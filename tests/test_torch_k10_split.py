"""K10's feature walk (``csrc/glove.cu``) replayed in plain torch on the CPU.

K10 steps one GloVe tail shard in three launches: R, the row side, tiles
of E consecutive entries of its feature-ordered list (``ShardMaps.order`` /
``bounds``), one warp a tile walking its entries one after another: at a
feature's first entry its shard-start w_i, b_i are read (and copied once,
by the tile where the feature begins, into the slot-indexed snapshot); per
entry the cost from that row and the entry's w_j, b_j, and the sums of g =
cost w_j, g^2, cost and cost^2 in entry order; a feature inside the tile is
stepped there, the tile's first feature (if it began before the tile) and
last (if it runs past it) left in the tile's head / tail slot; C, the
column side the same way, reading the row side's rows from the snapshot;
F, each feature that runs over tiles summed from its tail's tile and the
heads after it in four running sums taken in turn, and the loss from R's
per-tile partials.
:func:`_replay` does the same in plain torch, in the kernel's order of
additions.

Inputs are numpy-made co-occurrences (seeded) staged as the port stages
them, with a popular row id whose entries run over several tiles.  Stated
tolerances, each table held by its change (max |a - b| / max |b - before|)
and the loss relatively, each shard of an epoch from the state the shards
before it left: the replay against ``_glove_shard_plain`` at float64 to
1e-12 and at float32 to 1e-6; against the JAX package's ``_glove_epoch``
and ``_glove_epoch_sched`` at float64 to 1e-10 absolute, the tolerance of
``tests/test_torch_glove.py``.  The same replay with either side applied
before the other has read its shard-start rows misses the plain version
by far more.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu.models import glove as ref_glove
from rsparse_tpu.ops.segsum import build_stacked_col_schedule
from rsparse_tpu_torch.convert import glove_state_from_numpy
from rsparse_tpu_torch.models import glove as port_glove

torch.set_num_threads(2)

HP = dict(x_max=10.0, alpha=0.75, lr=0.05)
TILES = (port_glove.K10_TILE, 64)
#: the walks' two snapshot faults: the column side reading w_i, b_i after
#: the row side applied them, and the column side applied first
FAULTS = ("no snapshot", "columns first")


def _cta_sum(parts):
    """Launch F's loss: one CTA of 8 warps, thread t summing parts t, t +
    256, ..., each warp by a butterfly, then the warps in order."""
    zero = parts[0] * 0 if parts else torch.zeros(())
    th = [zero.clone() for _ in range(256)]
    for i, p in enumerate(parts):
        th[i % 256] = th[i % 256] + p
    total = zero.clone()
    for w in range(8):
        v = th[32 * w:32 * w + 32]
        for o in (16, 8, 4, 2, 1):
            v = [v[lane] + v[lane ^ o] for lane in range(32)]
        total = total + v[0]
    return total


def _replay(st, sh, x_max, alpha, lr, tile, fault=None):
    """K10's three launches in plain torch, updating ``st`` in place.
    Returns (loss, pieces): pieces[side][u] lists each run of slot u's
    entries a tile summed, as (lo, hi, where): "step" (stepped in the
    walk), "head" or "tail" (left in the tile's slot), and "span" once for
    a feature launch F stepped."""
    r = st.w_i.shape[1]
    n_tiles = -(-sh.rows.shape[0] // tile)
    snap = {}

    def walk(row):
        own_ids, other_ids = (sh.rows, sh.cols) if row else (sh.cols, sh.rows)
        slot, order, bounds = ((sh.slot_r, sh.order_r, sh.bounds_r) if row
                               else (sh.slot_c, sh.order_c, sh.bounds_c))
        w, b, acc_w, acc_b = st[0::2] if row else st[1::2]
        n_valid = int(bounds[-1])
        bnd = bounds.tolist()
        spans, tail_u, parts, pieces = {}, {}, [], {}
        for t in range(n_tiles):
            e0, e1 = t * tile, min(t * tile + tile, n_valid)
            parts.append(torch.zeros((), dtype=w.dtype))
            if e0 >= n_valid:
                continue
            ps = order[e0:e1].long()
            us = slot[ps].tolist()
            u_first, u_last = us[0], us[-1]
            cross_in = bnd[u_first] < e0
            own_tail = bnd[u_last + 1] > e1 and not (u_last == u_first
                                                     and cross_in)
            if own_tail:
                tail_u[t] = u_last

            def finish(u, f, w0, b0, a, lo, hi):
                if u == u_first and cross_in:
                    spans[(t, 0)], where = a, "head"
                elif u == u_last and own_tail:
                    spans[(t, 1)], where = a, "tail"
                else:
                    where = "step"
                    aw = acc_w[f] + a[r:2 * r]
                    w[f] = w0 + -lr * a[:r] / torch.sqrt(aw)
                    acc_w[f] = aw
                    ab = acc_b[f] + a[2 * r + 1]
                    b[f] = b0 + -lr * a[2 * r] / torch.sqrt(ab)
                    acc_b[f] = ab
                pieces.setdefault(u, []).append((lo, hi, where))

            cu = -1
            for k, p in enumerate(ps.tolist()):
                if us[k] != cu:
                    if cu >= 0:
                        finish(cu, cf, w0, b0, a, lo, e0 + k)
                    cu, cf, lo = us[k], int(own_ids[p]), e0 + k
                    w0, b0 = w[cf].clone(), b[cf].clone()
                    a = torch.zeros((2 * r + 2,), dtype=w.dtype)
                    if row and not (cu == u_first and cross_in):
                        snap[cu] = (w0.clone(), b0.clone())
                if row:
                    j = int(other_ids[p])
                    fr, ob = st.w_j[j].clone(), st.b_j[j].clone()
                elif fault is None:
                    fr, ob = snap[int(sh.slot_r[p])]
                else:  # the row side's rows as the table holds them now
                    i = int(other_ids[p])
                    fr, ob = st.w_i[i].clone(), st.b_i[i].clone()
                v = sh.vals[p].to(w.dtype)
                bi, bj = (b0, ob) if row else (ob, b0)
                inner = torch.clamp((w0 * fr).sum() + bi + bj - torch.log(v),
                                    -100.0, 100.0)
                weight = torch.pow(v / x_max, alpha) if v < x_max else 1.0
                cost = weight * inner
                if row:
                    parts[t] = parts[t] + cost * inner
                g = cost * fr
                a = a + torch.cat([g, g * g, cost[None], (cost * cost)[None]])
            finish(cu, cf, w0, b0, a, lo, e1)
        return spans, tail_u, parts, pieces

    def span(row, spans, tail_u, pieces):
        bounds, feats = ((sh.bounds_r, sh.feats_r) if row
                         else (sh.bounds_c, sh.feats_c))
        w, b, acc_w, acc_b = st[0::2] if row else st[1::2]
        for t, u in sorted(tail_u.items()):
            # four running sums over the slots in turn, then ((0 + 1) +
            # (2 + 3))
            t1 = (int(bounds[u + 1]) - 1) // tile
            p = [torch.zeros((2 * r + 2,), dtype=w.dtype) for _ in range(4)]
            for q in range(t, t1 + 1):
                p[(q - t) % 4] = p[(q - t) % 4] + spans[(q, int(q == t))]
            a = (p[0] + p[1]) + (p[2] + p[3])
            f = int(feats[u])
            aw = acc_w[f] + a[r:2 * r]
            w[f] = w[f] + -lr * a[:r] / torch.sqrt(aw)
            acc_w[f] = aw
            ab = acc_b[f] + a[2 * r + 1]
            b[f] = b[f] + -lr * a[2 * r] / torch.sqrt(ab)
            acc_b[f] = ab
            pieces[u].append((None, None, "span"))

    if fault == "columns first":
        c = walk(False)
        rr = walk(True)
    else:
        rr = walk(True)
        c = walk(False)
    span(True, *rr[:2], rr[3])
    span(False, *c[:2], c[3])
    return _cta_sum(rr[2]), {"r": rr[3], "c": c[3]}


def _tail(seed=0, n=60, nnz=700, batch=256):
    """Stacked shards of ``batch`` over an ``n``-token vocabulary whose
    row 0 holds about a third of the triplets (its entries run over several
    tiles of every shard), counts 1 + 10 U(0, 1), duplicates summed."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / (np.arange(n) + 1.0) ** 1.5
    pop /= pop.sum()
    i = rng.choice(n, nnz, p=pop)
    j = rng.integers(0, n, nnz)
    coo = sp.coo_matrix((1.0 + 10.0 * rng.random(nnz), (i, j)), shape=(n, n))
    coo.sum_duplicates()
    return sp.coo_matrix(coo), port_glove._stack_coo_host(coo, batch)


def _shards(host, dtype=torch.float64):
    r, c, v, m = (torch.from_numpy(a) for a in host)
    return port_glove.Shards.build(r, c, v.to(dtype), m)


def _state(n, r, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = [rng.uniform(-0.5, 0.5, s) for s in ((n, r), (n, r), (n,), (n,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n, r), (n, r), (n,), (n,))]
    a = [x.astype(dtype) for x in a]
    return a, glove_state_from_numpy(a, "double" if dtype == np.float64
                                     else "float32", "cpu")


def _rel(a, b, before):
    """max |a - b| over the largest change of b."""
    d = (a.double() - b.double()).abs().max()
    return float(d / max(float((b.double() - before.double()).abs().max()),
                         1e-300))


def _variants(host):
    shards = _shards(host)
    shuffled = port_glove._shuffle_shards(shards, seed=5)
    return {"staged": shards, "shuffled": shuffled,
            "swapped": shards.swapped(), "shuffled, swapped":
            shuffled.swapped()}


def test_order_lists_every_valid_entry_once_by_slot():
    """Each side's feature-ordered list of every shard: each valid entry
    once, then N at padding; slots ascending, entries ascending within a
    slot; bounds the per-slot counts; also after a shuffle and on swapped
    shards (the shuffle's maps rebuilt for the new contents)."""
    _, host = _tail(seed=1, nnz=1500)
    for what, shards in _variants(host).items():
        S, N = shards.rows.shape
        assert S > 2 and (~shards.valid[-1]).any(), what
        for s in range(S):
            sh = shards.shard(s)
            valid = shards.valid[s]
            for side in ("r", "c"):
                ids = sh.rows if side == "r" else sh.cols
                feats, slot, order, bounds = (getattr(sh, f"{k}_{side}")
                                              for k in ("feats", "slot",
                                                        "order", "bounds"))
                assert order.dtype == bounds.dtype == torch.int32
                nv = int(valid.sum())
                o = order[:nv].long()
                assert (order[nv:] == N).all(), what
                assert torch.equal(torch.sort(o).values,
                                   torch.nonzero(valid).reshape(-1)), what
                so = slot[o]
                assert (so[1:] >= so[:-1]).all(), what
                same = so[1:] == so[:-1]
                assert (o[1:][same] > o[:-1][same]).all(), what
                U = feats.shape[0]
                assert torch.equal(bounds[1:] - bounds[:-1],
                                   torch.bincount(slot[valid].long(),
                                                  minlength=U).int()), what
                assert int(bounds[0]) == 0 and int(bounds[-1]) == nv, what
                assert torch.equal(feats[so], ids[o]), what
                assert torch.equal(feats.long(),
                                   torch.unique(ids[valid]).long()), what
                assert (slot[~valid] == U).all(), what


@pytest.mark.parametrize("tile", TILES)
def test_split_covers_each_feature_once(tile):
    """The walks' tiles split a feature's entries into runs; the runs of
    every feature of each side cover its entries exactly once, and the
    feature takes one AdaGrad step: in its walk when one tile holds it, else
    in launch F from one tail and the heads after it.  Row 0 runs over
    several tiles of every shard."""
    _, host = _tail(seed=2)
    n = 60
    for what, shards in _variants(host).items():
        _, st = _state(n, 5, 3)
        for s in range(shards.rows.shape[0]):
            sh = shards.shard(s)
            _, pieces = _replay(st, sh, **HP, tile=tile)
            spanned = 0
            for side in ("r", "c"):
                bounds = getattr(sh, f"bounds_{side}").tolist()
                U = getattr(sh, f"feats_{side}").shape[0]
                assert sorted(pieces[side]) == list(range(U)), what
                for u, runs in pieces[side].items():
                    got = sorted((lo, hi) for lo, hi, k in runs
                                 if k != "span")
                    assert got[0][0] == bounds[u], what
                    assert got[-1][1] == bounds[u + 1], what
                    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
                    kinds = sorted(k for _, _, k in runs if k != "span")
                    n_span = sum(k == "span" for _, _, k in runs)
                    if kinds == ["step"]:
                        assert n_span == 0
                    else:
                        spanned += 1
                        assert n_span == 1 and kinds.count("tail") == 1
                        assert kinds.count("head") == len(kinds) - 1
            if s < shards.rows.shape[0] - 1:
                assert spanned, (what, s)  # row 0 ran over tiles


@pytest.mark.parametrize("r", [1, 5, 33])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("what", ["staged", "swapped", "shuffled"])
def test_replay_matches_plain(what, tile, r):
    """The replay against the plain version, float64 and float32, on every
    shard of an epoch, each from the state the plain version left."""
    _, host = _tail(seed=4)
    n = 60
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        shards = _variants(host)[what]
        shards = shards._replace(vals=shards.vals.to(dtype))
        _, state = _state(n, r, 5, np.float64 if dtype == torch.float64
                          else np.float32)
        for s in range(shards.rows.shape[0]):
            sh = shards.shard(s)
            s0 = [t.clone() for t in state]
            lp = port_glove._glove_shard_plain(state, sh, **HP)
            sr = port_glove.GloveState(*(t.clone() for t in s0))
            lr_, _ = _replay(sr, sh, **HP, tile=tile)
            assert abs(float(lr_) / float(lp) - 1) <= tol, (dtype, s)
            for name, a, b, t0 in zip(port_glove.GloveState._fields, sr,
                                      state, s0):
                assert _rel(a, b, t0) <= tol, (dtype, s, name)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("ref", ["scatter", "scheduled"])
def test_replay_matches_reference(ref, swap):
    """A whole epoch of the replay (tiles of 32) against the JAX package's
    scatter and scheduled epochs at float64, straight and swapped (the
    transposed pass of a triangular input)."""
    n, r = 60, 5
    _, host = _tail(seed=6)
    init, st = _state(n, r, 7)
    sj = ref_glove.GloveState(*(jnp.asarray(a) for a in init))
    shards = _shards(host)
    jsh = tuple(jnp.asarray(a) for a in host)
    if swap:
        jsh = (jsh[1], jsh[0]) + jsh[2:]
        shards = shards.swapped()
    if ref == "scatter":
        sj, lj = ref_glove._glove_epoch(sj, *jsh, **HP)
    else:
        sr = build_stacked_col_schedule(host[0], host[3], n)
        sc = build_stacked_col_schedule(host[1], host[3], n)
        if swap:
            sr, sc = sc, sr
        sj, lj = ref_glove._glove_epoch_sched(sj, *jsh, sr, sc, **HP)
    losses = [_replay(st, shards.shard(s), **HP, tile=32)[0]
              for s in range(shards.rows.shape[0])]
    np.testing.assert_allclose(0.5 * float(sum(losses)), float(lj),
                               rtol=1e-10)
    for name, a, b in zip(port_glove.GloveState._fields, st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize("fault", FAULTS)
def test_snapshot_is_needed(fault):
    """Either side applied before the other has read its shard-start rows
    (the column side reading w_i after the row side stepped it, or stepping
    w_j before the row side reads it) misses the plain version by many
    orders of magnitude more than the replay's 1e-12: the replay holds the
    snapshot, and the other tests would catch a walk that did not."""
    _, host = _tail(seed=8)
    sh = _shards(host).shard(0)
    _, st = _state(60, 5, 9)
    plain = port_glove.GloveState(*(t.clone() for t in st))
    port_glove._glove_shard_plain(plain, sh, **HP)
    good = port_glove.GloveState(*(t.clone() for t in st))
    _replay(good, sh, **HP, tile=32)
    bad = port_glove.GloveState(*(t.clone() for t in st))
    _replay(bad, sh, **HP, tile=32, fault=fault)
    off = {name: _rel(a, b, t0) for name, a, b, t0 in
           zip(port_glove.GloveState._fields, bad, plain, st)}
    assert max(_rel(a, b, t0) for a, b, t0 in zip(good, plain, st)) <= 1e-12
    assert max(off.values()) > 1e-3, off
    # the faulty side's tables are the ones off
    side = "_j" if fault == "no snapshot" else "_i"
    assert min(v for k, v in off.items() if k.endswith(side)) > 1e-3, off


def test_tile_is_the_kernels():
    """K10_TILE, the tile the replays above use, is the tile csrc/glove.cu
    is built with, whole steps of 32."""
    T = port_glove.K10_TILE
    src = (Path(port_glove.__file__).parent.parent / "csrc" / "glove.cu"
           ).read_text()
    assert re.search(rf"constexpr int kTile = {T};", src)
    assert T > 0 and T % 32 == 0 and T in TILES
