"""K8's feature walk (``csrc/fm.cu``) replayed in plain torch on the CPU.

K8 updates one FM block in three launches (``rsparse_tpu_torch/models/fm.py``
k8_plan): A, the rows (predictions, each row's dL and s1, one dL partial a
CTA); B, tiles of E consecutive entries of the block's feature-ordered list
(``GLMBlock.order`` / ``offs``; E a multiple of 32, read 32 at a time),
32 / tpe entries a step, each feature's
gradient sums taken by a segmented scan over a step and carried from step
to step, a feature inside the tile stepped there, the tile's first feature
(if it began before the tile) and last (if it runs past it) left in the
tile's head / tail slot; C, each feature that runs over tiles summed from
its first tile's tail and the heads after it by that tile's warp (its
32 / tpe entry groups each every (32 / tpe)-th slot, then a fixed tree),
and the intercept from A's partials.  :func:`_replay` does the same in plain torch,
step by step, in the kernel's order of additions.

Inputs are numpy-made CSRs (seeded) staged as the port stages them.  Stated
tolerances, each table held by its change (max |a - b| / max |b - before|)
and the predictions relative to their largest magnitude (at least 1), each
block of a pass from the state the blocks before it left: the replay against ``_fm_block_plain`` at
float64 to 1e-12 and at float32 to 1e-6 of the change or of the table's
largest value (the two add a feature's gradients, and the intercept's dL
over a block's rows, in different orders, and the intercept's sum
cancels), and against the JAX package's
``_fm_block`` at float64 to 1e-10 absolute, the tolerance of
``tests/test_torch_fm.py``.  A block of only empty rows takes the intercept
step in the port and not in the reference (ROADMAP.md queue 3), so it is
held to the plain version only.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu.models import fm as ref_fm
from rsparse_tpu_torch.models import fm as port_fm
from rsparse_tpu_torch.ops import segsum

from test_torch_ftrl import glm_problem, port_blocks, ref_blocks

torch.set_num_threads(2)

STATE = ("w0", "acc_w0", "w", "v", "acc_w", "acc_v")
HP = dict(lr_w=0.15, lr_v=0.1, lam_w=0.02, lam_v=0.01)


def _replay(w0, acc_w0, w, v, acc_w, acc_v, blk, y, sample_w, lr_w, lr_v,
            lam_w, lam_v, family, intercept, do_update, tile):
    """K8's three launches in plain torch, updating the tables in place.
    Returns (y_hat, pieces): pieces[u] lists each run of slot u's entries
    a tile summed, as (lo, hi, where): "step" (stepped in launch B),
    "head" or "tail" (left in the tile's slot), and "span" once for a
    feature launch C stepped."""
    B, L = blk.col_idx.shape
    r, N = v.shape[1], blk.order.shape[0]
    plan = port_fm.k8_plan(B, N, r)
    col = blk.col_idx.long()
    x = blk.values
    # A: the rows, from the block-start tables
    vx = v[col] * x[..., None]
    s1 = vx.sum(1)
    raw = (w0 + (w[col] * x).sum(1)
           + 0.5 * ((s1 * s1).sum(1) - (vx * vx).sum((1, 2))))
    y_hat = torch.sigmoid(raw) if family == 1 else raw
    if not do_update:
        return y_hat, {}
    if family == 1:
        dL = (torch.sigmoid(raw * y) - 1.0) * y
    else:
        dL = 2.0 * (raw - y)
    dL = dL * sample_w
    rows_cta = port_fm.K8_WARPS * (32 // plan["G"])
    part = [(dL[i:i + rows_cta].sum(), (dL[i:i + rows_cta] ** 2).sum())
            for i in range(0, B, rows_cta)]
    # B: every entry's gradients from the block-start v, in `order`
    order = blk.order.long()
    offs = blk.offs.tolist()
    u_of = blk.slot.reshape(-1)[order].tolist()
    f_of = col.reshape(-1)[order]
    xe = x.reshape(-1)[order]
    b_of = order // L
    d = dL[b_of]
    ve = v[f_of]
    gw = torch.clamp(xe * d + 2.0 * lam_w, -100.0, 100.0)
    gv = torch.clamp(d[:, None] * xe[:, None] * (s1[b_of] - ve * xe[:, None])
                     + 2.0 * lam_v * ve, -100.0, 100.0)
    g = torch.cat([gw[:, None], (gw * gw)[:, None], gv, gv * gv], 1)
    feats = blk.feats.long()

    def step(u, a):
        f = feats[u]
        aw = acc_w[f] + a[1]
        w[f] += -lr_w * a[0] / torch.sqrt(aw)
        acc_w[f] = aw
        av = acc_v[f] + a[2 + r:]
        v[f] += -lr_v * a[2:2 + r] / torch.sqrt(av)
        acc_v[f] = av

    E, S = tile, 32 // plan["tpe"]
    n_tiles = -(-N // E)
    slots = {}
    tail_u = [-1] * n_tiles
    pieces = {}
    for t in range(n_tiles):
        e0, e1 = t * E, min(t * E + E, N)
        u_first, u_last = u_of[e0], u_of[e1 - 1]
        cross_in = offs[u_first] < e0
        cross_out = offs[u_last + 1] > e1
        own_tail = cross_out and not (u_last == u_first and cross_in)
        tail_u[t] = u_last if own_tail else -1

        def finish(a, u, lo, hi):
            if u == u_first and cross_in:
                slots[(t, 0)], where = a, "head"
            elif u == u_last and own_tail:
                slots[(t, 1)], where = a, "tail"
            else:
                step(u, a)
                where = "step"
            pieces.setdefault(u, []).append((lo, hi, where))

        cu, carry, c_lo = -1, None, e0
        for s in range(e0, e1, S):
            m = min(S, e1 - s)
            us = u_of[s:s + m] + [-1] * (S - m)
            a = torch.zeros((S, g.shape[1]), dtype=g.dtype)
            a[:m] = g[s:s + m]
            dd = 1
            while dd < S:  # the segmented inclusive scan over the step
                nxt = a.clone()
                for j in range(dd, S):
                    if us[j - dd] == us[j]:
                        nxt[j] = a[j] + a[j - dd]
                a, dd = nxt, dd * 2
            if cu >= 0 and cu != us[0]:
                finish(carry, cu, c_lo, s)
            elif cu >= 0:
                for j in range(S):
                    if us[j] == cu:
                        a[j] = a[j] + carry
            lo = s if not (cu >= 0 and cu == us[0]) else c_lo
            for j in range(m - 1):
                if us[j] != us[j + 1]:
                    finish(a[j], us[j], lo, s + j + 1)
                    lo = s + j + 1
            cu, carry, c_lo = us[m - 1], a[m - 1], lo
        finish(carry, cu, c_lo, e1)
    # C: the features that run over tiles, each by its first tile's warp:
    # entry group j sums slots t + j, t + j + S, ..., then a fixed tree
    for t in range(n_tiles):
        u = tail_u[t]
        if u < 0:
            continue
        t1 = (offs[u + 1] - 1) // E
        part_s = [torch.zeros_like(g[0]) for _ in range(S)]
        for j in range(S):
            for q in range(t + j, t1 + 1, S):
                part_s[j] = part_s[j] + slots[(q, int(q == t))]
        o = 1
        while o < S:
            part_s = [part_s[j] + part_s[j ^ o] for j in range(S)]
            o *= 2
        step(u, part_s[0])
        pieces[u].append((None, None, "span"))
    if intercept:
        s = sum(p[0] for p in part)
        s2 = sum(p[1] for p in part)
        acc_w0 += s2
        w0 -= lr_w * s / torch.sqrt(acc_w0)
    return y_hat, pieces


def _tables(F1, r, dtype, seed):
    rng = np.random.default_rng(seed)
    init = [np.asarray(0.1), np.asarray(1.3), rng.standard_normal(F1) * 0.1,
            rng.standard_normal((F1, r)) * 0.1, rng.uniform(1, 2, F1),
            rng.uniform(1, 2, (F1, r))]
    return init, [torch.tensor(a, dtype=dtype) for a in init]


def _rel(a, b, before):
    """max |a - b| relative to the largest change of b, and to the largest
    value of b."""
    a, b, before = (np.asarray(t, np.float64) for t in (a, b, before))
    d = float(np.abs(a - b).max())
    return (d / max(np.abs(b - before).max(), 1e-300),
            d / max(np.abs(b).max(), 1e-300))


def _problem(case, seed=0):
    """(x, y in +-1, weights) of one test case."""
    rng = np.random.default_rng(seed)
    if case == "empty rows":
        x, y, w = glm_problem(seed=seed, n_rows=90, n_feat=40, max_nnz=12,
                              empty=(0, 5, 6, 50))
    elif case == "every row":
        # feature 0 in every row (a bias column), the rest sparse
        x, y, w = glm_problem(seed=seed, n_rows=150, n_feat=60, max_nnz=10)
        x = sp.hstack([sp.csr_matrix(np.ones((150, 1))), x[:, 1:]]).tocsr()
    elif case == "one-hot":
        # config #5's rows: (user, n_users + item), value 1, L = 8
        n_users, n_items, n = 400, 60, 300
        u = rng.integers(0, n_users, n)
        i = rng.integers(0, n_items, n)
        x = sp.csr_matrix((np.ones(2 * n), np.stack([u, n_users + i],
                                                    1).reshape(-1),
                           np.arange(0, 2 * n + 1, 2)),
                          shape=(n, n_users + n_items))
        y = (u % 3 == 0).astype(float)
        w = np.ones(n)
    elif case == "all empty":
        x = sp.csr_matrix((40, 12))
        y = rng.integers(0, 2, 40).astype(float)
        w = rng.uniform(0.5, 1.5, 40)
    else:
        x, y, w = glm_problem(seed=seed, n_rows=120, n_feat=25, max_nnz=20)
    return x, np.where(y == 1, 1.0, -1.0), w


CASES = ("mixed", "empty rows", "every row", "one-hot", "all empty")


def test_order_lists_every_valid_entry_once_by_slot():
    """The feature-ordered list of a staged block: each valid entry exactly
    once, no padding entry, slots ascending, row-major within a slot; offs
    the per-slot counts."""
    for case in CASES:
        x, y, w = _problem(case, seed=3)
        for blk in segsum.staged_glm_blocks(x, torch.float64, "cpu"):
            B, L = blk.col_idx.shape
            valid = blk.mask().reshape(-1).numpy()
            order = blk.order.numpy()
            slot = blk.slot.reshape(-1).numpy()
            assert blk.order.dtype == blk.offs.dtype == torch.int32
            np.testing.assert_array_equal(np.sort(order),
                                          np.flatnonzero(valid))
            s = slot[order]
            assert (np.diff(s) >= 0).all()
            same = np.diff(s) == 0
            assert (np.diff(order)[same] > 0).all()
            U = blk.feats.shape[0]
            np.testing.assert_array_equal(
                np.diff(blk.offs.numpy()),
                np.bincount(slot[valid], minlength=U))
            assert blk.offs[0] == 0 and blk.offs[-1] == len(order)
            np.testing.assert_array_equal(
                blk.col_idx.reshape(-1).numpy()[order],
                blk.feats.numpy()[s])


@pytest.mark.parametrize("tile", [32, 64, 256])
@pytest.mark.parametrize("r", [1, 4, 8, 33, 128])
def test_split_covers_each_feature_once(r, tile):
    """Launch B's tiles split a feature's entries into runs; the runs of
    every feature cover its entries exactly once, and the feature takes one
    AdaGrad step: in launch B when one tile holds it, else in launch C from
    one tail and the heads after it."""
    for case in ("mixed", "every row", "one-hot"):
        x, y, w = _problem(case, seed=r)
        blocks, labels = port_blocks(x, y, w, zero_pad_weight=True)
        for blk, (yb, wb) in zip(blocks, labels):
            _, st = _tables(x.shape[1] + 1, r, torch.float64, 1)
            _, pieces = _replay(*st, blk, yb, wb, **HP, family=1,
                                intercept=True, do_update=True, tile=tile)
            offs = blk.offs.tolist()
            assert sorted(pieces) == list(range(blk.feats.shape[0]))
            for u, runs in pieces.items():
                spans = [p for p in runs if p[2] == "span"]
                got = sorted((lo, hi) for lo, hi, k in runs if k != "span")
                assert got[0][0] == offs[u] and got[-1][1] == offs[u + 1]
                assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
                kinds = sorted(k for _, _, k in runs if k != "span")
                if kinds == ["step"]:
                    assert not spans
                else:
                    assert len(spans) == 1 and kinds.count("tail") == 1
                    assert kinds.count("head") == len(kinds) - 1


@pytest.mark.parametrize("do_update", [False, True])
@pytest.mark.parametrize("family", [1, 2])
@pytest.mark.parametrize("r", [1, 4, 8, 33, 128])
@pytest.mark.parametrize("case", CASES)
def test_replay_matches_plain(case, r, family, do_update):
    """The replay (tiles of 32 entries, so features run over tiles, and of
    K8_TILE) against the plain version, float64 and float32, on every block
    of a pass, each from the state the plain version left."""
    x, y, w = _problem(case, seed=7)
    if family == 2:
        y = x @ np.linspace(-1, 1, x.shape[1]) + 0.1
    kw = dict(family=family, intercept=True, do_update=do_update)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        blocks, labels = port_blocks(x, y, w, zero_pad_weight=True)
        _, state = _tables(x.shape[1] + 1, r, dtype, 2)
        for blk, (yb, wb) in zip(blocks, labels):
            blk = segsum.GLMBlock(*(t.to(dtype) if t.is_floating_point()
                                    else t for t in blk))
            yb, wb = yb.to(dtype), wb.to(dtype)
            s0 = [t.clone() for t in state]
            yp = port_fm._fm_block_plain(*state, blk, yb, wb, *HP.values(),
                                         **kw)
            for tile in (32, port_fm.K8_TILE):
                sr = [t.clone() for t in s0]
                yr, _ = _replay(*sr, blk, yb, wb, **HP, **kw, tile=tile)
                np.testing.assert_allclose(
                    yr.numpy(), yp.numpy(), rtol=0,
                    atol=tol * max(1.0, float(yp.abs().max())))
                for name, a, b, t0 in zip(STATE, sr, state, s0):
                    if not do_update:
                        assert torch.equal(a, t0), name
                        continue
                    by_change, by_value = _rel(a, b, t0)
                    if dtype == torch.float64:
                        assert by_change <= tol, (name, by_change)
                    else:
                        assert min(by_change, by_value) <= tol, (
                            name, by_change, by_value)


@pytest.mark.parametrize("family", [1, 2])
@pytest.mark.parametrize("r", [4, 33])
@pytest.mark.parametrize("case", ["mixed", "empty rows", "every row",
                                  "one-hot"])
def test_replay_matches_reference(case, r, family):
    """Every block of a pass, in order, from the same state: the replay's
    tables and predictions against the JAX package's ``_fm_block`` at
    float64."""
    x, y, w = _problem(case, seed=9)
    if family == 2:
        y = x @ np.linspace(-1, 1, x.shape[1]) + 0.1
    br, layouts, rlab = ref_blocks(x, y, w, zero_pad_weight=True)
    blocks, plab = port_blocks(x, y, w, zero_pad_weight=True)
    init, st = _tables(x.shape[1] + 1, r, torch.float64, 4)
    sj = [jnp.asarray(a) for a in init]
    for rb, lay, (ry, rw), pb, (py, pw) in zip(br.buckets, layouts, rlab,
                                               blocks, plab):
        for do_update in (False, True):
            *sj, yj = ref_fm._fm_block(
                *sj, rb.col_idx, rb.values, ry, rw, *HP.values(), lay,
                family=family, intercept=True, do_update=do_update,
                rowmajor_pred=True)
            yt, _ = _replay(*st, pb, py, pw, **HP, family=family,
                            intercept=True, do_update=do_update, tile=32)
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                       atol=1e-10)
            for name, a, b in zip(STATE, st, sj):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=1e-10, err_msg=name)


def test_plan_lanes_and_tiles():
    """k8_plan: an entry's lanes, a row's lanes from the mean row length
    (config #5's one-hot rows share a warp), the tiles and the scratch;
    K8_TILE is the tile csrc/fm.cu is built with, whole steps of 32."""
    T = port_fm.K8_TILE
    src = (Path(port_fm.__file__).parent.parent / "csrc" / "fm.cu"
           ).read_text()
    assert re.search(rf"#define RSP_FM_TILE {T}\b", src)
    assert T > 0 and T % 32 == 0
    p = port_fm.k8_plan(32768, 32768 * 32, 8)
    assert (p["tpe"], p["G"], p["n_tiles"]) == (8, 32, 32768 * 32 // T)
    p = port_fm.k8_plan(131072, 2 * 131072, 4)
    assert (p["tpe"], p["G"], p["n_tiles"]) == (4, 8, 2 * 131072 // T)
    assert p["n_part"] == 131072 // (port_fm.K8_WARPS * 4)
    for r, tpe in ((1, 1), (2, 2), (3, 4), (8, 8), (9, 16), (33, 32),
                   (128, 32)):
        p = port_fm.k8_plan(10, 25, r)
        assert p["tpe"] == tpe and p["n_tiles"] == 1
        assert tpe <= p["G"] <= 32 and p["G"] & (p["G"] - 1) == 0
    p = port_fm.k8_plan(40, 0, 3)
    assert p["n_tiles"] == 0 and p["G"] == p["tpe"]
    B, N, r = 100, 700, 5
    p = port_fm.k8_plan(B, N, r)
    assert p["scratch"] == (B * (r + 1) + 2 * p["n_part"]
                            + p["n_tiles"] * (2 * (2 + 2 * r) + 1))
