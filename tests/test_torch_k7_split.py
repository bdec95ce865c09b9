"""K7's feature walk (``csrc/ftrl.cu``) replayed in plain torch on the CPU,
and the FTRL model's (z, n) pair table.

K7 updates one FTRL block in three launches (``rsparse_tpu_torch/models/
ftrl.py`` k7_plan): A, the rows (lazy weights from the block-start (z, n),
the link, each row's d = sample_w (y_hat - y), then each entry's g =
clip(d x), sigma and z's increment from the same pair); B, tiles of E
consecutive entries of the block's feature-ordered list (``GLMBlock.order``
/ ``offs``; E a multiple of 32), 32 entries a step, one a lane: the
increments' sums by a segmented scan over the step carried from step to
step, a feature inside the tile written there, the tile's first feature
(if it began before the tile) and last (if it runs past it) left in the
tile's head / tail slot; C, each feature that runs over tiles summed from its
tail's tile and the heads after it, lane j every 32nd slot from the tail's
tile + j, then a butterfly.  :func:`_replay` does the same in plain torch,
step by step, in the kernel's order of additions.

Inputs are numpy-made CSRs (seeded) staged as the port stages them, keep
masks drawn with numpy (or the JAX package's own draw).  Stated
tolerances, z and n held by their change (max |a - b| / max |b - before|)
and the predictions relative to their largest magnitude (at least 1), each
block of a pass from the state the blocks before it left: the replay
against ``_ftrl_block_plain`` at float64 to 1e-12 and at float32 to 1e-6;
against the JAX package's ``_ftrl_block`` at float64 to 1e-10 absolute,
the tolerance of ``tests/test_torch_ftrl.py``.  The pair table: a fit on
it equals, bitwise, a fit on two separate tables.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.models import ftrl as ref_ftrl
from rsparse_tpu_torch.convert import ftrl_from_numpy
from rsparse_tpu_torch.models import ftrl as port_ftrl
from rsparse_tpu_torch.ops import segsum

from test_torch_ftrl import glm_problem, port_blocks, ref_blocks

torch.set_num_threads(2)

HP = dict(lr=0.2, decay=0.7, l1=0.12, l2=0.28)
FAMILIES = {"binomial": 1, "gaussian": 2, "poisson": 3}
CASES = ("mixed", "empty rows", "every row", "one-hot")


def _replay(z, n, blk, y, sample_w, lr, decay, l1, l2, dropout, keep,
            family, do_update, tile):
    """K7's three launches in plain torch, updating z and n in place.
    Returns (y_hat, pieces): pieces[u] lists each run of slot u's entries
    a tile summed, as (lo, hi, where): "step" (written in launch B), "head"
    or "tail" (left in the tile's slot), and "span" once for a feature
    launch C wrote."""
    B, L = blk.col_idx.shape
    col = blk.col_idx.long()
    x = port_ftrl._dropped_values(blk, keep, dropout)
    # A: the rows, from the block-start pairs
    w = port_ftrl._lazy_weights(z[col], n[col], lr, decay, l1, l2)
    y_hat = port_ftrl._link((w * x).sum(1), family)
    if not do_update:
        return y_hat, {}
    d = sample_w * (y_hat - y)
    # A, then: every entry's increments from its block-start pair; B walks
    # them in `order`
    N = blk.order.shape[0]
    order = blk.order.long()
    offs = blk.offs.tolist()
    u_of = blk.slot.reshape(-1)[order].tolist()
    f_of = col.reshape(-1)[order]
    ze, ne = z[f_of], n[f_of]
    we = port_ftrl._lazy_weights(ze, ne, lr, decay, l1, l2)
    g = torch.clamp(d[order // L] * x.reshape(-1)[order], -1000.0, 1000.0)
    g2 = g * g
    uz = g - (torch.sqrt(ne + g2) - torch.sqrt(ne)) / lr * we
    inc = torch.stack([uz, g2], 1)
    feats = blk.feats.long()

    # a feature's pair written from its block-start value, which A kept
    z0, n0 = z.clone(), n.clone()

    def write(u, a):
        f = feats[u]
        z[f] = z0[f] + a[0]
        n[f] = n0[f] + a[1]

    n_tiles = -(-N // tile)
    slots, tail_u, pieces = {}, [-1] * n_tiles, {}
    for t in range(n_tiles):
        e0, e1 = t * tile, min(t * tile + tile, N)
        u_first, u_last = u_of[e0], u_of[e1 - 1]
        cross_in = offs[u_first] < e0
        own_tail = offs[u_last + 1] > e1 and not (u_last == u_first
                                                  and cross_in)
        tail_u[t] = u_last if own_tail else -1

        def finish(a, u, lo, hi):
            if u == u_first and cross_in:
                slots[(t, 0)], where = a, "head"
            elif u == u_last and own_tail:
                slots[(t, 1)], where = a, "tail"
            else:
                write(u, a)
                where = "step"
            pieces.setdefault(u, []).append((lo, hi, where))

        cu, carry, c_lo = -1, None, e0
        for s in range(e0, e1, 32):
            m = min(32, e1 - s)
            us = u_of[s:s + m] + [-1] * (32 - m)
            a = torch.zeros((32, 2), dtype=inc.dtype)
            a[:m] = inc[s:s + m]
            o = 1
            while o < 32:  # the segmented inclusive scan over the step
                nxt = a.clone()
                for j in range(o, 32):
                    if us[j - o] == us[j]:
                        nxt[j] = a[j] + a[j - o]
                a, o = nxt, o * 2
            if cu >= 0 and cu != us[0]:
                finish(carry, cu, c_lo, s)
            elif cu >= 0:
                for j in range(32):
                    if us[j] == cu:
                        a[j] = a[j] + carry
            lo = c_lo if cu >= 0 and cu == us[0] else s
            for j in range(m - 1):
                if us[j] != us[j + 1]:
                    finish(a[j], us[j], lo, s + j + 1)
                    lo = s + j + 1
            cu, carry, c_lo = us[m - 1], a[m - 1], lo
        finish(carry, cu, c_lo, e1)
    # C: lane j sums the slots tile + j, tile + j + 32, ..., then a butterfly
    for t in range(n_tiles):
        u = tail_u[t]
        if u < 0:
            continue
        t1 = (offs[u + 1] - 1) // tile
        lanes = [torch.zeros((2,), dtype=inc.dtype) for _ in range(32)]
        for j in range(32):
            for q in range(t + j, t1 + 1, 32):
                lanes[j] = lanes[j] + slots[(q, int(q == t))]
        for o in (16, 8, 4, 2, 1):
            lanes = [lanes[j] + lanes[j ^ o] for j in range(32)]
        write(u, lanes[0])
        pieces[u].append((None, None, "span"))
    return y_hat, pieces


def _problem(case, family="binomial", seed=0):
    """(x, y, weights) of one test case."""
    rng = np.random.default_rng(seed)
    if case == "empty rows":
        x, y, w = glm_problem(seed=seed, n_rows=90, n_feat=40, max_nnz=12,
                              empty=(0, 5, 6, 50))
    elif case == "every row":
        # feature 0 in every row (a bias column), the rest sparse
        x, y, w = glm_problem(seed=seed, n_rows=150, n_feat=60, max_nnz=10)
        x = sp.hstack([sp.csr_matrix(np.ones((150, 1))), x[:, 1:]]).tocsr()
    elif case == "one-hot":
        n_users, n_items, m = 400, 60, 300
        u = rng.integers(0, n_users, m)
        i = rng.integers(0, n_items, m)
        x = sp.csr_matrix((np.ones(2 * m), np.stack([u, n_users + i],
                                                    1).reshape(-1),
                           np.arange(0, 2 * m + 1, 2)),
                          shape=(m, n_users + n_items))
        y = (u % 3 == 0).astype(float)
        w = rng.uniform(0.5, 1.5, m)
    else:
        x, y, w = glm_problem(seed=seed, n_rows=120, n_feat=25, max_nnz=20)
    if family == "gaussian":
        y = y * 2.0 - 0.5
    elif family == "poisson":
        y, x = y * 3.0, x * 0.2
    return sp.csr_matrix(x), y, w


def _tables(F1, dtype, seed):
    rng = np.random.default_rng(seed)
    z0 = rng.standard_normal(F1) * 0.5
    n0 = rng.uniform(0.0, 2.0, F1)
    zn = torch.tensor(np.stack([z0, n0], 1), dtype=dtype)
    return (z0, n0), zn


def _rel(a, b, before):
    d = float((a.double() - b.double()).abs().max())
    return d / max(float((b.double() - before.double()).abs().max()), 1e-300)


@pytest.mark.parametrize("tile", [32, port_ftrl.K7_TILE])
def test_split_covers_each_feature_once(tile):
    """Launch B's tiles split a feature's entries into runs; the runs of
    every feature cover its entries exactly once, and the feature's pair is
    written once: in launch B when one tile holds it, else in launch C from
    one tail and the heads after it."""
    for case in ("mixed", "every row", "one-hot"):
        x, y, w = _problem(case, seed=3)
        blocks, labels = port_blocks(x, y, w)
        spanned = 0
        for blk, (yb, wb) in zip(blocks, labels):
            _, zn = _tables(x.shape[1] + 1, torch.float64, 1)
            _, pieces = _replay(zn[:, 0], zn[:, 1], blk, yb, wb, **HP,
                                dropout=0.0, keep=None, family=1,
                                do_update=True, tile=tile)
            offs = blk.offs.tolist()
            assert sorted(pieces) == list(range(blk.feats.shape[0]))
            for u, runs in pieces.items():
                n_span = sum(k == "span" for _, _, k in runs)
                got = sorted((lo, hi) for lo, hi, k in runs if k != "span")
                assert got[0][0] == offs[u] and got[-1][1] == offs[u + 1]
                assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
                kinds = sorted(k for _, _, k in runs if k != "span")
                if kinds == ["step"]:
                    assert n_span == 0
                else:
                    spanned += 1
                    assert n_span == 1 and kinds.count("tail") == 1
                    assert kinds.count("head") == len(kinds) - 1
        if case == "every row":
            assert spanned  # the bias column runs over tiles


def _keep(blk, dropout, seed):
    if not dropout:
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(tuple(blk.values.shape)) > dropout)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("do_update", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("case", CASES)
def test_replay_matches_plain(case, family, do_update, dropout):
    """The replay (tiles of 32 entries, so features run over tiles, and of
    K7_TILE) against the plain version, float64 and float32, on every block
    of a pass, each from the state the plain version left."""
    x, y, w = _problem(case, family, seed=7)
    kw = dict(dropout=dropout, family=FAMILIES[family], do_update=do_update)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        blocks, labels = port_blocks(x, y, w)
        _, zn = _tables(x.shape[1] + 1, dtype, 2)
        for k, (blk, (yb, wb)) in enumerate(zip(blocks, labels)):
            blk = segsum.GLMBlock(*(t.to(dtype) if t.is_floating_point()
                                    else t for t in blk))
            yb, wb = yb.to(dtype), wb.to(dtype)
            keep = _keep(blk, dropout, 10 + k)
            z0 = zn.clone()
            yp = port_ftrl._ftrl_block_plain(zn[:, 0], zn[:, 1], blk, yb, wb,
                                             **HP, keep=keep, **kw)
            for tile in (32, port_ftrl.K7_TILE):
                zr = z0.clone()
                yr, _ = _replay(zr[:, 0], zr[:, 1], blk, yb, wb, **HP,
                                keep=keep, **kw, tile=tile)
                np.testing.assert_allclose(
                    yr.numpy(), yp.numpy(), rtol=0,
                    atol=tol * max(1.0, float(yp.abs().max())))
                if not do_update:
                    assert torch.equal(zr, z0) and torch.equal(zn, z0)
                    continue
                for c in (0, 1):
                    assert _rel(zr[:, c], zn[:, c], z0[:, c]) <= tol, (
                        dtype, k, tile, c)


@pytest.mark.parametrize("case, family, dropout", [
    ("mixed", "binomial", 0.35), ("mixed", "gaussian", 0.0),
    ("mixed", "poisson", 0.0), ("empty rows", "gaussian", 0.35),
    ("every row", "binomial", 0.0), ("every row", "poisson", 0.35),
    ("one-hot", "binomial", 0.0), ("one-hot", "gaussian", 0.35)])
def test_replay_matches_reference(case, family, dropout):
    """Every block of a pass, in order, from the same state, predict then
    update: the replay's z, n and predictions against the JAX package's
    ``_ftrl_block`` at float64, dropout with the reference's own keep
    draw."""
    x, y, w = _problem(case, family, seed=9)
    fam = FAMILIES[family]
    br, layouts, rlab = ref_blocks(x, y, w)
    blocks, plab = port_blocks(x, y, w)
    (z0, n0), zn = _tables(x.shape[1] + 1, torch.float64, 4)
    zj, nj = jnp.asarray(z0), jnp.asarray(n0)
    hp = tuple(HP.values())
    for k, (rb, lay, (ry, rw), pb, (py, pw)) in enumerate(
            zip(br.buckets, layouts, rlab, blocks, plab)):
        key = jax.random.PRNGKey(20 + k)
        for do_update in (False, True):
            drop = do_update and dropout > 0
            zj, nj, yj = ref_ftrl._ftrl_block(
                zj, nj, rb.col_idx, rb.values, ry, rw, key, *hp, dropout,
                lay, family=fam, do_update=do_update, use_dropout=drop,
                rowmajor_pred=bool(k % 2))
            keep = None
            if drop:
                keep = torch.from_numpy(np.array(
                    jax.random.uniform(key, rb.values.shape) > dropout))
            yt, _ = _replay(zn[:, 0], zn[:, 1], pb, py, pw, *hp,
                            dropout if drop else 0.0, keep, fam, do_update,
                            tile=32)
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                       atol=1e-10)
        np.testing.assert_allclose(zn[:, 0].numpy(), np.asarray(zj), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(zn[:, 1].numpy(), np.asarray(nj), rtol=0,
                                   atol=1e-10)


def test_model_keeps_one_pair_table():
    """A fitted model's z and n are the columns of its one (F + 1, 2)
    table ``zn``: one storage, n one element past z, stride 2."""
    x, y, w = _problem("mixed", seed=11)
    m = rt.FTRL(learning_rate=0.1, lambda_=0.5, precision="double",
                device="cpu")
    assert m.zn is None and m.z is None and m.n is None
    m.partial_fit(x, y, w)
    F1 = x.shape[1] + 1
    assert m.zn.shape == (F1, 2) and m.zn.is_contiguous()
    for c, t in enumerate((m.z, m.n)):
        assert t.shape == (F1,) and t.stride() == (2,)
        assert t.untyped_storage().data_ptr() == \
            m.zn.untyped_storage().data_ptr()
        assert t.storage_offset() == m.zn.storage_offset() + c
        assert torch.equal(t, m.zn[:, c])


def test_fit_on_pair_table_equals_separate_tables():
    """Two passes of every block (dropout on, one shared mask stream) on
    the model's pair table and on two separate contiguous tables: the same
    z, n and predictions, bitwise."""
    x, y, w = _problem("every row", seed=12)
    blocks, labels = port_blocks(x, y, w)
    _, zn = _tables(x.shape[1] + 1, torch.float64, 13)
    z, n = zn[:, 0].clone(), zn[:, 1].clone()
    assert z.is_contiguous() and z.untyped_storage().data_ptr() != \
        zn.untyped_storage().data_ptr()
    for p in range(2):
        for k, (blk, (yb, wb)) in enumerate(zip(blocks, labels)):
            keep = _keep(blk, 0.25, 100 * p + k)
            args = (blk, yb, wb, *HP.values(), 0.25, keep, 1, True)
            ya = port_ftrl._ftrl_block(zn[:, 0], zn[:, 1], *args)
            yb_ = port_ftrl._ftrl_block(z, n, *args)
            assert torch.equal(ya, yb_)
    assert torch.equal(zn[:, 0], z) and torch.equal(zn[:, 1], n)


def test_carry_over_fills_the_pair_table():
    """A JAX-fitted model carried over by ``FTRL.load(ref.dump())`` and by
    ``convert.ftrl_from_numpy`` lands in one pair table holding the
    reference's z and n, dumps them back as they were, and takes the same
    next partial_fit as the reference."""
    x, y, w = _problem("mixed", seed=14)
    kw = dict(learning_rate=0.15, learning_rate_decay=0.6, lambda_=2.0,
              l1_ratio=0.7, precision="double")
    mj = rt_ref.FTRL(**kw)
    mj.fit(x, y, w, n_iter=2)
    carried = [rt.FTRL.load(mj.dump(), precision="double", device="cpu"),
               ftrl_from_numpy(np.asarray(mj.z), np.asarray(mj.n), **kw,
                               device="cpu")]
    for mc in carried:
        assert mc.zn.shape == (x.shape[1] + 1, 2) and mc.zn.is_contiguous()
        assert mc.n_features == x.shape[1]
        np.testing.assert_array_equal(mc.zn[:, 0].numpy(), np.asarray(mj.z))
        np.testing.assert_array_equal(mc.zn[:, 1].numpy(), np.asarray(mj.n))
        d = mc.dump()
        np.testing.assert_array_equal(d["z"], np.asarray(mj.z))
        np.testing.assert_array_equal(d["n"], np.asarray(mj.n))
        assert d["z"].flags.c_contiguous and d["n"].flags.c_contiguous
    x2, y2, w2 = _problem("mixed", seed=15)
    pj = mj.partial_fit(x2, y2, w2)
    for mc in carried:
        np.testing.assert_allclose(mc.partial_fit(x2, y2, w2), pj, rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(mc.z.numpy(), np.asarray(mj.z), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(mc.n.numpy(), np.asarray(mj.n), rtol=0,
                                   atol=1e-10)
    with pytest.raises(ValueError, match="one \\(F \\+ 1,\\) shape"):
        ftrl_from_numpy(np.zeros(4), np.zeros(5), device="cpu")


def test_kernel_layouts():
    """The layouts K7 takes: the two columns of one (F + 1, 2) table or
    two contiguous 1-D tables (here refused only for lying on the CPU);
    any other layout raises for its layout."""
    zn = torch.zeros((9, 2))
    wide = torch.zeros((9, 3))
    for z, n in ((zn[:, 0], zn[:, 1]), (torch.zeros(9), torch.zeros(9))):
        with pytest.raises(ValueError, match="CUDA"):
            port_ftrl.zn_layout(z, n)
    for z, n in ((zn[:, 1], zn[:, 0]), (wide[:, 0], wide[:, 1]),
                 (zn[:, 0], torch.zeros(9)), (zn[:, 0], zn.clone()[:, 1]),
                 (zn.T.contiguous().T[:, 0], zn[:, 1])):
        with pytest.raises(ValueError, match="takes the two columns"):
            port_ftrl.zn_layout(z, n)
    with pytest.raises(ValueError, match="two \\(F \\+ 1,\\) tables"):
        port_ftrl.zn_layout(zn[:, 0], torch.zeros(8))


def test_plan_and_tile():
    """k7_plan's tiles and scratch; K7_TILE is the tile csrc/ftrl.cu is
    built with, whole steps of 32."""
    T = port_ftrl.K7_TILE
    src = (Path(port_ftrl.__file__).parent.parent / "csrc" / "ftrl.cu"
           ).read_text()
    assert re.search(rf"#define RSP_FTRL_TILE {T}\b", src)
    assert T > 0 and T % 32 == 0
    p = port_ftrl.k7_plan(32_768, 32, 32_768 * 32)
    assert p["n_tiles"] == 32_768 * 32 // T
    assert p["scratch"] == 4 * 32_768 * 32 + 5 * p["n_tiles"]
    assert port_ftrl.k7_plan(40, 3, 0) == dict(n_tiles=0, scratch=480)
