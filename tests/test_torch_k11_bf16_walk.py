"""K11's bf16-state head (``csrc/glove_dense.cu`` ``glove_tile_walk_bf16``,
GloVe at ``precision="bfloat16"``) replayed in plain torch on the CPU.

Launch A: for each side of the tile a CTA owns KO = 32 positions of that
side and walks one chunk of the other side in steps of KN = 64 positions.
Per step it stages the 32 x 64 count block as lines along X's unit stride
(the kernel's line map, replayed here from X's storage and strides),
compacts the present cells own-major, other positions rising, with a slot
for each other position that a present cell needs, and forms each present
cell's S as the exactly rounded bf16 of w_own . w_oth (the kernel's float32
sum, checked against the sum's error bound at the nearest bf16 rounding
midpoint and summed again in float64 where it is within it), then + b_i,
+ b_j and - log x each rounded, the clip, the cost and the loss term at
bf16.  The step's costs and bf16(cost^2) go into a 32 x slots block whose
products with the slots' rows (and their rounded squares) are summed at
float32 into the chunk's partials (the kernel's tensor cores), with the
lines' sums of cost and cost^2; launch B adds the chunks' partials in
order, rounds each sum once and takes the step op by op at bf16.
:func:`_replay` does that; it is held within one bf16 spacing (of the
larger of a cell's value and its change) of ``models/glove.py``
``_glove_tile_plain_bf16(..., exact=True)`` (S and the products summed at
float64, each rounded once) on ragged tiles at r = 16, 40 and 300, an
empty tile, lines without a present cell and a transposed view, each
present cell visited once a side, and against the JAX package's bf16 dense
step run op by op.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bf16_apart
from rsparse_tpu.models import glove as ref_glove
from rsparse_tpu_torch.config import round_bf16 as rb
from rsparse_tpu_torch.config import to_bf16
from rsparse_tpu_torch.models import glove

torch.set_num_threads(2)

#: own positions a CTA, other positions a step (csrc/glove_dense.cu kO, kN)
KO, KN = 32, 64
X_MAX, ALPHA, LR = 10.0, 0.75, 0.05
#: the JAX package's op-by-op head tile: embedding and accumulator cells
#: apart (the JAX function's S is a float32 sum rounded once, the kernel's
#: the exactly rounded one: none measured here; the bound the plain
#: version is held to in tests/test_torch_glove_bf16.py) and the share of
#: bias cells apart (the JAX package sums a tile's cost per line at bf16
#: in its own order; 155 of 600 measured, the same file's bound)
JAX_W_APART = 2
JAX_B_SHARE = 0.5


def _count_block(xs, sr, sc, side, own0, oth0, n_r, n_c):
    """The step's count block (KO own lines x KN other positions) as the
    kernel reads it: lines along X's unit stride (own lines when the other
    side's stride is 1, else other lines), zero outside the tile."""
    n_own, n_oth = (n_c, n_r) if side else (n_r, n_c)
    s_own, s_oth = (sc, sr) if side else (sr, sc)
    lines_own = s_oth == 1
    blk = torch.zeros((KO, KN), dtype=torch.float32)
    for m in range(min(KO, n_own - own0)):
        for n in range(min(KN, n_oth - oth0)):
            el = ((own0 + m) * s_own + oth0 + n if lines_own
                  else (oth0 + n) * s_oth + own0 + m)
            blk[m, n] = xs[el]
    return blk


def _replay(st, rows, cols, x, chunks):
    """K11's bf16-state walk, launches A and B, on bf16 state ``st`` and
    the tile's bf16 counts ``x`` (any strides with a unit one); updates st
    in place and returns (the bf16 loss, the per-side visits of each
    cell)."""
    n_r, n_c = rows.numel(), cols.numel()
    r = st.w_i.shape[1]
    ids = (rows.long(), cols.long())
    W = (st.w_i[ids[0]].float(), st.w_j[ids[1]].float())
    B = (st.b_i[ids[0]].float(), st.b_j[ids[1]].float())
    sr, sc = x.stride()
    assert 1 in (sr, sc)
    xs = torch.as_strided(x, (x.untyped_storage().nbytes()
                              // x.element_size() - x.storage_offset(),),
                          (1,), x.storage_offset()).float()
    width = 2 * r + 2
    part = [torch.zeros((chunks, n, width)) for n in (n_r, n_c)]
    visits = [torch.zeros((n_r, n_c), dtype=torch.int64) for _ in range(2)]
    loss = torch.zeros(())
    own_blocks = math.ceil(max(n_r, n_c) / KO)
    for side in (0, 1):
        n_own, n_oth = (n_r, n_c) if side == 0 else (n_c, n_r)
        steps = math.ceil(n_oth / KN)
        for ob in range(own_blocks):
            own0 = ob * KO
            if own0 >= n_own:
                continue                        # the CTA returns
            for ch in range(chunks):
                P = part[side][ch]
                for step in range(ch * steps // chunks,
                                  (ch + 1) * steps // chunks):
                    oth0 = step * KN
                    blk = _count_block(xs, sr, sc, side, own0, oth0, n_r,
                                       n_c)
                    cells = torch.nonzero(blk > 0)   # own-major, n rising
                    if cells.shape[0] == 0:
                        continue
                    m, n = cells[:, 0], cells[:, 1]
                    slot_pos, slot = torch.unique(n, return_inverse=True)
                    wo, wt = W[side][own0 + m], W[1 - side][oth0 + n]
                    S = to_bf16((wo.double() * wt.double()).sum(1)).float()
                    bo, bt = B[side][own0 + m], B[1 - side][oth0 + n]
                    b_row, b_col = (bt, bo) if side else (bo, bt)
                    xv = blk[m, n]
                    sv = torch.clamp(rb(rb(rb(S + b_row) + b_col)
                                        - rb(torch.log(xv))), -100.0, 100.0)
                    cost = rb(glove._weight_bf16(xv, X_MAX, ALPHA) * sv)
                    if side == 0:
                        loss = loss + rb(cost * sv).sum()
                    C = torch.zeros((KO, slot_pos.numel()))
                    C2 = torch.zeros_like(C)
                    C[m, slot] = cost
                    C2[m, slot] = rb(cost * cost)
                    rows_s = W[1 - side][oth0 + slot_pos]
                    k = min(KO, n_own - own0)
                    P[own0:own0 + k, :r] += (C @ rows_s)[:k]
                    sq = rb(rows_s * rows_s)
                    P[own0:own0 + k, r:2 * r] += (C2 @ sq)[:k]
                    P[own0:own0 + k, 2 * r] += C.sum(1)[:k]
                    P[own0:own0 + k, 2 * r + 1] += C2.sum(1)[:k]
                    i, j = ((oth0 + n, own0 + m) if side else
                            (own0 + m, oth0 + n))
                    visits[side][i, j] += 1
    for side, tabs in enumerate((st[0::2], st[1::2])):
        s = part[side][0].clone()
        for ch in range(1, chunks):             # launch B's fixed order
            s += part[side][ch]
        s = rb(s)
        glove._adagrad_apply_bf16(*tabs, ids[side], s[:, :r], s[:, r:2 * r],
                                  s[:, 2 * r], s[:, 2 * r + 1], LR)
    return rb(loss), visits


def _case(seed, n_r, n_c, r, vocab=400, density=0.15):
    """A bf16 state over ``vocab`` ids and a ragged tile of distinct row
    and column ids with bf16 counts (some above x_max)."""
    rng = np.random.default_rng(seed)
    a = [rng.standard_normal((vocab, r)) * 0.3,
         rng.standard_normal((vocab, r)) * 0.3,
         rng.standard_normal(vocab) * 0.1, rng.standard_normal(vocab) * 0.1,
         1.0 + rng.random((vocab, r)), 1.0 + rng.random((vocab, r)),
         1.0 + rng.random(vocab), 1.0 + rng.random(vocab)]
    st = glove.GloveState(*(torch.tensor(v, dtype=torch.bfloat16)
                            for v in a))
    rows = torch.from_numpy(rng.permutation(vocab)[:n_r].astype(np.int32))
    cols = torch.from_numpy(rng.permutation(vocab)[:n_c].astype(np.int32))
    counts = (1.0 + rng.exponential(5.0, (n_r, n_c))) * (
        rng.random((n_r, n_c)) < density)
    return st, rows, cols, torch.from_numpy(counts).to(torch.bfloat16)


def _clone(st):
    return glove.GloveState(*(t.clone() for t in st))


def _hold(st, rows, cols, x, chunks):
    """The replay against the plain version's float64 twin: every cell of
    the eight tables within one bf16 spacing, the loss too; each present
    cell visited once a side and no absent one.  Returns the replay's
    state."""
    sk, sp = _clone(st), _clone(st)
    lk, visits = _replay(sk, rows, cols, x, chunks)
    lp = glove._glove_tile_plain_bf16(sp, rows, cols, x.contiguous(), X_MAX,
                                      ALPHA, LR, exact=True)
    for name, a, b, t0 in zip(glove.GloveState._fields, sk, sp, st):
        over, _, _, _ = bf16_apart(a, b, t0)
        assert over == 0, name
    over, _, _, _ = bf16_apart(lk.reshape(1), lp.reshape(1),
                               torch.zeros(1))
    assert over == 0
    present = x.float() > 0
    for v in visits:
        assert bool((v[present] == 1).all())
        assert int(v[~present].sum()) == 0
    return sk


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("shape", [(150, 97, 16), (97, 150, 40),
                                   (70, 90, 300)])
def test_replay_matches_float64_twin(shape, chunks):
    n_r, n_c, r = shape
    st, rows, cols, x = _case(sum(shape) + chunks, n_r, n_c, r)
    _hold(st, rows, cols, x, chunks)


@pytest.mark.parametrize("chunks", [1, 2])
def test_lines_without_a_present_cell(chunks):
    """A row and a column without a present cell, and a whole own block of
    rows without one: their tables keep their values."""
    st, rows, cols, x = _case(13 + chunks, 100, 130, 40, density=0.05)
    x[7] = 0.0
    x[:, 70] = 0.0
    x[32:64] = 0.0
    sk = _hold(st, rows, cols, x, chunks)
    for t, t0 in ((sk.w_i, st.w_i), (sk.acc_w_i, st.acc_w_i),
                  (sk.b_i, st.b_i)):
        assert torch.equal(t[rows[7].long()], t0[rows[7].long()])
        assert torch.equal(t[rows[40].long()], t0[rows[40].long()])
    assert torch.equal(sk.w_j[cols[70].long()], st.w_j[cols[70].long()])


def test_tile_without_a_present_cell():
    st, rows, cols, x = _case(23, 70, 50, 16)
    x.zero_()
    sk = _clone(st)
    lk, visits = _replay(sk, rows, cols, x, 2)
    assert float(lk) == 0.0 and all(int(v.sum()) == 0 for v in visits)
    for a, b in zip(sk, st):
        assert torch.equal(a, b)


@pytest.mark.parametrize("r", [16, 300])
def test_transposed_view(r):
    """The transposed pass's tile: a view with a unit row stride, whose
    count lines run down X's columns."""
    st, rows, cols, x = _case(37 + r, 90, 75, r)
    xt = x.T.contiguous().T
    assert xt.stride() == (1, 90)
    _hold(st, rows, cols, xt, 2)


@pytest.mark.parametrize("r", [4, 40])
def test_replay_matches_jax_dense_step(r):
    """One tile (a 100-token head in one tile of a 150-token vocabulary)
    against the JAX package's bf16 dense step run op by op."""
    n, H = 150, 100
    rng = np.random.default_rng(9 + r)
    hot = np.sort(rng.choice(n, H, replace=False)).astype(np.int32)
    X = np.where(rng.random((H, H)) < 0.25,
                 1.0 + rng.exponential(8.0, (H, H)), 0.0).astype(np.float32)
    grids = ref_glove._head_grids(X, hot, jnp.bfloat16, 1 << 20)
    a = [rng.uniform(-0.5, 0.5, s) for s in ((n, r), (n, r), (n,), (n,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n, r), (n, r), (n,), (n,))]
    sj = ref_glove.GloveState(*(jnp.asarray(v, jnp.bfloat16) for v in a))
    st = glove.GloveState(*(torch.tensor(v, dtype=torch.bfloat16)
                            for v in a))
    with jax.disable_jit():
        sj, lj = ref_glove._glove_dense_step_impl(
            ref_glove._DIRECT, sj, *grids, x_max=X_MAX, alpha=ALPHA, lr=LR)
    ids = torch.from_numpy(hot)
    xb = torch.from_numpy(X).to(torch.bfloat16)
    lk, _ = _replay(st, ids, ids, xb, 2)
    apart = [int((p.float().numpy() != np.asarray(q, np.float32)).sum())
             for p, q in zip(st, sj)]
    print(f"r={r}: cells apart from the JAX step {apart}")
    assert apart[0] + apart[1] + apart[4] + apart[5] <= JAX_W_APART
    assert apart[2] + apart[3] + apart[6] + apart[7] <= JAX_B_SHARE * 4 * n
    spacing = 2.0 ** (np.floor(np.log2(abs(float(lj)))) - 7)
    assert abs(0.5 * float(lk) - float(lj)) <= spacing
