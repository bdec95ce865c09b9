"""K11's f32 head (``csrc/glove_dense.cu`` ``glove_tile_sums``, GloVe's
default compute dtype) replayed in plain torch on the CPU.

Launch A: for each side of the tile a CTA owns KO = 32 positions of that
side and walks one chunk of the other side in steps of KN = 64 positions.
Per step it stages the 32 x 64 count block own-major along X's unit stride
(the kernel's index map, replayed here from X's storage and strides),
compacts its present cells by ballots (own-major, other positions rising;
a slot for every other position that a present cell needs), stages only
the needed other rows, forms S, the cost and the loss term one present
cell at a time (the cell's own line found by a binary search of the
lines' starts) and adds cost w_oth, cost^2 w_oth^2, cost and cost^2 into
its own lines' sums, one set of partials a chunk.  Launch B sums the
chunks' partials in a fixed order and takes the accumulator-first AdaGrad
step.  :func:`_replay_tile` does exactly that; it is held against
``models/glove.py`` ``_glove_tile_plain`` at float64 to 1e-10 (ragged
tiles, r = 16, 40, 300, empty lines, an empty tile, a transposed view),
each present cell visited once a side and no absent one, and against the
JAX package's dense step.  The ML-100k cost history that ``chip_smoke.py``
holds the f32 head to on the card (``REF_GLOVE_F32``) is the JAX
package's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsparse_tpu as rt_ref
from rsparse_tpu.models import glove as ref_glove
from rsparse_tpu_torch.convert import glove_state_from_numpy
from rsparse_tpu_torch.models import glove

torch.set_num_threads(2)

#: own positions a CTA, other positions a step, the staged count line's
#: stride (csrc/glove_dense.cu kO, kN, kLdc)
KO, KN, LDC = 32, 64, 65
X_MAX, ALPHA, LR = 10.0, 0.75, 0.05
TOL = 1e-10


def _popc(v: int) -> int:
    return bin(v).count("1")


def _stage_counts(xs, sr, sc, side, own0, oth0, n_r, n_c):
    """load_counts: the step's count block, own-major at stride LDC, read
    from the storage ``xs`` by the kernel's index map (zero past the
    tile)."""
    A, Bn = (KN, KO) if side else (KO, KN)
    b_fast = sc == 1
    cnt = torch.zeros(KO * LDC, dtype=xs.dtype)
    for q in range(KO * KN):
        al, bl = (q // Bn, q % Bn) if b_fast else (q % A, q // A)
        a0, b0 = (oth0, own0) if side else (own0, oth0)
        ra, cb = a0 + al, b0 + bl
        ol, tl = (bl, al) if side else (al, bl)
        if ra < n_r and cb < n_c:
            cnt[ol * LDC + tl] = xs[ra * sr + cb * sc]
    return cnt


def _compact(cnt):
    """The ballots of compact(): (row0 (KO + 1,), slot_pos, cells as (e,
    line, slot, x)).  Line m's cells take [row0[m], row0[m + 1])."""
    lo, hi = [], []
    for m in range(KO):
        line = cnt[m * LDC:m * LDC + KN] > 0
        lo.append(sum(1 << n for n in range(32) if line[n]))
        hi.append(sum(1 << n for n in range(32) if line[32 + n]))
    nlo = nhi = 0
    for m in range(KO):
        nlo |= lo[m]
        nhi |= hi[m]
    row0 = [0]
    for m in range(KO):
        row0.append(row0[-1] + _popc(lo[m]) + _popc(hi[m]))
    slot_pos = ([n for n in range(32) if nlo >> n & 1]
                + [32 + n for n in range(32) if nhi >> n & 1])
    cells = []
    for m in range(KO):
        for n in range(KN):
            h, b = divmod(n, 32)
            bits = hi[m] if h else lo[m]
            if not bits >> b & 1:
                continue
            lt = (1 << b) - 1
            e = row0[m] + (_popc(lo[m]) + _popc(hi[m] & lt) if h
                           else _popc(lo[m] & lt))
            slot = (_popc(nlo) + _popc(nhi & lt) if h else _popc(nlo & lt))
            cells.append((e, m, slot, float(cnt[m * LDC + n])))
    cells.sort()
    assert [c[0] for c in cells] == list(range(len(cells)))
    return row0, slot_pos, cells


def _line_of(row0, e):
    """The S phase's binary search: the last line whose cells start at or
    before e."""
    m = 0
    h = 16
    while h:
        if row0[m + h] <= e:
            m += h
        h >>= 1
    return m


def _replay_tile(st, rows, cols, x, chunks):
    """K11's f32 head, launches A and B at st's dtype, on the tile counts
    ``x`` (any strides); updates st in place and returns (sum(cost * S),
    the per-side visits of each cell, the steps that held no present
    cell)."""
    acc = st.w_i.dtype
    n_r, n_c = rows.numel(), cols.numel()
    r = st.w_i.shape[1]
    ids = (rows.long(), cols.long())
    W = (st.w_i[ids[0]], st.w_j[ids[1]])
    B = (st.b_i[ids[0]], st.b_j[ids[1]])
    sr, sc = x.stride()
    xs = torch.as_strided(x, (x.untyped_storage().nbytes()
                              // x.element_size() - x.storage_offset(),),
                          (1,), x.storage_offset()).to(acc)
    own_blocks = math.ceil(max(n_r, n_c) / KO)
    width = 2 * r + 2
    part = [torch.zeros((chunks, n, width), dtype=acc) for n in (n_r, n_c)]
    visits = [torch.zeros((n_r, n_c), dtype=torch.int64) for _ in range(2)]
    loss = torch.zeros((), dtype=acc)
    empty = 0
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
                    cnt = _stage_counts(xs, sr, sc, side, own0, oth0, n_r,
                                        n_c)
                    row0, slot_pos, cells = _compact(cnt)
                    if not cells:
                        empty += 1
                        continue
                    staged = W[1 - side][[oth0 + n for n in slot_pos]]
                    b_st = B[1 - side][[oth0 + n for n in slot_pos]]
                    cost = []
                    for e, m, slot, xv in cells:
                        assert _line_of(row0, e) == m
                        s = torch.dot(W[side][own0 + m], staged[slot])
                        b_own, b_oth = B[side][own0 + m], b_st[slot]
                        b_row, b_col = (b_oth, b_own) if side else (b_own,
                                                                    b_oth)
                        xt = torch.tensor(xv, dtype=acc)
                        sv = torch.clamp(s + b_row + b_col - torch.log(xt),
                                         -100.0, 100.0)
                        w = (torch.pow(xt / X_MAX, ALPHA) if xv < X_MAX
                             else torch.ones((), dtype=acc))
                        cost.append(w * sv)
                        if side == 0:
                            loss = loss + w * sv * sv
                        n = slot_pos[slot]
                        i, j = ((oth0 + n, own0 + m) if side
                                else (own0 + m, oth0 + n))
                        visits[side][i, j] += 1
                    # the products: line by line, other positions rising
                    for m in range(KO):
                        for e in range(row0[m], row0[m + 1]):
                            cv, o = cost[e], staged[cells[e][2]]
                            p = own0 + m
                            P[p, :r] += cv * o
                            P[p, r:2 * r] += cv * cv * o * o
                            P[p, 2 * r] += cv
                            P[p, 2 * r + 1] += cv * cv
    for side, (w, b, aw, ab) in enumerate(((st.w_i, st.b_i, st.acc_w_i,
                                            st.acc_b_i),
                                           (st.w_j, st.b_j, st.acc_w_j,
                                            st.acc_b_j))):
        s = part[side][0].clone()
        for ch in range(1, chunks):             # launch B's fixed order
            s += part[side][ch]
        f = ids[side]
        av = aw[f] + s[:, r:2 * r]
        w[f] += -LR * s[:, :r] / torch.sqrt(av)
        aw[f] = av
        avb = ab[f] + s[:, 2 * r + 1]
        b[f] += -LR * s[:, 2 * r] / torch.sqrt(avb)
        ab[f] = avb
    return loss, visits, empty


def _case(seed, n_r, n_c, r, vocab=400, density=0.15):
    """A fitted-looking float64 state over ``vocab`` ids and a ragged tile
    of distinct row and column ids (some counts above x_max)."""
    rng = np.random.default_rng(seed)
    st = glove.GloveState(
        *(torch.from_numpy(a) for a in (
            rng.standard_normal((vocab, r)) * 0.3,
            rng.standard_normal((vocab, r)) * 0.3,
            rng.standard_normal(vocab) * 0.1,
            rng.standard_normal(vocab) * 0.1,
            1.0 + rng.random((vocab, r)), 1.0 + rng.random((vocab, r)),
            1.0 + rng.random(vocab), 1.0 + rng.random(vocab))))
    rows = torch.from_numpy(rng.permutation(vocab)[:n_r].astype(np.int32))
    cols = torch.from_numpy(rng.permutation(vocab)[:n_c].astype(np.int32))
    counts = (1.0 + rng.exponential(5.0, (n_r, n_c))) * (
        rng.random((n_r, n_c)) < density)
    return st, rows, cols, torch.from_numpy(counts)


def _clone(st):
    return glove.GloveState(*(t.clone() for t in st))


def _hold(st, rows, cols, x, chunks):
    """The replay against the plain version at float64; returns the
    replay's visits and empty steps."""
    sk, sp = _clone(st), _clone(st)
    lk, visits, empty = _replay_tile(sk, rows, cols, x, chunks)
    lp = glove._glove_tile_plain(sp, rows, cols, x.contiguous(), X_MAX,
                                 ALPHA, LR, torch.float64)
    for name, a, b, t0 in zip(glove.GloveState._fields, sk, sp, st):
        scale = max(float((b - t0).abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= TOL * scale, name
    assert abs(float(lk) - float(lp)) <= TOL * max(abs(float(lp)), 1e-30)
    present = x > 0
    for v in visits:                 # each present cell once a side
        assert bool((v[present] == 1).all())
        assert int(v[~present].sum()) == 0
    return visits, empty


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("shape", [(150, 97, 16), (97, 150, 40),
                                   (70, 90, 300)])
def test_replay_matches_plain_float64(shape, chunks):
    n_r, n_c, r = shape
    st, rows, cols, x = _case(sum(shape) + chunks, n_r, n_c, r)
    _hold(st, rows, cols, x, chunks)


@pytest.mark.parametrize("chunks", [1, 2])
def test_lines_without_a_present_cell(chunks):
    """A row and a column of the tile with no present cell, and a whole
    own block of rows without one: their partial sums stay zero and their
    steps stage nothing."""
    st, rows, cols, x = _case(11 + chunks, 100, 130, 40, density=0.05)
    x[7] = 0.0
    x[:, 70] = 0.0
    x[32:64] = 0.0
    sk = _clone(st)
    _hold(st, rows, cols, x, chunks)
    _replay_tile(sk, rows, cols, x, chunks)
    for t, t0 in ((sk.w_i, st.w_i), (sk.acc_w_i, st.acc_w_i)):
        assert torch.equal(t[rows[7].long()], t0[rows[7].long()])
    assert torch.equal(sk.w_j[cols[70].long()], st.w_j[cols[70].long()])


def test_tile_without_a_present_cell():
    """Every step is empty: nothing is staged, the tables keep their
    values and the loss is 0."""
    st, rows, cols, x = _case(21, 70, 50, 16)
    x.zero_()
    sk = _clone(st)
    lk, visits, empty = _replay_tile(sk, rows, cols, x, 2)
    assert float(lk) == 0.0 and all(int(v.sum()) == 0 for v in visits)
    steps = 3 * 1 + 2 * 2                # (own blocks x steps) a side
    assert empty == steps
    for a, b in zip(sk, st):
        assert torch.equal(a, b)


@pytest.mark.parametrize("r", [16, 300])
def test_transposed_view(r):
    """The transposed pass's tile is a view with a unit row stride (sr =
    1): the count block is then staged down X's columns."""
    st, rows, cols, x = _case(31 + r, 90, 75, r)
    xt = x.T.contiguous().T          # the same counts, column-major
    assert xt.stride() == (1, 90)
    _hold(st, rows, cols, xt, 2)


def test_compaction_order_and_slots():
    """compact(): cells own-major with other positions rising (the dense
    walk's order), every needed other position one slot in rising order,
    no slot for a position without a present cell."""
    rng = np.random.default_rng(5)
    for density in (0.02, 0.3, 1.0):
        cnt = torch.zeros(KO * LDC, dtype=torch.float64)
        block = torch.from_numpy(
            (rng.random((KO, KN)) < density) * (1 + rng.random((KO, KN))))
        for m in range(KO):
            cnt[m * LDC:m * LDC + KN] = block[m]
        row0, slot_pos, cells = _compact(cnt)
        want = [(m, n) for m in range(KO) for n in range(KN)
                if block[m, n] > 0]
        assert [(m, slot_pos[s]) for _, m, s, _ in cells] == want
        assert slot_pos == sorted({n for _, n in want})
        assert row0[-1] == len(want) <= KO * KN


def test_replay_matches_jax_dense_step():
    """One tile (a 100-token head in one tile of a 150-token vocabulary):
    the replay's step against the JAX package's dense step at float64."""
    n, H, r = 150, 100, 8
    rng = np.random.default_rng(9)
    hot = np.sort(rng.choice(n, H, replace=False)).astype(np.int32)
    X = np.where(rng.random((H, H)) < 0.2,
                 1.0 + rng.exponential(8.0, (H, H)), 0.0)
    grids = ref_glove._head_grids(X, hot, jnp.float64, 1_000_000)
    a = [rng.uniform(-0.5, 0.5, s) for s in ((n, r), (n, r), (n,), (n,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n, r), (n, r), (n,), (n,))]
    sj = ref_glove.GloveState(*(jnp.asarray(v) for v in a))
    st = glove_state_from_numpy(a, "double", "cpu")
    sj, lj = ref_glove._glove_dense_step(sj, *grids, x_max=X_MAX,
                                         alpha=ALPHA, lr=LR)
    ids = torch.from_numpy(hot)
    lk, _, _ = _replay_tile(st, ids, ids, torch.from_numpy(X), 2)
    np.testing.assert_allclose(0.5 * float(lk), float(lj), rtol=TOL)
    for name, p, q in zip(glove.GloveState._fields, st, sj):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=0,
                                   atol=TOL, err_msg=name)


def test_reference_cost_history_f32():
    """``chip_smoke.REF_GLOVE_F32``, the ML-100k cost history that
    chip_smoke.py phase 8 (b) holds K11's f32 head to on the card, is the
    JAX package's at the default compute dtype (float32 state) on the same
    input and model."""
    import chip_smoke
    assert "compute_dtype" not in chip_smoke.GLOVE_F32_KW
    x = chip_smoke.ml100k_cooccurrence(rt_ref.load_movielens100k())
    m = rt_ref.GloVe(**chip_smoke.GLOVE_F32_KW)
    m.fit_transform(x, n_iter=3)
    np.testing.assert_allclose(m.cost_history, chip_smoke.REF_GLOVE_F32,
                               rtol=1e-6)
