"""K11's decomposition (``csrc/glove_dense.cu``, the bf16 head on the
tensor cores) replayed in plain torch on the CPU.

Launch A: for each side of the tile, a CTA owns KO positions of that side
and walks one chunk of the other side in steps of KN positions; per step
it forms its block of S = bf16(w_own) bf16(w_oth)' (its own sum: the row
side's S[i, j] and the column side's S[j, i] are summed apart), the cost
and cost^2 with the reference's bf16 rounding points, and adds cost @
w_oth, cost^2 @ bf16(w_oth^2), and the row sums of cost and cost^2 into
its partial sums, one set a chunk; the row side also sums cost * S.
Launch B sums the chunks' partials in a fixed order and applies the
accumulator-first AdaGrad step.  :func:`_replay_tile` does exactly that
and is held against ``models/glove.py`` ``_glove_tile_plain`` on ragged
tiles (n_r != n_c, neither a multiple of 64), at float64 without rounding
to 1e-10, and with the bf16 head (float32 state) to K11's limit: each
table's change within 1e-5, or no further from the plain version at
float64 (the same bf16 roundings) than twice the float32 plain version.
The replay's walk visits every cell exactly once per side.
"""

import math

import numpy as np
import pytest
import torch

from rsparse_tpu_torch.models import glove

torch.set_num_threads(2)

#: own positions a CTA, other positions a step (csrc/glove_dense.cu kMO,
#: kMN)
KO = KN = 64
X_MAX, ALPHA, LR = 10.0, 0.75, 0.05


def _rounder(cdt, acc):
    if cdt == acc:
        return lambda t: t
    return lambda t: t.to(cdt).to(acc)


def _replay_tile(st, rows, cols, x, cdt, chunks):
    """K11's launches A and B at st's dtype; updates st in place and
    returns (sum(cost * S), the per-side visit counts of each cell)."""
    acc = st.w_i.dtype
    rd = _rounder(cdt, acc)
    n_r, n_c = rows.numel(), cols.numel()
    r = st.w_i.shape[1]
    ids = (rows.long(), cols.long())
    gw = (rd(st.w_i[ids[0]]), rd(st.w_j[ids[1]]))
    gw2 = tuple(rd(t * t) for t in gw)
    gb = (st.b_i[ids[0]], st.b_j[ids[1]])
    X = x.to(acc)
    own_blocks = math.ceil(max(n_r, n_c) / KO)
    part = [torch.zeros((chunks, n, 2 * r + 2), dtype=acc)
            for n in (n_r, n_c)]
    visits = [torch.zeros((n_r, n_c), dtype=torch.int64) for _ in range(2)]
    loss = torch.zeros((), dtype=acc)
    for side in (0, 1):
        n_own, n_oth = (n_r, n_c) if side == 0 else (n_c, n_r)
        steps = math.ceil(n_oth / KN)
        for ob in range(own_blocks):
            if ob * KO >= n_own:
                continue                        # the CTA returns
            P = slice(ob * KO, min((ob + 1) * KO, n_own))
            for ch in range(chunks):
                for step in range(ch * steps // chunks,
                                  (ch + 1) * steps // chunks):
                    Q = slice(step * KN, min((step + 1) * KN, n_oth))
                    S = gw[side][P] @ gw[1 - side][Q].T
                    if side == 0:
                        xb = X[P, Q]
                        b_row, b_col = gb[0][P][:, None], gb[1][Q][None, :]
                        visits[0][P, Q] += 1
                    else:
                        xb = X[Q, P].T
                        b_row, b_col = gb[0][Q][None, :], gb[1][P][:, None]
                        visits[1][Q, P] += 1
                    present = xb > 0
                    lx = torch.log(torch.where(present, xb, 1.0))
                    w = torch.where(present, torch.where(
                        xb < X_MAX, torch.pow(xb / X_MAX, ALPHA), 1.0), 0.0)
                    sv = torch.clamp(S + b_row + b_col - lx, -100.0, 100.0)
                    cost = torch.where(present, rd(rd(w) * rd(sv)), 0.0)
                    c2 = rd(cost * cost)
                    blk = part[side][ch, P]
                    blk[:, :r] += cost @ gw[1 - side][Q]
                    blk[:, r:2 * r] += c2 @ gw2[1 - side][Q]
                    blk[:, 2 * r] += cost.sum(1)
                    blk[:, 2 * r + 1] += c2.sum(1)
                    if side == 0:
                        loss = loss + (cost * sv).sum()
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
    return loss, visits


def _case(seed, n_r, n_c, r, vocab=400, density=0.15):
    """A fitted-looking state over ``vocab`` ids and a ragged tile of
    distinct row and column ids with bf16 counts (some above x_max)."""
    rng = np.random.default_rng(seed)
    st = glove.GloveState(
        *(torch.from_numpy(a) for a in (
            rng.standard_normal((vocab, r)).astype(np.float32) * 0.3,
            rng.standard_normal((vocab, r)).astype(np.float32) * 0.3,
            rng.standard_normal(vocab).astype(np.float32) * 0.1,
            rng.standard_normal(vocab).astype(np.float32) * 0.1,
            (1.0 + rng.random((vocab, r))).astype(np.float32),
            (1.0 + rng.random((vocab, r))).astype(np.float32),
            (1.0 + rng.random(vocab)).astype(np.float32),
            (1.0 + rng.random(vocab)).astype(np.float32))))
    rows = torch.from_numpy(rng.permutation(vocab)[:n_r].astype(np.int32))
    cols = torch.from_numpy(rng.permutation(vocab)[:n_c].astype(np.int32))
    counts = (1.0 + rng.exponential(5.0, (n_r, n_c))) * (
        rng.random((n_r, n_c)) < density)
    x = torch.from_numpy(counts.astype(np.float32)).to(torch.bfloat16)
    return st, rows, cols, x


def _clone(st, dtype=None):
    return glove.GloveState(*(t.clone() if dtype is None else t.to(dtype)
                              for t in st))


@pytest.mark.parametrize("shape", [(150, 97, 16), (97, 150, 40),
                                   (64, 130, 24)])
@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_replay_matches_plain_float64(shape, chunks):
    n_r, n_c, r = shape
    st, rows, cols, x = _case(sum(shape) + chunks, n_r, n_c, r)
    s64 = _clone(st, torch.float64)
    p64 = _clone(s64)
    lk, visits = _replay_tile(s64, rows, cols, x.double(), torch.float64,
                              chunks)
    lp = glove._glove_tile_plain(p64, rows, cols, x.double(), X_MAX, ALPHA,
                                 LR, torch.float64)
    for name, a, b, t0 in zip(glove.GloveState._fields, s64, p64, st):
        scale = max(float((b - t0.double()).abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-10 * scale, name
    assert abs(float(lk) - float(lp)) <= 1e-10 * abs(float(lp))
    for v in visits:
        assert int(v.min()) == 1 and int(v.max()) == 1


@pytest.mark.parametrize("shape", [(150, 97, 16), (97, 150, 40)])
def test_replay_bf16_head_holds_k11_limit(shape):
    """float32 state, bf16 counts and operands: the cost, cost^2 and w^2
    rounding points of the plain version, sums in float32 in the replay's
    own order."""
    n_r, n_c, r = shape
    st, rows, cols, x = _case(7 * sum(shape), n_r, n_c, r)
    bf = torch.bfloat16
    sk, sp, s64 = _clone(st), _clone(st), _clone(st, torch.float64)
    lk, _ = _replay_tile(sk, rows, cols, x, bf, chunks=2)
    lp = glove._glove_tile_plain(sp, rows, cols, x, X_MAX, ALPHA, LR, bf)
    l64 = glove._glove_tile_plain(s64, rows, cols, x, X_MAX, ALPHA, LR, bf)
    for name, a, b, c, t0 in zip(glove.GloveState._fields + ("loss",),
                                 (*sk, lk), (*sp, lp), (*s64, l64),
                                 (*st, torch.zeros(()))):
        change = max(float((b.double() - t0.double()).abs().max()), 1e-30)
        rel = float((a.double() - b.double()).abs().max()) / change
        ek = float((a.double() - c).abs().max())
        ep = float((b.double() - c).abs().max())
        assert rel <= 1e-5 or ek <= 2 * ep, (name, rel, ek, ep)


def test_bf16_rounding_points_are_the_plain_versions():
    """At float64 sums (no sum lands on a bf16 rounding boundary the other
    way) the replay with the bf16 head's rounding points -- cost, cost^2,
    bf16(w^2) -- equals the plain version's to 1e-10: they are the same
    rounding points."""
    st, rows, cols, x = _case(5, 70, 90, 16, density=0.3)
    bf = torch.bfloat16
    s64 = _clone(st, torch.float64)
    p64 = _clone(s64)
    _replay_tile(s64, rows, cols, x.double(), bf, chunks=2)
    glove._glove_tile_plain(p64, rows, cols, x.double(), X_MAX, ALPHA, LR, bf)
    for name, a, b, t0 in zip(glove.GloveState._fields, s64, p64, st):
        scale = max(float((b - t0.double()).abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-10 * scale, name
