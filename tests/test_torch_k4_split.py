"""K4's split (``csrc/als_nnls.cu``) replayed in plain torch on the CPU.

K4 solves a bucket of NNLS systems in three launches: a build stage writes
each system's G = lhs' lhs + eps I as its packed lower triangle (G[i, k] =
P[i (i + 1) / 2 + k] for i >= k) and mu = G x0 - lhs' rhs to a scratch
buffer, a slice of systems at a time; a sweep stage runs the coordinate
sweeps one system per warp, reading G[i, k] as row k of P for i < k and
column k for i >= k, each warp taking the next system from a counter; then
the loss.  :func:`_replay` does the build and the sweeps in that form
(float64, slices of the scratch, systems taken in a given order), and is
held against ``ops/solvers.py`` ``batched_nnls`` (the plain version) one
system at a time to 1e-10 (max |a - b| / max(max |b|, 1)), with the same
sweep counts.  The sweep's float32 quotient mu_k / G_kk, one multiply by
the correctly rounded 1 / G_kk and one correction, is held to the plain
version's division exactly.
Inputs: numpy (seed per width) SPD lhs of condition numbers from 2 to 40,
so that systems stop after different numbers of sweeps and one runs to the
budget, at d = 10, 64, 128 and 129, from a zero start and from the
absolute value of a random start.
"""

import numpy as np
import pytest
import torch

from rsparse_tpu_torch.ops import solvers

torch.set_num_threads(2)

#: the budget of these tests: one system of each batch runs to it
MAX_ITER = 40


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _sys_floats(d: int) -> int:
    """Floats of one system in K4's scratch: packed G, then mu, each
    padded to 16 bytes (csrc/als_nnls.cu sys_floats)."""
    return _round4(_tri(d)) + _round4(d)


def _pack(G: np.ndarray) -> np.ndarray:
    """The build stage's packed lower triangle, row by row."""
    d = G.shape[0]
    P = np.zeros(_round4(_tri(d)))
    for i in range(d):
        P[_tri(i):_tri(i) + i + 1] = G[i, :i + 1]
    return P


def _column_index(d: int):
    """For each coordinate step k, where lane i (every i < d) reads G[i, k]
    in P: row k (tri(k) + i) for i < k, column k (tri(i) + k) for i >= k."""
    i = np.arange(d)
    ti = i * (i + 1) // 2
    return [np.where(i < k, _tri(k) + i, ti + k) for k in range(d)]


def _replay(lhs, rhs, x0, slice_, order, max_iter=MAX_ITER,
            rel_tol=solvers.SCD_TOL):
    """K4's build and sweep stages at float64: per slice of ``slice_``
    systems, build each system's packed G and mu into the scratch, then
    sweep the slice's systems in ``order`` (positions within the slice) from
    the scratch alone.  Returns (x (B, d), sweeps (B,))."""
    B, d = x0.shape
    stride = _sys_floats(d)
    gf = _round4(_tri(d))
    cols = _column_index(d)
    x_out = np.zeros((B, d))
    sweeps = np.zeros(B, np.int64)
    for s0 in range(0, B, slice_):
        n = min(slice_, B - s0)
        scratch = np.full(n * stride, np.nan)
        for s in range(n):                       # (1) the build stage
            b = s0 + s
            G = lhs[b].T @ lhs[b] + solvers.NNLS_EPS * np.eye(d)
            mu = G @ x0[b] - lhs[b].T @ rhs[b]
            scratch[s * stride:s * stride + gf] = _pack(G)
            scratch[s * stride + gf:s * stride + gf + d] = mu
        for s in order(n):                       # (2) the sweep stage
            b = s0 + s
            P = scratch[s * stride:s * stride + gf]
            mu = scratch[s * stride + gf:s * stride + gf + d].copy()
            x = x0[b].copy()
            t, rel = 0, np.inf
            while t < max_iter and rel > rel_tol:
                start = x.copy()
                for k in range(d):
                    nw = max(x[k] - mu[k] / P[_tri(k) + k], 0.0)
                    mu += (nw - x[k]) * P[cols[k]]
                    x[k] = nw
                # the stop test once per sweep, over every coordinate
                rel = (np.abs(x - start)
                       / (np.abs(start) + solvers.NNLS_EPS)).max()
                t += 1
            x_out[b] = x
            sweeps[b] = t
    return x_out, sweeps


def _batch(d: int, B: int = 5):
    """SPD lhs of condition numbers 2 to 40, geometrically spaced (G
    squares them: the best conditioned stop within a few sweeps, the last
    runs to MAX_ITER), and a rhs whose solution has coordinates of both
    signs, so that some end at the bound."""
    rng = np.random.default_rng(d)
    lhs = np.empty((B, d, d))
    for b, cond in enumerate(np.geomspace(2, 40, B)):
        q, _ = np.linalg.qr(rng.standard_normal((d, d)))
        lhs[b] = (q * np.geomspace(1, cond, d)) @ q.T
    rhs = lhs @ rng.standard_normal((B, d))[..., None]
    return lhs, rhs[..., 0], rng.standard_normal((B, d))


@pytest.mark.parametrize("d", [10, 64, 128, 129])
def test_packed_index_map_reproduces_g(d):
    """Every G[i, k] a sweep step reads from the packed triangle is G's own
    entry, bit for bit (G symmetric, as the build's G = lhs lhs is: both
    triangles sum the same products in the same order)."""
    rng = np.random.default_rng(d)
    a = rng.standard_normal((d, d))
    G = a @ a.T
    G = np.tril(G) + np.tril(G, -1).T
    P = _pack(G)
    assert P.size == _round4(_tri(d)) and P.size % 4 == 0
    for k, idx in enumerate(_column_index(d)):
        np.testing.assert_array_equal(P[idx], G[:, k])
        assert P[_tri(k) + k] == G[k, k]
    assert _sys_floats(d) % 4 == 0 and _sys_floats(d) >= _tri(d) + d


@pytest.mark.parametrize("start", ["zero", "abs"])
@pytest.mark.parametrize("d", [10, 64, 128, 129])
def test_split_matches_batched_nnls(d, start):
    """The build, then the sweeps from (packed G, mu, x0) alone, equal
    batched_nnls one system at a time (and with the same sweeps); the
    systems stop after different numbers of sweeps, the last at the
    budget; every factor is >= 0 and some sit at the bound."""
    lhs, rhs, x0 = _batch(d)
    x0 = np.zeros_like(x0) if start == "zero" else np.abs(x0)
    x, sw = _replay(lhs, rhs, x0, slice_=len(x0), order=range)
    assert (x >= 0).all() and (x == 0).any()
    for b in range(len(x0)):
        xp, sp = solvers.batched_nnls(
            torch.from_numpy(lhs[b:b + 1]), torch.from_numpy(rhs[b:b + 1]),
            torch.from_numpy(x0[b:b + 1]), max_iter=MAX_ITER,
            return_sweeps=True)
        xp = xp.numpy()[0]
        assert np.abs(x[b] - xp).max() <= 1e-10 * max(np.abs(xp).max(), 1)
        assert sw[b] == int(sp[0])
    assert len(set(sw.tolist())) > 2
    assert sw[-1] == MAX_ITER and (sw < MAX_ITER).sum() >= 2


@pytest.mark.parametrize("d", [10, 129])
def test_split_does_not_depend_on_order_or_slices(d):
    """Systems taken in another order, or built and swept in slices of the
    scratch (as a bucket larger than the wrapper's scratch is), give the
    same factors and sweeps, bit for bit."""
    lhs, rhs, x0 = _batch(d)
    x0 = np.abs(x0)
    x, sw = _replay(lhs, rhs, x0, slice_=len(x0), order=range)
    for slice_, order in ((len(x0), lambda n: range(n - 1, -1, -1)),
                          (2, range),
                          (3, lambda n: np.random.default_rng(n).permutation(
                              n))):
        xo, so = _replay(lhs, rhs, x0, slice_, order)
        np.testing.assert_array_equal(xo, x)
        np.testing.assert_array_equal(so, sw)


def _f32(x):
    return np.float32(x)


def _quotient(mk, g):
    """The sweep's mu_k / G_kk in float32: r = RN(1 / g), q0 = RN(mk r),
    q = RN(q0 + RN(mk - g q0) r), each FMA's one rounding emulated in
    float64 (products of two float32 values are exact there)."""
    r = _f32(1.0) / g
    q0 = _f32(mk * r)
    rem = _f32(np.float64(mk) - np.float64(g) * np.float64(q0))
    return _f32(np.float64(q0) + np.float64(rem) * np.float64(r))


def test_sweep_quotient_is_the_correctly_rounded_division():
    """One correction of mk * RN(1 / g) gives mk / g correctly rounded in
    float32, as the plain version's division does, over magnitudes a fitted
    G and mu hold (signed mu, positive G_kk)."""
    rng = np.random.default_rng(0)
    mk = (rng.standard_normal(20_000)
          * 10.0 ** rng.uniform(-8, 8, 20_000)).astype(np.float32)
    g = (10.0 ** rng.uniform(-6, 8, 20_000)).astype(np.float32)
    q = np.array([_quotient(a, b) for a, b in zip(mk, g)])
    np.testing.assert_array_equal(q, mk / g)

