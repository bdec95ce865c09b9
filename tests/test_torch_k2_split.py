"""K2's decomposition (``csrc/als_chol.cu``) replayed in plain torch on the
CPU.

K2 builds a row's lhs as the lower m16n8 tiles of a weighted Gram on the
tensor cores, pads d to D (a multiple of 16) with an identity block,
appends the rhs as row D of the matrix, and factors right-looking in
panels of 16 columns: one warp factors the diagonal block column by
column with the reference's pivot guard (piv = sqrt(max(A_jj, 0)), divisor
1 if 0), one thread per row below solves that row against it (divisor
L_jj, or 1 where it is not positive) -- the rhs row among them, so the
forward substitution comes out of the factorisation -- and all threads
apply the rank-16 trailing update.  One warp then solves L' x = z a row
of L at a time.  :func:`_replay_solve` does exactly that, at the input's
dtype, and is held at float64 against the plain version
(``ops/solvers.py`` ``batched_spd_solve``) and the JAX package's
``batched_spd_solve_blocked`` to 1e-10, on batches that include
non-positive pivots (against the JAX package's guard alone: the plain
version's ``torch.linalg.cholesky`` refuses them).

The Gram's operand rule is emulated on the CPU: tf32 by rounding away the
13 low mantissa bits of a float32 (to nearest, ties away, as
``cvt.rna.tf32.f32``), 3xTF32 as hi hi + hi lo + lo hi, bf16 products
exactly, every sum in float32; under ``compute_dtype="bfloat16"`` each
implicit cold entry is summed both ways, (bf16(w x), x) and (x, bf16(w
x)), and each head entry with weight 2 W1, then halved.  Solved with the
replay in float32, the result must stay within K2's limit of the float32
plain version (y 1e-4) or no further from float64 than twice the plain
version (Frobenius), on well-conditioned and fitted-like buckets at d =
10, 128 and 129.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsparse_tpu.ops import solvers as ref
from rsparse_tpu_torch.ops import solvers

torch.set_num_threads(2)

PANEL = 16


def _padded(d: int) -> int:
    """K2's D (csrc/als_chol.cu make_layout)."""
    return -(-d // PANEL) * PANEL


def _replay_solve(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """K2's factorisation and substitutions at lhs's dtype, reading only
    the lower triangle of lhs (B, d, d); rhs (B, d) -> x (B, d)."""
    B, d = rhs.shape
    D = _padded(d)
    dt = lhs.dtype
    M = torch.zeros((B, D + 1, D), dtype=dt)
    M[:, :d, :d] = torch.tril(lhs)
    idx = torch.arange(d, D)
    M[:, idx, idx] = 1.0
    M[:, D, :d] = rhs
    dinv = torch.empty((B, D), dtype=dt)
    one = torch.ones((), dtype=dt)
    for s in range(0, D, PANEL):
        e = s + PANEL
        blk = M[:, s:e, s:e].clone()
        for j in range(PANEL):          # one warp, one column a step
            piv = torch.sqrt(torch.clamp(blk[:, j, j], min=0))
            safe = torch.where(piv > 0, piv, one)
            blk[:, j:, j] = blk[:, j:, j] / safe[:, None]
            blk[:, j + 1:, j + 1:] -= (blk[:, j + 1:, j, None]
                                       * blk[:, None, j + 1:, j])
        M[:, s:e, s:e] = blk
        ljj = torch.diagonal(blk, dim1=1, dim2=2)
        dinv[:, s:e] = 1.0 / torch.where(ljj > 0, ljj, one)
        R = M[:, e:, s:e].clone()       # the rows below, then the rhs row
        for j in range(PANEL):
            R[:, :, j] = R[:, :, j] * dinv[:, s + j, None]
            R[:, :, j + 1:] -= R[:, :, j, None] * blk[:, None, j + 1:, j]
        M[:, e:, s:e] = R
        if e < D:                       # rank-16 trailing update
            M[:, e:, e:] -= R @ R[:, :-1].transpose(1, 2)
    u = M[:, D, :].clone()              # z = L^-1 rhs
    x = torch.zeros((B, D), dtype=dt)
    for i in reversed(range(D)):        # L' x = z, one row of L a step
        xi = u[:, i] * dinv[:, i]
        x[:, i] = xi
        u[:, :i] -= M[:, i, :i] * xi[:, None]
    return x[:, :d]


def _spd(rng, B, d, cond):
    q, _ = np.linalg.qr(rng.standard_normal((B, d, d)))
    ev = np.geomspace(1.0, 1.0 / cond, d) * (1 + rng.random((B, d)))
    A = np.einsum("bij,bj,bkj->bik", q, ev, q)
    return (A + A.transpose(0, 2, 1)) / 2, rng.standard_normal((B, d))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _jax_blocked(A, b, block):
    return np.asarray(ref.batched_spd_solve_blocked(
        jnp.asarray(A), jnp.asarray(b), block=block))


@pytest.mark.parametrize("d", [10, 64, 128, 129])
def test_replay_matches_plain_and_reference(d):
    rng = np.random.default_rng(d)
    A, b = _spd(rng, 6, d, 1e3)
    x = _replay_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    plain = solvers.batched_spd_solve(torch.from_numpy(A),
                                      torch.from_numpy(b)).numpy()
    assert _rel(x, plain) <= 1e-10
    for block in (16, 32):
        assert _rel(x, _jax_blocked(A, b, block)) <= 1e-10


@pytest.mark.parametrize("pivots", [(0,), (5, 16), (15, 31, 128)])
def test_non_positive_pivots_take_the_reference_guard(pivots):
    """Rows and columns zeroed (pivot 0) or given a negative diagonal
    (pivot < 0), inside a panel and at panel boundaries: the replay keeps
    the JAX package's guard to 1e-10."""
    d = 129
    rng = np.random.default_rng(sum(pivots))
    A, b = _spd(rng, 4, d, 1e2)
    for k, p in enumerate(pivots):
        A[:, p, :] = 0.0
        A[:, :, p] = 0.0
        A[::2, p, p] = -1.0 - k        # negative in half the batch
    x = _replay_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.isfinite(x).all()
    assert _rel(x, _jax_blocked(A, b, 16)) <= 1e-10
    assert _rel(x, _jax_blocked(A, b, 32)) <= 1e-10
    # a zero row and column with divisor 1 leaves x_p = b_p
    np.testing.assert_allclose(x[1::2][:, list(pivots)],
                               b[1::2][:, list(pivots)], rtol=1e-12)


@pytest.mark.parametrize("d", [10, 129])
def test_substitutions_solve_the_factor(d):
    """z (row D after the factorisation) is L^-1 rhs and x is L'^-1 z for
    the replay's own L, to 1e-12; d = 129 pads to D = 144, whose identity
    block leaves the solution alone."""
    rng = np.random.default_rng(3)
    A, b = _spd(rng, 3, d, 1e2)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    L = torch.linalg.cholesky(At)
    z = torch.linalg.solve_triangular(L, bt[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(1, 2), z, upper=True)
    assert _rel(_replay_solve(At, bt), x[..., 0]) <= 1e-12
    assert _padded(d) == (16 if d == 10 else 144)


# -- the Gram's operand rule --------------------------------------------------

def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> tf32 (cvt.rna.tf32.f32: 10 mantissa bits, to nearest,
    ties away from zero), kept in float32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x: np.ndarray):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _gram(a, b):
    """sum_l a_l b_l' in float32 (exact products of tf32 / bf16 values)."""
    return torch.einsum("bli,blj->bij", torch.from_numpy(a),
                        torch.from_numpy(b)).numpy()


def _gram_rule(a, x, route):
    """K2's Gram of weighted rows a = w x and rows x by ``route``."""
    if route == "3xTF32":
        ah, al = _split(a)
        xh, xl = _split(x)
        return _gram(ah, xl) + _gram(al, xh) + _gram(ah, xh)
    if route == "2xTF32":
        ah, al = _split(a)
        return _gram(al, x) + _gram(ah, x)
    if route == "bf16":
        return _gram(a, x)
    assert route == "bf16 both ways"
    return _gram(np.concatenate([a, x], 1), np.concatenate([x, a], 1))


def _bucket(rng, d, kind, explicit, B=8, L=96, H=48):
    """Cold rows X (B, L, d), values c (B, L), head rows Vh (H, d) and
    values W (B, H) (about a third present), as float32.  ``fitted``:
    rows of a matrix whose spectrum falls over four decades, the Gram of
    a fitted factor table."""
    n = 4 * L
    if kind == "well":
        V = rng.standard_normal((n + H, d)) * 0.1
    else:
        U = rng.standard_normal((n + H, d))
        W, _ = np.linalg.qr(rng.standard_normal((d, d)))
        V = (U * np.geomspace(1.0, 1e-2, d)) @ W.T
    V = V.astype(np.float32)
    X = V[rng.integers(0, n, (B, L))]
    if explicit:
        c = rng.integers(1, 6, (B, L)).astype(np.float32)
        Wh = rng.integers(1, 6, (B, H)).astype(np.float32)
    else:
        c = (1.0 + rng.exponential(3.0, (B, L))).astype(np.float32)
        Wh = (1.0 + rng.exponential(3.0, (B, H))).astype(np.float32)
    Wh = Wh * (rng.random((B, H)) < 0.35)
    return X, c, V[n:], Wh.astype(np.float32)


def _normal_equations(X, c, Vh, Wh, explicit, table_bf16, rnd, dt, route=None):
    """The bucket's (lhs, rhs) as the plain version forms them (f32 or f64
    sums, the bf16 rounding points of compute_dtype="bfloat16"), or with
    ``route`` the kernel's Gram under the operand rule (float32)."""
    rb = _bf16 if rnd else (lambda t: t)
    if table_bf16 or rnd:
        X, Vh = _bf16(X), _bf16(Vh)
    B, L, d = X.shape
    lam = 1.0
    if explicit:
        w = np.ones_like(c)
        wh = (Wh != 0).astype(np.float32)
        base = lam * np.eye(d, dtype=np.float32)
        rw, rwh = rb(c), rb(Wh)
    else:
        w = c - 1.0
        wc = rb(Wh)
        wh = np.where(wc > 0, rb(wc - 1.0), 0.0).astype(np.float32)
        V0 = X.reshape(-1, d)[:64]
        base = (V0.T.astype(np.float64) @ V0 + lam * np.eye(d)).astype(
            np.float32)
        rw, rwh = rb(c), rb(Wh)
    a = X * w[..., None]
    a = rb(a) if (rnd and not explicit) else a
    ah = Vh[None] * wh[..., None]                     # (B, H, d)
    xh = np.broadcast_to(Vh[None], ah.shape)
    rhs = (np.einsum("bld,bl->bd", X.astype(dt), rw.astype(dt))
           + np.einsum("hd,bh->bd", Vh.astype(dt), rwh.astype(dt)))
    if route is None:
        G = (np.einsum("bli,blj->bij", a.astype(dt), X.astype(dt))
             + np.einsum("bli,blj->bij", ah.astype(dt), xh.astype(dt)))
        lhs = base.astype(dt)[None] + G
        return (lhs + lhs.transpose(0, 2, 1)) / 2, rhs
    cold, head = route
    doubled = rnd and not explicit
    G = _gram_rule(np.ascontiguousarray(a), X, cold)
    G = G + _gram_rule(np.ascontiguousarray(ah * (2 if doubled else 1)),
                       np.ascontiguousarray(xh), head)
    if doubled:
        G = G * 0.5
        base = (base + base.T) / 2
    return base[None] + G, rhs.astype(np.float32)


#: (explicit, bf16 table, compute_dtype="bfloat16") -> K2's (cold, head)
#: routes (csrc/als_chol.cu gram_route)
RULE_CASES = {
    (False, False, False): ("3xTF32", "3xTF32"),
    (True, False, False): ("3xTF32", "3xTF32"),
    (False, True, False): ("2xTF32", "2xTF32"),
    (False, True, True): ("bf16 both ways", "2xTF32"),
    (True, True, False): ("bf16", "bf16"),
    (True, True, True): ("bf16", "bf16"),
}


@pytest.mark.parametrize("d", [10, 128, 129])
@pytest.mark.parametrize("kind", ["well", "fitted"])
@pytest.mark.parametrize("case", list(RULE_CASES))
def test_operand_rule_holds_k2_limit(d, kind, case):
    explicit, table_bf16, rnd = case
    rng = np.random.default_rng(100 * d + len(kind) + 7 * sum(case))
    X, c, Vh, Wh = _bucket(rng, d, kind, explicit)
    ne = lambda dt, route=None: _normal_equations(  # noqa: E731
        X, c, Vh, Wh, explicit, table_bf16, rnd, dt, route)
    lhs64, rhs64 = ne(np.float64)
    y64 = solvers.batched_spd_solve(torch.from_numpy(lhs64),
                                    torch.from_numpy(rhs64)).numpy()
    lhs32, rhs32 = ne(np.float32)
    y32 = solvers.batched_spd_solve(torch.from_numpy(lhs32),
                                    torch.from_numpy(rhs32)).numpy()
    lhsk, rhsk = ne(np.float32, RULE_CASES[case])
    yk = _replay_solve(torch.from_numpy(lhsk), torch.from_numpy(rhsk)).numpy()
    fro = lambda a: float(np.linalg.norm(a - y64) / np.linalg.norm(y64))  # noqa: E731
    e = float(np.abs(yk - y32).max() / np.abs(y32).max())
    assert np.isfinite(yk).all()
    assert e <= 1e-4 or fro(yk) <= 2 * fro(y32), (e, fro(yk), fro(y32))


def test_symmetrised_gram_is_the_plain_symmetric_part():
    """Under compute_dtype="bfloat16" the implicit lhs XtX + sum bf16(w x)
    x' is not symmetric; summing each entry both ways and halving, with
    the head (a symmetric term) at weight 2 W1 and XtX averaged with its
    transpose, gives the plain version's (lhs + lhs') / 2 (float64 sums,
    1e-12)."""
    rng = np.random.default_rng(11)
    X, c, Vh, Wh = _bucket(rng, 24, "well", explicit=False)
    lhs, _ = _normal_equations(X, c, Vh, Wh, False, True, True, np.float64)
    Xb, Vb = _bf16(X), _bf16(Vh)
    a = _bf16(Xb * (c - 1.0)[..., None]).astype(np.float64)
    wc = _bf16(Wh)
    wh = np.where(wc > 0, _bf16(wc - 1.0), 0.0).astype(np.float64)
    V0 = Xb.reshape(-1, 24)[:64]
    base = (V0.T.astype(np.float64) @ V0 + np.eye(24)).astype(np.float32)
    cold = np.concatenate([a, Xb], 1), np.concatenate([Xb, a], 1)
    G = (np.einsum("bli,blj->bij", *cold)
         + np.einsum("bh,hi,hj->bij", 2 * wh, Vb, Vb)) / 2
    assert not np.allclose(np.einsum("bli,blj->bij", a, Xb),
                           np.einsum("bli,blj->bji", a, Xb))
    base = base.astype(np.float64)
    kern = (base + base.T)[None] / 2 + G
    assert _rel(kern, lhs) <= 1e-12
