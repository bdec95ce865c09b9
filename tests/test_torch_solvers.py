"""Port parity: batched CG, the batched SPD solve and batched NNLS at
float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsparse_tpu.ops import solvers as ref
from rsparse_tpu_torch.ops import solvers as port

torch.set_num_threads(2)


def _spd_batch(seed, B, d):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, d, d))
    lhs = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(d)
    return lhs, rng.standard_normal((B, d)), rng.standard_normal((B, d))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("d", [8, 33])
def test_batched_spd_solve_matches_reference(d):
    lhs, rhs, _ = _spd_batch(d, 64, d)
    xj = np.asarray(ref.batched_spd_solve(jnp.asarray(lhs), jnp.asarray(rhs)))
    xt = port.batched_spd_solve(torch.from_numpy(lhs),
                                torch.from_numpy(rhs)).numpy()
    assert _rel(xt, xj) < 1e-10


@pytest.mark.parametrize("d,n_steps", [(8, 3), (33, 6)])
def test_batched_cg_matches_reference(d, n_steps):
    lhs, rhs, x0 = _spd_batch(100 + d, 40, d)
    # converged entries exercise the per-entity freeze
    x0[:4] = np.linalg.solve(lhs[:4], rhs[:4, :, None])[..., 0]
    lj = jnp.asarray(lhs)
    xj = np.asarray(ref.batched_cg(lambda p: jnp.einsum("bij,bj->bi", lj, p),
                                   jnp.asarray(rhs), jnp.asarray(x0),
                                   n_steps))
    lt = torch.from_numpy(lhs)
    xt = port.batched_cg(lambda p: torch.einsum("bij,bj->bi", lt, p),
                         torch.from_numpy(rhs), torch.from_numpy(x0),
                         n_steps).numpy()
    assert _rel(xt, xj) < 1e-10


@pytest.mark.parametrize("d,max_iter,zero_init", [(5, 10_000, False),
                                                  (12, 10_000, True),
                                                  (12, 7, False)])
def test_batched_nnls_matches_reference_per_system(d, max_iter, zero_init):
    """The port stops each system on its own; the reference stops the whole
    batch.  Held against the reference one system at a time they agree to
    1e-10; the sweep counts show systems that stopped at different sweeps
    (or at the budget)."""
    lhs, rhs, x0 = _spd_batch(200 + d, 6, d)
    x0 = np.zeros_like(x0) if zero_init else np.abs(x0)
    xt, sweeps = port.batched_nnls(torch.from_numpy(lhs),
                                   torch.from_numpy(rhs),
                                   torch.from_numpy(x0), max_iter=max_iter,
                                   return_sweeps=True)
    xt = xt.numpy()
    assert (xt >= 0).all()
    for b in range(lhs.shape[0]):
        xj = np.asarray(ref.batched_nnls(
            jnp.asarray(lhs[b:b + 1]), jnp.asarray(rhs[b:b + 1]),
            jnp.asarray(x0[b:b + 1]), max_iter=max_iter))[0]
        assert np.abs(xt[b] - xj).max() <= 1e-10 * max(np.abs(xj).max(), 1)
    sweeps = sweeps.numpy()
    if max_iter == 7:
        assert (sweeps == 7).all()
    else:
        assert len(set(sweeps.tolist())) > 1 and sweeps.max() < max_iter


def test_batched_nnls_solves_the_constrained_problem():
    """Against scipy's active-set NNLS on the same squared system."""
    from scipy.optimize import nnls
    lhs, rhs, _ = _spd_batch(300, 4, 9)
    xt = port.batched_nnls(torch.from_numpy(lhs), torch.from_numpy(rhs),
                           torch.zeros((4, 9), dtype=torch.float64)).numpy()
    for b in range(4):
        xs, _ = nnls(lhs[b], rhs[b])
        assert np.abs(xt[b] - xs).max() <= 1e-2 * max(np.abs(xs).max(), 1)
