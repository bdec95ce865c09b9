"""Port parity: batched CG and the batched SPD solve at float64."""

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
