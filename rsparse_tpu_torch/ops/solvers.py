"""Batched dense solvers in plain PyTorch.

Port of ``rsparse_tpu/ops/solvers.py`` (``batched_cg``,
``batched_spd_solve``).  These are the plain versions: the CPU path runs
them, and the CUDA kernels in ``csrc/`` are held against them.  The exact
solve is ``torch.linalg.cholesky`` + ``torch.cholesky_solve``; the reference
blocks its Cholesky by hand because of how XLA lowers it on the TPU, which
does not apply here.
"""

from __future__ import annotations

from typing import Callable

import torch

#: per-entity CG stop on the squared residual (reference
#: inst/include/wrmf.hpp:20-22, same constant as rsparse_tpu)
CG_TOL = 1e-10


def batched_spd_solve(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``lhs @ x = rhs`` for a batch of SPD systems.

    lhs: (B, d, d), rhs: (B, d) -> (B, d).
    """
    chol = torch.linalg.cholesky(lhs)
    return torch.cholesky_solve(rhs[..., None], chol)[..., 0]


def batched_cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    x0: torch.Tensor,
    n_steps: int,
    tol: float = CG_TOL,
) -> torch.Tensor:
    """Batched fixed-step conjugate gradient with per-entity early freeze.

    Warm start ``x0``, ``n_steps`` iterations; an entity stops moving once
    its squared residual drops below ``tol`` (the batched form of the
    reference's per-thread ``break``, inst/include/wrmf_implicit.hpp:9-32).
    matvec maps (B, d) -> (B, d); rhs, x0: (B, d).
    """
    r = rhs - matvec(x0)
    p = r
    x = x0
    rsold = (r * r).sum(-1)
    for _ in range(n_steps):
        live = rsold >= tol
        Ap = matvec(p)
        pAp = (p * Ap).sum(-1)
        denom = torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        alpha = torch.where(live, rsold / denom, torch.zeros_like(rsold))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rsnew = (r * r).sum(-1)
        safe = torch.where(rsold == 0, torch.ones_like(rsold), rsold)
        beta = torch.where(live, rsnew / safe, torch.zeros_like(rsnew))
        p = r + beta[:, None] * p
        rsold = torch.where(live, rsnew, rsold)
    return x
