"""Batched dense solvers in plain PyTorch.

Port of ``rsparse_tpu/ops/solvers.py`` (``batched_cg``,
``batched_spd_solve``, ``batched_nnls``).  These are the plain versions: the
CPU path runs them, and the CUDA kernels in ``csrc/`` are held against
them.  The exact solve is ``torch.linalg.cholesky`` +
``torch.cholesky_solve``; the reference blocks its Cholesky by hand because
of how XLA lowers it on the TPU, which does not apply here.
"""

from __future__ import annotations

from typing import Callable

import torch

#: per-entity CG stop on the squared residual (reference
#: inst/include/wrmf.hpp:20-22, same constant as rsparse_tpu)
CG_TOL = 1e-10
#: NNLS sweep budget, stop on the relative coordinate change, and ridge
#: (reference inst/include/nnls.hpp:8, same constants as rsparse_tpu)
SCD_MAX_ITER = 10_000
SCD_TOL = 1e-4
NNLS_EPS = 1e-16


def batched_spd_solve(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``lhs @ x = rhs`` for a batch of SPD systems.

    lhs: (B, d, d), rhs: (B, d) -> (B, d).  The factorisation reads the
    symmetric part ``(lhs + lhs') / 2``, as ``lax.linalg.cholesky`` does
    in the reference: a Gram of bf16-rounded weighted rows is not exactly
    symmetric.
    """
    chol = torch.linalg.cholesky((lhs + lhs.transpose(-1, -2)) / 2)
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


def batched_nnls(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    init: torch.Tensor,
    max_iter: int = SCD_MAX_ITER,
    rel_tol: float = SCD_TOL,
    return_sweeps: bool = False,
):
    """Batched sequential-coordinate-descent NNLS (Franc et al.): solves
    ``min_{x>=0} ||lhs @ x - rhs||`` for each batch entry through the
    squared system of the reference ``c_nnls`` (inst/include/nnls.hpp:37-48):
    ``G = lhs' lhs + eps I``, ``mu = G @ init - lhs' rhs``, then sweeps over
    the coordinates in order, each clamped at 0 (nnls.hpp:11-34).

    Each system stops on its own, after the first sweep whose largest
    relative coordinate change is at most ``rel_tol`` or after ``max_iter``
    sweeps, as the reference's per-entity loop does.  (rsparse_tpu's
    ``batched_nnls`` runs every system until the whole batch has stopped;
    one system at a time the two agree exactly.)

    lhs: (B, d, d), rhs: (B, d), init: (B, d) -> x (B, d), and with
    ``return_sweeps`` also the sweeps each system ran (B,) int32.
    """
    B, d = init.shape
    G = lhs.transpose(-1, -2) @ lhs + NNLS_EPS * torch.eye(
        d, dtype=lhs.dtype, device=lhs.device)
    Gdiag = torch.diagonal(G, dim1=-2, dim2=-1)
    Gcols = G.transpose(-1, -2).contiguous()       # Gcols[:, k] = G[:, :, k]
    mu = (G @ init[..., None])[..., 0] - (
        lhs.transpose(-1, -2) @ rhs[..., None])[..., 0]
    x = init.clone()
    live = torch.ones((B,), dtype=torch.bool, device=x.device)
    sweeps = torch.zeros((B,), dtype=torch.int32, device=x.device)
    for _ in range(max_iter):
        if not bool(live.any()):
            break
        # each coordinate moves once per sweep, so its old value is the
        # sweep's starting value
        start = x.clone()
        for k in range(d):
            old = start[:, k]
            new = torch.where(
                live, torch.clamp(old - mu[:, k] / Gdiag[:, k], min=0.0), old)
            diff = new - old
            mu = mu + diff[:, None] * Gcols[:, k]
            x[:, k] = new
        rel = ((x - start).abs() / (start.abs() + NNLS_EPS)).amax(1)
        sweeps += live.to(torch.int32)
        live = live & (rel > rel_tol)
    return (x, sweeps) if return_sweeps else x
