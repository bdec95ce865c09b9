"""Implicit-feedback ALS half-sweep for WRMF, one nnz-bucket at a time.

Port of ``rsparse_tpu/ops/als.py`` for implicit feedback without
per-entity biases.  For every target row b of a bucket, with the source
rows it touches gathered as ``Xg = src[col_idx[b, :nnz_b]]`` and
confidences ``c``:

    lhs  = XtX + Xg' diag(c - 1) Xg               (XtX holds the lambda ridge)
    rhs  = Xg' (c - (c - 1) g) + rhs_init          (g: implicit global bias)
    loss = sum c (1 - g - Xg y)^2 + lambda ||y||^2

With a dense zipf head (``sparse/device.py`` ``HotBlock``) the head
columns' entries add the same terms from the dense ``(B, H)`` weights.

Two kernels solve a bucket on the card: K1 (``csrc/als_cg.cu``) runs the
CG solve and K2 (``csrc/als_chol.cu``) the exact Cholesky solve.
:func:`_solve_bucket_implicit` is their plain PyTorch version; the
wrappers take it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import _kernels
from ..config import accum_dtype
from ..sparse.device import RowBucket
from .solvers import CG_TOL, batched_cg, batched_spd_solve

# Solver codes, mirroring reference inst/include/wrmf.hpp:16-18
CHOLESKY = 0
CONJUGATE_GRADIENT = 1
NNLS = 2

_SOLVER_CODES = {"cholesky": CHOLESKY, "conjugate_gradient": CONJUGATE_GRADIENT,
                 "nnls": NNLS}


@dataclass(frozen=True)
class ALSConfig:
    """Configuration of one implicit-feedback ALS half-sweep."""

    solver: int                 # CHOLESKY | CONJUGATE_GRADIENT
    cg_steps: int = 3
    use_global_bias: bool = False

    @property
    def solve_empty(self) -> bool:
        """Solve rows with zero total nnz too (implicit global-bias
        semantics, reference wrmf_implicit.hpp:180); consulted on the
        hot/cold-split path, where bucket membership cannot tell an empty
        row from one whose entries all live in the hot block.  Without
        per-entity biases it is exactly ``use_global_bias``."""
        return self.use_global_bias


def solver_code(name: str) -> int:
    try:
        return _SOLVER_CODES[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; one of {sorted(_SOLVER_CODES)}"
        ) from None


def _solve_bucket_implicit(
    src: torch.Tensor,                 # (n_src, d)
    XtX: torch.Tensor,                 # (d, d) incl. lambda ridge
    rhs_init: Optional[torch.Tensor],  # (d,) or None
    bucket: RowBucket,
    x_init: torch.Tensor,              # (B, d) warm start (CG only)
    lam: float,
    g: float,                          # global bias (0 when unused)
    cfg: ALSConfig,
    hot_W: Optional[torch.Tensor] = None,   # (B, H) dense hot confidences
    V_hot: Optional[torch.Tensor] = None,   # (H, d) hot source factors
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (CG) and K2 (Cholesky): one bucket of
    per-entity implicit-feedback solves.  Returns (y (B, d), loss (B,))."""
    sdt = XtX.dtype
    mask = bucket.mask()
    Xg = src.to(sdt)[bucket.col_idx.long()]                  # (B, L, d)
    c = bucket.values.to(sdt)
    zero = torch.zeros((), dtype=sdt, device=c.device)
    cm = torch.where(mask, c, zero)
    cm1 = torch.where(mask, c - 1.0, zero)
    offs = g if cfg.use_global_bias else None

    c_eff = cm if offs is None else cm - cm1 * offs
    rhs = torch.einsum("bld,bl->bd", Xg, c_eff)
    if rhs_init is not None:
        rhs = rhs + rhs_init[None, :]
    if hot_W is not None:
        Vh = V_hot.to(sdt)
        Wc = hot_W.to(sdt)
        W1 = torch.where(Wc > 0, Wc - 1.0, zero)
        ce_hot = Wc if offs is None else Wc - W1 * offs
        rhs = rhs + ce_hot @ Vh

    if cfg.solver == CONJUGATE_GRADIENT:
        def matvec(p):
            t = torch.einsum("bld,bd->bl", Xg, p) * cm1
            out = p @ XtX + torch.einsum("bl,bld->bd", t, Xg)
            if hot_W is not None:
                out = out + ((p @ Vh.T) * W1) @ Vh
            return out
        y = batched_cg(matvec, rhs, x_init.to(sdt), cfg.cg_steps)
    elif cfg.solver == CHOLESKY:
        lhs = XtX[None] + torch.einsum("bld,ble->bde", Xg * cm1[..., None], Xg)
        y = batched_spd_solve(lhs, rhs)
    else:
        raise NotImplementedError(
            f"solver code {cfg.solver} is not ported yet (see ROADMAP.md)")

    pred = torch.einsum("bld,bd->bl", Xg, y)
    base = 1.0 - pred
    if offs is not None:
        base = base - offs
    loss = (cm * base * base).sum(-1) + lam * (y * y).sum(-1)
    if hot_W is not None:
        pred_h = y @ Vh.T
        base_h = (1.0 - offs) - pred_h if offs is not None else 1.0 - pred_h
        loss = loss + (Wc * base_h * base_h).sum(-1)
    return y, loss


def _bucket_args(src, XtX, rhs_init, bucket, d):
    """Validate the arguments K1 and K2 share; return them as C values."""
    if d > _kernels.MAX_D:
        raise NotImplementedError(
            f"the CUDA ALS kernels take rank <= {_kernels.MAX_D}, got {d} "
            "(see ROADMAP.md)")
    B, L = bucket.batch, bucket.pad_len
    f32, i32 = torch.float32, torch.int32
    _kernels.check_tensor("src", src, (src.shape[0], d), f32)
    _kernels.check_tensor("XtX", XtX, (d, d), f32)
    _kernels.check_tensor("col_idx", bucket.col_idx, (B, L), i32)
    _kernels.check_tensor("values", bucket.values, (B, L), f32)
    _kernels.check_tensor("nnz", bucket.nnz, (B,), i32)
    if rhs_init is not None:
        _kernels.check_tensor("rhs_init", rhs_init, (d,), f32)
    return (_kernels.ptr(src), _kernels.ptr(bucket.col_idx),
            _kernels.ptr(bucket.values), _kernels.ptr(bucket.nnz),
            ctypes.c_int(B), ctypes.c_int(L), ctypes.c_int(d),
            _kernels.ptr(XtX), _kernels.ptr(rhs_init))


def solve_bucket_cg(src, XtX, rhs_init, bucket, x_init, lam, g,
                    cfg: ALSConfig, hot_W=None, V_hot=None):
    """K1: one bucket of implicit CG solves (``csrc/als_cg.cu``).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Returns (y (B, d), loss (B,))."""
    if src.device.type == "cpu":
        return _solve_bucket_implicit(src, XtX, rhs_init, bucket, x_init,
                                      lam, g, cfg, hot_W, V_hot)
    d = src.shape[1]
    args = _bucket_args(src, XtX, rhs_init, bucket, d)
    B = bucket.batch
    _kernels.check_tensor("x_init", x_init, (B, d), torch.float32)
    H = 0
    if hot_W is not None:
        H = hot_W.shape[1]
        _kernels.check_tensor("hot_W", hot_W, (B, H), torch.float32)
        _kernels.check_tensor("V_hot", V_hot, (H, d), torch.float32)
    y = torch.empty((B, d), dtype=torch.float32, device=src.device)
    loss = torch.empty((B,), dtype=torch.float32, device=src.device)
    gg = float(g) if cfg.use_global_bias else 0.0
    rc = _kernels.lib().rsp_als_cg(
        *args, _kernels.ptr(x_init), _kernels.ptr(hot_W),
        _kernels.ptr(V_hot), ctypes.c_int(H), ctypes.c_float(lam),
        ctypes.c_float(gg), ctypes.c_int(cfg.cg_steps),
        ctypes.c_float(CG_TOL), _kernels.ptr(y), _kernels.ptr(loss),
        _kernels.stream(src.device))
    _kernels.check(rc, "als_cg")
    _kernels.launches["als_cg"] += 1
    return y, loss


def solve_bucket_cholesky(src, XtX, rhs_init, bucket, lam, g,
                          cfg: ALSConfig):
    """K2: one bucket of exact implicit Cholesky solves
    (``csrc/als_chol.cu``).  CPU tensors take the plain version; CUDA
    tensors launch the kernel.  Returns (y (B, d), loss (B,))."""
    if src.device.type == "cpu":
        x0 = torch.zeros((bucket.batch, src.shape[1]), dtype=XtX.dtype)
        return _solve_bucket_implicit(src, XtX, rhs_init, bucket, x0, lam,
                                      g, cfg)
    d = src.shape[1]
    args = _bucket_args(src, XtX, rhs_init, bucket, d)
    B = bucket.batch
    y = torch.empty((B, d), dtype=torch.float32, device=src.device)
    loss = torch.empty((B,), dtype=torch.float32, device=src.device)
    gg = float(g) if cfg.use_global_bias else 0.0
    rc = _kernels.lib().rsp_als_chol(
        *args, ctypes.c_float(lam), ctypes.c_float(gg), _kernels.ptr(y),
        _kernels.ptr(loss), _kernels.stream(src.device))
    _kernels.check(rc, "als_chol")
    _kernels.launches["als_chol"] += 1
    return y, loss


def _sweep_prepare(src, lam, g, cfg: ALSConfig, sdt):
    """XtX Gram with the lambda ridge, and rhs_init, from the source
    factors."""
    s = src.to(sdt)
    XtX = s.T @ s + lam * torch.eye(s.shape[1], dtype=sdt, device=s.device)
    rhs_init = -g * s.sum(0) if cfg.use_global_bias else None
    return XtX, rhs_init


def _src_reg_loss(src, lam, sdt):
    """Final lambda * ||source||^2 term (reference wrmf_implicit.hpp:286-303)."""
    s = src.to(sdt)
    return lam * (s * s).sum()


def _solve_scatter(result, src, XtX, rhs_init, bucket, old, lam, g,
                   n_tgt: int, cfg: ALSConfig, V_hot=None, hot_pre=None):
    """One bucket: gather the warm start, solve, scatter into ``result``
    (updated in place, so a sweep holds one output table).  Returns the
    bucket's loss over its valid rows."""
    ids = bucket.row_ids.clamp(max=n_tgt - 1).long()
    valid = bucket.row_ids < n_tgt
    hot_W = None
    if hot_pre is not None:
        hot_W, row_nnz = hot_pre
        if not cfg.solve_empty:
            # rows with zero TOTAL nnz keep the excluded-row semantics (y=0)
            valid = valid & (row_nnz > 0)
    if cfg.solver == CONJUGATE_GRADIENT:
        y, le = solve_bucket_cg(src, XtX, rhs_init, bucket,
                                old[ids].contiguous(), lam, g, cfg,
                                hot_W, V_hot)
    else:
        y, le = solve_bucket_cholesky(src, XtX, rhs_init, bucket, lam, g,
                                      cfg)
    y = torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype,
                                                   device=y.device))
    result[bucket.row_ids.long()] = y.to(result.dtype)
    return torch.where(valid, le, torch.zeros((), dtype=le.dtype,
                                              device=le.device)).sum()


def wrmf_sweep(
    src: torch.Tensor,                 # (n_src, d) source factors
    tgt_old: torch.Tensor,             # (n_tgt, d) previous target factors
    buckets: Tuple[RowBucket, ...],    # target rows over source columns
    lam: float,
    g: float,
    cfg: ALSConfig,
    hot_ids: Optional[torch.Tensor] = None,  # (H,) dense zipf-head columns
    hot_rows=None,                     # hot_bucket_rows(...) for buckets
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ALS half-sweep: re-solve every target entity given fixed sources.

    Returns (new target factors (n_tgt, d), summed un-normalised loss).
    Mirrors one call of ``private$solver`` in the reference fit loop
    (R/model_WRMF.R:318-338).
    """
    n_tgt, d = tgt_old.shape
    sdt = accum_dtype(src.dtype)
    XtX, rhs_init = _sweep_prepare(src, lam, g, cfg, sdt)
    V_hot = None
    if hot_ids is not None:
        if cfg.solver != CONJUGATE_GRADIENT:
            raise NotImplementedError(
                "the dense zipf head with the Cholesky solver is not ported "
                "yet (see ROADMAP.md)")
        V_hot = src[hot_ids.long()].contiguous()
    result = torch.zeros((n_tgt + 1, d), dtype=src.dtype, device=src.device)
    loss = torch.zeros((), dtype=sdt, device=src.device)
    for bi, bucket in enumerate(buckets):
        loss = loss + _solve_scatter(
            result, src, XtX, rhs_init, bucket, tgt_old, lam, g, n_tgt, cfg,
            V_hot, None if hot_rows is None else hot_rows[bi])
    return result[:n_tgt], loss + _src_reg_loss(src, lam, sdt)
