"""Soft-SVD / Soft-Impute by alternating least squares (Hastie et al.).

Port of ``rsparse_tpu/models/soft_als.py`` (reference R/SoftALS.R:107-245).
Each iteration solves the item side, then the user side (:func:`_b_step`):
the sparse products run on K5 (``ops/spmm.py`` :func:`spmm_buckets`), the
soft-impute residual of ``X - u diag(d) v'`` at the nnz pattern, its
squared norm and the residual SpMM on K6 (:func:`spmm_residual_buckets`),
and the tall-skinny SVDs are a Gram + ``torch.linalg.eigh`` on rank x rank
matrices (R/SoftALS.R:250-257).  The final cleanup soft-thresholds the
singular values ``max(d - lambda, 0)`` and trims the rank
(R/SoftALS.R:214-243).

Random numbers come from ``np.random.default_rng(seed)`` in the reference's
order, so the initial state is the reference's.  ``eigh``, ``qr`` and
``svd`` may flip the sign of a column of ``u`` together with the same
column of ``v``: compare ``u diag(d) v'``, never raw ``u`` or ``v``.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import logger, resolve_full_dtype
from ..ops.spmm import spmm_buckets, spmm_residual_buckets
from ..sparse.device import (BucketedRows, _csr_fingerprint, bucket_rows,
                             staged_aux_cached)


class SVDResult(NamedTuple):
    """An svd-like triple (u: (n, r), d: (r,), v: (m, r))."""

    u: torch.Tensor
    d: torch.Tensor
    v: torch.Tensor


class SoftALSFit(NamedTuple):
    """Result of :func:`soft_als`: the SVD triple and the per-iteration
    trace (``iter``, ``frob_delta``, ``loss`` as in the reference, plus
    ``wall_s``, the iteration's host time, which ends in a read of the
    iteration's change and so covers its device work)."""

    u: torch.Tensor
    d: torch.Tensor
    v: torch.Tensor
    trace: tuple

    @property
    def svd(self) -> SVDResult:
        return SVDResult(self.u, self.d, self.v)


def staged_buckets(csr: sp.csr_matrix, dtype: torch.dtype, device,
                   transpose: bool = False, fingerprint=None) -> BucketedRows:
    """The buckets of ``csr`` (or of its transpose) through the staging
    cache: soft-impute, LinearFlow and PureSVD bucket the same matrix.
    ``fingerprint`` is ``csr``'s, when the caller has it already."""
    build = ((lambda: bucket_rows(csr.T.tocsr(), dtype, device)) if transpose
             else (lambda: bucket_rows(csr, dtype, device)))
    if fingerprint is None:
        fingerprint = _csr_fingerprint(csr)
    return staged_aux_cached("spmm_tx" if transpose else "spmm_x",
                             fingerprint, build,
                             extra=(str(dtype), str(torch.device(device))))


def stage_both(csr: sp.csr_matrix, dtype: torch.dtype,
               device) -> Tuple[BucketedRows, BucketedRows]:
    """The buckets of ``csr`` and of its transpose, with one fingerprint of
    ``csr`` for both cache lookups."""
    fp = _csr_fingerprint(csr)
    return (staged_buckets(csr, dtype, device, fingerprint=fp),
            staged_buckets(csr, dtype, device, transpose=True, fingerprint=fp))


def svd_tall_skinny(x: torch.Tensor) -> SVDResult:
    """SVD of a tall-skinny matrix via Gram + symmetric eigendecomposition
    (the reference's crossprod + small SVD, R/SoftALS.R:250-257)."""
    w, vecs = torch.linalg.eigh(x.T @ x)            # ascending
    w = torch.flip(w, (0,)).clamp_min(0.0)
    vecs = torch.flip(vecs, (1,))
    d = torch.sqrt(w)
    u = (x @ vecs) / d.clamp_min(1e-12)[None, :]
    return SVDResult(u, d, vecs)


def calc_frobenius_norm_delta(old: SVDResult,
                              new: SVDResult) -> torch.Tensor:
    """Relative Frobenius change between two SVD triples
    (reference R/utils_SoftALS.R:24-34)."""
    denom = torch.sum(old.d ** 2)
    utu = new.d[:, None] * (new.u.T @ old.u)
    vtv = old.d[:, None] * (old.v.T @ new.v)
    uvprod = torch.trace(utu @ vtv)
    num = denom + torch.sum(new.d ** 2) - 2 * uvprod
    return num / denom.clamp_min(1e-9)


def pad_svd(init: SVDResult, rank: int,
            rng: np.random.Generator) -> SVDResult:
    """Pad a warm-start SVD to ``rank`` with orthogonalised random columns
    (reference R/utils_SoftALS.R:36-60)."""
    r0 = init.d.shape[0]
    if r0 > rank:
        raise ValueError("provided init has bigger rank than model rank")
    if r0 == rank:
        return init
    n_pad = rank - r0
    d = torch.cat([init.d, init.d[-1:].expand(n_pad)])

    def pad_orth(m):
        pad = torch.as_tensor(rng.standard_normal((m.shape[0], n_pad)),
                              dtype=m.dtype, device=m.device)
        pad = pad - m @ (m.T @ pad)
        q, _ = torch.linalg.qr(pad)
        return torch.cat([m, q], dim=1)

    return SVDResult(pad_orth(init.u), d, pad_orth(init.v))


def _b_step(buckets, n_rows: int, svd: SVDResult, lam: torch.Tensor,
            target: str, update_side: str,
            compute_dtype=None) -> Tuple[SVDResult, torch.Tensor]:
    """One half-iteration: re-solve one side and re-orthogonalise.

    ``buckets`` hold the matrix with the *solved* side as rows (x' for the
    item step ``update_side="v"``, x for the user step)."""
    u, d, v = svd
    shrink = d / (d + lam)
    loss = torch.tensor(float("nan"), dtype=torch.float32)
    if target == "soft_impute":
        # residual of the (rows x cols) pattern against rowfac diag(d)
        # colfac', fused with the residual SpMM (K6)
        rowfac, colfac = (v, u) if update_side == "v" else (u, v)
        proj, sqn = spmm_residual_buckets(buckets, n_rows, rowfac, colfac, d,
                                          compute_dtype=compute_dtype)
        # un-normalised loss; the caller divides by nnz (R/SoftALS.R:83)
        loss = sqn + lam * torch.sum(d)
        hat = (proj + rowfac * d[None, :]) * shrink[None, :]
    else:
        colfac = u if update_side == "v" else v
        proj = spmm_buckets(buckets, n_rows, colfac,
                            compute_dtype=compute_dtype)
        hat = proj * shrink[None, :]
    hsvd = svd_tall_skinny(hat)
    if update_side == "v":
        new = SVDResult(u @ hsvd.v, hsvd.d, hsvd.u)
    else:
        new = SVDResult(hsvd.u, hsvd.d, v @ hsvd.v)
    return new, loss


def _final_svd_m(x_buckets, u, d, v, n_rows: int, target: str):
    """The final cleanup's matrix ``m`` and its SVD (R/SoftALS.R:214-243).
    For soft-impute, ``m = X_delta v + u diag(d) (v'v)`` where the residual
    SpMM ``X_delta v`` is K6's proj with ``rowfac=u, colfac=v, scale=d``."""
    if target == "soft_impute":
        proj, _ = spmm_residual_buckets(x_buckets, n_rows, u, v, d)
        m = proj + (u * d[None, :]) @ (v.T @ v)
    else:
        m = spmm_buckets(x_buckets, n_rows, v)
    return torch.linalg.svd(m, full_matrices=False)


def _soft_als_iter(tx_buckets, x_buckets, n_rows: int, n_cols: int,
                   svd: SVDResult, lam, target: str, compute_dtype=None):
    svd1, _ = _b_step(tx_buckets, n_cols, svd, lam, target, "v",
                      compute_dtype)
    svd2, loss = _b_step(x_buckets, n_rows, svd1, lam, target, "u",
                         compute_dtype)
    return svd2, calc_frobenius_norm_delta(svd, svd2), loss


def _as_tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def soft_als(
    x: sp.spmatrix,
    rank: int = 10,
    lambda_: float = 0.0,
    n_iter: int = 100,
    convergence_tol: float = 1e-3,
    init=None,
    final_svd: bool = True,
    target: str = "svd",
    precision: str = "float32",
    seed: Optional[int] = None,
    compute_dtype: Optional[str] = None,
    device="cuda",
) -> SoftALSFit:
    """Core EM-like algorithm of soft-svd / soft-impute
    (reference R/SoftALS.R:107-245).

    ``compute_dtype="bfloat16"`` gathers the factor tables at half width
    (f32 sums, f32 orthogonalisation); the final SVD cleanup stays at full
    precision.  ``init`` is a warm start: an :class:`SVDResult`,
    :class:`SoftALSFit` or ``(u, d, v)`` of tensors or arrays, padded to
    ``rank`` with orthogonalised random columns."""
    dtype = resolve_full_dtype(precision)
    csr = sp.csr_matrix(x).astype(np.float64, copy=False)
    return _soft_als_buckets(*stage_both(csr, dtype, device), rank, lambda_,
                             n_iter, convergence_tol, init, final_svd, target,
                             dtype, seed, compute_dtype, device)


def _soft_als_buckets(x_b: BucketedRows, tx_b: BucketedRows, rank, lambda_,
                      n_iter, convergence_tol, init, final_svd, target, dtype,
                      seed, compute_dtype, device) -> SoftALSFit:
    """:func:`soft_als` on the buckets of x and of x' (LinearFlow hands in
    the ones it staged)."""
    if target not in ("svd", "soft_impute"):
        raise ValueError("target must be 'svd' or 'soft_impute'")
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    n_rows, n_cols = x_b.n_rows, x_b.n_cols

    if init is None:
        u0 = torch.as_tensor(rng.standard_normal((n_rows, rank)), dtype=dtype,
                             device=device)
        q, _ = torch.linalg.qr(u0)
        svd_cur = SVDResult(q, torch.ones((rank,), dtype=dtype, device=device),
                            torch.zeros((n_cols, rank), dtype=dtype,
                                        device=device))
    else:
        if hasattr(init, "u"):       # SVDResult / SoftALSFit warm start
            init = (init.u, init.d, init.v)
        svd_cur = pad_svd(SVDResult(*(_as_tensor(a, dtype, device)
                                      for a in init)), rank, rng)

    lam = torch.tensor(lambda_, dtype=dtype, device=device)
    trace = []
    converged = False
    for i in range(n_iter):
        t0 = time.perf_counter()
        svd_cur, delta, loss = _soft_als_iter(
            tx_b.buckets, x_b.buckets, n_rows, n_cols, svd_cur, lam, target,
            compute_dtype)
        delta = float(delta)
        trace.append({"iter": i + 1, "frob_delta": delta,
                      "loss": float(loss) / max(x_b.nnz, 1),
                      "wall_s": time.perf_counter() - t0})
        logger.info("soft_als: iter %03d, frobenius norm change %.5f", i + 1,
                    delta)
        if delta < convergence_tol:
            converged = True
            break
    if not converged:
        logger.warning("soft_als hasn't converged with tol %f after %d "
                       "iterations", convergence_tol, n_iter)

    if final_svd:
        u, d, v = svd_cur
        mu, md, mvh = _final_svd_m(x_b.buckets, u, d, v, n_rows, target)
        d_final = np.maximum(md.double().cpu().numpy() - lambda_, 0.0)
        n_keep = int((d_final > 0).sum())
        if n_keep == 0:
            raise ValueError(
                f"regularization lambda={lambda_} is too high - all "
                "singular values are zero")
        svd_cur = SVDResult(
            mu[:, :n_keep].contiguous(),
            torch.as_tensor(d_final[:n_keep], dtype=dtype, device=device),
            (v @ mvh.T)[:, :n_keep].contiguous())
    return SoftALSFit(svd_cur.u, svd_cur.d, svd_cur.v, tuple(trace))


def soft_impute(x, rank=10, lambda_=0.0, n_iter=100, convergence_tol=1e-3,
                init=None, final_svd=True, precision="float32", seed=None,
                compute_dtype=None, device="cuda") -> SoftALSFit:
    """Matrix completion on observed entries (reference R/SoftALS.R:40-49)."""
    return soft_als(x, rank, lambda_, n_iter, convergence_tol, init,
                    final_svd, "soft_impute", precision, seed, compute_dtype,
                    device)


def soft_svd(x, rank=10, lambda_=0.0, n_iter=100, convergence_tol=1e-3,
             init=None, final_svd=True, precision="float32", seed=None,
             compute_dtype=None, device="cuda") -> SoftALSFit:
    """Regularised truncated SVD (reference R/SoftALS.R:54-63)."""
    return soft_als(x, rank, lambda_, n_iter, convergence_tol, init,
                    final_svd, "svd", precision, seed, compute_dtype, device)
