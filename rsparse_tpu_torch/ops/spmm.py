"""Sparse x dense products and the sampled low-rank residual over buckets.

Port of ``rsparse_tpu/ops/spmm.py`` (reference R/SoftALS.R:86,101 and the
``cpp_make_sparse_approximation`` kernel, src/utils.cpp:5-56).  Two
hand-written kernels carry it on the card:

- K5 (``csrc/spmm.cu``): :func:`spmm_buckets`, ``out[row_ids[b]] = sum_l
  vals[b, l] * dense[col_idx[b, l]]``;
- K6 (``csrc/spmm_residual.cu``): :func:`spmm_residual_buckets`, the
  soft-impute projection: per entry ``a = (rowfac[row] * scale) .
  colfac[col]`` and ``delta = val - a``, returning ``sum delta^2`` and
  ``proj[row] = sum_l delta * colfac[col]`` from one gather of ``colfac``;
  with no proj and an ``a`` output it is :func:`sparse_approx_buckets`
  (and :func:`residual_values`).

``compute_dtype="bfloat16"`` gathers a bf16 shadow of the table
(:func:`_gather_table`) and rounds what multiplies it (the values, the
left factor, the residual) to bf16 too, as the reference does; every sum
is f32.  :func:`_spmm_plain` and :func:`_residual_plain` are the kernels'
plain PyTorch versions (the reference's gather + einsum + scatter-add);
the wrappers take them only for tensors on the CPU.  On the card K5 and
K6 take float32 (a float64 tensor raises) and tables of at most
``MAX_K`` columns.

One difference from the reference: :func:`sparse_approx_buckets` returns
0 at padding entries (``l >= nnz``), where the reference evaluates the
product at column 0.  Nothing reads those entries.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _kernels
from ..config import accum_dtype
from ..sparse.device import RowBucket

#: widest table K5 and K6 take (csrc/spmm_common.cuh kMaxK)
MAX_K = 512

_GATHER_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                  "float32": torch.float32, "float64": torch.float64}


def _gather_table(dense: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The factor table in the gather dtype: ``dense`` itself, or its bf16
    shadow for ``compute_dtype="bfloat16"`` (cast once, before any
    gather, so each gathered row is read at half width)."""
    if compute_dtype is None:
        return dense
    dt = (compute_dtype if isinstance(compute_dtype, torch.dtype)
          else _GATHER_DTYPES.get(compute_dtype))
    if dt is None:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return dense if dt == dense.dtype else dense.to(dt).contiguous()


# -- plain versions ----------------------------------------------------------

def _spmm_plain(buckets: Sequence[RowBucket], n_rows: int,
                dense: torch.Tensor, values_list=None,
                compute_dtype=None) -> torch.Tensor:
    """Plain version of K5 (rsparse_tpu/ops/spmm.py:35)."""
    k = dense.shape[1]
    dtype = dense.dtype
    sdt = accum_dtype(dtype)
    dg = _gather_table(dense, compute_dtype)
    out = torch.zeros((n_rows + 1, k), dtype=dtype, device=dense.device)
    for bi, b in enumerate(buckets):
        vals = b.values if values_list is None else values_list[bi]
        vm = torch.where(b.mask(), vals.to(sdt), 0.0)
        G = dg[b.col_idx.long()]                            # (B, L, k)
        rows = torch.einsum("bl,blk->bk", vm.to(G.dtype).to(sdt), G.to(sdt))
        out.index_add_(0, b.row_ids.long(), rows.to(dtype))
    return out[:n_rows]


def _residual_plain(buckets: Sequence[RowBucket], n_rows: int,
                    rowfac: torch.Tensor, colfac: torch.Tensor,
                    scale: Optional[torch.Tensor], compute_dtype=None,
                    proj: bool = True, approx: bool = False):
    """Plain version of K6 (rsparse_tpu/ops/spmm.py:81 and :59): returns
    (proj (n_rows, k) or None, sum of delta^2 (f32 scalar), [a (B, L)] or
    None)."""
    k = colfac.shape[1]
    dtype = colfac.dtype
    sdt = accum_dtype(dtype)
    left = rowfac if scale is None else rowfac * scale[None, :].to(
        rowfac.dtype)
    cg = _gather_table(colfac, compute_dtype)
    out = (torch.zeros((n_rows + 1, k), dtype=dtype, device=colfac.device)
           if proj else None)
    sqn = torch.zeros((), dtype=torch.float32, device=colfac.device)
    approx_list = [] if approx else None
    for b in buckets:
        mask = b.mask()
        ids = b.row_ids.long().clamp(max=left.shape[0] - 1)
        lf = left[ids].to(cg.dtype).to(sdt)
        rf = cg[b.col_idx.long()].to(sdt)                   # one gather
        a = torch.einsum("br,blr->bl", lf, rf)
        if approx:
            approx_list.append(torch.where(mask, a, 0.0).to(rowfac.dtype))
        delta = torch.where(mask, b.values.to(sdt) - a, 0.0)
        sqn = sqn + (delta * delta).to(torch.float32).sum()
        if proj:
            rows = torch.einsum("bl,blr->br", delta.to(cg.dtype).to(sdt), rf)
            out.index_add_(0, b.row_ids.long(), rows.to(dtype))
    return (None if out is None else out[:n_rows]), sqn, approx_list


# -- kernel wrappers ---------------------------------------------------------

def _table_for_kernel(name: str, dense: torch.Tensor,
                      compute_dtype) -> torch.Tensor:
    dense = dense.contiguous()
    _kernels.check_tensor(name, dense, dense.shape, torch.float32)
    if dense.shape[1] > MAX_K:
        raise ValueError(f"{name}: {dense.shape[1]} columns; the CUDA kernel "
                         f"takes at most {MAX_K}")
    tbl = _gather_table(dense, compute_dtype)
    if tbl.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: gather dtype {tbl.dtype} is not supported "
                        "by the CUDA kernel (float32 or bfloat16)")
    return tbl


def _check_bucket(b: RowBucket, vals: torch.Tensor) -> None:
    B, L = b.col_idx.shape
    _kernels.check_tensor("row_ids", b.row_ids, (B,), torch.int32)
    _kernels.check_tensor("col_idx", b.col_idx, (B, L), torch.int32)
    _kernels.check_tensor("nnz", b.nnz, (B,), torch.int32)
    _kernels.check_tensor("values", vals, (B, L), torch.float32)


def _spmm_cuda(buckets, n_rows, dense, values_list, compute_dtype):
    tbl = _table_for_kernel("dense", dense, compute_dtype)
    k = tbl.shape[1]
    out = torch.zeros((n_rows, k), dtype=torch.float32, device=dense.device)
    lib, st = _kernels.lib(), _kernels.stream(dense.device)
    aligned = int(tbl.data_ptr() % 16 == 0)
    for bi, b in enumerate(buckets):
        vals = b.values if values_list is None else values_list[bi]
        _check_bucket(b, vals)
        B, L = b.col_idx.shape
        if B == 0:
            continue
        rc = lib.rsp_spmm(
            _kernels.ptr(b.row_ids), _kernels.ptr(b.col_idx),
            _kernels.ptr(vals), _kernels.ptr(b.nnz), _kernels.ptr(tbl),
            int(tbl.dtype == torch.bfloat16), aligned, B, L, k, n_rows,
            _kernels.ptr(out), st)
        _kernels.check(rc, "spmm")
        _kernels.launches["spmm"] += 1
    return out


def _residual_cuda(buckets, n_rows, rowfac, colfac, scale, compute_dtype,
                   proj: bool, approx: bool):
    tbl = _table_for_kernel("colfac", colfac, compute_dtype)
    k = tbl.shape[1]
    rowfac = rowfac.contiguous()
    _kernels.check_tensor("rowfac", rowfac, (rowfac.shape[0], k),
                          torch.float32)
    if scale is not None:
        scale = scale.contiguous()
        _kernels.check_tensor("scale", scale, (k,), torch.float32)
    dev = colfac.device
    lib, st = _kernels.lib(), _kernels.stream(dev)
    aligned = int(tbl.data_ptr() % 16 == 0)
    out = (torch.zeros((n_rows, k), dtype=torch.float32, device=dev)
           if proj else None)
    parts = [lib.rsp_spmm_residual_parts(b.batch, b.pad_len, k, aligned)
             for b in buckets]
    offs = [0]
    for p in parts:
        offs.append(offs[-1] + p)
    sq_all = None if approx else torch.zeros((max(offs[-1], 1),),
                                             dtype=torch.float32, device=dev)
    approx_list = [] if approx else None
    for bi, b in enumerate(buckets):
        _check_bucket(b, b.values)
        B, L = b.col_idx.shape
        a = (torch.zeros((B, L), dtype=torch.float32, device=dev)
             if approx else None)
        if approx:
            approx_list.append(a)
        if B == 0:
            continue
        sq_ptr = (ctypes.c_void_p(0) if sq_all is None else
                  ctypes.c_void_p(sq_all.data_ptr() + 4 * offs[bi]))
        rc = lib.rsp_spmm_residual(
            _kernels.ptr(b.row_ids), _kernels.ptr(b.col_idx),
            _kernels.ptr(b.values), _kernels.ptr(b.nnz), _kernels.ptr(rowfac),
            _kernels.ptr(scale), rowfac.shape[0], _kernels.ptr(tbl),
            int(tbl.dtype == torch.bfloat16), aligned, B, L, k, n_rows,
            _kernels.ptr(out), _kernels.ptr(a), sq_ptr, st)
        _kernels.check(rc, "spmm_residual")
        _kernels.launches["spmm_residual"] += 1
    sqn = (torch.zeros((), dtype=torch.float32, device=dev) if sq_all is None
           else sq_all.sum())
    return out, sqn, approx_list


# -- public functions --------------------------------------------------------

def spmm_buckets(buckets: Sequence[RowBucket], n_rows: int,
                 dense: torch.Tensor, values_list=None,
                 compute_dtype=None) -> torch.Tensor:
    """Sparse @ dense: (n_rows, n_cols) x (n_cols, k) -> (n_rows, k).

    ``values_list`` optionally overrides each bucket's values (e.g. residual
    values from :func:`residual_values`).  CPU tensors take the plain
    version; CUDA tensors launch K5 once per bucket."""
    if dense.device.type == "cpu":
        return _spmm_plain(buckets, n_rows, dense, values_list, compute_dtype)
    return _spmm_cuda(buckets, n_rows, dense, values_list, compute_dtype)


def _residual(buckets, n_rows, rowfac, colfac, scale, compute_dtype=None,
              proj=True, approx=False):
    if colfac.device.type == "cpu":
        return _residual_plain(buckets, n_rows, rowfac, colfac, scale,
                               compute_dtype, proj, approx)
    return _residual_cuda(buckets, n_rows, rowfac, colfac, scale,
                          compute_dtype, proj, approx)


def spmm_residual_buckets(buckets: Sequence[RowBucket], n_rows: int,
                          rowfac: torch.Tensor, colfac: torch.Tensor,
                          scale: torch.Tensor, compute_dtype=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused soft-impute projection: the residual of ``rowfac diag(scale)
    colfac'`` at the nnz pattern, its squared norm (summed in float32, as
    the reference does at any precision) and the residual-SpMM against
    ``colfac``, in one gather of ``colfac`` per entry.  Returns ``(proj
    (n_rows, k), sq_norm scalar)``.  CUDA tensors launch K6 once per
    bucket."""
    proj, sqn, _ = _residual(buckets, n_rows, rowfac, colfac, scale,
                             compute_dtype, proj=True)
    return proj, sqn


def sparse_approx_buckets(buckets: Sequence[RowBucket], left: torch.Tensor,
                          right: torch.Tensor,
                          scale: Optional[torch.Tensor] = None
                          ) -> List[torch.Tensor]:
    """``left diag(scale) right'`` at each bucket's nnz pattern: a list of
    (B, L) value tensors aligned with the buckets, 0 at padding entries
    (reference src/utils.cpp:5-56).  CUDA tensors launch K6 in its
    approx-only mode."""
    return _residual(buckets, left.shape[0], left, right, scale, proj=False,
                     approx=True)[2]


def residual_values(buckets: Sequence[RowBucket], left, right,
                    scale=None) -> List[torch.Tensor]:
    """Bucket values minus the low-rank approximation at the nnz pattern
    (the ``x_delta`` of soft-impute, reference R/SoftALS.R:79-82)."""
    approx = sparse_approx_buckets(buckets, left, right, scale)
    return [b.values - a for b, a in zip(buckets, approx)]


def sq_norm_values(buckets: Sequence[RowBucket],
                   values_list=None) -> torch.Tensor:
    """Sum of squared (masked) values across buckets, in float32."""
    dev = buckets[0].values.device if buckets else None
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    for bi, b in enumerate(buckets):
        vals = b.values if values_list is None else values_list[bi]
        vm = torch.where(b.mask(), vals.to(torch.float32), 0.0)
        tot = tot + (vm * vm).sum()
    return tot
