"""Sparse x dense products and the sampled low-rank residual over buckets.

Port of ``rsparse_tpu/ops/spmm.py`` (reference R/SoftALS.R:86,101 and the
``cpp_make_sparse_approximation`` kernel, src/utils.cpp:5-56).  Two
hand-written kernels carry it on the card:

- K5 (``csrc/spmm.cu``): :func:`spmm_buckets`, ``out[row_ids[b]] = sum_l
  vals[b, l] * dense[col_idx[b, l]]``, one launch over a work list of row
  chunks and packed short rows (:func:`row_shape`, :func:`row_layout`);
- K6 (``csrc/spmm_residual.cu``): :func:`spmm_residual_buckets`, the
  soft-impute projection: per entry ``a = (rowfac[row] * scale) .
  colfac[col]`` and ``delta = val - a``, returning ``sum delta^2`` and
  ``proj[row] = sum_l delta * colfac[col]`` from one gather of ``colfac``;
  with no proj and an ``a`` output it is :func:`sparse_approx_buckets`
  (and :func:`residual_values`).  It runs on K5's work list, one launch
  per call, with one squared-norm partial per block.

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
import functools
import time
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from ..config import accum_dtype
from ..sparse.device import RowBucket

#: widest table K5 and K6 take (csrc/spmm_common.cuh kMaxK)
MAX_K = 512
#: K5's threads per block, the blocks its work list aims at, and its
#: longest chunk of a row (csrc/spmm.cu, :func:`row_shape`)
ROW_THREADS = 256
ROW_BLOCKS = 2048
ROW_MAX_CHUNK = 4096
#: buckets one K5 or K6 launch takes (their pointers are kernel parameters)
ROW_MAX_BUCKETS = 64

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


# -- K5's and K6's work list -------------------------------------------------

class RowShape(NamedTuple):
    """K5's and K6's launch shape for a table of k columns (csrc/spmm.cu,
    csrc/spmm_residual.cu): a block of ``ROW_THREADS`` threads is
    ``groups`` groups of ``tpe`` threads, each thread holding ``nv`` vectors
    of ``vec`` columns of a row.  The rows of a bucket padded to more than
    ``short`` entries are cut into chunks of ``chunk`` entries, one block
    each, its groups taking the chunk's entries in turn; the rows of the
    other buckets are packed ``groups`` to a block, one group each."""

    vec: int
    tpe: int
    nv: int
    groups: int
    chunk: int
    short: int


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@functools.lru_cache(maxsize=256)
def row_shape(k: int, aligned: bool = True, entries: int = 0) -> RowShape:
    """K5's shape for k columns (``aligned``: the table starts 16-byte
    aligned; the same arithmetic as ``rsp_sp::make_shape``) over buckets of
    ``entries`` padded entries.  The chunk aims at ``ROW_BLOCKS`` blocks,
    a power of two from 16 entries a group to ``ROW_MAX_CHUNK``: a small
    product keeps short chunks, so that it still fills the card, and a
    large one long chunks, so that fewer partial rows are summed and added.
    Rows are packed (those of buckets padded to at most a sixteenth of a
    chunk) only when the blocks would hold 1,024 entries or more: a group
    walks a packed row alone, which pays only when blocks are plentiful."""
    vec = 4 if (k % 4 == 0 and aligned) else 1
    nvec = -(-k // vec)
    tpe = min(32, _pow2_ceil(nvec))
    nv = _pow2_ceil(-(-nvec // tpe))
    groups = ROW_THREADS // tpe
    per_block = entries // ROW_BLOCKS
    chunk = min(ROW_MAX_CHUNK, max(16 * groups, 1 << max(
        0, per_block.bit_length() - 1)))
    return RowShape(vec, tpe, nv, groups, chunk,
                    chunk // 16 if per_block >= 1024 else 0)


class RowLayout(NamedTuple):
    """K5's work list over a list of bucket shapes (:func:`row_layout`):
    ``desc`` (n_blocks, 4) int32 = (bucket, row, chunk index or row count,
    packed), packed 0 chunk z of row y, 1 the z rows y, y + 1, ... of the
    bucket (z <= ``groups``); the chunks first, by chunk index, the buckets
    of the longest rows first."""

    desc: torch.Tensor        # (n_blocks, 4) int32
    shape: RowShape
    stats: dict               # blocks, chunks, chunked / packed rows, build_s


def row_layout(shapes: Sequence[Tuple[int, int]], shape: RowShape,
               device="cpu") -> RowLayout:
    """Build K5's and K6's work list (:class:`RowLayout`) for buckets of
    these ``(batch, pad_len)`` shapes: every row of a bucket padded to more
    than ``shape.short`` entries takes ``ceil(pad_len / chunk)`` chunk
    blocks (chunk c of every such row, longest buckets first, then chunk
    c + 1), and the rows of the other buckets are packed ``shape.groups``
    to a block.  It reads no bucket data: a chunk past a row's entries
    leaves at once on the card, and a row whose entries fit one chunk is
    stored, not added (csrc/spmm.cu, csrc/spmm_residual.cu).  Built on the
    host from the shapes and copied to ``device`` once."""
    t0 = time.perf_counter()
    C, G = shape.chunk, shape.groups
    chunked = [(bi, B, -(-L // C)) for bi, (B, L) in enumerate(shapes)
               if B and L > shape.short]
    chunked.sort(key=lambda c: -c[2])
    segs = [(bi, B, c) for c in range(max((n for _, _, n in chunked),
                                          default=0))
            for bi, B, n in chunked if n > c]
    parts = [np.stack([np.full(B, bi), np.arange(B), np.full(B, c),
                       np.zeros(B, np.int64)], 1) for bi, B, c in segs]
    n_chunks = sum(B for _, B, _ in segs)
    packed = [(bi, B) for bi, (B, L) in enumerate(shapes)
              if B and L <= shape.short]
    for bi, B in packed:
        y = np.arange(0, B, G)
        parts.append(np.stack([np.full(y.size, bi), y,
                               np.minimum(G, B - y), np.ones(y.size,
                                                             np.int64)], 1))
    desc = (np.concatenate(parts) if parts else np.zeros((0, 4), np.int64))
    stats = dict(blocks=int(desc.shape[0]), chunks=n_chunks,
                 chunked_rows=sum(B for _, B, _ in chunked),
                 packed_rows=sum(B for _, B in packed))
    lay = RowLayout(torch.from_numpy(desc.astype(np.int32)).to(device),
                    shape, stats)
    stats["build_s"] = time.perf_counter() - t0
    return lay


#: K5's work lists by (device, bucket shapes, RowShape), least recently
#: used first
_LAYOUTS: "OrderedDict[tuple, RowLayout]" = OrderedDict()
_LAYOUTS_MAX = 64


def spmm_layout(shapes: Tuple[Tuple[int, int], ...], shape: RowShape,
                device) -> RowLayout:
    """K5's work list for buckets of these ``(batch, pad_len)`` shapes on
    ``device``, from a cache of its own: built on the first call for a list
    of shapes, then reused for any buckets of the same shapes."""
    key = (torch.device(device), shapes, shape)
    lay = _LAYOUTS.get(key)
    if lay is None:
        lay = _LAYOUTS[key] = row_layout(shapes, shape, device)
        while len(_LAYOUTS) > _LAYOUTS_MAX:
            _LAYOUTS.popitem(last=False)
    else:
        _LAYOUTS.move_to_end(key)
    return lay


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
    """Raise unless the bucket's tensors are contiguous CUDA tensors of its
    shape and the kernels' dtypes (``_kernels.check_tensor``'s errors; the
    test that passes is inlined, as K5 and K6 run it on every call)."""
    B, L = b.col_idx.shape
    for name, t, shape, dt in (("row_ids", b.row_ids, (B,), torch.int32),
                               ("col_idx", b.col_idx, (B, L), torch.int32),
                               ("nnz", b.nnz, (B,), torch.int32),
                               ("values", vals, (B, L), torch.float32)):
        if not (t.is_cuda and t.dtype == dt and t.shape == shape
                and t.is_contiguous()):
            _kernels.check_tensor(name, t, shape, dt)


class _Part(NamedTuple):
    """The buckets of one K5 / K6 launch (at most ``ROW_MAX_BUCKETS``, all
    of them for every staged matrix of the port): their indices among the
    caller's buckets, the host array of their pointers the C entries take,
    and the work list of their shapes."""

    index: List[int]
    ptrs: ctypes.Array
    layout: RowLayout


def _parts(buckets, vals, k: int, aligned: bool, device) -> List[_Part]:
    """Check the non-empty buckets and cut them into launches, each with
    its cached work list (:func:`spmm_layout`)."""
    live = [i for i, b in enumerate(buckets) if b.batch]
    parts = []
    for i in range(0, len(live), ROW_MAX_BUCKETS):
        index = live[i:i + ROW_MAX_BUCKETS]
        shapes, ptrs = [], []
        for bi in index:
            b, v = buckets[bi], vals[bi]
            _check_bucket(b, v)
            B, L = b.col_idx.shape
            shapes.append((B, L))
            ptrs += (b.col_idx.data_ptr(), v.data_ptr(), b.row_ids.data_ptr(),
                     b.nnz.data_ptr(), L)
        shape = row_shape(k, aligned, sum(B * L for B, L in shapes))
        parts.append(_Part(index, (ctypes.c_longlong * len(ptrs))(*ptrs),
                           spmm_layout(tuple(shapes), shape, device)))
    return parts


def _spmm_cuda(buckets, n_rows, dense, values_list, compute_dtype):
    tbl = _table_for_kernel("dense", dense, compute_dtype)
    k = tbl.shape[1]
    out = torch.zeros((n_rows, k), dtype=torch.float32, device=dense.device)
    vals = ([b.values for b in buckets] if values_list is None
            else values_list)
    aligned = tbl.data_ptr() % 16 == 0
    # the parts' rows are disjoint, so their launches need no order
    for part in _parts(buckets, vals, k, aligned, dense.device):
        lay = part.layout
        rc = _kernels.lib().rsp_spmm(
            part.ptrs, len(part.index), _kernels.ptr(lay.desc),
            lay.stats["blocks"], _kernels.ptr(tbl),
            int(tbl.dtype == torch.bfloat16), int(aligned), k, n_rows,
            lay.shape.chunk, _kernels.ptr(out), _kernels.stream(dense.device))
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
    aligned = tbl.data_ptr() % 16 == 0
    out = (torch.zeros((n_rows, k), dtype=torch.float32, device=dev)
           if proj else None)
    approx_list = aptr = None
    if approx:
        # one zeroed buffer, one (B, L) view of it per bucket
        sizes = [b.batch * b.pad_len for b in buckets]
        flat = torch.zeros((sum(sizes),), dtype=torch.float32, device=dev)
        approx_list = [a.view(b.batch, b.pad_len) for a, b in
                       zip(flat.split(sizes), buckets)]
        aptr = [a.data_ptr() for a in approx_list]
    parts = _parts(buckets, [b.values for b in buckets], k, aligned, dev)
    sq_part = None
    if not approx:
        sq_part = torch.empty((sum(p.layout.stats["blocks"] for p in parts),),
                              dtype=torch.float32, device=dev)
    lib, st, off = _kernels.lib(), _kernels.stream(dev), 0
    for part in parts:
        lay = part.layout
        ap = (None if aptr is None else
              (ctypes.c_longlong * len(part.index))(
                  *(aptr[i] for i in part.index)))
        rc = lib.rsp_spmm_residual(
            part.ptrs, len(part.index), ap, _kernels.ptr(lay.desc),
            lay.stats["blocks"], _kernels.ptr(rowfac), _kernels.ptr(scale),
            rowfac.shape[0], _kernels.ptr(tbl),
            int(tbl.dtype == torch.bfloat16), int(aligned), k, n_rows,
            lay.shape.chunk, _kernels.ptr(out),
            (ctypes.c_void_p(0) if sq_part is None else
             ctypes.c_void_p(sq_part.data_ptr() + 4 * off)), st)
        _kernels.check(rc, "spmm_residual")
        _kernels.launches["spmm_residual"] += 1
        off += lay.stats["blocks"]
    sqn = (torch.zeros((), dtype=torch.float32, device=dev)
           if sq_part is None else sq_part.sum())
    return out, sqn, approx_list


# -- public functions --------------------------------------------------------

def spmm_buckets(buckets: Sequence[RowBucket], n_rows: int,
                 dense: torch.Tensor, values_list=None,
                 compute_dtype=None) -> torch.Tensor:
    """Sparse @ dense: (n_rows, n_cols) x (n_cols, k) -> (n_rows, k).

    ``values_list`` optionally overrides each bucket's values (e.g. residual
    values from :func:`residual_values`).  CPU tensors take the plain
    version; CUDA tensors launch K5 once over every bucket (once per 64
    buckets), on the work list of these buckets' shapes (built on the first
    call for a list of shapes, then cached)."""
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
    (n_rows, k), sq_norm scalar)``.  CUDA tensors launch K6 once over
    every bucket (once per 64 buckets), on K5's work list."""
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
