"""Device-resident sparse containers: nnz-bucketed padded row blocks.

Port of ``rsparse_tpu/sparse/device.py``.  Rows are grouped by padded
length from a geometric grid, so every bucket is a dense ``(B, L)`` block of
column indices and values; a kernel solves one bucket per launch and masks
the padding with ``nnz``.  The layouts are identical to the reference's
(same grid, same merge rule, same chunking), which the tests check array by
array.

The zipf head is split off into a dense block (:class:`HotBlock`): its
columns' weights are stored densely per row, and the solve kernels read
them without a per-nnz index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import np_dtype
from ..native import fill_bucket


class RowBucket(NamedTuple):
    """One padded bucket of sparse rows (tensors on one device).

    ``row_ids[b]`` is the original row index of batch entry ``b``; padding
    entries use ``row_id == n_rows`` (a dummy slot sliced off after the
    scatter).  ``col_idx`` padding points at column 0 and is neutralised by
    masks derived from ``nnz``.
    """

    row_ids: torch.Tensor  # (B,)   int32
    col_idx: torch.Tensor  # (B, L) int32
    values: torch.Tensor   # (B, L) float
    nnz: torch.Tensor      # (B,)   int32

    @property
    def batch(self) -> int:
        return self.row_ids.shape[0]

    @property
    def pad_len(self) -> int:
        return self.col_idx.shape[1]

    def mask(self) -> torch.Tensor:
        """(B, L) validity mask."""
        iota = torch.arange(self.pad_len, device=self.nnz.device)
        return iota[None, :] < self.nnz[:, None]


@dataclass(frozen=True)
class BucketedRows:
    """A sparse matrix as a list of padded row buckets."""

    buckets: Tuple[RowBucket, ...]
    n_rows: int
    n_cols: int
    nnz: int
    #: row indices with zero nnz (left out of the buckets unless
    #: ``include_empty`` was set)
    empty_rows: np.ndarray

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        return [(b.batch, b.pad_len) for b in self.buckets]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _length_grid(min_len: int, max_len: int, ratio: float,
                 quantum: int = 8) -> np.ndarray:
    """Geometric grid of padded row lengths: each step grows by ``ratio``,
    rounded up to ``quantum`` (to 32 past 256, as in the reference, so the
    bucket layouts stay identical to its)."""
    g = [min_len]
    while g[-1] < max_len:
        nxt = max(int(g[-1] * ratio), g[-1] + quantum)
        q = quantum if nxt <= 256 else max(quantum, 32)
        g.append(_round_up(nxt, q))
    return np.asarray(g, dtype=np.int64)


def bucket_rows(
    x: sp.spmatrix,
    dtype: torch.dtype,
    device,
    *,
    min_len: int = 8,
    row_align: int = 32,
    max_buckets: int = 24,
    length_ratio: float = 1.25,
    include_empty: bool = False,
    max_elems: Optional[int] = 1 << 22,
) -> BucketedRows:
    """Build a :class:`BucketedRows` on ``device`` from a scipy sparse matrix.

    Rows are grouped by padded length from a geometric grid with step
    ``length_ratio``; the number of distinct lengths is capped at
    ``max_buckets`` by merging the least-populated length upward.  Buckets
    whose ``B * L`` exceeds ``max_elems`` are split into batch chunks.
    """
    csr = sp.csr_matrix(x)
    csr.sort_indices()
    n_rows, n_cols = csr.shape
    row_nnz = np.diff(csr.indptr).astype(np.int64)

    empty = np.flatnonzero(row_nnz == 0).astype(np.int32)
    if include_empty:
        active = np.arange(n_rows, dtype=np.int64)
    else:
        active = np.flatnonzero(row_nnz > 0).astype(np.int64)
    if active.size == 0:
        return BucketedRows((), n_rows, n_cols, int(csr.nnz), empty)

    act_nnz = np.maximum(row_nnz[active], 1)
    grid = _length_grid(min_len, int(act_nnz.max()), length_ratio)
    lengths = grid[np.searchsorted(grid, act_nnz)]
    uniq, counts = np.unique(lengths, return_counts=True)
    while len(uniq) > max_buckets:
        k = int(np.argmin(counts[:-1]))
        lengths[lengths == uniq[k]] = uniq[k + 1]
        uniq, counts = np.unique(lengths, return_counts=True)

    val_dtype = np_dtype(dtype)
    buckets: List[RowBucket] = []
    for L in uniq:
        L = int(L)
        rows_all = active[lengths == L]
        if max_elems is not None:
            chunk_rows = max(_round_up(max(max_elems // L, 1), row_align),
                             row_align)
        else:
            chunk_rows = len(rows_all)
        for s in range(0, len(rows_all), chunk_rows):
            rows = rows_all[s:s + chunk_rows]
            B = _round_up(len(rows), row_align)
            filled = None
            if csr.nnz:
                filled = fill_bucket(csr.indptr, csr.indices, csr.data, rows,
                                     B, L, n_rows, val_dtype)
            if filled is not None:
                col_idx, values, nnz_arr, row_ids = filled
            else:
                col_idx, values, nnz_arr, row_ids = _fill_bucket_numpy(
                    csr, row_nnz, rows, B, L, n_rows, val_dtype)
            buckets.append(RowBucket(
                row_ids=torch.from_numpy(row_ids).to(device),
                col_idx=torch.from_numpy(col_idx).to(device),
                values=torch.from_numpy(values).to(device, dtype),
                nnz=torch.from_numpy(nnz_arr).to(device),
            ))
    return BucketedRows(tuple(buckets), n_rows, n_cols, int(csr.nnz), empty)


def _fill_bucket_numpy(csr, row_nnz, rows, B, L, n_rows, val_dtype):
    """Vectorised padded gather of CSR segments (the native fill's twin)."""
    nnz_arr = np.zeros((B,), dtype=np.int32)
    nnz_arr[: len(rows)] = row_nnz[rows]
    row_ids = np.full((B,), n_rows, dtype=np.int32)
    row_ids[: len(rows)] = rows
    if not csr.nnz:
        return (np.zeros((B, L), np.int32), np.zeros((B, L), val_dtype),
                nnz_arr, row_ids)
    starts = np.zeros((B,), dtype=np.int64)
    starts[: len(rows)] = csr.indptr[rows]
    offs = np.arange(L, dtype=np.int64)[None, :]
    flat = np.minimum(starts[:, None] + offs, csr.nnz - 1)
    valid = offs < nnz_arr[:, None]
    col_idx = np.where(valid, csr.indices[flat], 0).astype(np.int32)
    values = np.where(valid, csr.data[flat], 0).astype(val_dtype)
    return col_idx, values, nnz_arr, row_ids


class HotBlock(NamedTuple):
    """Dense block for the hottest columns (zipf head).

    ``W[r, j]`` is the confidence (or rating) of row ``r`` at column
    ``hot_ids[j]``; 0 means absent (implicit confidences are >= 1 where
    present).  The cold remainder stays on the bucketed path; the solve
    adds the dense head's rhs, matvec/lhs and loss terms.

    For explicit feedback a 0 *rating* is a legal observation, so presence
    is then carried apart as packed bits ``present_bits`` ((n_rows,
    ceil(H/8)) uint8, little-endian), built only when a stored zero lands
    in the head; otherwise ``W != 0`` is exact.
    """

    hot_ids: torch.Tensor   # (H,) int32 original column ids
    W: torch.Tensor         # (n_rows, H) confidences, 0 = absent
    row_nnz: torch.Tensor   # (n_rows,) int32 TOTAL row nnz (hot + cold)
    present_bits: Optional[torch.Tensor] = None   # (n_rows, ceil(H/8)) uint8


def split_hot_cold(
    x: sp.spmatrix,
    n_hot: int,
    dtype: torch.dtype,
    device,
    with_presence: bool = False,
) -> Tuple[Optional[HotBlock], sp.csr_matrix]:
    """Split columns into a dense hot block on ``device`` + a cold CSR.

    The cold matrix keeps the original shape and column ids; the hot
    entries are removed structurally, so explicitly stored zeros elsewhere
    survive.  Returns ``(None, csr)`` when ``n_hot <= 0`` or ``x`` is empty.
    Explicit-feedback callers pass ``with_presence=True`` (see
    :class:`HotBlock`).
    """
    csr = sp.csr_matrix(x)
    n_rows, n_cols = csr.shape
    n_hot = int(min(n_hot, n_cols))
    if n_hot <= 0 or csr.nnz == 0:
        return None, csr
    col_counts = np.bincount(csr.indices, minlength=n_cols)
    hot_ids = np.sort(np.argsort(-col_counts, kind="stable")[:n_hot]
                      .astype(np.int32))
    row_nnz_total = np.diff(csr.indptr).astype(np.int32)

    hot_pos = np.full((n_cols,), -1, np.int32)
    hot_pos[hot_ids] = np.arange(n_hot, dtype=np.int32)
    is_hot = hot_pos[csr.indices] >= 0
    rows_all = np.repeat(np.arange(n_rows, dtype=np.int64),
                         np.diff(csr.indptr))
    rows = rows_all[is_hot]
    hot_cols = hot_pos[csr.indices[is_hot]]
    hot_data = csr.data[is_hot]

    present_bits = None
    if with_presence and (hot_data == 0).any():
        present = np.zeros((n_rows, -(-n_hot // 8) * 8), bool)
        present[rows, hot_cols] = True
        present_bits = torch.from_numpy(
            np.packbits(present, axis=1, bitorder="little")).to(device)

    keep = ~is_hot
    cold_indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows_all[keep], minlength=n_rows),
              out=cold_indptr[1:])
    cold = sp.csr_matrix(
        (csr.data[keep], csr.indices[keep], cold_indptr), shape=csr.shape)

    # the dense W is built on the device from the hot triplets: ~16 B/nnz
    # over the bus instead of the whole (n_rows, H) block
    W = torch.zeros((n_rows, n_hot), dtype=dtype, device=device)
    W[torch.from_numpy(rows).to(device),
      torch.from_numpy(hot_cols.astype(np.int64)).to(device)] = (
        torch.from_numpy(hot_data).to(device, dtype))
    blk = HotBlock(hot_ids=torch.from_numpy(hot_ids).to(device),
                   W=W,
                   row_nnz=torch.from_numpy(row_nnz_total).to(device),
                   present_bits=present_bits)
    return blk, cold


def hot_bucket_rows(hot: Optional[HotBlock], buckets):
    """Gather the hot block's rows into bucket order once, at staging time.

    Bucket membership is fixed for the whole fit, so every sweep then reads
    a contiguous ``(B, H)`` block per bucket.  Returns a tuple aligned with
    ``buckets`` of ``(W_rows (B, H), bits_rows (B, ceil(H/8)) or None,
    row_nnz_rows (B,))``, or None.
    """
    if hot is None:
        return None
    n = hot.W.shape[0]
    bits = hot.present_bits
    out = []
    for b in buckets:
        ids = b.row_ids.clamp(max=n - 1).long()
        out.append((hot.W[ids], None if bits is None else bits[ids],
                    hot.row_nnz[ids]))
    return tuple(out)


# -- staged-bucket cache ------------------------------------------------------

_STAGING_CACHE: dict = {}
_STAGING_CACHE_MAX = 10


def clear_staging_cache() -> int:
    """Drop every cached staged tensor, releasing its device memory; returns
    the number of entries dropped.  The LRU otherwise keeps up to
    ``_STAGING_CACHE_MAX`` entries alive for the life of the process."""
    n = len(_STAGING_CACHE)
    _STAGING_CACHE.clear()
    return n


def _csr_fingerprint(csr: sp.csr_matrix) -> tuple:
    """Cheap content fingerprint of a CSR matrix: its shape, nnz and the
    adler32 of its three arrays (milliseconds, against seconds to restage
    the buckets of a large matrix)."""
    import zlib
    return (csr.shape, csr.nnz,
            zlib.adler32(np.ascontiguousarray(csr.data)),
            zlib.adler32(np.ascontiguousarray(csr.indices)),
            zlib.adler32(np.ascontiguousarray(csr.indptr)))


def staged_aux_cached(tag: str, fingerprint, build, extra=None):
    """Staging cache keyed by ``(tag, extra, fingerprint)``: ``build()`` runs
    on a miss, and its result is kept in a small LRU."""
    key = (tag, extra, fingerprint)
    hit = _STAGING_CACHE.pop(key, None)
    if hit is None:
        hit = build()
    _STAGING_CACHE[key] = hit                   # re-insert: LRU order
    while len(_STAGING_CACHE) > _STAGING_CACHE_MAX:
        _STAGING_CACHE.pop(next(iter(_STAGING_CACHE)))
    return hit


def staged_cached(tag: str, csr: sp.csr_matrix, build, extra=None):
    """Content-addressed staging cache for tensors built from ``csr``.

    soft-impute and LinearFlow's closed-form step bucket the same matrix
    and its transpose; the second caller hits the cache.  ``extra`` carries
    every other input that shapes what ``build()`` makes (the dtype and the
    device at least): two models that differ only in precision or device
    must not share an entry."""
    return staged_aux_cached(tag, _csr_fingerprint(csr), build, extra)
