"""Masked exact top-k retrieval (``top_product``).

Port of ``rsparse_tpu/ops/topk.py``.  Users are scored in chunks as
``U_c @ V`` (``torch.matmul``, full float32), and K3 (``csrc/topk.cu``)
takes the exact top-k of each row of ``max(scores + glob_mean, NEG_INF)``:

- masks travel as packed uint8 bits, little-endian (bit ``t`` of byte ``j``
  guards column ``8 j + t``, as ``np.packbits(..., bitorder="little")``);
  a masked column reads ``NEG_INF`` (float32 min, the value the reference
  writes over masked scores);
- the order is (score descending, index ascending): ties go to the lowest
  index, and a row with fewer than k live columns still returns k distinct
  indices, its tail at ``NEG_INF``.

K3 has two routes, chosen by k (:func:`topk_plan`): for k <= ``TOPK_KMAX``
one pass over the row (per-thread candidate lists above a sampled
threshold, merged by warp, CTA and cluster); above it the first kernel's k
rounds.  :func:`_masked_top_k_plain` is K3's plain version; the wrapper
:func:`masked_top_k_bits` takes it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import _kernels

NEG_INF = float(np.finfo(np.float32).min)
#: largest k of K3's one-pass route (csrc/topk.cu kMaxK)
TOPK_KMAX = 32
#: threads a CTA of that route (csrc/topk.cu kListThreads)
TOPK_THREADS = 256
#: the H100's streaming multiprocessors
SMS = 132


def topk_plan(C: int, n: int, k: int, masked: bool, sms: int = SMS) -> dict:
    """K3's launch for C rows of n columns: ``route`` "lists" (one pass,
    k <= TOPK_KMAX) or "rounds" (the first kernel, any k); for "lists" the
    sorted candidate list a thread keeps (``list_k``: 16 or 32 entries),
    ``parts``, the CTAs (a cluster) a row is split over so that few rows
    still fill the card (doubled while C * parts < sms and each CTA keeps
    at least four 16-byte chunks a thread), and ``words``, whether the mask
    is read as 32-bit words (n % 32 == 0; bytes otherwise)."""
    if k > TOPK_KMAX:
        return dict(route="rounds", list_k=0, parts=1, words=False)
    parts = 1
    while (parts < 8 and C * parts < sms
           and n // 4 >= 2 * 2 * parts * TOPK_THREADS):
        parts *= 2
    return dict(route="lists", list_k=16 if k <= 16 else 32, parts=parts,
                words=masked and n % 32 == 0)


def _expand_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., m) uint8 -> (..., 8 m) bool, little-endian bit order."""
    t = torch.arange(8, dtype=torch.uint8, device=bits.device)
    e = (bits[..., None] >> t) & 1
    return e.reshape(bits.shape[:-1] + (bits.shape[-1] * 8,)) != 0


def _masked_top_k_plain(scores: torch.Tensor, bits: Optional[torch.Tensor],
                        k: int, glob_mean: float = 0.0):
    """Plain version of K3: mask, then a stable descending sort (ties keep
    index order, which ``torch.topk`` does not promise)."""
    live = torch.clamp(scores + glob_mean, min=NEG_INF)
    if bits is not None:
        live = live.masked_fill(_expand_bits(bits), NEG_INF)
    s, i = torch.sort(live, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k].to(torch.int32)


def masked_top_k_bits(scores: torch.Tensor, bits: Optional[torch.Tensor],
                      k: int, glob_mean: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: exact top-k of ``max(scores + glob_mean, NEG_INF)`` per row, with
    1-bits of ``bits`` ((B, n // 8) uint8, or None for no mask) marking
    masked columns.  Returns (scores (B, k) float32, indices (B, k) int32).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    B, n = scores.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n={n}]")
    if bits is not None and (n % 8 or tuple(bits.shape) != (B, n // 8)):
        raise ValueError(f"bits shape {tuple(bits.shape)} != {(B, n // 8)}")
    if scores.device.type == "cpu":
        return _masked_top_k_plain(scores, bits, k, glob_mean)
    return _masked_top_k_cuda(scores, bits, k, glob_mean)


def _masked_top_k_cuda(scores, bits, k, glob_mean, rounds=False):
    """K3 on the card, on the route :func:`topk_plan` picks, or with
    ``rounds`` on the round-based route whatever k (checks hold both
    routes)."""
    B, n = scores.shape
    _kernels.check_tensor("scores", scores, (B, n), torch.float32)
    if bits is not None:
        _kernels.check_tensor("bits", bits, (B, n // 8), torch.uint8)
    plan = topk_plan(B, n, TOPK_KMAX + 1 if rounds else k, bits is not None,
                     _sms(scores.device))
    words = plan["words"] and bits.data_ptr() % 4 == 0
    out_s = torch.empty((B, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=scores.device)
    rc = _kernels.lib().rsp_topk(
        _kernels.ptr(scores), _kernels.ptr(bits), B, n, k,
        ctypes.c_float(glob_mean), int(plan["route"] == "lists"),
        plan["list_k"], plan["parts"], int(words), _kernels.ptr(out_s),
        _kernels.ptr(out_i), _kernels.stream(scores.device))
    _kernels.check(rc, "topk")
    _kernels.launches["topk"] += 1
    return out_s, out_i


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def pack_mask_bits(
    n_cols_padded: int,
    dense_rows: Optional[np.ndarray] = None,
    csr: Optional[sp.spmatrix] = None,
    rows: Optional[slice] = None,
    exclude_mask: Optional[np.ndarray] = None,
    n_rows: Optional[int] = None,
) -> np.ndarray:
    """Pack the host-side bitmask that :func:`masked_top_k_bits` reads.

    Combines (a) per-row masked columns from a CSR slice, (b) a global
    column exclude mask, and (c) dead bits for padding columns beyond the
    true item count, into a (n_rows, n_cols_padded // 8) uint8 array."""
    if dense_rows is not None:
        dense = dense_rows
        n_rows = dense.shape[0]
        if dense.shape[1] < n_cols_padded:
            pad = np.ones((n_rows, n_cols_padded - dense.shape[1]), bool)
            dense = np.concatenate([dense, pad], axis=1)
    else:
        dense = np.zeros((n_rows, n_cols_padded), bool)
        n_true = n_cols_padded
        if exclude_mask is not None:
            n_true = len(exclude_mask)
            dense[:, :n_true] = exclude_mask[None, :]
        if csr is not None:
            n_true = csr.shape[1]
            sub = csr[rows] if rows is not None else csr
            coo = sub.tocoo()
            dense[coo.row, coo.col] = True
        dense[:, n_true:] = True
    return np.packbits(dense, axis=1, bitorder="little")


def top_product(
    x,
    y,
    k: int,
    not_recommend: Optional[sp.spmatrix] = None,
    exclude: Optional[np.ndarray] = None,
    glob_mean: float = 0.0,
    user_chunk: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k items by score ``x @ y + glob_mean`` with masking.

    x: (n_users, R) user embeddings; y: (R, n_items) item embeddings, each a
    numpy array or a tensor.  Scoring runs on ``x``'s device when ``x`` is
    a tensor, else on "cuda".  Returns (indices (n_users, k) int32 0-based,
    scores (n_users, k) float32) as numpy arrays.  Same contract as the
    reference ``top_product`` (src/matrix_top_product.cpp:20-102) minus R's
    1-based indexing.
    """
    device = x.device if isinstance(x, torch.Tensor) else "cuda"
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    n_users, n_items = x.shape[0], y.shape[1]
    if k > n_items:
        raise ValueError(f"k={k} > n_items={n_items}")
    if n_users == 0:
        return np.empty((0, k), np.int32), np.empty((0, k), np.float32)

    exclude_mask = None
    if exclude is not None and len(exclude) > 0:
        exclude = np.asarray(exclude)
        if exclude.max() >= n_items or exclude.min() < 0:
            raise ValueError(
                "items_exclude indices must be in [0, number of items)")
        exclude_mask = np.zeros((n_items,), bool)
        exclude_mask[exclude] = True
    nr = None
    if not_recommend is not None:
        nr = sp.csr_matrix(not_recommend)
        if nr.shape != (n_users, n_items):
            raise ValueError("not_recommend shape mismatch")
        if nr.nnz == 0:
            nr = None

    masked = nr is not None or exclude_mask is not None
    # masked scoring runs over an item axis padded to a multiple of 256 with
    # zero columns whose mask bits are set (the reference's layout)
    n_pad = -(-n_items // 256) * 256 if masked else n_items
    if n_pad > n_items:
        y = torch.nn.functional.pad(y, (0, n_pad - n_items))
    idx = np.empty((n_users, k), np.int32)
    scores = np.empty((n_users, k), np.float32)
    for s in range(0, n_users, user_chunk):
        e = min(s + user_chunk, n_users)
        bits = None
        if masked:
            bits = torch.from_numpy(pack_mask_bits(
                n_pad, csr=nr, rows=slice(s, e), exclude_mask=exclude_mask,
                n_rows=e - s)).to(device)
        ts, ti = masked_top_k_bits(x[s:e] @ y, bits, k, glob_mean)
        scores[s:e] = ts.cpu().numpy()
        idx[s:e] = ti.cpu().numpy()
    return idx, scores
