"""Item-axis-sharded top-k retrieval.

Port of ``rsparse_tpu/parallel/topk_sharded.py``.  The item axis is split
over the mesh's ``data`` axis: every rank scores its item slice and runs
K3 (``ops/topk.py`` ``masked_top_k_bits``) on it with its slice of the
packed mask bits, and only the O(k) candidates a user cross the wire (an
all-gather of scores and global ids), followed by a merge.  The merge
keeps the single-process order (score descending, index ascending): the
candidates arrive in rank order, each rank's in index order among ties,
and a stable sort keeps that order among equal scores.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.topk import masked_top_k_bits, pack_mask_bits
from .mesh import Mesh


def _merge(group, s: torch.Tensor, i: torch.Tensor, k: int):
    """The top k of every member's (C, k) candidates (scores, global
    ids): the stable descending sort of their concatenation in rank
    order."""
    C = s.shape[0]
    s_all = group.all_gather(s[None]).permute(1, 0, 2).reshape(C, -1)
    i_all = group.all_gather(i[None]).permute(1, 0, 2).reshape(C, -1)
    sm, order = torch.sort(s_all, dim=1, descending=True, stable=True)
    return sm[:, :k], torch.gather(i_all, 1, order[:, :k])


def sharded_top_k(
    mesh: Mesh,
    x: torch.Tensor,                    # (n_users, R), whole on every rank
    y: torch.Tensor,                    # (R, n_items), whole on every rank
    k: int,
    mask: Optional[torch.Tensor] = None,       # (n_users, n_items) bool
    glob_mean: float = 0.0,
    axis: str = "data",
    mask_bits: Optional[torch.Tensor] = None,  # (n_users, n_items // 8)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``x @ y + glob_mean`` with the item axis split over
    ``axis``: (scores (n_users, k), indices (n_users, k) int32), the same
    on every rank.  ``n_items`` must divide the axis size and k must not
    exceed a rank's items.  The mask comes as a dense bool matrix
    (``mask``, True = masked) or as packed little-endian bits
    (``mask_bits``, ``ops.topk.pack_mask_bits``); each rank reads its
    columns of it."""
    group = mesh.group(axis)
    n_dev, me = group.size, group.rank
    n_users, n_items = x.shape[0], y.shape[1]
    if n_items % n_dev:
        raise ValueError(f"n_items={n_items} not divisible by mesh axis "
                         f"{n_dev}")
    shard = n_items // n_dev
    if k > shard:
        raise ValueError(f"k={k} must be <= items-per-shard={shard}")
    if mask is not None and mask_bits is not None:
        raise ValueError("pass at most one of mask / mask_bits")
    if mask_bits is not None and shard % 8:
        raise ValueError("mask_bits needs items-per-shard divisible by 8")
    lo = me * shard
    scores = x @ y[:, lo:lo + shard]
    bits = None
    if mask_bits is not None:
        bits = mask_bits[:, lo // 8:(lo + shard) // 8].contiguous()
    elif mask is not None:
        # pack this rank's columns, padded to whole bytes with masked
        # columns (they rank below every real column)
        width = -(-shard // 8) * 8
        dense = np.ones((n_users, width), bool)
        dense[:, :shard] = mask[:, lo:lo + shard].cpu().numpy()
        bits = torch.from_numpy(
            np.packbits(dense, axis=1, bitorder="little")).to(x.device)
        scores = torch.nn.functional.pad(scores, (0, width - shard))
    s, i = masked_top_k_bits(scores.contiguous(), bits, k, glob_mean)
    return _merge(group, s, i + lo, k)


def sharded_top_product(
    mesh: Mesh,
    x,
    y,
    k: int,
    not_recommend: Optional[sp.spmatrix] = None,
    exclude: Optional[np.ndarray] = None,
    glob_mean: float = 0.0,
    axis: str = "data",
    user_chunk: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """The mesh's ``ops.topk.top_product``: the same contract (top-k of
    ``x @ y + glob_mean`` with per-user ``not_recommend`` and global
    ``exclude`` masks; (indices, scores) numpy), the item axis split over
    ``axis``.  Items are padded to a multiple of 256 a rank, the padding
    masked; every rank returns the whole result."""
    n_dev = mesh.axis_size(axis)
    device = mesh.device
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    y = torch.as_tensor(y, dtype=torch.float32).to(device)
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
    n_pad = -(-n_items // (256 * n_dev)) * 256 * n_dev
    if k > n_pad // n_dev:
        raise ValueError(f"k={k} > items-per-shard={n_pad // n_dev}")
    if n_pad > n_items:
        y = torch.nn.functional.pad(y, (0, n_pad - n_items))
        if exclude_mask is None and nr is None:
            # the zero columns would score glob_mean: mask them
            exclude_mask = np.zeros((n_items,), bool)
    masked = nr is not None or exclude_mask is not None
    idx = np.empty((n_users, k), np.int32)
    scores = np.empty((n_users, k), np.float32)
    for s in range(0, n_users, user_chunk):
        e = min(s + user_chunk, n_users)
        bits = None
        if masked:
            bits = torch.from_numpy(pack_mask_bits(
                n_pad, csr=nr, rows=slice(s, e), exclude_mask=exclude_mask,
                n_rows=e - s)).to(device)
        ts, ti = sharded_top_k(mesh, x[s:e], y, k, glob_mean=glob_mean,
                               axis=axis, mask_bits=bits)
        scores[s:e] = ts.cpu().numpy()
        idx[s:e] = ti.cpu().numpy()
    return idx, scores


def shard_cap(n_items: int, n_dev: int) -> int:
    """Items a rank ranks in :func:`sharded_top_product`: a k above it
    takes the single-process path (``rsparse_tpu/models/base.py``)."""
    return -(-n_items // (256 * n_dev)) * 256
