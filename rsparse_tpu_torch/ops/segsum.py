"""Staging of the SGD models' blocks and their per-feature slot maps.

Port of the FTRL/FM part of ``rsparse_tpu/ops/segsum.py``
(``staged_blocks_with_layouts``, ``staged_label_gathers``).  The blocks are
:func:`~rsparse_tpu_torch.sparse.device.bucket_rows` of the input with the
reference's arguments (``include_empty=True``, ``max_elems=1 << 20``), so
the port walks exactly the reference's blocks: same rows, same order, same
``(B, L)``.  A different partition would give another, equally valid, SGD
trajectory.

The reference's scheduled two-level layout (``SchedLayout``,
``build_sched_layout``, ``sched_to_rows``, ``sched_reduce_chunks``,
``sched_apply_sums_multi``, ``scheduled_sums`` and the column schedules)
is not carried over: it exists because scatter is slow on a TPU.  What it
computes, the per-feature sums of per-position updates added to a table
once per block, happens inside K7 (``csrc/ftrl.cu``) and K8
(``csrc/fm.cu``), from a host-built slot map carried with each block:
``feats``, the block's distinct feature ids, and ``slot``, each entry's
index into ``feats``.  K7 adds per-entry updates into zeroed per-slot sums
with atomics and then applies them at ``feats`` (distinct ids, no race).
K8 walks the block's entries grouped by feature instead (``order``, the
valid entries' flat indices sorted by slot, and ``offs``, each slot's
range in ``order``): every feature's sums are taken in registers in a
fixed order, with no atomics and no scratch to zero.

GloVe's scheduled tail epoch (``build_stacked_col_schedule``,
``sched_reduce_chunks``, ``sched_apply_sums_multi`` over its stacked
shards) goes the same way into K10 (``csrc/glove.cu``): each staged shard
carries one slot map per side from :func:`shard_slot_maps`, built on the
device at staging and again after every shuffle, since a shuffle changes
what each shard holds.
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..sparse.device import (_csr_fingerprint, bucket_rows, staged_aux_cached,
                             staged_cached)

#: entries per GLM block (the reference's ``max_elems``, models/ftrl.py:39)
GLM_BLOCK_ELEMS = 1 << 20


class GLMBlock(NamedTuple):
    """One padded row block with its slot map (tensors on one device).

    ``row_ids``/``col_idx``/``values``/``nnz`` are the
    :class:`~rsparse_tpu_torch.sparse.device.RowBucket` fields.
    ``feats[u]`` is the u-th distinct feature id of the block's valid
    entries (sorted); ``slot[b, l]`` is the index of ``col_idx[b, l]`` in
    ``feats`` for a valid entry and ``len(feats)`` at padding.
    ``order`` lists the flat indices ``b * L + l`` of the N valid entries
    grouped by slot ascending, row-major within a slot, and slot u's
    entries are ``order[offs[u]:offs[u + 1]]``."""

    row_ids: torch.Tensor  # (B,)   int32
    col_idx: torch.Tensor  # (B, L) int32
    values: torch.Tensor   # (B, L) float
    nnz: torch.Tensor      # (B,)   int32
    feats: torch.Tensor    # (U,)   int32
    slot: torch.Tensor     # (B, L) int32
    order: torch.Tensor    # (N,)   int32
    offs: torch.Tensor     # (U + 1,) int32

    def mask(self) -> torch.Tensor:
        """(B, L) validity mask."""
        iota = torch.arange(self.col_idx.shape[1], device=self.nnz.device)
        return iota[None, :] < self.nnz[:, None]


def slot_map(col_idx: np.ndarray, nnz: np.ndarray):
    """``(feats, slot, order, offs)`` of one host block: the distinct
    feature ids of the valid entries, each entry's index into them
    (``len(feats)`` at padding), the valid entries' flat indices grouped
    by that index (row-major within a group), and each group's offsets
    into ``order``; all from one sort of (feature id, flat index) keys."""
    B, L = col_idx.shape
    valid = np.arange(L)[None, :] < nnz[:, None]
    pos = np.flatnonzero(valid)
    keys = (col_idx.reshape(-1)[pos].astype(np.int64) << 32) | pos
    keys.sort()
    ids = keys >> 32
    start = np.ones(len(keys), bool)     # an entry that opens a group
    start[1:] = ids[1:] != ids[:-1]
    order = (keys & 0xFFFFFFFF).astype(np.int32)
    slot = np.full(B * L, np.count_nonzero(start), np.int32)
    slot[order] = np.cumsum(start) - 1
    offs = np.append(np.flatnonzero(start), len(keys))
    return (ids[start].astype(np.int32), slot.reshape(B, L), order,
            offs.astype(np.int32))


class ShardMaps(NamedTuple):
    """Slot maps of stacked (S, N) shards on one side (tensors on one
    device): shard s's distinct ids of its valid entries, sorted, are
    ``feats[offs[s]:offs[s + 1]]``, and ``slot[s, e]`` is entry e's index
    into them (their count at padding)."""

    feats: torch.Tensor  # (sum of U_s,) int32
    slot: torch.Tensor   # (S, N) int32
    offs: Tuple[int, ...]

    def shard(self, s: int):
        """(feats, slot) of shard s."""
        return self.feats[self.offs[s]:self.offs[s + 1]], self.slot[s]


def shard_slot_maps(ids: torch.Tensor, valid: torch.Tensor) -> ShardMaps:
    """:func:`slot_map` of every shard of ``ids`` (S, N) over its ``valid``
    entries, from one ``torch.unique`` over (shard, id) keys on the ids'
    device."""
    S, N = ids.shape
    shard = torch.arange(S, device=ids.device)[:, None].expand(S, N)
    keys = (shard[valid] << 32) | ids[valid].long()
    uniq, inv = torch.unique(keys, return_inverse=True)
    counts = torch.bincount(uniq >> 32, minlength=S)
    starts = torch.cumsum(counts, 0) - counts
    slot = counts[:, None].expand(S, N).clone()
    slot[valid] = inv - starts[keys >> 32]
    offs = [0] + torch.cumsum(counts, 0).tolist()
    return ShardMaps((uniq & 0xFFFFFFFF).to(torch.int32),
                     slot.to(torch.int32), tuple(offs))


def staged_glm_blocks(csr, dtype: torch.dtype,
                      device) -> Tuple[GLMBlock, ...]:
    """Content-cached GLM blocks of ``csr`` on ``device`` with their slot
    maps and feature-ordered entry lists (the counterpart of the
    reference's ``staged_blocks_with_layouts``): bucketed on the host,
    slot maps built there, then copied to the device once."""

    def build():
        br = bucket_rows(csr, dtype, "cpu", include_empty=True,
                         max_elems=GLM_BLOCK_ELEMS)
        out = []
        for b in br.buckets:
            maps = slot_map(b.col_idx.numpy(), b.nnz.numpy())
            out.append(GLMBlock(*(t.to(device) for t in b),
                                *(torch.from_numpy(a).to(device)
                                  for a in maps)))
        return tuple(out)

    return staged_cached("glm_blocks", csr, build,
                         extra=(str(dtype), str(torch.device(device))))


def staged_label_gathers(tag: str, csr, y: np.ndarray, weights: np.ndarray,
                         blocks, dtype: torch.dtype, device,
                         zero_pad_weight: bool):
    """Per-block ``(y_b, w_b)`` gathers, content-cached
    (rsparse_tpu/ops/segsum.py:252).  Padding rows read the last row's label
    and weight; ``zero_pad_weight`` zeroes their weight instead (the FM
    intercept contract: w0 steps once per real sample,
    src/factorization_machine.cpp:147-149)."""
    fp = (_csr_fingerprint(csr), zlib.adler32(np.ascontiguousarray(y)),
          zlib.adler32(np.ascontiguousarray(weights)), len(y))

    def build():
        n_rows = len(y)
        yd = torch.as_tensor(np.asarray(y), dtype=dtype, device=device)
        wd = torch.as_tensor(np.asarray(weights), dtype=dtype, device=device)
        out = []
        for b in blocks:
            rid = b.row_ids.long().clamp(max=n_rows - 1)
            w_b = wd[rid]
            if zero_pad_weight:
                w_b = torch.where(b.row_ids < n_rows, w_b, 0.0)
            out.append((yd[rid].contiguous(), w_b.contiguous()))
        return tuple(out)

    return staged_aux_cached(tag, fp, build,
                             extra=(str(dtype), str(torch.device(device)),
                                    zero_pad_weight))
