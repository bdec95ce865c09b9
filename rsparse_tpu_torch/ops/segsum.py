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
``feats``, the block's distinct feature ids, ``slot``, each entry's index
into ``feats``, ``order``, the valid entries' flat indices sorted by slot,
and ``offs``, each slot's range in ``order``.  Both kernels walk a block's
entries grouped by feature: every feature's sums are taken in registers in
a fixed order and its table rows written once, with no atomics, no scratch
to zero, and the same result on every run.

GloVe's scheduled tail epoch (``build_stacked_col_schedule``,
``sched_reduce_chunks``, ``sched_apply_sums_multi`` over its stacked
shards) goes the same way into K10 (``csrc/glove.cu``): each staged shard
carries one slot map per side from :func:`shard_slot_maps` (``feats``,
``slot``, and the side's entries grouped by slot, ``order`` and
``bounds``), built on the device from one sort at staging and again after
every shuffle, since a shuffle changes what each shard holds; each side
walks its entries by its own id.
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


class CompactBlock(NamedTuple):
    """A GLM block relabelled onto a compact table (mesh fits,
    ``parallel/sgd_sharded.py``): ``ids`` are the global rows of the compact
    table, the block's ``feats`` then the row its padding entries read
    (``col_idx`` 0 there, as in one process); ``block`` reads compact row
    ``slot`` at a valid entry and row ``U`` at padding, and its ``feats``
    are ``0..U-1``."""

    ids: torch.Tensor      # (U + 1,) int64
    block: GLMBlock


def compact_glm_block(blk: GLMBlock) -> CompactBlock:
    """:class:`CompactBlock` of ``blk``, on its device."""
    U = blk.feats.shape[0]
    pad = blk.col_idx.new_zeros(1)
    ids = torch.cat([blk.feats, pad]).long()
    col = torch.where(blk.mask(), blk.slot, U).to(torch.int32)
    feats = torch.arange(U, dtype=torch.int32, device=blk.feats.device)
    return CompactBlock(ids, blk._replace(col_idx=col, feats=feats))


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


class WorkList(NamedTuple):
    """One side of one shard as K10's bf16 walk takes it
    (:func:`k10_work_lists`): ``items[i] = (e0, e1, q, end)``, the entries
    ``order[e0:e1]`` that one CTA walks, the chunk slot ``q`` its rounded
    sums go to (-1: the item holds whole features, each stepped at once),
    and ``end``, the end of the item's feature in ``order`` where the item
    is a feature's first chunk (the ordered path walks the whole feature
    from there), -1 for a later chunk, ``e1`` otherwise; ``multi[m] = (u,
    q0)``, the slots of the features over several chunks and their first
    chunk slot (launch F sums chunks q0, q0 + 1, ... in order)."""

    items: torch.Tensor   # (n_items, 4) int32
    multi: torch.Tensor   # (n_multi, 2) int32


class ShardMaps(NamedTuple):
    """Slot maps of stacked (S, N) shards on one side (tensors on one
    device): shard s's distinct ids of its valid entries, sorted, are
    ``feats[offs[s]:offs[s + 1]]``, and ``slot[s, e]`` is entry e's index
    into them (their count at padding).  ``order[s]`` lists shard s's
    valid entries grouped by slot ascending, entry ascending within a slot
    (N past its valid entries), and slot u's entries are ``order[s, b[u]:
    b[u + 1]]`` with ``b = bounds[offs[s] + s:offs[s + 1] + s + 1]``.
    ``items`` / ``multi`` hold every shard's :class:`WorkList`, shard s's
    at ``item_offs[s]:item_offs[s + 1]`` / ``multi_offs``."""

    feats: torch.Tensor   # (sum of U_s,) int32
    slot: torch.Tensor    # (S, N) int32
    offs: Tuple[int, ...]
    order: torch.Tensor   # (S, N) int32
    bounds: torch.Tensor  # (sum of U_s + S,) int32
    items: torch.Tensor   # (sum of n_items_s, 4) int32
    item_offs: Tuple[int, ...]
    multi: torch.Tensor   # (sum of n_multi_s, 2) int32
    multi_offs: Tuple[int, ...]

    def shard(self, s: int):
        """(feats, slot, order, bounds) of shard s."""
        a, b = self.offs[s], self.offs[s + 1]
        return (self.feats[a:b], self.slot[s], self.order[s],
                self.bounds[a + s:b + s + 1])

    def work(self, s: int) -> WorkList:
        """Shard s's :class:`WorkList`."""
        return WorkList(
            self.items[self.item_offs[s]:self.item_offs[s + 1]],
            self.multi[self.multi_offs[s]:self.multi_offs[s + 1]])


def shard_slot_maps(ids: torch.Tensor, valid: torch.Tensor) -> ShardMaps:
    """:func:`slot_map` of every shard of ``ids`` (S, N) over its ``valid``
    entries, from one stable device sort of (shard, id) keys over the valid
    entries in (shard, entry) order, so that equal keys keep their entries
    ascending: the sort of (shard, id, entry) keys."""
    S, N = ids.shape
    dev = ids.device
    pos = torch.nonzero(valid.reshape(-1)).reshape(-1)   # shard-major
    keys = ((pos // N) << 32) | ids.reshape(-1)[pos].long()
    keys, perm = torch.sort(keys, stable=True)
    pos = pos[perm]
    shard = keys >> 32
    start = torch.ones_like(keys, dtype=torch.bool)      # opens a slot
    start[1:] = keys[1:] != keys[:-1]
    gid = torch.cumsum(start, 0) - 1                     # slot over shards
    counts = torch.bincount(shard[start], minlength=S)   # U_s
    n_valid = torch.bincount(shard, minlength=S)
    u0 = torch.cumsum(counts, 0) - counts
    e0 = torch.cumsum(n_valid, 0) - n_valid
    slot = counts[:, None].expand(S, N).clone()
    slot.view(-1)[pos] = gid - u0[shard]
    rank = torch.arange(keys.numel(), device=dev) - e0[shard]
    order = torch.full((S, N), N, dtype=torch.int64, device=dev)
    order[shard, rank] = pos % N
    # shard s's slot u begins at bounds[u0[s] + s + u]; its end, n_valid[s]
    ends = torch.cumsum(counts, 0)
    offs = [0] + ends.tolist()
    bounds = torch.empty((offs[-1] + S,), dtype=torch.int64, device=dev)
    bounds[gid[start] + shard[start]] = rank[start]
    bounds[ends + torch.arange(S, device=dev)] = n_valid
    items, item_offs, multi, multi_offs = k10_work_lists(bounds, offs, N)
    return ShardMaps((keys[start] & 0xFFFFFFFF).to(torch.int32),
                     slot.to(torch.int32), tuple(offs),
                     order.to(torch.int32), bounds.to(torch.int32),
                     items, item_offs, multi, multi_offs)


#: entries a packed item of K10's bf16 walk holds at most: the features
#: of at most this many entries that lie in one window of this many
#: entries of a side's order go to one CTA (csrc/glove.cu kPack)
K10_PACK = 32


def k10_work_lists(bounds: torch.Tensor, offs, N: int):
    """K10's bf16 work lists (:class:`WorkList`) of every shard of one side,
    on ``bounds``' device, from the slot ranges alone: a feature of more
    than ``SCHED_CHUNK`` entries gives one item a chunk of ``SCHED_CHUNK``
    (its rounded chunk sums go to chunk slots, launch F adds them); a
    feature of at most ``K10_PACK`` entries that lies inside one window of
    ``K10_PACK`` entries of the order shares that window's item with the
    others there; every other feature is an item of its own.  So no item
    holds more than ``SCHED_CHUNK`` entries, none splits a chunk, and each
    side's valid entries lie in exactly one item.  A shard's items are
    sorted by the length of their longest feature, longest first (the
    card starts the longest chains first), then by position.  Returns
    (items, item_offs, multi, multi_offs)."""
    dev = bounds.device
    S = len(offs) - 1
    counts = torch.tensor([offs[s + 1] - offs[s] for s in range(S)],
                          dtype=torch.long, device=dev)
    U = int(offs[-1])
    shard = torch.repeat_interleave(torch.arange(S, device=dev), counts)
    u_loc = torch.arange(U, device=dev) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    g = torch.arange(U, device=dev) + shard
    b = bounds.long()
    st, en = b[g], b[g + 1]
    n = en - st
    win = st // K10_PACK
    inside = (n <= K10_PACK) & ((en - 1) // K10_PACK == win)
    big = n > SCHED_CHUNK
    # packed items: the runs of inside features of one shard and window
    same = lambda a, c: (a[1:] == a[:-1]) & (c[1:] == c[:-1])  # noqa: E731
    key_same = same(shard, win) & inside[1:] & inside[:-1]
    first = inside.clone()
    first[1:] &= ~key_same
    last = inside.clone()
    last[:-1] &= ~key_same
    pk = (shard[first], st[first], en[last], en[last] - st[first])
    # features of their own: neither inside a window nor over chunks
    own = ~inside & ~big
    ow = (shard[own], st[own], en[own], n[own])
    # chunks of the features over several
    nc = (n[big] + SCHED_CHUNK - 1) // SCHED_CHUNK
    shard_b = shard[big]
    q0 = torch.cumsum(nc, 0) - nc
    per = torch.zeros(S + 1, dtype=torch.long, device=dev)
    per.index_add_(0, shard_b + 1, nc)
    q0 = q0 - torch.cumsum(per, 0)[shard_b]   # slots count from 0 a shard
    rep = lambda t: torch.repeat_interleave(t, nc)  # noqa: E731
    c = torch.arange(int(nc.sum()), device=dev) - rep(torch.cumsum(nc, 0)
                                                      - nc)
    ce0 = rep(st[big]) + SCHED_CHUNK * c
    ce1 = torch.minimum(ce0 + SCHED_CHUNK, rep(en[big]))
    ck = (rep(shard_b), ce0, ce1, rep(n[big]))
    cq = rep(q0) + c
    cend = torch.where(c == 0, rep(en[big]), -1)
    sh_i, e0, e1, ln = (torch.cat(t) for t in zip(pk, ow, ck))
    neg = torch.full_like(pk[0], -1)
    q = torch.cat([neg, torch.full_like(ow[0], -1), cq])
    end = torch.cat([pk[2], ow[2], cend])
    M = N + 1
    key = (sh_i * M + (N - ln)) * M + e0
    perm = torch.argsort(key)
    items = torch.stack([e0, e1, q, end], 1)[perm].to(torch.int32)
    n_items = torch.bincount(sh_i, minlength=S)
    multi = torch.stack([u_loc[big], q0], 1).to(torch.int32)
    n_multi = torch.bincount(shard_b, minlength=S)
    cum = lambda t: (0,) + tuple(torch.cumsum(t, 0).tolist())  # noqa: E731
    return (items.contiguous(), cum(n_items), multi.contiguous(),
            cum(n_multi))


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


def ordered_add_(table: torch.Tensor, idx: torch.Tensor,
                 upd: torch.Tensor) -> torch.Tensor:
    """``table[idx[n]] += upd[n]`` one update at a time in the order given,
    each add rounded to the table's dtype, in place: what the JAX package's
    scatter-add of bf16 updates into a bf16 table does (a row's duplicates
    round once each, so increments below half a spacing leave it where it
    is).  The plain version of the bf16 kernels' ordered walks: one
    indexed add a rank among equal ids, on any device."""
    idx = idx.reshape(-1).long()
    upd = upd.reshape((idx.numel(),) + tuple(table.shape[1:]))
    if idx.numel() == 0:
        return table
    key, perm = torch.sort(idx, stable=True)
    ar = torch.arange(key.numel(), device=key.device)
    start = torch.ones_like(key, dtype=torch.bool)
    start[1:] = key[1:] != key[:-1]
    rank = ar - torch.cummax(torch.where(start, ar, 0), 0).values
    for k in range(int(rank.max()) + 1):
        p = perm[rank == k]
        rows = idx[p]
        table[rows] = (table[rows].float() + upd[p].float()).to(table.dtype)
    return table


#: occurrences of a feature a chunk of the JAX package's scheduled sums
#: takes (rsparse_tpu/ops/segsum.py build_stacked_col_schedule chunk_len)
SCHED_CHUNK = 128


def chunked_sums_bf16(vals: torch.Tensor, slot: torch.Tensor,
                      n_slots: int) -> torch.Tensor:
    """Per-slot sums of ``vals`` (N, w) as the JAX package's scheduled
    segment sums form them at bf16 (rsparse_tpu/ops/segsum.py :600, :551):
    a slot's entries in order, cut into chunks of ``SCHED_CHUNK``, each
    chunk summed at float32 and rounded to bf16, the chunks summed at
    float32 and rounded again.  Returns (n_slots, w) float32 holding bf16
    values."""
    slot = slot.long()
    n = slot.numel()
    key, perm = torch.sort(slot, stable=True)
    ar = torch.arange(n, device=slot.device)
    start = torch.ones_like(key, dtype=torch.bool)
    start[1:] = key[1:] != key[:-1]
    rank = ar - torch.cummax(torch.where(start, ar, 0), 0).values
    chunk = torch.zeros(n, dtype=torch.long, device=slot.device)
    chunk[perm] = rank // SCHED_CHUNK
    n_chunk = int(chunk.max()) + 1 if n else 1
    w = vals.shape[1]
    part = torch.zeros((n_slots * n_chunk, w), dtype=torch.float32,
                       device=vals.device)
    part.index_add_(0, slot * n_chunk + chunk, vals.float())
    part = part.to(torch.bfloat16).float().view(n_slots, n_chunk, w)
    return part.sum(1).to(torch.bfloat16).float()
