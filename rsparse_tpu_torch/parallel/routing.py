"""ALX-style all-to-all factor routing.

Port of ``rsparse_tpu/parallel/routing.py``.  Gathering the source factors
from a row-sharded table by an all-gather moves the whole table to every
rank; each rank's buckets reference only a subset of its rows.  The ALX
recipe ("ALX: Large Scale Matrix Factorization on TPUs", PAPERS.md) routes
only the referenced rows: every rank asks each owner for the rows its
buckets touch, the owner gathers them from its shard (K12,
``ops/gather.py`` ``gather_rows``), and one all-to-all delivers each rank
its factor cache; the buckets' column ids were remapped to cache slots
ahead of time (the sparsity is fixed across ALS iterations, so the plan is
built once on the host, with numpy, as the same arrays as the JAX
package's).

Two exchanges: :func:`exchange_body` pads every (rank, owner) request list
to the global maximum ``m`` (one ``all_to_all_single`` of requests, one of
rows); :func:`ragged_exchange_body` moves exactly the requested rows with
one ``all_to_all_single`` whose split sizes come from the plan (native in
``torch.distributed``; the JAX package emulates it off the TPU).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.gather import gather_rows
from .mesh import AxisGroup


class RoutingPlan(NamedTuple):
    """Static all-to-all routing plan for one bucket set.

    request_ids: (n_dev, n_dev, m) int32 numpy; ``request_ids[d, o]`` are
      the rows rank ``d`` wants from owner ``o``, as owner-local row
      indices (padded with 0; padding slots are never referenced).
    cache_size: rows a rank's cache holds (``n_dev * m``).
    shard_rows: source rows each owner holds.
    """

    request_ids: np.ndarray
    cache_size: int
    shard_rows: int


def _check_split(n_src: int, n_dev: int) -> int:
    if n_src % n_dev:
        raise ValueError(
            "n_dev must divide n_src for contiguous sharding "
            f"(got n_src={n_src}, n_dev={n_dev}); pad the source table")
    return n_src // n_dev


def build_routing_plan(
    col_idx_per_device: Sequence[np.ndarray],
    n_src: int,
    n_dev: int,
) -> Tuple[RoutingPlan, list]:
    """The static plan and each rank's column ids remapped to cache slots.

    ``col_idx_per_device[d]`` holds the (any-shape) global column ids rank
    ``d`` references.  The source table is row-sharded contiguously:
    owner(i) = i // shard_rows."""
    shard_rows = _check_split(n_src, n_dev)
    needed = []   # per rank: per owner sorted unique local ids
    m = 1
    for d in range(n_dev):
        ids = np.unique(np.asarray(col_idx_per_device[d]).ravel())
        per_owner = []
        for o in range(n_dev):
            lo, hi = o * shard_rows, (o + 1) * shard_rows
            local = ids[(ids >= lo) & (ids < hi)] - lo
            per_owner.append(local)
            m = max(m, len(local))
        needed.append(per_owner)

    request_ids = np.zeros((n_dev, n_dev, m), np.int32)
    remapped = []
    for d in range(n_dev):
        lut = np.zeros(n_src, np.int32)
        for o in range(n_dev):
            local = needed[d][o]
            request_ids[d, o, :len(local)] = local
            lut[o * shard_rows + local] = (
                o * m + np.arange(len(local), dtype=np.int32))
        remapped.append(lut[np.asarray(col_idx_per_device[d])])
    return RoutingPlan(request_ids, n_dev * m, shard_rows), remapped


def _gathered(shard: torch.Tensor, idx: torch.Tensor, d: int
              ) -> torch.Tensor:
    """K12's gather of ``shard``'s rows ``idx``, cut to the first ``d``
    columns (the shard's width may be padded for K12's alignment)."""
    rows = gather_rows(shard, idx)
    return rows if rows.shape[1] == d else rows[:, :d].contiguous()


def exchange_body(group: AxisGroup, shard: torch.Tensor,
                  requests: torch.Tensor, m: int, d: int
                  ) -> Tuple[torch.Tensor, int]:
    """One rank's side of the padded routed exchange.

    ``shard``: this owner's rows (:func:`owner_shard`), ``d`` columns of
    them real; ``requests``: (n_dev, m) int32, what this rank wants from
    each owner.  An all-to-all of the requests tells every owner what to
    gather, K12 gathers it, and a second all-to-all delivers the caches.
    Returns (this rank's (n_dev * m, d) cache, the bytes it sent to other
    ranks)."""
    want = group.all_to_all(requests.reshape(-1).contiguous())
    cache = group.all_to_all(_gathered(shard, want.contiguous(), d))
    sent = (group.size - 1) * m * (4 + d * shard.element_size())
    return cache, sent


def routed_factor_exchange(group: AxisGroup, src: torch.Tensor,
                           plan: RoutingPlan) -> torch.Tensor:
    """This rank's factor cache from a ``(n_src, r)`` source table that
    every rank holds whole (the owner shard is its own rows of it); index
    it with the remapped column ids of :func:`build_routing_plan`."""
    m = plan.cache_size // group.size
    shard = owner_shard(src, group.rank, plan.shard_rows)
    req = torch.from_numpy(plan.request_ids[group.rank]).to(src.device)
    return exchange_body(group, shard, req, m, src.shape[1])[0]


def owner_shard(src: torch.Tensor, owner: int, shard_rows: int
                ) -> torch.Tensor:
    """Rows ``[owner * shard_rows, (owner + 1) * shard_rows)`` of ``src``
    (zero past its end) in a fresh table whose rows K12 can read (16-byte
    aligned: the width padded with zero columns where needed)."""
    d = src.shape[1]
    per = max(16 // src.element_size(), 1)
    width = -(-d // per) * per
    out = src.new_zeros((shard_rows, width))
    lo = owner * shard_rows
    rows = src[lo:lo + shard_rows]
    out[:rows.shape[0], :d] = rows
    return out


def wire_cost_report(plan: RoutingPlan, n_dev: int, rank: int,
                     itemsize: int = 4) -> dict:
    """Analytic off-rank wire bytes of one routed factor exchange against
    the plain path's all-gather of the whole row-sharded source table
    (each rank's own block stays local), summed over the ranks:

    - ``request_bytes``: the int32 request all-to-all,
      ``n_dev * (n_dev - 1) * m * 4``;
    - ``cache_bytes``: the factor-row all-to-all,
      ``n_dev * (n_dev - 1) * m * rank * itemsize``;
    - ``allgather_bytes``: the plain path,
      ``n_dev * (n_dev - 1) * shard_rows * rank * itemsize``.

    ``m = cache_size / n_dev`` is the most unique rows one (rank, owner)
    pair references, the all-to-all's padding."""
    m = plan.cache_size // n_dev
    off = n_dev * (n_dev - 1)
    request_bytes = off * m * 4
    cache_bytes = off * m * rank * itemsize
    allgather_bytes = off * plan.shard_rows * rank * itemsize
    return {
        "n_dev": n_dev,
        "m": m,
        "shard_rows": plan.shard_rows,
        "request_bytes": request_bytes,
        "cache_bytes": cache_bytes,
        "routed_total_bytes": request_bytes + cache_bytes,
        "allgather_bytes": allgather_bytes,
        "routed_over_allgather": (request_bytes + cache_bytes)
        / max(allgather_bytes, 1),
    }


class RaggedRoutingPlan(NamedTuple):
    """Static ragged all-to-all routing plan (no per-pair padding), numpy.

    Per rank ``d`` (as the JAX package's arrays):

    - ``want[d]``: (S_send_max,) owner-local row ids this rank, as owner,
      gathers, concatenated by requester (padding 0);
    - ``in_off[d][j]`` / ``send_sz[d][j]``: the slice of ``want[d]``'s rows
      bound for requester ``j``;
    - ``out_off[d][j]``: where owner ``d``'s chunk lands in requester
      ``j``'s cache (caches are concatenated by owner);
    - ``recv_sz[d][j]``: rows rank ``d`` receives from owner ``j``.

    ``cache_size`` is the most rows any rank requests in all.
    """

    want: np.ndarray
    in_off: np.ndarray
    send_sz: np.ndarray
    out_off: np.ndarray
    recv_sz: np.ndarray
    cache_size: int
    shard_rows: int


def build_ragged_routing_plan(
    col_idx_per_device: Sequence[np.ndarray],
    n_src: int,
    n_dev: int,
) -> Tuple[RaggedRoutingPlan, list]:
    """The ragged plan and the cache-remapped column ids (the same contract
    as :func:`build_routing_plan`)."""
    shard_rows = _check_split(n_src, n_dev)
    needed = []
    for d in range(n_dev):
        ids = np.unique(np.asarray(col_idx_per_device[d]).ravel())
        needed.append([ids[(ids >= o * shard_rows)
                           & (ids < (o + 1) * shard_rows)] - o * shard_rows
                       for o in range(n_dev)])
    n = np.array([[len(needed[d][o]) for o in range(n_dev)]
                  for d in range(n_dev)], np.int64)   # n[requester, owner]

    s_send = max(int(n.sum(axis=0).max()) if n_dev else 1, 1)
    cache_size = max(int(n.sum(axis=1).max()) if n_dev else 1, 1)
    want = np.zeros((n_dev, s_send), np.int32)
    in_off = np.zeros((n_dev, n_dev), np.int32)
    send_sz = np.zeros((n_dev, n_dev), np.int32)
    out_off = np.zeros((n_dev, n_dev), np.int32)
    recv_sz = np.zeros((n_dev, n_dev), np.int32)
    cache_off = np.zeros((n_dev, n_dev), np.int64)
    for d in range(n_dev):
        cache_off[d] = np.concatenate([[0], np.cumsum(n[d])[:-1]])

    remapped = []
    for d in range(n_dev):
        pos = 0
        for j in range(n_dev):       # as owner: slices by requester
            ids = needed[j][d]
            in_off[d, j] = pos
            send_sz[d, j] = len(ids)
            want[d, pos:pos + len(ids)] = ids
            pos += len(ids)
            out_off[d, j] = cache_off[j, d]
        recv_sz[d] = n[d]            # as requester: sizes from each owner
        lut = np.zeros(n_src, np.int32)
        for o in range(n_dev):
            ids = needed[d][o]
            lut[o * shard_rows + ids] = (
                cache_off[d, o] + np.arange(len(ids), dtype=np.int64)
            ).astype(np.int32)
        remapped.append(lut[np.asarray(col_idx_per_device[d])])
    plan = RaggedRoutingPlan(want, in_off, send_sz, out_off, recv_sz,
                             cache_size, shard_rows)
    return plan, remapped


def ragged_exchange_body(group: AxisGroup, shard: torch.Tensor,
                         plan: RaggedRoutingPlan, d: int
                         ) -> Tuple[torch.Tensor, int]:
    """One rank's side of the ragged routed exchange: K12 gathers the rows
    this owner sends, in requester order, and one ``all_to_all_single``
    with the plan's split sizes delivers every cache, exactly the
    requested rows on the wire.  Returns (this rank's (cache_size, d)
    cache, rows past what arrived are zero; the bytes it sent to other
    ranks)."""
    me = group.rank
    send = plan.send_sz[me].astype(np.int64)
    recv = plan.recv_sz[me].astype(np.int64)
    want = torch.from_numpy(
        np.ascontiguousarray(plan.want[me, :int(send.sum())])).to(
            shard.device)
    got = group.all_to_all(_gathered(shard, want, d), recv.tolist(),
                           send.tolist())
    cache = shard.new_zeros((plan.cache_size, d))
    cache[:got.shape[0]] = got
    sent = int(send.sum() - send[me]) * d * shard.element_size()
    return cache, sent


def ragged_factor_exchange(group: AxisGroup, src: torch.Tensor,
                           plan: RaggedRoutingPlan) -> torch.Tensor:
    """This rank's ragged factor cache from a source table every rank holds
    whole; index it with the remapped column ids of
    :func:`build_ragged_routing_plan`."""
    shard = owner_shard(src, group.rank, plan.shard_rows)
    return ragged_exchange_body(group, shard, plan, src.shape[1])[0]


def wire_cost_report_ragged(plan: RaggedRoutingPlan, n_dev: int,
                            rank: int, itemsize: int = 4) -> dict:
    """Analytic off-rank wire bytes of the ragged exchange: exactly the
    requested rows, less each rank's own chunk."""
    n = np.asarray(plan.recv_sz, np.int64)
    off_device = int(n.sum() - np.trace(n))
    cache_bytes = off_device * rank * itemsize
    return {
        "n_dev": n_dev,
        "rows_on_wire": off_device,
        "cache_bytes": cache_bytes,
        "routed_total_bytes": cache_bytes,   # requests are static (staged)
        "allgather_bytes": n_dev * (n_dev - 1) * plan.shard_rows
        * rank * itemsize,
    }
