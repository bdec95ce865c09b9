"""ALX-style routed ALS sweep: an all-to-all factor exchange, then local
solves.

Port of ``rsparse_tpu/parallel/alx.py``.  The plain mesh path gathers the
whole source table to every rank before the bucket solves; here (the ALX
recipe, PAPERS.md "ALX: Large Scale Matrix Factorization on TPUs"):

- the source table is row-sharded over the mesh's data axis, rank ``o``
  owning rows ``[o * shard_rows, (o + 1) * shard_rows)``;
- a static routing plan (``routing.py``, built once at staging: the
  sparsity is fixed across ALS iterations) tells every owner which of its
  rows each peer needs, and each rank's bucket column ids are remapped to
  slots of its cache at staging;
- one exchange a half-sweep delivers the caches: the owner gathers the
  requested rows with K12 and ``all_to_all_single`` moves them;
- the Gram ``X'X`` (and rhs_init) is a per-owner partial sum plus an
  all-reduce, each rank runs its buckets' solves on the port's kernels
  (K1 CG, K2 Cholesky, K4 NNLS) reading the cache, and only the solved
  target rows leave the rank.

Enabled with ``WRMF(mesh=..., routing="alx" | "alx_ragged")``.  All three
solvers; per-entity biases and the dense zipf head stay on the plain path,
as in the JAX package.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import accum_dtype
from ..ops.als import (ALSConfig, _active_slices, _assemble_target,
                       _gather_solved, _gather_src, _solve_scatter,
                       _src_reg_loss, _sweep_prepare)
from ..sparse.device import BucketedRows, RowBucket
from .mesh import Axes, Mesh
from .routing import (RaggedRoutingPlan, RoutingPlan,
                      build_ragged_routing_plan, build_routing_plan,
                      exchange_body, owner_shard, ragged_exchange_body,
                      wire_cost_report, wire_cost_report_ragged)

#: the last exchanges of this process: {"ms": host wall, "bytes": sent to
#: other ranks, "ragged": bool, "cache_rows": rows in the cache, "wire":
#: ``wire_cost_report*`` of the plan, whose ``routed_total_bytes`` the
#: ranks' ``bytes`` sum to}
EXCHANGES: collections.deque = collections.deque(maxlen=256)


class ALXStage(NamedTuple):
    """Staged ALX state of one sweep orientation on this rank."""

    plan: Union[RoutingPlan, RaggedRoutingPlan]
    #: this rank's slice of every bucket, column ids remapped to its cache
    buckets: Tuple[RowBucket, ...]
    #: source rows with the divisibility padding
    n_src_padded: int
    #: rows of the bucketed matrix (the target table) and its columns (the
    #: source table), as ``BucketedRows`` has them
    n_rows: int
    n_cols: int
    #: mesh axis, or tuple of axes, the exchange and the batches ride on
    axis: Axes = "data"


def stage_alx(br: BucketedRows, n_src: int, mesh: Mesh, axis: Axes = "data",
              ragged: bool = False) -> ALXStage:
    """The routing plan and this rank's cache-remapped buckets.

    ``br``: every bucket whole (as ``bucket_rows`` builds them, on any
    device), each batch divisible by the axis size and split contiguously
    over it.  The returned buckets are this rank's slices on the mesh's
    device, with ``col_idx`` rewritten to slots of this rank's cache."""
    n_dev, me = mesh.axis_size(axis), mesh.axis_index(axis)
    n_src_p = -(-n_src // n_dev) * n_dev
    per_dev = [[] for _ in range(n_dev)]
    for b in br.buckets:
        if b.batch % n_dev:
            raise ValueError(f"bucket batch {b.batch} not divisible by "
                             f"{n_dev}")
        step = b.batch // n_dev
        ci = b.col_idx.cpu().numpy()
        for d in range(n_dev):
            per_dev[d].append(ci[d * step:(d + 1) * step])
    col_idx_per_device = [
        np.concatenate([a.ravel() for a in blocks]) if blocks
        else np.zeros((0,), np.int64) for blocks in per_dev]
    build = build_ragged_routing_plan if ragged else build_routing_plan
    plan, remapped = build(col_idx_per_device, n_src_p, n_dev)

    out, off = [], 0
    for bi, b in enumerate(br.buckets):
        step = b.batch // n_dev
        size = per_dev[me][bi].size
        ci = remapped[me][off:off + size].reshape(step, b.pad_len)
        off += size
        sl = slice(me * step, (me + 1) * step)
        out.append(RowBucket(
            row_ids=b.row_ids[sl].to(mesh.device),
            col_idx=torch.from_numpy(np.ascontiguousarray(ci, np.int32)).to(
                mesh.device),
            values=b.values[sl].to(mesh.device),
            nnz=b.nnz[sl].to(mesh.device)))
    return ALXStage(plan, tuple(out), n_src_p, br.n_rows, br.n_cols, axis)


def alx_sweep(
    mesh: Mesh,
    src: torch.Tensor,                 # (n_src, R) source factors, whole
    tgt_old: torch.Tensor,             # (n_tgt, R)
    stage: ALXStage,
    src_cnt: Optional[torch.Tensor],
    lam,
    g,
    cfg: ALSConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One routed ALS half-sweep: the same result as ``ops.als.wrmf_sweep``
    on the whole buckets, up to the order of the partial sums.  One
    exchange a half-sweep (the plan covers every bucket), then each bucket
    of this rank solves on the cache; every rank returns the whole new
    target table and loss."""
    if cfg.with_biases:
        raise NotImplementedError("routing='alx' supports the no-per-entity"
                                  "-bias configurations")
    group = mesh.group(stage.axis)
    n_tgt, R = tgt_old.shape
    sdt = accum_dtype(src.dtype)
    src_act, _, XtX, rhs_init = _sweep_prepare(src, lam, g, cfg, sdt, group)
    d = src_act.shape[1]

    t0 = time.perf_counter()
    shard = owner_shard(src_act, group.rank, stage.plan.shard_rows)
    ragged = isinstance(stage.plan, RaggedRoutingPlan)
    if ragged:
        cache, sent = ragged_exchange_body(group, shard, stage.plan, d)
    else:
        req = torch.from_numpy(stage.plan.request_ids[group.rank]).to(
            src.device)
        cache, sent = exchange_body(group, shard, req,
                                    stage.plan.cache_size // group.size, d)
    if cache.is_cuda:
        torch.cuda.synchronize(cache.device)
    ms = (time.perf_counter() - t0) * 1e3
    report = wire_cost_report_ragged if ragged else wire_cost_report
    EXCHANGES.append({"ms": ms, "bytes": sent, "ragged": ragged,
                      "cache_rows": cache.shape[0],
                      "wire": report(stage.plan, group.size, d,
                                     src_act.element_size())})

    cache = _gather_src(cache, cfg, sdt)
    old_act = tgt_old[:, _active_slices(cfg, R)[1]]
    result = torch.zeros((n_tgt + 1, d), dtype=src.dtype, device=src.device)
    loss = torch.zeros((), dtype=sdt, device=src.device)
    for b in stage.buckets:
        loss = loss + _solve_scatter(result, cache, None, XtX, rhs_init, b,
                                     old_act, lam, g, n_tgt, cfg)
    loss = group.all_reduce(loss)
    result = _gather_solved(result, stage.buckets, group)
    tgt_new = _assemble_target(result[:n_tgt], cfg)
    return tgt_new, loss + _src_reg_loss(src, src_cnt, lam, cfg, sdt, group)
