"""Multi-process bring-up and per-process bucket building.

Port of ``rsparse_tpu/parallel/multihost.py`` onto ``torch.distributed``.
In PyTorch every mesh spans processes already (:mod:`.mesh`), so what is
left of the JAX module is:

- :func:`initialize`: ``init_process_group`` from arguments (a ``file://``
  or ``tcp://`` store, in the port's keywords or the reference's) or from
  the ``torchrun`` environment;
- :func:`make_multihost_mesh`: a ``("dcn", "ici")`` mesh, ``dcn`` the
  nodes and ``ici`` the ranks within a node, process-major, so that a
  batch axis split over both gives each node a contiguous block of rows;
- :func:`distributed_bucket_rows`: every rank buckets only its own
  contiguous row range; the bucket shapes are negotiated with small
  all-gathers so that every rank builds blocks of the same shapes, padded
  with sentinel rows where its range has fewer members.

The model integration is ``WRMF(mesh=make_multihost_mesh())``; every rank
calls the same code in the same order.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..config import np_dtype
from ..native import fill_bucket
from ..sparse.device import (BucketedRows, RowBucket, _fill_bucket_numpy,
                             _length_grid, _round_up)
from .mesh import AxisGroup, Mesh, _local_rank, make_mesh

#: axis names of the hierarchical mesh: ``dcn`` crosses nodes, ``ici`` the
#: ranks within a node.  Batch axes split over the tuple.
DATA_AXES: Tuple[str, str] = ("dcn", "ici")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device_type: Optional[str] = None,
               timeout_s: Optional[float] = None, *,
               coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_count: Optional[int] = None) -> None:
    """Bring up the default process group for this process, unless it is
    up.  Without arguments it reads ``torchrun``'s environment
    (``env://``).  The group carries gloo for CPU tensors, and NCCL for
    CUDA tensors when the process sees a card and ``device_type`` is not
    "cpu"; :func:`.mesh.make_mesh` picks which one its collectives use.

    The reference's keywords (``rsparse_tpu/parallel/multihost.py``
    ``initialize``) are taken too, so a caller written for it runs
    unchanged: ``coordinator_address`` is the store, ``num_processes`` the
    world size and ``process_id`` the rank.  A store without a scheme
    (``host:port``, in either spelling) is read as ``tcp://host:port``;
    one with a scheme passes through.  ``local_device_count`` is
    accepted and ignored: the port runs one rank a device, so a process
    never holds more than one (with ``device_type="cpu"`` it must be 1).
    Giving one quantity in both spellings raises ``TypeError``."""
    for port_name, port_v, ref_name, ref_v in (
            ("init_method", init_method, "coordinator_address",
             coordinator_address),
            ("world_size", world_size, "num_processes", num_processes),
            ("rank", rank, "process_id", process_id)):
        if port_v is not None and ref_v is not None:
            raise TypeError(f"initialize() got both {port_name}= and "
                            f"{ref_name}= (the same quantity)")
    init_method = init_method if init_method is not None \
        else coordinator_address
    world_size = world_size if world_size is not None else num_processes
    rank = rank if rank is not None else process_id
    if (local_device_count is not None and device_type == "cpu"
            and int(local_device_count) != 1):
        raise ValueError(f"local_device_count={local_device_count}: the "
                         "port runs one rank a device (1 on the CPU)")
    if dist.is_initialized():
        return
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    backend = ("gloo" if device_type == "cpu" or not torch.cuda.is_available()
               else "cpu:gloo,cuda:nccl")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank), **kw)


def make_multihost_mesh(axis_names: Tuple[str, str] = DATA_AXES,
                        device_type: Optional[str] = None) -> Mesh:
    """A ``(nodes, ranks per node)`` mesh over every rank, process-major
    (rank ``r`` at ``(r // per_node, r % per_node)``, torchrun's order)."""
    initialize(device_type=device_type)
    _, n_local = _local_rank()
    world = dist.get_world_size()
    if world % n_local:
        raise ValueError(f"{world} ranks do not split into nodes of "
                         f"{n_local}")
    return make_mesh((world // n_local, n_local), axis_names, device_type)


def is_multihost(mesh: Optional[Mesh]) -> bool:
    """True for any ``("dcn", "ici")``-style mesh, a one-process one
    included."""
    return mesh is not None and DATA_AXES[0] in mesh.axis_names


def data_spec(mesh: Mesh):
    """The axes a batch axis is split over: ``("dcn", "ici")`` on a
    multihost mesh, ``"data"`` otherwise."""
    if DATA_AXES[0] in mesh.axis_names:
        return DATA_AXES
    return "data"


def replicate(arr, mesh: Mesh) -> torch.Tensor:
    """This rank's whole copy of ``arr`` on the mesh's device (every rank
    must pass the same values)."""
    return torch.as_tensor(np.asarray(arr)).to(mesh.device)


def process_row_range(n_rows: int, n_proc: Optional[int] = None,
                      pid: Optional[int] = None) -> Tuple[int, int]:
    """This process's contiguous row range ``[lo, hi)`` of a global row
    axis: ``ceil(n_rows / n_proc)`` rows per process, the last one short."""
    up = dist.is_initialized()
    n_proc = (dist.get_world_size() if up else 1) if n_proc is None else n_proc
    pid = (dist.get_rank() if up else 0) if pid is None else pid
    per = -(-n_rows // n_proc)
    lo = min(pid * per, n_rows)
    return lo, min(lo + per, n_rows)


def _allgather(x: np.ndarray, group: AxisGroup) -> np.ndarray:
    """(members, *x.shape): every member's ``x`` (int64)."""
    t = torch.as_tensor(np.asarray(x, np.int64).reshape(1, -1))
    return group.all_gather(t).cpu().numpy().reshape(
        (group.size,) + np.shape(x))


def _allgather_max(x: np.ndarray, group: AxisGroup) -> np.ndarray:
    """Element-wise max of a small int array across the group's members."""
    return _allgather(x, group).max(axis=0)


def distributed_bucket_rows(
    local_csr: sp.spmatrix,
    row_offset: int,
    n_rows: int,
    n_cols: int,
    mesh: Mesh,
    dtype=torch.float32,
    *,
    min_len: int = 8,
    max_buckets: int = 24,
    length_ratio: float = 1.25,
    include_empty: bool = False,
    max_elems: Optional[int] = 1 << 22,
) -> BucketedRows:
    """This rank's buckets of its own contiguous row range.

    Each rank passes only its rows (``local_csr``, global rows
    ``[row_offset, row_offset + local_csr.shape[0])``).  The length grid
    and each length's padded batch come from all-gathers over the mesh's
    data axes (a scalar max, then the per-length populations), so every
    rank builds blocks of the same shapes, padded with sentinel rows
    (``row_id == n_rows``); ``nnz`` and ``empty_rows`` are the global ones.
    The returned buckets hold global row ids and sit on the mesh's device.
    """
    group = mesh.group(data_spec(mesh))
    csr = sp.csr_matrix(local_csr)
    csr.sort_indices()
    n_local_rows = csr.shape[0]
    row_align = 8     # one device a rank (rsparse_tpu: 8 * local devices)

    row_nnz = np.diff(csr.indptr).astype(np.int64)
    if include_empty:
        active = np.arange(n_local_rows, dtype=np.int64)
    else:
        active = np.flatnonzero(row_nnz > 0).astype(np.int64)
    act_nnz = (np.maximum(row_nnz[active], 1) if active.size
               else np.zeros((0,), np.int64))

    # a common length grid (one scalar all-gather)
    local_max = int(act_nnz.max()) if active.size else min_len
    global_max = int(_allgather_max(np.asarray([local_max]), group)[0])
    grid = _length_grid(min_len, global_max, length_ratio)
    lengths = (grid[np.searchsorted(grid, act_nnz)] if active.size
               else np.zeros((0,), np.int64))

    # merge sparsely populated lengths the same way on every rank
    local_counts = np.asarray([(lengths == L).sum() for L in grid], np.int64)
    gcounts = _allgather(local_counts, group).sum(axis=0)
    live = [i for i in range(len(grid)) if gcounts[i] > 0]
    while len(live) > max_buckets:
        k = int(np.argmin([gcounts[i] for i in live[:-1]]))
        src_i, dst_i = live[k], live[k + 1]
        lengths[lengths == grid[src_i]] = grid[dst_i]
        gcounts[dst_i] += gcounts[src_i]
        gcounts[src_i] = 0
        live.pop(k)

    # per length: the same padded batch on every rank
    per_len_local = np.asarray([(lengths == grid[i]).sum() for i in live],
                               np.int64)
    per_len_max = _allgather_max(per_len_local, group)
    val_dtype = np_dtype(dtype)
    # the local sentinel n_rows - row_offset lands on the global n_rows
    # after the uniform + row_offset shift
    sentinel = n_rows - row_offset
    buckets = []
    for i, li in enumerate(live):
        L = int(grid[li])
        rows_all = active[lengths == grid[li]]
        B_target = int(per_len_max[i])          # most members on any rank
        if max_elems is not None:
            chunk_rows = max(_round_up(max(max_elems // L, 1), row_align),
                             row_align)
        else:
            chunk_rows = max(_round_up(B_target, row_align), row_align)
        for c in range(max(-(-B_target // chunk_rows), 1)):
            s = c * chunk_rows
            want = min(chunk_rows, B_target - s) if B_target > s else 0
            B = _round_up(max(want, 1), row_align)
            rows = rows_all[s:s + want]
            filled = None
            if csr.nnz:
                filled = fill_bucket(csr.indptr, csr.indices, csr.data, rows,
                                     B, L, sentinel, val_dtype)
            if filled is None:
                filled = _fill_bucket_numpy(csr, row_nnz, rows, B, L,
                                            sentinel, val_dtype)
            col_idx, values, nnz_arr, row_ids = filled
            row_ids = row_ids.astype(np.int32) + np.int32(row_offset)
            buckets.append(RowBucket(
                row_ids=torch.from_numpy(row_ids).to(mesh.device),
                col_idx=torch.from_numpy(col_idx).to(mesh.device),
                values=torch.from_numpy(values).to(mesh.device, dtype),
                nnz=torch.from_numpy(nnz_arr).to(mesh.device)))

    gnnz = int(_allgather(np.asarray([csr.nnz]), group).sum())
    # the global empty-row list, through a padded all-gather
    empty_local = (np.flatnonzero(row_nnz == 0) + row_offset).astype(np.int64)
    cnts = _allgather(np.asarray([len(empty_local)]), group).reshape(-1)
    cap = int(cnts.max()) if cnts.size else 0
    if cap:
        padded = np.full((cap,), -1, np.int64)
        padded[:len(empty_local)] = empty_local
        allp = _allgather(padded, group).reshape(-1, cap)
        empty = np.sort(np.concatenate(
            [allp[p, :int(cnts[p])] for p in range(allp.shape[0])]))
    else:
        empty = empty_local
    return BucketedRows(tuple(buckets), n_rows, n_cols, gnnz,
                        empty.astype(np.int32))
