"""Process meshes, this rank's slices, and the collectives of the layer.

Port of ``rsparse_tpu/parallel/mesh.py`` onto ``torch.distributed``.  A JAX
mesh is one process driving many devices; here every mesh spans processes,
one rank a device, and each rank calls the same code with the same inputs
(the multi-controller discipline of ``rsparse_tpu/parallel/multihost.py``).
The axes keep their meaning:

- ``data``: the target entities (users or items being solved) are split
  across ranks; each rank solves its slice of every bucket's batch.
- ``model``: factor tables are row-sharded between half-sweeps and
  all-gathered over the model group before one, as XLA's partitioner does
  for ``P("model")`` tables.  Grams, rhs terms and losses are per-rank
  partial sums all-reduced over the data group.

One layout differs on purpose: the dense zipf head is replicated over
``model`` (each data rank holds its rows' whole head), where the JAX
package shards its columns and psums the head terms inside the CG loop.
K1 fuses those terms into its CG iterations, and no collective can run
inside a kernel.

Device and backend are chosen once per mesh, from what the process sees,
and printed: NCCL on ``cuda:<local rank>`` when every rank of the node has
a card of its own; gloo on ``cuda:0`` when the ranks share one card (NCCL
refuses two ranks on one device), with send and receive buffers copied
through the host; gloo on the CPU when the caller passes
``device_type="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..sparse.device import BucketedRows, HotBlock

Axes = Union[str, Tuple[str, ...]]


class AxisGroup:
    """The process group of one mesh axis (or of the whole mesh) with the
    collectives the layer uses.  ``rank`` and ``size`` are this process's
    index and the member count within the group; with ``host`` every
    buffer travels through host memory (gloo with CUDA tensors)."""

    def __init__(self, group, ranks: Sequence[int], host: bool,
                 device: torch.device):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.host = host
        #: where this group's collectives read and write their buffers
        self.comm_device = torch.device("cpu") if host else device

    def _buf(self, t: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of ``t`` on the collective's device."""
        return t.detach().to(self.comm_device, copy=True).contiguous()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, as a new tensor on ``t``'s
        device."""
        buf = self._buf(t)
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every member's ``t`` (the same shape on each), concatenated along
        dim 0 in group order, on ``t``'s device."""
        buf = self._buf(t)
        outs = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(outs, buf, group=self.group)
        return torch.cat(outs).to(t.device)

    def all_to_all(self, t: torch.Tensor,
                   out_splits: Optional[Sequence[int]] = None,
                   in_splits: Optional[Sequence[int]] = None
                   ) -> torch.Tensor:
        """One ``all_to_all_single`` along dim 0: even splits without
        sizes, else ``in_splits[j]`` rows of ``t`` go to member ``j`` and
        ``out_splits[j]`` rows arrive from it, concatenated in group
        order."""
        buf = self._buf(t)
        n = buf.shape[0] if out_splits is None else int(sum(out_splits))
        out = buf.new_empty((n,) + tuple(buf.shape[1:]))
        dist.all_to_all_single(
            out, buf, None if out_splits is None else list(out_splits),
            None if in_splits is None else list(in_splits), group=self.group)
        return out.to(t.device)

    def barrier(self) -> None:
        """Wait for every member (a one-element all-reduce, on the same
        backend as the group's other collectives)."""
        self.all_reduce(torch.zeros(1, device=self.comm_device))


@dataclasses.dataclass
class Mesh:
    """A named process mesh (:func:`make_mesh`).  ``shape`` maps each axis
    name to its size (as ``jax.sharding.Mesh.shape`` does), ``coords`` to
    this rank's index on it; ``device`` is where this rank's tensors live
    and ``backend`` ("nccl" or "gloo") carries the collectives."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    backend: str
    groups: Dict[str, AxisGroup]
    world: AxisGroup
    device_mesh: object = None

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise KeyError(f"mesh has no axis {a!r} ({self.axis_names})")
        return axes

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index over ``axes`` flattened in order (the first
        axis major)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes) -> AxisGroup:
        """The group of one axis, or of all the mesh's axes (a tuple naming
        every axis in order)."""
        axes = self._axes(axes)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if axes == self.axis_names:
            return self.world
        raise NotImplementedError(
            f"a group over the axes {axes} of a {self.axis_names} mesh")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device}, {self.backend})")


def _local_rank() -> Tuple[int, int]:
    """(this rank's index on its node, ranks on the node), from torchrun's
    environment, else all ranks on one node."""
    return (int(os.environ.get("LOCAL_RANK", dist.get_rank())),
            int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size())))


def pick_device(device_type: Optional[str] = None
                ) -> Tuple[torch.device, str, str]:
    """(device, backend, why) for this rank: the rule in the module
    docstring.  The default process group must already be up."""
    if device_type == "cpu":
        return torch.device("cpu"), "gloo", "device_type='cpu'"
    if device_type not in (None, "cuda"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device_type='cpu' for a "
                           "CPU mesh")
    local, n_local = _local_rank()
    cards = torch.cuda.device_count()
    has_nccl = "nccl" in str(dist.get_backend()).lower()
    if cards >= n_local and has_nccl:
        return (torch.device("cuda", local), "nccl",
                f"{n_local} rank(s) on this node, {cards} card(s): one each")
    if cards >= n_local:
        return (torch.device("cuda", local), "gloo",
                f"a card each, but the process group has no NCCL backend "
                f"({dist.get_backend()})")
    if cards == 1:
        return (torch.device("cuda", 0), "gloo",
                f"{n_local} ranks share one card (NCCL refuses two ranks on "
                "one device): buffers go through the host")
    raise ValueError(f"{n_local} ranks on this node and {cards} cards: "
                     "give each rank a card of its own, or run them all on "
                     "one")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data",),
              device_type: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` over all ranks, its axes named ``axis_names``
    (default: a 1-D ``data`` mesh).  Brings the process group up from the
    ``torchrun`` environment if nobody did (:func:`.multihost.initialize`
    takes explicit arguments).  Every rank must call it, in the same order
    as its other collectives."""
    from torch.distributed.device_mesh import init_device_mesh

    from .multihost import initialize
    initialize(device_type=device_type)
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axis names {axis_names} differ "
                         "in length")
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                         f"{math.prod(shape)} ranks, the process group has "
                         f"{world}")
    device, backend, why = pick_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    host = backend == "gloo" and device.type == "cuda"
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=axis_names)
    groups = {}
    for name in axis_names:
        g = dm.get_group(name)
        groups[name] = AxisGroup(g, dist.get_process_group_ranks(g), host,
                                 device)
    wg = dist.group.WORLD
    mesh = Mesh(axis_names, dict(zip(axis_names, shape)),
                dict(zip(axis_names, dm.get_coordinate())), device, backend,
                groups, AxisGroup(wg, range(world), host, device), dm)
    print(f"[rsparse_tpu_torch] {mesh}: {why}", file=sys.stderr, flush=True)
    return mesh


def data_sharding(mesh: Mesh, x, axis: Axes = "data") -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s leading axis, split over
    ``axis``, on the mesh's device (``NamedSharding(mesh, P(axis))``)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    t = torch.as_tensor(x)
    if t.shape[0] % n:
        raise ValueError(f"leading axis {t.shape[0]} not divisible by mesh "
                         f"axis {n}")
    per = t.shape[0] // n
    return t[i * per:(i + 1) * per].to(mesh.device)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """``x`` whole on this rank's device (``NamedSharding(mesh, P())``)."""
    return torch.as_tensor(x).to(mesh.device)


def shard_hot(hot: Optional[HotBlock], mesh: Mesh,
              model_axis: str = "model") -> Optional[HotBlock]:
    """Place a dense zipf-head block on the mesh: replicated over
    ``model`` (the module docstring says why), so each data rank gathers
    its buckets' rows from the whole block."""
    if hot is None:
        return None
    return HotBlock(*(None if t is None else t.to(mesh.device) for t in hot))


def shard_buckets(br: BucketedRows, mesh: Mesh,
                  axis: Axes = "data") -> BucketedRows:
    """Keep this rank's slice of every bucket's batch axis, split over
    ``axis``, on the mesh's device.  Bucket batches must be divisible by
    the axis size: pass ``row_align=lcm(8, n)`` to ``bucket_rows``."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    out = []
    for b in br.buckets:
        if b.batch % n:
            raise ValueError(
                f"bucket batch {b.batch} not divisible by mesh axis {n}; "
                f"build buckets with row_align divisible by {n}")
        step = b.batch // n
        out.append(type(b)(*(t[i * step:(i + 1) * step].to(mesh.device)
                             for t in b)))
    return dataclasses.replace(br, buckets=tuple(out))
