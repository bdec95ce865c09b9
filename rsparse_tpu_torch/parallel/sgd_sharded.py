"""Row-sharded state tables for the SGD family (FTRL, FM, RankMF, GloVe).

Port of ``rsparse_tpu/parallel/sgd_sharded.py`` onto ``torch.distributed``:
**replicated batch, sharded tables.**  Every state table (embeddings,
biases, AdaGrad accumulators, FTRL's (z, n)) is row-sharded over the mesh's
table axes, global row ``g`` on the rank at index ``g // per`` of those
axes (``per`` = the local row count), so a table's memory is 1/n a rank.
Every rank runs the whole minibatch's update, on the same batch.

A step gathers what it touches and runs the model's kernel unchanged:

1. the rows a block, batch, shard or head pass reads are known before it
   runs (a GLM block's ``feats``, a GloVe shard's slot maps, the head's
   ids, the rows RankMF's bits reach);
2. :meth:`ShardedOps.gather_many` gathers those rows of every state table:
   each rank reads its own rows, zeros elsewhere, and ONE all-reduce of
   the whole tuple makes the compact tables on every rank (the reference's
   single ``psum``; a batch-sized buffer, never a table-sized one);
3. the kernel runs on the compact tables, its inputs relabelled to
   compact rows (K9 reads through a row map instead, see
   ``models/rankmf.py``);
4. :meth:`ShardedOps.put` writes back the rows this rank owns.

The all-reduce sums the tables' bit patterns as integers (one rank adds a
row's bits, the others zeros), so a gathered row is the owner's row bit
for bit, signed zeros and all: the kernel adds the same floats in the same
order as in one process, and a mesh fit of K7, K8, K10 and K11 equals the
one-process fit bitwise.

:class:`DirectOps` is the one-device twin of :class:`ShardedOps`.  The
ops update tables in place (the port's idiom) and return them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .mesh import Mesh

Axes = Union[str, Tuple[str, ...]]

#: the integer type each float width's bits are summed as (2-byte tables,
#: bf16 state, as bytes: NCCL has no 16-bit integer)
_BITS = {1: torch.uint8, 2: torch.uint8, 4: torch.int32, 8: torch.int64}


def _rows_like(upd: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return upd.reshape((-1,) + tuple(table.shape[1:]))


class DirectOps:
    """Single-device table ops: plain gather / scatter-add / put."""

    is_sharded = False

    def gather(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return table[ids.long()]

    def gather_many(self, pairs) -> Tuple[torch.Tensor, ...]:
        return tuple(t[i.long()] for t, i in pairs)

    def scatter_add(self, table, ids, upd) -> torch.Tensor:
        return table.index_add_(0, ids.long().reshape(-1),
                                _rows_like(upd, table))

    def add_dense(self, table, delta) -> torch.Tensor:
        """table += delta where delta covers the table's full (global) row
        range."""
        return table.add_(delta)

    def add_dense_cols(self, table, delta, col_start: int) -> torch.Tensor:
        """table[:, col_start:col_start+w] += delta (full global row
        range): the column window of a packed state table."""
        table[:, col_start:col_start + delta.shape[1]] += delta
        return table

    def put(self, table, ids, rows) -> torch.Tensor:
        """table[ids] = rows (distinct ids): a compact step's write-back."""
        table[ids.long()] = rows
        return table


class ShardedOps:
    """Table ops on this rank's row shards over the mesh axes ``axes``
    (default :func:`mesh_table_axes`).  Tables are local shards (global row
    ``g`` on the rank at ``g // per``, local row ``g % per``, ``per`` =
    local shape[0]); ids are global and the same on every rank.

    ``stats`` counts the gathers (all-reduces, bytes) and, with ``timed``
    set, the seconds of each :meth:`phase` by the host clock around a
    device synchronisation."""

    is_sharded = True

    def __init__(self, mesh: Mesh, axes: Optional[Axes] = None):
        if not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh must be a rsparse_tpu_torch.parallel.mesh.Mesh "
                "(parallel.mesh.make_mesh or parallel.multihost."
                f"make_multihost_mesh), not {type(mesh).__name__}")
        self.mesh = mesh
        if axes is None:
            axes = mesh_table_axes(mesh)
        self.axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.index = mesh.axis_index(self.axes)
        self.size = mesh.axis_size(self.axes)
        self.timed = False
        self.stats: Dict[str, float] = {}
        self.reset_stats()

    @property
    def group(self):
        """The process group of the table axes (``AxisGroup``)."""
        return self.mesh.group(self.axes)

    def reset_stats(self) -> None:
        self.stats = {"gathers": 0, "gather_bytes": 0, "gather_s": 0.0,
                      "kernel_s": 0.0, "put_s": 0.0, "draw_checks": 0,
                      "draw_spread": 0}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Add the block's seconds to ``stats[name]`` when ``timed``."""
        if not self.timed:
            yield
            return
        dev = self.mesh.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.stats[name] += time.perf_counter() - t0

    def _local(self, table, ids):
        per = table.shape[0]
        local = ids.long() - self.index * per
        ok = (local >= 0) & (local < per)
        return local.clamp(0, per - 1), ok

    def _masked_gather(self, table, ids):
        safe, ok = self._local(table, ids)
        g = table[safe]
        okb = ok.reshape(ok.shape + (1,) * (g.ndim - ok.ndim))
        return torch.where(okb, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))

    def gather(self, table, ids) -> torch.Tensor:
        return self.gather_many([(table, ids)])[0]

    def gather_many(self, pairs) -> Tuple[torch.Tensor, ...]:
        """``table[ids]`` of every pair, whole on every rank, from ONE
        all-reduce of their bit patterns (module docstring).  Each result
        is a contiguous view starting on a 256-byte boundary."""
        parts = [self._masked_gather(t, i) for t, i in pairs]
        if not parts:
            return ()
        widths = {p.element_size() for p in parts}
        ity = _BITS[widths.pop()] if len(widths) == 1 else torch.uint8
        isz = torch.empty((), dtype=ity).element_size()
        align = 256 // isz
        flat, spans = [], []
        n = 0
        for p in parts:
            bits = p.contiguous().view(ity).reshape(-1)
            pad = -bits.numel() % align
            flat.append(bits)
            if pad:
                flat.append(bits.new_zeros(pad))
            spans.append((n, bits.numel()))
            n += bits.numel() + pad
        buf = torch.cat(flat)
        with self.phase("gather_s"):
            out = self.group.all_reduce(buf)
        self.stats["gathers"] += 1
        self.stats["gather_bytes"] += buf.numel() * isz
        return tuple(out[a:a + m].view(p.dtype).reshape(p.shape)
                     for (a, m), p in zip(spans, parts))

    def scatter_add(self, table, ids, upd) -> torch.Tensor:
        """Masked local scatter-add: each rank adds the updates landing in
        its rows."""
        safe, ok = self._local(table, ids)
        upd = _rows_like(upd, table)
        okb = ok.reshape(-1, *([1] * (upd.ndim - 1)))
        return table.index_add_(0, safe.reshape(-1),
                                torch.where(okb, upd, 0))

    def add_dense(self, table, delta) -> torch.Tensor:
        """Local shard += its slice of the replicated global delta: each
        rank takes its own row window, no collective."""
        per = table.shape[0]
        d = delta[self.index * per:(self.index + 1) * per]
        table[:d.shape[0]] += d
        return table

    def add_dense_cols(self, table, delta, col_start: int) -> torch.Tensor:
        per = table.shape[0]
        d = delta[self.index * per:(self.index + 1) * per]
        table[:d.shape[0], col_start:col_start + d.shape[1]] += d
        return table

    def put(self, table, ids, rows) -> torch.Tensor:
        """table[ids] = rows on the ids this rank owns (distinct ids), no
        collective: a compact step's write-back."""
        safe, ok = self._local(table, ids)
        table[safe[ok]] = rows[ok]
        return table

    def check_same(self, checksum: torch.Tensor, what: str) -> int:
        """Raise unless ``checksum`` (a 0-d int64 tensor, e.g. the running
        :func:`checksum` of a fit's draws) is the same on every rank of
        the table axes; returns max - min over the ranks (0)."""
        c = torch.as_tensor(checksum, dtype=torch.int64).reshape(1)
        every = self.group.all_gather(c.to(self.mesh.device)).cpu()
        spread = int(every.max() - every.min())
        self.stats["draw_checks"] += 1
        self.stats["draw_spread"] = max(self.stats["draw_spread"], spread)
        if spread:
            raise RuntimeError(f"{what} differ between ranks (checksums "
                               f"{every.tolist()}): the replicated batch "
                               "must be drawn alike on every rank")
        return spread


def checksum(t: torch.Tensor) -> torch.Tensor:
    """A 0-d int64 checksum of ``t``'s values (integers or booleans, read
    as int64) weighted by position, on ``t``'s device."""
    v = t.reshape(-1).long()
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return (v * w).sum()


# -- host-side staging helpers ------------------------------------------------


def mesh_table_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes a state table's row axis shards over: ``("dcn",
    "ici")`` on a multihost mesh, else every mesh axis (usually
    ``("data",)``)."""
    from .multihost import DATA_AXES

    if DATA_AXES[0] in mesh.axis_names:
        return DATA_AXES
    return tuple(mesh.axis_names)


def axes_size(mesh: Mesh, axes: Axes) -> int:
    return mesh.axis_size(axes)


def padded_rows(n: int, mesh: Mesh, axes: Optional[Axes] = None) -> int:
    """Table rows padded up so the row axis divides the mesh axes."""
    d = axes_size(mesh, axes if axes is not None else mesh_table_axes(mesh))
    return -(-n // d) * d


def local_rows(n: int, mesh: Mesh, axes: Optional[Axes] = None) -> int:
    """Rows of each rank's shard of an n-row table."""
    axes = axes if axes is not None else mesh_table_axes(mesh)
    return padded_rows(n, mesh, axes) // axes_size(mesh, axes)


def shard_table(arr, mesh: Mesh, axes: Optional[Axes] = None,
                n_rows: Optional[int] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's row shard of ``arr`` (numpy or torch, the same on every
    rank) on the mesh's device, the row axis padded to the mesh with zeros
    (sharded gathers and scatters touch only real ids; zeros keep
    checkpoints clean).  ``n_rows`` pads as if the table had that many
    rows."""
    axes = axes if axes is not None else mesh_table_axes(mesh)
    t = torch.as_tensor(arr)
    if dtype is not None:
        t = t.to(dtype)
    n = t.shape[0] if n_rows is None else int(n_rows)
    per = local_rows(n, mesh, axes)
    lo = mesh.axis_index(axes) * per
    out = torch.zeros((per,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=mesh.device)
    part = t[lo:lo + per]
    out[:part.shape[0]] = part.to(mesh.device)
    return out


def full_table(n: int, tail: Tuple[int, ...], value: float, mesh: Mesh,
               dtype: torch.dtype, axes: Optional[Axes] = None
               ) -> torch.Tensor:
    """This rank's shard of an n-row table of ``value`` (shape ``(n,) +
    tail``), made on the mesh's device without the whole table; padding
    rows zero, as :func:`shard_table` pads."""
    axes = axes if axes is not None else mesh_table_axes(mesh)
    per = local_rows(n, mesh, axes)
    lo = mesh.axis_index(axes) * per
    t = torch.zeros((per,) + tuple(tail), dtype=dtype, device=mesh.device)
    t[:max(0, min(per, n - lo))] = value
    return t


def replicate_on(mesh: Mesh, tree):
    """Every tensor of a (nested tuple / list / NamedTuple) tree on the
    mesh's device, whole (streamed read-only data, not state)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(tree).to(mesh.device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate_on(mesh, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate_on(mesh, t) for t in tree)
    return tree


def unshard(arr: torch.Tensor, n: Optional[int] = None,
            mesh: Optional[Mesh] = None,
            axes: Optional[Axes] = None) -> torch.Tensor:
    """The whole table of row shards ``arr`` (every rank calls it: an
    all-gather over the table axes), sliced back to its ``n`` logical
    rows, on ``arr``'s device.  Without a mesh ``arr`` is whole already.
    (The JAX package returns a numpy array; the port keeps tensors.)"""
    if mesh is not None:
        axes = axes if axes is not None else mesh_table_axes(mesh)
        t = arr.contiguous()
        if t.element_size() == 2:     # bf16 state, gathered as its bytes
            arr = mesh.group(axes).all_gather(t.view(torch.uint8)).view(
                t.dtype)
        else:
            arr = mesh.group(axes).all_gather(t)
    return arr if n is None else arr[:n]


def put_rows(ops, tables: Sequence[torch.Tensor], ids: torch.Tensor,
             compact: Sequence[torch.Tensor]) -> None:
    """Write a compact step's rows back into the tables (this rank's)."""
    with ops.phase("put_s"):
        for t, c in zip(tables, compact):
            ops.put(t, ids, c)
