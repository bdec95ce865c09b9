"""Sharded WRMF: factor placement and one full ALS iteration on a mesh.

Port of ``rsparse_tpu/parallel/wrmf_step.py``.  On a ``("data", "model")``
mesh:

- interaction buckets are split along their batch axis over ``data``
  (each rank solves its slice; :func:`.mesh.shard_buckets`);
- factor tables are row-sharded over ``model`` between half-sweeps
  (:func:`place_factors`) and all-gathered over the model group before one
  (:func:`gather_factors`), as XLA's partitioner does for ``P("model")``;
- the Gram, rhs_init and loss are partial sums all-reduced over the data
  group and the solved rows are all-gathered over it (``ops/als.py``
  ``wrmf_sweep(group=...)``), so every rank ends a half-sweep with the
  whole new table.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.als import ALSConfig, wrmf_sweep
from ..sparse.device import BucketedRows
from .mesh import Mesh, shard_buckets
from .multihost import data_spec


def place_factors(mesh: Mesh, arr: torch.Tensor) -> torch.Tensor:
    """This rank's share of a whole factor table: its row block over
    ``model`` when the axis exists and divides the rows, else the whole
    table (replicated, as ``rsparse_tpu`` ``_place_factors`` falls back)."""
    arr = arr.to(mesh.device)
    n = mesh.shape.get("model", 1)
    if n == 1 or arr.shape[0] % n:
        return arr
    per = arr.shape[0] // n
    i = mesh.coords["model"]
    return arr[i * per:(i + 1) * per].clone()


def gather_factors(mesh: Mesh, local: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """The whole ``(n_rows, R)`` table from this rank's share
    (:func:`place_factors`): an all-gather over ``model``, or the table
    itself when it is whole."""
    if local.shape[0] == n_rows:
        return local
    return mesh.group("model").all_gather(local)


def data_sweep(mesh: Mesh, src: torch.Tensor, tgt: torch.Tensor,
               buckets, n_src: int, n_tgt: int, lam, g, cfg: ALSConfig,
               hot_ids=None, hot_rows=None, src_cnt=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One half-sweep on the mesh: the tables whole, this rank's bucket
    slices solved, the result combined over the data group.  ``src`` and
    ``tgt`` may be shares (:func:`place_factors`); returns the whole new
    target table and the loss, the same on every rank."""
    return wrmf_sweep(gather_factors(mesh, src, n_src),
                      gather_factors(mesh, tgt, n_tgt), buckets, lam, g, cfg,
                      hot_ids, hot_rows, src_cnt,
                      group=mesh.group(data_spec(mesh)))


def train_step(
    mesh: Mesh,
    U: torch.Tensor,
    V: torch.Tensor,
    iu: BucketedRows,
    ui: BucketedRows,
    cnt_u,
    cnt_i,
    lam: float,
    g: float,
    cfg_items: ALSConfig,
    cfg_users: ALSConfig,
    hot_iu=None,
    hot_ui=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full ALS iteration (items then users) on the mesh, from the
    placed tables and this rank's buckets of :func:`shard_problem`;
    returns the placed (U, V) and the user half-sweep's loss.  ``hot_iu``
    / ``hot_ui`` are ``(hot_ids, hot_rows)`` of a dense zipf head."""
    n_users, n_items = ui.n_rows, iu.n_rows
    V, _ = data_sweep(mesh, U, V, iu.buckets, n_users, n_items, lam, g,
                      cfg_items, *(hot_iu or (None, None)), cnt_u)
    V = place_factors(mesh, V)
    U, loss = data_sweep(mesh, V, U, ui.buckets, n_items, n_users, lam, g,
                         cfg_users, *(hot_ui or (None, None)), cnt_i)
    return place_factors(mesh, U), V, loss


def shard_problem(mesh: Mesh, U: torch.Tensor, V: torch.Tensor,
                  iu: BucketedRows, ui: BucketedRows):
    """Factors row-sharded over ``model`` and buckets batch-split over
    ``data``; bucket batches must divide the ``data`` axis size."""
    return (place_factors(mesh, U), place_factors(mesh, V),
            shard_buckets(iu, mesh, "data"), shard_buckets(ui, mesh, "data"))
