"""Shared recommender API: ``predict`` and ``get_similar_items``.

Port of ``rsparse_tpu/models/base.py`` (reference
R/MatrixFactorizationRecommender.R:4-121).  Both go through
``ops/topk.py`` ``top_product`` on the model's device, or, for a model
fitted on a mesh with a ``data`` axis, through
``parallel/topk_sharded.py`` ``sharded_top_product`` (the item axis split
over the ranks; every rank calls it and gets the whole result), unless k
exceeds a rank's items: then each rank ranks alone, as the JAX package
falls back to one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.topk import top_product
from ..sparse.splr import SparsePlusLowRank


class TopK(NamedTuple):
    """Result of ``predict``: top-k item indices (0-based), scores, and —
    when the training matrix carried column names — the item identifiers
    (the ``ids`` attribute of the reference's prediction matrix,
    R/MatrixFactorizationRecommender.R:71-77)."""

    indices: np.ndarray             # (n_users, k) int32
    scores: np.ndarray              # (n_users, k) float32
    ids: Optional[np.ndarray]       # (n_users, k) object or None
    user_ids: Optional[Sequence]    # row names of the query matrix

    @property
    def shape(self):
        return self.indices.shape


def get_names(x, axis: int):
    """Row/col names attached by the RData loader (or None)."""
    return getattr(x, "row_names" if axis == 0 else "col_names", None)


class MatrixFactorizationRecommender:
    """Base recommender: holds item embeddings (``components``, (R, n_items)
    numpy, the reference's rank-by-items layout) and retrieval on the
    model's ``device``.  Subclasses (:class:`~.wrmf.WRMF`,
    :class:`~.pure_svd.PureSVD`, :class:`~.linear_flow.LinearFlow`)
    implement ``transform(x)``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.components: Optional[np.ndarray] = None
        self.global_bias: float = 0.0
        self.item_ids: Optional[Sequence] = None

    def _item_ids_of(self, idx: np.ndarray) -> Optional[np.ndarray]:
        if self.item_ids is None:
            return None
        return np.asarray(self.item_ids, object)[idx]

    def predict(
        self,
        x: sp.spmatrix,
        k: int,
        not_recommend: Union[sp.spmatrix, None, str] = "x",
        items_exclude: Sequence = (),
    ) -> TopK:
        """Recommend top-k items for each row of ``x``.

        ``not_recommend`` defaults to ``x`` itself (don't recommend already
        seen items, reference R/MatrixFactorizationRecommender.R:24).
        ``items_exclude`` may be integer indices or item identifiers.
        """
        if isinstance(not_recommend, str) and not_recommend == "x":
            not_recommend = x
        if isinstance(not_recommend, SparsePlusLowRank):
            # mask the observed interactions, the sparse part (the low-rank
            # term is a dense offset, not an interaction record)
            not_recommend = not_recommend.x
        items_exclude = list(dict.fromkeys(items_exclude))
        excl_idx = None
        if items_exclude:
            if all(isinstance(i, (int, np.integer)) for i in items_exclude):
                excl_idx = np.asarray(items_exclude, np.int64)
            else:
                if self.item_ids is None:
                    raise ValueError("model doesn't contain item ids")
                lookup = {v: i for i, v in enumerate(self.item_ids)}
                excl_idx = np.asarray(
                    [lookup[i] for i in items_exclude if i in lookup], np.int64)
        user_emb = self.transform(x)
        idx, scores = self._top_product(
            user_emb, self.components, k, not_recommend=not_recommend,
            exclude=excl_idx, glob_mean=self.global_bias)
        return TopK(idx, scores, self._item_ids_of(idx), get_names(x, 0))

    def _top_product(self, x, y, k, **kw):
        """``top_product``, or its sharded form on a mesh with a ``data``
        axis while k fits a rank's items."""
        mesh = getattr(self, "mesh", None)
        if mesh is not None and "data" in mesh.axis_names:
            from ..parallel.topk_sharded import shard_cap, sharded_top_product
            if k <= shard_cap(y.shape[1], mesh.shape["data"]):
                return sharded_top_product(mesh, x, y, k, **kw)
        return top_product(x, y, k, **kw)

    def get_similar_items(self, item_id, k: Optional[int] = None,
                          device: Optional[bool] = None) -> TopK:
        """Cosine-similar items to ``item_id``
        (reference R/MatrixFactorizationRecommender.R:79-107): top_product
        of the query's L2-normalised embedding against all items, the query
        itself excluded, so at most ``n_items - 1`` results.  ``device`` is
        the reference's choice between a host and a device ranking; it is
        accepted and ignored, since the port always ranks on the model's
        device (``top_product``, or sharded on a mesh)."""
        comps = np.asarray(self.components, np.float32)
        n_items = comps.shape[1]
        k = n_items - 1 if k is None else min(k, n_items - 1)
        if self.item_ids is not None and not isinstance(
                item_id, (int, np.integer)):
            matches = np.flatnonzero(
                np.asarray(self.item_ids, object) == item_id)
            if len(matches) == 0:
                raise ValueError(f"no item with id {item_id!r} in the model")
            i = int(matches[0])
        else:
            i = int(item_id)
        norms = np.sqrt((comps ** 2).sum(axis=0))
        l2 = torch.as_tensor(comps / np.maximum(norms, 1e-12),
                             device=self.device)
        idx, scores = self._top_product(l2[:, i][None, :], l2, k,
                                        exclude=np.asarray([i], np.int64))
        ids = self._item_ids_of(idx)
        return TopK(idx, scores, ids, None)
