"""Carry a fitted reference model's state into the port.

Each function takes the state of a fitted ``rsparse_tpu`` model as numpy
arrays and returns the fitted port model, whose ``transform``, ``predict``
and ``get_similar_items`` then compute what the reference's do:

- :func:`wrmf_from_numpy`: WRMF from ``m.components``, ``np.asarray(m._U)``
  and ``m.global_bias``;
- :func:`svd_from_numpy`: an :class:`SVDResult` from ``(u, d, v)``, e.g. a
  ``soft_svd`` / ``soft_impute`` result, usable as a warm start;
- :func:`pure_svd_from_numpy`: PureSVD from its ``_svd`` triple;
- :func:`linear_flow_from_numpy`: LinearFlow from ``m.v`` and
  ``m.components``;
- :func:`ftrl_from_numpy`: FTRL from ``m.z`` and ``m.n`` (or
  ``FTRL.load(m.dump())``);
- :func:`fm_from_numpy`: FactorizationMachine from ``m.w0``, ``m.acc_w0``,
  ``m.w``, ``m.v``, ``m.acc_w`` and ``m.acc_v``;
- :func:`rankmf_from_numpy`: RankMF from ``m.user_features_embeddings``,
  ``m.item_features_embeddings``, ``m._accW`` and ``m._accH``;
- :func:`glove_from_numpy`: GloVe from the embeddings ``fit_transform``
  returned, ``m.components.T``, ``m.bias_i`` and ``m.bias_j``;
  :func:`glove_state_from_numpy` the port's ``GloveState`` from the
  reference's (``m._state``, 8 arrays).

The SGD functions take ``mesh=`` (a ``parallel.mesh.Mesh``, every rank
calling with the same arrays): the model is made on that mesh with the
state carried across row-sharded (``parallel/sgd_sharded.py``).

A bf16 model (RankMF, GloVe ``precision="bfloat16"``) takes the
reference's bf16 parameters exactly: ``np.asarray`` of a JAX bf16 array is
a 2-byte bfloat16 array (of the ``ml_dtypes`` package, which the port does
not import), taken by its bit pattern; float32 or float64 arrays holding
bf16 values cast to bf16 without change.

Nothing of the reference is imported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import resolve_dtype, resolve_full_dtype
from .models.fm import FactorizationMachine
from .models.ftrl import FTRL
from .models.glove import GloVe, GloveState
from .models.linear_flow import LinearFlow
from .models.pure_svd import PureSVD
from .models.rankmf import RankMF
from .models.soft_als import SVDResult
from .models.wrmf import WRMF


def wrmf_from_numpy(components: np.ndarray,
                    user_factors: Optional[np.ndarray] = None,
                    global_bias: float = 0.0,
                    item_ids: Optional[Sequence] = None,
                    **wrmf_kwargs) -> WRMF:
    """A fitted port WRMF from (R, n_items) item factors ``components`` and
    optional (n_users, R) ``user_factors``; ``wrmf_kwargs`` go to
    :class:`WRMF`.  R is ``rank``, or ``rank + 2`` with
    ``with_user_item_bias`` (item rows ``[i_bias, emb..., 1]``); ``rank``
    defaults to what R implies.  Pass the fitted model's ``feedback``,
    ``solver``, ``lambda_``, ``dynamic_lambda`` and bias options too, so
    that ``transform`` solves what the reference's does, and its
    ``precision``, ``compute_dtype`` and ``hot_dtype``: a bf16 model's
    components, read as float32, load into a bf16 port model exactly."""
    comps = np.asarray(components)
    if comps.ndim != 2:
        raise ValueError("components must be (R, n_items)")
    extra = 2 if wrmf_kwargs.get("with_user_item_bias") else 0
    wrmf_kwargs.setdefault("rank", comps.shape[0] - extra)
    m = WRMF(**wrmf_kwargs)
    if m._R != comps.shape[0]:
        raise ValueError(f"rank={m.rank} needs {m._R} rows of components, "
                         f"got {comps.shape[0]}")
    m._set_items(torch.tensor(comps.T, dtype=m.dtype,
                              device=m.device).contiguous())
    m._n_items = comps.shape[1]
    m.global_bias = float(global_bias)
    m.item_ids = item_ids
    if user_factors is not None:
        m._U = torch.tensor(np.asarray(user_factors), dtype=m.dtype,
                            device=m.device)
    return m


def svd_from_numpy(u: np.ndarray, d: np.ndarray, v: np.ndarray,
                   precision: str = "float32", device="cuda") -> SVDResult:
    """An :class:`SVDResult` of tensors on ``device`` from (n, r), (r,) and
    (m, r) arrays."""
    dtype = resolve_full_dtype(precision)
    u, d, v = (torch.tensor(np.asarray(a), dtype=dtype, device=device)
               for a in (u, d, v))
    if d.ndim != 1 or u.shape[1] != d.shape[0] or v.shape[1] != d.shape[0]:
        raise ValueError("expected u (n, r), d (r,), v (m, r)")
    return SVDResult(u, d, v)


def pure_svd_from_numpy(u: np.ndarray, d: np.ndarray, v: np.ndarray,
                        item_ids: Optional[Sequence] = None,
                        **pure_svd_kwargs) -> PureSVD:
    """A fitted port PureSVD from the reference model's ``_svd`` triple;
    ``pure_svd_kwargs`` go to :class:`PureSVD` (pass its ``precision`` and
    ``preprocess``); ``rank`` defaults to ``len(d)``."""
    pure_svd_kwargs.setdefault("rank", len(d))
    m = PureSVD(**pure_svd_kwargs)
    m._svd = svd_from_numpy(u, d, v, m.precision, m.device)
    m.components = (m._svd.v * m._svd.d[None, :]).T.cpu().numpy()
    m.item_ids = item_ids
    return m


def linear_flow_from_numpy(v: np.ndarray, components: np.ndarray,
                           item_ids: Optional[Sequence] = None,
                           **linear_flow_kwargs) -> LinearFlow:
    """A fitted port LinearFlow from the reference model's (n_items, r)
    right singular vectors ``v`` and (r, n_items) ``components``;
    ``linear_flow_kwargs`` go to :class:`LinearFlow` (pass its
    ``precision``, ``lambda_`` and ``preprocess``); ``rank`` defaults to
    ``v.shape[1]``."""
    v = np.asarray(v)
    comps = np.asarray(components)
    if v.ndim != 2 or comps.shape != (v.shape[1], v.shape[0]):
        raise ValueError("expected v (n_items, r) and components "
                         "(r, n_items)")
    linear_flow_kwargs.setdefault("rank", v.shape[1])
    m = LinearFlow(**linear_flow_kwargs)
    m.v = torch.tensor(v, dtype=m.dtype, device=m.device)
    m.components = np.array(comps)
    m.item_ids = item_ids
    return m


def as_tensor(a) -> torch.Tensor:
    """A host tensor of array ``a``: numpy floats as they are, a 2-byte
    bfloat16 array (``np.asarray`` of a JAX bf16 array) by its bit
    pattern, as torch.bfloat16."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.itemsize == 2 and a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tensor(a, m):
    return as_tensor(a).to(device=m.device, dtype=m.dtype)


def _table(a, m):
    """A state table on the model's device, or its row shard on the
    model's mesh."""
    if m.mesh is None:
        return _tensor(a, m)
    from .parallel.sgd_sharded import shard_table
    return shard_table(as_tensor(a), m.mesh, dtype=m.dtype)


def ftrl_from_numpy(z: np.ndarray, n: np.ndarray, **ftrl_kwargs) -> FTRL:
    """A fitted port FTRL from the reference model's (F + 1,) ``z`` and
    ``n`` (the last row is the padding feature); ``ftrl_kwargs`` go to
    :class:`FTRL` (pass its learning rates, ``lambda_``, ``l1_ratio``,
    ``dropout``, ``family`` and ``precision``, and ``mesh`` to shard the
    table)."""
    m = FTRL(**ftrl_kwargs)
    m._set_state(z, n)
    return m


def fm_from_numpy(w0, acc_w0, w: np.ndarray, v: np.ndarray,
                  acc_w: np.ndarray, acc_v: np.ndarray,
                  **fm_kwargs) -> FactorizationMachine:
    """A fitted port FactorizationMachine from the reference model's
    scalars ``w0``/``acc_w0``, (F + 1,) ``w``/``acc_w`` and (F + 1, r)
    ``v``/``acc_v``; ``fm_kwargs`` go to :class:`FactorizationMachine`
    (pass its learning rates, lambdas, ``family``, ``intercept`` and
    ``precision``, and ``mesh`` to shard the tables); ``rank`` defaults to
    ``v.shape[1]``."""
    v = np.asarray(v)
    if v.ndim != 2 or np.shape(w) != (v.shape[0],):
        raise ValueError("expected w (F + 1,) and v (F + 1, r)")
    fm_kwargs.setdefault("rank", v.shape[1])
    m = FactorizationMachine(**fm_kwargs)
    m.n_features = v.shape[0] - 1
    m.w0, m.acc_w0 = _tensor(w0, m), _tensor(acc_w0, m)
    m.w, m.v = _table(w, m), _table(v, m)
    m.acc_w, m.acc_v = _table(acc_w, m), _table(acc_v, m)
    return m


def rankmf_from_numpy(user_emb: np.ndarray, item_emb: np.ndarray,
                      acc_user: np.ndarray, acc_item: np.ndarray,
                      user_features=None, item_features=None,
                      item_ids: Optional[Sequence] = None,
                      **rankmf_kwargs) -> RankMF:
    """A fitted port RankMF from the reference model's (n_user_feat, r) and
    (n_item_feat, r) feature embeddings and their accumulators, with the
    side-feature matrices it was fitted with (None: identity features);
    ``rankmf_kwargs`` go to :class:`RankMF` (``mesh`` shards the tables);
    ``rank`` defaults to ``user_emb.shape[1]``.  ``transform``,
    ``components`` and ``predict`` then give the reference's, and
    ``partial_fit_transform`` continues from this state."""
    import scipy.sparse as sp
    user_emb, item_emb = np.asarray(user_emb), np.asarray(item_emb)
    rankmf_kwargs.setdefault("rank", user_emb.shape[1])
    m = RankMF(**rankmf_kwargs)
    m.user_features_embeddings = _table(user_emb, m)
    m.item_features_embeddings = _table(item_emb, m)
    m._accW, m._accH = _table(acc_user, m), _table(acc_item, m)
    m._nuf, m._nif = user_emb.shape[0], item_emb.shape[0]
    m._identity_user_feats = user_features is None
    m._identity_item_feats = item_features is None
    m._user_features = (None if user_features is None
                        else sp.csr_matrix(user_features))
    m._item_features = (None if item_features is None
                        else sp.csr_matrix(item_features))
    m.item_ids = item_ids
    return m


def glove_state_from_numpy(state: Sequence, precision: str = "float32",
                           device="cuda") -> GloveState:
    """The port's :class:`GloveState` on ``device`` from the reference's
    (8 arrays in its field order: w_i, w_j, b_i, b_j and their
    accumulators)."""
    if len(state) != len(GloveState._fields):
        raise ValueError(f"expected {len(GloveState._fields)} arrays "
                         f"({', '.join(GloveState._fields)})")
    dtype = resolve_dtype(precision)
    return GloveState(*(as_tensor(a).to(device=device, dtype=dtype)
                        for a in state))


def glove_from_numpy(w_i: np.ndarray, w_j: np.ndarray, b_i: np.ndarray,
                     b_j: np.ndarray, **glove_kwargs) -> GloVe:
    """A fitted port GloVe from the reference model's (n, r) embeddings
    ``w_i`` (what ``fit_transform`` returned) and context embeddings ``w_j``
    (``m.components.T``), and its (n,) biases; ``glove_kwargs`` go to
    :class:`GloVe` (pass its ``x_max`` and ``precision``, and ``mesh`` to
    shard the state); ``rank`` defaults to ``w_i.shape[1]``.  Sets
    ``components``, ``bias_i``, ``bias_j`` and the state (accumulators at
    ones)."""
    w_i, w_j = np.asarray(w_i), np.asarray(w_j)
    n = w_i.shape[0]
    if (w_i.ndim != 2 or w_j.shape != w_i.shape or np.shape(b_i) != (n,)
            or np.shape(b_j) != (n,)):
        raise ValueError("expected w_i, w_j (n, r) and b_i, b_j (n,)")
    glove_kwargs.setdefault("rank", w_i.shape[1])
    m = GloVe(**glove_kwargs)
    ones = [np.ones_like(a) for a in (w_i, w_j, b_i, b_j)]
    st = glove_state_from_numpy([w_i, w_j, b_i, b_j, *ones], m.dtype,
                                m.device if m.mesh is None else "cpu")
    if m.mesh is not None:
        from .parallel.sgd_sharded import shard_table
        st = GloveState(*(shard_table(t, m.mesh) for t in st))
        m._n_vocab = n
    m._set_fitted(st)
    return m
