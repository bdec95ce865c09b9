"""Model checkpoints, in the JAX package's npz store.

Port of the npz store of ``rsparse_tpu/utils/checkpoint.py``.  A checkpoint
is a directory holding ``meta.json`` (the class name under ``__class__``
and every JSON-serialisable attribute) and ``arrays.npz`` (every array),
with the reference's markers: ``__bf16__`` names the arrays stored as
float32 that are bfloat16 in the model, ``__sparse__`` the scipy matrices
stored as ``__sp__<name>__row/col/val``, ``__strarr__`` the string arrays
kept in ``meta.json``.  The attribute names and layouts are the reference's,
so each package loads the other's checkpoints:

- FTRL's (F + 1, 2) table ``zn`` is written as the reference's 1-D ``z``
  and ``n``;
- the port's runtime state (``device``, a torch ``dtype``, its generators,
  staged inputs and caches) and its telemetry (``stage_info``,
  ``fit_trace``, ``svd_trace``, ``trace``) are not written; ``load``
  re-derives ``dtype`` from ``precision`` (or from the arrays) and places
  the tensors on its ``device`` argument;
- PureSVD's fitted triple is written as ``_svd_u``, ``_svd_d``, ``_svd_v``
  (the reference writes it as text, which no loader can read back); from a
  checkpoint without them ``load`` rebuilds ``d`` and ``v`` from
  ``components`` = (V diag(d))', which is all ``transform`` needs;
- what the reference writes and the port does not keep (``_cnt_u``,
  ``_cnt_i`` load as unused tensors; ``_components_l2`` and caches are
  dropped) loads without effect, and a ``mesh`` or ``routing`` other than
  None raises ``NotImplementedError``, as the port's constructors do.

The reference's orbax store (mesh-sharded tables written per device) is not
ported: ``store="orbax"`` and an orbax checkpoint raise
``NotImplementedError`` (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Type

import numpy as np
import scipy.sparse as sp
import torch

#: runtime state the reference does not write either
_SKIP = ("_rng", "_key", "preprocess", "_init", "_train_ui")
#: the port's own runtime state and telemetry, re-made on load
_PORT_ONLY = ("device", "dtype", "_cdt", "_generator", "_positives",
              "_state", "stage_info", "fit_trace", "svd_trace", "trace")
#: caches: written as None (the reference's classes read them), dropped on
#: load
_CACHES = ("_components_cache", "_components_l2")
#: what else the reference writes and the port keeps nowhere: WRMF's
#: transform cache, and PureSVD's ``_svd`` / GloVe's ``_state``, which it
#: writes as text
_REFERENCE_ONLY = ("_prep_cache_key", "_prep_cache", "_svd", "_state")
#: arrays the port's models hold as numpy; every other floating array is a
#: tensor on the model's device
_HOST_ARRAYS = ("components", "bias_i", "bias_j", "_init_components")
_SVD_FIELDS = ("u", "d", "v")


def _orbax_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "the orbax store (mesh-sharded tables) is not ported to "
        "rsparse_tpu_torch yet; see ROADMAP.md queue 1 item 5")


def _host(t: torch.Tensor, name: str, dtypes: Dict[str, str]) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        dtypes[name] = "bfloat16"
        t = t.float()
    return t.numpy()


def save(model: Any, path: str, store: str = "auto") -> None:
    """Save a fitted model to the directory ``path`` in the npz store
    (``store``: "auto" or "npz"; "orbax" raises)."""
    if store == "orbax":
        raise _orbax_not_ported()
    if store not in ("auto", "npz"):
        raise ValueError(f"unknown store {store!r}")
    from ..models.base import MatrixFactorizationRecommender
    from ..models.ftrl import FTRL
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    meta: Dict[str, Any] = {"__class__": type(model).__name__}
    state = dict(vars(model))
    if isinstance(model, FTRL) and state.get("zn") is not None:
        zn = state.pop("zn")
        state["z"], state["n"] = zn[:, 0].contiguous(), zn[:, 1].contiguous()
    svd = state.pop("_svd", None)
    if svd is not None:
        state.update({f"_svd_{f}": getattr(svd, f) for f in _SVD_FIELDS
                      if getattr(svd, f) is not None})
    if isinstance(model, MatrixFactorizationRecommender):
        state.setdefault("_components_l2", None)
    for k, v in state.items():
        if k in _SKIP or k in _PORT_ONLY or callable(v):
            continue
        if k in _CACHES:
            meta[k] = None
        elif isinstance(v, torch.Tensor):
            arrays[k] = _host(v, k, dtypes)
        elif isinstance(v, np.ndarray):
            if v.dtype.kind == "O":
                if v.ndim != 1:
                    raise ValueError(f"cannot checkpoint {v.ndim}-D object "
                                     f"array {k!r}")
                meta[k] = [str(s) for s in v.tolist()]
                meta.setdefault("__strarr__", []).append(k)
            else:
                arrays[k] = v
        elif sp.issparse(v):
            coo = sp.coo_matrix(v)
            arrays[f"__sp__{k}__row"] = coo.row
            arrays[f"__sp__{k}__col"] = coo.col
            arrays[f"__sp__{k}__val"] = coo.data
            meta.setdefault("__sparse__", {})[k] = list(coo.shape)
        elif isinstance(v, (int, float, str, bool, type(None), list, tuple)):
            meta[k] = v
    # a bf16 model's components are float32 numpy here (numpy has no
    # bfloat16) holding bf16 values exactly: mark them as the reference's
    if getattr(model, "dtype", None) == torch.bfloat16 and "components" in arrays:
        dtypes["components"] = "bfloat16"
    np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)
    meta["__bf16__"] = dtypes
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)


def load(path: str, cls: Optional[Type] = None, device="cuda") -> Any:
    """Restore a model that :func:`save` or the JAX package's ``save`` (npz
    store) wrote.  ``cls`` may be omitted: the class is looked up among
    ``rsparse_tpu_torch``'s exports by the recorded name.  Tensors land on
    ``device``."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.pop("__store__", "npz") == "orbax":
        raise _orbax_not_ported()
    if cls is None:
        import rsparse_tpu_torch
        name = meta["__class__"]
        cls = getattr(rsparse_tpu_torch, name, None)
        if not isinstance(cls, type):
            raise ValueError(f"{path}: unknown model class {name!r}")
    for k in ("mesh", "routing"):
        if meta.get(k) is not None:
            raise NotImplementedError(
                f"{path} holds a model fitted with {k}={meta[k]!r}, which "
                "is not ported to rsparse_tpu_torch yet (see ROADMAP.md)")
    bf16 = meta.pop("__bf16__", {})
    sparse_shapes = meta.pop("__sparse__", {})
    strarr = meta.pop("__strarr__", [])
    for k in ("__class__", "__orbax_arrays__", *_CACHES, *_REFERENCE_ONLY):
        meta.pop(k, None)
    device = torch.device(device)
    model = cls.__new__(cls)
    for k, v in meta.items():
        setattr(model, k, np.asarray(v) if k in strarr else v)

    with np.load(os.path.join(path, "arrays.npz")) as npz:
        files = {k: npz[k] for k in npz.files}
    sparse_parts: Dict[str, Dict[str, np.ndarray]] = {}
    tensors: Dict[str, torch.Tensor] = {}
    for k, a in files.items():
        if k.startswith("__sp__"):
            name, part = k[len("__sp__"):].rsplit("__", 1)
            sparse_parts.setdefault(name, {})[part] = a
        elif k in _CACHES or k in _REFERENCE_ONLY:
            continue
        elif k in _HOST_ARRAYS or a.dtype.kind != "f":
            setattr(model, k, a)
        else:
            t = torch.from_numpy(a)
            if k in bf16:
                t = t.to(torch.bfloat16)
            tensors[k] = t.to(device)
    for name, parts in sparse_parts.items():
        setattr(model, name, sp.csr_matrix(
            (parts["val"], (parts["row"], parts["col"])),
            shape=tuple(sparse_shapes[name])))
    _restore_runtime(model, tensors, device)
    return model


def _restore_runtime(model, tensors: Dict[str, torch.Tensor],
                     device: torch.device) -> None:
    """Set the loaded tensors and re-make what :func:`save` does not
    write: the device, the dtype, fresh generators, the identity
    preprocess, and each class's own runtime state."""
    from ..config import resolve_dtype, resolve_full_dtype
    from ..models.ftrl import FTRL
    from ..models.glove import GloVe, _compute_dtype
    from ..models.pure_svd import PureSVD
    from ..models.rankmf import RankMF
    from ..models.soft_als import SVDResult
    from ..models.wrmf import WRMF, _FitState

    model.device = device
    if getattr(model, "precision", None) is not None:
        takes_bf16 = isinstance(model, (WRMF, _FitState))
        model.dtype = (resolve_dtype if takes_bf16
                       else resolve_full_dtype)(model.precision)
    else:   # RankMF and GloVe keep no precision name: their arrays' dtype
        first = next((a for a in (*tensors.values(),
                                  getattr(model, "components", None))
                      if a is not None), None)
        model.dtype = (torch.float64 if first is not None
                       and str(first.dtype).endswith("float64")
                       else torch.float32)
    z, n = tensors.pop("z", None), tensors.pop("n", None)
    svd = [tensors.pop(f"_svd_{f}", None) for f in _SVD_FIELDS]
    for k, t in tensors.items():
        setattr(model, k, t)
    model._rng = np.random.default_rng(0)
    if "preprocess" not in vars(model):
        model.preprocess = lambda m: m
    if isinstance(model, (FTRL, RankMF)):
        model._seed = getattr(model, "_seed", 0)
        model._generator = None
    if isinstance(model, FTRL):
        model.zn = None
        if z is not None:
            model._set_state(z.cpu().numpy(), n.cpu().numpy())
    if isinstance(model, (WRMF, RankMF, GloVe)):
        model.stage_info = {}
    if isinstance(model, RankMF):
        model._components_cache = None
    if isinstance(model, GloVe):
        model._cdt = _compute_dtype(model.compute_dtype, model.dtype)
        model._init = {}
        model._state = None
    if isinstance(model, PureSVD):
        model._init = None
        if svd[2] is None and getattr(model, "components", None) is not None:
            # components = (V diag(d))' with orthonormal V and d >= 0
            c = torch.as_tensor(np.asarray(model.components),
                                dtype=model.dtype, device=device)
            d = torch.linalg.vector_norm(c, dim=1)
            svd = [None, d, (c / d[:, None]).T.contiguous()]
        model._svd = None if svd[2] is None else SVDResult(*svd)
