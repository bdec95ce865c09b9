"""Carry a fitted reference model's state into the port.

:func:`wrmf_from_numpy` takes the state of a fitted ``rsparse_tpu`` WRMF as
numpy arrays (``m.components``, ``np.asarray(m._U)``, ``m.global_bias``) and
returns a fitted port :class:`~rsparse_tpu_torch.models.wrmf.WRMF`: its
``transform``, ``predict`` and ``get_similar_items`` then compute what the
reference's do.  Nothing of the reference is imported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

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
    that ``transform`` solves what the reference's does."""
    comps = np.asarray(components)
    if comps.ndim != 2:
        raise ValueError("components must be (R, n_items)")
    extra = 2 if wrmf_kwargs.get("with_user_item_bias") else 0
    wrmf_kwargs.setdefault("rank", comps.shape[0] - extra)
    m = WRMF(**wrmf_kwargs)
    if m._R != comps.shape[0]:
        raise ValueError(f"rank={m.rank} needs {m._R} rows of components, "
                         f"got {comps.shape[0]}")
    m._V = torch.tensor(comps.T, dtype=m.dtype, device=m.device).contiguous()
    m.components = m._V.T.cpu().numpy()
    m._n_items = comps.shape[1]
    m.global_bias = float(global_bias)
    m.item_ids = item_ids
    if user_factors is not None:
        m._U = torch.tensor(np.asarray(user_factors), dtype=m.dtype,
                            device=m.device)
    return m
