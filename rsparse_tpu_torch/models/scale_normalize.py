"""ScaleNormalize: EigenRec popularity rescaling.

A copy of ``rsparse_tpu/models/scale_normalize.py`` (scipy only).
Reference R/model_ScaleNormalize.R:8-63 — eq. (16) of "EigenRec:
Generalizing PureSVD": a diagonal row/column scaling by
``((sum |x|^p)^(1/p))^(scale-1)``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class ScaleNormalize:
    def __init__(self, scale: float = 0.5, norm: float = 2.0,
                 target: str = "rows"):
        if target not in ("rows", "columns"):
            raise ValueError("target must be 'rows' or 'columns'")
        self.scale = scale
        self.norm = norm
        self.target = target
        self.scaling_: np.ndarray | None = None

    def fit(self, x: sp.spmatrix) -> "ScaleNormalize":
        csr = sp.csr_matrix(x)
        axis = 1 if self.target == "rows" else 0
        powered = csr.copy()
        powered.data = np.abs(powered.data) ** self.norm
        norm_vec = np.asarray(powered.sum(axis=axis)).ravel() ** (
            1.0 / self.norm)
        nz = norm_vec != 0
        norm_vec[nz] = norm_vec[nz] ** (self.scale - 1.0)
        self.scaling_ = norm_vec
        return self

    def transform(self, x: sp.spmatrix) -> sp.csr_matrix:
        if self.scaling_ is None:
            raise RuntimeError("model is not fitted")
        d = sp.diags(self.scaling_)
        res = d @ x if self.target == "rows" else x @ d
        return sp.csr_matrix(res)

    def fit_transform(self, x: sp.spmatrix) -> sp.csr_matrix:
        return self.fit(x).transform(x)
