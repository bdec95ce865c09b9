"""PureSVD recommender (reference R/model_PureSVD.R:20-109).

Port of ``rsparse_tpu/models/pure_svd.py``: a recommender around
:func:`soft_svd` / :func:`soft_impute`.  Item components are
``(V diag(d))'``, user embeddings are ``x V`` (K5).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_full_dtype
from ..ops.spmm import spmm_buckets
from ..sparse.device import bucket_rows
from .base import MatrixFactorizationRecommender, get_names
from .soft_als import SVDResult, soft_impute, soft_svd, staged_buckets


class PureSVD(MatrixFactorizationRecommender):
    def __init__(
        self,
        rank: int = 10,
        lambda_: float = 0.0,
        init: Optional[SVDResult] = None,
        preprocess: Optional[Callable] = None,
        method: str = "svd",
        precision: str = "float32",
        seed: Optional[int] = None,
        device="cuda",
    ):
        super().__init__(device)
        if method not in ("svd", "impute"):
            raise ValueError("method must be 'svd' or 'impute'")
        self.rank = int(rank)
        self.lambda_ = float(lambda_)
        self.method = method
        self.precision = precision
        self.dtype = resolve_full_dtype(precision)
        self.preprocess = preprocess or (lambda m: m)
        self._init = init
        self._svd: Optional[SVDResult] = None
        self.seed = seed

    def fit_transform(self, x: sp.spmatrix, n_iter: int = 100,
                      convergence_tol: float = 1e-3) -> torch.Tensor:
        """Fit the SVD; returns the user embeddings ``x V`` (n_users, r) as
        a tensor on the model's device."""
        self.item_ids = get_names(x, 1)
        self.user_ids = get_names(x, 0)
        csr = sp.csr_matrix(self.preprocess(
            sp.csr_matrix(x).astype(np.float64)))
        fn = soft_svd if self.method == "svd" else soft_impute
        fit = fn(csr, rank=self.rank, lambda_=self.lambda_, n_iter=n_iter,
                 convergence_tol=convergence_tol, init=self._init,
                 precision=self.precision, seed=self.seed, device=self.device)
        self._svd = fit.svd
        self.trace = fit.trace
        u, d, v = self._svd
        # user embeddings = x V (R/model_PureSVD.R:77), on the buckets the
        # fit staged
        xb = staged_buckets(csr, self.dtype, self.device)
        res = spmm_buckets(xb.buckets, csr.shape[0], v)
        # components = (V diag(d))' (R/model_PureSVD.R:80)
        self.components = (v * d[None, :]).T.cpu().numpy()
        return res

    def transform(self, x: sp.spmatrix) -> torch.Tensor:
        if self._svd is None:
            raise RuntimeError("model is not fitted")
        csr = sp.csr_matrix(self.preprocess(
            sp.csr_matrix(x).astype(np.float64)))
        xb = bucket_rows(csr, self.dtype, self.device)
        return spmm_buckets(xb.buckets, csr.shape[0], self._svd.v)
