"""Linear-Flow: low-rank item-item similarity for one-class CF.

Port of ``rsparse_tpu/models/linear_flow.py`` (reference
R/model_LinearFlow.R:22-200, "Practical Linear Models for Large-Scale
One-Class Collaborative Filtering").  The closed form: the right singular
vectors V of the interaction matrix (soft-impute or soft-SVD), then the
ridge system

    (V' G'G V + lambda I) W = V' G'G        (G = interactions)

with ``rhs = (x V)' x`` and ``lhs = rhs V``: two bucketed SpMMs (K5) and one
rank x rank solve.  ``components = W`` maps user vectors ``x V`` to item
scores.  ``cross_validate_lambda`` re-solves along a lambda path with the
lhs/rhs reused and ranks through ``top_product`` (K3).
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..config import logger, resolve_dtype
from ..ops.spmm import spmm_buckets
from ..ops.topk import top_product
from ..sparse.device import bucket_rows
from ..sparse.splr import SparsePlusLowRank
from ..utils.metrics import ap_k, ndcg_k
from ..utils.profiling import FitTrace
from .base import MatrixFactorizationRecommender, get_names
from .soft_als import _soft_als_buckets, stage_both, staged_buckets


def _solve_ridge(lhs: torch.Tensor, rhs: torch.Tensor, lam) -> torch.Tensor:
    """(lhs + lam I) W = rhs (reference R/model_LinearFlow.R:194-198)."""
    r = lhs.shape[0]
    eye = torch.eye(r, dtype=lhs.dtype, device=lhs.device)
    return torch.linalg.solve(lhs + lam * eye, rhs)


class LinearFlow(MatrixFactorizationRecommender):
    def __init__(
        self,
        rank: int = 8,
        lambda_: float = 0.0,
        init=None,
        preprocess: Optional[Callable] = None,
        solve_right_singular_vectors: str = "soft_impute",
        precision: str = "float32",
        seed: Optional[int] = None,
        device="cuda",
    ):
        super().__init__(device)
        if solve_right_singular_vectors not in ("soft_impute", "svd"):
            raise ValueError(
                "solve_right_singular_vectors must be 'soft_impute' or 'svd'")
        self.rank = int(rank)
        self.lambda_ = float(lambda_)
        self._custom_preprocess = preprocess is not None
        self.preprocess = preprocess or (lambda m: m)
        self.solve_right_singular_vectors = solve_right_singular_vectors
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self.seed = seed
        #: (n_items, rank) right singular vectors; ``init`` fixes them
        self.v: Optional[torch.Tensor] = None
        if init is not None:
            self.v = torch.as_tensor(np.asarray(init) if not isinstance(
                init, torch.Tensor) else init, device=self.device)
        #: the soft-impute / soft-SVD trace of the last fit (empty when V
        #: was given)
        self.svd_trace: tuple = ()
        self.fit_trace = FitTrace(self.device)

    # -- internals ---------------------------------------------------------

    def _get_v_splr(self, x: SparsePlusLowRank,
                    n_iter: int = 30) -> torch.Tensor:
        """Right singular vectors of a SparsePlusLowRank input by subspace
        iteration on its lazy products, on the host (the reference's
        R/model_LinearFlow.R:55 splr input; the dense sum is never
        formed)."""
        rng = np.random.default_rng(self.seed)
        r = min(self.rank + 4, min(x.shape))
        Q = np.linalg.qr(rng.standard_normal((x.shape[1], r)))[0]
        for _ in range(max(n_iter, 8)):
            Q = np.linalg.qr(x.crossprod(x @ Q))[0]
        B = x @ Q                                    # (n_rows, r)
        _, s, wt = np.linalg.svd(B, full_matrices=False)
        v = (Q @ wt.T)[:, :self.rank]
        if v.shape[1] < self.rank:
            v = np.pad(v, ((0, 0), (0, self.rank - v.shape[1])))
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _get_v(self, staged, n_iter: int = 30) -> torch.Tensor:
        """V from the buckets of x and x' (``stage_both``): the given init,
        or soft-impute / soft-SVD on those buckets."""
        xb, txb = staged
        if self.v is not None:
            v = self.v.to(self.dtype)
            if tuple(v.shape) != (xb.n_cols, self.rank):
                raise ValueError("init v has wrong shape")
            return v
        fit = _soft_als_buckets(
            xb, txb, self.rank, 0.0, n_iter, 1e-3, None, True,
            self.solve_right_singular_vectors, self.dtype, self.seed, None,
            self.device)
        self.svd_trace = fit.trace
        v = fit.v
        if v.shape[1] < self.rank:  # final_svd may trim; pad back with zeros
            v = torch.nn.functional.pad(v, (0, self.rank - v.shape[1]))
        return v.to(self.dtype).contiguous()

    def _lhs_rhs(self, xb, txb):
        """rhs = (x v)' x, lhs = rhs v (reference R/model_LinearFlow.R:59-67):
        two K5 launch sets over the buckets of x and x', and one matmul."""
        xv = spmm_buckets(xb.buckets, xb.n_rows, self.v)         # (n_u, r)
        rhs = spmm_buckets(txb.buckets, txb.n_rows, xv).T       # (r, n_i)
        return rhs @ self.v, rhs, xv

    def _prepare(self, x) -> sp.csr_matrix:
        return sp.csr_matrix(self.preprocess(
            sp.csr_matrix(x).astype(np.float64)))

    # -- public API --------------------------------------------------------

    def fit_transform(self, x, n_iter: int = 30) -> torch.Tensor:
        """``x``: scipy sparse matrix or :class:`SparsePlusLowRank`
        (``x + a b'`` taken lazily, R/model_LinearFlow.R:55).  Returns the
        user embeddings ``x V`` as a tensor on the model's device.  The
        wall of each stage (staging, soft_impute, lhs_rhs, solve) goes to
        ``fit_trace``."""
        self.fit_trace = FitTrace(self.device)
        self.svd_trace = ()
        if isinstance(x, SparsePlusLowRank):
            if self._custom_preprocess:
                raise ValueError(
                    "a custom preprocess hook is not supported with "
                    "SparsePlusLowRank input (it operates on CSR matrices)")
            self.item_ids = None      # splr carries no dimnames
            self.user_ids = None
            if self.v is None:
                self.v = self._get_v_splr(x, n_iter)
            v_np = self.v.double().cpu().numpy()
            xv = x @ v_np                                # (n_u, r)
            rhs = torch.as_tensor(x.crossprod(xv).T, dtype=self.dtype,
                                  device=self.device)    # (r, n_i)
            lhs = rhs @ torch.as_tensor(v_np, dtype=self.dtype,
                                        device=self.device)
            self.components = _solve_ridge(lhs, rhs,
                                           self.lambda_).cpu().numpy()
            return torch.as_tensor(xv, dtype=self.dtype, device=self.device)
        self.item_ids = get_names(x, 1)
        self.user_ids = get_names(x, 0)
        trace = self.fit_trace
        with trace.phase(0, "staging"):
            csr = self._prepare(x)
            staged = stage_both(csr, self.dtype, self.device)
        with trace.phase(0, "soft_impute"):
            self.v = self._get_v(staged, n_iter)
        with trace.phase(0, "lhs_rhs"):
            lhs, rhs, xv = self._lhs_rhs(*staged)
        with trace.phase(0, "solve"):
            self.components = _solve_ridge(lhs, rhs,
                                           self.lambda_).cpu().numpy()
        return xv

    def transform(self, x) -> torch.Tensor:
        if self.v is None:
            raise RuntimeError("model is not fitted")
        if isinstance(x, SparsePlusLowRank):
            return torch.as_tensor(x @ self.v.double().cpu().numpy(),
                                   dtype=self.dtype, device=self.device)
        csr = self._prepare(x)
        xb = staged_buckets(csr, self.dtype, self.device)
        return spmm_buckets(xb.buckets, csr.shape[0], self.v.to(self.dtype))

    def cross_validate_lambda(
        self,
        x: sp.spmatrix,
        x_train: sp.spmatrix,
        x_test: sp.spmatrix,
        lambda_: Union[str, Sequence[float]] = "auto@10",
        metric: str = "map@10",
        not_recommend: Union[sp.spmatrix, None, str] = "x_train",
        n_iter: int = 30,
    ):
        """Tune lambda with the lhs/rhs reused across the ridge solves
        (reference R/model_LinearFlow.R:96-165).  Returns a list of
        ``{"lambda": l, "score": s}`` and keeps the best components.  The
        query embeddings and each lambda's components stay on the device
        through the top-k kernel."""
        self.item_ids = get_names(x, 1)
        if isinstance(not_recommend, str) and not_recommend == "x_train":
            not_recommend = x_train
        csr = self._prepare(x)
        train_csr = self._prepare(x_train)

        m = re.fullmatch(r"(ndcg|map)@(\d+)", metric)
        if not m:
            raise ValueError(f"unsupported metric {metric!r}; use map@k/ndcg@k")
        metric_name, metric_k = m.group(1), int(m.group(2))

        staged = stage_both(csr, self.dtype, self.device)
        self.v = self._get_v(staged, n_iter)
        lhs, rhs, _ = self._lhs_rhs(*staged)

        if isinstance(lambda_, str):
            am = re.fullmatch(r"auto@(\d+)", lambda_)
            if not am:
                raise ValueError(f"unsupported lambda spec {lambda_!r}")
            k = int(am.group(1))
            ridge = torch.diagonal(lhs).double().cpu().numpy()
            lambdas = np.logspace(np.log10(0.1 * ridge.min()),
                                  np.log10(10 * ridge.max()), k)
        else:
            lambdas = np.asarray(lambda_, np.float64)
        if lambdas.size == 0:
            raise ValueError("lambda_ grid is empty")

        xb_train = bucket_rows(train_csr, self.dtype, self.device)
        xq = spmm_buckets(xb_train.buckets, train_csr.shape[0], self.v)

        results = []
        best = -np.inf
        best_y = None
        scorer = ap_k if metric_name == "map" else ndcg_k
        for lam in lambdas:
            Y = _solve_ridge(lhs, rhs, torch.tensor(lam, dtype=lhs.dtype,
                                                    device=lhs.device))
            idx, _ = top_product(xq, Y, metric_k, not_recommend=not_recommend)
            score = float(np.nanmean(scorer(idx, x_test)))
            results.append({"lambda": float(lam), "score": score})
            # a NaN score never wins and never sets the bar; an unfitted
            # model still keeps the first solve, so that predict works
            if not np.isnan(score) and score >= best:
                best = score
                best_y = Y
                self.lambda_ = float(lam)
            elif best_y is None and self.components is None:
                best_y = Y
                self.lambda_ = float(lam)
            logger.info("lambda %.4f score %.4f", lam, score)
        if best_y is not None:      # all-NaN scores keep prior components
            self.components = best_y.cpu().numpy()
        return results
