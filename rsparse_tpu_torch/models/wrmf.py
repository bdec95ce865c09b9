"""WRMF: Weighted Regularized Matrix Factorization (implicit-feedback iALS).

Port of ``rsparse_tpu/models/wrmf.py`` for implicit feedback with the
conjugate-gradient or Cholesky solver, an optional implicit global bias,
the dense zipf-head split (``n_hot``, CG only), warm-start ``init`` and
``convergence_tol``.  Interactions are bucketed into padded (B, L) row
blocks (``sparse/device.py``); each ALS half-sweep solves the buckets one
kernel launch at a time (``ops/als.py``).  The alternating item/user sweeps
mirror the reference's fit loop (R/model_WRMF.R:318-338), and the fit ends
with the exact Cholesky half-sweep that makes ``fit_transform(x)`` equal
``transform(x)`` (R/model_WRMF.R:355-359).

Randomness comes from ``np.random.default_rng(seed)`` drawn in the same
order as the reference (U first; V only when the solver is not CG), so the
initial state matches it exactly.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import logger, resolve_dtype
from ..ops.als import (ALSConfig, CHOLESKY, CONJUGATE_GRADIENT, NNLS,
                       solver_code, wrmf_sweep)
from ..sparse.device import (BucketedRows, bucket_rows, hot_bucket_rows,
                             split_hot_cold)
from ..utils.profiling import FitTrace
from .base import MatrixFactorizationRecommender, get_names

#: rows per bucket are padded to a multiple of this (the reference's value
#: without a device mesh)
_ROW_ALIGN = 8


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to rsparse_tpu_torch yet (see ROADMAP.md)")


class WRMF(MatrixFactorizationRecommender):
    """Weighted ALS matrix factorization for implicit feedback."""

    def __init__(
        self,
        rank: int = 10,
        lambda_: float = 0.0,
        dynamic_lambda: bool = True,
        init: Optional[np.ndarray] = None,
        preprocess: Optional[Callable] = None,
        feedback: str = "implicit",
        solver: str = "conjugate_gradient",
        with_user_item_bias: bool = False,
        with_global_bias: bool = False,
        cg_steps: int = 3,
        precision: str = "float32",
        seed: Optional[int] = None,
        mesh=None,
        compute_dtype: str = "float32",
        n_hot="auto",
        hot_dtype: str = "auto",
        routing: Optional[str] = None,
        device="cuda",
    ):
        super().__init__(device)
        if feedback not in ("implicit", "explicit"):
            raise ValueError("feedback must be 'implicit' or 'explicit'")
        if feedback == "explicit":
            raise _not_ported("explicit feedback")
        self.solver = solver_code(solver)
        if self.solver == NNLS:
            raise _not_ported("the 'nnls' solver")
        if with_user_item_bias:
            raise _not_ported("with_user_item_bias")
        if compute_dtype != "float32":
            raise _not_ported(f"compute_dtype={compute_dtype!r}")
        if hot_dtype != "auto":
            raise _not_ported(f"hot_dtype={hot_dtype!r}")
        if mesh is not None:
            raise _not_ported("mesh")
        if routing is not None:
            raise _not_ported(f"routing={routing!r}")
        if n_hot != "auto" and int(n_hot) != 0 and \
                self.solver != CONJUGATE_GRADIENT:
            raise _not_ported("the dense zipf head with the Cholesky solver")
        self.feedback = feedback
        self.with_global_bias = with_global_bias
        self.rank = int(rank)
        self.lambda_ = float(lambda_)
        # dynamic lambda scales lambda by nnz for explicit feedback only
        self.dynamic_lambda = bool(dynamic_lambda)
        self.cg_steps = int(cg_steps)
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self.preprocess = preprocess or (lambda m: m)
        self._rng = np.random.default_rng(seed)
        self._init_components = init
        #: dense zipf-head split: the hottest columns of each sweep
        #: orientation go to a dense block read without per-nnz indices.
        #: 0 disables, an int fixes the head size, "auto" applies the
        #: reference's break-even rule
        self.n_hot = n_hot
        self._V: Optional[torch.Tensor] = None   # (n_items, R) factors
        self._U: Optional[torch.Tensor] = None   # (n_users, R) factors
        self._n_items: Optional[int] = None
        self.loss_history: list = []

    # -- helpers -----------------------------------------------------------

    def _cfg(self, solver: Optional[int] = None) -> ALSConfig:
        return ALSConfig(
            solver=self.solver if solver is None else solver,
            cg_steps=self.cg_steps,
            use_global_bias=self.with_global_bias,
        )

    def _bucketize(self, csr, include_empty: bool) -> BucketedRows:
        return bucket_rows(csr, self.dtype, self.device,
                           include_empty=include_empty, row_align=_ROW_ALIGN)

    def _resolve_n_hot(self, csr: sp.csr_matrix) -> int:
        """Head size for the dense zipf-head split of one sweep orientation
        (the reference's rule, rsparse_tpu/models/wrmf.py
        ``_resolve_n_hot``): "auto" takes every column whose nnz count
        clears ``max(8, n_rows / (512 / w_bytes))``; the width is capped by
        a 1 GB budget for the dense block and by 16384 / w_bytes."""
        if self.solver != CONJUGATE_GRADIENT and self.n_hot == "auto":
            return 0
        n_rows, n_cols = csr.shape
        w_bytes = torch.finfo(self.dtype).bits // 8
        n = self.n_hot
        if n == "auto":
            counts = np.bincount(csr.indices, minlength=n_cols)
            n = int((counts >= max(8, n_rows // (512 // min(w_bytes, 4)))
                     ).sum())
        cap = (1 << 30) // max(w_bytes * n_rows, 1)
        n = int(min(int(n), 16384 // min(w_bytes, 4), cap, n_cols))
        return n if n >= 16 else 0

    def _stage(self, csr: sp.csr_matrix, include_empty: bool):
        """Hot/cold split + buckets of one sweep orientation: (hot column
        ids or None, buckets, hot rows in bucket order or None).  The dense
        block itself is dropped once its rows are in bucket order."""
        n_hot = self._resolve_n_hot(csr)
        hot = None
        if n_hot:
            hot, csr = split_hot_cold(csr, n_hot, self.dtype, self.device)
        br = self._bucketize(csr, include_empty or hot is not None)
        if hot is None:
            return None, br, None
        return hot.hot_ids, br, hot_bucket_rows(hot, br.buckets)

    def _rand(self, n: int) -> torch.Tensor:
        # N(0, 0.01) init, matching large_rand_matrix / flrnorm
        # (reference src/utils.cpp:131-143, R/model_WRMF.R:211)
        a = self._rng.standard_normal((n, self.rank)) * 0.01
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _prepare_input(self, x: sp.spmatrix) -> sp.csr_matrix:
        csr = self.preprocess(sp.csr_matrix(x).astype(np.float64))
        if csr.nnz and csr.data.min() < 0:
            raise ValueError("all values must be >= 0 for implicit feedback")
        return csr

    # -- fitting -----------------------------------------------------------

    def fit_transform(self, x: sp.spmatrix, n_iter: int = 10,
                      convergence_tol: Optional[float] = None,
                      checkpoint_path: Optional[str] = None,
                      resume: bool = False) -> torch.Tensor:
        """Alternating sweeps over items and users; returns the user
        embeddings (n_users, rank) as a tensor on the model's device."""
        if checkpoint_path is not None or resume:
            raise _not_ported("checkpoint_path/resume")
        if convergence_tol is None:
            convergence_tol = 0.005
        row_names, col_names = get_names(x, 0), get_names(x, 1)
        csr = self._prepare_input(x)
        n_users, n_items = csr.shape
        self._n_items = n_items
        self.item_ids = col_names
        self.user_ids = row_names

        self.global_bias = 0.0
        if self.with_global_bias:
            s = float(csr.data.sum())
            self.global_bias = s / (s + float(n_users) * float(n_items)
                                    - csr.nnz)
        incl = self.with_global_bias
        # items-as-rows buckets drive the item sweep, users-as-rows the user
        # sweep; the closing exact half-sweep uses the full user buckets
        hot_items, ui, ui_hot_rows = self._stage(csr, incl)
        hot_users, iu, iu_hot_rows = self._stage(csr.T.tocsr(), incl)
        ui_full = ui if hot_items is None else self._bucketize(csr, incl)
        #: what staging built, for logs and smoke runs
        self.stage_info = {
            "hot_items": 0 if hot_items is None else len(hot_items),
            "hot_users": 0 if hot_users is None else len(hot_users),
            "buckets_items": len(iu.buckets),
            "buckets_users": len(ui.buckets),
            "buckets_transform": len(ui_full.buckets)}
        logger.info("staged: %s", self.stage_info)
        nnz = max(csr.nnz, 1)

        # factor init (R/model_WRMF.R:203-255)
        U = self._rand(n_users)
        if self._init_components is not None:
            comp = np.asarray(self._init_components)
            if comp.shape != (self.rank, n_items):
                raise ValueError(
                    f"init must have shape ({self.rank}, {n_items})")
            V = torch.as_tensor(comp.T, dtype=self.dtype,
                                device=self.device).contiguous()
        elif self.solver == CONJUGATE_GRADIENT:
            V = torch.zeros((n_items, self.rank), dtype=self.dtype,
                            device=self.device)
        else:
            V = self._rand(n_items)

        cfg = self._cfg()
        lam, g = self.lambda_, self.global_bias
        loss_prev = math.inf
        self.loss_history = []
        self.fit_trace = FitTrace(self.device)
        for it in range(n_iter):
            with self.fit_trace.phase(it + 1, "items") as rec:
                V, loss = wrmf_sweep(U, V, iu.buckets, lam, g, cfg,
                                     hot_users, iu_hot_rows)
                rec["loss"] = loss = float(loss) / nnz
            logger.info("iter %d (items) loss = %.4f", it + 1, loss)
            with self.fit_trace.phase(it + 1, "users") as rec:
                U, loss = wrmf_sweep(V, U, ui.buckets, lam, g, cfg,
                                     hot_items, ui_hot_rows)
                rec["loss"] = loss = float(loss) / nnz
            logger.info("iter %d (users) loss = %.4f", it + 1, loss)
            self.loss_history.append(loss)
            if loss == 0.0 or loss_prev / loss - 1 < convergence_tol:
                logger.info("converged after %d iterations", it + 1)
                break
            loss_prev = loss

        self._V = V
        self.components = V.T.cpu().numpy()       # (R, n_items) public layout
        with self.fit_trace.phase(len(self.loss_history), "transform"):
            self._U = self._transform_buckets(ui_full, n_users)
        return self._U

    def _transform_buckets(self, ui: BucketedRows,
                           n_users: int) -> torch.Tensor:
        """User-side half-sweep from zero init with CG swapped for Cholesky
        (``avoid_cg``, reference R/model_WRMF.R:111-112,412-452).  The Gram
        of the item factors is rebuilt on every call: it is one small
        matmul, and no cache can go stale across refits."""
        tgt0 = torch.zeros((n_users, self.rank), dtype=self.dtype,
                           device=self.device)
        U, _ = wrmf_sweep(self._V, tgt0, ui.buckets, self.lambda_,
                          self.global_bias, self._cfg(solver=CHOLESKY))
        return U

    def transform(self, x: sp.spmatrix) -> torch.Tensor:
        """Project users onto the fixed item factors (one exact ALS
        half-step, reference R/model_WRMF.R:365-385)."""
        if self._V is None:
            raise RuntimeError("model is not fitted")
        if x.shape[1] != self._n_items:
            raise ValueError("column count mismatch with fitted model")
        csr = self._prepare_input(x)
        ui = self._bucketize(csr, self.with_global_bias)
        return self._transform_buckets(ui, csr.shape[0])
