"""WRMF: Weighted Regularized Matrix Factorization (iALS).

Port of ``rsparse_tpu/models/wrmf.py`` for one device: implicit and explicit
feedback, the conjugate-gradient, Cholesky and NNLS solvers (NNLS gives
NNMF), static or dynamic lambda, user/item and global biases, the dense
zipf-head split (``n_hot``) stored as float32, bfloat16 or uint8 codes
(``hot_dtype``), bf16 gathers and products with float32 sums
(``compute_dtype="bfloat16"``), bf16 factor tables (``precision=
"bfloat16"``), warm-start ``init``, ``convergence_tol``, and a fit state
written every ``checkpoint_every`` iterations that a later fit resumes.
Interactions are bucketed into padded (B, L) row blocks
(``sparse/device.py``); each ALS half-sweep solves the buckets one kernel
launch at a time (``ops/als.py``).  The alternating item/user sweeps mirror
the reference's fit loop (R/model_WRMF.R:318-338), and the fit ends with
the exact half-sweep that makes ``fit_transform(x)`` equal ``transform(x)``
(R/model_WRMF.R:355-359).

With ``with_user_item_bias`` the factor tables carry ``rank + 2`` columns:
users ``[1, emb..., u_bias]``, items ``[i_bias, emb..., 1]``, so
``components`` is ``(rank + 2, n_items)`` and a plain dot product scores
``i_bias + emb . emb + u_bias``.

On the card the factor width d (``rank``, or ``rank + 2`` with biases)
runs on hand-written kernels up to ``_kernels.MAX_D``: d <= 514 (rank 512
with both biases) for CG (K1), Cholesky (K2, which also runs
``transform`` and the closing half-sweep) and NNLS (K4); above it a solve
raises NotImplementedError naming ROADMAP.md.  CPU tensors take the plain
versions at any width.

Randomness comes from ``np.random.default_rng(seed)`` drawn in the same
order as the reference (U first; V only when the solver is not CG), so the
initial state matches it exactly.

On a mesh (``mesh=parallel.mesh.make_mesh(...)``, every rank calling
``fit_transform(x)`` with the same ``x`` and seed) each rank buckets and
solves only its slice of the rows, the factor tables are row-sharded over
a ``model`` axis between half-sweeps, and at the end every rank holds the
whole embeddings, ``components`` and ``loss_history``
(``parallel/wrmf_step.py``); ``routing="alx"`` / ``"alx_ragged"`` exchange
only the referenced source rows (``parallel/alx.py``).  The model then
runs on the mesh's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import accum_dtype, logger, resolve_dtype
from ..ops.als import (ALSConfig, CHOLESKY, CONJUGATE_GRADIENT, NNLS,
                       solver_code, wrmf_sweep)
from ..ops.bias_init import initialize_biases
from ..ops.solvers import SCD_MAX_ITER
from ..parallel.alx import ALXStage, alx_sweep, stage_alx
from ..parallel.mesh import Mesh, shard_buckets, shard_hot
from ..parallel.multihost import (data_spec, distributed_bucket_rows,
                                  is_multihost, process_row_range)
from ..parallel.wrmf_step import data_sweep, gather_factors, place_factors
from ..sparse.device import (BucketedRows, bucket_rows, hot_bucket_rows,
                             split_hot_cold)
from ..utils.profiling import FitTrace
from .base import MatrixFactorizationRecommender, get_names

#: rows per bucket are padded to a multiple of this (the reference's value
#: without a device mesh)
_ROW_ALIGN = 8


class _FitState:
    """Mid-fit WRMF checkpoint payload: the factor tables ``U`` and ``V``,
    the iterations done ``it``, ``loss_history``, the loss the next
    iteration is compared with ``loss_prev``, and ``global_bias``.  It is
    written through ``utils/checkpoint.py`` in the JAX package's layout
    (rsparse_tpu/models/wrmf.py:45-67), so each package resumes the
    other's fits."""


def _save_fit_state(path, U, V, it, loss_history, loss_prev, global_bias,
                    mesh=None):
    """Write the fit state; on a mesh rank 0 writes the whole tables it is
    given and every rank waits for it."""
    from ..utils import checkpoint
    if mesh is None or mesh.rank == 0:
        st = _FitState()
        st.U, st.V, st.it = U, V, int(it)
        st.loss_history = [float(v) for v in loss_history]
        st.loss_prev = float(loss_prev)
        st.global_bias = float(global_bias)
        checkpoint.save(st, path)
        logger.info("fit checkpoint written to %s (iteration %d)", path, it)
    if mesh is not None:
        mesh.world.barrier()


def _load_fit_state(path, device):
    """The fit state in ``path``, or None when there is none."""
    import os
    if not os.path.exists(os.path.join(path, "meta.json")):
        return None
    from ..utils import checkpoint
    return checkpoint.load(path, cls=_FitState, device=device)


def _check_mesh(mesh, routing, with_user_item_bias) -> None:
    """The constructor's mesh and routing checks (rsparse_tpu/models/
    wrmf.py:139-153, and alx_ragged on a ("dcn", "ici") mesh, which the
    JAX package only refuses at the first sweep)."""
    if routing not in (None, "alx", "alx_ragged"):
        raise ValueError(f"unknown routing {routing!r}")
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh must be a rsparse_tpu_torch.parallel.mesh.Mesh "
                "(parallel.mesh.make_mesh or parallel.multihost."
                f"make_multihost_mesh), not {type(mesh).__name__}")
        if not ("data" in mesh.axis_names
                or set(mesh.axis_names) == {"dcn", "ici"}):
            raise ValueError(
                "a WRMF mesh needs a 'data' axis (and optionally 'model'), or "
                f"exactly ('dcn', 'ici'); got {mesh.axis_names}")
    if routing is not None:
        if mesh is None:
            raise ValueError("routing='alx' requires a mesh with a 'data' "
                             "axis or both 'dcn' and 'ici'")
        if with_user_item_bias:
            raise ValueError("routing='alx' does not support per-entity "
                             "biases")
        if routing == "alx_ragged" and "data" not in mesh.axis_names:
            raise ValueError("routing='alx_ragged' takes a mesh with a "
                             "'data' axis; on a ('dcn', 'ici') mesh use "
                             "routing='alx'")


class WRMF(MatrixFactorizationRecommender):
    """Weighted ALS matrix factorization for implicit/explicit feedback."""

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
        nnls_max_iter: int = SCD_MAX_ITER,
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
        self.solver = solver_code(solver)
        self.non_negative = self.solver == NNLS
        if self.non_negative and with_global_bias:
            logger.warning("setting with_global_bias=False for 'nnls' solver")
            with_global_bias = False
        if hot_dtype not in ("auto", "uint8", "bfloat16", "float32"):
            raise ValueError(f"unknown hot_dtype {hot_dtype!r}")
        if hot_dtype == "uint8" and feedback != "implicit":
            raise ValueError("hot_dtype='uint8' requires implicit feedback "
                             "(quantized confidences must be positive)")
        _check_mesh(mesh, routing, with_user_item_bias)
        self.feedback = feedback
        self.with_user_item_bias = bool(with_user_item_bias)
        self.with_global_bias = with_global_bias
        self.rank = int(rank)
        #: width of the factor tables: rank, + 2 with user/item biases
        self._R = self.rank + (2 if self.with_user_item_bias else 0)
        self.lambda_ = float(lambda_)
        #: dynamic lambda scales lambda by nnz (explicit feedback only)
        self.dynamic_lambda = bool(dynamic_lambda)
        self.cg_steps = int(cg_steps)
        self.nnls_max_iter = int(nnls_max_iter)
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self.preprocess = preprocess or (lambda m: m)
        self._rng = np.random.default_rng(seed)
        self._init_components = init
        #: dense zipf-head split: the hottest columns of each sweep
        #: orientation go to a dense block read without per-nnz indices.
        #: 0 disables, an int fixes the head size, "auto" applies the
        #: reference's break-even rule (CG only)
        self.n_hot = n_hot
        #: dtype of the gathered rows and the products' operands ("float32"
        #: or "bfloat16": bf16 operands, float32 sums)
        self.compute_dtype = compute_dtype
        #: storage of the dense head: "auto" follows compute_dtype (else the
        #: factor dtype), "uint8" per-row quantised codes (implicit only)
        self.hot_dtype = hot_dtype
        #: a ``parallel.mesh.Mesh`` with a "data" axis (buckets split over
        #: it) and optionally "model" (tables row-sharded over it), or a
        #: ("dcn", "ici") mesh (each rank buckets its own rows); None runs
        #: in this process alone
        self.mesh = mesh
        #: "alx" / "alx_ragged": route only the referenced source rows to
        #: each rank by a static all-to-all plan (parallel/alx.py)
        self.routing = routing
        if mesh is not None:
            self.device = mesh.device
        self._V: Optional[torch.Tensor] = None   # (n_items, R) factors
        self._U: Optional[torch.Tensor] = None   # (n_users, R) factors
        #: nnz per user / per item of the last fit (float32): the explicit
        #: dynamic-lambda loss's weights, kept as the reference keeps them
        self._cnt_u: Optional[torch.Tensor] = None
        self._cnt_i: Optional[torch.Tensor] = None
        self._n_items: Optional[int] = None
        self.loss_history: list = []

    # -- helpers -----------------------------------------------------------

    def _cfg(self, bias_last_in_source: bool = False,
             solver: Optional[int] = None) -> ALSConfig:
        return ALSConfig(
            solver=self.solver if solver is None else solver,
            cg_steps=self.cg_steps,
            use_global_bias=(self.feedback == "implicit"
                             and self.with_global_bias
                             and not self.with_user_item_bias),
            feedback=self.feedback,
            with_biases=self.with_user_item_bias,
            bias_last_in_source=bias_last_in_source,
            dynamic_lambda=self.dynamic_lambda,
            nnls_max_iter=self.nnls_max_iter,
            compute_dtype=self.compute_dtype,
        )

    @property
    def _include_empty(self) -> bool:
        """Bucket empty rows too: the reference solves them with implicit
        feedback and biases or a global bias (wrmf_implicit.hpp:180)."""
        return self._cfg().solve_empty

    @property
    def _g(self) -> float:
        """The global bias the sweeps see (explicit feedback centres the
        matrix instead)."""
        return self.global_bias if self.feedback == "implicit" else 0.0

    @property
    def _w_dtype(self) -> torch.dtype:
        """Storage dtype of the dense head (rsparse_tpu/models/wrmf.py:
        396-400)."""
        if self.hot_dtype == "auto":
            return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                    else self.dtype)
        return {"uint8": torch.uint8, "bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.hot_dtype]

    # -- the mesh (rsparse_tpu/models/wrmf.py:188-265) ----------------------

    @property
    def _row_align(self) -> int:
        """Rows a bucket's batch is padded to: a multiple of 8 that the
        data axes' size divides."""
        if self.mesh is None:
            return _ROW_ALIGN
        n = self.mesh.axis_size(data_spec(self.mesh))
        return 8 * n if 8 % n else 8

    @property
    def _multihost(self) -> bool:
        return is_multihost(self.mesh)

    def _values_f32(self, br: BucketedRows) -> BucketedRows:
        """bf16 values (precision "bfloat16", as the reference stores them)
        held as the float32 they equal, which is what the kernels read."""
        if self.dtype != torch.bfloat16:
            return br
        return dataclasses.replace(br, buckets=tuple(
            b._replace(values=b.values.float()) for b in br.buckets))

    def _bucketize(self, csr, include_empty: bool):
        """Buckets of ``csr`` at the factor dtype.  On a mesh, this rank's
        slices of them (``BucketedRows`` with the global shape), or with
        ``routing`` the ``ALXStage`` of the routed sweep; on a ("dcn",
        "ici") mesh each rank buckets only its own row range."""
        mesh = self.mesh
        if mesh is None:
            return self._values_f32(bucket_rows(
                csr, self.dtype, self.device, include_empty=include_empty,
                row_align=_ROW_ALIGN))
        axis = data_spec(mesh)
        if self.routing is not None:
            br = self._values_f32(bucket_rows(
                csr, self.dtype, "cpu", include_empty=include_empty,
                row_align=self._row_align))
            return stage_alx(br, csr.shape[1], mesh, axis,
                             ragged=self.routing == "alx_ragged")
        if self._multihost:
            group = mesh.group(axis)
            lo, hi = process_row_range(csr.shape[0], group.size, group.rank)
            return self._values_f32(distributed_bucket_rows(
                sp.csr_matrix(csr)[lo:hi], lo, csr.shape[0], csr.shape[1],
                mesh, self.dtype, include_empty=include_empty))
        br = bucket_rows(csr, self.dtype, "cpu", include_empty=include_empty,
                         row_align=self._row_align)
        return self._values_f32(shard_buckets(br, mesh, axis))

    def _place_factors(self, arr: torch.Tensor) -> torch.Tensor:
        """This rank's share of a whole table (row-sharded over "model")."""
        if self.mesh is None:
            return arr
        return place_factors(self.mesh, arr)

    def _whole(self, arr: torch.Tensor, n_rows: int) -> torch.Tensor:
        if self.mesh is None:
            return arr
        return gather_factors(self.mesh, arr, n_rows)

    def _sweep(self, src, tgt, container, lam, g, cfg, hot_ids=None,
               hot_rows=None, src_cnt=None):
        """One half-sweep over ``container`` (``_bucketize``'s): the whole
        new target table and the loss."""
        if self.mesh is None:
            return wrmf_sweep(src, tgt, container.buckets, lam, g, cfg,
                              hot_ids, hot_rows, src_cnt)
        n_src, n_tgt = container.n_cols, container.n_rows
        if isinstance(container, ALXStage):
            return alx_sweep(self.mesh, self._whole(src, n_src),
                             self._whole(tgt, n_tgt), container, src_cnt,
                             lam, g, cfg)
        return data_sweep(self.mesh, src, tgt, container.buckets, n_src,
                          n_tgt, lam, g, cfg, hot_ids, hot_rows, src_cnt)

    def _resolve_n_hot(self, csr: sp.csr_matrix) -> int:
        """Head size for the dense zipf-head split of one sweep orientation
        (the reference's rule, rsparse_tpu/models/wrmf.py
        ``_resolve_n_hot``): none with per-entity biases; "auto" takes
        every column whose nnz count clears ``max(8, n_rows / (512 /
        w_bytes))`` with CG and none with the exact solvers, which pay
        ``B * H * d^2`` for the head's lhs; the width is capped by a 1 GB
        budget for the dense block and by 16384 / w_bytes."""
        if self.with_user_item_bias or self._multihost or self.routing:
            return 0
        if self.solver != CONJUGATE_GRADIENT and self.n_hot == "auto":
            return 0
        n_rows, n_cols = csr.shape
        # the reference's storage width: uint8 1, a bf16 head 2, else the
        # factor dtype's (rsparse_tpu/models/wrmf.py:300-309)
        if self.hot_dtype == "uint8":
            w_bytes = 1
        elif self._w_dtype == torch.bfloat16:
            w_bytes = 2
        else:
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
            hot, csr = split_hot_cold(
                csr, n_hot, self.dtype, self.device,
                with_presence=self.feedback == "explicit",
                w_dtype=self._w_dtype)
            if self.mesh is not None:
                hot = shard_hot(hot, self.mesh)
        br = self._bucketize(csr, include_empty or hot is not None)
        if hot is None:
            return None, br, None
        return hot.hot_ids, br, hot_bucket_rows(hot, br.buckets)

    def _rand(self, n: int) -> torch.Tensor:
        # N(0, 0.01) init, matching large_rand_matrix / flrnorm
        # (reference src/utils.cpp:131-143, R/model_WRMF.R:211)
        a = self._rng.standard_normal((n, self._R)) * 0.01
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _prepare_input(self, x: sp.spmatrix) -> sp.csr_matrix:
        csr = self.preprocess(sp.csr_matrix(x).astype(np.float64))
        if ((self.feedback == "implicit" or self.non_negative) and csr.nnz
                and csr.data.min() < 0):
            raise ValueError(
                "all values must be >= 0 for implicit feedback / nnls")
        return csr

    def _fit_matrix(self, x: sp.spmatrix):
        """The matrix the sweeps of a fit see, and the initial biases:
        (csr, user_bias or None, item_bias or None).  Sets
        ``global_bias``; explicit feedback with a global bias centres the
        values (reference R/model_WRMF.R, rsparse_tpu/models/wrmf.py:372-388)."""
        csr = self._prepare_input(x)
        n_users, n_items = csr.shape
        self.global_bias = 0.0
        if self.with_user_item_bias:
            g, user_bias, item_bias, csr = initialize_biases(
                csr, self.lambda_, self.dynamic_lambda, self.non_negative,
                self.with_global_bias, self.feedback == "explicit")
            if self.with_global_bias:
                self.global_bias = g
            return csr, user_bias, item_bias
        if self.with_global_bias:
            if self.feedback == "explicit":
                self.global_bias = float(csr.data.mean()) if csr.nnz else 0.0
                csr = csr.copy()
                csr.data = csr.data - self.global_bias
            else:
                s = float(csr.data.sum())
                self.global_bias = s / (s + float(n_users) * float(n_items)
                                        - csr.nnz)
        return csr, None, None

    # -- fitting -----------------------------------------------------------

    def fit_transform(self, x: sp.spmatrix, n_iter: int = 10,
                      convergence_tol: Optional[float] = None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 1,
                      resume: bool = False) -> torch.Tensor:
        """Alternating sweeps over items and users; returns the user
        embeddings (n_users, rank [+2 with biases]) as a tensor on the
        model's device.

        ``checkpoint_path``: a directory to write the fit state (factor
        tables, iterations done, loss history) to every
        ``checkpoint_every`` iterations.  ``resume=True`` starts from the
        state in ``checkpoint_path`` (the same ``x`` and hyperparameters
        assumed), or from scratch when there is none; the sweeps depend on
        (U, V) alone and sum in a fixed order, so the resumed fit is
        bitwise the uninterrupted one."""
        if resume and checkpoint_path is None:
            raise ValueError("resume=True requires checkpoint_path")
        if convergence_tol is None:
            convergence_tol = 0.005 if self.feedback == "implicit" else 0.001
        row_names, col_names = get_names(x, 0), get_names(x, 1)
        csr, user_bias, item_bias = self._fit_matrix(x)
        n_users, n_items = csr.shape
        self._n_items = n_items
        self.item_ids = col_names
        self.user_ids = row_names
        R = self._R
        incl = self._include_empty
        # items-as-rows buckets drive the item sweep, users-as-rows the user
        # sweep; the closing exact half-sweep uses the full user buckets
        csr_t = csr.T.tocsr()
        hot_items, ui, ui_hot_rows = self._stage(csr, incl)
        hot_users, iu, iu_hot_rows = self._stage(csr_t, incl)
        ui_full = ui if hot_items is None else self._bucketize(csr, incl)
        #: what staging built, for logs and smoke runs
        self.stage_info = {
            "hot_items": 0 if hot_items is None else len(hot_items),
            "hot_users": 0 if hot_users is None else len(hot_users),
            "buckets_items": len(iu.buckets),
            "buckets_users": len(ui.buckets),
            "buckets_transform": len(ui_full.buckets)}
        logger.info("staged: %s", self.stage_info)
        # nnz per user / per item, for the explicit dynamic-lambda loss
        cnt_u = torch.as_tensor(np.diff(csr.indptr), dtype=torch.float32,
                                device=self.device)
        cnt_i = torch.as_tensor(np.diff(csr_t.indptr), dtype=torch.float32,
                                device=self.device)
        self._cnt_u, self._cnt_i = cnt_u, cnt_i
        nnz = max(csr.nnz, 1)

        # factor init (R/model_WRMF.R:203-255)
        U = self._rand(n_users)
        if self._init_components is not None:
            comp = np.asarray(self._init_components)
            if comp.shape != (R, n_items):
                raise ValueError(f"init must have shape ({R}, {n_items})")
            V = torch.tensor(comp.T, dtype=self.dtype,
                             device=self.device).contiguous()
        elif self.solver == CONJUGATE_GRADIENT:
            V = torch.zeros((n_items, R), dtype=self.dtype,
                            device=self.device)
        else:
            V = self._rand(n_items)
        if self.non_negative:
            U, V = U.abs(), V.abs()
        if self.with_user_item_bias:
            # users = [1, emb..., u_bias]; items = [i_bias, emb..., 1]
            U[:, 0] = 1.0
            U[:, R - 1] = torch.as_tensor(user_bias, dtype=self.dtype)
            V[:, R - 1] = 1.0
            V[:, 0] = torch.as_tensor(item_bias, dtype=self.dtype)
        U, V = self._place_factors(U), self._place_factors(V)

        cfg_items = self._cfg(bias_last_in_source=True)
        cfg_users = self._cfg(bias_last_in_source=False)
        lam, g = self.lambda_, self._g
        loss_prev = math.inf
        self.loss_history = []
        self.fit_trace = FitTrace(self.device)
        start_iter = 0
        state = _load_fit_state(checkpoint_path, self.device) if resume else None
        if state is not None:
            U = self._place_factors(state.U.to(self.dtype))
            V = self._place_factors(state.V.to(self.dtype))
            start_iter = int(state.it)
            self.loss_history = list(state.loss_history)
            loss_prev = float(state.loss_prev)
            self.global_bias = float(state.global_bias)
            g = self._g
            logger.info("resumed fit from %s at iteration %d",
                        checkpoint_path, start_iter)
        for it in range(start_iter, n_iter):
            with self.fit_trace.phase(it + 1, "items") as rec:
                V, loss = self._sweep(U, V, iu, lam, g, cfg_items, hot_users,
                                      iu_hot_rows, cnt_u)
                V = self._place_factors(V)
                rec["loss"] = loss = float(loss) / nnz
            logger.info("iter %d (items) loss = %.4f", it + 1, loss)
            with self.fit_trace.phase(it + 1, "users") as rec:
                U, loss = self._sweep(V, U, ui, lam, g, cfg_users, hot_items,
                                      ui_hot_rows, cnt_i)
                U = self._place_factors(U)
                rec["loss"] = loss = float(loss) / nnz
            logger.info("iter %d (users) loss = %.4f", it + 1, loss)
            self.loss_history.append(loss)
            if checkpoint_path and (it + 1) % max(checkpoint_every, 1) == 0:
                # the resumed loop compares with THIS iteration's loss
                _save_fit_state(checkpoint_path, self._whole(U, n_users),
                                self._whole(V, n_items), it + 1,
                                self.loss_history, loss, self.global_bias,
                                self.mesh)
            if loss == 0.0 or loss_prev / loss - 1 < convergence_tol:
                logger.info("converged after %d iterations", it + 1)
                break
            loss_prev = loss

        self._set_items(self._whole(V, n_items))
        with self.fit_trace.phase(len(self.loss_history), "transform"):
            self._U = self._transform_buckets(ui_full, n_users)
        return self._U

    def _set_items(self, V: torch.Tensor) -> None:
        """Keep the item factors and their public (R, n_items) numpy view
        (float32 for a bf16 model: numpy has no bfloat16; exact)."""
        self._V = V
        self.components = V.T.to(accum_dtype(V.dtype)).cpu().numpy()

    def _transform_buckets(self, ui: BucketedRows,
                           n_users: int) -> torch.Tensor:
        """User-side half-sweep from zero init with CG swapped for Cholesky
        (``avoid_cg``, reference R/model_WRMF.R:111-112,412-452); NNLS stays
        NNLS.  The Gram of the item factors is rebuilt on every call: it is
        one small matmul, and no cache can go stale across refits.  The
        sweep's loss is not used, so no per-item counts are passed."""
        solver = CHOLESKY if self.solver == CONJUGATE_GRADIENT else self.solver
        tgt0 = torch.zeros((n_users, self._R), dtype=self.dtype,
                           device=self.device)
        U, _ = self._sweep(self._V, tgt0, ui, self.lambda_, self._g,
                           self._cfg(bias_last_in_source=False,
                                     solver=solver))
        return U

    def transform(self, x: sp.spmatrix) -> torch.Tensor:
        """Project users onto the fixed item factors (one exact ALS
        half-step, reference R/model_WRMF.R:365-385)."""
        if self._V is None:
            raise RuntimeError("model is not fitted")
        if x.shape[1] != self._n_items:
            raise ValueError("column count mismatch with fitted model")
        csr = self._prepare_input(x)
        if self.feedback == "explicit" and self.global_bias != 0.0:
            csr = csr.copy()
            csr.data = csr.data - self.global_bias
        ui = self._bucketize(csr, self._include_empty)
        return self._transform_buckets(ui, csr.shape[0])
