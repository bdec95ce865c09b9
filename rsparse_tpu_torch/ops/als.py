"""ALS half-sweep for WRMF, one nnz-bucket at a time.

Port of ``rsparse_tpu/ops/als.py``.  For every target row b of a bucket,
with the source rows it touches gathered as ``Xg = src[col_idx[b, :nnz_b]]``
and their values ``c`` (confidences, or ratings for explicit feedback):

    implicit  lhs  = XtX + Xg' diag(c - 1) Xg      (XtX holds the ridge)
              rhs  = Xg' (c - (c - 1)(x_bias + g)) + rhs_init
              loss = sum c (1 - g - x_bias - Xg y)^2 + lambda ||y||^2
    explicit  lhs  = Xg' Xg + lambda_use I         (observed entries only)
              rhs  = Xg' (r - x_bias)
              loss = sum (r - x_bias - Xg y)^2 + lambda_use ||y||^2

``lambda_use`` is lambda times the row's total nnz with dynamic lambda.
With per-entity biases the factor tables carry ``rank + 2`` columns, users
``[1, emb..., u_bias]`` and items ``[i_bias, emb..., 1]`` (reference
wrmf_implicit.hpp:96-101): a sweep solves the target's non-ones columns
against the source's non-bias columns (:func:`_active_slices`) and reads
the source's bias column as ``x_bias``.

With a dense zipf head (``sparse/device.py`` ``HotBlock``) the head
columns' entries add the same terms from the dense ``(B, H)`` weights;
explicit presence comes from the packed bits, so a stored 0.0 rating
enters the lhs and the loss.

``compute_dtype="bfloat16"`` (with float32 sums) gathers from a bf16 shadow
of the source table and rounds to bf16 where the reference does
(rsparse_tpu/ops/als.py:166-265, :296-373): the rhs weights, ``bf16(p)``
before each product, the matvec terms before their second product, the
head's ``Wc``, ``W1 = Wc - 1`` and ``Wc - W1 g``, the exact solvers' weighted
rows, and ``bf16(y)`` in the loss; every sum stays float32.  A uint8 head
(``hot_scale``) dequantises as ``code * scale`` in the compute dtype.

Three kernels solve a bucket on the card: K1 (``csrc/als_cg.cuh``) by CG,
K2 (``csrc/als_chol.cu``, ``als_chol_wide.cu``) by Cholesky and K4
(``csrc/als_nnls.cu``, ``als_nnls_wide.cu``) by NNLS coordinate descent; :func:`hot_chain` exposes K1's bf16 head term
alone.  :func:`_solve_bucket_implicit` and :func:`_solve_bucket_explicit`
are their plain PyTorch versions; the wrappers take them only for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import _kernels
from ..config import accum_dtype
from ..sparse.device import RowBucket
from .solvers import (CG_TOL, SCD_MAX_ITER, SCD_TOL, batched_cg,
                      batched_nnls, batched_spd_solve)
from .topk import _expand_bits

# Solver codes, mirroring reference inst/include/wrmf.hpp:16-18
CHOLESKY = 0
CONJUGATE_GRADIENT = 1
NNLS = 2

_SOLVER_CODES = {"cholesky": CHOLESKY, "conjugate_gradient": CONJUGATE_GRADIENT,
                 "nnls": NNLS}


@dataclass(frozen=True)
class ALSConfig:
    """Configuration of one ALS half-sweep."""

    solver: int                 # CHOLESKY | CONJUGATE_GRADIENT | NNLS
    cg_steps: int = 3
    #: implicit global bias (without per-entity biases)
    use_global_bias: bool = False
    feedback: str = "implicit"  # "implicit" | "explicit"
    with_biases: bool = False
    #: True when the *source* factor carries its bias in the last column
    #: (source = users, solving items); mirrors ``is_x_bias_last_row``
    #: (reference wrmf_implicit.hpp:96-101)
    bias_last_in_source: bool = True
    dynamic_lambda: bool = False
    nnls_max_iter: int = SCD_MAX_ITER
    #: dtype of the gathered rows and the products' operands: "bfloat16"
    #: rounds at the reference's points over float32 sums
    compute_dtype: str = "float32"

    @property
    def solve_empty(self) -> bool:
        """Solve rows with zero total nnz too (the reference does so with
        implicit feedback and biases or a global bias,
        wrmf_implicit.hpp:180); consulted on the hot/cold-split path, where
        bucket membership cannot tell an empty row from one whose entries
        all live in the hot block."""
        return self.feedback == "implicit" and (
            self.with_biases or self.use_global_bias)


def solver_code(name: str) -> int:
    try:
        return _SOLVER_CODES[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; one of {sorted(_SOLVER_CODES)}"
        ) from None


def _active_slices(cfg: ALSConfig, R: int):
    """Column slices: (source active columns, target solved columns).

    With biases the source drops its own bias column but keeps its ones
    column (which generates the target's bias coordinate), the batched form
    of ``drop_row`` (reference inst/include/wrmf_utils.hpp:4-10)."""
    if not cfg.with_biases:
        return slice(0, R), slice(0, R)
    if cfg.bias_last_in_source:
        # source = [1, emb..., bias], target = [bias, emb..., 1]
        return slice(0, R - 1), slice(0, R - 1)
    # source = [bias, emb..., 1], target = [1, emb..., bias]
    return slice(1, R), slice(1, R)


def hot_outer_table(Vh: torch.Tensor) -> torch.Tensor:
    """(H, d*d) outer products of the head's source rows."""
    H, d = Vh.shape
    return (Vh[:, :, None] * Vh[:, None, :]).reshape(H, d * d)


def _hot_lhs(w: torch.Tensor, Vh: torch.Tensor) -> torch.Tensor:
    """Dense-head lhs term ``sum_h w[b, h] Vh[h] Vh[h]'`` (plain version of
    K2's and K4's head term): one (B, H) x (H, d^2) matmul against the
    outer-product table.  w: (B, H); Vh: (H, d) -> (B, d, d)."""
    d = Vh.shape[1]
    return (w @ hot_outer_table(Vh)).reshape(w.shape[0], d, d)


def _rounds_bf16(cfg: ALSConfig, sdt: torch.dtype) -> bool:
    """Whether the solve rounds to bf16: ``compute_dtype="bfloat16"`` over
    float32 sums (the reference's ``gdt``, rsparse_tpu/ops/als.py:166)."""
    return cfg.compute_dtype == "bfloat16" and sdt == torch.float32


def _bf16_rounder(on: bool):
    """``t -> bf16(t)`` kept in ``t``'s dtype (a product of two rounded
    values is then exact in float32, as with ``preferred_element_type``),
    or the identity."""
    if not on:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(t.dtype)


def _gather_src(src_act: torch.Tensor, cfg: ALSConfig, sdt) -> torch.Tensor:
    """The table the buckets gather from: its bf16 shadow when the solve
    rounds (cast once per half-sweep, rsparse_tpu/ops/als.py:173), else
    ``src_act``."""
    return (src_act.to(torch.bfloat16).contiguous() if _rounds_bf16(cfg, sdt)
            else src_act)


def _hot_terms(hot_W, V_hot, hot_scale, rb, sdt):
    """The dense head's (Vh, Wc, W1) at ``sdt`` (rsparse_tpu/ops/als.py:
    203-208): Wc = W, or code * scale for a uint8 head, W1 = Wc - 1 where
    Wc > 0, each rounded by ``rb`` as the compute dtype rounds them."""
    Vh = rb(V_hot.to(sdt))
    Wc = rb(hot_W.to(sdt))
    if hot_scale is not None:
        Wc = rb(Wc * rb(hot_scale.to(sdt))[:, None])
    W1 = torch.where(Wc > 0, rb(Wc - 1.0), torch.zeros((), dtype=sdt,
                                                        device=Wc.device))
    return Vh, Wc, W1


def _exact_solve(lhs, rhs, x_init, cfg: ALSConfig, sweeps=None):
    """Cholesky or NNLS solve of a bucket's normal equations; ``sweeps``
    ((B,) int32, optional) receives the NNLS sweeps of each system."""
    if cfg.solver == NNLS:
        y, sw = batched_nnls(lhs, rhs, x_init.to(lhs.dtype),
                             max_iter=cfg.nnls_max_iter, return_sweeps=True)
        if sweeps is not None:
            sweeps.copy_(sw)
        return y
    return batched_spd_solve(lhs, rhs)


def _solve_bucket_implicit(
    src: torch.Tensor,                 # (n_src, d) active source columns
    x_biases: Optional[torch.Tensor],  # (n_src,) source biases or None
    XtX: torch.Tensor,                 # (d, d) incl. lambda ridge
    rhs_init: Optional[torch.Tensor],  # (d,) or None
    bucket: RowBucket,
    x_init: torch.Tensor,              # (B, d) warm start (CG, NNLS)
    lam: float,
    g: float,                          # global bias (0 when unused)
    cfg: ALSConfig,
    hot_W: Optional[torch.Tensor] = None,   # (B, H) dense hot confidences
    V_hot: Optional[torch.Tensor] = None,   # (H, d) hot source factors
    sweeps: Optional[torch.Tensor] = None,  # (B,) int32 NNLS sweeps out
    hot_scale: Optional[torch.Tensor] = None,  # (B,) uint8 head scale
    rounding: Optional[bool] = None,   # bf16 rounding (None: as cfg says)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1, K2 and K4 for implicit feedback: one bucket of
    per-entity solves.  ``rounding`` forces the compute dtype's bf16
    rounding on or off whatever ``XtX``'s dtype (a float64 twin of a bf16
    solve).  Returns (y (B, d), loss (B,))."""
    sdt = XtX.dtype
    rb = _bf16_rounder(_rounds_bf16(cfg, sdt) if rounding is None
                       else rounding)
    mask = bucket.mask()
    col = bucket.col_idx.long()
    Xg = rb(src[col].to(sdt))                                # (B, L, d)
    c = bucket.values.to(sdt)
    zero = torch.zeros((), dtype=sdt, device=c.device)
    cm = torch.where(mask, c, zero)
    cm1 = torch.where(mask, c - 1.0, zero)
    xb = None
    if cfg.with_biases:
        xb = x_biases.to(sdt)[col]                           # (B, L)
        offs = xb + g
    elif cfg.use_global_bias:
        offs = g
    else:
        offs = None

    c_eff = cm if offs is None else cm - cm1 * offs
    rhs = torch.einsum("bld,bl->bd", Xg, rb(c_eff))
    if rhs_init is not None:
        rhs = rhs + rhs_init[None, :]
    if hot_W is not None:
        Vh, Wc, W1 = _hot_terms(hot_W, V_hot, hot_scale, rb, sdt)
        ce_hot = (Wc if offs is None
                  else rb(Wc - rb(W1 * rb(torch.tensor(g, dtype=sdt)))))
        rhs = rhs + ce_hot @ Vh

    if cfg.solver == CONJUGATE_GRADIENT:
        def matvec(p):
            pb = rb(p)
            t = rb(torch.einsum("bld,bd->bl", Xg, pb) * cm1)
            out = p @ XtX + torch.einsum("bl,bld->bd", t, Xg)
            if hot_W is not None:
                out = out + rb(rb(pb @ Vh.T) * W1) @ Vh
            return out
        y = batched_cg(matvec, rhs, x_init.to(sdt), cfg.cg_steps)
    else:
        lhs = XtX[None] + torch.einsum("bld,ble->bde",
                                       rb(Xg * cm1[..., None]), Xg)
        if hot_W is not None:
            lhs = lhs + _hot_lhs(W1, Vh)
        y = _exact_solve(lhs, rhs, x_init, cfg, sweeps)

    yb = rb(y)
    pred = torch.einsum("bld,bd->bl", Xg, yb)
    base = 1.0 - pred
    if cfg.use_global_bias:
        base = base - g
    if xb is not None:
        base = base - xb
    loss = (cm * base * base).sum(-1) + lam * (y * y).sum(-1)
    if hot_W is not None:
        pred_h = yb @ Vh.T
        base_h = (1.0 - g) - pred_h if cfg.use_global_bias else 1.0 - pred_h
        loss = loss + (Wc * base_h * base_h).sum(-1)
    return y, loss


def _solve_bucket_explicit(
    src: torch.Tensor,                 # (n_src, d) active source columns
    x_biases: Optional[torch.Tensor],  # (n_src,) source biases or None
    bucket: RowBucket,
    x_init: torch.Tensor,              # (B, d) warm start (CG, NNLS)
    lam: float,
    cfg: ALSConfig,
    hot_W: Optional[torch.Tensor] = None,     # (B, H) ratings, 0 = absent
    V_hot: Optional[torch.Tensor] = None,     # (H, d)
    hot_bits: Optional[torch.Tensor] = None,  # (B, ceil(H/8)) presence
    nnz_total: Optional[torch.Tensor] = None,  # (B,) hot + cold row nnz
    sweeps: Optional[torch.Tensor] = None,    # (B,) int32 NNLS sweeps out
    rounding: Optional[bool] = None,   # bf16 rounding (None: as cfg says)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1, K2 and K4 for explicit feedback: one bucket of
    observed-entries-only solves (reference
    inst/include/wrmf_explicit.hpp:34-132).  Returns (y (B, d),
    loss (B,))."""
    sdt = accum_dtype(src.dtype)
    rb = _bf16_rounder(_rounds_bf16(cfg, sdt) if rounding is None
                       else rounding)
    mask = bucket.mask()
    col = bucket.col_idx.long()
    Xg = rb(src[col].to(sdt))                                # (B, L, d)
    zero = torch.zeros((), dtype=sdt, device=Xg.device)
    conf = torch.where(mask, bucket.values.to(sdt), zero)
    if cfg.with_biases:
        conf = conf - torch.where(mask, x_biases.to(sdt)[col], zero)

    nnz = (bucket.nnz if nnz_total is None else nnz_total).to(sdt)
    lam_use = lam * nnz if cfg.dynamic_lambda else torch.full_like(nnz, lam)

    rhs = torch.einsum("bld,bl->bd", Xg, rb(conf))
    if hot_W is not None:
        Vh = rb(V_hot.to(sdt))
        Wraw = hot_W.to(sdt)
        Wv = rb(Wraw)
        H = Wv.shape[1]
        Mh = (_expand_bits(hot_bits)[:, :H] if hot_bits is not None
              else Wv != 0)
        # absent cells hold 0 and present zero ratings add nothing either
        rhs = rhs + Wv @ Vh

    if cfg.solver == CONJUGATE_GRADIENT:
        def matvec(p):
            pb = rb(p)
            t = torch.where(mask, torch.einsum("bld,bd->bl", Xg, pb), zero)
            out = torch.einsum("bl,bld->bd", rb(t), Xg) + lam_use[:, None] * p
            if hot_W is not None:
                out = out + rb(torch.where(Mh, pb @ Vh.T, zero)) @ Vh
            return out
        y = batched_cg(matvec, rhs, x_init.to(sdt), cfg.cg_steps)
    else:
        d = Xg.shape[-1]
        eye = torch.eye(d, dtype=sdt, device=Xg.device)[None]
        Xgm = torch.where(mask[..., None], Xg, zero)
        lhs = torch.einsum("bld,ble->bde", Xgm, Xgm)
        if hot_W is not None:
            lhs = lhs + _hot_lhs(Mh.to(sdt), Vh)
        lhs = lhs + lam_use[:, None, None] * eye
        # keep padding rows nonsingular (their solutions are discarded)
        invalid = (bucket.nnz == 0) & (lam_use == 0)
        lhs = lhs + invalid[:, None, None] * eye
        y = _exact_solve(lhs, rhs, x_init, cfg, sweeps)

    yb = rb(y)
    pred = torch.einsum("bld,bd->bl", Xg, yb)
    diff = conf - torch.where(mask, pred, zero)
    loss = (diff * diff).sum(-1) + lam_use * (y * y).sum(-1)
    if hot_W is not None:
        diff_h = torch.where(Mh, Wraw - yb @ Vh.T, zero)
        loss = loss + (diff_h * diff_h).sum(-1)
    return y, loss


def _solve_bucket_plain(src, x_biases, XtX, rhs_init, bucket, x_init, lam, g,
                        cfg: ALSConfig, hot_W=None, V_hot=None, hot_bits=None,
                        nnz_total=None, sweeps=None, hot_scale=None,
                        rounding=None):
    """The plain version of whichever kernel ``cfg`` selects."""
    if cfg.feedback == "implicit":
        return _solve_bucket_implicit(src, x_biases, XtX, rhs_init, bucket,
                                      x_init, lam, g, cfg, hot_W, V_hot,
                                      sweeps, hot_scale, rounding)
    return _solve_bucket_explicit(src, x_biases, bucket, x_init, lam, cfg,
                                  hot_W, V_hot, hot_bits, nnz_total, sweeps,
                                  rounding)


#: BucketArgs.w_kind of each head storage dtype
_W_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _bucket_args(src, x_biases, XtX, rhs_init, bucket, x_init, lam, g,
                 cfg: ALSConfig, hot_W, V_hot, hot_bits, nnz_total,
                 hot_scale=None, kernel: str = "als_cg"):
    """Validate a bucket's CUDA inputs for ``kernel`` (``als_cg``,
    ``als_chol`` or ``als_nnls``); return (BucketArgs, y, loss) with the
    outputs allocated.  The source table and the head's rows are read as
    float32 or bfloat16 (with ``compute_dtype="bfloat16"`` a float32 table
    is cast to its shadow first); the head as float32, bfloat16 or uint8
    codes with their (B,) ``hot_scale``.  Raises on what the kernel does
    not take, NotImplementedError above its width (``_kernels.MAX_D``)."""
    d = src.shape[1]
    if d > _kernels.MAX_D[kernel]:
        raise NotImplementedError(
            f"the CUDA kernel {kernel} takes d <= {_kernels.MAX_D[kernel]}, "
            f"got {d} (see ROADMAP.md)")
    B, L = bucket.batch, bucket.pad_len
    f32, i32 = torch.float32, torch.int32
    n_src = src.shape[0]
    round_bf16 = _rounds_bf16(cfg, f32)
    if round_bf16:
        src = src.to(torch.bfloat16)
    tdt = src.dtype if src.dtype == torch.bfloat16 else f32
    _kernels.check_tensor("src", src, (n_src, d), tdt)
    _kernels.check_tensor("col_idx", bucket.col_idx, (B, L), i32)
    _kernels.check_tensor("values", bucket.values, (B, L), f32)
    _kernels.check_tensor("nnz", bucket.nnz, (B,), i32)
    explicit = cfg.feedback == "explicit"
    if explicit:
        XtX = rhs_init = None
    else:
        _kernels.check_tensor("XtX", XtX, (d, d), f32)
        if rhs_init is not None:
            _kernels.check_tensor("rhs_init", rhs_init, (d,), f32)
    if not cfg.with_biases:
        x_biases = None
    elif x_biases is not None:
        _kernels.check_tensor("x_biases", x_biases, (n_src,), f32)
    if x_init is not None:
        _kernels.check_tensor("x_init", x_init, (B, d), f32)
    H, w_kind = 0, 0
    if hot_W is not None:
        H = hot_W.shape[1]
        w_kind = _W_KIND.get(hot_W.dtype)
        if w_kind is None:
            raise TypeError(f"hot_W: dtype {hot_W.dtype} is not supported by "
                            "the CUDA kernel (float32, bfloat16 or uint8)")
        _kernels.check_tensor("hot_W", hot_W, (B, H), hot_W.dtype)
        V_hot = V_hot.to(tdt)
        _kernels.check_tensor("V_hot", V_hot, (H, d), tdt)
        if hot_bits is not None:
            _kernels.check_tensor("hot_bits", hot_bits, (B, -(-H // 8)),
                                  torch.uint8)
        if (hot_scale is not None) != (hot_W.dtype == torch.uint8):
            raise ValueError("hot_scale is given exactly with uint8 hot_W")
        if hot_scale is not None:
            hot_scale = hot_scale.to(f32)
            _kernels.check_tensor("hot_scale", hot_scale, (B,), f32)
    if not (explicit and hot_W is not None):
        hot_bits = None
    if nnz_total is not None:
        _kernels.check_tensor("nnz_total", nnz_total, (B,), i32)
    y = torch.empty((B, d), dtype=f32, device=src.device)
    loss = torch.empty((B,), dtype=f32, device=src.device)
    if explicit:
        g_rhs = g_loss = 0.0
    else:
        g_rhs = float(g) if (cfg.with_biases or cfg.use_global_bias) else 0.0
        g_loss = float(g) if cfg.use_global_bias else 0.0
    p = _kernels.ptr
    args = _kernels.BucketArgs(
        V=p(src), xbias=p(x_biases), col=p(bucket.col_idx),
        val=p(bucket.values), nnz=p(bucket.nnz), nnz_total=p(nnz_total),
        XtX=p(XtX), rhs_init=p(rhs_init), W=p(hot_W), Vh=p(V_hot),
        bits=p(hot_bits), x0=p(x_init), y=p(y), loss=p(loss),
        w_scale=p(hot_scale), B=B, L=L, d=d, H=H, explicit_fb=int(explicit),
        dynamic_lambda=int(cfg.dynamic_lambda),
        table_bf16=int(tdt == torch.bfloat16), w_kind=w_kind,
        round_bf16=int(round_bf16), lam=float(lam), g_rhs=g_rhs,
        g_loss=g_loss)
    # the tensors the struct points into (casts made here included) must
    # outlive the launch: they ride along with the outputs
    args._keep = (src, V_hot, hot_scale)
    return args, y, loss


#: K1's layout (csrc/als_cg.cuh): warps a CTA, rows of a tile product,
#: head columns a panel, and the bounds of the sparse head cells a warp
#: keeps (what shared memory leaves)
CG_WARPS, CG_TILE, CG_PANEL = 32, 16, 64
CG_CACHE_MIN, CG_CACHE_MAX = 160, 1024
#: the widest d of K1's and K2's narrow instances (csrc/als_cg.cuh
#: kNarrow, csrc/als_chol.cu): above it K1 runs CG_WIDE_WARPS warps a CTA,
#: sizes the tile's vectors to its rows and walks every head cell (no tile
#: products: a 64-row panel of Vh is 132 KB at d = 512), and K2 keeps the
#: factor in a cluster's shared memory (csrc/als_chol_wide.cu)
WIDE_D, CG_WIDE_WARPS = 160, 16
#: K1's tau at the wide widths: no panel is a tile product
CG_TAU_WIDE = 1 << 30
#: present cells (of a tile's rows in one panel: 1,024 at most) from which
#: K1 takes the panel as a tensor-core tile product, by the products'
#: route: where the tile products (a fixed cost a panel) overtake the walk
#: (a cost a cell) on the H100, at about 72% present at 3xTF32, 75% at
#: 2xTF32 and 42% on bf16 mma (PERF.md; chip_smoke.py phases 2 and 9 time
#: both sides); sparser panels are walked cell by cell, panels without one
#: are skipped
CG_TAU = {"3xTF32": 736, "2xTF32": 768, "bf16 mma": 432}
#: fewest cold entries a warp's share of a row may hold when a row is split
#: over the CTAs of a cluster
CG_MIN_SLICE = 64
#: :func:`cg_split`'s costs, in a warp's round trips: the fixed work of a
#: pass (barriers, P XtX, the CG scalars) and a cluster's exchange; fitted
#: to K1's times under every plan on each bucket of the ML-20M-shaped fit
#: (NVIDIA H100, PERF.md)
CG_PASS_COST, CG_CLUSTER_COST = 16, 16
#: shared memory a CTA may use on the H100 (bytes)
SMEM_LIMIT = 232_448


def cg_layout(d: int, H: int, tbytes: int, cluster: int,
              rows: int = CG_TILE) -> Tuple[int, int]:
    """(shared bytes, sparse head cells a warp keeps) of one K1 CTA
    (``make_layout`` in ``csrc/als_cg.cuh``, which ``rsp_als_cg_layout``
    reports; ``tests/test_torch_wide_als.py`` and ``chip_smoke.py`` hold
    the two equal).  ``rows`` (target rows a CTA) sizes the tile's vectors
    at d > ``WIDE_D`` only."""
    up = lambda n: (n + 15) & ~15  # noqa: E731
    wide = d > WIDE_D
    nw = CG_WIDE_WARPS if wide else CG_WARPS
    vr = rows if wide else CG_TILE
    Dk = -(-d // 16) * 16
    sp = Dk + 4
    sv = Dk + 4 if tbytes == 4 else Dk + 8
    npan = -(-H // CG_PANEL)
    vec = vr * sp * 4
    head = H > 0
    tiles = head and not wide
    parts = [vec] * 5 + [
        nw * sp * 4,
        CG_TILE * (CG_PANEL + 4) * 4 if tiles else 0,
        CG_PANEL * sv * tbytes if tiles else 0,
        CG_PANEL * sv * tbytes if tiles else 0,
        vec if cluster > 1 else 0, vec if cluster > 1 else 0,
        CG_TILE * 4, CG_TILE * 4, (nw + 8) * CG_TILE * 4,
        CG_TILE * 8 * 4, npan * 4, npan * 4, npan * 4, 16]
    o = sum(up(n) for n in parts)
    cache = 0
    if head:
        cache = ((SMEM_LIMIT - o) // (nw * 8)) & ~31
        cache = min(max(cache, CG_CACHE_MIN), CG_CACHE_MAX)
    return o + 2 * up(nw * cache * 4), cache


def cg_smem_bytes(d: int, H: int, tbytes: int, cluster: int,
                  rows: int = CG_TILE) -> int:
    """Shared bytes of one K1 CTA (:func:`cg_layout`)."""
    return cg_layout(d, H, tbytes, cluster, rows)[0]


def _cg_walk(L: int, units: int) -> int:
    """Round trips (four source rows loaded at once) of the busiest of
    ``units`` warps taking a row of L entries in chunks of 32 dealt round
    robin: unit 0, whose last chunk may be the row's short one."""
    n = -(-L // 32)
    k = -(-n // units)
    trips = 8 * k
    if (n - 1) % units == 0:
        trips -= 8 - (-(-(L - 32 * (n - 1)) // 4))
    return trips


def cg_split(B: int, L: int, active, H: int = 0,
             warps: int = CG_WARPS) -> Tuple[int, int]:
    """K1's split of a bucket of B rows padded to L entries, with a dense
    head of H columns, over CTAs of ``warps`` warps (``CG_WIDE_WARPS`` at
    d > ``WIDE_D``): (target rows a CTA, CTAs a cluster).  ``active`` maps
    a cluster size (1, 2, 4, 8, 16), or a pair (rows, cluster size) where
    the layout depends on the rows (the wide instances), to the clusters
    of that size the card runs at once (0 or absent: that size cannot run,
    or its layout does not fit a CTA's shared memory).  A row's
    entries are dealt in chunks of 32 to the ``warps`` / rows warps of each
    CTA of its cluster, and its head panels likewise, so every (rows,
    cluster) is costed as its waves (whole while they are few) times a
    warp's round trips in a pass: the busiest warp's walk (:func:`_cg_walk`),
    a quarter of its share of the head's panels (the first pass scans them
    four at a time), ``CG_PASS_COST`` for the pass's fixed work and, in a
    cluster, ``CG_CLUSTER_COST`` for the exchange; a row is split over a
    cluster only while each warp keeps ``CG_MIN_SLICE`` entries.  The
    cheapest within 5% wins, the most rows a CTA first (they share the
    head's tile products), then the smallest cluster."""
    npan = -(-H // CG_PANEL)
    options = []
    for rows in (16, 8, 4, 2, 1):
        tiles = -(-B // rows)
        wpr = warps // rows
        for cs in (1, 2, 4, 8, 16):
            n = int(active.get((rows, cs), active.get(cs, 0)))
            if n <= 0 or (cs > 1 and L < CG_MIN_SLICE * wpr * cs):
                continue
            waves = tiles / n if tiles >= 4 * n else -(-tiles // n)
            trips = (CG_PASS_COST + (CG_CLUSTER_COST if cs > 1 else 0)
                     + _cg_walk(L, wpr * cs) + npan / (4 * wpr * cs))
            options.append((waves * trips, rows, cs))
    if not options:
        raise RuntimeError("als_cg: the card runs no K1 launch")
    best = min(o[0] for o in options)
    _, rows, cs = max((o for o in options if o[0] <= 1.05 * best),
                      key=lambda o: (o[1], -o[2]))
    return rows, cs


_CG_INFO: dict = {}


def _cg_info(args) -> dict:
    """The driver's answer for K1 at a bucket's width, table and head
    (cached): shared bytes, CTAs an SM, clusters of each size at once (at
    d > ``WIDE_D``, whose layout depends on the rows a CTA, keyed by (rows,
    cluster size), shared bytes and CTAs an SM at 16 rows)."""
    key = (args.d, args.H if args.W else 0, args.table_bf16,
           args.explicit_fb, bool(args.xbias))
    if key not in _CG_INFO:
        wide = args.d > WIDE_D
        active = {}
        for rows in ((16, 8, 4, 2, 1) if wide else (CG_TILE,)):
            info = (ctypes.c_int * 7)()
            rc = _kernels.lib().rsp_als_cg_info(ctypes.byref(args), rows,
                                                info)
            _kernels.check(rc, "als_cg")
            if rows == CG_TILE:
                smem, per_sm = info[0], info[1]
            for k in range(5):
                active[(rows, 1 << k) if wide else 1 << k] = info[2 + k]
        _CG_INFO[key] = dict(smem_bytes=smem, ctas_per_sm=per_sm,
                             active=active)
    return _CG_INFO[key]


def _cg_route(args) -> str:
    """The route of K1's tile products (head panels, P XtX) for a bucket
    (at d > ``WIDE_D`` only P XtX: the head is walked)."""
    return ("bf16 mma" if args.round_bf16 else
            "2xTF32" if args.table_bf16 else "3xTF32")


def _cg_launch_plan(args, L: int) -> "_kernels.CgPlan":
    """K1's launch for a bucket padded to L entries: :func:`cg_split` on
    the driver's cluster occupancy, and ``CG_TAU`` of its route."""
    info = _cg_info(args)
    wide = args.d > WIDE_D
    rows, cs = cg_split(args.B, L, info["active"], args.H if args.W else 0,
                        CG_WIDE_WARPS if wide else CG_WARPS)
    return _kernels.CgPlan(rows=rows, cluster=cs,
                           tau=CG_TAU_WIDE if wide else CG_TAU[_cg_route(args)])


def _launch_cg(args, y, loss, plan, cg_steps: int, device):
    """Launch K1 on the bucket in ``args`` (:func:`_bucket_args`, whose
    outputs are y and loss) as ``plan`` says."""
    rc = _kernels.lib().rsp_als_cg(
        ctypes.byref(args), ctypes.byref(plan), ctypes.c_int(cg_steps),
        ctypes.c_float(CG_TOL), _kernels.stream(device))
    _kernels.check(rc, "als_cg")
    _kernels.launches["als_cg_wide" if args.d > WIDE_D else "als_cg"] += 1
    return y, loss


def cg_head_panels(hot_W, hot_bits, rows: int, cluster: int,
                   tau: int) -> dict:
    """How K1 takes a bucket's dense head (counted here with torch, as the
    kernel counts it): panels of ``CG_PANEL`` columns a tile of ``rows``
    rows, and of those the tile products (at least ``tau`` present cells),
    the sparse ones and the empty ones, summed over the tiles."""
    if hot_W is None:
        return dict(panels=0, dense_panels=0, sparse_panels=0,
                    sparse_cells=0)
    B, H = hot_W.shape
    pres = (_expand_bits(hot_bits)[:, :H] if hot_bits is not None
            else hot_W != 0)
    npan, tiles = -(-H // CG_PANEL), -(-B // rows)
    pres = torch.nn.functional.pad(pres, (0, npan * CG_PANEL - H, 0,
                                          tiles * rows - B))
    cnt = pres.reshape(tiles, rows, npan, CG_PANEL).sum((1, 3))
    sparse = (cnt > 0) & (cnt < tau)
    return dict(panels=tiles * npan, dense_panels=int((cnt >= tau).sum()),
                sparse_panels=int(sparse.sum()),
                sparse_cells=int((cnt * sparse).sum()))


def cg_plan(src, x_biases, XtX, rhs_init, bucket, x_init, lam, g,
            cfg: ALSConfig, hot_W=None, V_hot=None, hot_bits=None,
            nnz_total=None, hot_scale=None) -> dict:
    """How K1 runs a bucket on the card (nothing is launched): rows a CTA,
    CTAs a cluster, the shared bytes a CTA and the sparse head cells a warp
    keeps (:func:`cg_layout`, held to the driver's count), CTAs an SM, the
    head's panels by kind (:func:`cg_head_panels`) and the tile products'
    route."""
    args, _, _ = _bucket_args(src, x_biases, XtX, rhs_init, bucket, x_init,
                              lam, g, cfg, hot_W, V_hot, hot_bits, nnz_total,
                              hot_scale)
    info = _cg_info(args)
    pl = _cg_launch_plan(args, bucket.pad_len)
    route = _cg_route(args)
    tb = 2 if args.table_bf16 else 4
    Hh = args.H if args.W else 0
    smem, cache = cg_layout(args.d, Hh, tb, pl.cluster, pl.rows)
    c_cache = ctypes.c_int(0)
    c_smem = _kernels.lib().rsp_als_cg_layout(args.d, Hh, tb, pl.cluster,
                                              pl.rows, ctypes.byref(c_cache))
    if (smem, cache) != (c_smem, c_cache.value):
        raise RuntimeError(f"als_cg: the host's layout ({smem} B, {cache} "
                           f"cells) is not the card's ({c_smem} B, "
                           f"{c_cache.value} cells)")
    return dict(rows=pl.rows, cluster=pl.cluster, tau=pl.tau, route=route,
                smem_bytes=smem, cache=cache,
                ctas_per_sm=info["ctas_per_sm"], active=info["active"],
                **cg_head_panels(hot_W, hot_bits if cfg.feedback ==
                                 "explicit" else None, pl.rows, pl.cluster,
                                 pl.tau))


def solve_bucket_cg(src, x_biases, XtX, rhs_init, bucket, x_init, lam, g,
                    cfg: ALSConfig, hot_W=None, V_hot=None, hot_bits=None,
                    nnz_total=None, hot_scale=None):
    """K1: one bucket of CG solves (``csrc/als_cg.cu``), launched as
    :func:`cg_split` splits the bucket's shape (at d > ``WIDE_D`` on the
    wide instances: 16 warps a CTA, every head cell walked).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Returns (y (B, d), loss (B,))."""
    if src.device.type == "cpu":
        return _solve_bucket_plain(src, x_biases, XtX, rhs_init, bucket,
                                   x_init, lam, g, cfg, hot_W, V_hot,
                                   hot_bits, nnz_total, hot_scale=hot_scale)
    args, y, loss = _bucket_args(src, x_biases, XtX, rhs_init, bucket,
                                 x_init, lam, g, cfg, hot_W, V_hot, hot_bits,
                                 nnz_total, hot_scale)
    return _launch_cg(args, y, loss, _cg_launch_plan(args, bucket.pad_len),
                      cfg.cg_steps, src.device)


def solve_bucket_cholesky(src, x_biases, XtX, rhs_init, bucket, x_init, lam,
                          g, cfg: ALSConfig, hot_W=None, V_hot=None,
                          hot_bits=None, nnz_total=None, hot_scale=None,
                          stages: int = 3):
    """K2: one bucket of exact Cholesky solves (``csrc/als_chol.cu``, the
    factor in shared memory; at d > ``WIDE_D`` ``csrc/als_chol_wide.cu``,
    the factor across a cluster's shared memory, :func:`chol_wide_layout`);
    ``x_init`` is not read.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.  Returns (y (B, d), loss (B,)).

    ``stages`` other than 3 stops the kernel early, for timing its parts:
    1 after the Gram (y and loss are left unwritten), 2 after the solve (no
    loss); at d > ``WIDE_D`` also 4, after the factorisation (nothing
    written)."""
    if src.device.type == "cpu":
        return _solve_bucket_plain(src, x_biases, XtX, rhs_init, bucket,
                                   x_init, lam, g, cfg, hot_W, V_hot,
                                   hot_bits, nnz_total, hot_scale=hot_scale)
    args, y, loss = _bucket_args(src, x_biases, XtX, rhs_init, bucket, None,
                                 lam, g, cfg, hot_W, V_hot, hot_bits,
                                 nnz_total, hot_scale, kernel="als_chol")
    lib = _kernels.lib()
    wide = args.d > WIDE_D
    if stages not in ((1, 2, 3, 4) if wide else (1, 2, 3)):
        raise ValueError(f"stages={stages} (K2 at d = {args.d})")
    fn = lib.rsp_als_chol_wide if wide else lib.rsp_als_chol
    rc = fn(ctypes.byref(args), int(stages), _kernels.stream(src.device))
    _kernels.check(rc, "als_chol")
    _kernels.launches["als_chol_wide" if wide else "als_chol"] += 1
    return y, loss


#: K2's Gram routes (csrc/als_chol.cu Route)
CHOL_ROUTES = ("bf16 mma", "bf16 mma, both ways", "2xTF32", "3xTF32")


def cholesky_plan(src, x_biases, XtX, rhs_init, bucket, x_init, lam, g,
                  cfg: ALSConfig, hot_W=None, V_hot=None, hot_bits=None,
                  nnz_total=None, hot_scale=None) -> dict:
    """How K2 runs a bucket on the card (nothing is launched): CTAs an SM
    (at d > ``WIDE_D``: clusters at once and CTAs a cluster, one row a
    cluster, the floats of the largest CTA's panels, the kernel's width and
    table bytes), the Gram route of the cold and of the head entries, the
    padded width D and the shared bytes a CTA."""
    args, _, _ = _bucket_args(src, x_biases, XtX, rhs_init, bucket, None,
                              lam, g, cfg, hot_W, V_hot, hot_bits, nnz_total,
                              hot_scale, kernel="als_chol")
    info = _chol_info(args)
    wide = args.d > WIDE_D
    out = dict(ctas_per_sm=1 if wide else info[0],
               cold_route=CHOL_ROUTES[info[1]],
               head_route=CHOL_ROUTES[info[2]], D=info[3],
               smem_bytes=info[4], wide=wide)
    if wide:
        out.update(clusters=info[0], cluster=info[5],
                   panel_floats=info[6], d=args.d,
                   table_bytes=2 if args.table_bf16 else 4)
    return out


def _chol_info(args) -> list:
    """K2's info for a bucket (``rsp_als_chol_info``, or at d >
    ``WIDE_D`` ``rsp_als_chol_wide_info``: clusters at once in place of
    CTAs an SM, then CTAs a cluster and the largest CTA's panel floats)."""
    wide = args.d > WIDE_D
    info = (ctypes.c_int * (7 if wide else 5))()
    fn = (_kernels.lib().rsp_als_chol_wide_info if wide
          else _kernels.lib().rsp_als_chol_info)
    _kernels.check(fn(ctypes.byref(args), info), "als_chol")
    return list(info)


#: the wide K2's cluster sizes by width (csrc/als_chol_wide.cu
#: cluster_size: CTAs a row, the smallest that fits), the sizes a bucket of
#: few long rows may take (kSizes, bucket_plan), its warps a CTA (kWarpsW),
#: the Gram tiles a warp holds at most (kMaxWarpTiles) and its panels' rows
CHOL_CLUSTERS, CHOL_SIZES = (1, 2, 4), (1, 2, 4, 6, 8)
CHOL_WARPS, CHOL_WARP_TILES, CHOL_PANEL = 16, 18, 16
#: K2's entry list and chunk (csrc/als_chol.cuh kSeg, kRows)
CHOL_SEG, CHOL_ROWS = 1024, 16


def chol_panel_owner(p: int, n_panels: int, cluster: int) -> int:
    """The CTA of the wide K2's cluster of ``cluster`` CTAs that holds
    16-row panel ``p``: panels are dealt from the last (widest) down,
    ``cluster`` a round, the direction turning each round
    (csrc/als_chol_wide.cu panel_owner)."""
    i = n_panels - 1 - p
    rnd, pos = divmod(i, cluster)
    return cluster - 1 - pos if rnd % 2 else pos


def chol_panel_lda(p: int) -> int:
    """Row stride (floats) of panel ``p``: its 16 (p + 1) columns padded to
    8 mod 32."""
    return 16 * (p + 1) + (8 if p % 2 else 24)


def _chol_cluster_layout(d: int, tbytes: int, cluster: int) -> dict:
    """csrc/als_chol_wide.cu make_wide_layout at one cluster size."""
    D = -(-d // CHOL_PANEL) * CHOL_PANEL
    n_p = D // CHOL_PANEL
    owner = [chol_panel_owner(p, n_p, cluster) for p in range(n_p)]
    floats = [sum(CHOL_PANEL * chol_panel_lda(p) for p in range(n_p)
                  if owner[p] == c) for c in range(cluster)]
    tiles = [sum(2 * (p + 1) for p in range(n_p) if owner[p] == c)
             for c in range(cluster)]
    w = 4 * ((d * tbytes + 30) // 16)
    w += (8 - w) % 32
    rows = CHOL_ROWS if tbytes == 2 else CHOL_ROWS // 2
    # the staging buffers, which also hold a step's column block copy
    stage = max(2 * rows * 4 * w, 64 * (D - CHOL_PANEL))
    panels = stage + CHOL_SEG * 12 + ((2 * CHOL_ROWS * 4 + 65 * 4 + 15) & ~15)
    n_max = -(-514 // CHOL_PANEL)
    extra = panels + 4 * max(floats)
    nbytes = extra + 4 * (3 * (CHOL_PANEL * CHOL_PANEL + 2 * CHOL_PANEL)
                          + 4 * D + n_max * CHOL_PANEL + 36 + 3 * n_max)
    nbytes = ((nbytes + 15) & ~15) + 16     # the back substitution's mbarrier
    return dict(D=D, panels=n_p, cluster=cluster, owner=owner,
                floats=floats, tiles=tiles, rows=rows, smem_bytes=nbytes)


def chol_wide_layout(d: int, tbytes: int) -> dict:
    """The wide K2's cluster layout at width ``d`` and table bytes
    ``tbytes``, as csrc/als_chol_wide.cu cluster_size and make_wide_layout
    choose it (a bucket of few long rows may take a larger cluster of
    ``CHOL_SIZES``: :func:`cholesky_plan` says which): the smallest
    cluster of ``CHOL_CLUSTERS`` whose CTA fits
    ``SMEM_LIMIT`` and whose warps hold at most ``CHOL_WARP_TILES`` Gram
    tiles; D, the panels, each panel's owner, the floats and Gram tiles of
    each CTA's panels, the entries staged a chunk, and the shared bytes a
    CTA (two staging buffers, also a factorisation step's column block
    copy, the entry list, the largest CTA's panels, the diagonal slots and
    vectors, the back substitution's mbarrier)."""
    for cluster in CHOL_CLUSTERS:
        L = _chol_cluster_layout(d, tbytes, cluster)
        if (L["smem_bytes"] <= SMEM_LIMIT
                and max(L["tiles"]) <= CHOL_WARP_TILES * CHOL_WARPS):
            return L
    return L


#: largest scratch K4's build stage writes for its sweeps (packed G and mu,
#: 33.5 KB a system at d = 128; at d > ``WIDE_D`` G and mu, 1.07 MB a
#: system at d = 514, and the lhs and rhs of a sub-slice of
#: ``NNLS_LHS_SUB`` systems): a bucket with more systems is built and
#: swept in slices
NNLS_SCRATCH_BYTES = 1 << 30
#: the wide K4's G tile, the rows of G a sweep warp's ring holds and the
#: rows it copies on one mbarrier, and the systems whose lhs the scratch
#: holds at once (csrc/als_nnls_wide.cu kGT, kRing, kChunk, kLhsSub)
NNLS_G_TILE, NNLS_RING, NNLS_CHUNK, NNLS_LHS_SUB = 64, 16, 4, 128


def nnls_inflight(d: int) -> int:
    """Systems K4's sweep stage holds at once on one SM at width d (one
    warp each; shared memory bounds it, and at d > ``WIDE_D`` the wide
    kernel's kPerSm)."""
    n = _kernels.lib().rsp_als_nnls_inflight(d)
    if n <= 0:
        raise RuntimeError(f"als_nnls occupancy query failed: CUDA error {-n}")
    return n


def nnls_wide_layout(d: int, tbytes: int) -> dict:
    """The wide K4's work at width ``d`` (160 < d <= 514) and table bytes
    ``tbytes``, as csrc/als_nnls_wide.cu lays it out: the build's CTAs a
    system and their panels (the wide K2's :func:`chol_wide_layout`: each
    CTA sums and writes its own 16-row panels of the lhs), the row stride
    ``ds`` of lhs and G in the scratch (d rounded up to 8 floats), the
    floats of one system of a slice there (``stride``: G, then mu at float
    ``offsets["mu"]``) and of one system of the lhs sub-slice after the
    slice (the same: lhs, then rhs at ``offsets["rhs"]``), the systems a
    sub-slice holds at most, G's lower 64 x 64 tiles a system and the
    shared bytes of a sweep warp (its chunks' mbarriers, 128 bytes, and the
    ring of G rows it streams)."""
    ds = (d + 7) & ~7
    nt = -(-d // NNLS_G_TILE)
    chol = chol_wide_layout(d, tbytes)
    return dict(d=d, ds=ds, stride=d * ds + ds, sub=NNLS_LHS_SUB,
                offsets=dict(G=0, mu=d * ds, lhs=0, rhs=d * ds),
                cluster=chol["cluster"], owner=chol["owner"],
                panels=chol["panels"], smem_bytes=chol["smem_bytes"],
                g_tiles=nt * (nt + 1) // 2,
                ring_bytes=128 + 4 * NNLS_RING * ds)


def nnls_plan(src, x_biases, XtX, rhs_init, bucket, x_init, lam, g,
              cfg: ALSConfig, hot_W=None, V_hot=None, hot_bits=None,
              nnz_total=None, hot_scale=None) -> dict:
    """How the wide K4 (d > ``WIDE_D``) runs a bucket on the card
    (``rsp_als_nnls_wide_info``; nothing is launched): the build's CTAs a
    system and shared bytes a CTA, its passes (2 where bf16-rounded
    implicit rows make the lhs non-symmetric), G's tiles a system, the row
    stride, the sweeping warps an SM, the ring's shared bytes and the
    systems an lhs sub-slice holds."""
    args, _, _ = _bucket_args(src, x_biases, XtX, rhs_init, bucket, None,
                              lam, g, cfg, hot_W, V_hot, hot_bits, nnz_total,
                              hot_scale, kernel="als_nnls")
    info = (ctypes.c_int * 8)()
    _kernels.check(_kernels.lib().rsp_als_nnls_wide_info(
        ctypes.byref(args), info), "als_nnls")
    return dict(cluster=info[0], smem_bytes=info[1], passes=info[2],
                g_tiles=info[3], ds=info[4], per_sm=info[5],
                ring_bytes=info[6], sub=info[7], d=args.d,
                table_bytes=2 if args.table_bf16 else 4)


def nnls_scratch(d: int, B: int) -> Tuple[int, int]:
    """(floats of K4's scratch a system of a slice, floats after the
    slice) for a bucket of B systems at width d (``rsp_als_nnls_stride``,
    ``rsp_als_nnls_extra``: at d > ``WIDE_D`` the lhs sub-slice)."""
    lib = _kernels.lib()
    stride, extra = lib.rsp_als_nnls_stride(d), lib.rsp_als_nnls_extra(d, B)
    if stride <= 0 or extra < 0:
        _kernels.check(-min(stride, extra), "als_nnls")
    return stride, extra


def _launch_nnls(args, max_iter: int, sweeps, device, stages: int = 5):
    """K4 on a validated bucket (:func:`_bucket_args`), its scratch a slice
    of the bucket's systems at a time (and at d > ``WIDE_D`` an lhs
    sub-slice), at most ``NNLS_SCRATCH_BYTES`` in all, at least one system.
    At d > ``WIDE_D`` ``stages`` < 5 stops each slice after the wide
    kernel's build (1), G (2), mu (3) or sweeps (4), and runs no loss
    (timings)."""
    lib = _kernels.lib()
    stride, extra = nnls_scratch(args.d, args.B)
    per = max(1, min(args.B, (NNLS_SCRATCH_BYTES - 4 * extra)
                     // (4 * stride)))
    scratch = torch.empty((per * stride + extra,), dtype=torch.float32,
                          device=device)
    counter = torch.empty((1,), dtype=torch.int32, device=device)
    common = (ctypes.byref(args), ctypes.c_int(max_iter),
              ctypes.c_float(SCD_TOL), _kernels.ptr(sweeps),
              _kernels.ptr(scratch), per, _kernels.ptr(counter))
    if stages == 5:
        rc = lib.rsp_als_nnls(*common, _kernels.stream(device))
    else:
        rc = lib.rsp_als_nnls_wide_staged(*common, stages,
                                          _kernels.stream(device))
    _kernels.check(rc, "als_nnls")


def solve_bucket_nnls(src, x_biases, XtX, rhs_init, bucket, x_init, lam, g,
                      cfg: ALSConfig, hot_W=None, V_hot=None, hot_bits=None,
                      nnz_total=None, sweeps=None, hot_scale=None):
    """K4: one bucket of non-negative solves by coordinate descent
    (``csrc/als_nnls.cu``: the normal equations and G built per system,
    then the sweeps one warp per system, then the loss; at d > ``WIDE_D``
    ``csrc/als_nnls_wide.cu``: the lhs built over the wide K2's panels, G
    in float64 tiles, mu, the sweeps streaming G's rows from device memory,
    the loss).  ``sweeps`` ((B,) int32, optional) receives the sweeps each
    system ran.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.  Returns (y (B, d), loss (B,))."""
    if src.device.type == "cpu":
        return _solve_bucket_plain(src, x_biases, XtX, rhs_init, bucket,
                                   x_init, lam, g, cfg, hot_W, V_hot,
                                   hot_bits, nnz_total, sweeps, hot_scale)
    args, y, loss = _bucket_args(src, x_biases, XtX, rhs_init, bucket,
                                 x_init, lam, g, cfg, hot_W, V_hot, hot_bits,
                                 nnz_total, hot_scale, kernel="als_nnls")
    if sweeps is not None:
        _kernels.check_tensor("sweeps", sweeps, (bucket.batch,), torch.int32)
    _launch_nnls(args, cfg.nnls_max_iter, sweeps, src.device)
    _kernels.launches["als_nnls_wide" if args.d > WIDE_D
                      else "als_nnls"] += 1
    return y, loss


def _hot_chain_plain(W, Vh, p=None, g=None, scale=None,
                     sdt=torch.float32):
    """Plain version of :func:`hot_chain`: the dense-head terms of the bf16
    implicit solve, sums at ``sdt`` (float32; float64 gives a twin with the
    same roundings; rsparse_tpu/ops/als.py:203-225, the chain of
    scripts/exp_bisect3.py ``ka`` -> ``kd``)."""
    rb = _bf16_rounder(True)
    Vb, Wc, W1 = _hot_terms(W, Vh, scale, rb, sdt)
    if p is not None:
        return rb(rb(rb(p.to(sdt)) @ Vb.T) * W1) @ Vb
    return rb(Wc - rb(W1 * rb(torch.tensor(g, dtype=sdt)))) @ Vb


#: widest Vh rsp_hot_chain is built for (the probe's d = 128)
HOT_CHAIN_MAX_D = 128


def hot_chain(W, Vh, p=None, g=None, scale=None) -> torch.Tensor:
    """K1's bf16 dense-head term alone (``rsp_hot_chain`` in
    ``csrc/als_cg.cu``, the same device code K1 runs), the counterpart of
    the Pallas probe scripts/exp_bisect3.py: with ``p`` ((B, d)) the CG
    matvec term ``bf16(bf16(bf16(p) Vh') * W1) Vh`` (``kc``), else with
    ``g`` the rhs term ``bf16(Wc - bf16(W1 bf16(g))) Vh`` (``kd``); ``W``
    (B, H) float32, bfloat16 or uint8 codes with (B,) ``scale``, ``Vh``
    (H, d), d <= ``HOT_CHAIN_MAX_D``.  The head's panels are taken as K1
    takes them on bf16 mma (``CG_TAU["bf16 mma"]``: the present cells from
    which a panel of 16 rows is a tile product).  Returns (B, d) float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if (p is None) == (g is None):
        raise ValueError("give exactly one of p (matvec term) and g (rhs)")
    if W.device.type == "cpu":
        return _hot_chain_plain(W, Vh, p, g, scale)
    B, H = W.shape
    d = Vh.shape[1]
    bf16, f32 = torch.bfloat16, torch.float32
    if d > HOT_CHAIN_MAX_D:
        raise NotImplementedError(f"hot_chain takes d <= {HOT_CHAIN_MAX_D}")
    w_kind = _W_KIND.get(W.dtype)
    if w_kind is None:
        raise TypeError(f"W: dtype {W.dtype} is not supported")
    _kernels.check_tensor("W", W, (B, H), W.dtype)
    Vh = Vh.to(bf16).contiguous()
    if (scale is not None) != (W.dtype == torch.uint8):
        raise ValueError("scale is given exactly with uint8 W")
    if scale is not None:
        scale = scale.to(f32).contiguous()
        _kernels.check_tensor("scale", scale, (B,), f32)
    if p is not None:
        _kernels.check_tensor("p", p, (B, d), f32)
    out = torch.empty((B, d), dtype=f32, device=W.device)
    q = _kernels.ptr
    args = _kernels.BucketArgs(
        W=q(W), Vh=q(Vh), x0=q(p), y=q(out), w_scale=q(scale), B=B, d=d,
        H=H, table_bf16=1, w_kind=w_kind, round_bf16=1,
        g_rhs=0.0 if g is None else float(g))
    plan = _kernels.CgPlan(rows=CG_TILE, cluster=1, tau=CG_TAU["bf16 mma"])
    rc = _kernels.lib().rsp_hot_chain(ctypes.byref(args), ctypes.byref(plan),
                                      ctypes.c_int(int(p is not None)),
                                      _kernels.stream(W.device))
    _kernels.check(rc, "hot_chain")
    _kernels.launches["hot_chain"] += 1
    return out


_SOLVE = {CONJUGATE_GRADIENT: solve_bucket_cg, CHOLESKY: solve_bucket_cholesky,
          NNLS: solve_bucket_nnls}


def _check_hot_supported(hot_ids, cfg: ALSConfig):
    """The reference's rule (rsparse_tpu/ops/als.py:376-380): every solver
    takes the dense head, per-entity biases do not."""
    if hot_ids is not None and cfg.with_biases:
        raise NotImplementedError(
            "hot/cold split does not support per-entity biases")


def _rows_of(t: torch.Tensor, group) -> torch.Tensor:
    """This member's contiguous share of ``t``'s rows (``ceil(n / size)``
    a member, the last one short), or all of them without a group."""
    if group is None:
        return t
    per = -(-t.shape[0] // group.size)
    lo = min(group.rank * per, t.shape[0])
    return t[lo:lo + per]


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's members (``t`` itself without one)."""
    return t if group is None else group.all_reduce(t)


def _sweep_prepare(src, lam, g, cfg: ALSConfig, sdt, group=None):
    """The sweep-invariant terms: (active source columns, contiguous;
    source biases or None; XtX Gram with the lambda ridge, implicit only;
    rhs_init or None).  With a ``group`` (``parallel/mesh.py``
    ``AxisGroup``) each member sums the Gram and rhs_init over its share of
    the source rows and the partial sums are all-reduced."""
    R = src.shape[1]
    src_sl, _ = _active_slices(cfg, R)
    src_act = src[:, src_sl].contiguous()
    x_biases = None
    if cfg.with_biases:
        x_biases = src[:, R - 1 if cfg.bias_last_in_source else 0].to(
            sdt).contiguous()
    if cfg.feedback != "implicit":
        # explicit feedback builds per-entity Grams from the gathered rows
        # only (wrmf_explicit.hpp:74-78)
        return src_act, x_biases, None, None
    s = _rows_of(src_act.to(sdt), group)
    XtX = _summed(s.T @ s, group) + lam * torch.eye(
        s.shape[1], dtype=sdt, device=s.device)
    rhs_init = None
    if cfg.with_biases:
        xb = _rows_of(x_biases.to(sdt), group)
        rhs_init = -_summed(s.T @ (xb + g), group)
    elif cfg.use_global_bias:
        rhs_init = -g * _summed(s.sum(0), group)
    return src_act, x_biases, XtX, rhs_init


def _src_reg_loss(src, src_cnt, lam, cfg: ALSConfig, sdt, group=None):
    """Final lambda * ||learned source params||^2 term (reference
    wrmf_implicit.hpp:286-303, wrmf_explicit.hpp:147-172); with a
    ``group``, summed over each member's share of the rows, then
    all-reduced."""
    R = src.shape[1]
    if cfg.with_biases:
        excl = slice(1, R) if cfg.bias_last_in_source else slice(0, R - 1)
        s = _rows_of(src[:, excl], group).to(sdt)
    else:
        s = _rows_of(src, group).to(sdt)
    if cfg.feedback == "explicit" and cfg.dynamic_lambda:
        if src_cnt is None:
            return torch.zeros((), dtype=sdt, device=src.device)
        cnt = _rows_of(src_cnt, group).to(sdt)
        return lam * _summed(((s * s).sum(1) * cnt).sum(), group)
    return lam * _summed((s * s).sum(), group)


def _assemble_target(result_act, cfg: ALSConfig):
    """Re-attach the target's ones column to its solved columns."""
    if not cfg.with_biases:
        return result_act
    ones = torch.ones((result_act.shape[0], 1), dtype=result_act.dtype,
                      device=result_act.device)
    if cfg.bias_last_in_source:   # the target's ones column is last
        return torch.cat([result_act, ones], dim=1)
    return torch.cat([ones, result_act], dim=1)


def _gather_solved(result: torch.Tensor, buckets, group) -> torch.Tensor:
    """Every member's solved rows in one table: each member's rows of
    ``result`` (its buckets' row ids, padding on the sentinel row) are
    all-gathered over ``group`` and written into zeros, so rows outside
    every bucket stay 0 as on one process."""
    ids = (torch.cat([b.row_ids for b in buckets]).long() if buckets
           else torch.zeros((0,), dtype=torch.long, device=result.device))
    out = torch.zeros_like(result)
    out[group.all_gather(ids)] = group.all_gather(result[ids])
    return out


def _solve_scatter(result, src_act, x_biases, XtX, rhs_init, bucket, old_act,
                   lam, g, n_tgt: int, cfg: ALSConfig, V_hot=None,
                   hot_pre=None):
    """One bucket: gather the warm start, solve, scatter into ``result``
    (updated in place, so a sweep holds one output table; a bf16 table
    rounds the solutions there).  Returns the bucket's loss over its valid
    rows."""
    ids = bucket.row_ids.clamp(max=n_tgt - 1).long()
    valid = bucket.row_ids < n_tgt
    hot_W = hot_bits = nnz_total = hot_scale = None
    if hot_pre is not None:
        hot_W, hot_bits, row_nnz, hot_scale = hot_pre
        if cfg.feedback == "explicit" and cfg.dynamic_lambda:
            nnz_total = row_nnz
        if not cfg.solve_empty:
            # rows with zero TOTAL nnz keep the excluded-row semantics (y=0)
            valid = valid & (row_nnz > 0)
    x0 = old_act[ids].to(accum_dtype(old_act.dtype)).contiguous()
    y, le = _SOLVE[cfg.solver](src_act, x_biases, XtX, rhs_init, bucket, x0,
                               lam, g, cfg, hot_W, V_hot, hot_bits, nnz_total,
                               hot_scale=hot_scale)
    y = torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype,
                                                   device=y.device))
    result[bucket.row_ids.long()] = y.to(result.dtype)
    return torch.where(valid, le, torch.zeros((), dtype=le.dtype,
                                              device=le.device)).sum()


def wrmf_sweep(
    src: torch.Tensor,                 # (n_src, R) source factors
    tgt_old: torch.Tensor,             # (n_tgt, R) previous target factors
    buckets: Tuple[RowBucket, ...],    # target rows over source columns
    lam: float,
    g: float,
    cfg: ALSConfig,
    hot_ids: Optional[torch.Tensor] = None,  # (H,) dense zipf-head columns
    hot_rows=None,                     # hot_bucket_rows(...) for buckets
    src_cnt: Optional[torch.Tensor] = None,  # (n_src,) nnz counts
    group=None,                        # parallel/mesh.py AxisGroup
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ALS half-sweep: re-solve every target entity given fixed sources.

    Returns (new target factors (n_tgt, R), summed un-normalised loss).
    ``src_cnt`` weighs the source regulariser of explicit dynamic lambda;
    without it that term is left out of the loss.  With a ``group`` (the
    data axis of a mesh) ``buckets`` are this member's slices: the Gram,
    rhs_init and the source regulariser are partial sums over its share of
    the source rows, and the loss and the solved rows are combined over the
    group, so every member returns the whole table and loss.
    Mirrors one call of ``private$solver`` in the reference fit loop
    (R/model_WRMF.R:318-338).  The Gram and rhs_init come from ``src`` as
    it is; with ``compute_dtype="bfloat16"`` the buckets and the head
    gather from its bf16 shadow.
    """
    n_tgt, R = tgt_old.shape
    sdt = accum_dtype(src.dtype)
    _check_hot_supported(hot_ids, cfg)
    src_act, x_biases, XtX, rhs_init = _sweep_prepare(src, lam, g, cfg, sdt,
                                                      group)
    src_act = _gather_src(src_act, cfg, sdt)
    _, tgt_sl = _active_slices(cfg, R)
    old_act = tgt_old[:, tgt_sl]
    d = src_act.shape[1]
    V_hot = None if hot_ids is None else src_act[hot_ids.long()].contiguous()
    result = torch.zeros((n_tgt + 1, d), dtype=src.dtype, device=src.device)
    loss = torch.zeros((), dtype=sdt, device=src.device)
    for bi, bucket in enumerate(buckets):
        loss = loss + _solve_scatter(
            result, src_act, x_biases, XtX, rhs_init, bucket, old_act, lam, g,
            n_tgt, cfg, V_hot, None if hot_rows is None else hot_rows[bi])
    if group is not None:
        loss = group.all_reduce(loss)
        result = _gather_solved(result, buckets, group)
    tgt_new = _assemble_target(result[:n_tgt], cfg)
    return tgt_new, loss + _src_reg_loss(src, src_cnt, lam, cfg, sdt, group)
