"""Second-order Factorization Machine.

Port of ``rsparse_tpu/models/fm.py`` (reference
R/model_FactorizationMachine.R:22-182 over
src/factorization_machine.cpp:8-194).  Rows go in the reference's padded
``(B, L)`` blocks (``ops/segsum.py``); each block is one deterministic
update from the block-start tables with accumulator-first AdaGrad factored
per feature.  On the card one block is K8 (``csrc/fm.cu``: rows, then the
block's entries grouped by feature, :func:`k8_plan`);
:func:`_fm_block_plain` is its plain PyTorch version, which CPU tensors
take.

Per-sample math matches the reference:
  pred = w0 + sum w_j x_j + 0.5 * sum_f [(sum v_fj x_j)^2 - sum (v_fj x_j)^2]
  binomial (y in +-1): dL = (sigmoid(pred*y) - 1) * y       (:138-139)
  gaussian:            dL = 2 * (pred - y)                  (:140-141)
  grad_w_j = clip(x_j dL + 2 lambda_w);  AdaGrad, acc init 1
  grad_v_j = clip(dL x_j (s1 - v_j x_j) + 2 lambda_v v_j);  AdaGrad
Gradients are clipped at +-100 (CLIP_VALUE, src/rsparse.h:19).  A feature's
update is ``-lr * sum(g) / sqrt(acc + sum(g^2))`` with ``acc += sum(g^2)``.

One difference from the reference: a block made only of empty rows still
takes the intercept step (the reference returns early there and skips it,
rsparse_tpu/models/fm.py:67-70; ROADMAP.md queue 3).

The tables are updated in place.  On the card K8 takes float32 and a rank
of at most ``MAX_RANK``: ``precision="double"`` runs on the CPU only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import _kernels
from ..config import resolve_full_dtype
from ..ops.segsum import GLMBlock, staged_glm_blocks, staged_label_gathers

CLIP_VALUE = 100.0
#: widest factor table K8 takes (csrc/fm.cu kMaxR)
MAX_RANK = 128
#: warps a CTA in K8's launches (csrc/fm.cu kWarps)
K8_WARPS = 8
#: entries a tile of K8's feature walk (csrc/fm.cu kTile, launch B): a
#: feature with more entries than a tile holds is summed by every tile it
#: runs over and finished by launch C.  Chosen by ``kernel_times.py
#: k8-tiles`` (PERF.md)
K8_TILE = 128


def k8_plan(B: int, N: int, r: int) -> dict:
    """K8's launch for a block of B rows holding N valid entries at rank r:
    ``tpe`` lanes an entry (its components across them), ``G`` lanes a row
    in launch A (tpe times the mean row length, both rounded up to powers
    of two, at most 32: short rows share a warp), launch A's CTAs
    (``n_part``), launch B's tiles of K8_TILE entries, and the float32
    scratch the wrapper allocates (rows, A's partials, the tiles' head and
    tail sums and their owners)."""
    tpe = min(1 << (r - 1).bit_length(), 32)
    per_row = -(-N // B) if B else 0
    G = min(32, tpe * (1 << max(per_row - 1, 0).bit_length()))
    n_part = -(-B // (K8_WARPS * (32 // G)))
    n_tiles = -(-N // K8_TILE)
    scratch = B * (r + 1) + 2 * n_part + n_tiles * (2 * (2 + 2 * r) + 1)
    return dict(tpe=tpe, G=G, n_part=n_part, n_tiles=n_tiles,
                scratch=scratch)


def _fm_block_plain(w0, acc_w0, w, v, acc_w, acc_v, blk: GLMBlock, y,
                    sample_w, lr_w, lr_v, lam_w, lam_v, family: int,
                    intercept: bool, do_update: bool):
    """Plain version of K8 (rsparse_tpu/models/fm.py:39): gathers the
    snapshot, computes every entry's clipped gradients, sums them per slot,
    then applies accumulator-first AdaGrad at ``feats`` (and to w0).
    Returns the (B,) predictions."""
    col = blk.col_idx.long()
    x = blk.values
    wg, vg = w[col], v[col]                              # (B, L), (B, L, r)
    vx = vg * x[..., None]
    s1 = vx.sum(1)                                       # (B, r)
    raw = (w0 + (wg * x).sum(1)
           + 0.5 * ((s1 * s1).sum(1) - (vx * vx).sum((1, 2))))
    y_hat = torch.sigmoid(raw) if family == 1 else raw
    if not do_update:
        return y_hat
    if family == 1:
        dL = (torch.sigmoid(raw * y) - 1.0) * y
    else:
        dL = 2.0 * (raw - y)
    dL = dL * sample_w
    if intercept:
        acc_w0 += (dL * dL).sum()
        w0 -= lr_w * dL.sum() / torch.sqrt(acc_w0)
    m = blk.mask()
    d = dL[:, None].expand_as(x)[m]                      # (N,)
    xm, vm = x[m], vg[m]                                 # (N,), (N, r)
    g_w = torch.clamp(xm * d + 2.0 * lam_w, -CLIP_VALUE, CLIP_VALUE)
    s1m = s1[:, None, :].expand_as(vg)[m]
    g_v = torch.clamp(d[:, None] * xm[:, None] * (s1m - vm * xm[:, None])
                      + 2.0 * lam_v * vm, -CLIP_VALUE, CLIP_VALUE)
    U, r = blk.feats.shape[0], v.shape[1]
    slot = blk.slot[m].long()
    sw = torch.zeros((U + 1, 2), dtype=w.dtype, device=w.device)
    sv = torch.zeros((U + 1, 2, r), dtype=w.dtype, device=w.device)
    sw.index_add_(0, slot, torch.stack([g_w, g_w * g_w], 1))
    sv.index_add_(0, slot, torch.stack([g_v, g_v * g_v], 1))
    feats = blk.feats.long()
    aw = acc_w[feats] + sw[:U, 1]
    w.index_add_(0, feats, -lr_w * sw[:U, 0] / torch.sqrt(aw))
    acc_w.index_add_(0, feats, sw[:U, 1])
    av = acc_v[feats] + sv[:U, 1]
    v.index_add_(0, feats, -lr_v * sv[:U, 0] / torch.sqrt(av))
    acc_v.index_add_(0, feats, sv[:U, 1])
    return y_hat


def _fm_block_cuda(w0, acc_w0, w, v, acc_w, acc_v, blk: GLMBlock, y,
                   sample_w, lr_w, lr_v, lam_w, lam_v, family: int,
                   intercept: bool, do_update: bool):
    B, L = blk.col_idx.shape
    U, r, N = blk.feats.shape[0], v.shape[1], blk.order.shape[0]
    if r > MAX_RANK:
        raise ValueError(f"FM rank {r}: the CUDA kernel takes at most "
                         f"{MAX_RANK}")
    f32 = torch.float32
    F1 = w.shape[0]
    for name, t, shape in (("w0", w0, ()), ("acc_w0", acc_w0, ()),
                           ("w", w, (F1,)), ("acc_w", acc_w, (F1,)),
                           ("v", v, (F1, r)), ("acc_v", acc_v, (F1, r)),
                           ("values", blk.values, (B, L)), ("y", y, (B,)),
                           ("sample_w", sample_w, (B,))):
        _kernels.check_tensor(name, t, shape, f32)
    for name, t, shape in (("col_idx", blk.col_idx, (B, L)),
                           ("nnz", blk.nnz, (B,)), ("slot", blk.slot, (B, L)),
                           ("feats", blk.feats, (U,)), ("order", blk.order,
                                                        (N,)),
                           ("offs", blk.offs, (U + 1,))):
        _kernels.check_tensor(name, t, shape, torch.int32)
    dev = w.device
    y_hat = torch.empty((B,), dtype=f32, device=dev)
    if B == 0:
        return y_hat
    plan = k8_plan(B, N, r)
    scratch = (torch.empty((plan["scratch"],), dtype=f32, device=dev)
               if do_update else None)
    rc = _kernels.lib().rsp_fm_block(
        _kernels.ptr(blk.col_idx), _kernels.ptr(blk.values),
        _kernels.ptr(blk.nnz), _kernels.ptr(blk.slot), _kernels.ptr(y),
        _kernels.ptr(sample_w), _kernels.ptr(w0), _kernels.ptr(acc_w0),
        _kernels.ptr(w), _kernels.ptr(v), _kernels.ptr(acc_w),
        _kernels.ptr(acc_v), _kernels.ptr(blk.feats),
        _kernels.ptr(blk.order), _kernels.ptr(blk.offs),
        _kernels.ptr(scratch), U, N, B, L, r, plan["tpe"], plan["G"], lr_w,
        lr_v, lam_w, lam_v, family, int(intercept), int(do_update),
        _kernels.ptr(y_hat), _kernels.stream(dev))
    _kernels.check(rc, "fm")
    _kernels.launches["fm"] += 1
    return y_hat


def _fm_block(w0, acc_w0, w, v, acc_w, acc_v, blk: GLMBlock, y, sample_w,
              lr_w, lr_v, lam_w, lam_v, family: int, intercept: bool,
              do_update: bool):
    """One block: predictions (B,) from the block-start tables and, with
    ``do_update``, the AdaGrad steps of w0, w and v applied in place (w0 and
    acc_w0 are 0-d tensors).  CPU tensors take the plain version; CUDA
    tensors launch K8."""
    fn = _fm_block_plain if w.device.type == "cpu" else _fm_block_cuda
    return fn(w0, acc_w0, w, v, acc_w, acc_v, blk, y, sample_w, float(lr_w),
              float(lr_v), float(lam_w), float(lam_v), family, intercept,
              do_update)


class FactorizationMachine:
    """2nd-order FM, binomial or gaussian."""

    def __init__(
        self,
        learning_rate_w: float = 0.2,
        rank: int = 4,
        lambda_w: float = 0.0,
        lambda_v: float = 0.0,
        family: str = "binomial",
        intercept: bool = True,
        learning_rate_v: Optional[float] = None,
        precision: str = "float32",
        seed: Optional[int] = None,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (row-sharded tables) is not ported yet; see ROADMAP.md")
        if family not in ("binomial", "gaussian"):
            raise ValueError("family must be 'binomial' or 'gaussian'")
        if not (lambda_w >= 0 and lambda_v >= 0 and learning_rate_w > 0
                and rank >= 1):
            raise ValueError("invalid hyperparameters")
        self.learning_rate_w = float(learning_rate_w)
        self.learning_rate_v = float(learning_rate_v
                                     if learning_rate_v is not None
                                     else learning_rate_w)
        self.rank = int(rank)
        self.lambda_w = float(lambda_w)
        self.lambda_v = float(lambda_v)
        self.family = family
        self.family_code = 1 if family == "binomial" else 2
        self.intercept = bool(intercept)
        self.precision = precision
        self.dtype = resolve_full_dtype(precision)
        self.device = torch.device(device)
        self.mesh = None
        self._rng = np.random.default_rng(seed)
        self.n_features: Optional[int] = None

    def _ensure_state(self, n_features: int):
        if self.n_features is None:
            self.n_features = n_features
            kw = dict(dtype=self.dtype, device=self.device)
            # v init N(0, 0.001), the reference's numpy draw
            # (src/factorization_machine.cpp:219-223), with the padding row
            self.w0 = torch.zeros((), **kw)
            self.acc_w0 = torch.ones((), **kw)
            self.w = torch.zeros((n_features + 1,), **kw)
            self.v = torch.tensor(
                self._rng.standard_normal((n_features + 1, self.rank))
                * 0.001, **kw)
            self.acc_w = torch.ones((n_features + 1,), **kw)
            self.acc_v = torch.ones((n_features + 1, self.rank), **kw)
        elif n_features != self.n_features:
            raise ValueError("feature count mismatch with fitted model")

    def _stage(self, x, y, weights, do_update: bool):
        """Staging of one (x, y, weights) problem, once per ``fit()``."""
        csr = sp.csr_matrix(x)
        if np.isnan(csr.data).any():
            raise ValueError("NA's in input matrix are not allowed")
        self._ensure_state(csr.shape[1])
        n_rows = csr.shape[0]
        if do_update:
            y = np.asarray(y, np.float64)
            if np.isnan(y).any():
                raise ValueError("NA's in y are not allowed")
            if len(y) != n_rows:
                raise ValueError("nrow(x) must equal length(y)")
            if self.family == "binomial":
                # {0,1} -> {-1,1} (reference
                # R/model_FactorizationMachine.R:99-101)
                y = np.where(y == 1, 1.0, -1.0)
        else:
            y = np.zeros(n_rows)
        weights = (np.ones(n_rows) if weights is None
                   else np.asarray(weights, np.float64))
        blocks = staged_glm_blocks(csr, self.dtype, self.device)
        # zero sample weight on padding rows: dL carries it, so they add
        # nothing to the intercept (w0 steps once per real sample)
        labels = staged_label_gathers("fm_y", csr, y, weights, blocks,
                                      self.dtype, self.device,
                                      zero_pad_weight=True)
        return n_rows, blocks, labels

    def _run_staged(self, staged, do_update=False, materialize=True):
        n_rows, blocks, labels = staged
        outs = []
        for blk, (y_b, w_b) in zip(blocks, labels):
            yh = _fm_block(self.w0, self.acc_w0, self.w, self.v, self.acc_w,
                           self.acc_v, blk, y_b, w_b, self.learning_rate_w,
                           self.learning_rate_v, self.lambda_w,
                           self.lambda_v, self.family_code, self.intercept,
                           do_update)
            outs.append((blk.row_ids, yh))
        if not materialize:
            return None
        y_hat = np.empty(n_rows, np.float64)
        for row_ids, yh in outs:
            rows = row_ids.cpu().numpy()
            keep = rows < n_rows
            y_hat[rows[keep]] = yh.double().cpu().numpy()[keep]
        return y_hat

    def _run(self, x, y=None, weights=None, do_update=False,
             materialize=True):
        return self._run_staged(self._stage(x, y, weights, do_update),
                                do_update=do_update, materialize=materialize)

    def partial_fit(self, x, y, weights=None) -> np.ndarray:
        return self._run(x, y, weights, do_update=True)

    def fit(self, x, y, weights=None, n_iter: int = 1) -> np.ndarray:
        if n_iter < 1:
            raise ValueError("n_iter must be >= 1")
        staged = self._stage(x, y, weights, do_update=True)
        for i in range(n_iter):
            out = self._run_staged(staged, do_update=True,
                                   materialize=(i == n_iter - 1))
        return out

    def predict(self, x) -> np.ndarray:
        if self.n_features is None:
            raise RuntimeError("model is not fitted")
        return self._run(x, do_update=False)
