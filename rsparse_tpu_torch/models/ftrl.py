"""FTRL-proximal elastic-net generalized linear model.

Port of ``rsparse_tpu/models/ftrl.py`` (reference R/model_FTRL.R:25-207 over
src/FTRL.cpp:18-169, McMahan et al.).  Rows go in the reference's padded
``(B, L)`` blocks (``ops/segsum.py``); each block is one deterministic
update: lazy weights from the block-start (z, n), link and gradient, then
the per-feature sums of the per-entry z/n increments added to the tables.
On the card one block is K7 (``csrc/ftrl.cu``); :func:`_ftrl_block_plain`
is its plain PyTorch version, which CPU tensors take.

Per-element math matches src/FTRL.cpp:
  w_j = -(z_j - sign(z_j) l1) / ((decay + sqrt(n_j))/lr + l2)  if |z_j| > l1
  grad = sample_weight * (y_hat - y) * x, clipped at +-1000       (:146-158)
  sigma = (sqrt(n + g^2) - sqrt(n)) / lr;  z += g - sigma*w;  n += g^2
Input dropout keeps an entry with probability 1 - dropout and rescales it
by 1/(1 - dropout) (:133-143); the keep mask comes from the model's
``torch.Generator`` and serves the block's prediction and its update.

(z, n) are updated in place.  On the card the kernel takes float32:
``precision="double"`` runs on the CPU only.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import _kernels
from ..config import logger, resolve_dtype
from ..ops.segsum import GLMBlock, staged_glm_blocks, staged_label_gathers

_FAMILY_CODES = {"binomial": 1, "gaussian": 2, "poisson": 3}
CLIP_GRAD = 1000.0


def _link(x: torch.Tensor, family: int) -> torch.Tensor:
    if family == 1:
        return torch.sigmoid(x)
    if family == 2:
        return x
    return torch.exp(x)


def _lazy_weights(z, n, lr, decay, l1, l2):
    """w_ftprl (reference src/FTRL.cpp:78-92)."""
    denom = (decay + torch.sqrt(n)) / lr + l2
    w = -(z - torch.sign(z) * l1) / denom
    return torch.where(torch.abs(z) > l1, w, 0.0)


def _dropped_values(blk: GLMBlock, keep, dropout: float) -> torch.Tensor:
    if keep is None:
        return blk.values
    return torch.where(keep, blk.values * (1.0 / (1.0 - dropout)), 0.0)


def _ftrl_block_plain(z, n, blk: GLMBlock, y, sample_w, lr, decay, l1, l2,
                      dropout, keep, family: int, do_update: bool):
    """Plain version of K7 (rsparse_tpu/models/ftrl.py:64): gathers the
    snapshot, computes every entry's increments, sums them per slot and
    adds the sums at ``feats``.  Returns the (B,) predictions."""
    col = blk.col_idx.long()
    nf = n[col]
    w = _lazy_weights(z[col], nf, lr, decay, l1, l2)        # (B, L)
    vals = _dropped_values(blk, keep, dropout)
    y_hat = _link(torch.sum(w * vals, dim=1), family)
    if not do_update:
        return y_hat
    d = sample_w * (y_hat - y)
    g = torch.clamp(d[:, None] * vals, -CLIP_GRAD, CLIP_GRAD)
    g2 = g * g
    sigma = (torch.sqrt(nf + g2) - torch.sqrt(nf)) / lr
    uz = g - sigma * w
    U = blk.feats.shape[0]
    m = blk.mask()
    slot = blk.slot[m].long()
    dz = torch.zeros((U + 1,), dtype=z.dtype, device=z.device)
    dn = torch.zeros((U + 1,), dtype=z.dtype, device=z.device)
    dz.index_add_(0, slot, uz[m])
    dn.index_add_(0, slot, g2[m])
    feats = blk.feats.long()
    z.index_add_(0, feats, dz[:U])
    n.index_add_(0, feats, dn[:U])
    return y_hat


def _ftrl_block_cuda(z, n, blk: GLMBlock, y, sample_w, lr, decay, l1, l2,
                     dropout, keep, family: int, do_update: bool):
    B, L = blk.col_idx.shape
    U = blk.feats.shape[0]
    f32 = torch.float32
    _kernels.check_tensor("z", z, z.shape, f32)
    _kernels.check_tensor("n", n, z.shape, f32)
    _kernels.check_tensor("col_idx", blk.col_idx, (B, L), torch.int32)
    _kernels.check_tensor("values", blk.values, (B, L), f32)
    _kernels.check_tensor("nnz", blk.nnz, (B,), torch.int32)
    _kernels.check_tensor("slot", blk.slot, (B, L), torch.int32)
    _kernels.check_tensor("feats", blk.feats, (U,), torch.int32)
    _kernels.check_tensor("y", y, (B,), f32)
    _kernels.check_tensor("sample_w", sample_w, (B,), f32)
    if keep is not None:
        _kernels.check_tensor("keep", keep, (B, L), torch.bool)
    dev = z.device
    y_hat = torch.empty((B,), dtype=f32, device=dev)
    if B == 0:
        return y_hat
    dzn = (torch.zeros((2, max(U, 1)), dtype=f32, device=dev)
           if do_update else None)
    rc = _kernels.lib().rsp_ftrl_block(
        _kernels.ptr(blk.col_idx), _kernels.ptr(blk.values),
        _kernels.ptr(blk.nnz), _kernels.ptr(blk.slot), _kernels.ptr(keep),
        1.0 / (1.0 - dropout), _kernels.ptr(y), _kernels.ptr(sample_w),
        _kernels.ptr(z), _kernels.ptr(n), _kernels.ptr(dzn),
        _kernels.ptr(blk.feats), U, B, L, lr, decay, l1, l2, family,
        int(do_update), _kernels.ptr(y_hat), _kernels.stream(dev))
    _kernels.check(rc, "ftrl")
    _kernels.launches["ftrl"] += 1
    return y_hat


def _ftrl_block(z, n, blk: GLMBlock, y, sample_w, lr, decay, l1, l2,
                dropout, keep, family: int, do_update: bool):
    """One block: predictions (B,) from the block-start (z, n), and with
    ``do_update`` the z/n increments added in place.  ``keep`` is the
    (B, L) bool dropout mask or None.  CPU tensors take the plain version;
    CUDA tensors launch K7."""
    fn = _ftrl_block_plain if z.device.type == "cpu" else _ftrl_block_cuda
    return fn(z, n, blk, y, sample_w, float(lr), float(decay), float(l1),
              float(l2), float(dropout), keep, family, do_update)


class FTRL:
    """'Follow the Regularized Leader' proximal GLM (binomial default)."""

    def __init__(
        self,
        learning_rate: float = 0.1,
        learning_rate_decay: float = 0.5,
        lambda_: float = 0.0,
        l1_ratio: float = 1.0,
        dropout: float = 0.0,
        family: str = "binomial",
        precision: str = "float32",
        seed: Optional[int] = None,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (row-sharded tables) is not ported yet; see ROADMAP.md")
        if not 0 <= dropout < 1:
            raise ValueError("dropout must be in [0, 1)")
        if not 0 <= l1_ratio <= 1:
            raise ValueError("l1_ratio must be in [0, 1]")
        if lambda_ < 0 or learning_rate <= 0 or learning_rate_decay <= 0:
            raise ValueError("invalid learning-rate/lambda parameters")
        if family not in _FAMILY_CODES:
            raise ValueError(f"unknown family {family!r}")
        self.learning_rate = float(learning_rate)
        self.learning_rate_decay = float(learning_rate_decay)
        self.lambda_ = float(lambda_)
        self.l1_ratio = float(l1_ratio)
        self.dropout = float(dropout)
        self.family = family
        self.family_code = _FAMILY_CODES[family]
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self.device = torch.device(device)
        self.mesh = None
        self.n_features: Optional[int] = None
        self.z: Optional[torch.Tensor] = None
        self.n: Optional[torch.Tensor] = None
        self._seed = seed if seed is not None else 0
        self._generator: Optional[torch.Generator] = None

    @property
    def _gen(self) -> torch.Generator:
        """The generator on the model's device that draws the dropout keep
        masks, seeded with ``seed`` (made at first use)."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self._seed)
        return self._generator

    @property
    def _l1(self):
        return self.lambda_ * self.l1_ratio

    @property
    def _l2(self):
        return self.lambda_ * (1.0 - self.l1_ratio)

    def _ensure_state(self, n_features: int):
        if self.n_features is None:
            self.n_features = n_features
            self.z = torch.zeros((n_features + 1,), dtype=self.dtype,
                                 device=self.device)
            self.n = torch.zeros_like(self.z)
        elif n_features != self.n_features:
            raise ValueError(
                f"feature count mismatch: model has {self.n_features}, "
                f"input has {n_features}")

    def _stage(self, x: sp.spmatrix, y, weights, do_update: bool):
        """Staging of one (x, y, weights) problem, once per ``fit()``."""
        csr = sp.csr_matrix(x)
        if np.isnan(csr.data).any():
            raise ValueError("NA's in input matrix are not allowed")
        self._ensure_state(csr.shape[1])
        n_rows = csr.shape[0]
        y = np.zeros(n_rows) if y is None else np.asarray(y, np.float64)
        if do_update and len(y) != n_rows:
            raise ValueError("nrow(x) must equal length(y)")
        weights = (np.ones(n_rows) if weights is None
                   else np.asarray(weights, np.float64))
        blocks = staged_glm_blocks(csr, self.dtype, self.device)
        labels = staged_label_gathers("ftrl_y", csr, y, weights, blocks,
                                      self.dtype, self.device,
                                      zero_pad_weight=False)
        return n_rows, blocks, labels

    def _run_staged(self, staged, do_update=False, materialize=True):
        n_rows, blocks, labels = staged
        use_dropout = do_update and self.dropout > 0
        outs = []
        for blk, (y_b, w_b) in zip(blocks, labels):
            keep = None
            if use_dropout:
                keep = torch.rand(blk.values.shape, generator=self._gen,
                                  device=self.device) > self.dropout
            yh = _ftrl_block(self.z, self.n, blk, y_b, w_b,
                             self.learning_rate, self.learning_rate_decay,
                             self._l1, self._l2, self.dropout, keep,
                             self.family_code, do_update)
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

    def partial_fit(self, x: sp.spmatrix, y, weights=None) -> np.ndarray:
        """One SGD pass over the samples; returns in-pass predictions."""
        return self._run(x, y, weights, do_update=True)

    def fit(self, x, y, weights=None, n_iter: int = 1):
        if n_iter < 1:
            raise ValueError("n_iter must be >= 1")
        staged = self._stage(x, y, weights, do_update=True)
        for i in range(n_iter):
            logger.debug("FTRL iter %03d", i + 1)
            out = self._run_staged(staged, do_update=True,
                                   materialize=(i == n_iter - 1))
        return out

    def predict(self, x: sp.spmatrix) -> np.ndarray:
        if self.n_features is None:
            raise RuntimeError("model is not fitted")
        return self._run(x, do_update=False)

    def coef(self) -> np.ndarray:
        """Regression weights from the (z, n) state, (n_features,)
        (reference src/FTRL.cpp:59-75)."""
        F = self.n_features
        w = _lazy_weights(self.z[:F], self.n[:F], self.learning_rate,
                          self.learning_rate_decay, self._l1, self._l2)
        return w.double().cpu().numpy()

    # -- serialization (reference R/model_FTRL.R:142-158) ------------------

    def dump(self) -> Dict:
        if self.n_features is None:
            raise RuntimeError("model is not fitted")
        return {
            "kind": "ftrl_model_dump",
            "learning_rate": self.learning_rate,
            "learning_rate_decay": self.learning_rate_decay,
            "lambda": self.lambda_, "l1_ratio": self.l1_ratio,
            "dropout": self.dropout, "family": self.family,
            "n_features": self.n_features,
            "z": self.z.cpu().numpy().copy(),
            "n": self.n.cpu().numpy().copy(),
        }

    @classmethod
    def load(cls, d: Dict, precision: str = "float32",
             device="cuda") -> "FTRL":
        """A model from :meth:`dump`'s dict (the reference's dump loads
        too: its z and n are numpy arrays)."""
        if d.get("kind") != "ftrl_model_dump":
            raise ValueError("input should be an ftrl_model_dump dict")
        m = cls(learning_rate=d["learning_rate"],
                learning_rate_decay=d["learning_rate_decay"],
                lambda_=d["lambda"], l1_ratio=d["l1_ratio"],
                dropout=d["dropout"], family=d["family"],
                precision=precision, device=device)
        m.n_features = int(d["n_features"])
        m.z = torch.tensor(np.asarray(d["z"]), dtype=m.dtype, device=m.device)
        m.n = torch.tensor(np.asarray(d["n"]), dtype=m.dtype, device=m.device)
        return m
