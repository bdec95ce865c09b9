"""FTRL-proximal elastic-net generalized linear model.

Port of ``rsparse_tpu/models/ftrl.py`` (reference R/model_FTRL.R:25-207 over
src/FTRL.cpp:18-169, McMahan et al.).  Rows go in the reference's padded
``(B, L)`` blocks (``ops/segsum.py``); each block is one deterministic
update: lazy weights from the block-start (z, n), link and gradient, then
the per-feature sums of the per-entry z/n increments added to the tables.
On the card one block is K7 (``csrc/ftrl.cu``: the rows, then the block's
entries grouped by feature, :func:`k7_plan`); :func:`_ftrl_block_plain` is
its plain PyTorch version, which CPU tensors take.

The model keeps (z, n) as one (F + 1, 2) table ``zn``, so that a feature's
z and n share one 32-byte sector of device memory; ``z`` and ``n`` are its
column views.  (The JAX package keeps two 1-D tables because a TPU pads a
(F, 2) array to (F, 128), rsparse_tpu/models/ftrl.py:71-74; a GPU does not
pad.)

Per-element math matches src/FTRL.cpp:
  w_j = -(z_j - sign(z_j) l1) / ((decay + sqrt(n_j))/lr + l2)  if |z_j| > l1
  grad = sample_weight * (y_hat - y) * x, clipped at +-1000       (:146-158)
  sigma = (sqrt(n + g^2) - sqrt(n)) / lr;  z += g - sigma*w;  n += g^2
Input dropout keeps an entry with probability 1 - dropout and rescales it
by 1/(1 - dropout) (:133-143); the keep mask comes from the model's
``torch.Generator`` and serves the block's prediction and its update.

(z, n) are updated in place.  On the card the kernel takes float32:
``precision="double"`` runs on the CPU only.

On a mesh (``mesh=parallel.mesh.make_mesh(...)``, every rank calling the
same code) ``zn`` is this rank's row shard of the (F + 1, 2) table
(``parallel/sgd_sharded.py``): each block gathers its features' pairs into
one contiguous compact pair table (one all-reduce), runs K7 on it with the
block relabelled (``ops/segsum.py`` ``compact_glm_block``) and writes back
the pairs this rank owns.  Every rank draws the same keep masks (the same
seed); ``z``, ``n``, ``coef``, ``dump`` and ``predict`` see whole tables.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import _kernels
from ..config import logger, resolve_full_dtype
from ..ops.segsum import (GLMBlock, compact_glm_block, staged_glm_blocks,
                          staged_label_gathers)
from ..parallel import sgd_sharded as sgd

_FAMILY_CODES = {"binomial": 1, "gaussian": 2, "poisson": 3}
CLIP_GRAD = 1000.0
#: entries a tile of K7's feature walk (csrc/ftrl.cu kTile, launch B): a
#: feature with entries in more than one tile is finished by launch C
K7_TILE = 128


def k7_plan(B: int, L: int, N: int) -> dict:
    """K7's launch for a (B, L) block holding N valid entries: launch B's
    tiles of K7_TILE entries, and the float32 scratch the wrapper allocates
    in update mode (each entry's two increments and block-start pair, the
    tiles' head and tail sums and their owners)."""
    n_tiles = -(-N // K7_TILE)
    return dict(n_tiles=n_tiles, scratch=4 * B * L + 4 * n_tiles + n_tiles)


def zn_layout(z: torch.Tensor, n: torch.Tensor) -> int:
    """How K7 takes (z, n): 1 for the two columns of one contiguous
    (F + 1, 2) float32 CUDA table, 0 for two contiguous 1-D ones; raises
    for any other layout."""
    if z.dim() != 1 or z.shape != n.shape:
        raise ValueError("z, n: expected two (F + 1,) tables")
    F1 = z.shape[0]
    pair = (z.stride() == n.stride() == (2,) and F1 > 1
            and z.untyped_storage().data_ptr()
            == n.untyped_storage().data_ptr()
            and n.storage_offset() == z.storage_offset() + 1)
    if not (pair or z.is_contiguous() and n.is_contiguous()):
        raise ValueError("z, n: the CUDA kernel takes the two columns of one "
                         "contiguous (F + 1, 2) table or two contiguous 1-D "
                         "tables")
    if not pair:
        _kernels.check_tensor("z", z, (F1,), torch.float32)
        _kernels.check_tensor("n", n, (F1,), torch.float32)
        return 0
    _kernels.check_tensor("zn", z.as_strided((F1, 2), (2, 1)), (F1, 2),
                          torch.float32)
    if z.data_ptr() % 8:
        raise ValueError("zn: the pair table must be 8-byte aligned")
    return 1


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
    U, N = blk.feats.shape[0], blk.order.shape[0]
    f32 = torch.float32
    pair = zn_layout(z, n)
    _kernels.check_tensor("col_idx", blk.col_idx, (B, L), torch.int32)
    _kernels.check_tensor("values", blk.values, (B, L), f32)
    _kernels.check_tensor("nnz", blk.nnz, (B,), torch.int32)
    _kernels.check_tensor("slot", blk.slot, (B, L), torch.int32)
    _kernels.check_tensor("feats", blk.feats, (U,), torch.int32)
    _kernels.check_tensor("order", blk.order, (N,), torch.int32)
    _kernels.check_tensor("offs", blk.offs, (U + 1,), torch.int32)
    _kernels.check_tensor("y", y, (B,), f32)
    _kernels.check_tensor("sample_w", sample_w, (B,), f32)
    if keep is not None:
        _kernels.check_tensor("keep", keep, (B, L), torch.bool)
    dev = z.device
    y_hat = torch.empty((B,), dtype=f32, device=dev)
    if B == 0:
        return y_hat
    scratch = (torch.empty((k7_plan(B, L, N)["scratch"],), dtype=f32,
                           device=dev) if do_update else None)
    rc = _kernels.lib().rsp_ftrl_block(
        _kernels.ptr(blk.col_idx), _kernels.ptr(blk.values),
        _kernels.ptr(blk.nnz), _kernels.ptr(blk.slot), _kernels.ptr(keep),
        1.0 / (1.0 - dropout), _kernels.ptr(y), _kernels.ptr(sample_w),
        _kernels.ptr(z), _kernels.ptr(n), pair, _kernels.ptr(blk.feats),
        _kernels.ptr(blk.order), _kernels.ptr(blk.offs),
        _kernels.ptr(scratch), U, N, B, L, lr, decay, l1, l2, family,
        int(do_update), _kernels.ptr(y_hat), _kernels.stream(dev))
    _kernels.check(rc, "ftrl")
    _kernels.launches["ftrl"] += 1
    return y_hat


def _ftrl_block(z, n, blk: GLMBlock, y, sample_w, lr, decay, l1, l2,
                dropout, keep, family: int, do_update: bool):
    """One block: predictions (B,) from the block-start (z, n), and with
    ``do_update`` the z/n increments added in place.  ``keep`` is the
    (B, L) bool dropout mask or None.  CPU tensors take the plain version;
    CUDA tensors launch K7, with (z, n) laid out as :func:`zn_layout`
    takes them."""
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
        self.dtype = resolve_full_dtype(precision)
        self.device = torch.device(device)
        #: a ``parallel.mesh.Mesh``: (z, n) row-sharded over its table axes
        #: (``parallel/sgd_sharded.py``); None runs on ``device``
        self.mesh = mesh
        self._ops = None
        if mesh is not None:
            self._ops = sgd.ShardedOps(mesh)
            self.device = mesh.device
        self.n_features: Optional[int] = None
        #: the (F + 1, 2) table of (z, n), the last row the padding feature
        #: (on a mesh this rank's row shard of it)
        self.zn: Optional[torch.Tensor] = None
        self._seed = seed if seed is not None else 0
        self._generator: Optional[torch.Generator] = None

    def _zn_whole(self) -> Optional[torch.Tensor]:
        """The whole (F + 1, 2) table (on a mesh an all-gather: every rank
        calls it)."""
        if self.zn is None or self.mesh is None:
            return self.zn
        return sgd.unshard(self.zn, self.n_features + 1, self.mesh)

    @property
    def z(self) -> Optional[torch.Tensor]:
        """(F + 1,) z: column 0 of ``zn``, a view (on a mesh, of the whole
        table gathered)."""
        zn = self._zn_whole()
        return None if zn is None else zn[:, 0]

    @property
    def n(self) -> Optional[torch.Tensor]:
        """(F + 1,) n: column 1 of ``zn``, a view (on a mesh, of the whole
        table gathered)."""
        zn = self._zn_whole()
        return None if zn is None else zn[:, 1]

    def _sharded_tables(self) -> Dict[str, int]:
        """The row-sharded tables on a mesh and their logical rows."""
        return {} if self.n_features is None else {
            "zn": self.n_features + 1}

    def _set_state(self, z, n) -> None:
        """``zn`` from (F + 1,) arrays z and n (row-sharded on a mesh)."""
        z, n = np.asarray(z), np.asarray(n)
        if z.ndim != 1 or z.shape != n.shape:
            raise ValueError("expected z and n of one (F + 1,) shape")
        self.n_features = z.shape[0] - 1
        zn = torch.tensor(np.stack([z, n], 1), dtype=self.dtype)
        self.zn = (zn.to(self.device) if self.mesh is None
                   else sgd.shard_table(zn, self.mesh))

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
            self.zn = (torch.zeros((n_features + 1, 2), dtype=self.dtype,
                                   device=self.device) if self.mesh is None
                       else sgd.full_table(n_features + 1, (2,), 0.0,
                                           self.mesh, self.dtype))
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

    def _block(self, blk, y_b, w_b, keep, do_update):
        """One block on the model's tables; on a mesh, on the compact pair
        table of its features (module docstring)."""
        args = (y_b, w_b, self.learning_rate, self.learning_rate_decay,
                self._l1, self._l2, self.dropout, keep, self.family_code,
                do_update)
        if self.mesh is None:
            return _ftrl_block(self.zn[:, 0], self.zn[:, 1], blk, *args)
        ops, cb = self._ops, compact_glm_block(blk)
        zc = ops.gather(self.zn, cb.ids)
        with ops.phase("kernel_s"):
            yh = _ftrl_block(zc[:, 0], zc[:, 1], cb.block, *args)
        if do_update:
            U = blk.feats.shape[0]
            sgd.put_rows(ops, (self.zn,), cb.ids[:U], (zc[:U],))
        return yh

    def _run_staged(self, staged, do_update=False, materialize=True):
        n_rows, blocks, labels = staged
        use_dropout = do_update and self.dropout > 0
        outs = []
        draws = 0    # on a mesh: the masks' running checksum
        for blk, (y_b, w_b) in zip(blocks, labels):
            keep = None
            if use_dropout:
                keep = torch.rand(blk.values.shape, generator=self._gen,
                                  device=self.device) > self.dropout
                if self.mesh is not None:
                    draws = draws + sgd.checksum(keep)
            yh = self._block(blk, y_b, w_b, keep, do_update)
            outs.append((blk.row_ids, yh))
        if use_dropout and self.mesh is not None:
            self._ops.check_same(draws, "FTRL dropout masks")
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
        zn = self._zn_whole()
        w = _lazy_weights(zn[:F, 0], zn[:F, 1], self.learning_rate,
                          self.learning_rate_decay, self._l1, self._l2)
        return w.double().cpu().numpy()

    # -- serialization (reference R/model_FTRL.R:142-158) ------------------

    def dump(self) -> Dict:
        if self.n_features is None:
            raise RuntimeError("model is not fitted")
        zn = self._zn_whole()
        return {
            "kind": "ftrl_model_dump",
            "learning_rate": self.learning_rate,
            "learning_rate_decay": self.learning_rate_decay,
            "lambda": self.lambda_, "l1_ratio": self.l1_ratio,
            "dropout": self.dropout, "family": self.family,
            "n_features": self.n_features,
            "z": zn[:, 0].cpu().numpy().copy(),
            "n": zn[:, 1].cpu().numpy().copy(),
        }

    @classmethod
    def load(cls, d: Dict, precision: str = "float32", device="cuda",
             mesh=None) -> "FTRL":
        """A model from :meth:`dump`'s dict (the reference's dump loads
        too: its z and n are numpy arrays); with ``mesh`` its tables are
        row-sharded there."""
        if d.get("kind") != "ftrl_model_dump":
            raise ValueError("input should be an ftrl_model_dump dict")
        m = cls(learning_rate=d["learning_rate"],
                learning_rate_decay=d["learning_rate_decay"],
                lambda_=d["lambda"], l1_ratio=d["l1_ratio"],
                dropout=d["dropout"], family=d["family"],
                precision=precision, device=device, mesh=mesh)
        m._set_state(d["z"], d["n"])
        if m.n_features != int(d["n_features"]):
            raise ValueError("n_features does not match z and n")
        return m
