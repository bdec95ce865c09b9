"""RankMF: pairwise-ranking matrix factorization (BPR / WARP).

Port of ``rsparse_tpu/models/rankmf.py`` (reference R/model_RankMF.R:7-162
over src/rankmf.cpp:103-283).  Each minibatch of S samples draws one
``(S, K + 2)`` block of uint32 bits (user, positive offset, K negative
candidates) from the model's ``torch.Generator``; the first acceptable
candidate (BPR: any non-positive; WARP: one that violates the margin) is
taken, the positive sets are probed through bucketized per-user hash
tables (:func:`build_user_hash`), and the WARP rank weight is
``log1p((n_item - 1)/(k + 1) + 1) / log1p(n_item + 1)`` with k the
candidates tried.

Side features: embeddings are feature combinations ``w_u = sum_f W[f] *
val`` (identity features = plain MF, one row gather); gradients go to every
feature id of the touched entities with the per-feature scalar
AdaGrad/RMSprop accumulator of the mean squared gradient
(src/rankmf.cpp:86-100), unscaled by feature values, with weight decay
``lr * lambda * combined_embedding`` (:246-279).  All samples of a batch
read the batch-start tables; duplicates accumulate (accumulator first).

On the card one batch is K9 (``csrc/rankmf.cu``); :func:`_rankmf_batch_plain`
is its plain PyTorch version, which CPU tensors take.  K9 takes float32
and a rank of at most ``MAX_RANK``.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import _kernels
from ..config import logger, resolve_full_dtype
from ..sparse.device import staged_cached
from .base import MatrixFactorizationRecommender, get_names

ADAGRAD, RMSPROP = 0, 1
_MAX_PROBE = 8        # hash-set probe window (build_user_hash guarantees)
BPR, WARP = 0, 1
IDENTITY, SIGMOID = 0, 1
EPS = 1e-10
#: widest embedding K9 takes (csrc/rankmf.cu kMaxR)
MAX_RANK = 128
#: batches whose AUC counters make one ``auc_history`` entry (the
#: reference's scan chunk)
CHUNK = 8
#: candidates K9's launch A scores side by side before its first ballot
#: (``kWindow`` in csrc/rankmf.cu, where the reason for 8 stands; later
#: windows take up to 32)
K9_WINDOW = 8


class _Feats(NamedTuple):
    """Padded per-entity feature lists: idx (n, F), val (n, F), mask."""

    idx: torch.Tensor
    val: torch.Tensor
    mask: torch.Tensor


class _Positives(NamedTuple):
    """The interactions as K9 reads them: CSR column ids, row starts, row
    lengths, and the hash sets of :func:`build_user_hash`."""

    flat_idx: torch.Tensor   # (nnz,) int32
    indptr: torch.Tensor     # (n_user,) int32 row starts
    row_nnz: torch.Tensor    # (n_user,) int32
    table: torch.Tensor      # (TB, lanes) int32, -1 = empty
    boff: torch.Tensor       # (n_user,) int32
    bmask: torch.Tensor      # (n_user,) int32
    bshift: torch.Tensor     # (n_user,) int32


def _pad_features(feats: sp.csr_matrix, dtype, device) -> _Feats:
    csr = sp.csr_matrix(feats)
    csr.sort_indices()
    n = csr.shape[0]
    F = max(int(np.diff(csr.indptr).max()) if csr.nnz else 1, 1)
    idx = np.zeros((n, F), np.int32)
    val = np.zeros((n, F), np.float64)
    nnz = np.diff(csr.indptr)
    offs = np.arange(F)[None, :]
    flat = np.minimum(csr.indptr[:-1, None] + offs, max(csr.nnz - 1, 0))
    mask = offs < nnz[:, None]
    if csr.nnz:
        idx = np.where(mask, csr.indices[flat], 0).astype(np.int32)
        val = np.where(mask, csr.data[flat], 0.0)
    return _Feats(torch.from_numpy(idx).to(device),
                  torch.from_numpy(val).to(device, dtype),
                  torch.from_numpy(mask).to(device))


def _combine(emb: torch.Tensor, feats: Optional[_Feats],
             ids: torch.Tensor) -> torch.Tensor:
    """Feature-combined embeddings of entities ``ids``: (..., r).
    ``feats=None`` is the identity feature matrix: one row gather."""
    if feats is None:
        return emb[ids]
    fi = feats.idx[ids].long()                  # (..., F)
    fv = torch.where(feats.mask[ids], feats.val[ids], 0.0)
    return torch.einsum("...f,...fr->...r", fv, emb[fi])


_HASH_MULT = np.uint32(2654435761)      # Knuth multiplicative hash


def build_user_hash(csr: sp.csr_matrix, max_probe: int = 8):
    """Per-user bucketized hash sets of the positive items (numpy; a copy
    of rsparse_tpu/models/rankmf.py:98).

    Each user owns ``bcap_u`` (a power of two) buckets of ``max_probe``
    lanes in one ``(total_buckets, max_probe)`` table; an item lives in any
    free lane of bucket ``(item * MULT) >> (32 - log2(bcap))`` (the high
    bits of a multiplicative hash, so strided ids do not collide), and a
    user's bucket count doubles until every bucket fits.  Membership is one
    bucket-row read and a lane compare.  Empty lanes hold -1.

    Returns ``(table (TB, max_probe) int32, boff (n_user,) int32,
    bmask (n_user,) int32, bshift (n_user,) int32)`` as numpy arrays, with
    ``bmask = bcap - 1`` and ``bshift = min(32 - log2(bcap), 31)``.
    """
    n_user = csr.shape[0]
    nnz = np.diff(csr.indptr).astype(np.int64)
    bcap = 2 ** np.ceil(np.log2(np.maximum(
        -(-nnz // max(max_probe // 4, 1)), 1))).astype(np.int64)
    items_all = csr.indices.astype(np.uint32)
    users_all = np.repeat(np.arange(n_user, dtype=np.int64), nnz)
    h_all = (items_all * _HASH_MULT).astype(np.uint32)

    while True:
        boff = np.zeros(n_user + 1, np.int64)
        np.cumsum(bcap, out=boff[1:])
        total = int(boff[-1])
        if total * max_probe >= (1 << 31):
            raise MemoryError("user hash table exceeds int32 indexing")
        log2b = np.round(np.log2(bcap)).astype(np.int64)
        sh = np.minimum(32 - log2b, 31).astype(np.uint32)
        b = ((h_all >> sh[users_all])
             & (bcap[users_all] - 1).astype(np.uint32)).astype(np.int64)
        gb = boff[users_all] + b
        order = np.argsort(gb, kind="stable")
        gbs = gb[order]
        first = np.ones(len(gbs), bool)
        first[1:] = gbs[1:] != gbs[:-1]
        run_start = np.flatnonzero(first)
        lane = np.arange(len(gbs)) - run_start[np.cumsum(first) - 1]
        over = lane >= max_probe
        if over.any():          # rare: a bucket drew > max_probe items
            bcap[np.unique(users_all[order[over]])] *= 2
            continue
        table = np.full((total, max_probe), -1, np.int32)
        table[gbs, lane] = items_all[order].astype(np.int32)
        return (table, boff[:-1].astype(np.int32),
                (bcap - 1).astype(np.int32), sh.astype(np.int32))


def _in_hash_set(table, off, capmask, bshift, u, queries) -> torch.Tensor:
    """Membership of ``queries[s, k]`` in user ``u[s]``'s hash set: one
    bucket-row gather and a compare over its lanes (the plain version of
    K9's probe, rsparse_tpu/models/rankmf.py:167)."""
    q = queries.long()
    h = (q * int(_HASH_MULT)) & 0xFFFFFFFF
    m = capmask[u].long()[:, None]
    sh = bshift[u].long()[:, None]
    row = off[u].long()[:, None] + ((h >> sh) & m)          # (S, K)
    got = table[row]                                         # (S, K, lanes)
    return (got == q[..., None]).any(-1)


class BatchConfig(NamedTuple):
    S: int
    K: int
    loss: int
    kernel: int
    optimizer: int
    update_items: bool


class BatchParams(NamedTuple):
    lr: float
    gamma: float
    lam_u: float
    lam_ip: float
    lam_in: float
    margin: float


def _apply_plain(emb, acc, feats, ids, grad, lam, comb, lr, gamma, optimizer):
    """Scatter one stacked entity set's update into its feature embeddings
    (rsparse_tpu/models/rankmf.py:290-329)."""
    r = emb.shape[1]
    nz = (grad != 0).any(1)
    if feats is None:
        fi = ids[:, None]
        fmask = nz[:, None]
    else:
        fi = feats.idx[ids].long()
        fmask = feats.mask[ids] & nz[:, None]
    g2 = (grad * grad).sum(1) / r
    flat = fi.reshape(-1)
    if optimizer == ADAGRAD:
        acc.index_add_(0, flat, torch.where(fmask, g2[:, None], 0.0)
                       .reshape(-1))
    else:
        old = acc[fi]
        cnt = torch.zeros_like(acc).index_add_(
            0, flat, fmask.to(acc.dtype).reshape(-1))
        n_dup = cnt[fi].clamp(min=1.0)
        delta = (gamma - 1.0) * old / n_dup + (1.0 - gamma) * g2[:, None]
        acc.index_add_(0, flat, torch.where(fmask, delta, 0.0).reshape(-1))
    denom = torch.sqrt(acc[fi] + EPS)
    step = grad[:, None, :] / denom[..., None] + lam[:, None, None] * \
        comb[:, None, :]
    step = torch.where(fmask[..., None], step, 0.0)
    emb.index_add_(0, flat, (-lr * step).reshape(-1, r))


def _first_acceptable(acceptable: torch.Tensor, valid: torch.Tensor):
    """The reference's choice among a sample's K candidates
    (rsparse_tpu/models/rankmf.py:257-262): (found, the first acceptable
    candidate or 0, the candidates tried: first + 1, or K), each (S,)."""
    K = acceptable.shape[1]
    found = acceptable.any(1) & valid
    first_k = acceptable.to(torch.uint8).argmax(1)       # first True, or 0
    return found, first_k, torch.where(found, first_k + 1, K)


def _rankmf_batch_plain(W, H, accW, accH, bits, pos: _Positives,
                        uf: Optional[_Feats], itf: Optional[_Feats],
                        hp: BatchParams, cfg: BatchConfig, n_item: int):
    """Plain version of K9 (rsparse_tpu/models/rankmf.py:202) on the JAX
    package's arithmetic: samples from ``bits`` (S, K + 2), scores every
    candidate, takes the first acceptable one, then updates W, H, accW
    and accH in place.  Returns int64 counters [auc_num, auc_den, found,
    n_tried] (auc_den = max(valid samples, 1))."""
    S, K = cfg.S, cfg.K
    b = bits.long() & 0xFFFFFFFF
    n_user = pos.row_nnz.shape[0]
    u = b[:, 0] % n_user
    nnz_u = pos.row_nnz[u].long()
    valid = nnz_u > 0
    p1 = pos.indptr[u].long()
    pos_off = b[:, 1] % nnz_u.clamp(min=1)
    i = pos.flat_idx[(p1 + pos_off).clamp(0, pos.flat_idx.shape[0] - 1)
                     ].long()
    w_u = _combine(W, uf, u)
    h_i = _combine(H, itf, i)
    j_cand = b[:, 2:] % n_item
    is_neg = ~_in_hash_set(pos.table, pos.boff, pos.bmask, pos.bshift, u,
                           j_cand)
    h_j_all = _combine(H, itf, j_cand)                   # (S, K, r)
    r_ui = (w_u * h_i).sum(1)
    r_uj = torch.einsum("sr,skr->sk", w_u, h_j_all)
    if cfg.kernel == SIGMOID:
        r_ui_k, r_uj_k = torch.sigmoid(r_ui), torch.sigmoid(r_uj)
        hi_adj = r_ui_k * (1 - r_ui_k)
        hj_adj_all = r_uj_k * (1 - r_uj_k)
        d = r_uj_k - r_ui_k[:, None]
    else:
        hi_adj = torch.ones_like(r_ui)
        hj_adj_all = torch.ones_like(r_uj)
        d = r_uj - r_ui[:, None]
    acceptable = is_neg if cfg.loss == BPR else is_neg & (d + hp.margin >= 0)
    found, first_k, tried = _first_acceptable(acceptable, valid)
    sel = lambda a: a.gather(1, first_k[:, None])[:, 0]  # noqa: E731
    j = sel(j_cand)
    d_sel, hj_adj = sel(d), sel(hj_adj_all)
    h_j = h_j_all[torch.arange(S, device=W.device), first_k]
    weight = torch.sigmoid(d_sel)
    if cfg.loss == WARP:
        norm = float(np.log1p(float(n_item) + 1.0))
        weight = weight * torch.log1p(
            (n_item - 1.0) / (first_k.to(W.dtype) + 1.0) + 1.0) / norm
    weight = torch.where(found, weight, 0.0)
    auc_num = (is_neg[:, 0] & (d[:, 0] < 0) & valid).sum()
    auc_den = valid.sum().clamp(min=1)

    grad_u = weight[:, None] * (hj_adj[:, None] * h_j
                                - hi_adj[:, None] * h_i)
    grad_ip = -weight[:, None] * hi_adj[:, None] * w_u
    grad_in = weight[:, None] * hj_adj[:, None] * w_u
    full = lambda v: torch.full((S,), v, dtype=W.dtype,  # noqa: E731
                                device=W.device)
    _apply_plain(W, accW, uf, u, grad_u, full(hp.lam_u), w_u, hp.lr,
                 hp.gamma, cfg.optimizer)
    if cfg.update_items:
        _apply_plain(H, accH, itf, torch.cat([i, j]),
                     torch.cat([grad_ip, grad_in]),
                     torch.cat([full(hp.lam_ip), full(hp.lam_in)]),
                     torch.cat([h_i, h_j]), hp.lr, hp.gamma, cfg.optimizer)
    return torch.stack([auc_num, auc_den, found.sum(), tried.sum()]).long()


def _feat_args(f: Optional[_Feats], name: str, n: int):
    if f is None:
        return (None, None, None), 0
    F = f.idx.shape[1]
    _kernels.check_tensor(f"{name}.idx", f.idx, (n, F), torch.int32)
    _kernels.check_tensor(f"{name}.val", f.val, (n, F), torch.float32)
    _kernels.check_tensor(f"{name}.mask", f.mask, (n, F), torch.bool)
    return (f.idx, f.val, f.mask), F


def _rankmf_batch_cuda(W, H, accW, accH, bits, pos: _Positives,
                       uf: Optional[_Feats], itf: Optional[_Feats],
                       hp: BatchParams, cfg: BatchConfig, n_item: int,
                       stages: int = 2):
    """K9 on CUDA tensors (see :func:`_rankmf_batch`).  ``stages`` 1 stops
    after launch A, for timing it apart: the counters are left unclamped
    and the tables unchanged, but AdaGrad's accumulators."""
    S, K = cfg.S, cfg.K
    nuf, r = W.shape
    nif = H.shape[0]
    n_user = pos.row_nnz.shape[0]
    if r > MAX_RANK:
        raise ValueError(f"RankMF rank {r}: the CUDA kernel takes at most "
                         f"{MAX_RANK}")
    f32, i32 = torch.float32, torch.int32
    _kernels.check_tensor("W", W, (nuf, r), f32)
    _kernels.check_tensor("H", H, (nif, r), f32)
    _kernels.check_tensor("accW", accW, (nuf,), f32)
    _kernels.check_tensor("accH", accH, (nif,), f32)
    _kernels.check_tensor("bits", bits, (S, K + 2), torch.int64)
    _kernels.check_tensor("flat_idx", pos.flat_idx, pos.flat_idx.shape, i32)
    lanes = pos.table.shape[1]
    if not 1 <= lanes <= 32:
        raise ValueError(f"hash table of {lanes} lanes: K9 takes 1 to 32")
    _kernels.check_tensor("table", pos.table, pos.table.shape, i32)
    for name in ("indptr", "row_nnz", "boff", "bmask", "bshift"):
        _kernels.check_tensor(name, getattr(pos, name), (n_user,), i32)
    (ui, uv, um), Fu = _feat_args(uf, "user_features", n_user)
    (ii, iv, im), Fi = _feat_args(itf, "item_features", n_item)
    dev = W.device
    F = max(Fu, Fi, 1)
    rms = cfg.optimizer == RMSPROP
    iscr = torch.empty((2 * 3 * S,), dtype=i32, device=dev)
    fscr = torch.empty((3 * S * (1 + 2 * r + (F if rms else 0)),),
                       dtype=f32, device=dev)
    cntW = torch.zeros((nuf,), dtype=f32, device=dev) if rms else None
    cntH = (torch.zeros((nif,), dtype=f32, device=dev)
            if rms and cfg.update_items else None)
    counters = torch.empty((4,), dtype=torch.int64, device=dev)
    args = _kernels.RankMFArgs(
        *(_kernels.ptr(t) for t in (
            bits, pos.flat_idx, pos.indptr, pos.row_nnz, pos.table, pos.boff,
            pos.bmask, pos.bshift, ui, uv, um, ii, iv, im, W, H, accW, accH,
            iscr, fscr, cntW, cntH, counters)),
        S, K, r, n_user, n_item, pos.flat_idx.shape[0], lanes, Fu, Fi,
        cfg.loss, cfg.kernel, cfg.optimizer, int(cfg.update_items),
        hp.lr, hp.gamma, hp.lam_u, hp.lam_ip, hp.lam_in, hp.margin,
        float(np.log1p(float(n_item) + 1.0)))
    rc = _kernels.lib().rsp_rankmf_batch(ctypes.byref(args),
                                         ctypes.c_int(int(stages)),
                                         _kernels.stream(dev))
    _kernels.check(rc, "rankmf")
    _kernels.launches["rankmf"] += 1
    return counters


def _rankmf_batch(W, H, accW, accH, bits, pos: _Positives,
                  uf: Optional[_Feats], itf: Optional[_Feats],
                  hp: BatchParams, cfg: BatchConfig, n_item: int):
    """One minibatch of pairwise updates from the uint32 ``bits`` (S, K + 2)
    held in an int64 tensor; W, H and their accumulators change in place.
    Returns int64 counters [auc_num, auc_den, found, n_tried].  CPU tensors
    take the plain version; CUDA tensors launch K9."""
    fn = (_rankmf_batch_plain if W.device.type == "cpu"
          else _rankmf_batch_cuda)
    return fn(W, H, accW, accH, bits, pos, uf, itf, hp, cfg, n_item)


def _stage_positives(csr: sp.csr_matrix, device) -> _Positives:
    arrays = (csr.indices, csr.indptr[:-1], np.diff(csr.indptr),
              *build_user_hash(csr, _MAX_PROBE))
    return _Positives(*(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                        .to(device) for a in arrays))


class RankMF(MatrixFactorizationRecommender):
    """Pairwise-ranking MF with optional user/item side features."""

    def __init__(
        self,
        rank: int = 8,
        learning_rate: float = 0.01,
        optimizer: str = "adagrad",
        lambda_: float = 0.0,
        gamma: float = 0.0,
        loss: str = "bpr",
        kernel: str = "identity",
        margin: float = 0.1,
        max_negative_samples: int = 50,
        batch_size: int = 512,
        precision: str = "float32",
        seed: Optional[int] = None,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (row-sharded tables) is not ported yet; see ROADMAP.md")
        super().__init__(device)
        self.mesh = None
        self.rank = int(rank)
        self.learning_rate = float(learning_rate)
        self.optimizer = {"adagrad": ADAGRAD, "rmsprop": RMSPROP}[optimizer]
        if np.isscalar(lambda_):
            lambda_ = {"lambda_user": lambda_, "lambda_item_positive": lambda_,
                       "lambda_item_negative": lambda_}
        self.lambda_user = float(lambda_["lambda_user"])
        self.lambda_item_positive = float(lambda_["lambda_item_positive"])
        self.lambda_item_negative = float(lambda_["lambda_item_negative"])
        self.gamma = float(gamma)
        self.loss = {"bpr": BPR, "warp": WARP}[loss]
        self.kernel = {"identity": IDENTITY, "sigmoid": SIGMOID}[kernel]
        self.margin = float(margin)
        self.max_negative_samples = int(max_negative_samples)
        self.batch_size = int(batch_size)
        self.dtype = resolve_full_dtype(precision)
        self._rng = np.random.default_rng(seed)
        self._seed = seed if seed is not None else 0
        self._generator: Optional[torch.Generator] = None
        self.user_features_embeddings = None   # W (n_user_feat, r)
        self.item_features_embeddings = None   # H (n_item_feat, r)
        self._accW = self._accH = None
        self._item_features = self._user_features = None
        self._identity_user_feats = self._identity_item_feats = False
        self._components_cache = None
        self.auc_history = []
        self.stage_info: dict = {}

    @property
    def _gen(self) -> torch.Generator:
        """The generator on the model's device that draws each minibatch's
        (S, K + 2) sampling bits, seeded with ``seed`` (made at first use)."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self._seed)
        return self._generator

    def _init_tables(self, nuf: int, nif: int):
        kw = dict(dtype=self.dtype, device=self.device)
        if self.user_features_embeddings is None:
            self.user_features_embeddings = torch.tensor(
                self._rng.standard_normal((nuf, self.rank)) * 1e-3, **kw)
            self._accW = torch.ones((nuf,), **kw)
        if self.item_features_embeddings is None:
            self.item_features_embeddings = torch.tensor(
                self._rng.standard_normal((nif, self.rank)) * 1e-3, **kw)
            self._accH = torch.ones((nif,), **kw)

    def partial_fit_transform(self, x: sp.spmatrix, item_features=None,
                              user_features=None, n_iter: int = 100,
                              update_items: bool = True):
        """Run ``n_iter * n_user`` pairwise updates (rounded up to whole
        chunks of ``CHUNK`` batches, as the reference does); returns user
        embeddings (reference R/model_RankMF.R:86-160)."""
        csr = sp.csr_matrix(x)
        csr.sort_indices()
        n_user, n_item = csr.shape
        self.item_ids = get_names(x, 1)
        self._identity_item_feats = item_features is None
        self._identity_user_feats = user_features is None
        if item_features is None:
            item_features = sp.identity(n_item, format="csr")
        if user_features is None:
            user_features = sp.identity(n_user, format="csr")
        item_features = sp.csr_matrix(item_features)
        user_features = sp.csr_matrix(user_features)
        if user_features.shape[0] != n_user:
            raise ValueError("user_features rows must match n_users")
        if item_features.shape[0] != n_item:
            raise ValueError("item_features rows must match n_items")
        self._item_features = item_features
        self._user_features = user_features
        nuf, nif = user_features.shape[1], item_features.shape[1]
        self._nuf, self._nif = nuf, nif
        t0 = time.perf_counter()
        self._init_tables(nuf, nif)
        t1 = time.perf_counter()

        dt_key = (str(self.dtype), str(self.device))
        uf = None if self._identity_user_feats else staged_cached(
            "rankmf_uf", user_features,
            lambda: _pad_features(user_features, self.dtype, self.device),
            extra=dt_key)
        itf = None if self._identity_item_feats else staged_cached(
            "rankmf_if", item_features,
            lambda: _pad_features(item_features, self.dtype, self.device),
            extra=dt_key)
        pos = staged_cached("rankmf_x", csr,
                            lambda: _stage_positives(csr, self.device),
                            extra=str(self.device))
        t2 = time.perf_counter()
        #: the staged interactions and hash sets of the last call
        self._positives = pos

        S = min(self.batch_size, max(n_user, 8))
        K = min(self.max_negative_samples, n_item)
        n_batches = max(n_iter * n_user // S, 1)
        n_batches = -(-n_batches // CHUNK) * CHUNK
        cfg = BatchConfig(S, K, self.loss, self.kernel, self.optimizer,
                          bool(update_items))
        hp = BatchParams(self.learning_rate, self.gamma, self.lambda_user,
                         self.lambda_item_positive,
                         self.lambda_item_negative, self.margin)
        #: host walls of this call's set-up (the table draw; the staging of
        #: the positives, hash sets and features, ~0 on a cache hit) and its
        #: batch count
        self.stage_info = {"init_s": t1 - t0, "staging_s": t2 - t1,
                           "batches": n_batches, "updates": n_batches * S}
        W, H = self.user_features_embeddings, self.item_features_embeddings
        counts = []
        for bi in range(n_batches):
            bits = torch.randint(0, 1 << 32, (S, K + 2), generator=self._gen,
                                 dtype=torch.int64, device=self.device)
            c = _rankmf_batch(W, H, self._accW, self._accH, bits, pos, uf,
                              itf, hp, cfg, n_item)
            if bi >= n_batches - CHUNK:
                counts.append(c)
        # the last chunk's counters (the freshest estimate)
        tot = torch.stack(counts).sum(0).cpu()
        self.auc_history.append(int(tot[0]) / max(int(tot[1]), 1))
        logger.info("RankMF: %d updates, AUC~%.3f", n_batches * S,
                    self.auc_history[-1])

        self._components_cache = None
        if self._identity_user_feats:
            return W.clone()
        return user_features @ W.double().cpu().numpy()

    @property
    def components(self):
        if (self._components_cache is None
                and self.item_features_embeddings is not None):
            H = self.item_features_embeddings.double().cpu().numpy()
            if self._identity_item_feats:
                self._components_cache = np.ascontiguousarray(H.T)
            else:
                self._components_cache = np.asarray(
                    (self._item_features @ H).T)
        return self._components_cache

    @components.setter
    def components(self, value):
        self._components_cache = value

    def transform(self, x: sp.spmatrix):
        """Embed known users (by their trained feature embeddings)."""
        if self.user_features_embeddings is None:
            raise RuntimeError("model is not fitted")
        W = self.user_features_embeddings
        if self._user_features is None or self._identity_user_feats:
            if x.shape[0] != self._nuf:
                raise ValueError(
                    f"x has {x.shape[0]} rows but the model was trained "
                    f"with identity features for {self._nuf} users")
            return W.clone()
        return self._user_features @ W.double().cpu().numpy()
