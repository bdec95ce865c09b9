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
or bfloat16 tables and a rank of at most ``MAX_RANK``.

``precision="bfloat16"`` keeps W, H, accW, accH and the side features'
values at bf16, as the JAX package does, and gives its bf16 results: the
scalars (learning rate, gamma, lambdas, margin) are rounded to bf16 as
the reference's are (``jnp.asarray(v, W.dtype)``), and every value is
rounded where the JAX function run op by op rounds it, each op whose
result is bf16 (:func:`_rankmf_batch_plain_bf16` spells them out).  Which
rule each scatter-add of the batch meets, read from ``jax.make_jaxpr`` of
``rsparse_tpu/models/rankmf.py:_rankmf_batch`` in each mode (BPR / WARP x
identity / sigmoid x AdaGrad / RMSprop, with and without side features,
with and without x64):

  ==========================  ===============  ==============================
  scatter                     update dtype     rule
  ==========================  ===============  ==============================
  accW / accH (AdaGrad g^2)   bfloat16         one rounding a duplicate
  RMSprop count, accW / accH  bfloat16         one rounding a duplicate
  W / H (-lr step)            bfloat16         one rounding a duplicate
  ==========================  ===============  ==============================

Every mode meets the same rule: in WARP the rank weight's factor
``log1p((n_item - 1.0) / (first_k + 1.0) + 1.0)`` is a weakly typed float
and is cast to bf16 (through float32) before it multiplies the bf16
weight, so no gradient is promoted to float32.  So a feature row's
duplicate updates are added one at a time in the batch's update order
(the users' by sample; the items' positives, then negatives), each add
rounded to bf16: a hot row whose increments are below half a spacing
stays where it is.  XLA's CPU ``jit`` fuses some elementwise chains and
skips their bf16 roundings, so a jitted fit of the JAX package sits a
little apart from the op-by-op semantics the port follows
(tests/test_torch_rankmf_bf16.py measures both).

On a mesh (``mesh=parallel.mesh.make_mesh(...)``, every rank calling the
same code) W, H, accW and accH are this rank's row shards
(``parallel/sgd_sharded.py``).  K9 turns the bits into table rows inside
the kernel, so a batch's rows cannot be relabelled beforehand: each batch
finds the feature rows its bits reach (:func:`batch_rows`, on the device),
gathers them of the four tables (one all-reduce), runs K9 in its row-map
mode (feature row -> compact row, two (n_feat,) int32 maps kept by the
model and reset after each batch) and writes back the rows this rank owns.
Every rank draws the same bits (the same seed; checked at the end of each
call); ``components``, ``transform`` and the embeddings returned are whole.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import _kernels
from ..config import bf16_value, logger, resolve_dtype
from ..config import round_bf16 as _rb
from ..ops.segsum import ordered_add_
from ..parallel import sgd_sharded as sgd
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


def _rows(rowmap: Optional[torch.Tensor], f: torch.Tensor) -> torch.Tensor:
    """Table rows of feature rows ``f``: ``rowmap[f]`` in K9's row-map mode
    (compact tables), else ``f``."""
    return f.long() if rowmap is None else rowmap[f.long()].long()


def _combine(emb: torch.Tensor, feats: Optional[_Feats],
             ids: torch.Tensor,
             rowmap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Feature-combined embeddings of entities ``ids``: (..., r).
    ``feats=None`` is the identity feature matrix: one row gather."""
    if feats is None:
        return emb[_rows(rowmap, ids)]
    fi = _rows(rowmap, feats.idx[ids])          # (..., F)
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


def _apply_plain(emb, acc, feats, ids, grad, lam, comb, lr, gamma, optimizer,
                 rowmap=None):
    """Scatter one stacked entity set's update into its feature embeddings
    (rsparse_tpu/models/rankmf.py:290-329)."""
    r = emb.shape[1]
    nz = (grad != 0).any(1)
    if feats is None:
        fi = _rows(rowmap, ids[:, None])
        fmask = nz[:, None]
    else:
        fi = _rows(rowmap, feats.idx[ids])
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


def _decode(bits, pos: _Positives, n_item: int):
    """A batch's samples from its uint32 ``bits`` (S, K + 2), as K9 decodes
    them (rsparse_tpu/models/rankmf.py:226-237): users u, whether each has
    positives, the positives i and the K candidates (S, K), all int64."""
    b = bits.long() & 0xFFFFFFFF
    n_user = pos.row_nnz.shape[0]
    u = b[:, 0] % n_user
    nnz_u = pos.row_nnz[u].long()
    p = (pos.indptr[u].long() + b[:, 1] % nnz_u.clamp(min=1)).clamp(
        0, pos.flat_idx.shape[0] - 1)
    return u, nnz_u > 0, pos.flat_idx[p].long(), b[:, 2:] % n_item


def _rankmf_batch_plain(W, H, accW, accH, bits, pos: _Positives,
                        uf: Optional[_Feats], itf: Optional[_Feats],
                        hp: BatchParams, cfg: BatchConfig, n_item: int,
                        wmap: Optional[torch.Tensor] = None,
                        hmap: Optional[torch.Tensor] = None):
    """Plain version of K9 (rsparse_tpu/models/rankmf.py:202) on the JAX
    package's arithmetic: samples from ``bits`` (S, K + 2), scores every
    candidate, takes the first acceptable one, then updates W, H, accW
    and accH in place.  Returns int64 counters [auc_num, auc_den, found,
    n_tried] (auc_den = max(valid samples, 1)).  With ``wmap`` / ``hmap``
    (K9's row-map mode, :func:`batch_rows`) the tables are compact and
    feature row f is table row ``map[f]``."""
    S, K = cfg.S, cfg.K
    u, valid, i, j_cand = _decode(bits, pos, n_item)
    w_u = _combine(W, uf, u, wmap)
    h_i = _combine(H, itf, i, hmap)
    is_neg = ~_in_hash_set(pos.table, pos.boff, pos.bmask, pos.bshift, u,
                           j_cand)
    h_j_all = _combine(H, itf, j_cand, hmap)             # (S, K, r)
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
                 hp.gamma, cfg.optimizer, wmap)
    if cfg.update_items:
        _apply_plain(H, accH, itf, torch.cat([i, j]),
                     torch.cat([grad_ip, grad_in]),
                     torch.cat([full(hp.lam_ip), full(hp.lam_in)]),
                     torch.cat([h_i, h_j]), hp.lr, hp.gamma, cfg.optimizer,
                     hmap)
    return torch.stack([auc_num, auc_den, found.sum(), tried.sum()]).long()


def _sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """The logistic of bf16 values as XLA expands it at bf16: 1 / (1 +
    exp(-x)), each op rounded."""
    return _rb(1.0 / _rb(1.0 + _rb(torch.exp(-x))))


def _combine_bf16(emb, feats, ids, rowmap=None) -> torch.Tensor:
    """:func:`_combine` of a bf16 table as float32 bf16 values: a feature
    combination is one f32 sum rounded once (the reference's einsum)."""
    if feats is None:
        return emb[_rows(rowmap, ids)].float()
    fi = _rows(rowmap, feats.idx[ids])
    fv = torch.where(feats.mask[ids], feats.val[ids].float(), 0.0)
    return _rb(torch.einsum("...f,...fr->...r", fv, emb[fi].float()))


def _apply_plain_bf16(emb, acc, feats, ids, grad, lam, comb, lr, gamma,
                      optimizer, rowmap=None):
    """:func:`_apply_plain` on bf16 tables (float32 ``grad``, ``lam``,
    ``comb`` holding bf16 values): each op rounded, every scatter-add one
    rounding a duplicate in update order (:func:`ordered_add_`)."""
    r = emb.shape[1]
    nz = (grad != 0).any(1)
    if feats is None:
        fi = _rows(rowmap, ids[:, None])
        fmask = nz[:, None]
    else:
        fi = _rows(rowmap, feats.idx[ids])
        fmask = feats.mask[ids] & nz[:, None]
    g2 = _rb(_rb(_rb(grad * grad).sum(1)) / bf16_value(r))
    rows = fi[fmask]                                  # update order
    if optimizer == ADAGRAD:
        ordered_add_(acc, rows, g2[:, None].expand(fi.shape)[fmask])
    else:
        old = acc[fi].float()
        cnt = torch.zeros_like(acc)
        ordered_add_(cnt, rows, torch.ones_like(rows, dtype=torch.float32))
        n_dup = cnt[fi].float().clamp(min=1.0)
        gm1, omg = bf16_value(gamma - 1.0), bf16_value(1.0 - gamma)
        delta = _rb(_rb(_rb(gm1 * old) / n_dup) + _rb(omg * g2[:, None]))
        ordered_add_(acc, rows, delta[fmask])
    denom = _rb(torch.sqrt(_rb(acc[fi].float() + bf16_value(EPS))))
    step = _rb(_rb(grad[:, None, :] / denom[..., None])
               + _rb(lam[:, None, None] * comb[:, None, :]))
    ordered_add_(emb, rows, _rb(-lr * step)[fmask])


def _rankmf_batch_plain_bf16(W, H, accW, accH, bits, pos: _Positives,
                             uf: Optional[_Feats], itf: Optional[_Feats],
                             hp: BatchParams, cfg: BatchConfig, n_item: int,
                             wmap: Optional[torch.Tensor] = None,
                             hmap: Optional[torch.Tensor] = None):
    """:func:`_rankmf_batch_plain` on bf16 tables (``hp`` bf16 values),
    rounding where the JAX function run op by op rounds: every op whose
    result is bf16, the products of r_ui before their sum, r_uj and each
    feature combination as one f32 sum, the logistic as
    bf16(1 / bf16(1 + bf16(exp(-x)))), the WARP factor cast to bf16
    through float32; every scatter-add one rounding a duplicate in the
    batch's update order."""
    S = cfg.S
    u, valid, i, j_cand = _decode(bits, pos, n_item)
    w_u = _combine_bf16(W, uf, u, wmap)
    h_i = _combine_bf16(H, itf, i, hmap)
    is_neg = ~_in_hash_set(pos.table, pos.boff, pos.bmask, pos.bshift, u,
                           j_cand)
    h_j_all = _combine_bf16(H, itf, j_cand, hmap)
    r_ui = _rb(_rb(w_u * h_i).sum(1))
    r_uj = _rb(torch.einsum("sr,skr->sk", w_u, h_j_all))
    if cfg.kernel == SIGMOID:
        r_ui_k, r_uj_k = _sigmoid_bf16(r_ui), _sigmoid_bf16(r_uj)
        hi_adj = _rb(r_ui_k * _rb(1 - r_ui_k))
        hj_adj_all = _rb(r_uj_k * _rb(1 - r_uj_k))
        d = _rb(r_uj_k - r_ui_k[:, None])
    else:
        hi_adj = torch.ones_like(r_ui)
        hj_adj_all = torch.ones_like(r_uj)
        d = _rb(r_uj - r_ui[:, None])
    acceptable = (is_neg if cfg.loss == BPR
                  else is_neg & (_rb(d + hp.margin) >= 0))
    found, first_k, tried = _first_acceptable(acceptable, valid)
    sel = lambda a: a.gather(1, first_k[:, None])[:, 0]  # noqa: E731
    j = sel(j_cand)
    d_sel, hj_adj = sel(d), sel(hj_adj_all)
    h_j = h_j_all[torch.arange(S, device=W.device), first_k]
    weight = _sigmoid_bf16(d_sel)
    if cfg.loss == WARP:
        fac = torch.log1p((n_item - 1.0) / (first_k.double() + 1.0) + 1.0)
        norm = bf16_value(np.log1p(float(n_item) + 1.0))
        weight = _rb(_rb(weight * _rb(fac.float())) / norm)
    weight = torch.where(found, weight, 0.0)
    auc_num = (is_neg[:, 0] & (d[:, 0] < 0) & valid).sum()
    auc_den = valid.sum().clamp(min=1)

    grad_u = _rb(weight[:, None] * _rb(_rb(hj_adj[:, None] * h_j)
                                       - _rb(hi_adj[:, None] * h_i)))
    grad_ip = _rb(_rb(-weight[:, None] * hi_adj[:, None]) * w_u)
    grad_in = _rb(_rb(weight[:, None] * hj_adj[:, None]) * w_u)
    full = lambda v: torch.full((S,), v, dtype=torch.float32,  # noqa: E731
                                device=W.device)
    _apply_plain_bf16(W, accW, uf, u, grad_u, full(hp.lam_u), w_u, hp.lr,
                      hp.gamma, cfg.optimizer, wmap)
    if cfg.update_items:
        _apply_plain_bf16(H, accH, itf, torch.cat([i, j]),
                          torch.cat([grad_ip, grad_in]),
                          torch.cat([full(hp.lam_ip), full(hp.lam_in)]),
                          torch.cat([h_i, h_j]), hp.lr, hp.gamma,
                          cfg.optimizer, hmap)
    return torch.stack([auc_num, auc_den, found.sum(), tried.sum()]).long()


def _feat_args(f: Optional[_Feats], name: str, n: int, dtype):
    if f is None:
        return (None, None, None), 0
    F = f.idx.shape[1]
    _kernels.check_tensor(f"{name}.idx", f.idx, (n, F), torch.int32)
    _kernels.check_tensor(f"{name}.val", f.val, (n, F), dtype)
    _kernels.check_tensor(f"{name}.mask", f.mask, (n, F), torch.bool)
    return (f.idx, f.val, f.mask), F


def _walk_pairs(iscr: torch.Tensor, S: int, F: int, feats, rowmap,
                es) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (table row, update) pairs of one table in the order K9's bf16
    instance walks them (its launch A writes the rows, its launch G sorts
    them on the device), sorted stably by row: the plain oracle of that
    order, for the tests.  ``es`` the staged entity kinds that
    update it, in the reference's update order (W: (0,) users; H: (1, 2)
    positives, then negatives), each by sample and feature slot.  Returns
    int32 (keys, codes): the row, -1 where the pair updates nothing, and
    q F + l (staged entity q = 3 s + e, slot l)."""
    ids = iscr[:3 * S].view(S, 3).long()
    flag = iscr[3 * S:].view(S, 3) != 0
    s3 = 3 * torch.arange(S, device=iscr.device)
    keys, codes = [], []
    for e in es:
        if feats is None:
            rows = ids[:, e:e + 1]
            m = flag[:, e:e + 1]
        else:
            rows = feats.idx[ids[:, e]].long()
            m = feats.mask[ids[:, e]] & flag[:, e:e + 1]
        if rowmap is not None:
            rows = rowmap[rows].long()
        keys.append(torch.where(m, rows, -1).reshape(-1))
        codes.append(((s3 + e)[:, None] * F + torch.arange(
            rows.shape[1], device=iscr.device)[None, :]).reshape(-1))
    k, perm = torch.sort(torch.cat(keys), stable=True)
    return k.to(torch.int32), torch.cat(codes)[perm].to(torch.int32)


#: K9's scratch of the last batch shape: (key, (iscratch, fscratch,
#: gscratch)), reused by every batch of a fit (the batches run in order on
#: one stream)
_SCRATCH: list = [None, None]


def _scratch(dev, S: int, r: int, F: int, rms: bool, bf16: bool, Fu: int,
             Fi: int, update_items: bool):
    """K9's int and float scratch and, at bf16, the ints of its device
    pair lists and sort (``rsp_rankmf_group_ints``); allocated when the
    batch shape changes."""
    key = (str(dev), S, r, F, rms, bf16, Fu, Fi, bool(update_items))
    if _SCRATCH[0] != key:
        _SCRATCH[:] = [None, None]   # free the last shape's first
        n_g = (_kernels.lib().rsp_rankmf_group_ints(S, Fu, Fi,
                                                    int(update_items))
               if bf16 else 0)
        _SCRATCH[:] = [key, (
            torch.empty((2 * 3 * S,), dtype=torch.int32, device=dev),
            torch.empty((3 * S * (1 + 2 * r + (F if rms else 0)),),
                        dtype=torch.float32, device=dev),
            torch.empty((n_g,), dtype=torch.int32, device=dev)
            if bf16 else None)]
    return _SCRATCH[1]


def _rankmf_batch_cuda(W, H, accW, accH, bits, pos: _Positives,
                       uf: Optional[_Feats], itf: Optional[_Feats],
                       hp: BatchParams, cfg: BatchConfig, n_item: int,
                       wmap: Optional[torch.Tensor] = None,
                       hmap: Optional[torch.Tensor] = None,
                       stages: int = 2):
    """K9 on CUDA tensors (see :func:`_rankmf_batch`), float32 or bf16
    tables (``hp`` bf16 values at bf16).  ``stages`` 1 stops after launch
    A, for timing it apart: the counters are left unclamped and the tables
    unchanged, but AdaGrad's accumulators (the float32 instance)."""
    S, K = cfg.S, cfg.K
    nuf, r = W.shape
    nif = H.shape[0]
    n_user = pos.row_nnz.shape[0]
    if r > MAX_RANK:
        raise ValueError(f"RankMF rank {r}: the CUDA kernel takes at most "
                         f"{MAX_RANK}")
    tdt = W.dtype
    if tdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K9 takes float32 or bfloat16 tables, not {tdt}")
    bf16 = tdt == torch.bfloat16
    f32, i32 = torch.float32, torch.int32
    _kernels.check_tensor("W", W, (nuf, r), tdt)
    _kernels.check_tensor("H", H, (nif, r), tdt)
    _kernels.check_tensor("accW", accW, (nuf,), tdt)
    _kernels.check_tensor("accH", accH, (nif,), tdt)
    _kernels.check_tensor("bits", bits, (S, K + 2), torch.int64)
    _kernels.check_tensor("flat_idx", pos.flat_idx, pos.flat_idx.shape, i32)
    lanes = pos.table.shape[1]
    if not 1 <= lanes <= 32:
        raise ValueError(f"hash table of {lanes} lanes: K9 takes 1 to 32")
    _kernels.check_tensor("table", pos.table, pos.table.shape, i32)
    for name in ("indptr", "row_nnz", "boff", "bmask", "bshift"):
        _kernels.check_tensor(name, getattr(pos, name), (n_user,), i32)
    (ui, uv, um), Fu = _feat_args(uf, "user_features", n_user, tdt)
    (ii, iv, im), Fi = _feat_args(itf, "item_features", n_item, tdt)
    if (wmap is None) != (hmap is None):
        raise ValueError("K9's row-map mode takes both wmap and hmap")
    for name, t in (("wmap", wmap), ("hmap", hmap)):
        if t is not None:
            _kernels.check_tensor(name, t, (t.shape[0],), i32)
    dev = W.device
    F = max(Fu, Fi, 1)
    rms = cfg.optimizer == RMSPROP and not bf16
    iscr, fscr, gscr = _scratch(dev, S, r, F, rms, bf16, Fu, Fi,
                                cfg.update_items)
    cntW = torch.zeros((nuf,), dtype=f32, device=dev) if rms else None
    cntH = (torch.zeros((nif,), dtype=f32, device=dev)
            if rms and cfg.update_items else None)
    counters = torch.empty((4,), dtype=torch.int64, device=dev)
    norm = float(np.log1p(float(n_item) + 1.0))
    args = _kernels.RankMFArgs(
        *(_kernels.ptr(t) for t in (
            bits, pos.flat_idx, pos.indptr, pos.row_nnz, pos.table, pos.boff,
            pos.bmask, pos.bshift, ui, uv, um, ii, iv, im, W, H, accW, accH,
            iscr, fscr, cntW, cntH, counters, wmap, hmap, gscr)),
        S, K, r, n_user, n_item, pos.flat_idx.shape[0], lanes, Fu, Fi,
        cfg.loss, cfg.kernel, cfg.optimizer, int(cfg.update_items), int(bf16),
        nuf, nif, hp.lr, hp.gamma, hp.lam_u, hp.lam_ip, hp.lam_in, hp.margin,
        bf16_value(norm) if bf16 else norm)
    rc = _kernels.lib().rsp_rankmf_batch(
        ctypes.byref(args), ctypes.c_int(int(stages)), _kernels.stream(dev))
    _kernels.check(rc, "rankmf")
    _kernels.launches[("rankmf" if wmap is None else "rankmf_rowmap")
                      + ("_bf16" if bf16 else "")] += 1
    return counters


def _rankmf_batch(W, H, accW, accH, bits, pos: _Positives,
                  uf: Optional[_Feats], itf: Optional[_Feats],
                  hp: BatchParams, cfg: BatchConfig, n_item: int,
                  wmap: Optional[torch.Tensor] = None,
                  hmap: Optional[torch.Tensor] = None):
    """One minibatch of pairwise updates from the uint32 ``bits`` (S, K + 2)
    held in an int64 tensor; W, H and their accumulators change in place.
    Returns int64 counters [auc_num, auc_den, found, n_tried].  With
    ``wmap`` / ``hmap`` the tables are compact and feature row f is table
    row ``map[f]`` (K9's row-map mode, :func:`batch_rows`).  CPU tensors
    take the plain version (bf16 tables :func:`_rankmf_batch_plain_bf16`);
    CUDA tensors launch K9."""
    if W.device.type != "cpu":
        fn = _rankmf_batch_cuda
    elif W.dtype == torch.bfloat16:
        fn = _rankmf_batch_plain_bf16
    else:
        fn = _rankmf_batch_plain
    return fn(W, H, accW, accH, bits, pos, uf, itf, hp, cfg, n_item,
              wmap=wmap, hmap=hmap)


def batch_rows(bits, pos: _Positives, uf: Optional[_Feats],
               itf: Optional[_Feats], n_item: int):
    """The feature rows of W and of H that a batch of ``bits`` can read or
    write, each sorted and distinct (int64, on the bits' device): the
    sampled users' features, the positives' and every candidate's (a
    padding feature slot counts: the plain version reads its row times
    0).  Decoded as K9 decodes them."""
    u, _, i, j_cand = _decode(bits, pos, n_item)
    items = torch.cat([i, j_cand.reshape(-1)])
    rows_w = u if uf is None else uf.idx[u].reshape(-1)
    rows_h = items if itf is None else itf.idx[items].reshape(-1)
    return torch.unique(rows_w.long()), torch.unique(rows_h.long())


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
        super().__init__(device)
        #: a ``parallel.mesh.Mesh``: W, H and their accumulators row-sharded
        #: over its table axes (``parallel/sgd_sharded.py``); None runs on
        #: ``device``
        self.mesh = mesh
        self._ops = None
        if mesh is not None:
            self._ops = sgd.ShardedOps(mesh)
            self.device = mesh.device
        self._maps = None
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
        self.dtype = resolve_dtype(precision)
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

    def _draw_bits(self, S: int, K: int) -> torch.Tensor:
        """One batch's (S, K + 2) uint32 sampling bits, as int64."""
        return torch.randint(0, 1 << 32, (S, K + 2), generator=self._gen,
                             dtype=torch.int64, device=self.device)

    def _sharded_tables(self):
        """The row-sharded tables on a mesh and their logical rows."""
        if self.user_features_embeddings is None:
            return {}
        return {"user_features_embeddings": self._nuf, "_accW": self._nuf,
                "item_features_embeddings": self._nif, "_accH": self._nif}

    def _whole(self, name: str) -> torch.Tensor:
        """Table ``name`` whole (on a mesh an all-gather: every rank calls
        it)."""
        t = getattr(self, name)
        if self.mesh is None:
            return t
        return sgd.unshard(t, self._sharded_tables()[name], self.mesh)

    def _init_tables(self, nuf: int, nif: int):
        kw = dict(dtype=self.dtype, device=self.device)
        # on a mesh every rank draws each table whole and keeps its shard
        place = ((lambda a: torch.tensor(a, **kw)) if self.mesh is None else
                 (lambda a: sgd.shard_table(a, self.mesh, dtype=self.dtype)))
        if self.user_features_embeddings is None:
            self.user_features_embeddings = place(
                self._rng.standard_normal((nuf, self.rank)) * 1e-3)
            self._accW = place(np.ones((nuf,)))
        if self.item_features_embeddings is None:
            self.item_features_embeddings = place(
                self._rng.standard_normal((nif, self.rank)) * 1e-3)
            self._accH = place(np.ones((nif,)))

    def _mesh_batch(self, bits, pos, uf, itf, hp, cfg, n_item):
        """One batch on the mesh: gather the rows the bits reach, K9 in its
        row-map mode on them, write back this rank's rows (module
        docstring)."""
        ops = self._ops
        tabs = (self.user_features_embeddings, self._accW,
                self.item_features_embeddings, self._accH)
        if self._maps is None or self._maps[0].shape[0] != self._nuf or \
                self._maps[1].shape[0] != self._nif:
            self._maps = tuple(torch.full((n,), -1, dtype=torch.int32,
                                          device=self.device)
                               for n in (self._nuf, self._nif))
        wmap, hmap = self._maps
        rows_w, rows_h = batch_rows(bits, pos, uf, itf, n_item)
        Wc, aWc, Hc, aHc = ops.gather_many(
            [(tabs[0], rows_w), (tabs[1], rows_w), (tabs[2], rows_h),
             (tabs[3], rows_h)])
        for m, rows in ((wmap, rows_w), (hmap, rows_h)):
            m[rows] = torch.arange(rows.shape[0], dtype=torch.int32,
                                   device=m.device)
        with ops.phase("kernel_s"):
            c = _rankmf_batch(Wc, Hc, aWc, aHc, bits, pos, uf, itf, hp, cfg,
                              n_item, wmap=wmap, hmap=hmap)
        sgd.put_rows(ops, tabs[:2], rows_w, (Wc, aWc))
        sgd.put_rows(ops, tabs[2:], rows_h, (Hc, aHc))
        wmap[rows_w] = -1
        hmap[rows_h] = -1
        return c

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
        if self.dtype == torch.bfloat16:
            # the reference's scalars ride at the table dtype
            hp = BatchParams(*(bf16_value(v) for v in hp))
        #: host walls of this call's set-up (the table draw; the staging of
        #: the positives, hash sets and features, ~0 on a cache hit) and its
        #: batch count
        self.stage_info = {"init_s": t1 - t0, "staging_s": t2 - t1,
                           "batches": n_batches, "updates": n_batches * S}
        W, H = self.user_features_embeddings, self.item_features_embeddings
        counts = []
        draws = 0    # on a mesh: the bits' running checksum
        for bi in range(n_batches):
            bits = self._draw_bits(S, K)
            if self.mesh is None:
                c = _rankmf_batch(W, H, self._accW, self._accH, bits, pos,
                                  uf, itf, hp, cfg, n_item)
            else:
                draws = draws + sgd.checksum(bits)
                c = self._mesh_batch(bits, pos, uf, itf, hp, cfg, n_item)
            if bi >= n_batches - CHUNK:
                counts.append(c)
        if self.mesh is not None:
            self._ops.check_same(draws, "RankMF sampling bits")
        # the last chunk's counters (the freshest estimate)
        tot = torch.stack(counts).sum(0).cpu()
        self.auc_history.append(int(tot[0]) / max(int(tot[1]), 1))
        logger.info("RankMF: %d updates, AUC~%.3f", n_batches * S,
                    self.auc_history[-1])

        self._components_cache = None
        W = self._whole("user_features_embeddings")
        if self._identity_user_feats:
            return W.clone()
        return user_features @ W.double().cpu().numpy()

    @property
    def components(self):
        """(rank, n_items) item embeddings (on a mesh the first read
        gathers H: every rank reads it)."""
        if (self._components_cache is None
                and self.item_features_embeddings is not None):
            H = self._whole("item_features_embeddings").double().cpu(
                ).numpy()
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
        W = self._whole("user_features_embeddings")
        if self._user_features is None or self._identity_user_feats:
            if x.shape[0] != self._nuf:
                raise ValueError(
                    f"x has {x.shape[0]} rows but the model was trained "
                    f"with identity features for {self._nuf} users")
            return W.clone()
        return self._user_features @ W.double().cpu().numpy()
