"""GloVe: Global Vectors embeddings.

Port of ``rsparse_tpu/models/glove.py`` (reference R/model_GloVe.R:13-183
over src/GloVe.cpp:5-158): deterministic minibatched AdaGrad over the
co-occurrence triplets, the reference's exact per-triplet math
  weight = min((x / x_max)^alpha, 1)
  inner = clip(w_i.w_j + b_i + b_j - log x, +-100),  cost = weight * inner
with accumulators initialised to ones, accumulator first (a feature's step
over a minibatch is ``-lr * sum(g) / sqrt(acc + sum(g^2))``), and the epoch
loss ``0.5 * sum(cost * inner)``.

An epoch walks, in the reference's order, the dense head block of the
hottest tokens in square tiles (K11, ``csrc/glove_dense.cu``; plain version
:func:`_glove_tile_plain`), then the remaining triplets in stride-interleaved
shards of ``batch_size`` (K10, ``csrc/glove.cu``; plain version
:func:`_glove_shard_plain`), and for a triangular input both again on the
transposed triplets.  CPU tensors take the plain versions.  Each tile and
each shard reads the state it starts from and updates the tables in place.

The head grid lives on the device once, at the grid dtype, and a tile is a
view of it (the transposed pass a view of its transpose): the reference's
padded and re-tiled host copies are not made, and a tile's padding
positions, whose counts are all zero and whose updates are zero, are left
out.  The shuffle permutes the staged shards on the device with a
``torch.Generator`` seeded from the model's numpy RNG (other bits than
``jax.random``), and rebuilds the shards' slot maps.

On the card both kernels take float32 state and a rank of at most
``MAX_RANK``, and the head a float32 or bfloat16 grid:
``precision="double"`` runs on the CPU only.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import _kernels
from ..config import logger, resolve_dtype
from ..ops.segsum import ShardMaps, shard_slot_maps

CLIP_VALUE = 100.0
#: widest embedding K10 and K11 take (csrc/glove.cu, csrc/glove_dense.cu
#: kMaxR)
MAX_RANK = 128


class GloveState(NamedTuple):
    w_i: torch.Tensor      # (n, r) main embeddings
    w_j: torch.Tensor      # (n, r) context embeddings
    b_i: torch.Tensor      # (n,)
    b_j: torch.Tensor      # (n,)
    acc_w_i: torch.Tensor  # squared-grad accumulators (init ones)
    acc_w_j: torch.Tensor
    acc_b_i: torch.Tensor
    acc_b_j: torch.Tensor


class Shard(NamedTuple):
    """One tail shard as K10 takes it: N entries (row id, column id,
    count) and each side's slot map (``feats`` the distinct ids of the
    valid entries, ``slot`` each entry's index into them, ``len(feats)`` at
    padding)."""

    rows: torch.Tensor     # (N,) int32
    cols: torch.Tensor     # (N,) int32
    vals: torch.Tensor     # (N,) float
    feats_r: torch.Tensor  # (U_r,) int32
    slot_r: torch.Tensor   # (N,) int32
    feats_c: torch.Tensor  # (U_c,) int32
    slot_c: torch.Tensor   # (N,) int32


class Shards(NamedTuple):
    """The staged tail: (S, N) stacked shards and their slot maps."""

    rows: torch.Tensor   # (S, N) int32
    cols: torch.Tensor   # (S, N) int32
    vals: torch.Tensor   # (S, N) float
    valid: torch.Tensor  # (S, N) bool
    maps_r: ShardMaps
    maps_c: ShardMaps

    @classmethod
    def build(cls, rows, cols, vals, valid) -> "Shards":
        return cls(rows, cols, vals, valid, shard_slot_maps(rows, valid),
                   shard_slot_maps(cols, valid))

    def shard(self, s: int) -> Shard:
        return Shard(self.rows[s], self.cols[s], self.vals[s],
                     *self.maps_r.shard(s), *self.maps_c.shard(s))

    def swapped(self) -> "Shards":
        """The transposed triplets: roles, and with them the maps, swap."""
        return Shards(self.cols, self.rows, self.vals, self.valid,
                      self.maps_c, self.maps_r)


class HeadGrid(NamedTuple):
    """The dense head on the device: ``x[a, b]`` counts hot token
    ``ids[a]`` with ``ids[b]`` at the grid dtype (0 = absent), walked in
    ``nt`` x ``nt`` square tiles of ``side`` positions."""

    ids: torch.Tensor  # (H,) int32
    x: torch.Tensor    # (H, H), possibly a transposed view
    side: int
    nt: int

    def transposed(self) -> "HeadGrid":
        return self._replace(x=self.x.T)


# -- K10: one sparse-tail shard ----------------------------------------------

def _adagrad_apply(w, b, acc_w, acc_b, ids, sg, sg2, sc, sc2, lr):
    """Accumulator-first AdaGrad at distinct ``ids`` from the sums of g, g²
    (rows of w) and of cost, cost² (b)."""
    aw = acc_w[ids] + sg2
    w.index_add_(0, ids, -lr * sg / torch.sqrt(aw))
    acc_w[ids] = aw
    ab = acc_b[ids] + sc2
    b.index_add_(0, ids, -lr * sc / torch.sqrt(ab))
    acc_b[ids] = ab


def _glove_shard_plain(st: GloveState, sh: Shard, x_max: float,
                       alpha: float, lr: float) -> torch.Tensor:
    """Plain version of K10 (rsparse_tpu/models/glove.py:50, one scan
    step): every valid entry's cost from the shard-start tables, per-slot
    sums of its updates by ``index_add_``, then the AdaGrad steps at each
    side's distinct ids.  Returns the shard's sum(cost * inner)."""
    valid = sh.slot_r < sh.feats_r.shape[0]
    i, j = sh.rows[valid].long(), sh.cols[valid].long()
    v = sh.vals[valid].to(st.w_i.dtype)
    wi, wj = st.w_i[i], st.w_j[j]
    inner = torch.clamp((wi * wj).sum(1) + st.b_i[i] + st.b_j[j]
                        - torch.log(v), -CLIP_VALUE, CLIP_VALUE)
    weight = torch.where(v < x_max, torch.pow(v / x_max, alpha), 1.0)
    cost = weight * inner
    r = wi.shape[1]
    # each side with its (w, b, acc_w, acc_b) tables
    for feats, slot, g, t in (
            (sh.feats_r, sh.slot_r, cost[:, None] * wj, st[0::2]),
            (sh.feats_c, sh.slot_c, cost[:, None] * wi, st[1::2])):
        s = torch.zeros((feats.shape[0], 2 * r + 2), dtype=g.dtype,
                        device=g.device)
        s.index_add_(0, slot[valid].long(), torch.cat(
            [g, g * g, cost[:, None], (cost * cost)[:, None]], 1))
        _adagrad_apply(*t, feats.long(), s[:, :r], s[:, r:2 * r],
                       s[:, 2 * r], s[:, 2 * r + 1], lr)
    return (cost * inner).sum()


def _check_state(st: GloveState) -> int:
    """Raise unless the tables are what K10 and K11 take; returns r."""
    n, r = st.w_i.shape
    if r > MAX_RANK:
        raise ValueError(f"GloVe rank {r}: the CUDA kernels take at most "
                         f"{MAX_RANK}")
    for name, t in zip(GloveState._fields, st):
        _kernels.check_tensor(name, t, (n, r) if name.startswith(
            ("w_", "acc_w_")) else (n,), torch.float32)
    return r


def _glove_shard_cuda(st: GloveState, sh: Shard, x_max: float, alpha: float,
                      lr: float) -> torch.Tensor:
    r = _check_state(st)
    N, U_r, U_c = sh.rows.shape[0], sh.feats_r.shape[0], sh.feats_c.shape[0]
    f32, i32 = torch.float32, torch.int32
    _kernels.check_tensor("vals", sh.vals, (N,), f32)
    for name, t, shape in (("rows", sh.rows, (N,)), ("cols", sh.cols, (N,)),
                           ("slot_r", sh.slot_r, (N,)),
                           ("slot_c", sh.slot_c, (N,)),
                           ("feats_r", sh.feats_r, (U_r,)),
                           ("feats_c", sh.feats_c, (U_c,))):
        _kernels.check_tensor(name, t, shape, i32)
    sums = torch.zeros((2 * (U_r + U_c) * (r + 1) + 1,), dtype=f32,
                       device=st.w_i.device)
    rc = _kernels.lib().rsp_glove_shard(
        *(_kernels.ptr(t) for t in (sh.rows, sh.cols, sh.vals, sh.slot_r,
                                    sh.slot_c, sh.feats_r, sh.feats_c)),
        N, U_r, U_c, r, *(_kernels.ptr(t) for t in st), x_max, alpha, lr,
        _kernels.ptr(sums), _kernels.stream(st.w_i.device))
    _kernels.check(rc, "glove")
    _kernels.launches["glove"] += 1
    return sums[-1]


def _glove_shard(st: GloveState, sh: Shard, x_max: float, alpha: float,
                 lr: float) -> torch.Tensor:
    """One shard's AdaGrad step, in place; returns its sum(cost * inner) as
    a 0-d tensor.  CPU tensors take the plain version; CUDA tensors launch
    K10."""
    fn = _glove_shard_plain if st.w_i.device.type == "cpu" else \
        _glove_shard_cuda
    return fn(st, sh, float(x_max), float(alpha), float(lr))


def _glove_epoch(st: GloveState, shards: Shards, x_max: float, alpha: float,
                 lr: float) -> torch.Tensor:
    """One pass over the staged tail (rsparse_tpu/models/glove.py:103):
    its loss 0.5 * sum(cost * inner), on the device."""
    losses = [_glove_shard(st, shards.shard(s), x_max, alpha, lr)
              for s in range(shards.rows.shape[0])]
    if not losses:
        return torch.zeros((), dtype=st.w_i.dtype, device=st.w_i.device)
    return 0.5 * torch.stack(losses).sum()


# -- K11: one dense head tile -------------------------------------------------

def _glove_tile_plain(st: GloveState, rows, cols, x, x_max: float,
                      alpha: float, lr: float, cdt: torch.dtype):
    """Plain version of K11 (rsparse_tpu/models/glove.py:206, one scan
    step) on the tile's counts ``x`` (len(rows), len(cols)): S, the cost
    grid and its five products, rounded to ``cdt`` where the reference
    rounds (every product and sum at the state dtype), then the AdaGrad
    steps at the tile's rows and columns.  Returns sum(cost * S)."""
    acc = st.w_i.dtype
    rd = (lambda t: t) if cdt == acc else (lambda t: t.to(cdt).to(acc))
    i, j = rows.long(), cols.long()
    xf = x.to(acc)
    present = xf > 0
    lx = torch.log(torch.where(present, xf, 1.0))
    w = torch.where(present, torch.where(
        xf < x_max, torch.pow(xf / x_max, alpha), 1.0), 0.0)
    wi, wj = rd(st.w_i[i]), rd(st.w_j[j])
    s = torch.clamp(wi @ wj.T + st.b_i[i][:, None] + st.b_j[j][None, :] - lx,
                    -CLIP_VALUE, CLIP_VALUE)
    cost = rd(rd(w) * rd(s))
    c2 = rd(cost * cost)
    _adagrad_apply(st.w_i, st.b_i, st.acc_w_i, st.acc_b_i, i, cost @ wj,
                   c2 @ rd(wj * wj), cost.sum(1), c2.sum(1), lr)
    _adagrad_apply(st.w_j, st.b_j, st.acc_w_j, st.acc_b_j, j, cost.T @ wi,
                   c2.T @ rd(wi * wi), cost.sum(0), c2.sum(0), lr)
    return (cost * s).sum()


def _glove_tile_cuda(st: GloveState, rows, cols, x, x_max: float,
                     alpha: float, lr: float, cdt: torch.dtype):
    r = _check_state(st)
    n_r, n_c = rows.shape[0], cols.shape[0]
    f32 = torch.float32
    if cdt not in (f32, torch.bfloat16) or x.dtype != cdt:
        raise TypeError(f"GloVe head: the CUDA kernel takes a float32 or "
                        f"bfloat16 grid at the compute dtype (got grid "
                        f"{x.dtype}, compute {cdt})")
    if x.device.type != "cuda" or tuple(x.shape) != (n_r, n_c):
        raise ValueError(f"x: expected a CUDA tensor of shape {(n_r, n_c)}")
    _kernels.check_tensor("rows", rows, (n_r,), torch.int32)
    _kernels.check_tensor("cols", cols, (n_c,), torch.int32)
    so = _kernels.lib()
    dev = st.w_i.device
    scratch = torch.empty((so.rsp_glove_tile_scratch(n_r, n_c, r),),
                          dtype=f32, device=dev)
    loss = torch.empty((), dtype=f32, device=dev)
    rc = so.rsp_glove_tile(
        _kernels.ptr(rows), _kernels.ptr(cols), n_r, n_c, _kernels.ptr(x),
        x.stride(0), x.stride(1), int(cdt == torch.bfloat16),
        *(_kernels.ptr(t) for t in st), r, x_max, alpha, lr,
        _kernels.ptr(scratch), _kernels.ptr(loss), _kernels.stream(dev))
    _kernels.check(rc, "glove_dense")
    _kernels.launches["glove_dense"] += 1
    return loss


def _glove_tile(st: GloveState, rows, cols, x, x_max: float, alpha: float,
                lr: float, cdt: torch.dtype) -> torch.Tensor:
    """One head tile's AdaGrad step, in place; returns its sum(cost * S) as
    a 0-d tensor.  CPU tensors take the plain version; CUDA tensors launch
    K11."""
    fn = _glove_tile_plain if st.w_i.device.type == "cpu" else \
        _glove_tile_cuda
    return fn(st, rows, cols, x, float(x_max), float(alpha), float(lr), cdt)


def _glove_dense_step(st: GloveState, head: HeadGrid, x_max: float,
                      alpha: float, lr: float, cdt: torch.dtype):
    """One pass over the head's tiles in the reference's order ti * nt +
    tj (rsparse_tpu/models/glove.py:296): its loss 0.5 * sum(cost * S)."""
    H, side = head.ids.shape[0], head.side
    spans = [(t * side, min(H, (t + 1) * side)) for t in range(head.nt)]
    losses = [_glove_tile(st, head.ids[a0:a1], head.ids[b0:b1],
                          head.x[a0:a1, b0:b1], x_max, alpha, lr, cdt)
              for a0, a1 in spans for b0, b1 in spans]
    return 0.5 * torch.stack(losses).sum()


# -- staging (numpy copies of the reference's host helpers) -------------------

def _split_head(coo: sp.coo_matrix, n_hot: int, np_dt):
    """The dense (H, H) head block of the hottest tokens and the remaining
    COO (rsparse_tpu/models/glove.py:337): ``(hot_ids, X_hh, rem)``, or
    ``(None, None, coo)`` when no head is dense enough."""
    n = coo.shape[0]
    n_hot = int(min(n_hot, n))
    if n_hot < 16 or coo.nnz == 0:
        return None, None, coo
    counts = (np.bincount(coo.row, minlength=n)
              + np.bincount(coo.col, minlength=n))
    by_count = np.argsort(-counts, kind="stable").astype(np.int32)
    pos = np.full((n,), -1, np.int32)
    in_head = None
    while n_hot >= 16:
        hot_ids = np.sort(by_count[:n_hot])
        pos[:] = -1
        pos[hot_ids] = np.arange(n_hot, dtype=np.int32)
        in_head = (pos[coo.row] >= 0) & (pos[coo.col] >= 0)
        if int(in_head.sum()) >= 0.004 * n_hot * n_hot:
            break
        n_hot //= 2
    if n_hot < 16:
        return None, None, coo
    X = np.zeros((n_hot, n_hot), np_dt)
    # duplicate (i, j) triplets accumulate, in order, at the grid's dtype
    np.add.at(X, (pos[coo.row[in_head]], pos[coo.col[in_head]]),
              coo.data[in_head])
    rem = sp.coo_matrix(
        (coo.data[~in_head], (coo.row[~in_head], coo.col[~in_head])),
        shape=coo.shape)
    return hot_ids, X, rem


def _stage_head(X: np.ndarray, hot_ids: np.ndarray, gdt: torch.dtype,
                batch_size: int, device) -> HeadGrid:
    """The head on the device (rsparse_tpu/models/glove.py:380
    ``_head_grids``): tiles of ``side`` positions carrying roughly
    ``batch_size`` nnz each; the counts rounded to ``gdt`` through float32
    (float64 grids stay float64), as the reference stages them."""
    H = X.shape[0]
    density = max(int(np.count_nonzero(X)), 1) / float(H * H)
    side = int(np.clip(np.sqrt(batch_size / density), 128, H))
    x = torch.from_numpy(X)
    if gdt != torch.float64:
        x = x.to(torch.float32)
    x = x.to(device).to(gdt)
    return HeadGrid(torch.from_numpy(hot_ids.astype(np.int32)).to(device), x,
                    side, -(-H // side))


def _stack_coo_host(coo: sp.coo_matrix, batch_size: int):
    """(n_shards, batch_size) stacked triplets, stride-interleaved: triplet
    t lands in shard t % n_shards (rsparse_tpu/models/glove.py:407)."""
    n = coo.nnz
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    r = np.concatenate([coo.row, np.zeros(pad, coo.row.dtype)])
    c = np.concatenate([coo.col, np.zeros(pad, coo.col.dtype)])
    v = np.concatenate([coo.data, np.ones(pad)])
    m = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    stack = lambda a: np.ascontiguousarray(  # noqa: E731
        a.reshape(batch_size, nb).T)
    return (stack(r).astype(np.int32), stack(c).astype(np.int32),
            stack(v), stack(m))


def _stage_tail(coo: sp.coo_matrix, batch_size: int, dtype: torch.dtype,
                device) -> Shards:
    r, c, v, m = _stack_coo_host(coo, batch_size)
    return Shards.build(torch.from_numpy(r).to(device),
                        torch.from_numpy(c).to(device),
                        torch.from_numpy(v).to(dtype).to(device),
                        torch.from_numpy(m).to(device))


def _shuffle_shards(shards: Shards, seed: Optional[int] = None,
                    perm: Optional[torch.Tensor] = None) -> Shards:
    """Shards permuted over the flat nnz axis on their device
    (rsparse_tpu/models/glove.py:441), padding travelling with its valid
    bits, by ``perm`` or by ``torch.randperm`` from a generator seeded with
    ``seed``; the slot maps are rebuilt for the new contents."""
    shp, dev = shards.rows.shape, shards.rows.device
    n = shards.rows.numel()
    if perm is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        perm = torch.randperm(n, generator=gen, device=dev)
    perm = perm.to(dev)
    f = lambda a: a.reshape(n)[perm].reshape(shp)  # noqa: E731
    return Shards.build(*(f(a) for a in shards[:4]))


def _compute_dtype(name, dtype: torch.dtype) -> torch.dtype:
    if name is None:
        return dtype
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    return resolve_dtype(name)


class GloVe:
    """GloVe model (mlapi-style fit_transform)."""

    def __init__(
        self,
        rank: int,
        x_max: float,
        learning_rate: float = 0.15,
        alpha: float = 0.75,
        lambda_: float = 0.0,
        shuffle: bool = False,
        init: Optional[dict] = None,
        batch_size: int = 8192,
        precision: str = "float32",
        seed: Optional[int] = None,
        n_hot="auto",
        mesh=None,
        compute_dtype: Optional[str] = None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (row-sharded tables) is not ported yet; see ROADMAP.md")
        self.rank = int(rank)
        #: dense-head grid and product-operand dtype ("bfloat16"); state,
        #: biases, accumulators and the loss stay at ``precision``
        self.compute_dtype = compute_dtype
        self.mesh = None
        self.x_max = float(x_max)
        self.learning_rate = float(learning_rate)
        self.alpha = float(alpha)
        self.lambda_ = float(lambda_)  # reserved, as in the reference
        self.shuffle = shuffle
        self.batch_size = int(batch_size)
        self.n_hot = n_hot
        self.dtype = resolve_dtype(precision)
        self._cdt = _compute_dtype(compute_dtype, self.dtype)
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._init = init or {}
        self.components = None   # (rank, n) context embeddings w_j
        self.bias_i = None
        self.bias_j = None
        self.cost_history = []
        #: host walls of the last fit's stages: the head split, the head's
        #: and the tail's staging, each epoch (ending in its loss read)
        self.stage_info = {}

    def _init_state(self, n: int) -> GloveState:
        k = self.rank
        kw = dict(dtype=self.dtype, device=self.device)

        def initm(name, shape):
            v = self._init.get(name)
            if v is not None:
                v = np.asarray(v)
                if len(shape) == 2 and v.shape == shape[::-1]:
                    v = v.T  # accept reference-layout (rank, n) matrices
                if v.shape != shape:
                    raise ValueError(f"init {name} has wrong shape")
                return torch.tensor(v, **kw)
            return torch.tensor(self._rng.uniform(-0.5, 0.5, shape), **kw)

        return GloveState(
            w_i=initm("w_i", (n, k)), w_j=initm("w_j", (n, k)),
            b_i=initm("b_i", (n,)), b_j=initm("b_j", (n,)),
            acc_w_i=torch.ones((n, k), **kw), acc_w_j=torch.ones((n, k), **kw),
            acc_b_i=torch.ones((n,), **kw), acc_b_j=torch.ones((n,), **kw))

    def fit_transform(self, x, n_iter: int = 10,
                      convergence_tol: float = -1.0) -> torch.Tensor:
        coo = sp.coo_matrix(x)
        if coo.shape[0] != coo.shape[1]:
            raise ValueError("input co-occurrence matrix must be square")
        if coo.nnz and coo.data.min() <= 0:
            raise ValueError("all co-occurrence values must be > 0")
        n = coo.shape[0]
        # triangular co-occurrence => also fit on the transposed triplets
        # (reference R/model_GloVe.R:80,133-136)
        triu = bool((coo.row <= coo.col).all())
        tril = bool((coo.row >= coo.col).all())
        is_triangular = (triu or tril) and n > 1
        st = self._init_state(n)

        nnz = max(coo.nnz, 1)
        self.cost_history = []
        n_hot = self.n_hot
        if n_hot == "auto":
            # ~2 GB of f32 cells, split with the transposed pass's
            # (rsparse_tpu/models/glove.py:567-571)
            cells = (1 << 29) // (2 if is_triangular else 1)
            n_hot = int(min(n, np.sqrt(cells)))
        np_dt = np.float64 if self.dtype == torch.float64 else np.float32
        t0 = time.perf_counter()
        hot_ids, X_hh, rem = _split_head(coo, int(n_hot), np_dt)
        t1 = time.perf_counter()
        head = None
        if hot_ids is not None:
            head = _stage_head(X_hh, hot_ids, self._cdt, self.batch_size,
                               self.device)
            del X_hh
            logger.info("glove head block: %d tokens, %d/%d nnz dense",
                        len(hot_ids), coo.nnz - rem.nnz, coo.nnz)
        t2 = time.perf_counter()
        tail = (_stage_tail(rem, self.batch_size, self.dtype, self.device)
                if rem.nnz else None)
        info = self.stage_info = {
            "split_s": t1 - t0, "head_s": t2 - t1,
            "tail_s": time.perf_counter() - t2,
            "head_tokens": 0 if head is None else head.ids.shape[0],
            "tiles": 0 if head is None else head.nt ** 2,
            "shards": 0 if tail is None else tail.rows.shape[0],
            "epoch_s": []}
        hp = (self.x_max, self.alpha, self.learning_rate)
        for it in range(n_iter):
            t0 = time.perf_counter()
            if self.shuffle:
                # the reference draws a key every epoch
                # (rsparse_tpu/models/glove.py:618); the transposed pass
                # reuses the permutation with the roles exchanged
                seed = int(self._rng.integers(2 ** 31))
                if tail is not None:
                    tail = _shuffle_shards(tail, seed)
            parts = []
            passes = [(head, tail)]
            if is_triangular:
                passes.append((head and head.transposed(),
                               tail and tail.swapped()))
            for h, t in passes:
                if h is not None:
                    parts.append(_glove_dense_step(st, h, *hp, self._cdt))
                if t is not None:
                    parts.append(_glove_epoch(st, t, *hp))
            cost = sum(float(p) for p in parts)
            info["epoch_s"].append(time.perf_counter() - t0)
            if np.isnan(cost):
                raise FloatingPointError(
                    "Cost becomes NaN, try a smaller learning_rate.")
            if cost / nnz > 1:
                raise FloatingPointError(
                    "Cost is too big, probably something is wrong... "
                    "try a smaller learning rate")
            self.cost_history.append(cost / nnz)
            logger.info("epoch %d, loss %.4f", it + 1, self.cost_history[-1])
            if (it > 0 and self.cost_history[-2] / self.cost_history[-1] - 1
                    < convergence_tol):
                logger.info("early stopping at epoch %d", it + 1)
                break

        self._set_fitted(st)
        return st.w_i

    def _set_fitted(self, st: GloveState) -> None:
        self._state = st
        self.components = st.w_j.T.cpu().numpy()  # (rank, n), like w_j
        self.bias_i = st.b_i.cpu().numpy()
        self.bias_j = st.b_j.cpu().numpy()

    def get_history(self):
        return {"cost_history": list(self.cost_history)}
