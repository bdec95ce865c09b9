"""K6's work list (``csrc/spmm_residual.cu``) replayed in plain torch on the
CPU.

K6 runs the soft-impute residual (SDDMM, squared norm, SpMM) in one launch
over K5's work list (``rsparse_tpu_torch/ops/spmm.py`` row_shape,
row_layout): every block is a chunk of one row of a bucket padded past
``short`` (empty past the row's entries) or up to ``groups`` packed rows of
a shorter bucket.  A block computes, for each of its entries, ``a = lf .
cf`` and ``delta = val - a`` (with a bf16 table, ``lf`` and ``delta``
rounded to bf16 before they multiply ``cf``), writes ``a`` where the caller
asks for it, adds its rows' partial ``sum delta * cf`` into ``proj`` and
writes one partial of ``sum delta^2``; the wrapper sums the partials.
:func:`_replay` does the same per block in plain torch.

Inputs: ML-100k (items as rows, whose head rows are long) and a small
numpy-made matrix (seed 0) with two empty rows and one full row, bucketed
as the port stages them, so that the buckets hold padding rows; work lists
at the shape K5 and K6 take for the product, and with short chunks and
packed short rows.  Stated tolerances (max |a - b| / max |b|): the replay
against ``_residual_plain`` at float64, bf16 rounding included, to 1e-10
(proj and approx; the squared norm, which both sum in float32, to 1e-6);
against the JAX package's ``spmm_residual_buckets`` at float32 to 1e-5 for
proj (the kernel's own limit against its plain version, PERF.md section 2)
and 1e-6 for the squared norm, and with a bf16 table to 1e-2 (a bf16
rounding whose float32 sum order differs may land one bf16 step apart), as
``tests/test_torch_spmm.py`` holds the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu_torch as rt
from rsparse_tpu.ops import spmm as ref
from rsparse_tpu.sparse import device as ref_dev
from rsparse_tpu_torch.config import accum_dtype
from rsparse_tpu_torch.ops import spmm as port
from rsparse_tpu_torch.sparse import device as port_dev

torch.set_num_threads(2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _replay(buckets, n_rows, rowfac, colfac, scale, layout,
            compute_dtype=None, proj=True, approx=False):
    """K6's work list run in plain torch: for each block, its entries'
    products, residuals and the approx values; its rows' partial SpMM,
    added into proj (a store when the row has one chunk of entries, an
    atomic add otherwise: both add into the zeroed proj); and its squared
    norm partial in float32.  Returns (proj or None, the partials
    (n_blocks,) float32, their sum, [approx (B, L)] or None)."""
    k = colfac.shape[1]
    dtype = colfac.dtype
    sdt = accum_dtype(dtype)
    left = rowfac if scale is None else rowfac * scale[None, :]
    cg = port._gather_table(colfac, compute_dtype)
    out = torch.zeros((n_rows + 1, k), dtype=dtype) if proj else None
    desc = layout.desc.long()
    G, C = layout.shape.groups, layout.shape.chunk
    part_sq = torch.zeros((desc.shape[0],), dtype=sdt)
    approx_list = [] if approx else None
    for bi, b in enumerate(buckets):
        a_out = torch.zeros(b.col_idx.shape, dtype=dtype)
        if approx:
            approx_list.append(a_out)
        ids = torch.nonzero(desc[:, 0] == bi)[:, 0]
        if ids.numel() == 0:
            continue
        d = desc[ids]
        packed = d[:, 3] == 1
        dc, dp = d[~packed], d[packed]
        g = torch.arange(G)[None, :]
        live_g = g < dp[:, 2:3]
        # one (row, block, first entry, end) per block row
        rows = torch.cat([dc[:, 1], (dp[:, 1:2] + g)[live_g]])
        blk = torch.cat([ids[~packed], ids[packed][:, None].expand(
            -1, G)[live_g]])
        lo = torch.cat([dc[:, 2] * C, torch.zeros(int(live_g.sum()),
                                                  dtype=torch.long)])
        n = b.nnz.long()[rows]
        hi = torch.where(torch.arange(rows.numel()) < dc.shape[0],
                         torch.minimum(n, lo + C), n)
        ls = torch.arange(b.pad_len)
        j, l = torch.nonzero((ls[None, :] >= lo[:, None])
                             & (ls[None, :] < hi[:, None]), as_tuple=True)
        r = rows[j]
        lf = left[b.row_ids.long()[r].clamp(max=left.shape[0] - 1)]
        lf = lf.to(cg.dtype).to(sdt)
        cf = cg[b.col_idx[r, l].long()].to(sdt)
        a = (lf * cf).sum(1)
        delta = b.values[r, l].to(sdt) - a
        a_out[r, l] = a.to(dtype)
        part_sq.index_add_(0, blk[j], delta * delta)
        if proj:
            part = torch.zeros((rows.numel(), k), dtype=sdt)
            part.index_add_(0, j, delta.to(cg.dtype).to(sdt)[:, None] * cf)
            out.index_add_(0, b.row_ids.long()[rows], part.to(dtype))
    part_sq = part_sq.to(torch.float32)
    return (None if out is None else out[:n_rows]), part_sq, part_sq.sum(), \
        approx_list


def _small(seed=0, n_rows=90, n_cols=50, density=0.12):
    """Signed values, two empty rows (3, 10) and one full row (5)."""
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="lil")
    m[3, :] = 0
    m[10, :] = 0
    m[5, :] = rng.random(n_cols) + 0.5
    m = sp.csr_matrix(m)
    m.data = rng.standard_normal(m.nnz)
    return m


_MATS = {}


def _matrix(name):
    if name not in _MATS:
        if name == "small":
            m = _small()
        else:
            m = sp.csr_matrix(sp.csr_matrix(rt.load_movielens100k()).T,
                              dtype=np.float64)
        _MATS[name] = m
    return _MATS[name]


def _staged(m, dtype, max_elems=1 << 12):
    br = port_dev.bucket_rows(m, dtype, "cpu", max_elems=max_elems)
    bk = list(br.buckets)
    assert len(bk) > 2
    assert any(int((b.row_ids == m.shape[0]).sum()) for b in bk)
    return bk


#: (k, chunk, short): the shape K5 and K6 take for the product (chunks of
#: 16 entries a group, nothing packed at these sizes), and short chunks
#: with the rows of buckets padded to at most 8 or 16 packed
_SHAPES = {"own": (10, None, None), "packed8": (12, 16, 8),
           "packed16": (16, 64, 16)}


def _layout(bk, name):
    k, chunk, short = _SHAPES[name]
    shapes = [(b.batch, b.pad_len) for b in bk]
    sh = port.row_shape(k, True, sum(B * L for B, L in shapes))
    if chunk is not None:
        sh = sh._replace(chunk=chunk, short=short)
    return k, port.row_layout(shapes, sh)


def _factors(seed, m, k, dtype=np.float64):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((m.shape[0], k)).astype(dtype)
    v = rng.standard_normal((m.shape[1], k)).astype(dtype)
    d = (np.abs(rng.standard_normal(k)) + 0.1).astype(dtype)
    return u, v, d


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("mat", ["small", "ml100k_items"])
def test_layout_covers_chunked_packed_empty_and_padding_rows(mat, shape):
    """The list K6 runs holds chunked rows and (with short > 0) packed
    rows; empty rows and padding rows sit in it and add nothing."""
    m = _matrix(mat)
    bk = _staged(m, torch.float64)
    _, lay = _layout(bk, shape)
    desc = lay.desc.numpy()
    assert lay.stats["chunks"] > 0
    assert (lay.stats["packed_rows"] > 0) == (_SHAPES[shape][2] is not None)
    covered = {(bi, int(y)) for bi, y, z, pk in desc if not pk}
    covered |= {(bi, int(y) + g) for bi, y, z, pk in desc if pk
                for g in range(z)}
    assert len(covered) == sum(b.batch for b in bk)
    n_pad = sum(int((b.row_ids == m.shape[0]).sum()) for b in bk)
    assert n_pad > 0 and (m.getnnz(axis=1) == 0).sum() >= (
        2 if mat == "small" else 0)


@pytest.mark.parametrize("cdt", [None, "bfloat16"])
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("mat", ["small", "ml100k_items"])
def test_replay_matches_plain_float64(mat, shape, scaled, cdt):
    """At float64 the replay equals ``_residual_plain``: proj, approx (0 at
    padding entries) and the squared norm from the per-block partials; one
    partial per block, 0 for the chunks past a row's entries.  With a bf16
    table both round lf and delta to bf16 before they multiply it, so the
    replay is far from the unrounded product."""
    m = _matrix(mat)
    bk = _staged(m, torch.float64)
    k, lay = _layout(bk, shape)
    u, v, d = (torch.as_tensor(t) for t in _factors(1, m, k))
    scale = d if scaled else None
    p, parts, sq, _ = _replay(bk, m.shape[0], u, v, scale, lay, cdt)
    pp, sqp, _ = port._residual_plain(bk, m.shape[0], u, v, scale, cdt)
    assert p.dtype == torch.float64 and tuple(p.shape) == (m.shape[0], k)
    assert _rel(p, pp) <= 1e-10
    assert float(sq) == pytest.approx(float(sqp), rel=1e-6)
    assert parts.shape == (lay.stats["blocks"],)
    assert not p[torch.as_tensor(m.getnnz(axis=1) == 0)].any()
    desc = lay.desc.long()
    empty = torch.tensor([int(z) * lay.shape.chunk >= int(bk[bi].nnz[y])
                          for bi, y, z, pk in desc.tolist() if not pk])
    assert empty.any() and not parts[:empty.numel()][empty].any()
    _, _, _, ak = _replay(bk, m.shape[0], u, v, scale, lay, cdt, proj=False,
                          approx=True)
    _, _, ap = port._residual_plain(bk, m.shape[0], u, v, scale, cdt,
                                    proj=False, approx=True)
    for b, a_k, a_p in zip(bk, ak, ap):
        assert _rel(a_k, a_p) <= 1e-10
        assert not a_k[~b.mask()].any()
    if cdt is not None:
        p32, _, _, _ = _replay(bk, m.shape[0], u, v, scale, lay)
        assert _rel(p, p32) > 1e-5


@pytest.mark.parametrize("cdt", [None, "bfloat16"])
@pytest.mark.parametrize("shape", ["own", "packed8"])
@pytest.mark.parametrize("mat", ["small", "ml100k_items"])
def test_replay_matches_reference_float32(mat, shape, cdt):
    """The replay at float32 against the JAX package's spmm_residual_buckets
    (and sparse_approx_buckets) on the same numpy inputs, bucketed alike
    (fewer, larger buckets than above: each is one XLA program)."""
    m = _matrix(mat)
    bk = _staged(m, torch.float32, 1 << 15)
    bj = ref_dev.bucket_rows(m, jnp.float32, max_elems=1 << 15)
    k, lay = _layout(bk, shape)
    u, v, d = _factors(2, m, k, np.float32)
    pj, sj = ref.spmm_residual_buckets(bj.buckets, m.shape[0], jnp.asarray(u),
                                       jnp.asarray(v), jnp.asarray(d),
                                       compute_dtype=cdt)
    p, _, sq, _ = _replay(bk, m.shape[0], torch.as_tensor(u),
                          torch.as_tensor(v), torch.as_tensor(d), lay, cdt)
    assert p.dtype == torch.float32
    lim = 1e-5 if cdt is None else 1e-2
    assert _rel(p, pj) <= lim
    assert float(sq) == pytest.approx(float(sj), rel=1e-6 if cdt is None
                                      else 1e-2)
    if cdt is None:
        aj = ref.sparse_approx_buckets(bj.buckets, jnp.asarray(u),
                                       jnp.asarray(v), jnp.asarray(d))
        _, _, _, ak = _replay(bk, m.shape[0], torch.as_tensor(u),
                              torch.as_tensor(v), torch.as_tensor(d), lay,
                              proj=False, approx=True)
        for b, a_k, a_j in zip(bk, ak, aj):
            mask = b.mask().numpy()
            assert _rel(a_k.numpy()[mask], np.asarray(a_j)[mask]) <= 1e-5
