"""K5's work list (``rsparse_tpu_torch/ops/spmm.py`` row_shape, row_layout,
spmm_layout) on the CPU.

The work list is what K5 (``csrc/spmm.cu``) runs on the card in one
launch.  It depends on the buckets' shapes alone: every row of a bucket
padded to more than ``short`` entries is cut into ``ceil(pad_len /
chunk)`` chunks, one block each (a chunk past the row's entries is empty),
and the rows of the other buckets are packed ``groups`` to a block.  These
tests hold its structure (every live entry in exactly one block, padding
entries in none, the chunks first, the longest buckets first) and replay
the kernel's work list in plain torch (:func:`_replay`, each block's
entries summed apart, then added into the output).  Inputs: ML-100k (items
as rows, whose head rows are long; users as rows) and a small zipf
synthetic (numpy, seed 0), bucketed as the port stages them, with padding
rows and an empty bucket.  Stated tolerances: the replay against
``_spmm_plain`` on the same tensors to 1e-6 relative (max |a - b| / max
|b|; the sums run in another order); against the JAX package's
``spmm_buckets`` at float64 to 1e-12, and with bf16 gathers (float32
factors) to 1e-2, as ``tests/test_torch_spmm.py`` holds the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu_torch as rt
from rsparse_tpu.ops import spmm as ref
from rsparse_tpu.sparse import device as ref_dev
from rsparse_tpu_torch.ops import spmm as port
from rsparse_tpu_torch.sparse import device as port_dev
from rsparse_tpu_torch.config import accum_dtype
from rsparse_tpu_torch.sparse.device import RowBucket

torch.set_num_threads(2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _replay(buckets, n_rows, dense, layout, values_list=None,
            compute_dtype=None):
    """K5's work list run in plain torch: each block sums its entries (a
    chunk of one row, empty past the row's entries, or whole packed rows)
    apart, then adds each of its rows into the output."""
    k = dense.shape[1]
    sdt = accum_dtype(dense.dtype)
    dg = port._gather_table(dense, compute_dtype)
    out = torch.zeros((n_rows + 1, k), dtype=dense.dtype)
    desc = layout.desc.long()
    G, C = layout.shape.groups, layout.shape.chunk
    for bi, b in enumerate(buckets):
        d = desc[desc[:, 0] == bi]
        if d.numel() == 0:
            continue
        vals = b.values if values_list is None else values_list[bi]
        packed = d[:, 3] == 1
        # one (row, first entry, end) per block row: chunks, then packed rows
        dc, dp = d[~packed], d[packed]
        g = torch.arange(G)[None, :]
        prow = (dp[:, 1:2] + g)[g < dp[:, 2:3]]
        rows = torch.cat([dc[:, 1], prow])
        lo = torch.cat([dc[:, 2] * C, torch.zeros_like(prow)])
        n = b.nnz.long()[rows]
        hi = torch.where(torch.arange(rows.numel()) < dc.shape[0],
                         torch.minimum(n, lo + C), n)
        ls = torch.arange(b.pad_len)
        take = (ls[None, :] >= lo[:, None]) & (ls[None, :] < hi[:, None])
        j, l = torch.nonzero(take, as_tuple=True)
        src = dg[b.col_idx[rows[j], l].long()].to(sdt)
        v = vals[rows[j], l].to(dg.dtype).to(sdt)
        part = torch.zeros((rows.numel(), k), dtype=sdt)
        part.index_add_(0, j, v[:, None] * src)
        out.index_add_(0, b.row_ids.long()[rows], part.to(dense.dtype))
    return out[:n_rows]


def _zipf(seed=0, n_rows=700, n_cols=400):
    """Log-normal row lengths over zipf-popular columns (the shape of
    ``bench.synth_ml20m_like`` at a small size), signed values."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(np.log(12), 0.9, n_rows).astype(int), 1,
                   n_cols)
    pop = 1.0 / (np.arange(n_cols) + 5.0)
    pop /= pop.sum()
    rows = np.repeat(np.arange(n_rows), lens)
    cols = np.concatenate([rng.choice(n_cols, n, replace=False, p=pop)
                           for n in lens])
    m = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n_rows, n_cols))
    m.sum_duplicates()
    return m


_MATS = {}


def _matrix(name):
    if name not in _MATS:
        if name == "zipf":
            m = _zipf()
        else:
            m = sp.csr_matrix(rt.load_movielens100k(), dtype=np.float64)
            if name == "ml100k_items":
                m = sp.csr_matrix(m.T)
        _MATS[name] = m
    return _MATS[name]


def _buckets(m, dtype=torch.float64):
    """The port's buckets of ``m`` with an empty bucket in the middle; the
    32-row alignment leaves padding rows (row_id == n_rows)."""
    br = port_dev.bucket_rows(m, dtype, "cpu", max_elems=1 << 14)
    bk = list(br.buckets)
    assert any(int((b.row_ids == m.shape[0]).sum()) for b in bk)
    empty = RowBucket(torch.zeros(0, dtype=torch.int32),
                      torch.zeros((0, 8), dtype=torch.int32),
                      torch.zeros((0, 8), dtype=dtype),
                      torch.zeros(0, dtype=torch.int32))
    return bk[:1] + [empty] + bk[1:]


#: (k, aligned, padded entries, chunk, short): the shapes the card takes
#: at k = 10 (one 16-lane group a row, 16 groups a block), 64 and 256 on
#: a small product (short chunks, nothing packed), k = 256 on LinearFlow's
#: 7.44M entries (chunks of 2,048, the rows of buckets padded to at most
#: 128 packed 8 to a block), and k = 256 with chunks of 16 entries and the
#: buckets padded to 8 packed, so that small matrices cut rows into many
#: chunks, most of them empty in the longest buckets
_SHAPES = {"k10": (10, True, 0, None, None), "k64": (64, True, 0, None, None),
           "k256": (256, True, 0, None, None),
           "k256_large": (256, True, 7_441_066, None, None),
           "k256_small_chunks": (256, True, 0, 16, 8)}


def _shape(name):
    k, aligned, entries, chunk, short = _SHAPES[name]
    sh = port.row_shape(k, aligned, entries)
    if chunk is not None:
        sh = sh._replace(chunk=chunk, short=short)
    return k, sh


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("mat", ["ml100k_items", "ml100k_users", "zipf"])
def test_row_layout_holds_every_entry_once(mat, shape):
    """Each live entry lies in exactly one block: a chunk of a row of a
    bucket padded to more than ``short`` (every row of it in
    ``ceil(pad_len / chunk)`` chunks), or a packed row of a bucket padded to
    at most ``short`` (up to ``groups`` consecutive rows a block, every row
    once); padding entries in none; the chunks first, by chunk index, the
    longest buckets first."""
    m = _matrix(mat)
    bk = _buckets(m)
    _, sh = _shape(shape)
    lay = port.row_layout([(b.batch, b.pad_len) for b in bk], sh)
    desc = lay.desc.numpy().astype(np.int64)
    assert lay.stats["blocks"] == desc.shape[0]
    packed = desc[:, 3]
    n_ch = int((packed == 0).sum())
    assert n_ch == lay.stats["chunks"]
    assert (packed[:n_ch] == 0).all() and (packed[n_ch:] == 1).all()
    covered = [np.zeros(b.col_idx.shape, np.int64) for b in bk]
    blocks = [np.zeros(b.batch, np.int64) for b in bk]
    prev = None                      # (chunk index, -chunks of the bucket)
    for bi, y, z, pk in desc:
        b = bk[bi]
        nnz = b.nnz.numpy()
        n_chunks = -(-b.pad_len // sh.chunk)
        if pk:
            assert b.pad_len <= sh.short and 0 < z <= sh.groups
            assert y % sh.groups == 0 and y + z <= b.batch
            for r in range(y, y + z):
                covered[bi][r, :nnz[r]] += 1
                blocks[bi][r] += 1
        else:
            assert b.pad_len > sh.short and 0 <= z < n_chunks
            covered[bi][y, z * sh.chunk:min(nnz[y], (z + 1) * sh.chunk)] += 1
            blocks[bi][y] += 1
            assert prev is None or (z, -n_chunks) >= prev
            prev = (z, -n_chunks)
    for b, c, nb in zip(bk, covered, blocks):
        live = np.arange(b.pad_len)[None, :] < b.nnz.numpy()[:, None]
        assert (c[live] == 1).all() and (c[~live] == 0).all()
        want = 1 if b.pad_len <= sh.short else -(-b.pad_len // sh.chunk)
        assert (nb == want).all()
    assert sum(int(c.sum()) for c in covered) == m.nnz
    assert lay.stats["chunked_rows"] + lay.stats["packed_rows"] == sum(
        b.batch for b in bk)


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("cdt", [None, "bfloat16"])
@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("mat", ["ml100k_items", "zipf"])
def test_layout_replay_matches_plain(mat, shape, cdt, override):
    """K5's work list (each block's rows summed apart, then added into the
    output) equals the plain version on the same float32 tensors, bf16
    gathers and value overrides included."""
    m = _matrix(mat)
    bk = _buckets(m, torch.float32)
    k, sh = _shape(shape)
    rng = np.random.default_rng(3)
    dense = torch.tensor(rng.standard_normal((m.shape[1], k)),
                         dtype=torch.float32)
    vl = None
    if override:
        vl = [torch.tensor(rng.standard_normal(tuple(b.values.shape)),
                           dtype=torch.float32) for b in bk]
    lay = port.row_layout([(b.batch, b.pad_len) for b in bk], sh)
    y = _replay(bk, m.shape[0], dense, lay, vl, cdt)
    yp = port._spmm_plain(bk, m.shape[0], dense, vl, cdt)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m.shape[0], k)
    assert _rel(y, yp) <= 1e-6


@pytest.mark.parametrize("precision", ["float64", "bfloat16"])
@pytest.mark.parametrize("mat", ["ml100k_items", "zipf"])
def test_layout_replay_matches_reference(mat, precision):
    """The replay against the JAX package's spmm_buckets on the same numpy
    inputs (float64; bf16 gathers of float32 factors)."""
    m = _matrix(mat)
    f64 = precision == "float64"
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                        torch.float32)
    cdt = None if f64 else "bfloat16"
    bj = ref_dev.bucket_rows(m, jdt)
    bt = port_dev.bucket_rows(m, tdt, "cpu")
    dense = np.random.default_rng(4).standard_normal((m.shape[1], 16))
    if not f64:
        dense = dense.astype(np.float32)
    oj = ref.spmm_buckets(bj.buckets, m.shape[0], jnp.asarray(dense),
                          compute_dtype=cdt)
    _, sh = _shape("k256_small_chunks")
    lay = port.row_layout(bt.shapes, sh)
    ot = _replay(list(bt.buckets), m.shape[0], torch.as_tensor(dense), lay,
                 compute_dtype=cdt)
    assert _rel(ot, oj) <= (1e-12 if f64 else 1e-2)


@pytest.mark.parametrize("k, aligned, entries, want", [
    (10, True, 0, (1, 16, 1, 16, 256, 0)),
    (10, True, 1_000_000, (1, 16, 1, 16, 256, 0)),
    (64, True, 0, (4, 16, 1, 16, 256, 0)),
    (128, True, 0, (4, 32, 1, 8, 128, 0)),
    (256, True, 0, (4, 32, 2, 8, 128, 0)),
    (256, True, 2_000_000, (4, 32, 2, 8, 512, 0)),
    (256, True, 7_441_066, (4, 32, 2, 8, 2048, 128)),
    (256, True, 20_000_000, (4, 32, 2, 8, 4096, 256)),
    (512, True, 0, (4, 32, 4, 8, 128, 0)),
    (256, False, 0, (1, 32, 8, 8, 128, 0)),
    (12, True, 0, (4, 4, 1, 64, 1024, 0)),
])
def test_row_shape(k, aligned, entries, want):
    """K5's shape: 16-byte (f32) loads where the table allows, a row's
    vectors spread over up to 32 lanes, a 256-thread block; chunks that
    aim at ROW_BLOCKS blocks, from 16 entries a group up to
    ROW_MAX_CHUNK, and rows packed only when blocks would hold 1,024
    entries or more."""
    sh = port.row_shape(k, aligned, entries)
    assert tuple(sh) == want
    assert sh.groups * sh.tpe == port.ROW_THREADS
    assert sh.tpe * sh.nv * sh.vec >= k


def test_spmm_layout_is_cached():
    """spmm_layout builds once per list of bucket shapes, K5 shape and
    device, in a cache of its own, and gives the same work list to other
    buckets of the same shapes; the cache keeps at most _LAYOUTS_MAX
    lists."""
    port._LAYOUTS.clear()
    m = _matrix("zipf")
    shapes = tuple((b.batch, b.pad_len) for b in _buckets(m, torch.float32))
    sh = port.row_shape(64)
    a = port.spmm_layout(shapes, sh, "cpu")
    assert port.spmm_layout(shapes, sh, torch.device("cpu")) is a
    assert a.desc.device.type == "cpu"
    assert port.spmm_layout(shapes, sh._replace(chunk=64), "cpu") is not a
    other = port_dev.bucket_rows(_matrix("ml100k_users"), torch.float32,
                                 "cpu").shapes
    assert port.spmm_layout(tuple(other), sh, "cpu") is not a
    assert len(port._LAYOUTS) == 3
    for L in range(8, 8 * (port._LAYOUTS_MAX + 2), 8):
        port.spmm_layout(((32, L),), sh, "cpu")
    assert len(port._LAYOUTS) == port._LAYOUTS_MAX
    assert port.spmm_layout(shapes, sh, "cpu") is not a   # evicted, rebuilt
    port._LAYOUTS.clear()
