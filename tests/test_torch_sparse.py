"""Port parity: bucketed rows and the dense zipf-head split.

The same random CSRs go through ``rsparse_tpu.sparse.device`` and
``rsparse_tpu_torch.sparse.device``; every layout array must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu.sparse import device as ref
from rsparse_tpu_torch.sparse import device as port

torch.set_num_threads(2)


def _csr(seed, n_rows=70, n_cols=50, density=0.12):
    """Random implicit CSR with planted empty rows and one heavy row."""
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="lil")
    m[3, :] = 0
    m[10, :] = 0
    m[5, :] = rng.random(n_cols) + 0.5
    m = sp.csr_matrix(m)
    m.data = 1.0 + 4.0 * m.data
    return m


def _assert_buckets_equal(bj, bt):
    assert bt.n_rows == bj.n_rows and bt.n_cols == bj.n_cols
    assert bt.nnz == bj.nnz
    np.testing.assert_array_equal(bt.empty_rows, bj.empty_rows)
    assert bt.shapes == bj.shapes
    for a, b in zip(bj.buckets, bt.buckets):
        np.testing.assert_array_equal(b.row_ids.numpy(), np.asarray(a.row_ids))
        np.testing.assert_array_equal(b.col_idx.numpy(), np.asarray(a.col_idx))
        np.testing.assert_array_equal(b.values.numpy(), np.asarray(a.values))
        np.testing.assert_array_equal(b.nnz.numpy(), np.asarray(a.nnz))


@pytest.mark.parametrize("seed,include_empty,row_align,precision", [
    (0, False, 32, "float32"),
    (1, True, 32, "float64"),
    (2, False, 8, "float64"),
    (3, True, 8, "float32"),
])
def test_bucket_rows_identical(seed, include_empty, row_align, precision):
    m = _csr(seed)
    jdt = jnp.float64 if precision == "float64" else jnp.float32
    tdt = torch.float64 if precision == "float64" else torch.float32
    bj = ref.bucket_rows(m, jdt, include_empty=include_empty,
                         row_align=row_align, max_elems=256)
    bt = port.bucket_rows(m, tdt, "cpu", include_empty=include_empty,
                          row_align=row_align, max_elems=256)
    assert len(bt.buckets) > 2          # several lengths and split chunks
    _assert_buckets_equal(bj, bt)
    mask = bt.buckets[0].mask().numpy()
    np.testing.assert_array_equal(mask, np.asarray(bj.buckets[0].mask()))


def test_bucket_rows_numpy_fill_matches_native(monkeypatch):
    """The numpy fallback gives the same layout as the native fill."""
    m = _csr(4)
    native = port.bucket_rows(m, torch.float32, "cpu", include_empty=True)
    monkeypatch.setattr(port, "fill_bucket", lambda *a, **k: None)
    fallback = port.bucket_rows(m, torch.float32, "cpu", include_empty=True)
    for a, b in zip(native.buckets, fallback.buckets):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("n_hot,precision", [(8, "float64"), (20, "float32")])
def test_split_hot_cold_identical(n_hot, precision):
    m = _csr(5 + n_hot)
    jdt = jnp.float64 if precision == "float64" else jnp.float32
    tdt = torch.float64 if precision == "float64" else torch.float32
    hj, cj = ref.split_hot_cold(m, n_hot, jdt)
    ht, ct = port.split_hot_cold(m, n_hot, tdt, "cpu")
    np.testing.assert_array_equal(ht.hot_ids.numpy(), np.asarray(hj.hot_ids))
    np.testing.assert_array_equal(ht.W.numpy(), np.asarray(hj.W))
    assert ht.W.dtype == tdt
    np.testing.assert_array_equal(ht.row_nnz.numpy(), np.asarray(hj.row_nnz))
    for a in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ct, a), getattr(cj, a))
    assert ct.shape == cj.shape

    # hot rows in bucket order
    bj = ref.bucket_rows(cj, jdt, include_empty=True, row_align=8)
    bt = port.bucket_rows(ct, tdt, "cpu", include_empty=True, row_align=8)
    rj = ref.hot_bucket_rows(hj, bj.buckets, m.shape[0])
    rt = port.hot_bucket_rows(ht, bt.buckets)
    assert len(rj) == len(rt)
    for (wj, bj_, nj, sj), (wt, bt_, nt, st) in zip(rj, rt):
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        assert bj_ is None and bt_ is None
        assert sj is None and st is None


@pytest.mark.parametrize("stored_zero_in_head", [True, False])
def test_split_hot_cold_presence_bits_identical(stored_zero_in_head):
    """Explicit ratings: presence bits are built exactly when a stored 0.0
    rating lands in the head, bit for bit as the reference builds them,
    and follow the rows into bucket order.  Stored zeros in the tail stay
    in the cold matrix."""
    m = _csr(17).tolil()
    counts = np.bincount(sp.csr_matrix(m).indices, minlength=m.shape[1])
    hot_col, cold_col = int(np.argmax(counts)), int(np.argmin(counts))
    m[3, cold_col] = 1e-300
    if stored_zero_in_head:
        m[4, hot_col] = 1e-300
    m = sp.csr_matrix(m)
    m.data[np.abs(m.data) < 1e-200] = 0.0            # true stored zeros
    hj, cj = ref.split_hot_cold(m, 12, jnp.float64, with_presence=True)
    ht, ct = port.split_hot_cold(m, 12, torch.float64, "cpu",
                                 with_presence=True)
    assert (ht.present_bits is not None) == stored_zero_in_head
    assert (hj.present_bits is not None) == stored_zero_in_head
    if stored_zero_in_head:
        assert ht.present_bits.dtype == torch.uint8
        np.testing.assert_array_equal(ht.present_bits.numpy(),
                                      np.asarray(hj.present_bits))
    np.testing.assert_array_equal(ht.W.numpy(), np.asarray(hj.W))
    for a in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ct, a), getattr(cj, a))
    assert (ct.data == 0).sum() >= 1                 # the tail's stored zero
    bj = ref.bucket_rows(cj, jnp.float64, include_empty=True, row_align=8)
    bt = port.bucket_rows(ct, torch.float64, "cpu", include_empty=True,
                          row_align=8)
    rj = ref.hot_bucket_rows(hj, bj.buckets, m.shape[0])
    rt = port.hot_bucket_rows(ht, bt.buckets)
    for (wj, bits_j, nj, _), (wt, bits_t, nt, _) in zip(rj, rt):
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        if stored_zero_in_head:
            np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
        else:
            assert bits_t is None and bits_j is None


def test_split_hot_cold_disabled():
    m = _csr(9)
    assert port.split_hot_cold(m, 0, torch.float32, "cpu")[0] is None
    assert port.hot_bucket_rows(None, ()) is None
