"""Port parity of the bucketed sparse products (K5, K6 plain versions).

The same numpy-made CSRs and factors go through ``rsparse_tpu.ops.spmm``
and ``rsparse_tpu_torch.ops.spmm`` on the CPU, where the port's wrappers
run the kernels' plain PyTorch versions.  Stated tolerances: float64
outputs to 1e-12 relative (max |a - b| / max |b|); the squared norm, a
float32 sum in both packages whose order differs between XLA and torch, to
1e-6 relative; bfloat16 gathers (float32 factors) to 1e-2 relative, as a
bf16 rounding of a value whose float32 sum order differs may land one bf16
step (2^-8 relative) apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu.ops import spmm as ref
from rsparse_tpu.sparse import device as ref_dev
from rsparse_tpu_torch.ops import spmm as port
from rsparse_tpu_torch.sparse import device as port_dev

torch.set_num_threads(2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _csr(seed, n_rows=90, n_cols=50, density=0.12):
    """Signed values, two empty rows and one heavy row (several bucket
    lengths; row_align 32 leaves padding rows)."""
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="lil")
    m[3, :] = 0
    m[10, :] = 0
    m[5, :] = rng.random(n_cols) + 0.5
    m = sp.csr_matrix(m)
    m.data = rng.standard_normal(m.nnz)
    return m


def _both(m, precision):
    jdt = jnp.float64 if precision == "float64" else jnp.float32
    tdt = torch.float64 if precision == "float64" else torch.float32
    bj = ref_dev.bucket_rows(m, jdt, max_elems=256)
    bt = port_dev.bucket_rows(m, tdt, "cpu", max_elems=256)
    assert len(bt.buckets) > 2
    assert any(int((b.row_ids == m.shape[0]).sum()) for b in bt.buckets)
    return bj, bt, jdt, tdt


def _factors(seed, shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("override", [False, True])
def test_spmm_matches_reference(override):
    m = _csr(0)
    bj, bt, jdt, tdt = _both(m, "float64")
    (dense,) = _factors(1, [(m.shape[1], 7)])
    vj = vt = None
    if override:
        rng = np.random.default_rng(2)
        vals = [rng.standard_normal(b.values.shape) for b in bt.buckets]
        vj = [jnp.asarray(v) for v in vals]
        vt = [torch.as_tensor(v) for v in vals]
    oj = ref.spmm_buckets(bj.buckets, m.shape[0], jnp.asarray(dense),
                          values_list=vj)
    ot = port.spmm_buckets(bt.buckets, m.shape[0], torch.as_tensor(dense),
                           values_list=vt)
    assert ot.dtype == torch.float64 and tuple(ot.shape) == (m.shape[0], 7)
    assert _rel(ot, oj) <= 1e-12
    assert not ot[[3, 10]].any()                    # empty rows stay zero


@pytest.mark.parametrize("k", [1, 6, 16])
def test_spmm_residual_matches_reference(k):
    m = _csr(3)
    bj, bt, _, _ = _both(m, "float64")
    u, v, d = _factors(4, [(m.shape[0], k), (m.shape[1], k), (k,)])
    d = np.abs(d) + 0.1
    pj, sj = ref.spmm_residual_buckets(bj.buckets, m.shape[0], jnp.asarray(u),
                                       jnp.asarray(v), jnp.asarray(d))
    pt, st = port.spmm_residual_buckets(bt.buckets, m.shape[0],
                                        torch.as_tensor(u),
                                        torch.as_tensor(v),
                                        torch.as_tensor(d))
    assert _rel(pt, pj) <= 1e-12
    assert st.dtype == torch.float32
    assert float(st) == pytest.approx(float(sj), rel=1e-6)


def test_approx_only_and_residual_values_match_reference():
    """The approx-only mode: the low-rank product at every valid entry
    (the port writes 0 at padding entries, which nothing reads); and the
    residual values built on it."""
    m = _csr(5)
    bj, bt, _, _ = _both(m, "float64")
    u, v, d = _factors(6, [(m.shape[0], 5), (m.shape[1], 5), (5,)])
    for scale in (None, d):
        sj = None if scale is None else jnp.asarray(scale)
        st = None if scale is None else torch.as_tensor(scale)
        aj = ref.sparse_approx_buckets(bj.buckets, jnp.asarray(u),
                                       jnp.asarray(v), sj)
        at = port.sparse_approx_buckets(bt.buckets, torch.as_tensor(u),
                                        torch.as_tensor(v), st)
        rj = ref.residual_values(bj.buckets, jnp.asarray(u), jnp.asarray(v),
                                 sj)
        rt = port.residual_values(bt.buckets, torch.as_tensor(u),
                                  torch.as_tensor(v), st)
        for b, a_j, a_t, r_j, r_t in zip(bt.buckets, aj, at, rj, rt):
            mask = b.mask().numpy()
            assert _rel(a_t.numpy()[mask], np.asarray(a_j)[mask]) <= 1e-12
            assert _rel(r_t.numpy()[mask], np.asarray(r_j)[mask]) <= 1e-12
            assert not a_t.numpy()[~mask].any()
        # the residual through the SpMM: what soft-impute's final step runs
        oj = ref.spmm_buckets(bj.buckets, m.shape[0], jnp.asarray(v),
                              values_list=rj)
        ot = port.spmm_buckets(bt.buckets, m.shape[0], torch.as_tensor(v),
                               values_list=rt)
        assert _rel(ot, oj) <= 1e-12
        assert float(port.sq_norm_values(bt.buckets, rt)) == pytest.approx(
            float(ref.sq_norm_values(bj.buckets, rj)), rel=1e-6)


def test_empty_matrices():
    """No buckets at all, and rows with no entries, give zero rows and a
    zero norm in both packages."""
    m = sp.csr_matrix((12, 9))
    bj, bt = (ref_dev.bucket_rows(m, jnp.float64),
              port_dev.bucket_rows(m, torch.float64, "cpu"))
    assert bt.buckets == () and bj.buckets == ()
    dense = torch.ones((9, 4), dtype=torch.float64)
    out = port.spmm_buckets(bt.buckets, 12, dense)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref.spmm_buckets(bj.buckets, 12,
                                                 jnp.ones((9, 4)))))
    proj, sq = port.spmm_residual_buckets(bt.buckets, 12,
                                          torch.ones((12, 4)), dense.float(),
                                          torch.ones(4))
    assert not proj.any() and float(sq) == 0.0
    assert float(port.sq_norm_values(bt.buckets)) == 0.0


def test_bf16_gathers_match_reference():
    """compute_dtype="bfloat16" rounds the table, the values (K5) and the
    left factor and residual (K6) to bf16, sums in f32; both packages."""
    m = _csr(7)
    bj, bt, _, _ = _both(m, "float32")
    u, v, d = _factors(8, [(m.shape[0], 12), (m.shape[1], 12), (12,)],
                       np.float32)
    d = np.abs(d) + 0.1
    oj = ref.spmm_buckets(bj.buckets, m.shape[0], jnp.asarray(v),
                          compute_dtype="bfloat16")
    ot = port.spmm_buckets(bt.buckets, m.shape[0], torch.as_tensor(v),
                           compute_dtype="bfloat16")
    assert ot.dtype == torch.float32
    assert _rel(ot, oj) <= 1e-2
    # the bf16 rounding is really there: f32 gathers differ from it
    o32 = port.spmm_buckets(bt.buckets, m.shape[0], torch.as_tensor(v))
    assert _rel(ot, o32) > 1e-5
    pj, sj = ref.spmm_residual_buckets(
        bj.buckets, m.shape[0], jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(d), compute_dtype="bfloat16")
    pt, st = port.spmm_residual_buckets(
        bt.buckets, m.shape[0], torch.as_tensor(u), torch.as_tensor(v),
        torch.as_tensor(d), compute_dtype="bfloat16")
    assert _rel(pt, pj) <= 1e-2
    assert float(st) == pytest.approx(float(sj), rel=1e-2)


def test_gather_table_names():
    t = torch.ones((3, 2))
    assert port._gather_table(t, None) is t
    assert port._gather_table(t, "float32") is t
    assert port._gather_table(t, "bfloat16").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        port._gather_table(t, "int8")
