"""Port parity: one implicit ALS half-sweep, and the K1/K2 wrappers.

Float64 inputs made with numpy go through ``rsparse_tpu.ops.als`` and
``rsparse_tpu_torch.ops.als``.  On CPU tensors the wrappers run their plain
PyTorch versions.  Stated tolerances: new factors to 1e-9 absolute, losses
to 1e-10 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu.ops import als as ref
from rsparse_tpu.sparse import device as ref_dev
from rsparse_tpu_torch.ops import als as port
from rsparse_tpu_torch.sparse import device as port_dev

torch.set_num_threads(2)

N_TGT, N_SRC, D = 64, 48, 12
LAM = 0.5


def _problem(seed):
    rng = np.random.default_rng(seed)
    m = sp.random(N_TGT, N_SRC, density=0.2,
                  random_state=np.random.RandomState(seed), format="lil")
    m[7, :] = 0                                   # an empty target row
    m = sp.csr_matrix(m)
    m.data = 1.0 + 4.0 * m.data
    src = rng.standard_normal((N_SRC, D)) * 0.3
    tgt = rng.standard_normal((N_TGT, D)) * 0.3
    return m, src, tgt


def _configs(solver, ugb):
    code = ref.solver_code(solver)
    cj = ref.ALSConfig(feedback="implicit", solver=code, use_global_bias=ugb,
                       solve_empty=ugb)
    ct = port.ALSConfig(solver=code, use_global_bias=ugb)
    return cj, ct


@pytest.mark.parametrize("solver,ugb,hot", [
    ("conjugate_gradient", False, False),
    ("conjugate_gradient", True, False),
    ("conjugate_gradient", False, True),
    ("conjugate_gradient", True, True),
    ("cholesky", False, False),
    ("cholesky", True, False),
])
def test_wrmf_sweep_matches_reference(solver, ugb, hot):
    m, src, tgt = _problem(1 + ugb + 2 * hot)
    g = 0.07 if ugb else 0.0
    cj, ct = _configs(solver, ugb)
    hj = ht = rows_j = rows_t = None
    cold = m
    if hot:
        hj, cold = ref_dev.split_hot_cold(m, 10, jnp.float64)
        ht, _ = port_dev.split_hot_cold(m, 10, torch.float64, "cpu")
    incl = ugb or hot
    bj = ref_dev.bucket_rows(cold, jnp.float64, include_empty=incl,
                             row_align=8)
    bt = port_dev.bucket_rows(cold, torch.float64, "cpu", include_empty=incl,
                              row_align=8)
    if hot:
        rows_j = ref_dev.hot_bucket_rows(hj, bj.buckets, N_TGT)
        rows_t = port_dev.hot_bucket_rows(ht, bt.buckets)
    yj, lj = ref.wrmf_sweep(jnp.asarray(src), jnp.asarray(tgt), bj.buckets,
                            None, LAM, g, cj, hj, rows_j)
    yt, lt = port.wrmf_sweep(torch.from_numpy(src), torch.from_numpy(tgt),
                             bt.buckets, LAM, g, ct,
                             None if ht is None else ht.hot_ids, rows_t)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-9)
    assert abs(float(lt) - float(lj)) <= 1e-10 * abs(float(lj))
    # the empty row solves only under the global-bias semantics
    assert (np.abs(yt.numpy()[7]).sum() > 0) == ugb


@pytest.mark.parametrize("solver,hot", [("conjugate_gradient", False),
                                        ("conjugate_gradient", True),
                                        ("cholesky", False)])
def test_bucket_kernel_wrappers_on_cpu(solver, hot):
    """solve_bucket_cg / solve_bucket_cholesky (the K1/K2 entry points) on
    CPU tensors against the reference's per-bucket solve."""
    m, src, tgt = _problem(11)
    g = 0.05
    cj, ct = _configs(solver, True)
    bj = ref_dev.bucket_rows(m, jnp.float64, row_align=8)
    bt = port_dev.bucket_rows(m, torch.float64, "cpu", row_align=8)
    b = int(np.argmax([bk.pad_len for bk in bt.buckets]))
    B = bt.buckets[b].batch
    rng = np.random.default_rng(12)
    x0 = rng.standard_normal((B, D)) * 0.1
    Wh = Vh = None
    if hot:
        Wh = np.where(rng.random((B, 9)) < 0.4, 1.0 + rng.random((B, 9)), 0.0)
        Vh = rng.standard_normal((9, D)) * 0.3
    s = jnp.asarray(src)
    XtX = s.T @ s + LAM * jnp.eye(D, dtype=s.dtype)
    rhs_init = -g * s.sum(0)
    yj, lj = ref._solve_bucket_implicit(
        s, None, XtX, rhs_init, bj.buckets[b], jnp.asarray(x0),
        jnp.asarray(LAM), jnp.asarray(g), cj,
        jnp.float64, hot_W=None if Wh is None else jnp.asarray(Wh),
        V_hot=None if Vh is None else jnp.asarray(Vh))
    XtX_t = torch.tensor(np.asarray(XtX))
    init_t = torch.tensor(np.asarray(rhs_init))
    if solver == "cholesky":
        yt, lt = port.solve_bucket_cholesky(torch.from_numpy(src), XtX_t,
                                            init_t, bt.buckets[b], LAM, g, ct)
    else:
        yt, lt = port.solve_bucket_cg(
            torch.from_numpy(src), XtX_t, init_t, bt.buckets[b],
            torch.from_numpy(x0), LAM, g, ct,
            None if Wh is None else torch.from_numpy(Wh),
            None if Vh is None else torch.from_numpy(Vh))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
