"""Port parity: one ALS half-sweep, and the K1/K2/K4 wrappers.

Float64 inputs made with numpy go through ``rsparse_tpu.ops.als`` and
``rsparse_tpu_torch.ops.als``.  On CPU tensors the wrappers run their plain
PyTorch versions.  Stated tolerances: new factors to 1e-9 absolute, losses
to 1e-10 relative; NNLS factors to 1e-3 and losses to 1e-5 relative,
because the port stops each system's coordinate descent on its own where
the reference stops the whole batch at once (both at a relative change of
1e-4), so a system may run a few sweeps more or fewer.
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
    solve = (port.solve_bucket_cholesky if solver == "cholesky"
             else port.solve_bucket_cg)
    yt, lt = solve(torch.from_numpy(src), None, XtX_t, init_t, bt.buckets[b],
                   torch.from_numpy(x0), LAM, g, ct,
                   None if Wh is None else torch.from_numpy(Wh),
                   None if Vh is None else torch.from_numpy(Vh))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)


# -- every solver x feedback x bias x head combination the reference allows --

VARIANTS = {
    # name: (with_biases, bias_last_in_source, implicit global bias, head,
    #        explicit dynamic lambda)
    "plain": (False, True, False, False, True),
    "bias_last": (True, True, False, False, True),
    "bias_first": (True, False, False, False, True),
    "global_bias": (False, True, True, False, True),
    "hot": (False, True, False, True, True),
    "hot_global_bias": (False, True, True, True, True),
    "static_lambda": (False, True, False, False, False),
    "hot_static_lambda": (False, True, False, True, False),
}
IMPLICIT_ONLY = {"global_bias", "hot_global_bias"}
EXPLICIT_ONLY = {"static_lambda", "hot_static_lambda"}
SWEEP_CASES = [(s, f, v) for s in ("conjugate_gradient", "cholesky", "nnls")
               for f in ("implicit", "explicit") for v in VARIANTS
               if not (f == "explicit" and v in IMPLICIT_ONLY)
               and not (f == "implicit" and v in EXPLICIT_ONLY)]


def _sweep_case(solver, feedback, variant, seed):
    """A sweep problem with (n_src, R) sources carrying ones and bias
    columns when biased; explicit ratings are centred integers, many of
    them stored zeros (some in the head)."""
    biases, last, ugb, hot, dyn = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    m = sp.random(N_TGT, N_SRC, density=0.2,
                  random_state=np.random.RandomState(seed), format="lil")
    m[7, :] = 0
    m = sp.csr_matrix(m)
    m.data = (np.round(1.0 + 4.0 * m.data) - 3.0 if feedback == "explicit"
              else 1.0 + 4.0 * m.data)
    R = D + 2 if biases else D
    src = rng.standard_normal((N_SRC, R)) * 0.3
    tgt = rng.standard_normal((N_TGT, R)) * 0.3
    if solver == "nnls":
        tgt = np.abs(tgt)
    if biases:
        src[:, 0 if last else R - 1] = 1.0
        tgt[:, R - 1 if last else 0] = 1.0
    g = 0.07 if feedback == "implicit" and (ugb or biases) else 0.0
    code = ref.solver_code(solver)
    dyn = dyn and feedback == "explicit"
    ct = port.ALSConfig(solver=code, use_global_bias=ugb, feedback=feedback,
                        with_biases=biases, bias_last_in_source=last,
                        dynamic_lambda=dyn)
    cj = ref.ALSConfig(feedback=feedback, solver=code, with_biases=biases,
                       bias_last_in_source=last, use_global_bias=ugb,
                       dynamic_lambda=dyn, solve_empty=ct.solve_empty)
    return m, src, tgt, g, cj, ct, hot


@pytest.mark.parametrize("solver,feedback,variant", SWEEP_CASES)
def test_every_sweep_configuration_matches_reference(solver, feedback,
                                                     variant):
    m, src, tgt, g, cj, ct, hot = _sweep_case(solver, feedback, variant, 21)
    explicit = feedback == "explicit"
    hj = ht = rows_j = rows_t = None
    cold = m
    if hot:
        hj, cold = ref_dev.split_hot_cold(m, 10, jnp.float64,
                                          with_presence=explicit)
        ht, _ = port_dev.split_hot_cold(m, 10, torch.float64, "cpu",
                                        with_presence=explicit)
        # explicit: stored zero ratings in the head travel as presence bits
        assert (ht.present_bits is not None) == explicit
    incl = ct.solve_empty or hot
    bj = ref_dev.bucket_rows(cold, jnp.float64, include_empty=incl,
                             row_align=8)
    bt = port_dev.bucket_rows(cold, torch.float64, "cpu", include_empty=incl,
                              row_align=8)
    if hot:
        rows_j = ref_dev.hot_bucket_rows(hj, bj.buckets, N_TGT)
        rows_t = port_dev.hot_bucket_rows(ht, bt.buckets)
    cnt = np.diff(m.tocsc().indptr).astype(np.float64)
    yj, lj = ref.wrmf_sweep(jnp.asarray(src), jnp.asarray(tgt), bj.buckets,
                            jnp.asarray(cnt), LAM, g, cj, hj, rows_j)
    yt, lt = port.wrmf_sweep(torch.from_numpy(src), torch.from_numpy(tgt),
                             bt.buckets, LAM, g, ct,
                             None if ht is None else ht.hot_ids, rows_t,
                             torch.from_numpy(cnt))
    yj = np.asarray(yj)
    assert yt.shape == yj.shape == tgt.shape
    if solver == "nnls":
        assert yt.numpy()[:, ref._active_slices(cj, src.shape[1])[1]].min() >= 0
        assert np.abs(yt.numpy() - yj).max() <= 1e-3 * np.abs(yj).max()
        assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    else:
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-9)
        assert abs(float(lt) - float(lj)) <= 1e-10 * abs(float(lj))


@pytest.mark.parametrize("solver", ["conjugate_gradient", "cholesky", "nnls"])
def test_explicit_bucket_wrappers_on_cpu(solver):
    """The K1/K2/K4 entry points on an explicit bucket with biases, a dense
    head with presence bits (stored zero ratings) and dynamic lambda over
    the total nnz, against the reference's per-bucket solve."""
    rng = np.random.default_rng(31)
    m, src, _, _, cj, ct, _ = _sweep_case(solver, "explicit", "plain", 31)
    bj = ref_dev.bucket_rows(m, jnp.float64, row_align=8)
    bt = port_dev.bucket_rows(m, torch.float64, "cpu", row_align=8)
    b = int(np.argmax([bk.pad_len for bk in bt.buckets]))
    B = bt.buckets[b].batch
    x0 = np.abs(rng.standard_normal((B, D))) * 0.1
    xb = rng.standard_normal(N_SRC) * 0.2
    H = 13
    present = rng.random((B, H)) < 0.4
    Wh = np.where(present, np.round(rng.random((B, H)) * 4) - 2, 0.0)
    assert (present & (Wh == 0)).any()
    bits = np.packbits(np.pad(present, ((0, 0), (0, 3))), axis=1,
                       bitorder="little")
    Vh = rng.standard_normal((H, D)) * 0.3
    nnz_tot = np.asarray(bt.buckets[b].nnz) + present.sum(1)
    cj = ref.ALSConfig(feedback="explicit", solver=cj.solver,
                       with_biases=True, dynamic_lambda=True)
    ct = port.ALSConfig(solver=ct.solver, feedback="explicit",
                        with_biases=True, dynamic_lambda=True)
    yj, lj = ref._solve_bucket_explicit(
        jnp.asarray(src), jnp.asarray(xb), bj.buckets[b], jnp.asarray(x0),
        jnp.asarray(LAM), cj, jnp.float64, hot_W=jnp.asarray(Wh),
        V_hot=jnp.asarray(Vh), hot_bits=jnp.asarray(bits),
        nnz_total=jnp.asarray(nnz_tot.astype(np.int32)))
    solve = {"conjugate_gradient": port.solve_bucket_cg,
             "cholesky": port.solve_bucket_cholesky,
             "nnls": port.solve_bucket_nnls}[solver]
    yt, lt = solve(torch.from_numpy(src), torch.from_numpy(xb), None, None,
                   bt.buckets[b], torch.from_numpy(x0), LAM, 0.0, ct,
                   torch.from_numpy(Wh), torch.from_numpy(Vh),
                   torch.from_numpy(bits),
                   torch.from_numpy(nnz_tot.astype(np.int32)))
    tol = 1e-3 if solver == "nnls" else 1e-9
    assert np.abs(yt.numpy() - np.asarray(yj)).max() <= tol * np.abs(
        np.asarray(yj)).max()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               rtol=1e-5 if solver == "nnls" else 1e-10)


def test_hot_lhs_matches_reference():
    """The plain version of the exact solvers' dense-head lhs term."""
    rng = np.random.default_rng(5)
    w = rng.random((9, 17)) * (rng.random((9, 17)) < 0.5)
    Vh = rng.standard_normal((17, D))
    lj = np.asarray(ref._hot_lhs(jnp.asarray(w), jnp.asarray(Vh), jnp.float64))
    lt = port._hot_lhs(torch.from_numpy(w), torch.from_numpy(Vh)).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(lt[0], (Vh.T * w[0]) @ Vh, rtol=1e-12)


# -- dense numpy oracles (the reference's tests/test_wrmf.py:96-158) ---------

def test_wrmf_sweep_matches_dense_oracle():
    """One implicit Cholesky item sweep against a dense numpy solve of the
    same normal equations (inst/include/wrmf_implicit.hpp:206-237)."""
    rng = np.random.default_rng(0)
    n_u, n_i, r, lam = 50, 30, 6, 0.3
    conf = sp.random(n_u, n_i, density=0.3,
                     random_state=np.random.RandomState(1), format="csr")
    conf.data = 1.0 + 4.0 * conf.data
    U = rng.standard_normal((n_u, r)) * 0.1
    iu = port_dev.bucket_rows(conf.T.tocsr(), torch.float64, "cpu")
    V_new, _ = port.wrmf_sweep(torch.from_numpy(U),
                               torch.zeros((n_i, r), dtype=torch.float64),
                               iu.buckets, lam, 0.0,
                               port.ALSConfig(solver=port.CHOLESKY))
    V_new = V_new.numpy()
    XtX = U.T @ U + lam * np.eye(r)
    csc = conf.tocsc()
    for i in range(n_i):
        idx, c = (csc.indices[csc.indptr[i]:csc.indptr[i + 1]],
                  csc.data[csc.indptr[i]:csc.indptr[i + 1]])
        if len(idx) == 0:
            np.testing.assert_allclose(V_new[i], 0.0)
            continue
        Un = U[idx]
        lhs = XtX + Un.T @ ((c - 1.0)[:, None] * Un)
        np.testing.assert_allclose(V_new[i], np.linalg.solve(lhs, Un.T @ c),
                                   rtol=1e-6, atol=1e-9)


def test_wrmf_explicit_sweep_matches_dense_oracle():
    """Explicit dynamic-lambda sweep against a dense numpy solve
    (inst/include/wrmf_explicit.hpp:78,103-108)."""
    rng = np.random.default_rng(2)
    n_u, n_i, r, lam = 40, 25, 5, 0.2
    x = sp.random(n_u, n_i, density=0.25,
                  random_state=np.random.RandomState(3), format="csr")
    x.data = 1.0 + 4.0 * rng.random(x.nnz)
    U = rng.standard_normal((n_u, r)) * 0.1
    cfg = port.ALSConfig(solver=port.CHOLESKY, feedback="explicit",
                         dynamic_lambda=True)
    iu = port_dev.bucket_rows(x.T.tocsr(), torch.float64, "cpu")
    cnt_u = torch.from_numpy(np.diff(x.indptr).astype(np.float64))
    V_new, _ = port.wrmf_sweep(torch.from_numpy(U),
                               torch.zeros((n_i, r), dtype=torch.float64),
                               iu.buckets, lam, 0.0, cfg, src_cnt=cnt_u)
    V_new = V_new.numpy()
    csc = x.tocsc()
    for i in range(n_i):
        idx, vals = (csc.indices[csc.indptr[i]:csc.indptr[i + 1]],
                     csc.data[csc.indptr[i]:csc.indptr[i + 1]])
        if len(idx) == 0:
            np.testing.assert_allclose(V_new[i], 0.0)
            continue
        Un = U[idx]
        lhs = Un.T @ Un + lam * len(idx) * np.eye(r)
        np.testing.assert_allclose(V_new[i], np.linalg.solve(lhs, Un.T @ vals),
                                   rtol=1e-6, atol=1e-9)
