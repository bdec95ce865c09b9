"""Port parity of the whole WRMF slice: fit_transform, transform, predict.

The same seed and the same numpy-made input go through ``rsparse_tpu.WRMF``
and ``rsparse_tpu_torch.WRMF`` at float64 on the CPU (where the port runs
the plain versions of its kernels).  Stated tolerances: loss history to
1e-8 relative; components and user factors to 1e-7; identical predict
indices.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu_torch.convert import wrmf_from_numpy

torch.set_num_threads(2)


def _synthetic(seed=0, n_users=300, n_items=200, mean_nnz=20):
    """Implicit interactions with zipf item popularity (~6k nnz)."""
    rng = np.random.default_rng(seed)
    row_nnz = rng.integers(1, 2 * mean_nnz, n_users)
    row_nnz[5] = 0                                  # an empty user
    pop = 1.0 / (np.arange(n_items) + 5.0)
    cols = rng.choice(n_items, size=int(row_nnz.sum()), p=pop / pop.sum())
    rows = np.repeat(np.arange(n_users), row_nnz)
    vals = 1.0 + rng.exponential(2.0, size=len(rows))
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n_users, n_items))
    m.sum_duplicates()
    m.col_names = [f"i{j}" for j in range(n_items)]
    return m


CASES = {
    "cg_global_bias_hot": dict(solver="conjugate_gradient",
                               with_global_bias=True),
    "cholesky": dict(solver="cholesky"),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def fitted_pair(request):
    x = _synthetic()
    kw = dict(rank=8, lambda_=0.5, feedback="implicit", precision="double",
              seed=0, **CASES[request.param])
    mj = rt_ref.WRMF(**kw)
    ej = np.asarray(mj.fit_transform(x, n_iter=4, convergence_tol=-1))
    mt = rt.WRMF(**kw, device="cpu")
    et = mt.fit_transform(x, n_iter=4, convergence_tol=-1)
    return x, mj, ej, mt, et


def test_fit_transform_matches_reference(fitted_pair):
    x, mj, ej, mt, et = fitted_pair
    if mt.solver == 1:
        assert mt.stage_info["hot_items"] > 0       # the dense head ran
        assert mt.stage_info["hot_users"] > 0
    assert len(mt.loss_history) == len(mj.loss_history) == 4
    np.testing.assert_allclose(mt.loss_history, mj.loss_history, rtol=1e-8)
    np.testing.assert_allclose(mt.components, np.asarray(mj.components),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=1e-7)
    assert mt.global_bias == pytest.approx(mj.global_bias, rel=1e-15)
    # fit_transform == transform (reference test-wrmf.R:56-57)
    np.testing.assert_allclose(mt.transform(x).numpy(), et.numpy(), rtol=0,
                               atol=1e-12)
    pj = mj.predict(x, k=10)
    pt = mt.predict(x, k=10)
    np.testing.assert_array_equal(pt.indices, pj.indices)
    np.testing.assert_array_equal(pt.ids, pj.ids)


def test_state_carried_by_convert(fitted_pair):
    x, mj, _, _, _ = fitted_pair
    mc = wrmf_from_numpy(np.asarray(mj.components), np.asarray(mj._U),
                         mj.global_bias, item_ids=mj.item_ids,
                         lambda_=mj.lambda_, precision="double",
                         with_global_bias=mj.with_global_bias, device="cpu")
    held_out = x[::3]
    np.testing.assert_allclose(mc.transform(held_out).numpy(),
                               np.asarray(mj.transform(held_out)), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(mc.predict(held_out, k=7).indices,
                                  mj.predict(held_out, k=7).indices)
    sj = mj.get_similar_items(3, k=15, device=True)
    st = mc.get_similar_items(3, k=15, device=True)
    np.testing.assert_array_equal(st.indices, sj.indices)
    np.testing.assert_array_equal(st.ids, sj.ids)


def test_ml100k_quality_gate_float32():
    """The port alone passes the reference's ML-100k gate (bench.py
    measure_quality_ml100k: rank 10, lambda 1, CG, seed 0, 80/20 split)."""
    x = rt.load_movielens100k()
    train, test = rt.train_test_split(x, 0.2, np.random.default_rng(0))
    m = rt.WRMF(rank=10, lambda_=1.0, feedback="implicit",
                solver="conjugate_gradient", seed=0, device="cpu")
    m.fit_transform(train, n_iter=10)
    assert all(b <= a for a, b in zip(m.loss_history, m.loss_history[1:]))
    preds = m.predict(train, k=10, not_recommend=train)
    assert np.nanmean(rt.ndcg_k(preds.indices, test)) > 0.31
    assert np.nanmean(rt.ap_k(preds.indices, test)) > 0.37


def test_port_imports_no_jax():
    code = ("import sys, rsparse_tpu_torch, rsparse_tpu_torch.convert; "
            "import rsparse_tpu_torch.ops.spmm, "
            "rsparse_tpu_torch.models.soft_als, "
            "rsparse_tpu_torch.models.pure_svd, "
            "rsparse_tpu_torch.models.linear_flow, "
            "rsparse_tpu_torch.models.kmeans, "
            "rsparse_tpu_torch.models.scale_normalize, "
            "rsparse_tpu_torch.sparse.splr, "
            "rsparse_tpu_torch.ops.segsum, "
            "rsparse_tpu_torch.models.ftrl, "
            "rsparse_tpu_torch.models.fm, "
            "rsparse_tpu_torch.models.rankmf, "
            "rsparse_tpu_torch.models.glove, rsparse_tpu_torch.ops.gather, "
            "rsparse_tpu_torch.cli, rsparse_tpu_torch.data.io, "
            "rsparse_tpu_torch.utils.checkpoint, "
            "rsparse_tpu_torch.utils.profiling, "
            "chip_smoke; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m.startswith('rsparse_tpu.') or m == 'rsparse_tpu'"
            " for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                       __file__))))


@pytest.mark.parametrize("kwargs", [
    dict(mesh=object(), compute_dtype="bfloat16"),
    dict(mesh=object(), hot_dtype="uint8"),
    dict(mesh=object(), precision="bfloat16"),
    dict(mesh=object()),
    dict(routing="alx"),
])
def test_options_outside_the_slice_raise(kwargs):
    """The mesh and routing are ported (tests/test_torch_parallel.py): what
    stays outside is a mesh that is not the port's own (a JAX mesh, any
    other object), with or without the reduced-precision options, and
    routing without a mesh, which the JAX package refuses too."""
    exc, match = ((TypeError, "parallel.mesh.Mesh") if "mesh" in kwargs
                  else (ValueError, "routing='alx' requires a mesh"))
    with pytest.raises(exc, match=match):
        rt.WRMF(device="cpu", **kwargs)


# -- the dense zipf head with explicit feedback and the exact solvers --------
# (the reference's tests/test_wrmf.py:290-320 and :396-427, on the port,
# plus the same fits through the reference)

def _explicit_with_stored_zeros():
    """Explicit ratings with a stored 0.0 on the hottest column and on a
    tail column (rsparse_tpu tests/test_wrmf.py:296-307)."""
    m = sp.random(100, 64, 0.25, random_state=6, format="csr")
    m.data = np.round(1.0 + 4.0 * m.data, 2)
    hot_col = int(np.argmax(np.bincount(m.indices, minlength=64)))
    m = m.tolil()
    m[3, hot_col] = 1e-300
    m[4, 63] = 1e-300
    m = sp.csr_matrix(m)
    m.data[np.abs(m.data) < 1e-200] = 0.0
    assert (m.data == 0.0).sum() == 2
    return m


@pytest.mark.parametrize("dyn", [False, True])
def test_explicit_hot_cold_split_parity(dyn):
    """Same normal equations partitioned by column set: the head split
    matches the pure-bucketed fit to 1e-9, stored zero ratings keep their
    lhs and loss terms through the presence bits, and both match the
    reference's split fit."""
    m = _explicit_with_stored_zeros()
    kw = dict(rank=6, lambda_=0.3, feedback="explicit", dynamic_lambda=dyn,
              solver="conjugate_gradient", seed=0, precision="double")
    m0 = rt.WRMF(n_hot=0, device="cpu", **kw)
    e0 = m0.fit_transform(m, n_iter=3, convergence_tol=-1).numpy()
    m1 = rt.WRMF(n_hot=16, device="cpu", **kw)
    e1 = m1.fit_transform(m, n_iter=3, convergence_tol=-1).numpy()
    assert m1.stage_info["hot_items"] == 16
    np.testing.assert_allclose(e1, e0, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(m1.loss_history, m0.loss_history, rtol=1e-9)
    mj = rt_ref.WRMF(n_hot=16, **kw)
    ej = np.asarray(mj.fit_transform(m, n_iter=3, convergence_tol=-1))
    np.testing.assert_allclose(e1, ej, rtol=0, atol=1e-9)
    np.testing.assert_allclose(m1.loss_history, mj.loss_history, rtol=1e-9)


@pytest.mark.parametrize("solver", ["cholesky", "nnls"])
def test_exact_solver_hot_cold_split_parity(solver):
    """Cholesky and NNLS with a dense head: the head's lhs term reproduces
    the pure-bucketed exact solve (NNLS to the reference's own tolerance,
    rtol 0.05 / atol 0.02: the coordinate descent stops at a relative
    change of 1e-4, so summation order moves its stopping point)."""
    rng = np.random.default_rng(7)
    m = sp.random(250, 160, 0.08, random_state=7, format="csr")
    m.data = 1.0 + rng.exponential(2.0, m.nnz)
    kw = dict(rank=8, lambda_=0.5, feedback="implicit", solver=solver,
              seed=0, precision="double")
    e0 = rt.WRMF(n_hot=0, device="cpu", **kw).fit_transform(
        m, n_iter=2, convergence_tol=-1).numpy()
    m1 = rt.WRMF(n_hot=48, device="cpu", **kw)
    e1 = m1.fit_transform(m, n_iter=2, convergence_tol=-1).numpy()
    assert m1.stage_info["hot_items"] == 48
    if solver == "nnls":
        assert (e1 >= 0).all()
        np.testing.assert_allclose(e1, e0, rtol=0.05, atol=0.02)
    else:
        np.testing.assert_allclose(e1, e0, rtol=1e-8, atol=1e-10)
        ej = np.asarray(rt_ref.WRMF(n_hot=48, **kw).fit_transform(
            m, n_iter=2, convergence_tol=-1))
        np.testing.assert_allclose(e1, ej, rtol=0, atol=1e-9)


def test_explicit_cholesky_dynamic_lambda_hot_split_parity():
    me = sp.random(120, 80, 0.2, random_state=8, format="csr")
    me.data = np.round(1.0 + 4.0 * me.data, 2)
    kw = dict(rank=6, lambda_=0.3, feedback="explicit", solver="cholesky",
              dynamic_lambda=True, seed=0, precision="double")
    e0 = rt.WRMF(n_hot=0, device="cpu", **kw).fit_transform(
        me, n_iter=2, convergence_tol=-1).numpy()
    e1 = rt.WRMF(n_hot=16, device="cpu", **kw).fit_transform(
        me, n_iter=2, convergence_tol=-1).numpy()
    np.testing.assert_allclose(e1, e0, rtol=1e-8, atol=1e-10)


def test_biases_disable_the_head():
    """The reference's rule: no dense head with per-entity biases, even
    when n_hot asks for one."""
    m = rt.WRMF(rank=4, n_hot=32, with_user_item_bias=True, device="cpu",
                precision="double", seed=0)
    m.fit_transform(_synthetic(), n_iter=1)
    assert m.stage_info["hot_items"] == m.stage_info["hot_users"] == 0


def test_explicit_bias_model_carried_by_convert():
    """A reference-fitted explicit model with user/item and global biases,
    moved across by its arrays, gives the same transform and predict."""
    x = _synthetic(3)
    x.data = np.round(x.data)
    kw = dict(rank=5, lambda_=0.3, feedback="explicit", solver="cholesky",
              with_user_item_bias=True, with_global_bias=True,
              dynamic_lambda=True, precision="double")
    mj = rt_ref.WRMF(seed=0, **kw)
    mj.fit_transform(x, n_iter=3, convergence_tol=-1)
    assert mj.components.shape == (7, x.shape[1])
    mc = wrmf_from_numpy(np.asarray(mj.components), np.asarray(mj._U),
                         mj.global_bias, item_ids=mj.item_ids, device="cpu",
                         **kw)
    assert mc.rank == 5 and mc.components.shape == (7, x.shape[1])
    held_out = x[::3]
    np.testing.assert_allclose(mc.transform(held_out).numpy(),
                               np.asarray(mj.transform(held_out)), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(mc.predict(held_out, k=7).indices,
                                  mj.predict(held_out, k=7).indices)
    with pytest.raises(ValueError, match="rows of components"):
        wrmf_from_numpy(np.asarray(mj.components), rank=7,
                        with_user_item_bias=True, device="cpu")


def test_ml100k_explicit_rating_gate_float32():
    """The port alone passes the reference's explicit rating gate
    (rsparse_tpu tests/test_wrmf.py:183-203: explicit, Cholesky, biases,
    rank 10, lambda 0.3, 30 iterations, seed-7 split): RMSE < 1.05 and
    below the global-mean predictor (the reference measured 0.980)."""
    full = sp.csr_matrix(rt.load_movielens100k())
    tr, te = rt.train_test_split(full, 0.8, np.random.default_rng(7))
    te = te.tocoo()
    mean = tr.data.mean()
    trc = tr.copy()
    trc.data = trc.data - mean
    m = rt.WRMF(rank=10, lambda_=0.3, feedback="explicit", solver="cholesky",
                with_user_item_bias=True, seed=0, device="cpu")
    emb = m.fit_transform(trc, n_iter=30).numpy().astype(np.float64)
    scores = emb @ m.components + mean
    rmse = np.sqrt(np.mean((scores[te.row, te.col] - te.data) ** 2))
    baseline = np.sqrt(np.mean((te.data - mean) ** 2))
    assert rmse < 1.05 and rmse < baseline, (rmse, baseline)
