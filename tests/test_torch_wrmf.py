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
    st = mc.get_similar_items(3, k=15)
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
    code = ("import sys, rsparse_tpu_torch; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m.startswith('rsparse_tpu.') or m == 'rsparse_tpu'"
            " for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                       __file__))))


@pytest.mark.parametrize("kwargs", [
    dict(feedback="explicit"),
    dict(solver="nnls"),
    dict(with_user_item_bias=True),
    dict(compute_dtype="bfloat16"),
    dict(hot_dtype="uint8"),
    dict(precision="bfloat16"),
    dict(mesh=object()),
    dict(routing="alx"),
    dict(solver="cholesky", n_hot=64),
])
def test_options_outside_the_slice_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rt.WRMF(device="cpu", **kwargs)


def test_checkpoint_outside_the_slice_raises():
    m = rt.WRMF(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        m.fit_transform(_synthetic(), checkpoint_path="ckpt")
