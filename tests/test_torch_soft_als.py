"""Port parity of the low-rank family: soft_svd / soft_impute, PureSVD,
LinearFlow (with cross_validate_lambda and SparsePlusLowRank input),
ScaleNormalize, kmeans and the convert round trips.

The same numpy-made inputs and seeds go through ``rsparse_tpu`` and
``rsparse_tpu_torch`` at float64 on the CPU, where the port runs the plain
versions of K5 / K6.  Stated tolerances (relative, max |a - b| / max |b|):
the trace's ``frob_delta``, ``d`` and ``u diag(d) v'`` to 1e-8 (never raw
u / v: ``eigh``, ``qr`` and ``svd`` may flip a column's sign in u and v
together); the trace's ``loss`` to 1e-6, because both packages sum the
squared residuals in float32 (rsparse_tpu/ops/spmm.py:110) and XLA and
torch sum in different orders; scores ``transform(x) @ components`` to
1e-8; predict indices equal.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.models import soft_als as ref_sa
from rsparse_tpu_torch.convert import (linear_flow_from_numpy,
                                       pure_svd_from_numpy, svd_from_numpy)
from rsparse_tpu_torch.models import soft_als as port_sa

torch.set_num_threads(2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _recon(fit) -> np.ndarray:
    u, d, v = (np.asarray(t, np.float64) for t in (fit.u, fit.d, fit.v))
    return (u * d) @ v.T


def _matrix(seed=3, n_rows=120, n_cols=80, density=0.1):
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_cols, density, random_state=seed, format="csr")
    m.data = 1.0 + rng.exponential(2.0, m.nnz)
    return m


def _assert_fits_match(fj, ft, n_trace):
    assert len(ft.trace) == len(fj.trace) == n_trace
    for a, b in zip(fj.trace, ft.trace):
        assert b["iter"] == a["iter"]
        assert b["frob_delta"] == pytest.approx(a["frob_delta"], rel=1e-8)
        if np.isnan(a["loss"]):
            assert np.isnan(b["loss"])
        else:
            assert b["loss"] == pytest.approx(a["loss"], rel=1e-6)
    assert ft.d.shape == fj.d.shape
    assert _rel(ft.d, fj.d) <= 1e-8
    assert _rel(_recon(ft), _recon(fj)) <= 1e-8


@pytest.mark.parametrize("fn,lam", [("soft_svd", 0.0), ("soft_svd", 0.5),
                                    ("soft_impute", 0.0),
                                    ("soft_impute", 0.5)])
def test_soft_als_whole_fit_matches_reference(fn, lam):
    m = _matrix()
    kw = dict(rank=6, lambda_=lam, n_iter=8, convergence_tol=-1,
              precision="double", seed=3)
    fj = getattr(rt_ref, fn)(m, **kw)
    ft = getattr(rt, fn)(m, device="cpu", **kw)
    assert ft.u.dtype == torch.float64 and ft.u.device.type == "cpu"
    _assert_fits_match(fj, ft, 8)
    assert {"iter", "frob_delta", "loss", "wall_s"} <= set(ft.trace[0])


def test_soft_impute_converges_like_reference():
    """convergence_tol stops both at the same iteration."""
    m = _matrix(4)
    kw = dict(rank=4, lambda_=0.2, n_iter=60, convergence_tol=1e-4,
              precision="double", seed=1)
    fj = rt_ref.soft_impute(m, **kw)
    ft = rt.soft_impute(m, device="cpu", **kw)
    assert len(fj.trace) < 60
    _assert_fits_match(fj, ft, len(fj.trace))


def test_warm_start_pads_like_reference():
    """A rank-6 fit warm-starts a rank-10 one: pad_svd draws the padding
    from the same numpy rng in both packages."""
    m = _matrix(5)
    first = rt_ref.soft_svd(m, rank=6, n_iter=3, convergence_tol=-1,
                            precision="double", seed=4)
    init = tuple(np.asarray(a) for a in first.svd)
    kw = dict(rank=10, n_iter=5, convergence_tol=-1, precision="double",
              seed=4)
    for fn in ("soft_svd", "soft_impute"):
        fj = getattr(rt_ref, fn)(m, init=init, **kw)
        ft = getattr(rt, fn)(m, init=svd_from_numpy(*init, "double", "cpu"),
                             device="cpu", **kw)
        _assert_fits_match(fj, ft, 5)


def test_pad_svd_matches_reference():
    rng = np.random.default_rng(3)
    u, s, vt = np.linalg.svd(rng.standard_normal((30, 20)),
                             full_matrices=False)
    pj = ref_sa.pad_svd(ref_sa.SVDResult(jnp.asarray(u[:, :4]),
                                         jnp.asarray(s[:4]),
                                         jnp.asarray(vt[:4].T)), 8,
                        np.random.default_rng(9))
    pt = port_sa.pad_svd(port_sa.SVDResult(torch.as_tensor(u[:, :4]),
                                           torch.as_tensor(s[:4]),
                                           torch.as_tensor(vt[:4].T)), 8,
                         np.random.default_rng(9))
    assert pt.u.shape == (30, 8) and pt.v.shape == (20, 8)
    np.testing.assert_allclose(pt.d.numpy(), np.asarray(pj.d), rtol=1e-15)
    for a, b in ((pt.u, pj.u), (pt.v, pj.v)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a.T @ a, np.eye(8), atol=1e-12)
        np.testing.assert_allclose(a @ a.T, b @ b.T, atol=1e-12)  # span
    with pytest.raises(ValueError, match="bigger rank"):
        port_sa.pad_svd(pt, 4, np.random.default_rng(0))
    assert port_sa.pad_svd(pt, 8, np.random.default_rng(0)) is pt


def test_lambda_soft_threshold_and_trim():
    """final_svd soft-thresholds d by lambda and trims the zeros; a lambda
    above every singular value raises."""
    m = _matrix(6)
    plain = rt.soft_svd(m, rank=6, n_iter=40, precision="double", seed=1,
                        device="cpu")
    lam = float(plain.d[2]) + 0.5 * float(plain.d[2] - plain.d[3])
    kw = dict(rank=6, lambda_=lam, n_iter=40, precision="double", seed=1)
    fj = rt_ref.soft_svd(m, **kw)
    ft = rt.soft_svd(m, device="cpu", **kw)
    assert ft.d.shape[0] < 6 and ft.u.shape[1] == ft.v.shape[1] == \
        ft.d.shape[0]
    assert bool((ft.d > 0).all())
    _assert_fits_match(fj, ft, len(fj.trace))
    with pytest.raises(ValueError, match="all singular values are zero"):
        rt.soft_svd(m, rank=4, lambda_=1e6, n_iter=2, precision="double",
                    seed=1, device="cpu")
    with pytest.raises(ValueError, match="target"):
        port_sa.soft_als(m, target="nope", device="cpu")


def _scores(emb, comps):
    return np.asarray(emb, np.float64) @ np.asarray(comps, np.float64)


@pytest.mark.parametrize("method", ["svd", "impute"])
def test_pure_svd_matches_reference(ml100k, method):
    train = sp.csr_matrix(ml100k)[:250]
    train.col_names = ml100k.col_names
    held = sp.csr_matrix(ml100k)[250:330]
    kw = dict(rank=8, lambda_=0.5, method=method, precision="double", seed=0)
    mj = rt_ref.PureSVD(**kw)
    ej = mj.fit_transform(train, n_iter=10, convergence_tol=-1)
    mt = rt.PureSVD(device="cpu", **kw)
    et = mt.fit_transform(train, n_iter=10, convergence_tol=-1)
    assert _rel(_scores(et, mt.components), _scores(ej, mj.components)) \
        <= 1e-8
    assert _rel(_scores(mt.transform(held), mt.components),
                _scores(mj.transform(held), mj.components)) <= 1e-8
    np.testing.assert_allclose(mt.transform(train).numpy(), et.numpy(),
                               rtol=0, atol=1e-12)
    pj, pt = mj.predict(held, k=10), mt.predict(held, k=10)
    np.testing.assert_array_equal(pt.indices, pj.indices)
    st = mt.get_similar_items(mt.item_ids[0], k=5)
    assert st.indices.shape == (1, 5) and 0 not in st.indices

    # carried across by its arrays
    mc = pure_svd_from_numpy(*(np.asarray(a) for a in mj._svd[:3]),
                             item_ids=mj.item_ids, precision="double",
                             device="cpu")
    assert mc.rank == 8
    np.testing.assert_allclose(mc.components, mj.components, rtol=0,
                               atol=1e-14)
    np.testing.assert_array_equal(mc.predict(held, k=10).indices, pj.indices)
    np.testing.assert_allclose(mc.transform(held).numpy(),
                               np.asarray(mj.transform(held)), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("solver", ["soft_impute", "svd"])
def test_linear_flow_matches_reference(ml100k, solver):
    train = sp.csr_matrix(ml100k)[:250]
    held = sp.csr_matrix(ml100k)[250:330]
    kw = dict(rank=8, lambda_=3.0, solve_right_singular_vectors=solver,
              precision="double", seed=0)
    mj = rt_ref.LinearFlow(**kw)
    ej = mj.fit_transform(train, n_iter=6)
    mt = rt.LinearFlow(device="cpu", **kw)
    et = mt.fit_transform(train, n_iter=6)
    assert len(mt.svd_trace) == 6
    assert set(mt.fit_trace.summary()) == {"staging", "soft_impute",
                                           "lhs_rhs", "solve"}
    assert _rel(_scores(et, mt.components), _scores(ej, mj.components)) \
        <= 1e-8
    assert _rel(_scores(mt.transform(held), mt.components),
                _scores(mj.transform(held), mj.components)) <= 1e-8
    np.testing.assert_array_equal(mt.predict(held, k=10).indices,
                                  mj.predict(held, k=10).indices)

    # carried across by its arrays
    mc = linear_flow_from_numpy(np.asarray(mj.v), mj.components,
                                precision="double", device="cpu")
    np.testing.assert_allclose(mc.transform(held).numpy(),
                               np.asarray(mj.transform(held)), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(mc.predict(held, k=10).indices,
                                  mj.predict(held, k=10).indices)
    with pytest.raises(ValueError, match="components"):
        linear_flow_from_numpy(np.asarray(mj.v), mj.components.T)


def test_linear_flow_init_v_and_unfitted():
    m = _matrix(7)
    v = np.linalg.qr(np.random.default_rng(0).standard_normal((80, 5)))[0]
    mj = rt_ref.LinearFlow(rank=5, lambda_=1.0, init=v, precision="double")
    mt = rt.LinearFlow(rank=5, lambda_=1.0, init=v, precision="double",
                       device="cpu")
    ej, et = mj.fit_transform(m), mt.fit_transform(m)
    assert mt.svd_trace == ()
    assert _rel(_scores(et, mt.components), _scores(ej, mj.components)) \
        <= 1e-10
    with pytest.raises(RuntimeError, match="not fitted"):
        rt.LinearFlow(device="cpu").transform(m)
    with pytest.raises(ValueError, match="wrong shape"):
        rt.LinearFlow(rank=4, init=v, precision="double",
                      device="cpu").fit_transform(m)


def test_cross_validate_lambda_matches_reference(ml100k):
    train = sp.csr_matrix(ml100k)[:250]
    cv = sp.csr_matrix(ml100k)[250:400]
    cv_train, cv_test = rt.train_test_split(cv, 0.5,
                                            np.random.default_rng(5))
    kw = dict(rank=8, precision="double", seed=0)
    for spec in ("auto@5", [0.5, 50.0, 5000.0]):
        mj, mt = rt_ref.LinearFlow(**kw), rt.LinearFlow(device="cpu", **kw)
        rj = mj.cross_validate_lambda(train, cv_train, cv_test,
                                      lambda_=spec, metric="ndcg@10",
                                      n_iter=6)
        rt_ = mt.cross_validate_lambda(train, cv_train, cv_test,
                                       lambda_=spec, metric="ndcg@10",
                                       n_iter=6)
        assert len(rt_) == len(rj)
        for a, b in zip(rj, rt_):
            assert b["lambda"] == pytest.approx(a["lambda"], rel=1e-10)
            assert b["score"] == pytest.approx(a["score"], rel=1e-12)
        assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-10)
        assert _rel(mt.components, mj.components) <= 1e-8
        np.testing.assert_array_equal(mt.predict(cv_train, k=10).indices,
                                      mj.predict(cv_train, k=10).indices)
    with pytest.raises(ValueError, match="metric"):
        mt.cross_validate_lambda(train, cv_train, cv_test, metric="auc")
    with pytest.raises(ValueError, match="lambda spec"):
        mt.cross_validate_lambda(train, cv_train, cv_test, lambda_="grid")


def test_cross_validate_all_nan_scores_keep_first_solve():
    """The NaN rule (rsparse_tpu tests/test_soft_als.py:173): with an empty
    test matrix every lambda scores NaN; the model still keeps the first
    lambda's components."""
    x = sp.random(60, 40, density=0.2, random_state=1, format="csr")
    x.data[:] = 1.0
    empty_test = sp.csr_matrix((30, 40))
    model = rt.LinearFlow(rank=4, precision="double", seed=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # nanmean of empty slices
        res = model.cross_validate_lambda(x, sp.csr_matrix(x[:30]),
                                          empty_test,
                                          lambda_=[0.1, 1.0, 10.0],
                                          metric="map@10")
    assert all(np.isnan(r["score"]) for r in res)
    assert model.components is not None and model.lambda_ == 0.1


def test_sparse_plus_low_rank_input_matches_reference():
    m = _matrix(8, 70, 50)
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((70, 2)) * 0.1, rng.standard_normal((50, 2))
    xj = rt_ref.SparsePlusLowRank(m, a, b)
    xt = rt.SparsePlusLowRank(m, a, b)
    np.testing.assert_array_equal(xt.toarray(), xj.toarray())
    kw = dict(rank=6, lambda_=2.0, precision="double", seed=0)
    mj, mt = rt_ref.LinearFlow(**kw), rt.LinearFlow(device="cpu", **kw)
    ej, et = mj.fit_transform(xj, n_iter=10), mt.fit_transform(xt, n_iter=10)
    assert _rel(_scores(et, mt.components), _scores(ej, mj.components)) \
        <= 1e-8
    assert _rel(mt.transform(xt), mj.transform(xj)) <= 1e-10
    # predict masks the sparse part of a sparse-plus-low-rank input
    pj, pt = mj.predict(xj, k=5), mt.predict(xt, k=5)
    np.testing.assert_array_equal(pt.indices, pj.indices)
    assert not np.asarray(m[np.repeat(np.arange(70), 5),
                            pt.indices.ravel()]).any()
    with pytest.raises(ValueError, match="preprocess"):
        rt.LinearFlow(preprocess=lambda z: z, device="cpu").fit_transform(xt)


def test_scale_normalize_exact(ml100k):
    m = sp.csr_matrix(ml100k)[:100]
    for kw in (dict(scale=0.5, norm=2, target="columns"),
               dict(scale=0.4, norm=1, target="rows")):
        oj = rt_ref.ScaleNormalize(**kw).fit_transform(m)
        ot = rt.ScaleNormalize(**kw).fit_transform(m)
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(ot, attr),
                                          getattr(oj, attr))
    with pytest.raises(RuntimeError, match="not fitted"):
        rt.ScaleNormalize().transform(m)


@pytest.mark.parametrize("mode", ["static_subset", "random_subset",
                                  "static_spread", "random_spread"])
def test_kmeans_matches_reference(mode):
    rng = np.random.default_rng(11)
    centres = np.array([[0, 0, 0], [6, 0, 0], [0, 6, 0], [0, 0, 6]])
    pts = np.concatenate([rng.standard_normal((40, 3)) + c for c in centres])
    cj, aj = rt_ref.kmeans(pts, 4, n_iter=8, seed_mode=mode, seed=1)
    ct, at = rt.kmeans(pts, 4, n_iter=8, seed_mode=mode, seed=1,
                       device="cpu")
    np.testing.assert_array_equal(at, np.asarray(aj))
    np.testing.assert_allclose(ct, np.asarray(cj), rtol=0, atol=1e-5)
    assert ct.dtype == np.float32


def test_kmeans_errors():
    with pytest.raises(ValueError, match="k=5"):
        rt.kmeans(np.zeros((3, 2)), 5, device="cpu")
    with pytest.raises(ValueError, match="seed_mode"):
        rt.kmeans(np.zeros((3, 2)), 2, seed_mode="nope", device="cpu")


#: the reference's ML-100k quality (rsparse_tpu, float32, CPU: 80/20 split
#: with seed 0, predict(train, k=10, not_recommend=train)); chip_smoke.py
#: phase 6 (a) holds the port on the card to these within 0.01
ML100K_PURESVD = (0.3258, 0.3848)         # rank 10, seed 0, 100 iterations
ML100K_LINEAR_FLOW = (0.3338, 0.3924)     # rank 10, lambda 1, 30 iterations


def test_ml100k_quality_pinned_float32():
    """The port on the CPU at float32 reproduces the pinned reference
    values to their 4 printed digits (5e-5 rounding, 1e-4 allowed)."""
    x = rt.load_movielens100k()
    train, test = rt.train_test_split(x, 0.2, np.random.default_rng(0))
    ps = rt.PureSVD(rank=10, seed=0, device="cpu")
    ps.fit_transform(train, n_iter=100)
    lf = rt.LinearFlow(rank=10, lambda_=1.0, seed=0, device="cpu")
    lf.fit_transform(train, n_iter=30)
    for m, ref in ((ps, ML100K_PURESVD), (lf, ML100K_LINEAR_FLOW)):
        idx = m.predict(train, k=10, not_recommend=train).indices
        assert float(np.nanmean(rt.ndcg_k(idx, test))) == pytest.approx(
            ref[0], abs=1e-4)
        assert float(np.nanmean(rt.ap_k(idx, test))) == pytest.approx(
            ref[1], abs=1e-4)


def test_staging_cache_keys_by_content_dtype_and_device():
    from rsparse_tpu_torch.sparse import device as dev
    dev.clear_staging_cache()
    m = _matrix(9)
    a = port_sa.staged_buckets(m, torch.float64, "cpu")
    assert port_sa.staged_buckets(m.copy(), torch.float64, "cpu") is a
    assert port_sa.staged_buckets(m, torch.float32, "cpu") is not a
    assert port_sa.staged_buckets(m, torch.float64, "cpu",
                                  transpose=True).n_rows == m.shape[1]
    m2 = m.copy()
    m2.data[0] += 1.0
    assert port_sa.staged_buckets(m2, torch.float64, "cpu") is not a
    assert dev.clear_staging_cache() == 4
    for i in range(dev._STAGING_CACHE_MAX + 3):
        dev.staged_aux_cached("t", i, lambda: i)
    assert len(dev._STAGING_CACHE) == dev._STAGING_CACHE_MAX
    dev.clear_staging_cache()
