"""Port parity of the Factorization Machine (K8's plain version).

The same numpy-made CSRs, labels, weights and seed go through
``rsparse_tpu`` and ``rsparse_tpu_torch`` at float64 on the CPU, where the
port's wrapper runs K8's plain PyTorch version.  Stated tolerances: block
updates, whole fits and carried-over models to 1e-10 absolute; the
per-sample replica of the batched ordering to 1e-12.

One case departs from the reference on purpose: a block made only of empty
rows takes the intercept step in the port, where the reference returns
early (rsparse_tpu/models/fm.py:67-70; ROADMAP.md queue 3).  That case is
held to the per-sample replica, not to the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.models import fm as ref_fm
from rsparse_tpu_torch.convert import fm_from_numpy
from rsparse_tpu_torch.models import fm as port_fm

from test_torch_ftrl import glm_problem, port_blocks, ref_blocks

torch.set_num_threads(2)

TOL = 1e-10
STATE = ("w0", "acc_w0", "w", "v", "acc_w", "acc_v")


def _state(m):
    return [np.asarray(getattr(m, k)) for k in STATE]


def _assert_state(mt, mj, tol=TOL):
    for k, a, b in zip(STATE, _state(mt), _state(mj)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("lams", [(0.0, 0.0), (0.02, 0.01)])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("family", ["binomial", "gaussian"])
def test_fm_block_matches_reference(family, intercept, lams):
    """Every block of a pass, in order, from the same state, in predict and
    update mode: the six tables and the predictions."""
    x, y, w = glm_problem(seed=11, n_feat=50)
    if family == "binomial":
        y = np.where(y == 1, 1.0, -1.0)
    fam = 1 if family == "binomial" else 2
    lam_w, lam_v = lams
    lr_w, lr_v, r = 0.15, 0.1, 3
    br, layouts, rlab = ref_blocks(x, y, w, zero_pad_weight=True)
    blocks, plab = port_blocks(x, y, w, zero_pad_weight=True)
    rng = np.random.default_rng(12)
    F1 = x.shape[1] + 1
    init = [np.asarray(0.1), np.asarray(1.3), rng.standard_normal(F1) * 0.1,
            rng.standard_normal((F1, r)) * 0.1, rng.uniform(1, 2, F1),
            rng.uniform(1, 2, (F1, r))]
    sj = [jnp.asarray(a) for a in init]
    st = [torch.tensor(a) for a in init]
    for k, (rb, lay, (ry, rw), pb, (py, pw)) in enumerate(
            zip(br.buckets, layouts, rlab, blocks, plab)):
        for do_update in (False, True):
            *sj, yj = ref_fm._fm_block(
                *sj, rb.col_idx, rb.values, ry, rw, lr_w, lr_v, lam_w, lam_v,
                lay, family=fam, intercept=intercept, do_update=do_update,
                rowmajor_pred=bool(k % 2))
            yt = port_fm._fm_block(*st, pb, py, pw, lr_w, lr_v, lam_w, lam_v,
                                   fam, intercept, do_update)
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                       atol=TOL)
            for name, a, b in zip(STATE, st, sj):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def fitted_pair():
    x, y, w = glm_problem(seed=13, n_rows=300, n_feat=80)
    kw = dict(learning_rate_w=0.15, learning_rate_v=0.1, rank=4,
              lambda_w=0.01, lambda_v=0.02, precision="double", seed=3)
    mj = rt_ref.FactorizationMachine(**kw)
    pj = mj.fit(x, y, w, n_iter=3)
    mt = rt.FactorizationMachine(**kw, device="cpu")
    pt = mt.fit(x, y, w, n_iter=3)
    return x, y, w, kw, mj, pj, mt, pt


def test_fm_fit_matches_reference(fitted_pair):
    """Same seed, same numpy draw of v: the whole 3-pass state."""
    x, _, _, _, mj, pj, mt, pt = fitted_pair
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL)
    _assert_state(mt, mj)
    np.testing.assert_allclose(mt.predict(x[::3]), mj.predict(x[::3]),
                               rtol=0, atol=TOL)


def test_fm_gaussian_fit_matches_reference():
    x, y, _ = glm_problem(seed=14, n_rows=200, n_feat=40)
    y = x @ np.linspace(-1, 1, x.shape[1]) + 0.1
    kw = dict(learning_rate_w=0.05, rank=2, family="gaussian",
              intercept=True, precision="double", seed=0)
    mj = rt_ref.FactorizationMachine(**kw)
    mt = rt.FactorizationMachine(**kw, device="cpu")
    np.testing.assert_allclose(mt.fit(x, y, n_iter=3), mj.fit(x, y, n_iter=3),
                               rtol=0, atol=TOL)
    _assert_state(mt, mj)


def test_fm_from_numpy_carries_the_reference(fitted_pair):
    x, y, w, kw, mj, _, _, _ = fitted_pair
    mc = fm_from_numpy(*_state(mj), **kw, device="cpu")
    np.testing.assert_allclose(mc.predict(x), mj.predict(x), rtol=0,
                               atol=TOL)
    x2, y2, w2 = glm_problem(seed=15, n_rows=100, n_feat=80)
    np.testing.assert_allclose(mc.partial_fit(x2, y2, w2),
                               mj.partial_fit(x2, y2, w2), rtol=0, atol=TOL)
    _assert_state(mc, mj)


def _fm_replica_batched(X, y01, wts, v0, lr_w, lr_v, lam_w, lam_v,
                        intercept=True):
    """The batched ordering of the FM per-sample loop
    (tests/test_sgd_replica.py ``_fm_replica(ordering="batched")``):
    accumulator-first AdaGrad, snapshot s1, an accumulated w0.  A sample
    without features still steps w0."""
    F, r = v0.shape
    y = np.where(y01 == 1, 1.0, -1.0)
    w0, acc_w0 = 0.0, 1.0
    w = np.zeros(F)
    v = v0.copy()
    acc_w = np.ones(F)
    acc_v = np.ones((F, r))
    for i in range(X.shape[0]):
        p1, p2 = X.indptr[i], X.indptr[i + 1]
        idx, xv = X.indices[p1:p2], X.data[p1:p2]
        vx = v[idx] * xv[:, None]
        s1 = vx.sum(axis=0)
        raw = (w0 + np.sum(w[idx] * xv)
               + 0.5 * np.sum(s1 * s1 - np.sum(vx * vx, axis=0)))
        dL = (1.0 / (1.0 + np.exp(-raw * y[i])) - 1.0) * y[i] * wts[i]
        if intercept:
            acc_w0 += dL * dL
            w0 -= lr_w * dL / np.sqrt(acc_w0)
        g_w = np.clip(xv * dL + 2 * lam_w, -100, 100)
        aw = acc_w[idx] + g_w * g_w
        w[idx] -= lr_w * g_w / np.sqrt(aw)
        acc_w[idx] = aw
        g_v = np.clip(dL * xv[:, None] * (s1[None, :] - vx)
                      + 2 * lam_v * v[idx], -100, 100)
        av = acc_v[idx] + g_v * g_v
        v[idx] -= lr_v * g_v / np.sqrt(av)
        acc_v[idx] = av
    return w0, w, v


def test_fm_per_sample_replica_with_empty_rows():
    """One row per partial_fit, some rows empty (each such call is a block
    of only empty rows): the port follows the batched replica, the intercept
    of the empty rows included."""
    x, y, w = glm_problem(seed=16, n_rows=30, n_feat=20, max_nnz=5,
                          empty=(2, 9, 10, 21))
    lr_w, lr_v, lam_w, lam_v = 0.15, 0.1, 0.02, 0.01
    m = rt.FactorizationMachine(learning_rate_w=lr_w, learning_rate_v=lr_v,
                                rank=3, lambda_w=lam_w, lambda_v=lam_v,
                                precision="double", seed=5, device="cpu")
    m._ensure_state(x.shape[1])
    v0 = m.v.numpy()[:x.shape[1]].copy()
    for i in range(x.shape[0]):
        m.partial_fit(x[i], [y[i]], [w[i]])
    w0, ww, v = _fm_replica_batched(x, y, w, v0, lr_w, lr_v, lam_w, lam_v)
    np.testing.assert_allclose(float(m.w0), w0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.w.numpy()[:x.shape[1]], ww, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(m.v.numpy()[:x.shape[1]], v, rtol=0,
                               atol=1e-12)


def test_fm_learns_xor():
    """The nonlinearity canary (tests/test_fm_rankmf.py, reference
    test-fm.R:2-17) on the port."""
    x = sp.csr_matrix(np.array([[0, 0], [0, 1], [1, 0], [1, 1]], float))
    y = np.array([0.0, 1.0, 1.0, 0.0])
    fm = rt.FactorizationMachine(learning_rate_w=0.2, rank=2, seed=42,
                                 device="cpu")
    fm.fit(sp.vstack([x] * 200).tocsr(), np.tile(y, 200), n_iter=80)
    p = fm.predict(x)
    assert p[0] < 0.05 and p[3] < 0.05, p
    assert p[1] > 0.95 and p[2] > 0.95, p


def test_fm_intercept_ignores_padding_rows():
    """One real row padded to a 32-row block: the exact post-update w0 of a
    single-feature gaussian FM (tests/test_fm_rankmf.py)."""
    m = rt.FactorizationMachine(learning_rate_w=0.2, rank=1,
                                family="gaussian", seed=0, device="cpu")
    m.partial_fit(sp.csr_matrix(np.array([[1.0]])), np.array([1.0]))
    np.testing.assert_allclose(float(m.w0), 0.2 * 2.0 / np.sqrt(5.0),
                               rtol=1e-6)


def test_fm_errors_and_options():
    x = sp.random(10, 5, density=0.5, format="csr", random_state=0)
    fm = rt.FactorizationMachine(seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        fm.predict(x)
    with pytest.raises(ValueError):
        fm.partial_fit(x, np.zeros(7))
    fm.partial_fit(x, np.ones(10))
    with pytest.raises(ValueError):
        fm.partial_fit(sp.random(10, 6, density=0.5, format="csr"),
                       np.ones(10))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        rt.FactorizationMachine(mesh=object(), device="cpu")
    assert rt.FactorizationMachine().device.type == "cuda"


def test_reference_quality():
    """``chip_smoke.REF_GLM_ACC["fm"]``, the train accuracy that
    chip_smoke.py phase 7 (b) holds the port to on the card, is the
    reference's (float32) on the same problem and hyperparameters."""
    import chip_smoke
    x, truth = chip_smoke.synth_glm()
    m = rt_ref.FactorizationMachine(rank=8, learning_rate_w=0.2, seed=0)
    m.fit(x, truth, n_iter=3)
    acc = float(((np.asarray(m.predict(x)) > 0.5) == truth).mean())
    assert abs(acc - chip_smoke.REF_GLM_ACC["fm"]) < 5e-6, acc
