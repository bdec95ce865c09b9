"""Port parity of whole fits across WRMF's configuration surface.

Every configuration of the reference's grid (tests/test_wrmf.py GRID:
solver x feedback x lambda x biases) fits for 2 iterations through
``rsparse_tpu.WRMF`` and ``rsparse_tpu_torch.WRMF`` on the same numpy-made
ratings, at float64 on the CPU (the grid's float32 rows run at float64
here: the point is the algorithm, not the rounding).  Stated tolerances:
loss history to 1e-9 relative; components and user factors to 1e-9 of
their largest magnitude; ``transform`` likewise; identical ``predict``
indices.

NNLS: the port stops each system's coordinate descent on its own (as the
reference C++ does, inst/include/nnls.hpp), the JAX package stops a
bucket's systems together.  These tests hold the NNLS fits against the JAX
package with its ``batched_nnls`` run one system at a time (``jax.vmap``
over single systems, whose batched ``while_loop`` freezes each system when
its own loop ends), which is the port's rule; the tolerance is then 1e-6
relative, as the two take the same sweeps but sum in different orders.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
from rsparse_tpu.ops import als as ref_als
from rsparse_tpu.ops import solvers as ref_solvers
import rsparse_tpu_torch as rt

torch.set_num_threads(2)

GRID = [
    # (solver, feedback, lambda, bias) of rsparse_tpu tests/test_wrmf.py
    ("cholesky", "implicit", 0.0, False),
    ("cholesky", "implicit", 0.1, True),
    ("cholesky", "implicit", 1000.0, False),
    ("nnls", "implicit", 0.1, False),
    ("nnls", "implicit", 0.1, True),
    ("conjugate_gradient", "implicit", 0.0, False),
    ("conjugate_gradient", "implicit", 0.1, False),
    ("conjugate_gradient", "implicit", 0.1, True),
    ("conjugate_gradient", "implicit", 1000.0, False),
    ("cholesky", "explicit", 0.1, False),
    ("cholesky", "explicit", 0.1, True),
    ("cholesky", "explicit", 1000.0, True),
    ("conjugate_gradient", "explicit", 0.1, False),
    ("conjugate_gradient", "explicit", 0.1, True),
    ("nnls", "explicit", 0.1, False),
]


def _ratings(seed=0, n_users=160, n_items=90, mean_nnz=12):
    """Integer ratings 1..5 with zipf item popularity, an empty user and
    row/column names."""
    rng = np.random.default_rng(seed)
    row_nnz = rng.integers(1, 2 * mean_nnz, n_users)
    row_nnz[4] = 0
    pop = 1.0 / (np.arange(n_items) + 4.0)
    cols = rng.choice(n_items, size=int(row_nnz.sum()), p=pop / pop.sum())
    rows = np.repeat(np.arange(n_users), row_nnz)
    m = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(n_users, n_items))
    m.sum_duplicates()
    m.data = rng.integers(1, 6, m.nnz).astype(np.float64)
    m.row_names = [f"u{i}" for i in range(n_users)]
    m.col_names = [f"i{j}" for j in range(n_items)]
    return m


@pytest.fixture
def per_system_reference_nnls(monkeypatch):
    """The JAX package's NNLS with a per-system stop: its own
    ``batched_nnls`` vmapped over single systems."""
    single = ref_solvers.batched_nnls

    def per_system(lhs, rhs, init, max_iter=ref_solvers.SCD_MAX_ITER):
        return jax.vmap(lambda l, r, i: single(
            l[None], r[None], i[None], max_iter=max_iter)[0])(lhs, rhs, init)

    jax.clear_caches()
    monkeypatch.setattr(ref_als, "batched_nnls", per_system)
    yield
    jax.clear_caches()


def _fit_pair(x, n_iter=2, **kw):
    mj = rt_ref.WRMF(**kw)
    ej = np.asarray(mj.fit_transform(x, n_iter=n_iter, convergence_tol=-1))
    mt = rt.WRMF(**kw, device="cpu")
    et = mt.fit_transform(x, n_iter=n_iter, convergence_tol=-1).numpy()
    return mj, ej, mt, et


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("solver,feedback,lam,bias", GRID)
def test_fit_transform_grid_matches_reference(per_system_reference_nnls,
                                              solver, feedback, lam, bias):
    x = _ratings()
    cv = x[::4]
    cv.row_names, cv.col_names = x.row_names[::4], x.col_names
    kw = dict(rank=6, lambda_=lam, feedback=feedback, solver=solver,
              with_user_item_bias=bias, precision="double", seed=0)
    mj, ej, mt, et = _fit_pair(x, **kw)
    tol = 1e-6 if solver == "nnls" else 1e-9
    R = 6 + (2 if bias else 0)
    assert et.shape == (x.shape[0], R)
    assert mt.components.shape == (R, x.shape[1])
    assert mt.item_ids == x.col_names
    np.testing.assert_allclose(mt.loss_history, mj.loss_history, rtol=tol)
    _close(mt.components, mj.components, tol)
    _close(et, ej, tol)
    assert mt.global_bias == mj.global_bias
    # fit_transform == transform (reference test-wrmf.R:56-57)
    np.testing.assert_allclose(mt.transform(x).numpy(), et, rtol=0,
                               atol=1e-12)
    cj, ct = np.asarray(mj.transform(cv)), mt.transform(cv).numpy()
    _close(ct, cj, tol)
    pt, pj = mt.predict(cv, k=5), mj.predict(cv, k=5)
    assert pt.user_ids == cv.row_names
    if solver != "nnls":
        np.testing.assert_array_equal(pt.indices, pj.indices)
        np.testing.assert_array_equal(pt.ids, pj.ids)
    else:
        assert ct.min() >= 0 and mt.components.min() >= 0
    if bias:
        # users [1, emb..., u_bias], items [i_bias, emb..., 1]
        np.testing.assert_array_equal(et[:, 0], 1.0)
        np.testing.assert_array_equal(mt.components[-1], 1.0)


@pytest.mark.parametrize("feedback", ["implicit", "explicit"])
def test_global_bias_matches_reference(feedback):
    """Implicit: the global-bias offset; explicit: the centred matrix, and
    ``transform`` re-centres its input."""
    x = _ratings(1)
    kw = dict(rank=4, lambda_=0.1, feedback=feedback, solver="cholesky",
              with_global_bias=True, precision="double", seed=0)
    mj, ej, mt, et = _fit_pair(x, **kw)
    assert mt.global_bias == mj.global_bias != 0.0
    np.testing.assert_allclose(mt.loss_history, mj.loss_history, rtol=1e-9)
    _close(et, ej, 1e-9)
    np.testing.assert_allclose(mt.transform(x).numpy(), et, rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(mt.predict(x[:30], k=5).indices,
                                  mj.predict(x[:30], k=5).indices)


def test_biases_with_global_bias_and_dynamic_lambda():
    """Explicit, biases, global bias and dynamic lambda together (the
    rating model of the reference's quality gate) over 4 iterations."""
    x = _ratings(2)
    kw = dict(rank=5, lambda_=0.3, feedback="explicit", solver="cholesky",
              with_user_item_bias=True, with_global_bias=True,
              dynamic_lambda=True, precision="double", seed=3)
    mj, ej, mt, et = _fit_pair(x, n_iter=4, **kw)
    assert mt.global_bias == mj.global_bias != 0.0
    np.testing.assert_allclose(mt.loss_history, mj.loss_history, rtol=1e-9)
    _close(mt.components, mj.components, 1e-9)
    _close(et, ej, 1e-9)


def test_nnls_drops_global_bias_and_rejects_negative_values():
    m = rt.WRMF(solver="nnls", with_global_bias=True, device="cpu")
    assert m.with_global_bias is False and m.non_negative
    x = _ratings(3)
    x.data = x.data - 3.0
    with pytest.raises(ValueError, match="nnls"):
        rt.WRMF(solver="nnls", feedback="explicit", device="cpu"
                ).fit_transform(x)


def test_explicit_accepts_negative_ratings_implicit_does_not():
    x = _ratings(4)
    x.data = x.data - 3.0
    emb = rt.WRMF(rank=3, lambda_=0.1, feedback="explicit",
                  solver="cholesky", device="cpu", precision="double",
                  seed=0).fit_transform(x, n_iter=1)
    assert torch.isfinite(emb).all()
    with pytest.raises(ValueError, match="implicit"):
        rt.WRMF(rank=3, device="cpu").fit_transform(x, n_iter=1)
