"""Port parity of WRMF's reduced-precision options.

``compute_dtype="bfloat16"`` (bf16 gathers and products, float32 sums),
``hot_dtype`` uint8 / bfloat16 / float32 and ``precision="bfloat16"``:
the same numpy-made inputs go through ``rsparse_tpu`` and
``rsparse_tpu_torch`` on the CPU, where the port runs the plain versions
of K1, K2, K4 and of K1's head term.

Stated tolerances: one bucket's bf16 solve to 1e-5 relative (max norm)
against the reference run op by op (``jax.disable_jit``), which rounds at
every point the port rounds; against the jitted reference to 2e-3,
because XLA's CPU fusions skip some bf16 roundings (measured ~5e-4, as PR
5 found for GloVe).  uint8 codes and scales exactly; the float64 uint8 fit
(no bf16 anywhere) to 1e-10; whole bf16 fits' loss histories to 1e-3
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.ops import als as ref
from rsparse_tpu.sparse import device as ref_dev
from rsparse_tpu_torch.convert import wrmf_from_numpy
from rsparse_tpu_torch.ops import als as port
from rsparse_tpu_torch.ops import gather as port_gather
from rsparse_tpu_torch.sparse import device as port_dev

torch.set_num_threads(2)

N_TGT, N_SRC, D, N_HOT = 64, 48, 8, 10
LAM, G = 0.5, 0.07


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _matrix(seed, explicit=False):
    rng = np.random.default_rng(seed)
    m = sp.random(N_TGT, N_SRC, density=0.25,
                  random_state=np.random.RandomState(seed), format="csr")
    m.data = (np.round(1.0 + 4.0 * m.data, 1) if explicit
              else 1.0 + rng.exponential(3.0, m.nnz))
    src = (rng.standard_normal((N_SRC, D)) * 0.3).astype(np.float32)
    return m, src


def _bucket_inputs(m, src, head, explicit):
    """The widest cold bucket of ``m`` with its head rows, on both sides."""
    w_dt = {"bf16": (jnp.bfloat16, torch.bfloat16),
            "uint8": (jnp.uint8, torch.uint8),
            "f32": (jnp.float32, torch.float32)}.get(head)
    hj = ht = None
    cold = m
    if head is not None:
        hj, cold = ref_dev.split_hot_cold(m, N_HOT, jnp.float32,
                                          w_dtype=w_dt[0],
                                          with_presence=explicit)
        ht, _ = port_dev.split_hot_cold(m, N_HOT, torch.float32, "cpu",
                                        with_presence=explicit,
                                        w_dtype=w_dt[1])
    bj = ref_dev.bucket_rows(cold, jnp.float32, include_empty=True,
                             row_align=8)
    bt = port_dev.bucket_rows(cold, torch.float32, "cpu", include_empty=True,
                              row_align=8)
    i = int(np.argmax([b.pad_len for b in bt.buckets]))
    rows_j = rows_t = (None,) * 4
    if head is not None:
        rows_j = ref_dev.hot_bucket_rows(hj, bj.buckets, N_TGT)[i]
        rows_t = port_dev.hot_bucket_rows(ht, bt.buckets)[i]
        np.testing.assert_array_equal(
            rows_t[0].float().numpy(), np.asarray(rows_j[0], np.float32))
    hot_ids = None if hj is None else np.asarray(hj.hot_ids)
    return bj.buckets[i], bt.buckets[i], rows_j, rows_t, hot_ids


def _as_t(a):
    return None if a is None else torch.from_numpy(np.array(a))


CASES = [(solver, head, ugb)
         for solver in ("conjugate_gradient", "cholesky", "nnls")
         for head, ugb in ((None, False), ("bf16", True), ("uint8", False),
                           ("uint8", True))]


@pytest.mark.parametrize("solver,head,ugb", CASES)
def test_bf16_implicit_bucket_matches_reference(solver, head, ugb):
    """compute_dtype="bfloat16": one bucket of implicit solves, with and
    without a bf16 or uint8 head and a global bias, against the reference
    run op by op (1e-5) and jitted (2e-3).  NNLS runs one sweep on both
    sides: the port stops each system on its own, the reference the batch
    (ROADMAP queue 3), so one sweep is where the two are the same map."""
    m, src = _matrix(3)
    bj, bt, rows_j, rows_t, hot_ids = _bucket_inputs(m, src, head, False)
    code = ref.solver_code(solver)
    cj = ref.ALSConfig(feedback="implicit", solver=code, use_global_bias=ugb,
                       compute_dtype="bfloat16", nnls_max_iter=1)
    ct = port.ALSConfig(solver=code, use_global_bias=ugb,
                        compute_dtype="bfloat16", nnls_max_iter=1)
    g = G if ugb else 0.0
    sj = jnp.asarray(src)
    src_act, _, XtX, rhs_init = ref._sweep_prepare(
        sj, jnp.asarray(LAM, jnp.float32), jnp.asarray(g, jnp.float32), cj,
        jnp.float32)
    rng = np.random.default_rng(4)
    x0 = (rng.random((bj.batch, D)) * 0.1).astype(np.float32)
    W, _, _, scale = rows_j
    Vh = None if hot_ids is None else sj[hot_ids]
    args_j = (src_act, None, XtX, rhs_init, bj, jnp.asarray(x0),
              jnp.asarray(LAM, jnp.float32), jnp.asarray(g, jnp.float32))

    def reference(*a):
        return ref._solve_bucket_implicit(*a, cj, jnp.float32, hot_W=W,
                                          V_hot=Vh, hot_scale=scale)

    with jax.disable_jit():
        yj, lj = reference(*args_j)
    yjj, ljj = jax.jit(reference)(*args_j)
    Wt, _, _, st = rows_t
    yt, lt = port._solve_bucket_implicit(
        torch.from_numpy(src), None, _as_t(XtX), _as_t(rhs_init), bt,
        torch.from_numpy(x0), LAM, g, ct, Wt,
        None if hot_ids is None else torch.from_numpy(src)[hot_ids],
        hot_scale=st)
    assert yt.dtype == torch.float32
    assert _rel(yt, yj) <= 1e-5 and _rel(lt, lj) <= 1e-5
    assert _rel(yt, yjj) <= 2e-3 and _rel(lt, ljj) <= 2e-3
    # the rounding points matter: float32 compute lands measurably apart
    y32, _ = port._solve_bucket_implicit(
        torch.from_numpy(src), None, _as_t(XtX), _as_t(rhs_init), bt,
        torch.from_numpy(x0), LAM, g, ct, Wt,
        None if hot_ids is None else torch.from_numpy(src)[hot_ids],
        hot_scale=st, rounding=False)
    assert _rel(y32, yj) > 1e-4


@pytest.mark.parametrize("solver,head", [
    (solver, head) for solver in ("conjugate_gradient", "cholesky", "nnls")
    for head in (None, "bf16")] + [("conjugate_gradient", "f32")])
def test_bf16_explicit_bucket_matches_reference(solver, head):
    """compute_dtype="bfloat16", explicit feedback with dynamic lambda:
    ratings, a bf16 or float32 head (whose raw values enter the loss), op
    by op 1e-5 and jitted 2e-3."""
    m, src = _matrix(5, explicit=True)
    bj, bt, rows_j, rows_t, hot_ids = _bucket_inputs(m, src, head, True)
    code = ref.solver_code(solver)
    cj = ref.ALSConfig(feedback="explicit", solver=code, dynamic_lambda=True,
                       compute_dtype="bfloat16", nnls_max_iter=1)
    ct = port.ALSConfig(solver=code, feedback="explicit", dynamic_lambda=True,
                        compute_dtype="bfloat16", nnls_max_iter=1)
    sj = jnp.asarray(src)
    rng = np.random.default_rng(6)
    x0 = (rng.random((bj.batch, D)) * 0.1).astype(np.float32)
    W, bits, nnz_tot, _ = rows_j
    Vh = None if hot_ids is None else sj[hot_ids]
    args_j = (sj, None, bj, jnp.asarray(x0), jnp.asarray(LAM, jnp.float32))

    def reference(*a):
        return ref._solve_bucket_explicit(*a, cj, jnp.float32, hot_W=W,
                                          V_hot=Vh, hot_bits=bits,
                                          nnz_total=nnz_tot)

    with jax.disable_jit():
        yj, lj = reference(*args_j)
    yjj, ljj = jax.jit(reference)(*args_j)
    Wt, bits_t, nnz_t, _ = rows_t
    yt, lt = port._solve_bucket_explicit(
        torch.from_numpy(src), None, bt, torch.from_numpy(x0), LAM, ct, Wt,
        None if hot_ids is None else torch.from_numpy(src)[hot_ids], bits_t,
        nnz_t)
    assert _rel(yt, yj) <= 1e-5 and _rel(lt, lj) <= 1e-5
    assert _rel(yt, yjj) <= 2e-3 and _rel(lt, ljj) <= 2e-3


@pytest.mark.parametrize("mode", ["matvec", "rhs"])
@pytest.mark.parametrize("w_kind", ["bf16", "uint8"])
def test_hot_chain_matches_probe_chain(mode, w_kind):
    """hot_chain (K1's head term; its plain version on the CPU) against the
    chain of the Pallas probe scripts/exp_bisect3.py (``ka`` -> ``kc``,
    ``kd``) written in jnp and run op by op: W (64, 512) about 10% present,
    Vh (512, 128) bf16, exactly the same float32 sums up to order."""
    rng = np.random.default_rng(0)
    B, H, d = 64, 512, 128
    w = (rng.random((B, H)) > 0.9) * (1 + rng.random((B, H)))
    Vh = (rng.standard_normal((H, d)) * 0.1).astype(np.float32)
    P = rng.standard_normal((B, d)).astype(np.float32)
    g = 0.3
    bf16 = jnp.bfloat16
    if w_kind == "uint8":
        s = np.where(w.max(1) > 0, w.max(1) / 255.0, 1.0).astype(np.float32)
        codes = np.where(w > 0, np.clip(np.rint(w / s[:, None]), 1, 255), 0
                         ).astype(np.uint8)
        Wj = jnp.asarray(codes).astype(bf16) * jnp.asarray(s)[:, None].astype(
            bf16)
        Wt, st = torch.from_numpy(codes), torch.from_numpy(s)
    else:
        Wj = jnp.asarray(w, bf16)
        Wt, st = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16), None
    with jax.disable_jit():
        Vb = jnp.asarray(Vh, bf16)
        W1 = jnp.where(Wj > 0, Wj - jnp.asarray(1.0, bf16),
                       jnp.asarray(0.0, bf16))
        if mode == "matvec":
            th = jnp.dot(jnp.asarray(P).astype(bf16), Vb.T,
                         preferred_element_type=jnp.float32)
            want = jnp.dot(th.astype(bf16) * W1, Vb,
                           preferred_element_type=jnp.float32)
        else:
            ce = (Wj - W1 * jnp.asarray(g).astype(bf16)).astype(bf16)
            want = jnp.dot(ce, Vb, preferred_element_type=jnp.float32)
    kw = dict(p=torch.from_numpy(P)) if mode == "matvec" else dict(g=g)
    got = port.hot_chain(Wt, torch.from_numpy(Vh), scale=st, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, d)
    assert _rel(got, want) <= 1e-6


def test_split_hot_cold_uint8_codes_and_scales_exact():
    """uint8 codes, per-row scales (float32 and float64) and the scale rows
    in bucket order equal the reference's exactly."""
    m, _ = _matrix(8)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        hj, cj = ref_dev.split_hot_cold(m, N_HOT, jdt, w_dtype=jnp.uint8)
        ht, ct = port_dev.split_hot_cold(m, N_HOT, tdt, "cpu",
                                         w_dtype=torch.uint8)
        assert ht.W.dtype == torch.uint8 and ht.w_scale.dtype == tdt
        np.testing.assert_array_equal(ht.W.numpy(), np.asarray(hj.W))
        np.testing.assert_array_equal(ht.w_scale.numpy(),
                                      np.asarray(hj.w_scale))
        assert ht.W.numpy()[ht.W.numpy() > 0].min() >= 1
        for a in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(ct, a), getattr(cj, a))
        bj = ref_dev.bucket_rows(cj, jdt, include_empty=True, row_align=8)
        bt = port_dev.bucket_rows(ct, tdt, "cpu", include_empty=True,
                                  row_align=8)
        for rj, rt_ in zip(ref_dev.hot_bucket_rows(hj, bj.buckets, N_TGT),
                           port_dev.hot_bucket_rows(ht, bt.buckets)):
            np.testing.assert_array_equal(rt_[0].numpy(), np.asarray(rj[0]))
            np.testing.assert_array_equal(rt_[3].numpy(), np.asarray(rj[3]))
    # a bf16 solve dtype holds the scale at bf16, as the reference does
    hj, _ = ref_dev.split_hot_cold(m, N_HOT, jnp.bfloat16, w_dtype=jnp.uint8)
    ht, _ = port_dev.split_hot_cold(m, N_HOT, torch.bfloat16, "cpu",
                                    w_dtype=torch.uint8)
    np.testing.assert_array_equal(ht.w_scale.float().numpy(),
                                  np.asarray(hj.w_scale, np.float32))


@pytest.mark.parametrize("what", ["non_positive", "presence"])
def test_split_hot_cold_uint8_raises_as_reference(what):
    m, _ = _matrix(9)
    kw = {}
    if what == "non_positive":
        hot = int(np.argmax(np.bincount(m.indices, minlength=N_SRC)))
        m = m.tolil()
        m[int(np.flatnonzero(m.toarray()[:, hot])[0]), hot] = -1.0
        m = sp.csr_matrix(m)
    else:
        kw = dict(with_presence=True)
    with pytest.raises(ValueError, match="strictly positive"):
        ref_dev.split_hot_cold(m, N_HOT, jnp.float32, w_dtype=jnp.uint8,
                               **kw)
    with pytest.raises(ValueError, match="strictly positive"):
        port_dev.split_hot_cold(m, N_HOT, torch.float32, "cpu",
                                w_dtype=torch.uint8, **kw)


def _implicit_matrix(seed=9, n_users=300, n_items=200):
    rng = np.random.default_rng(seed)
    m = sp.random(n_users, n_items, 0.08, random_state=seed, format="csr")
    m.data = 1.0 + rng.exponential(2.0, m.nnz)
    return m


def test_uint8_head_float64_fit_matches_reference():
    """hot_dtype="uint8" at float64 (no bf16 anywhere; the reference's
    tests/test_wrmf.py:336-349 fit): the port's fit equals the reference's
    to 1e-10."""
    m = _implicit_matrix()
    kw = dict(rank=8, lambda_=0.5, feedback="implicit", n_hot=64,
              solver="conjugate_gradient", seed=0, precision="double",
              hot_dtype="uint8")
    mj = rt_ref.WRMF(**kw)
    ej = np.asarray(mj.fit_transform(m, n_iter=3, convergence_tol=-1))
    mt = rt.WRMF(device="cpu", **kw)
    et = mt.fit_transform(m, n_iter=3, convergence_tol=-1).numpy()
    assert mt.stage_info["hot_items"] == 64
    np.testing.assert_allclose(mt.loss_history, mj.loss_history, rtol=1e-10)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-10)
    np.testing.assert_allclose(mt.components, np.asarray(mj.components),
                               rtol=0, atol=1e-10)


LOWP_FITS = {
    "compute_bf16": dict(compute_dtype="bfloat16"),
    "compute_bf16_hot_f32": dict(compute_dtype="bfloat16",
                                 hot_dtype="float32"),
    "compute_bf16_hot_uint8": dict(compute_dtype="bfloat16",
                                   hot_dtype="uint8"),
    "hot_bf16": dict(hot_dtype="bfloat16"),
    "precision_bf16": dict(precision="bfloat16"),
    "precision_bf16_compute_bf16": dict(precision="bfloat16",
                                        compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(LOWP_FITS))
def test_bf16_fit_loss_history_matches_reference(case):
    """Whole implicit CG fits with a 64-column head at each bf16 setting:
    loss histories within 1e-3 relative of the (jitted) reference, factors
    of the stated dtype, predict indices close."""
    m = _implicit_matrix()
    kw = dict(rank=8, lambda_=0.5, feedback="implicit", n_hot=64,
              solver="conjugate_gradient", seed=0, with_global_bias=True,
              **LOWP_FITS[case])
    mj = rt_ref.WRMF(**kw)
    ej = np.asarray(mj.fit_transform(m, n_iter=3, convergence_tol=-1),
                    np.float32)
    mt = rt.WRMF(device="cpu", **kw)
    et = mt.fit_transform(m, n_iter=3, convergence_tol=-1)
    dt = torch.bfloat16 if kw.get("precision") == "bfloat16" else \
        torch.float32
    assert et.dtype == dt and mt.components.dtype == np.float32
    np.testing.assert_allclose(mt.loss_history, mj.loss_history, rtol=1e-3)
    assert _rel(et.float(), ej) <= 2e-2
    pj, pt = mj.predict(m, k=5), mt.predict(m, k=5)
    assert (pj.indices == pt.indices).mean() >= 0.95


def test_resolve_n_hot_memory_budget_grid():
    """The reference's memory-budget grid (tests/test_wrmf.py:357-377) on
    the port: the same head sizes, each within the 1 GB budget at the
    storage width of its hot dtype."""
    rng = np.random.default_rng(0)
    n_r, n_c, nnz = 1 << 20, 4096, 100_000
    csr = sp.csr_matrix(
        (np.ones(nnz, np.float32),
         (rng.integers(0, n_r, nnz), rng.integers(0, n_c, nnz))),
        shape=(n_r, n_c))
    for hot_dtype, compute, precision, w_bytes in [
        ("uint8", "float32", "float32", 1),
        ("auto", "bfloat16", "float32", 2),
        ("auto", "float32", "float32", 4),
        ("float32", "bfloat16", "float32", 4),
        ("auto", "float32", "double", 8),
        ("auto", "float32", "bfloat16", 2),
    ]:
        kw = dict(n_hot=1 << 14, hot_dtype=hot_dtype, compute_dtype=compute,
                  precision=precision)
        n = rt.WRMF(device="cpu", **kw)._resolve_n_hot(csr)
        assert n == rt_ref.WRMF(**kw)._resolve_n_hot(csr)
        assert w_bytes * n_r * n <= (1 << 30), (hot_dtype, compute, n)
    # "auto": uint8 halves the popularity threshold of bf16
    x = _implicit_matrix(n_users=2048, n_items=300)
    for hot_dtype in ("uint8", "bfloat16"):
        kw = dict(hot_dtype=hot_dtype)
        assert (rt.WRMF(device="cpu", **kw)._resolve_n_hot(x)
                == rt_ref.WRMF(**kw)._resolve_n_hot(x))


def test_wrmf_from_numpy_of_a_bf16_model():
    """A JAX precision="bfloat16" model's components, read as float32,
    load exactly into a bf16 port model, whose transform agrees with the
    reference's (both round the solutions to bf16: at most one bf16 step
    apart, nearly all bitwise)."""
    m = _implicit_matrix()
    kw = dict(rank=8, lambda_=0.5, feedback="implicit",
              solver="conjugate_gradient", seed=0, precision="bfloat16",
              compute_dtype="bfloat16")
    mj = rt_ref.WRMF(**kw)
    mj.fit_transform(m, n_iter=2, convergence_tol=-1)
    comps = np.asarray(mj.components, np.float32)
    mc = wrmf_from_numpy(comps, item_ids=mj.item_ids, device="cpu", **kw)
    assert mc._V.dtype == torch.bfloat16
    np.testing.assert_array_equal(mc.components, comps)
    held = m[::3]
    uj = np.asarray(mj.transform(held), np.float32)
    ut = mc.transform(held).float().numpy()
    assert np.abs(ut - uj).max() <= 2.0 ** -7 * np.abs(uj).max()
    assert (ut == uj).mean() >= 0.95
    sj = mj.get_similar_items(3, k=10, device=True)
    st = mc.get_similar_items(3, k=10, device=True)
    np.testing.assert_array_equal(st.indices, sj.indices)


def test_options_validated_as_reference():
    with pytest.raises(ValueError, match="implicit"):
        rt.WRMF(feedback="explicit", hot_dtype="uint8", device="cpu")
    with pytest.raises(ValueError, match="hot_dtype"):
        rt.WRMF(hot_dtype="int8", device="cpu")
    m = _implicit_matrix()
    hot = int(np.argmax(np.bincount(m.indices, minlength=m.shape[1])))
    m = m.tolil()
    m[0, hot] = 1e-300
    m = sp.csr_matrix(m)
    m.data[m.data < 1e-200] = 0.0                     # a stored zero
    with pytest.raises(ValueError, match="strictly positive"):
        rt.WRMF(hot_dtype="uint8", n_hot=16, device="cpu").fit_transform(m)


@pytest.mark.parametrize("make", [
    lambda: rt.PureSVD(precision="bfloat16", device="cpu"),
    lambda: rt.LinearFlow(precision="bfloat16", device="cpu"),
    lambda: rt.FTRL(precision="bfloat16", device="cpu"),
    lambda: rt.FactorizationMachine(precision="bfloat16", device="cpu"),
    lambda: rt.soft_impute(sp.random(20, 10, 0.3, format="csr"), rank=2,
                           precision="bfloat16", device="cpu"),
], ids=["pure_svd", "linear_flow", "ftrl", "fm", "soft_impute"])
def test_bf16_precision_is_wrmf_only(make):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make()


def test_gather_rows_plain_and_strided_out():
    """gather_rows (K12's wrapper; its plain version on the CPU) against
    the JAX probes' own gathers on the same inputs, f32 and bf16:
    scripts/exp_gather.py kern_take (jnp.take over the rows),
    scripts/exp_gather2.py b1 (take_along_axis with operand-shaped
    indices) and b3 (the lane gather take_along_axis(tabT, idx, axis=1)
    on the transposed table, which the port writes through strided views
    of the table and output).  Layouts and index types K12 is not built
    for raise on the CPU as on the card."""
    rng = np.random.default_rng(2)
    tab_np = rng.standard_normal((64, 16)).astype(np.float32)
    idx_np = rng.integers(0, 64, 200).astype(np.int32)
    idx = torch.tensor(idx_np)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        tab_j = jnp.asarray(tab_np, dtype=jdt)
        tab = torch.tensor(tab_np).to(tdt)
        take = np.asarray(jnp.take(tab_j, jnp.asarray(idx_np), axis=0)
                          .astype(jnp.float32))
        assert np.array_equal(
            port_gather.gather_rows(tab, idx).float().numpy(), take)
        sq = idx_np[:64]                              # b1: n == len(table)
        tala = jnp.take_along_axis(
            tab_j, jnp.broadcast_to(jnp.asarray(sq)[:, None], (64, 16)),
            axis=0)
        assert np.array_equal(
            port_gather.gather_rows(tab, torch.tensor(sq)).float().numpy(),
            np.asarray(tala.astype(jnp.float32)))
        tabT_j = tab_j.T                              # b3: (16, 64)
        tabT = tab.T.contiguous()
        # 200 indices, and 1001: a row of the output that is not a whole
        # number of 16-byte vectors
        for li in (idx_np, rng.integers(0, 64, 1001).astype(np.int32)):
            n = li.size
            lanes = jnp.take_along_axis(
                tabT_j, jnp.broadcast_to(jnp.asarray(li)[None, :], (16, n)),
                axis=1)
            outT = torch.empty((16, n), dtype=tdt)
            got = port_gather.gather_rows(tabT.T, torch.tensor(li),
                                          out=outT.T)
            assert got.data_ptr() == outT.data_ptr()
            assert np.array_equal(outT.float().numpy(),
                                  np.asarray(lanes.astype(jnp.float32)))
            assert torch.equal(outT, tabT[:, torch.tensor(li).long()])
    tab = torch.tensor(tab_np)
    with pytest.raises(ValueError):
        port_gather.gather_rows(tab, idx, out=torch.empty((200, 15)))
    with pytest.raises(ValueError, match="int32"):
        port_gather.gather_rows(tab, idx.long())
    with pytest.raises(ValueError, match="strides"):
        port_gather.gather_rows(tab[:, ::2], idx)


@pytest.mark.parametrize("n, d, n_tab, es, want", [
    # P2's shape, bf16: one 64 KB row of tabT a block, two blocks an SM,
    # spans of twice the table
    (2_097_152, 128, 32_768, 2, ("staged", 1, 65_536, 128, 32, 65_536)),
    # f32: one 128 KB row a block, one block an SM, 3 spans (3 waves)
    (2_097_152, 128, 32_768, 4, ("staged", 1, 699_052, 128, 3, 131_072)),
    # a bf16 table of 200,000 rows: a row of tabT (400 KB) does not fit
    (4096, 64, 200_000, 2, ("elementwise", 0, 0, 0, 0, 0)),
    # a small table: every row staged in one group
    (50, 16, 64, 2, ("staged", 16, 128, 1, 1, 2048)),
])
def test_lane_plan(n, d, n_tab, es, want):
    """K12's lane layout plan: the rows of tabT that leave room for two
    blocks an SM in the H100's shared memory (else the one that fits),
    spread evenly over the row groups; short spans when two blocks share
    an SM, else at least two waves of 132 blocks; spans a multiple of the
    16-byte vector; the per-element case for a table too long."""
    p = port_gather.lane_plan(n, d, n_tab, es)
    assert tuple(p) == want
    if p.case == "staged":
        assert p.span % (16 // es) == 0 and p.span * p.n_spans >= n
        assert p.smem_bytes <= port_gather.H100_SMEM_BYTES
        assert p.row_groups * p.rt >= d > (p.row_groups - 1) * p.rt
        assert (2 * p.smem_bytes <= port_gather.H100_SMEM_BYTES
                or p.rt == 1 and p.row_groups * p.n_spans
                >= 2 * port_gather.H100_SMS)

