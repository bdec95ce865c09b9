"""Port parity of WRMF at the wide widths (K1's and K2's d > 160 routes).

On the card K1 and K2 take d <= 514 (rank 512 with both biases) on wide
instances (``ops/als.py`` ``WIDE_D``); on the CPU their wrappers run the
plain versions, which take any width.  The same numpy-made inputs go
through ``rsparse_tpu`` and ``rsparse_tpu_torch`` at d = 161 and 258 (and
a whole fit at rank 192); the wide launch plans are checked as pure
functions, as ``tests/test_torch_k1_split.py`` checks ``cg_split``.

Stated tolerances, as ``tests/test_torch_als.py`` and
``tests/test_torch_wrmf_lowp.py`` at the same dtypes: float64 half-sweeps
(implicit and explicit, CG and Cholesky, biases, a float32 / bf16 / uint8
head) 1e-9 absolute on the factors and 1e-10 relative on the loss;
compute_dtype="bfloat16" buckets against the reference run op by op 1e-5
relative (max norm); the float64 fit 1e-9 on the embeddings and 1e-10
relative on the loss history, and the same top-10 predictions.
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
from rsparse_tpu_torch import _kernels
from rsparse_tpu_torch.convert import wrmf_from_numpy
from rsparse_tpu_torch.ops import als as port
from rsparse_tpu_torch.sparse import device as port_dev

torch.set_num_threads(2)

N_TGT, N_SRC, N_HOT = 40, 36, 8
LAM = 0.5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _sweep_problem(d, feedback, biases, seed, n_tgt):
    """(n_tgt, n_src) interactions (explicit: centred integer ratings, some
    stored zeros) and (n, d) factor tables, with the ones and bias columns
    of ``with_user_item_bias`` when ``biases``."""
    rng = np.random.default_rng(seed)
    m = sp.random(n_tgt, N_SRC, density=0.3,
                  random_state=np.random.RandomState(seed), format="csr")
    m.data = (np.round(1.0 + 4.0 * m.data) - 3.0 if feedback == "explicit"
              else 1.0 + 4.0 * m.data)
    src = rng.standard_normal((N_SRC, d)) * 0.3
    tgt = rng.standard_normal((n_tgt, d)) * 0.3
    if biases:
        src[:, 0] = 1.0
        tgt[:, d - 1] = 1.0
    return m, src, tgt


# Cholesky sweeps hold two target rows, one bucket of B = 2 without row
# padding, at d = 161: there the reference factors with
# lax.linalg.cholesky (B d^2 < 2^16).  Above that size it takes its blocked
# solve, whose compile costs the CPU suite ~25 s a case (measured at d =
# 258, B = 2), so the Cholesky route at d = 258 is held on the card (K2
# against its plain version, chip_smoke.py phase 11) and not here.
SWEEPS = [(161, "conjugate_gradient", "implicit", "head uint8"),
          (161, "conjugate_gradient", "explicit", "biases"),
          (258, "conjugate_gradient", "implicit", "head f32"),
          (258, "conjugate_gradient", "implicit", "biases"),
          (258, "conjugate_gradient", "explicit", "head bf16"),
          (161, "cholesky", "implicit", "head uint8"),
          (161, "cholesky", "implicit", "biases"),
          (161, "cholesky", "explicit", "head bf16"),
          (161, "cholesky", "explicit", "biases")]


@pytest.mark.parametrize("d,solver,feedback,kind", SWEEPS)
def test_wide_half_sweep_matches_reference(d, solver, feedback, kind):
    """One float64 half-sweep at a wide width: every bucket's solve (the
    K1 / K2 plain versions) against the reference's; heads stored at
    float32, bf16 or uint8 (explicit: presence bits for stored zeros)."""
    biases = kind == "biases"
    explicit = feedback == "explicit"
    chol = solver == "cholesky"
    n_tgt, align = (2, 1) if chol else (N_TGT, 8)
    m, src, tgt = _sweep_problem(d, feedback, biases, d + len(kind), n_tgt)
    code = ref.solver_code(solver)
    g = 0.07 if not explicit else 0.0
    ct = port.ALSConfig(solver=code, feedback=feedback, with_biases=biases,
                        use_global_bias=not explicit, dynamic_lambda=explicit)
    cj = ref.ALSConfig(feedback=feedback, solver=code, with_biases=biases,
                       use_global_bias=not explicit, dynamic_lambda=explicit,
                       solve_empty=ct.solve_empty)
    hj = ht = rows_j = rows_t = None
    cold = m
    if kind.startswith("head"):
        w = kind.split()[1]
        w_dt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16),
                "uint8": (jnp.uint8, torch.uint8)}[w]
        hj, cold = ref_dev.split_hot_cold(m, N_HOT, jnp.float64,
                                          w_dtype=w_dt[0],
                                          with_presence=explicit)
        ht, _ = port_dev.split_hot_cold(m, N_HOT, torch.float64, "cpu",
                                        with_presence=explicit,
                                        w_dtype=w_dt[1])
    incl = ct.solve_empty or ht is not None
    bj = ref_dev.bucket_rows(cold, jnp.float64, include_empty=incl,
                             row_align=align)
    bt = port_dev.bucket_rows(cold, torch.float64, "cpu", include_empty=incl,
                              row_align=align)
    if chol:
        assert sum(b.batch for b in bt.buckets) <= 2
    if ht is not None:
        rows_j = ref_dev.hot_bucket_rows(hj, bj.buckets, n_tgt)
        rows_t = port_dev.hot_bucket_rows(ht, bt.buckets)
    cnt = np.diff(m.tocsc().indptr).astype(np.float64)
    yj, lj = ref.wrmf_sweep(jnp.asarray(src), jnp.asarray(tgt), bj.buckets,
                            jnp.asarray(cnt), LAM, g, cj, hj, rows_j)
    yt, lt = port.wrmf_sweep(torch.from_numpy(src), torch.from_numpy(tgt),
                             bt.buckets, LAM, g, ct,
                             None if ht is None else ht.hot_ids, rows_t,
                             torch.from_numpy(cnt))
    yj = np.asarray(yj)
    assert yt.shape == yj.shape == (n_tgt, d)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-9)
    assert abs(float(lt) - float(lj)) <= 1e-10 * abs(float(lj))


def _bf16_bucket(d, head, explicit, seed):
    """The widest cold bucket of a float32 problem with its head rows
    (``head``: "bf16" or "uint8" storage), on both sides."""
    rng = np.random.default_rng(seed)
    m = sp.random(N_TGT, N_SRC, density=0.3,
                  random_state=np.random.RandomState(seed), format="csr")
    m.data = (np.round(1.0 + 4.0 * m.data, 1) if explicit
              else 1.0 + rng.exponential(3.0, m.nnz))
    src = (rng.standard_normal((N_SRC, d)) * 0.3).astype(np.float32)
    w_dt = {"bf16": (jnp.bfloat16, torch.bfloat16),
            "uint8": (jnp.uint8, torch.uint8)}[head]
    hj, cold = ref_dev.split_hot_cold(m, N_HOT, jnp.float32, w_dtype=w_dt[0],
                                      with_presence=explicit)
    ht, _ = port_dev.split_hot_cold(m, N_HOT, torch.float32, "cpu",
                                    with_presence=explicit, w_dtype=w_dt[1])
    bj = ref_dev.bucket_rows(cold, jnp.float32, include_empty=True,
                             row_align=8)
    bt = port_dev.bucket_rows(cold, torch.float32, "cpu", include_empty=True,
                              row_align=8)
    i = int(np.argmax([b.pad_len for b in bt.buckets]))
    rows_j = ref_dev.hot_bucket_rows(hj, bj.buckets, N_TGT)[i]
    rows_t = port_dev.hot_bucket_rows(ht, bt.buckets)[i]
    x0 = (rng.random((bj.buckets[i].batch, d)) * 0.1).astype(np.float32)
    return (src, bj.buckets[i], bt.buckets[i], rows_j, rows_t,
            np.asarray(hj.hot_ids), x0)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d", [161, 258])
def test_wide_bf16_implicit_bucket_matches_reference(d):
    """compute_dtype="bfloat16" with a uint8 head and a global bias at a
    wide width: one implicit CG bucket against the reference run op by op
    (1e-5), which rounds where the port does.  (Not the Cholesky solve:
    at B d^2 >= 2^16 the reference's blocked solve factors the lower
    triangle of a Gram that the bf16 rounding leaves unsymmetric, where
    lax.linalg.cholesky below that size, the port's plain version and K2
    factor its symmetric part; the card holds K2 to the plain version.)"""
    solver = "conjugate_gradient"
    src, bj, bt, rows_j, rows_t, hot, x0 = _bf16_bucket(d, "uint8", False, 3)
    code = ref.solver_code(solver)
    cj = ref.ALSConfig(feedback="implicit", solver=code, use_global_bias=True,
                       compute_dtype="bfloat16")
    ct = port.ALSConfig(solver=code, use_global_bias=True,
                        compute_dtype="bfloat16")
    g = 0.07
    sj = jnp.asarray(src)
    src_act, _, XtX, rhs_init = ref._sweep_prepare(
        sj, jnp.asarray(LAM, jnp.float32), jnp.asarray(g, jnp.float32), cj,
        jnp.float32)
    W, _, _, scale = rows_j
    with jax.disable_jit():
        yj, lj = ref._solve_bucket_implicit(
            src_act, None, XtX, rhs_init, bj, jnp.asarray(x0),
            jnp.asarray(LAM, jnp.float32), jnp.asarray(g, jnp.float32), cj,
            jnp.float32, hot_W=W, V_hot=sj[hot], hot_scale=scale)
    Wt, _, _, st = rows_t
    yt, lt = port.solve_bucket_cg(
        torch.from_numpy(src), None, _t(XtX), _t(rhs_init), bt,
        torch.from_numpy(x0), LAM, g, ct, Wt, torch.from_numpy(src)[hot],
        hot_scale=st)
    assert yt.shape == (bt.batch, d)
    assert _rel(yt, yj) <= 1e-5 and _rel(lt, lj) <= 1e-5


def test_wide_bf16_explicit_bucket_matches_reference():
    """compute_dtype="bfloat16", explicit feedback with dynamic lambda and
    a bf16 head with presence bits at d = 258: one CG bucket, op by op
    1e-5."""
    solver, d = "conjugate_gradient", 258
    src, bj, bt, rows_j, rows_t, hot, x0 = _bf16_bucket(d, "bf16", True, 5)
    code = ref.solver_code(solver)
    cj = ref.ALSConfig(feedback="explicit", solver=code, dynamic_lambda=True,
                       compute_dtype="bfloat16")
    ct = port.ALSConfig(solver=code, feedback="explicit", dynamic_lambda=True,
                        compute_dtype="bfloat16")
    sj = jnp.asarray(src)
    W, bits, nnz_tot, _ = rows_j
    with jax.disable_jit():
        yj, lj = ref._solve_bucket_explicit(
            sj, None, bj, jnp.asarray(x0), jnp.asarray(LAM, jnp.float32), cj,
            jnp.float32, hot_W=W, V_hot=sj[hot], hot_bits=bits,
            nnz_total=nnz_tot)
    Wt, bits_t, nnz_t, _ = rows_t
    yt, lt = port.solve_bucket_cg(torch.from_numpy(src), None, None, None,
                                  bt, torch.from_numpy(x0), LAM, 0.0, ct, Wt,
                                  torch.from_numpy(src)[hot], bits_t, nnz_t)
    assert _rel(yt, yj) <= 1e-5 and _rel(lt, lj) <= 1e-5


def test_wide_fit_transform_predict_matches_reference():
    """WRMF rank 192 on a 400 x 300 matrix, 3% dense, float64: CG
    fit_transform (closing with the exact half-sweep), transform and
    predict against the JAX package's."""
    rng = np.random.default_rng(17)
    m = sp.random(400, 300, density=0.03, random_state=17, format="csr")
    m.data = 1.0 + rng.exponential(2.0, m.nnz)
    kw = dict(rank=192, lambda_=1.0, feedback="implicit", seed=0,
              solver="conjugate_gradient", precision="double", n_hot=0)
    mj = rt_ref.WRMF(**kw)
    ej = np.asarray(mj.fit_transform(m, n_iter=2, convergence_tol=-1))
    mt = rt.WRMF(device="cpu", **kw)
    et = mt.fit_transform(m, n_iter=2, convergence_tol=-1)
    assert et.shape == (400, 192)
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=1e-9)
    np.testing.assert_allclose(mt.loss_history, mj.loss_history, rtol=1e-10)
    tj = np.asarray(mj.transform(m))
    tt = mt.transform(m).numpy()
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-9)
    pj = mj.predict(m, k=10, not_recommend=m)
    pt = mt.predict(m, k=10, not_recommend=m)
    np.testing.assert_array_equal(np.asarray(pt.indices),
                                  np.asarray(pj.indices))


def test_wrmf_from_numpy_carries_wide_tables():
    """convert.wrmf_from_numpy at rank 512 with both biases (components of
    514 rows) carries the item table unchanged."""
    rng = np.random.default_rng(2)
    comps = rng.standard_normal((514, 30))
    comps[-1] = 1.0
    m = wrmf_from_numpy(comps, with_user_item_bias=True, precision="double",
                        device="cpu")
    assert m.rank == 512 and m._R == 514
    np.testing.assert_array_equal(np.asarray(m.components), comps)


# -- the wide launch plans as pure functions ----------------------------------

def _fake_active(d, H, tb, per_sm=1):
    """What rsp_als_cg_info reports for a wide instance: by (rows, cluster
    size), the clusters that run at once on 132 SMs, 0 where the layout
    does not fit a CTA's shared memory."""
    return {(rows, cs): (132 * per_sm // cs
                         if port.cg_smem_bytes(d, H, tb, cs, rows)
                         <= port.SMEM_LIMIT else 0)
            for rows in (16, 8, 4, 2, 1) for cs in (1, 2, 4, 8, 16)}


@pytest.mark.parametrize("d,H,tb", [(161, 0, 4), (258, 4096, 4),
                                     (258, 4096, 2), (514, 0, 4),
                                     (514, 4096, 4), (514, 16384, 2)])
def test_cg_split_offers_only_layouts_that_fit(d, H, tb):
    """cg_split over the wide instances' (rows, cluster) occupancy: every
    plan it takes fits a CTA's shared memory, at the buckets' shapes of
    the ML-20M-shaped fit and the long-row bucket, and the vectors are
    sized to the plan's rows."""
    active = _fake_active(d, H, tb)
    assert any(n > 0 for n in active.values())
    for B, L in ((256, 128), (16, 8192), (11272, 16), (8, 41280)):
        rows, cs = port.cg_split(B, L, active, H, port.CG_WIDE_WARPS)
        assert active[(rows, cs)] > 0, (B, L)
        smem, cache = port.cg_layout(d, H, tb, cs, rows)
        assert smem <= port.SMEM_LIMIT
        assert cache == 0 if H == 0 else (
            port.CG_CACHE_MIN <= cache <= port.CG_CACHE_MAX)
    # the narrow instances keep 16-row vectors whatever the plan's rows
    assert port.cg_layout(128, 0, 4, 1, 1) == port.cg_layout(128, 0, 4, 1)
    assert port.cg_layout(d, 0, 4, 1, 1)[0] < port.cg_layout(d, 0, 4, 1,
                                                             16)[0]


def test_wide_layout_at_514_needs_fewer_rows():
    """At d = 514 a 16-row tile no longer fits with a cluster's exchange
    buffers, while 8 rows do: the plan must drop rows, never the width."""
    assert port.cg_smem_bytes(514, 0, 4, 2, 16) > port.SMEM_LIMIT
    assert port.cg_smem_bytes(514, 0, 4, 2, 8) <= port.SMEM_LIMIT


#: the widths chip_smoke.py phase 11 runs K1 and K2 at
WIDE_DS = (161, 192, 256, 258, 512, 514)


def _chol_runs(d):
    """Each (CTA, warp)'s run of the wide K2's lower m16n8 tiles, as
    csrc/als_chol_wide.cu ClusterRun deals them: a CTA's own panels
    ascending, tile (m, n), n <= 2m + 1, in each; kMaxWarpTiles a warp at
    most (from the tiles a CTA holds, over its CHOL_WARPS warps)."""
    L = port.chol_wide_layout(d, 4)
    runs, nw = {}, port.CHOL_WARPS
    for c in range(L["cluster"]):
        tiles = [(p, n) for p in range(L["panels"]) if L["owner"][p] == c
                 for n in range(2 * (p + 1))]
        per = -(-len(tiles) // nw)
        for w in range(nw):
            runs[c, w] = tiles[w * per:(w + 1) * per]
    return L, runs


@pytest.mark.parametrize("tb", [4, 2])
@pytest.mark.parametrize("d", WIDE_DS)
def test_chol_cluster_layout_fits(d, tb):
    """The wide K2's CTA at the cluster size its width takes (two staging
    buffers, the entry list, its panels, the diagonal slots and vectors)
    fits 232,448 bytes of
    shared memory at every width, and a warp of its 16 never sums more than
    the 18 tiles its registers hold (kMaxWarpTiles, 128 registers a
    thread)."""
    L, runs = _chol_runs(d)
    assert port.chol_wide_layout(d, tb)["smem_bytes"] <= port.SMEM_LIMIT
    assert L["D"] == -(-d // 16) * 16 and L["panels"] == L["D"] // 16
    # one CTA a row through d = 256, two at 258 (rank 256 with biases),
    # four at 512 and 514
    assert L["cluster"] == {161: 1, 192: 1, 256: 1, 258: 2, 512: 4,
                            514: 4}[d]
    assert max(len(r) for r in runs.values()) <= port.CHOL_WARP_TILES == 18


def _dealt(n_p, cluster):
    """The panels' owners by the deal csrc/als_chol_wide.cu's note
    describes, replayed card by card: from the widest panel down,
    ``cluster`` a round, the direction turning each round."""
    owner, order, p = {}, list(range(cluster)), n_p - 1
    while p >= 0:
        for c in order[:p + 1]:
            owner[p] = c
            p -= 1
        order.reverse()
    return [owner[p] for p in range(n_p)]


@pytest.mark.parametrize("d", WIDE_DS)
def test_chol_every_lower_tile_has_one_owner(d):
    """Every lower m16n8 tile of the padded D x D matrix is summed by
    exactly one warp of the cluster, the one on the CTA that holds its
    panel (so the Gram needs no exchange); the owner of every panel, at
    every cluster size the kernel takes, is the one the deal gives."""
    L, runs = _chol_runs(d)
    n_p = L["panels"]
    for cluster in port.CHOL_SIZES:
        assert [port.chol_panel_owner(p, n_p, cluster)
                for p in range(n_p)] == _dealt(n_p, cluster), cluster
    seen = {}
    for (c, w), run in runs.items():
        for t in run:
            assert t not in seen, (t, c, w, seen.get(t))
            assert L["owner"][t[0]] == c
            seen[t] = c
    assert set(seen) == {(p, n) for p in range(n_p) for n in range(2 * (p + 1))}


@pytest.mark.parametrize("d", WIDE_DS)
def test_chol_deal_balances_the_triangle(d):
    """The deal (from the widest panel down, the direction turning each
    round) gives every CTA of a cluster of 1, 2, 4, 6 or 8 (6 and 8 for a
    bucket of few long rows) at most one panel more than another's share:
    the floats of the CTAs' panels differ by at most the largest panel's,
    and a larger cluster than the width's fits a CTA's shared memory too."""
    for cluster in port.CHOL_SIZES:
        L = port._chol_cluster_layout(d, 4, cluster)
        biggest = 16 * port.chol_panel_lda(L["panels"] - 1)
        assert max(L["floats"]) - min(L["floats"]) <= biggest
        if cluster >= port.chol_wide_layout(d, 4)["cluster"]:
            assert L["smem_bytes"] <= port.SMEM_LIMIT
        assert sum(L["floats"]) == sum(16 * port.chol_panel_lda(p)
                                       for p in range(L["panels"]))
    # a row stride of 8 mod 32 floats spreads a fragment's float2 accesses
    assert all(port.chol_panel_lda(p) % 32 == 8 for p in range(33))


def test_caps_raise_above_each_kernel_width():
    """The width caps, one a kernel: K1, K2 and K4 take d <= 514; above
    them the wrapper raises NotImplementedError naming ROADMAP.md before it
    touches a tensor (the CPU plain versions take any width)."""
    assert _kernels.MAX_D == {"als_cg": 514, "als_chol": 514,
                              "als_nnls": 514}
    assert port.WIDE_D == 160
    for kernel, d in (("als_cg", 515), ("als_chol", 515), ("als_nnls", 515)):
        src = torch.zeros((4, d))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            port._bucket_args(src, None, None, None, None, None, 1.0, 0.0,
                              port.ALSConfig(solver=0), None, None, None, None,
                              kernel=kernel)
