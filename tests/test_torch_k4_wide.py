"""Port parity of K4, WRMF's NNLS solver, at the wide widths (160 < d <= 514).

On the card K4 takes d <= 514 (rank 512 with both biases) on
``csrc/als_nnls_wide.cu``; on the CPU its wrapper runs the plain version
(``ops/solvers.py`` ``batched_nnls`` behind ``ops/als.py``
``_solve_bucket_implicit`` / ``_explicit``), which takes any width.  The
same numpy-made inputs go through ``rsparse_tpu`` and ``rsparse_tpu_torch``:

- the plain ``batched_nnls`` against the JAX package's at d = 161, 258 and
  514, float64, one system at a time (where the two agree exactly: the JAX
  package stops a batch when all of its systems have stopped, the port
  each system on its own), 1e-10 (max |a - b| / max(max |b|, 1)), with
  systems that stop after different numbers of sweeps;
- one bucket's NNLS solve at d = 258 and 514, float64, against the JAX
  package's bucket function run one row at a time: implicit with a head,
  implicit with a global bias, explicit with source biases, explicit with
  a head and presence bits; y 1e-9 absolute, the loss 1e-10 relative;
- the wide kernel's split replayed in float64 numpy: each build CTA's
  panels of lhs (the wide K2's deal) written to the scratch with their
  mirrors, or a second pass where bf16-rounded rows make lhs
  non-symmetric; G's lower 64 x 64 tiles and their mirrors; mu; the sweeps
  reading G's rows through a warp's ring; slices and orders of systems
  that do not change y or the sweeps (bitwise);
- a 2-iteration ``WRMF(rank=192, solver="nnls")`` fit, transform and
  predict against the JAX package's at float64 (1e-9), and
  ``convert.wrmf_from_numpy`` of a JAX-fitted rank-192 NNLS model;
- ``chip_smoke.REF_WIDE["wrmf_nnls_rank192"]`` held to the JAX package.

The sweep budgets are small (the plain version runs a torch op a
coordinate step).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.ops import als as ref
from rsparse_tpu.ops import solvers as ref_solvers
from rsparse_tpu.sparse import device as ref_dev
from rsparse_tpu_torch.convert import wrmf_from_numpy
from rsparse_tpu_torch.ops import als as port
from rsparse_tpu_torch.ops import solvers
from rsparse_tpu_torch.sparse import device as port_dev

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TGT, N_SRC, N_HOT = 12, 40, 8
LAM = 0.5
#: the sweep budget of the bucket tests (the plain loop is a torch op a
#: coordinate step)
MAX_ITER = 20


def _rel1(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


# -- the plain batched_nnls against the JAX package's --------------------------

def _spd_batch(d: int, B: int = 3, seed: int = 0):
    """SPD lhs of condition numbers 2 to 12 (G squares them), a rhs whose
    solution has coordinates of both signs, and a random start."""
    rng = np.random.default_rng(seed + d)
    lhs = np.empty((B, d, d))
    for b, cond in enumerate(np.geomspace(2, 12, B)):
        q, _ = np.linalg.qr(rng.standard_normal((d, d)))
        lhs[b] = (q * np.geomspace(1, cond, d)) @ q.T
    rhs = (lhs @ rng.standard_normal((B, d))[..., None])[..., 0]
    return lhs, rhs, rng.standard_normal((B, d))


@pytest.mark.parametrize("d,start", [(161, "zero"), (258, "abs"),
                                     (514, "abs")])
def test_plain_nnls_matches_reference(d, start):
    """batched_nnls (the plain version K4 is held to) against the JAX
    package's, one system at a time, float64: 1e-10; the systems stop
    after different numbers of sweeps, every factor >= 0, some at 0."""
    lhs, rhs, x0 = _spd_batch(d)
    x0 = np.zeros_like(x0) if start == "zero" else np.abs(x0)
    x, sw = solvers.batched_nnls(torch.from_numpy(lhs), torch.from_numpy(rhs),
                                 torch.from_numpy(x0), max_iter=60,
                                 return_sweeps=True)
    x = x.numpy()
    assert (x >= 0).all() and (x == 0).any()
    for b in range(len(x0)):
        xj = np.asarray(ref_solvers.batched_nnls(
            jnp.asarray(lhs[b:b + 1]), jnp.asarray(rhs[b:b + 1]),
            jnp.asarray(x0[b:b + 1]), max_iter=60))[0]
        assert _rel1(x[b], xj) <= 1e-10
    assert len(set(sw.tolist())) > 1


# -- one bucket's solve against the JAX package's -----------------------------

def _problem(d, explicit, biases, seed):
    """(N_TGT, N_SRC) interactions (explicit: centred integer ratings,
    stored zeros among them) and a source table whose solve is d wide:
    (N_SRC, d), or with ``biases`` (N_SRC, d + 1) with the ones column of
    ``with_user_item_bias`` first and its bias column last."""
    rng = np.random.default_rng(seed)
    m = sp.random(N_TGT, N_SRC, density=0.3,
                  random_state=np.random.RandomState(seed), format="csr")
    m.data = (np.round(1.0 + 4.0 * m.data) - 3.0 if explicit
              else 1.0 + 4.0 * m.data)
    src = rng.standard_normal((N_SRC, d + int(biases))) * 0.3
    if biases:
        src[:, 0] = 1.0
    x0 = np.abs(rng.standard_normal((N_TGT + 8, d))) * 0.05
    return m, src, x0


BUCKETS = [(d, kind) for d in (258, 514) for kind in (
    "implicit head", "implicit global bias", "explicit biases",
    "explicit head bits")]


@pytest.mark.parametrize("d,kind", BUCKETS)
def test_wide_nnls_bucket_matches_reference(d, kind):
    """The widest bucket of a float64 problem at a wide width: the port's
    NNLS solve of the whole bucket (each system stops on its own) against
    the JAX package's bucket function one row at a time (whose batch is
    then that system): y 1e-9, the loss 1e-10 relative; every factor >= 0.
    A head is stored at float32; explicit heads carry presence bits (a
    stored zero rating counts)."""
    explicit = kind.startswith("explicit")
    biases = kind.endswith("biases")
    head = "head" in kind
    ugb = kind.endswith("global bias")
    m, src, x0 = _problem(d, explicit, biases, d + len(kind))
    fb = "explicit" if explicit else "implicit"
    g = 0.07 if ugb else 0.0
    ct = port.ALSConfig(solver=port.NNLS, feedback=fb, with_biases=biases,
                        use_global_bias=ugb, dynamic_lambda=explicit,
                        nnls_max_iter=MAX_ITER)
    cj = ref.ALSConfig(feedback=fb, solver=ref.NNLS, with_biases=biases,
                       use_global_bias=ugb, dynamic_lambda=explicit,
                       nnls_max_iter=MAX_ITER, solve_empty=ct.solve_empty)
    cold, hj, ht = m, None, None
    if head:
        hj, cold = ref_dev.split_hot_cold(m, N_HOT, jnp.float64,
                                          w_dtype=jnp.float32,
                                          with_presence=explicit)
        ht, _ = port_dev.split_hot_cold(m, N_HOT, torch.float64, "cpu",
                                        with_presence=explicit,
                                        w_dtype=torch.float32)
    bj = ref_dev.bucket_rows(cold, jnp.float64, include_empty=True,
                             row_align=1)
    bt = port_dev.bucket_rows(cold, torch.float64, "cpu", include_empty=True,
                              row_align=1)
    i = int(np.argmax([b.batch * b.pad_len for b in bt.buckets]))
    b_j, b_t = bj.buckets[i], bt.buckets[i]
    B = b_t.batch
    assert B >= 2
    rows_j = rows_t = None
    if head:
        rows_j = ref_dev.hot_bucket_rows(hj, bj.buckets, N_TGT)[i]
        rows_t = port_dev.hot_bucket_rows(ht, bt.buckets)[i]
    sj, st = jnp.asarray(src), torch.from_numpy(src)
    src_j, xb_j, XtX_j, ri_j = ref._sweep_prepare(sj, LAM, g, cj, jnp.float64)
    src_t, xb_t, XtX_t, ri_t = port._sweep_prepare(st, LAM, g, ct,
                                                   torch.float64)
    ids = np.asarray(b_t.row_ids)
    xt = torch.from_numpy(x0[ids])
    Vh_t = None if ht is None else src_t[ht.hot_ids.long()]
    sweeps = torch.zeros((B,), dtype=torch.int32)
    if explicit:
        W, bits, nnz_tot = (None, None, None) if not head else rows_t[:3]
        yt, lt = port._solve_bucket_explicit(
            src_t, xb_t, b_t, xt, LAM, ct, W, Vh_t, bits, nnz_tot,
            sweeps=sweeps)
    else:
        W = None if not head else rows_t[0]
        yt, lt = port._solve_bucket_implicit(
            src_t, xb_t, XtX_t, ri_t, b_t, xt, LAM, g, ct, W, Vh_t,
            sweeps=sweeps)
    assert yt.shape == (B, d) and (yt >= 0).all()
    Vh_j = None if hj is None else src_j[np.asarray(hj.hot_ids)]
    one = lambda t, r: None if t is None else t[r:r + 1]  # noqa: E731
    for r in range(B):
        bucket = type(b_j)(*(one(t, r) for t in b_j))
        x_r = jnp.asarray(x0[ids[r]:ids[r] + 1])
        if explicit:
            W, bits, nnz_tot = ((None,) * 3 if not head else
                                tuple(one(t, r) for t in rows_j[:3]))
            yj, lj = ref._solve_bucket_explicit(
                src_j, xb_j, bucket, x_r, LAM, cj, jnp.float64, hot_W=W,
                V_hot=Vh_j, hot_bits=bits, nnz_total=nnz_tot)
        else:
            W = None if not head else one(rows_j[0], r)
            yj, lj = ref._solve_bucket_implicit(
                src_j, xb_j, XtX_j, ri_j, bucket, x_r, LAM, g, cj,
                jnp.float64, hot_W=W, V_hot=Vh_j)
        np.testing.assert_allclose(yt[r].numpy(), np.asarray(yj)[0], rtol=0,
                                   atol=1e-9)
        assert abs(float(lt[r]) - float(lj[0])) <= 1e-10 * max(
            abs(float(lj[0])), 1e-30)
    assert int(sweeps.max()) <= MAX_ITER and int(sweeps.min()) >= 1


# -- the wide kernel's split, replayed ----------------------------------------

def _layout_consts():
    """kRing, kChunk, kGT, kLhsSub and the row stride rule as
    csrc/als_nnls_wide.cu has them."""
    with open(os.path.join(REPO, "rsparse_tpu_torch", "csrc",
                           "als_nnls_wide.cu")) as f:
        src = f.read()
    consts = tuple(int(re.search(r"constexpr int %s = (\d+);" % n,
                                 src).group(1))
                   for n in ("kRing", "kChunk", "kGT", "kLhsSub"))
    ds_rule = re.search(r"nnls_ds\(int d\) \{ return \(d \+ 7\) & ~7; \}",
                        src) is not None
    return consts, ds_rule


def test_wide_layout_constants_match_the_kernel():
    """ops/als.py's mirror of the wide K4's layout (nnls_wide_layout:
    the ring of G rows and its chunks, G's tile, the lhs sub-slice, the row
    stride) holds the kernel's constants; a system of a slice is G then mu
    at 32-byte aligned rows (a system of the sub-slice lhs then rhs), and
    NNLS_SCRATCH_BYTES holds the sub-slice and over 800 systems' G at d =
    514."""
    consts, ds_rule = _layout_consts()
    assert consts == (port.NNLS_RING, port.NNLS_CHUNK, port.NNLS_G_TILE,
                      port.NNLS_LHS_SUB) and ds_rule
    assert port.NNLS_RING % port.NNLS_CHUNK == 0
    assert port.NNLS_RING // port.NNLS_CHUNK >= 3
    for d in (161, 192, 256, 258, 512, 514):
        L = port.nnls_wide_layout(d, 4)
        assert L["ds"] % 8 == 0 and d <= L["ds"] < d + 8
        off = L["offsets"]
        assert (off["G"], off["mu"], off["lhs"], off["rhs"]) == (
            0, d * L["ds"], 0, d * L["ds"])
        assert L["stride"] == off["mu"] + L["ds"] and L["stride"] % 8 == 0
        assert L["cluster"] == port.chol_wide_layout(d, 4)["cluster"]
        assert L["ring_bytes"] == 128 + 4 * port.NNLS_RING * L["ds"]
    L = port.nnls_wide_layout(514, 4)
    per = (port.NNLS_SCRATCH_BYTES - 4 * L["sub"] * L["stride"]) // (
        4 * L["stride"])
    assert per >= 800


def _build_scratch(lhs, tbytes, two_pass):
    """The build's writes of one system's lhs (d x d) into its scratch
    rows (d x ds), CTA by CTA over the wide K2's panels: each panel's rows
    up to its diagonal block's end, then the blocks left of its diagonal
    block transposed, from lhs itself (symmetric: the mirror) or, with
    ``two_pass``, from the second pass's panels (of lhs': lhs's upper
    blocks).  Returns (scratch rows, writes per cell)."""
    d = lhs.shape[0]
    L = port.nnls_wide_layout(d, tbytes)
    ds = L["ds"]
    A = np.full((d, ds), np.nan)
    writes = np.zeros((d, ds), np.int64)
    lhs_t = lhs.T
    for c in range(L["cluster"]):
        for p in (p for p in range(L["panels"]) if L["owner"][p] == c):
            i0 = 16 * p
            for i in range(i0, min(i0 + 16, d)):
                for j in range(min(i0 + 16, d)):  # pass 1: lhs's lower rows
                    A[i, j] = lhs[i, j]
                    writes[i, j] += 1
                for j in range(i0):  # the mirror, or pass 2 (lhs' panels)
                    A[j, i] = lhs_t[i, j] if two_pass else lhs[i, j]
                    writes[j, i] += 1
    return A, writes


def _g_tiles(A, d):
    """G = A' A + eps I by the kernel's lower 64 x 64 tiles (k ascending),
    each written at (i, j) and mirrored; returns (G, writes per cell)."""
    gt = port.NNLS_G_TILE
    nt = -(-d // gt)
    G = np.full((d, d), np.nan)
    writes = np.zeros((d, d), np.int64)
    A = A[:, :d]
    for ti in range(nt):
        for tj in range(ti + 1):
            r = slice(gt * ti, min(gt * ti + gt, d))
            c = slice(gt * tj, min(gt * tj + gt, d))
            blk = A[:, r].T @ A[:, c]
            if ti == tj:
                blk = blk + solvers.NNLS_EPS * np.eye(blk.shape[0])
            G[r, c] = blk
            writes[r, c] += 1
            if ti != tj:
                G[c, r] = blk.T
                writes[c, r] += 1
    return G, writes


def _sweep_ring(G, mu, x0, max_iter, rel_tol=solvers.SCD_TOL):
    """One warp's sweeps, G's rows read through its ring of NNLS_RING
    slots in chunks of NNLS_CHUNK rows: stream position p (row p % d) in
    slot p % NNLS_RING, the chunks 0-2 fetched first, and at the start of
    chunk c (step q = c NNLS_CHUNK) chunk c + 3 into the slots chunk c - 1
    left, after which chunks c and c + 1 are waited for; step q reads row
    q + 1; a stopped system's chunks in flight are dropped.  Returns (x,
    sweeps)."""
    d = len(x0)
    R, K = port.NNLS_RING, port.NNLS_CHUNK
    n_ch = R // K
    ring = np.full((R, d), np.nan)
    held = [-1] * R
    landed = [False] * R
    state = dict(ic=0, row=0)

    def fetch():
        for u in range(K):
            s = (state["ic"] * K + u) % R
            ring[s], held[s], landed[s] = G[state["row"]], state["row"], False
            state["row"] = (state["row"] + 1) % d
        state["ic"] += 1

    def wait(ic_done):
        """The chunks before ``ic_done`` have landed."""
        for c in range(ic_done):
            for u in range(K):
                if held[(c * K + u) % R] >= 0 and c >= state["ic"] - n_ch:
                    landed[(c * K + u) % R] = True

    for _ in range(n_ch - 1):
        fetch()
    wait(1)
    x, mu = x0.copy(), mu.copy()
    assert held[0] == 0 and landed[0]
    gc, q, t, go = ring[0].copy(), 0, 0, True
    while t < max_iter and go:
        start = x.copy()
        for k in range(d):
            if q % K == 0:
                fetch()
                wait(q // K + 2)
            s = (q + 1) % R
            # the next row is in its slot and has landed
            assert held[s] == (q + 1) % d and landed[s]
            gn = ring[s].copy()
            nw = max(x[k] - mu[k] / G[k, k], 0.0)
            mu += (nw - x[k]) * gc
            x[k] = nw
            gc, q = gn, q + 1
        rel = (np.abs(x - start) / (np.abs(start) + solvers.NNLS_EPS)).max()
        go = rel > rel_tol
        t += 1
    return x, t


def _replay(lhs, rhs, x0, slice_, order, two_pass=False, max_iter=40,
            sub=port.NNLS_LHS_SUB):
    """The wide K4's launches per slice of ``slice_`` systems: per
    sub-slice of ``sub`` systems (whose lhs the scratch holds) the build,
    G's tiles and mu into the slice's scratch; then the sweeps of the
    slice's systems in ``order`` from the scratch alone.  Returns (x (B,
    d), sweeps (B,))."""
    B, d = x0.shape
    x_out, sw = np.zeros((B, d)), np.zeros(B, np.int64)
    for s0 in range(0, B, slice_):
        n = min(slice_, B - s0)
        scratch = [None] * n
        for u0 in range(0, n, min(sub, slice_)):
            lhs_sub = [None] * min(sub, slice_)
            for s in range(u0, min(u0 + min(sub, slice_), n)):
                lhs_sub[s - u0], _ = _build_scratch(lhs[s0 + s], 4, two_pass)
            for s in range(u0, min(u0 + min(sub, slice_), n)):
                A = lhs_sub[s - u0]
                G, _ = _g_tiles(A, d)
                mu = G @ x0[s0 + s] - A[:, :d].T @ rhs[s0 + s]
                scratch[s] = (G, mu)
        for s in order(n):
            G, mu = scratch[s]
            x_out[s0 + s], sw[s0 + s] = _sweep_ring(G, mu, x0[s0 + s],
                                                    max_iter)
    return x_out, sw


@pytest.mark.parametrize("d,two_pass", [(161, False), (258, True),
                                        (514, False)])
def test_build_writes_every_lhs_cell_once(d, two_pass):
    """The build CTAs' writes cover every cell of a system's lhs rows
    exactly once (the row padding none), with lhs's own values: a
    non-symmetric lhs too when the second pass writes the upper blocks;
    G's tiles and mirrors cover G once and make it exactly symmetric,
    within 1e-12 of lhs' lhs."""
    rng = np.random.default_rng(d)
    lhs = rng.standard_normal((d, d))
    if not two_pass:
        lhs = lhs + lhs.T
    A, writes = _build_scratch(lhs, 4, two_pass)
    assert (writes[:, :d] == 1).all() and (writes[:, d:] == 0).all()
    np.testing.assert_array_equal(A[:, :d], lhs)
    G, gw = _g_tiles(A, d)
    assert (gw == 1).all()
    np.testing.assert_array_equal(G, G.T)
    ref_g = lhs.T @ lhs + solvers.NNLS_EPS * np.eye(d)
    assert _rel1(G, ref_g) <= 1e-12


@pytest.mark.parametrize("d", [161, 258])
def test_split_matches_batched_nnls(d):
    """The build, G, mu and the ring-fed sweeps from the scratch alone
    equal batched_nnls one system at a time (1e-10, the same sweeps)."""
    lhs, rhs, x0 = _spd_batch(d, B=2, seed=1)
    x0 = np.abs(x0)
    x, sw = _replay(lhs, rhs, x0, slice_=2, order=range)
    for b in range(2):
        xp, sp_ = solvers.batched_nnls(
            torch.from_numpy(lhs[b:b + 1]), torch.from_numpy(rhs[b:b + 1]),
            torch.from_numpy(x0[b:b + 1]), max_iter=40, return_sweeps=True)
        assert _rel1(x[b], xp.numpy()[0]) <= 1e-10
        assert sw[b] == int(sp_[0])
    assert (x >= 0).all()


def test_split_does_not_depend_on_order_or_slices():
    """Systems swept in another order, or built and swept in slices of the
    scratch (a bucket past NNLS_SCRATCH_BYTES), their lhs in sub-slices of
    any size, give the same factors and sweeps, bit for bit."""
    lhs, rhs, x0 = _spd_batch(161, B=3, seed=2)
    x0 = np.abs(x0)
    x, sw = _replay(lhs, rhs, x0, slice_=3, order=range, max_iter=15)
    for slice_, order, sub in ((3, lambda n: range(n - 1, -1, -1), 128),
                               (1, range, 128), (3, range, 2),
                               (2, lambda n: range(n - 1, -1, -1), 1)):
        xo, so = _replay(lhs, rhs, x0, slice_, order, max_iter=15, sub=sub)
        np.testing.assert_array_equal(xo, x)
        np.testing.assert_array_equal(so, sw)


# -- whole fits -------------------------------------------------------------

def _fit_problem():
    rng = np.random.default_rng(23)
    m = sp.random(120, 90, density=0.06, random_state=23, format="csr")
    m.data = 1.0 + rng.exponential(2.0, m.nnz)
    return m


NNLS_FIT = dict(rank=192, lambda_=1.0, feedback="implicit", seed=0,
                solver="nnls", precision="double", n_hot=0, nnls_max_iter=6)


def test_wide_nnls_fit_transform_predict_matches_reference():
    """WRMF rank 192 NNLS on a 120 x 90 matrix, 6% dense, float64, 2
    iterations: fit_transform (closing with the NNLS half-sweep),
    transform and predict against the JAX package's: 1e-9 on the factors,
    1e-10 relative on the loss history, the same top-10; every factor >= 0.
    The budget of 6 sweeps stops every system at the budget in both
    packages (a system that stopped sooner in the port would show here)."""
    m = _fit_problem()
    mj = rt_ref.WRMF(**NNLS_FIT)
    ej = np.asarray(mj.fit_transform(m, n_iter=2, convergence_tol=-1))
    mt = rt.WRMF(device="cpu", **NNLS_FIT)
    et = mt.fit_transform(m, n_iter=2, convergence_tol=-1)
    assert et.shape == (120, 192) and float(et.min()) >= 0
    assert float(np.min(mt.components)) >= 0
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=1e-9)
    np.testing.assert_allclose(mt.loss_history, mj.loss_history, rtol=1e-10)
    np.testing.assert_allclose(mt.transform(m).numpy(),
                               np.asarray(mj.transform(m)), rtol=0, atol=1e-9)
    pj = mj.predict(m, k=10, not_recommend=m)
    pt = mt.predict(m, k=10, not_recommend=m)
    np.testing.assert_array_equal(np.asarray(pt.indices),
                                  np.asarray(pj.indices))


def test_wrmf_from_numpy_carries_a_jax_nnls_model():
    """convert.wrmf_from_numpy of a JAX-fitted rank-192 NNLS model: the
    port model's transform (an NNLS half-sweep at d = 192) equals the JAX
    model's, 1e-9, non-negative."""
    m = _fit_problem()
    mj = rt_ref.WRMF(**NNLS_FIT)
    mj.fit_transform(m, n_iter=1, convergence_tol=-1)
    kw = {k: v for k, v in NNLS_FIT.items() if k != "seed"}
    mt = wrmf_from_numpy(np.asarray(mj.components), device="cpu", **kw)
    assert mt.rank == 192 and mt._R == 192
    tt = mt.transform(m).numpy()
    assert tt.min() >= 0
    np.testing.assert_allclose(tt, np.asarray(mj.transform(m)), rtol=0,
                               atol=1e-9)


def test_ref_wide_nnls_key_is_the_jax_package():
    """chip_smoke.REF_WIDE["wrmf_nnls_rank192"] (what phase 11 (c) holds
    the port's ML-100k NNLS fit to) is the JAX package's result, made as
    its comment says: NDCG@10 and MAP@10 within 1e-4 (another CPU's sums
    may round apart); every factor >= 0."""
    import chip_smoke
    kw = chip_smoke.WIDE_NNLS_ML100K
    x = rt_ref.load_movielens100k()
    tr, te = rt_ref.train_test_split(x, 0.2, np.random.default_rng(0))
    m = rt_ref.WRMF(seed=0, **kw["model"])
    emb = m.fit_transform(tr, n_iter=kw["n_iter"])
    p = m.predict(tr, k=10, not_recommend=tr)
    got = (float(np.nanmean(rt_ref.ndcg_k(p.indices, te))),
           float(np.nanmean(rt_ref.ap_k(p.indices, te))))
    want = chip_smoke.REF_WIDE["wrmf_nnls_rank192"]
    assert abs(got[0] - want[0]) <= 1e-4 and abs(got[1] - want[1]) <= 1e-4
    assert float(np.min(emb)) >= 0 and float(np.min(m.components)) >= 0
