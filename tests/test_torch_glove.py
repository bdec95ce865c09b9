"""Port parity of GloVe (K10's and K11's plain versions).

The same numpy-made co-occurrences, states and seeds go through
``rsparse_tpu`` and ``rsparse_tpu_torch`` on the CPU, where the port's
wrappers run the kernels' plain PyTorch versions.  Stated tolerances, all
absolute at float64: a tail epoch (against the scatter and the scheduled
reference epochs), a head pass with a padded edge tile, a shuffled epoch
with the reference's permutation, whole fits and the per-sample replica,
1e-10.  With float32 state and the bfloat16 head the port's f32 sums run
in another order than XLA's, and XLA's CPU fusions skip some of the bf16
roundings the reference's code names, so each table's change is held
relative to its largest entry: ``BF16_EAGER_REL`` against the reference
run op by op, ``BF16_REL`` jitted; the cells of S that round to another
bf16 value are counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.models import glove as ref_glove
from rsparse_tpu.ops.segsum import build_stacked_col_schedule
from rsparse_tpu_torch.convert import glove_from_numpy, glove_state_from_numpy
from rsparse_tpu_torch.models import glove as port_glove

from test_sgd_replica import _glove_replica, glove_problem  # noqa: F401

torch.set_num_threads(2)

TOL = 1e-10
#: the bf16 head against the reference's: largest difference of a table's
#: change over its largest change, against the reference run op by op
#: (measured at most 3.4e-7 over the eight tables) and jitted (measured
#: 8.6e-4, on acc_w_j)
BF16_EAGER_REL = 1e-5
BF16_REL = 2e-3
HP = dict(x_max=10.0, alpha=0.75, lr=0.05)


def _cooc(n, density, seed, scale=10.0):
    m = sp.random(n, n, density=density, random_state=seed, format="coo")
    m.data = 1.0 + scale * m.data
    return m


def _states(n, r, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = [rng.uniform(-0.5, 0.5, s) for s in ((n, r), (n, r), (n,), (n,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n, r), (n, r), (n,), (n,))]
    a = [x.astype(dtype) for x in a]
    return (ref_glove.GloveState(*(jnp.asarray(x) for x in a)),
            glove_state_from_numpy(a, "double" if dtype == np.float64
                                   else "float32", "cpu"))


def _assert_state(sj, st, tol=TOL):
    for name, a, b in zip(port_glove.GloveState._fields, st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol,
                                   err_msg=name)


def _port_shards(host):
    r, c, v, m = (torch.from_numpy(a) for a in host)
    return port_glove.Shards.build(r, c, v.double(), m)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("ref", ["scatter", "scheduled"])
def test_tail_epoch_matches_reference(ref, swap):
    """Several shards of 256 over a 60-token vocabulary (every shard holds
    a token many times): the port's epoch against the reference's scatter
    and scheduled epochs, and the swapped pass of a triangular input."""
    n, r = 60, 5
    coo = _cooc(n, 0.3, 1)
    host = ref_glove._stack_coo_host(coo, 256)
    for a, b in zip(port_glove._stack_coo_host(coo, 256), host):
        np.testing.assert_array_equal(a, b)
    rows, cols = host[:2]
    assert np.bincount(rows[0][host[3][0]]).max() > 3
    shards = _port_shards(host)
    sj, st = _states(n, r, 2)
    jsh = (jnp.asarray(host[0]), jnp.asarray(host[1]), jnp.asarray(host[2]),
           jnp.asarray(host[3]))
    if swap:
        jsh = (jsh[1], jsh[0]) + jsh[2:]
        shards = shards.swapped()
    if ref == "scatter":
        sj, lj = ref_glove._glove_epoch(sj, *jsh, **HP)
    else:
        sr = build_stacked_col_schedule(rows, host[3], n)
        sc = build_stacked_col_schedule(cols, host[3], n)
        if swap:
            sr, sc = sc, sr
        sj, lj = ref_glove._glove_epoch_sched(sj, *jsh, sr, sc, **HP)
    lt = port_glove._glove_epoch(st, shards, **HP)
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    _assert_state(sj, st)


@pytest.mark.parametrize("trans", [False, True])
def test_dense_step_matches_reference(trans):
    """A 200-token head of a 300-token vocabulary in 2 x 2 tiles of 130
    (the edge tiles padded in the reference, cut in the port), and the
    transposed pass."""
    n, H, r = 300, 200, 4
    rng = np.random.default_rng(3)
    hot = np.sort(rng.choice(n, H, replace=False)).astype(np.int32)
    X = np.where(rng.random((H, H)) < 0.3,
                 1.0 + rng.exponential(8.0, (H, H)), 0.0)
    batch = 5070
    grids = ref_glove._head_grids(X.T if trans else X, hot, jnp.float64,
                                  batch)
    head = port_glove._stage_head(X, hot, torch.float64, batch, "cpu")
    assert (head.side, head.nt) == (130, 2) and grids[0].shape == (4, 130)
    if trans:
        head = head.transposed()
    sj, st = _states(n, r, 4)
    sj, lj = ref_glove._glove_dense_step(sj, *grids, **HP)
    lt = port_glove._glove_dense_step(st, head, **HP, cdt=torch.float64)
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    _assert_state(sj, st)


@pytest.mark.parametrize("jit", [False, True])
def test_bf16_head_matches_reference(jit):
    """float32 state, bf16 head: one tile of 256 hot tokens against the
    reference's.  Run op by op (``jax.disable_jit``), the reference rounds
    at every point its code names, as the port does: each table's change
    to BF16_EAGER_REL.  Jitted, XLA's CPU fusions skip some of those bf16
    roundings: BF16_REL.  Few cells of S round apart in the two."""
    n, H, r = 300, 256, 16
    rng = np.random.default_rng(5)
    hot = np.sort(rng.choice(n, H, replace=False)).astype(np.int32)
    X = np.where(rng.random((H, H)) < 0.3,
                 1.0 + rng.exponential(8.0, (H, H)), 0.0).astype(np.float32)
    grids = ref_glove._head_grids(X, hot, jnp.bfloat16, 1 << 20)
    head = port_glove._stage_head(X, hot, torch.bfloat16, 1 << 20, "cpu")
    assert head.nt == 1 and grids[0].shape[0] == 1
    np.testing.assert_array_equal(
        head.x.float().numpy(), np.asarray(grids[2][0], np.float32))
    sj0, st = _states(n, r, 6, np.float32)
    before = [t.clone() for t in st]
    if jit:
        sj, lj = ref_glove._glove_dense_step(sj0, *grids, **HP,
                                             compute_dtype="bfloat16")
    else:
        with jax.disable_jit():
            sj, lj = ref_glove._glove_dense_step_impl(
                ref_glove._DIRECT, sj0, *grids, **HP,
                compute_dtype="bfloat16")
    lim = BF16_REL if jit else BF16_EAGER_REL
    lt = port_glove._glove_dense_step(st, head, **HP, cdt=torch.bfloat16)
    np.testing.assert_allclose(float(lt), float(lj), rtol=lim)
    for name, a, b, t0 in zip(port_glove.GloveState._fields, st, sj, before):
        dp, dj = a.double() - t0.double(), np.asarray(b, np.float64) - \
            t0.double().numpy()
        rel = float(np.abs(dp.numpy() - dj).max() / np.abs(dj).max())
        assert rel < lim, (name, rel)
    # the cells that round apart: XLA's and torch's f32 log, pow and dot
    # differ in the last bits, so a few S (and cost) land on either side of
    # a bf16 rounding point
    sj_c, cj = _bf16_cost_reference(X, hot, [np.asarray(t) for t in before])
    ti, tj, bi, bj = (t[torch.from_numpy(hot).long()] for t in before[:4])
    xt = head.x.float()
    lx = torch.log(torch.where(xt > 0, xt, 1.0))
    w = torch.where(xt > 0, torch.where(xt < 10.0, torch.pow(xt / 10.0, 0.75),
                                        1.0), 0.0)
    rd = lambda t: t.bfloat16().float()  # noqa: E731
    s = torch.clamp(rd(ti) @ rd(tj).T + bi[:, None] + bj[None, :] - lx, -100,
                    100)
    apart_s = int((rd(s).numpy() != sj_c).sum())
    apart_cost = int((rd(rd(w) * rd(s)).numpy() != cj).sum())
    assert apart_s <= 0.01 * H * H and apart_cost <= apart_s, \
        (apart_s, apart_cost)


def _bf16_cost_reference(X, hot, state):
    """The reference's s_c and cost_c of one bf16 tile
    (rsparse_tpu/models/glove.py:240-254), as float32."""
    bf, f32 = jnp.bfloat16, jnp.float32
    x = jnp.asarray(X, bf).astype(f32)
    present = x > 0
    lx = jnp.log(jnp.where(present, x, 1.0))
    w = jnp.where(present, jnp.where(x < 10.0, jnp.power(x / 10.0, 0.75),
                                     1.0), 0.0)
    wi, wj, bi, bj = (jnp.asarray(t[hot]) for t in state[:4])
    s = jnp.clip(jnp.dot(wi.astype(bf), wj.astype(bf).T,
                         preferred_element_type=f32)
                 + bi[:, None] + bj[None, :] - lx, -100.0, 100.0)
    s_c = s.astype(bf)
    return (np.asarray(s_c, np.float32),
            np.asarray(w.astype(bf) * s_c, np.float32))


def _fit_pair(x, n_iter=4, tol=-1.0, **kw):
    kw = dict(dict(rank=4, x_max=10.0, learning_rate=0.05, batch_size=64,
                   precision="double", seed=3), **kw)
    mj = rt_ref.GloVe(**kw)
    ej = mj.fit_transform(x, n_iter=n_iter, convergence_tol=tol)
    mt = rt.GloVe(**kw, device="cpu")
    et = mt.fit_transform(x, n_iter=n_iter, convergence_tol=tol)
    return mj, np.asarray(ej), mt, et


def _assert_fit(mj, ej, mt, et):
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=TOL)
    np.testing.assert_allclose(mt.components, np.asarray(mj.components),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(mt.bias_i, np.asarray(mj.bias_i), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(mt.bias_j, np.asarray(mj.bias_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(mt.cost_history, mj.cost_history, rtol=0,
                               atol=TOL)
    assert mt.get_history() == {"cost_history": mt.cost_history}


@pytest.mark.parametrize("case", ["tail_only", "head_and_tail", "head_only",
                                  "triangular", "early_stop"])
def test_fit_matches_reference(case):
    x = _cooc(150, 0.1, 7, scale=3.0)
    kw = {"tail_only": dict(n_hot=0), "head_and_tail": dict(n_hot=32),
          "head_only": dict(n_hot="auto"), "triangular": dict(n_hot=32),
          "early_stop": dict(n_hot=32)}[case]
    if case == "triangular":
        x = sp.triu(x + x.T).tocoo()
    tol = 0.3 if case == "early_stop" else -1.0
    mj, ej, mt, et = _fit_pair(x, n_iter=12 if tol > 0 else 4, tol=tol, **kw)
    if case == "early_stop":
        assert len(mt.cost_history) < 12
    _assert_fit(mj, ej, mt, et)


def test_init_and_reference_layout():
    """A warm init in both layouts (the (rank, n) one transposed)."""
    n, k = 40, 3
    rng = np.random.default_rng(8)
    init = {"w_i": rng.uniform(-0.5, 0.5, (n, k)),
            "w_j": rng.uniform(-0.5, 0.5, (k, n)),
            "b_i": rng.uniform(-0.5, 0.5, n)}
    x = _cooc(n, 0.3, 9, scale=3.0)
    mj, ej, mt, et = _fit_pair(x, n_iter=2, rank=k, n_hot=0, init=init)
    _assert_fit(mj, ej, mt, et)
    with pytest.raises(ValueError, match="wrong shape"):
        rt.GloVe(rank=k, x_max=10, init={"b_j": np.zeros(3)},
                 device="cpu").fit_transform(x)


def test_per_sample_replica(glove_problem):  # noqa: F811
    """batch_size=1: each shard is one triplet, the accumulator-first
    per-sample loop (tests/test_sgd_replica.py)."""
    coo, init = glove_problem
    g = rt.GloVe(rank=4, x_max=10.0, learning_rate=0.05, batch_size=1,
                 precision="double", n_hot=0, seed=0,
                 init={k: v.copy() for k, v in init.items()}, device="cpu")
    emb = g.fit_transform(coo, n_iter=3)
    w_i, w_j, b_i, b_j, costs = _glove_replica(coo, init, 10.0, 0.75, 0.05,
                                               3, ordering="batched")
    np.testing.assert_allclose(emb.numpy(), w_i, rtol=0, atol=TOL)
    np.testing.assert_allclose(g.components.T, w_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(g.bias_i, b_i, rtol=0, atol=TOL)
    np.testing.assert_allclose(g.bias_j, b_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(g.cost_history, costs, rtol=0, atol=TOL)


def test_shuffled_epoch_matches_reference():
    """The reference's permutation injected: the same shuffled shards, then
    an epoch on each side; maps left from before the shuffle would give
    other sums."""
    n, r, seed = 60, 5, 1234
    coo = _cooc(n, 0.3, 11)
    host = ref_glove._stack_coo_host(coo, 200)
    key = jax.random.PRNGKey(seed)
    jsh = ref_glove._shuffle_shards(*(jnp.asarray(a) for a in host), key)
    perm = np.asarray(jax.random.permutation(key, host[0].size))
    shards = _port_shards(host)
    shuffled = port_glove._shuffle_shards(shards, perm=torch.tensor(perm))
    for a, b in zip(shuffled[:4], jsh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sj, st = _states(n, r, 12)
    _, st_stale = _states(n, r, 12)
    sj, lj = ref_glove._glove_epoch(sj, *jsh, **HP)
    lt = port_glove._glove_epoch(st, shuffled, **HP)
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    _assert_state(sj, st)
    stale = shuffled._replace(maps_r=shards.maps_r, maps_c=shards.maps_c)
    port_glove._glove_epoch(st_stale, stale, **HP)
    assert not np.allclose(st_stale.w_i.numpy(), np.asarray(sj.w_i))


def test_shuffle_reproducible_by_seed():
    """Same seed, same device-side shuffles, same fit; another seed, another
    fit (tests/test_edge_cases.py:69)."""
    m = _cooc(50, 0.3, 0, scale=1.0)
    kw = dict(rank=4, x_max=5, shuffle=True, batch_size=128, device="cpu")
    ea = rt.GloVe(**kw, seed=7).fit_transform(m, n_iter=3)
    eb = rt.GloVe(**kw, seed=7).fit_transform(m, n_iter=3)
    torch.testing.assert_close(ea, eb, rtol=0, atol=0)
    ec = rt.GloVe(**kw, seed=8).fit_transform(m, n_iter=3)
    assert not torch.allclose(ea, ec)


def test_guards():
    with pytest.raises(ValueError, match="square"):
        rt.GloVe(rank=4, x_max=10, device="cpu").fit_transform(
            sp.random(5, 6, density=0.5, format="coo"))
    bad = _cooc(10, 0.5, 1)
    bad.data[0] = -1.0
    with pytest.raises(ValueError, match="> 0"):
        rt.GloVe(rank=4, x_max=10, device="cpu").fit_transform(bad)
    m = sp.random(40, 40, density=0.3, random_state=np.random.RandomState(1))
    m.data = np.abs(m.data) + 1
    with pytest.raises(FloatingPointError):
        rt.GloVe(rank=4, x_max=10, learning_rate=500.0, seed=0,
                 device="cpu").fit_transform(m.tocoo(), n_iter=5)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        rt.GloVe(rank=4, x_max=10, mesh=object(), device="cpu")
    assert rt.GloVe(rank=4, x_max=10).device.type == "cuda"


def test_convert_carries_the_reference():
    """glove_state_from_numpy / glove_from_numpy on a fitted reference."""
    x = _cooc(80, 0.2, 13)
    kw = dict(rank=4, x_max=10.0, batch_size=64, precision="double", seed=1,
              n_hot=0)
    mj = rt_ref.GloVe(**kw)
    ej = np.asarray(mj.fit_transform(x, n_iter=2))
    st = glove_state_from_numpy([np.asarray(a) for a in mj._state],
                                "double", "cpu")
    for name, a, b in zip(port_glove.GloveState._fields, st, mj._state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    mc = glove_from_numpy(ej, np.asarray(mj.components).T, mj.bias_i,
                          mj.bias_j, x_max=10.0, precision="double",
                          device="cpu")
    assert mc.rank == 4
    np.testing.assert_array_equal(mc._state.w_i.numpy(), ej)
    np.testing.assert_array_equal(mc.components, np.asarray(mj.components))
    np.testing.assert_array_equal(mc.bias_j, np.asarray(mj.bias_j))
    with pytest.raises(ValueError):
        glove_state_from_numpy([ej], "double", "cpu")
    with pytest.raises(ValueError):
        glove_from_numpy(ej, np.asarray(mj.components), mj.bias_i, mj.bias_j,
                         x_max=10.0, device="cpu")


def test_reference_cost_history():
    """``chip_smoke.REF_GLOVE["ml100k"]``, the cost history that
    chip_smoke.py phase 8 (b) holds the port to on the card, is the JAX
    package's (float32 state, bf16 head) on the same input and model."""
    import chip_smoke
    x = chip_smoke.ml100k_cooccurrence(rt_ref.load_movielens100k())
    m = rt_ref.GloVe(**chip_smoke.GLOVE_KW)
    m.fit_transform(x, n_iter=3)
    np.testing.assert_allclose(m.cost_history, chip_smoke.REF_GLOVE["ml100k"],
                               rtol=1e-6)
