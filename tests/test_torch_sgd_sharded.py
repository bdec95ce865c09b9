"""The port's SGD family on a mesh of processes
(``rsparse_tpu_torch/parallel/sgd_sharded.py``).

Two and four gloo ranks are spawned once each with ``torch.multiprocessing``
(``tests/torch_mesh_worker.py`` ``sgd_case``): two on a ``("data",)`` mesh,
four on a ``("dcn", "ici")`` = (2, 2) mesh, so the tables shard over both
axes.  Every rank runs FTRL, FM, RankMF and GloVe at the sizes of
tests/test_sgd_sharded.py with their state tables row-sharded, and this
process holds them:

- to the port's one-process fit of the same settings: FTRL, FM and GloVe
  bit for bit (the gather sums bit patterns, the plain versions add in the
  one-process order), RankMF within 1e-6 (the JAX package's mesh tests'
  limit; on the CPU it reads 0); GloVe (with and without the shuffle) and
  two RankMF settings also at ``precision="bfloat16"``, bit for bit (the
  gather sums a bf16 table's bytes);
- to the JAX package's mesh fit on its 8 virtual CPU devices, at float64
  from the same weights carried across by ``convert``, with no dropout, no
  shuffle and, for RankMF, the JAX package's own bits: 1e-10, the port's
  one-process parity tests' limit;
- every rank to every other, bit for bit, and each rank to its share of
  the rows (``padded_rows / world``);
- ``ShardedOps`` to ``DirectOps``; dumps and checkpoints to one process.

The JAX fits and the one-process fits run here while the ranks work.
Each test reads both worlds: the file holds 19 tests on purpose, so that
``--dist loadfile`` (which queues files by test count, then name) queues
it after the 20-test files, leaving the suite's longest files where they
were (see the verify notes).
"""

import time

import numpy as np
import pytest
import torch.multiprocessing as mp

import rsparse_tpu_torch as rt
import torch_mesh_worker as W

WORLDS = (2, 4)
JOIN_S = 300
#: the JAX package's mesh fits against the port's (float64)
JAX_TOL = 1e-10
#: a RankMF mesh fit against the one-process fit (tests/test_sgd_sharded.py)
RANKMF_TOL = 1e-6
BITWISE = ("ftrl", "fm", "glove", "glove_shuffle", "glove_small")


def _jax_bits(kw, n_user, n_item, n_iter):
    """The JAX package's sampling bits of ``partial_fit_transform``: one
    (S, K + 2) uint32 array a batch, from its key schedule
    (rsparse_tpu/models/rankmf.py: a split of the model key a chunk of 8
    batches, a key a batch)."""
    import jax
    import jax.numpy as jnp
    S = min(kw["batch_size"], max(n_user, 8))
    K = min(kw["max_negative_samples"], n_item)
    n_batches = max(n_iter * n_user // S, 1)
    key = jax.random.PRNGKey(kw["seed"])
    out = []
    for _ in range(-(-n_batches // 8)):
        key, sub = jax.random.split(key)
        for k in jax.random.split(sub, 8):
            out.append(np.asarray(jax.random.bits(k, (S, K + 2),
                                                  jnp.uint32)))
    return np.stack(out)


def _one_process(x, y):
    """The port's one-process fits of the ranks' seeded settings."""
    out = {}
    m = rt.FTRL(device="cpu", **W.SGD_FTRL)
    out["ftrl_fit"] = m.fit(x, y, n_iter=2)
    out["ftrl_pred"] = m.predict(x)
    out["ftrl_z"], out["ftrl_n"] = m.z.numpy(), m.n.numpy()
    out["ftrl_coef"] = m.coef()
    m = rt.FactorizationMachine(device="cpu", **W.SGD_FM)
    out["fm_fit"] = m.fit(x, y, n_iter=2)
    out["fm_pred"] = m.predict(x)
    for k in ("w", "v", "acc_w", "acc_v"):
        out[f"fm_{k}"] = getattr(m, k).numpy()
    out["fm_w0"] = m.w0.numpy()
    xi = W.sgd_interactions()
    uf, itf = W.sgd_side_features()
    for name, kw in W.SGD_RANKMF.items():
        feats = (dict(user_features=uf, item_features=itf)
                 if name == "side" else {})
        if name in W.SGD_RANKMF_BF16:
            b = rt.RankMF(device="cpu", **dict(kw, precision="bfloat16"))
            emb = b.partial_fit_transform(
                xi, n_iter=W.SGD_RANKMF_ITER[name], **feats)
            out.update(W.rankmf_bf16_outputs(name, b, emb, xi))
        m = rt.RankMF(device="cpu", **kw)
        emb = m.partial_fit_transform(xi, n_iter=W.SGD_RANKMF_ITER[name],
                                      **feats)
        out[f"rankmf_{name}_emb"] = np.asarray(emb)
        out[f"rankmf_{name}_comps"] = m.components
        out[f"rankmf_{name}_T"] = np.asarray(m.transform(xi))
        out[f"rankmf_{name}_auc"] = np.asarray(m.auc_history)
    for name, kw, coo, it in (
            ("glove", W.SGD_GLOVE, W.sgd_cooc(), 3),
            ("glove_shuffle", dict(W.SGD_GLOVE, shuffle=True), W.sgd_cooc(),
             3),
            ("glove_small", W.SGD_GLOVE_SMALL, W.sgd_cooc_small(), 2),
            *W.GLOVE_BF16):
        m = rt.GloVe(device="cpu", **kw)
        out[f"{name}_emb"] = W.host(m.fit_transform(coo, n_iter=it))
        out[f"{name}_comps"] = m.components
        out[f"{name}_bias_i"], out[f"{name}_bias_j"] = m.bias_i, m.bias_j
        out[f"{name}_cost"] = np.asarray(m.cost_history)
    return out


def _jax_mesh(x, y):
    """The JAX package's mesh fits (all 8 virtual CPU devices, float64)
    from the weights the ranks carry across (``*_ref``)."""
    import jax.numpy as jnp
    import rsparse_tpu as rj
    from rsparse_tpu.parallel.mesh import make_mesh
    from rsparse_tpu.parallel.sgd_sharded import (replicate_on, shard_table,
                                                  unshard)
    mesh = make_mesh()
    w = W.sgd_weights()
    out = {}
    m = rj.FTRL(mesh=mesh, **W.SGD_FTRL_REF)
    m.n_features = x.shape[1]
    m.z, m.n = (shard_table(jnp.asarray(a), mesh) for a in w["ftrl"])
    out["ftrl_ref_fit"] = m.fit(x, y, n_iter=2)
    out["ftrl_ref_z"] = unshard(m.z, x.shape[1] + 1)
    out["ftrl_ref_n"] = unshard(m.n, x.shape[1] + 1)
    w0, aw0, *tabs = w["fm"]
    m = rj.FactorizationMachine(precision="double", **W.SGD_FM, mesh=mesh)
    m.n_features = x.shape[1]
    m.w0, m.acc_w0 = replicate_on(mesh, (jnp.asarray(w0), jnp.asarray(aw0)))
    m.w, m.v, m.acc_w, m.acc_v = (shard_table(jnp.asarray(a), mesh)
                                  for a in tabs)
    out["fm_ref_fit"] = m.fit(x, y, n_iter=2)
    out["fm_ref_v"] = unshard(m.v, x.shape[1] + 1)
    xi = W.sgd_interactions()
    uf, itf = W.sgd_side_features()
    for name, wk, feats in (("warp", "rankmf", {}),
                            ("side", "rankmf_side",
                             dict(user_features=uf, item_features=itf))):
        m = rj.RankMF(precision="double", mesh=mesh, **W.SGD_RANKMF[name])
        (m.user_features_embeddings, m.item_features_embeddings, m._accW,
         m._accH) = (shard_table(jnp.asarray(a), mesh) for a in w[wk])
        emb = m.partial_fit_transform(xi, n_iter=W.SGD_RANKMF_ITER[name],
                                      **feats)
        out[f"rankmf_ref_{name}_emb"] = np.asarray(emb)
        out[f"rankmf_ref_{name}_comps"] = np.asarray(m.components)
        out[f"rankmf_ref_{name}_auc"] = np.asarray(m.auc_history)
    m = rj.GloVe(precision="double", mesh=mesh,
                 **dict(W.SGD_GLOVE, init=w["glove"]))
    out["glove_ref_emb"] = np.asarray(m.fit_transform(W.sgd_cooc(),
                                                      n_iter=3))
    out["glove_ref_comps"] = np.asarray(m.components)
    out["glove_ref_bias_i"] = np.asarray(m.bias_i)
    out["glove_ref_bias_j"] = np.asarray(m.bias_j)
    out["glove_ref_cost"] = np.asarray(m.cost_history)
    return out


def _join(ctx, deadline):
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks still running after "
                                   f"{JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn both worlds, fit here meanwhile, then read every rank's
    results: {"ranks": {world: [rank 0's, ...]}, "one": ..., "jax": ...}."""
    root = tmp_path_factory.mktemp("sgd_mesh")
    xi = W.sgd_interactions()
    np.savez(root / "rankmf_bits.npz", **{
        name: _jax_bits(W.SGD_RANKMF[name], xi.shape[0], xi.shape[1],
                        W.SGD_RANKMF_ITER[name])
        for name in ("warp", "side")})
    spawned = []
    for world in WORLDS:
        d = root / f"world{world}"
        d.mkdir()
        ctx = mp.start_processes(
            W.run, args=(world, str(d / "store"), str(d), ("sgd",)),
            nprocs=world, join=False, start_method="spawn")
        spawned.append((world, d, ctx))
    deadline = time.monotonic() + JOIN_S
    try:
        x, y = W.sgd_glm()
        one = _one_process(x, y)
        jax_fits = _jax_mesh(x, y)
    finally:
        for _, _, ctx in spawned:
            _join(ctx, deadline)
    ranks = {world: [dict(np.load(d / f"sgd.{r}.npz"))
                     for r in range(world)] for world, d, _ in spawned}
    return dict(ranks=ranks, one=one, jax=jax_fits, x=x, y=y, root=root)


def _every_rank(runs):
    """(world, one rank's results) over every rank of both worlds."""
    return [(w, r) for w in WORLDS for r in runs["ranks"][w]]


def _keys(out, prefix):
    return [k for k in out if k.startswith(prefix + "_")
            and not k.endswith(("_rows", "_draws", "_ckpt"))]


def test_sharded_ops_match_direct_ops(runs):
    """gather, gather_many (a float32 and a float64 table: one all-reduce
    of their bytes), scatter_add, add_dense, add_dense_cols and put on the
    row shards of a 43-row table, unsharded, equal DirectOps' on the whole
    table; the padding rows stay zero."""
    for world, r in _every_rank(runs):
        for op in ("gather", "gm0", "gm1", "scatter", "dense", "cols",
                   "put"):
            np.testing.assert_array_equal(r[f"sharded_{op}"],
                                          r[f"direct_{op}"], err_msg=op)
        assert int(r["shard_rows"]) == -(-43 // world)  # padded to world
        assert float(r["pad_rows"]) == 0.0


@pytest.mark.parametrize("model", BITWISE)
def test_mesh_fit_is_the_one_process_fit(runs, model):
    """FTRL (with dropout), FM and GloVe (with and without the shuffle, at
    float32 and at bfloat16: the ``glove`` case reads every ``glove_*``
    key) fitted on the mesh equal the one-process fit bit for bit:
    predictions, tables, embeddings, biases, cost history; on every
    rank."""
    one = runs["one"]
    for _, r in _every_rank(runs):
        keys = _keys(one, model)
        assert keys
        for k in keys:
            np.testing.assert_array_equal(r[k], one[k], err_msg=k)


@pytest.mark.parametrize("name", list(W.SGD_RANKMF))
def test_rankmf_mesh_fit_matches_one_process(runs, name):
    """RankMF (WARP + AdaGrad, BPR + RMSprop, side features) on the mesh,
    K9's row-map mode in its plain version, against the one-process fit:
    the embeddings, components and transform within 1e-6, the AUC
    counters equal; at ``precision="bfloat16"`` (WARP, side features; the
    bf16 plain version's ordered adds) bit for bit, every table bf16."""
    one = runs["one"]
    for _, r in _every_rank(runs):
        for k in (k for k in one if k.startswith(f"rankmf_bf16_{name}_")):
            np.testing.assert_array_equal(r[k], one[k], err_msg=k)
        if name in W.SGD_RANKMF_BF16:
            assert bool(r[f"rankmf_bf16_{name}_bf16"])
        for k in ("emb", "comps", "T"):
            np.testing.assert_allclose(r[f"rankmf_{name}_{k}"],
                                       one[f"rankmf_{name}_{k}"], rtol=0,
                                       atol=RANKMF_TOL)
        np.testing.assert_array_equal(r[f"rankmf_{name}_auc"],
                                      one[f"rankmf_{name}_auc"])


@pytest.mark.parametrize("model", ["ftrl_ref", "fm_ref", "rankmf_ref_warp",
                                   "rankmf_ref_side", "glove_ref"])
def test_mesh_fit_matches_jax_mesh(runs, model):
    """The port's mesh fit against the JAX package's on its 8 virtual CPU
    devices, at float64 from the same carried weights (RankMF with the JAX
    package's bits, no dropout, no shuffle)."""
    ref = runs["jax"]
    keys = [k for k in ref if k.startswith(model + "_")]
    assert keys
    for world in WORLDS:
        r = runs["ranks"][world][0]
        for k in keys:
            np.testing.assert_allclose(
                r[k], ref[k], rtol=0,
                atol=JAX_TOL * max(np.abs(ref[k]).max(), 1.0),
                err_msg=f"{k}, {world} ranks")


def test_ranks_draw_the_same_bits(runs):
    """Every rank draws the same dropout masks, sampling bits and shuffles
    (each fit checks its draws' checksum over the ranks) and ends on the
    same outputs; ranks seeded apart are refused."""
    for world, r in _every_rank(runs):
        got = runs["ranks"][world]
        for k in ("ftrl_draws", "rankmf_warp_draws", "rankmf_bpr_draws",
                  "rankmf_side_draws", "glove_shuffle_draws"):
            assert int(r[k]) >= 1, k
        assert bool(r["draws_apart_refused"])
        for k in got[0]:
            np.testing.assert_array_equal(r[k], got[0][k], err_msg=k)


def test_each_rank_holds_its_row_shard(runs):
    """During and after a fit each rank holds padded_rows / world rows of
    every state table: FTRL's (F + 1, 2) pairs, FM's four tables, RankMF's
    feature tables and accumulators, GloVe's eight tables."""
    uf, itf = W.sgd_side_features()
    for world, r in _every_rank(runs):
        per = lambda n: -(-n // world)  # noqa: E731  (padded_rows / world)
        assert int(r["ftrl_rows"]) == per(81)
        assert r["fm_rows"].tolist() == [per(81)] * 2
        for name in ("warp", "bpr"):
            assert r[f"rankmf_{name}_rows"].tolist() == [
                per(120), per(120), per(60), per(60)]
        assert r["rankmf_side_rows"].tolist() == [
            per(uf.shape[1]), per(uf.shape[1]), per(itf.shape[1]),
            per(itf.shape[1])]
        for name in ("glove", "glove_shuffle", "glove_ref"):
            assert r[f"{name}_rows"].tolist() == [per(100)] * 8
        assert r["glove_small_rows"].tolist() == [per(40)] * 8


@pytest.mark.parametrize("world", WORLDS)
def test_dumps_and_checkpoints_are_mesh_independent(runs, world):
    """A dump and a checkpoint of a mesh fit hold the whole, unpadded
    tables (rank 0 writes, ``mesh`` None) and load in one process to the
    mesh's predictions; loaded back onto the mesh (``load(...,
    sharding=)``, ``FTRL.load(..., mesh=)``) they predict the same."""
    import json
    r = runs["ranks"][world][0]
    x = runs["x"]
    d = runs["root"] / f"world{world}"
    assert len(r["ftrl_dump_z"]) == x.shape[1] + 1
    np.testing.assert_array_equal(r["ftrl_dump_z"], r["ftrl_z"])
    np.testing.assert_array_equal(r["ftrl_dumpload_pred"], r["ftrl_pred"])
    for name in ("ftrl", "fm", "rankmf", "glove"):
        with open(d / f"{name}_ckpt" / "meta.json") as f:
            assert json.load(f)["mesh"] is None
    m = rt.checkpoint.load(str(d / "ftrl_ckpt"), device="cpu")
    assert m.mesh is None and m.zn.shape == (x.shape[1] + 1, 2)
    np.testing.assert_array_equal(m.predict(x), r["ftrl_pred"])
    np.testing.assert_array_equal(r["ftrl_load_pred"], r["ftrl_pred"])
    assert int(r["ftrl_load_rows"]) == int(r["ftrl_rows"])
    m = rt.checkpoint.load(str(d / "fm_ckpt"), device="cpu")
    assert m.v.shape == (x.shape[1] + 1, 4)
    np.testing.assert_array_equal(m.predict(x), r["fm_pred"])
    np.testing.assert_array_equal(r["fm_load_pred"], r["fm_pred"])
    m = rt.checkpoint.load(str(d / "rankmf_ckpt"), device="cpu")
    np.testing.assert_array_equal(m.components, r["rankmf_warp_comps"])
    np.testing.assert_array_equal(r["rankmf_load_comps"],
                                  r["rankmf_warp_comps"])
    m = rt.checkpoint.load(str(d / "glove_ckpt"), device="cpu")
    np.testing.assert_array_equal(m.components, r["glove_comps"])
    np.testing.assert_array_equal(m.bias_i, r["glove_bias_i"])


def test_convert_shards_what_it_carries(runs):
    """``convert.glove_from_numpy(..., mesh=)`` row-shards the carried
    state (each rank its rows, equal to the fitted model's shards) and
    keeps the whole components."""
    for world, r in _every_rank(runs):
        assert bool(r["glove_convert_same"])
        assert int(r["glove_convert_rows"]) == -(-100 // world)
        np.testing.assert_array_equal(r["glove_convert_comps"],
                                      r["glove_comps"])
