"""The port's WRMF on a mesh of processes (``rsparse_tpu_torch/parallel/``).

Two and four gloo ranks are spawned with ``torch.multiprocessing``
(``tests/torch_mesh_worker.py``) on a ``file://`` store under a temporary
directory (the suite's xdist workers would collide on a fixed TCP port).
Every rank fits ML-100k at rank 8 and float64 on its mesh, the plain
``(2, 1)``, ``(1, 2)`` and ``(2, 2)`` ``("data", "model")`` meshes, the
routed ALX sweeps (padded and ragged) and ``("dcn", "ici")`` meshes, and
this process holds each fit to the port's one-process fit (1e-9, as
tests/test_multihost.py holds the JAX package) and some to the JAX
package's mesh fits on its virtual CPU devices (1e-9); those run here
while the ranks work.  Every rank must hold the same tables, bit for bit.
"""

import math
import os
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

import rsparse_tpu_torch as rt
import torch_mesh_worker as W

#: cases each world size runs, in one spawn each
WORLDS = {
    2: ("data2_cg_head", "data2_chol", "model2_cg", "model2_chol_head",
        "alx_cg", "alx_nnls", "ragged_cg", "ragged_nnls", "dcn_chol",
        "dcn_alx", "retrieval", "checkpoint", "mesh_load", "exchange"),
    4: ("mesh22_cg_head", "mesh22_chol", "alx4_chol", "step", "exchange"),
}
FIT_CASES = [c for cases in WORLDS.values() for c in cases if c in W.CASES]
#: fits also run by the JAX package on its mesh of virtual CPU devices
JAX_CASES = ("mesh22_cg_head", "mesh22_chol", "alx_nnls")
JOIN_S = 300
RTOL = 1e-9


def _jax_fit(case, x):
    import jax
    from rsparse_tpu import WRMF
    from rsparse_tpu.parallel.mesh import make_mesh
    shape, names, kw = W.CASES[case]
    mesh = make_mesh(shape, names, jax.devices()[:math.prod(shape)])
    m = WRMF(mesh=mesh, **W.FIT, **kw)
    emb = m.fit_transform(x, n_iter=W.N_ITER, convergence_tol=-1)
    return dict(U=np.asarray(emb), V=np.asarray(m._V),
                loss=np.asarray(m.loss_history))


def _one_process(kw, x):
    kw = {k: v for k, v in kw.items() if k != "routing"}
    m = rt.WRMF(device="cpu", **W.FIT, **kw)
    emb = m.fit_transform(x, n_iter=W.N_ITER, convergence_tol=-1)
    return dict(U=emb.numpy(), V=m._V.numpy(), loss=np.asarray(
        m.loss_history), T=m.transform(x[:200]).numpy(),
        pred_i=m.predict(x[:300], k=10).indices)


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
    """Spawn both worlds, run the JAX and one-process fits here meanwhile,
    then read every rank's results: {case: [rank 0's, rank 1's, ...]}."""
    root = tmp_path_factory.mktemp("mesh")
    spawned = []
    for world, cases in WORLDS.items():
        d = root / f"world{world}"
        d.mkdir()
        ctx = mp.start_processes(
            W.run, args=(world, str(d / "store"), str(d), cases),
            nprocs=world, join=False, start_method="spawn")
        spawned.append((world, d, cases, ctx))
    deadline = time.monotonic() + JOIN_S
    try:
        x = W.data()
        jax_fits = {c: _jax_fit(c, x) for c in JAX_CASES}
        single = {}
        for c in FIT_CASES:
            key = tuple(sorted((k, v) for k, v in W.CASES[c][2].items()
                               if k != "routing"))
            if key not in single:
                single[key] = _one_process(W.CASES[c][2], x)
        one = {c: single[tuple(sorted(
            (k, v) for k, v in W.CASES[c][2].items() if k != "routing"))]
            for c in FIT_CASES}
    finally:
        for _, _, _, ctx in spawned:
            _join(ctx, deadline)
    ranks = {(c, world) if c == "exchange" else c:
             [dict(np.load(d / f"{c}.{r}.npz")) for r in range(world)]
             for world, d, cases, _ in spawned for c in cases}
    model_dir = str(root / "world2" / "model")
    return dict(ranks=ranks, one=one, jax=jax_fits, x=x,
                model_dir=model_dir)


@pytest.mark.parametrize("case", FIT_CASES)
def test_mesh_fit_matches_one_process(runs, case):
    """Embeddings, item factors, loss history, transform and predict of a
    mesh fit against the port's one-process fit; every rank the same."""
    got = runs["ranks"][case]
    ref = runs["one"][case]
    for r in got[1:]:
        for k in ("U", "V", "loss", "T", "pred_i", "pred_s"):
            assert np.array_equal(r[k], got[0][k]), (case, k)
    g = got[0]
    for k in ("U", "V", "T"):
        np.testing.assert_allclose(g[k], ref[k], rtol=RTOL,
                                   atol=RTOL * np.abs(ref[k]).max())
    np.testing.assert_allclose(g["loss"], ref["loss"], rtol=RTOL)
    np.testing.assert_array_equal(g["pred_i"], ref["pred_i"])
    if W.CASES[case][2].get("solver") == "nnls":
        assert (g["U"] >= 0).all() and (g["V"] >= 0).all()


@pytest.mark.parametrize("case", [c for c in FIT_CASES
                                  if "routing" in W.CASES[c][2]])
def test_exchange_bytes_match_wire_cost_report(runs, case):
    """Every routed exchange of a fit, its transforms and predict: the
    bytes the ranks sent to one another sum to ``wire_cost_report*``'s
    ``routed_total_bytes`` for the plan (the padded exchange's requests
    included)."""
    got = runs["ranks"][case]
    sent = sum(r["sent"] for r in got)
    assert len(sent) == 2 * W.N_ITER + 3    # sweeps, closing, 2 transforms
    np.testing.assert_array_equal(sent, got[0]["wire"])


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_fit_matches_jax_mesh(runs, case):
    """The port's mesh fit against the JAX package's on a mesh of the same
    shape over its virtual CPU devices."""
    g, ref = runs["ranks"][case][0], runs["jax"][case]
    for k in ("U", "V"):
        np.testing.assert_allclose(g[k], ref[k], rtol=RTOL,
                                   atol=RTOL * np.abs(ref[k]).max())
    np.testing.assert_allclose(g["loss"], ref["loss"], rtol=RTOL)


@pytest.mark.parametrize("tag", ["mask", "none", "excl", "predict", "sim",
                                 "k_dense", "k_bits"])
def test_sharded_retrieval_matches_top_product(runs, tag):
    """sharded_top_product (training mask, none, item excludes), predict
    and get_similar_items of a mesh-fitted model, and sharded_top_k with a
    dense mask and with packed bits: the indices of the one-process
    ``top_product`` on the same inputs, in its tie order, on every rank.
    The scores agree to float32 rounding: a rank's scoring matmul is
    narrower than one process's, and the CPU's BLAS blocks them apart."""
    got = runs["ranks"]["retrieval"]
    ref = "k_ref" if tag.startswith("k_") else f"{tag}_ref"
    for r in got:
        np.testing.assert_array_equal(r[f"{tag}_i"], got[0][f"{ref}_i"])
    if tag != "sim":
        np.testing.assert_allclose(got[0][f"{tag}_s"], got[0][f"{ref}_s"],
                                   rtol=1e-6)


def test_train_step_matches_one_process(runs):
    """``shard_problem`` + ``train_step`` on a (2, 2) mesh (tables
    row-sharded over ``model``) against one process's two half-sweeps."""
    for r in runs["ranks"]["step"]:
        assert int(r["shard_rows"]) == 64          # 128 users over 2
        for k in ("U", "V", "loss"):
            np.testing.assert_allclose(r[f"{k}2"], r[f"{k}1"], rtol=1e-12,
                                       atol=1e-15)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_routed_exchange_matches_global_gather(runs, world):
    """Each rank's cache from the padded and the ragged exchange, read
    through its remapped ids, is the global gather of the rows it
    references."""
    for r in runs["ranks"][("exchange", world)]:
        np.testing.assert_array_equal(r["padded"], r["want"])
        np.testing.assert_array_equal(r["ragged"], r["want"])


def test_mesh_resume_is_bitwise_the_uninterrupted_fit(runs):
    """A mesh fit stopped after 1 of 3 iterations and resumed from the
    state rank 0 wrote ends on the uninterrupted mesh fit, bit for bit."""
    for r in runs["ranks"]["checkpoint"]:
        for k in ("U", "V", "loss"):
            assert np.array_equal(r[k], r[f"{k}_res"]), k


def test_mesh_checkpoint_loads_in_one_process(runs):
    """The model rank 0 saved (the JAX package's npz layout, mesh and
    routing None) loads in one process and predicts what the mesh did."""
    import json
    with open(os.path.join(runs["model_dir"], "meta.json")) as f:
        meta = json.load(f)
    assert meta["mesh"] is None and meta["routing"] is None
    m = rt.checkpoint.load(runs["model_dir"], device="cpu")
    g = runs["ranks"]["checkpoint"][0]
    assert m.mesh is None and np.array_equal(m._V.numpy(), g["V"])
    p = m.predict(runs["x"][:300], k=10)
    np.testing.assert_array_equal(p.indices, g["pred_i"])
    np.testing.assert_array_equal(p.scores, g["pred_s"])


def test_mesh_load_keeps_the_tables_whole(runs):
    """``load(..., sharding=)`` onto a (1, 2) mesh, whose model axis
    divides the rows: every rank holds the whole tables, as a fit on that
    mesh ends, predicts what the one-process load does, and a save from
    the mesh writes the whole tables again."""
    flat = rt.checkpoint.load(runs["model_dir"], device="cpu")
    p = flat.predict(runs["x"][:300], k=10)
    V = flat._V.numpy()
    assert V.shape[0] % 2 == 0
    for r in runs["ranks"]["mesh_load"]:
        assert r["on_mesh"]
        np.testing.assert_array_equal(r["U"], flat._U.numpy())
        np.testing.assert_array_equal(r["V"], V)
        np.testing.assert_array_equal(r["pred_i"], p.indices)
        np.testing.assert_allclose(r["pred_s"], p.scores, rtol=1e-12)
        assert r["V_again"].shape == V.shape
        np.testing.assert_array_equal(r["V_again"], V)
        np.testing.assert_array_equal(r["comps_again"],
                                      np.asarray(flat.components))


def test_every_rank_holds_the_whole_tables(runs):
    """The returned embeddings and item factors are whole on every rank of
    every mesh (the model axis' shards are all-gathered at the end)."""
    x = runs["x"]
    for case in FIT_CASES:
        for r in runs["ranks"][case]:
            assert r["U"].shape == (x.shape[0], W.FIT["rank"]), case
            assert r["V"].shape == (x.shape[1], W.FIT["rank"]), case
            assert np.isfinite(r["U"]).all() and np.isfinite(r["V"]).all()


# -- bring-up in the reference's keywords (in this process, one gloo rank) ---

def _free_tcp_address() -> str:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


@pytest.mark.parametrize("spelling", ["port", "reference", "reference_tcp"])
def test_initialize_takes_both_spellings(spelling, tmp_path):
    """``initialize`` brings up a one-rank gloo group from the port's
    keywords, the reference's (``rsparse_tpu/parallel/multihost.py``:
    coordinator_address, num_processes, process_id, local_device_count),
    and a bare ``host:port`` read as ``tcp://``; the group then carries a
    collective."""
    import torch
    import torch.distributed as dist

    from rsparse_tpu_torch.parallel import multihost
    store = f"file://{tmp_path / 'store'}"
    if spelling == "port":
        multihost.initialize(store, 1, 0, device_type="cpu")
    elif spelling == "reference":
        multihost.initialize(coordinator_address=store, num_processes=1,
                             process_id=0, local_device_count=1,
                             device_type="cpu")
    else:
        multihost.initialize(coordinator_address=_free_tcp_address(),
                             num_processes=1, process_id=0,
                             device_type="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
        t = torch.arange(3.0)
        dist.all_reduce(t)
        assert t.tolist() == [0.0, 1.0, 2.0]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw,err", [
    (dict(init_method="file:///x", coordinator_address="file:///x"),
     TypeError),
    (dict(world_size=1, num_processes=1), TypeError),
    (dict(rank=0, process_id=0), TypeError),
    (dict(coordinator_address="localhost:1", num_processes=1, process_id=0,
          local_device_count=2, device_type="cpu"), ValueError)])
def test_initialize_refuses_mixed_spellings(kw, err):
    """One quantity in both spellings raises TypeError, and more than one
    device a CPU rank ValueError, before any group is brought up."""
    import torch.distributed as dist

    from rsparse_tpu_torch.parallel import multihost
    with pytest.raises(err):
        multihost.initialize(**kw)
    assert not dist.is_initialized()
