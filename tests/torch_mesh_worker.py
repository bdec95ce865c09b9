"""One rank of the port's CPU mesh runs (tests/test_torch_parallel.py,
tests/test_torch_sgd_sharded.py).

Started by ``torch.multiprocessing`` (spawn) with ``run(rank, world, store,
out_dir, cases)``: brings up gloo on a ``file://`` store, then runs each
named case in order (every rank runs the same cases: they are collective)
and writes ``<case>.<rank>.npz`` into ``out_dir``.  Imports torch, numpy,
scipy and the port only.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the settings every fit shares: ML-100k, rank 8, float64 (the JAX
#: package's mesh tests' settings, tests/test_multihost.py)
FIT = dict(rank=8, lambda_=0.5, feedback="implicit", precision="double",
           seed=0)
N_ITER = 2

#: case -> (mesh shape, axis names or "multihost", WRMF keyword arguments)
CASES = {
    "data2_cg_head": ((2, 1), ("data", "model"),
                      dict(solver="conjugate_gradient", n_hot="auto")),
    "data2_chol": ((2, 1), ("data", "model"), dict(solver="cholesky")),
    "model2_cg": ((1, 2), ("data", "model"),
                  dict(solver="conjugate_gradient", n_hot=0)),
    "model2_chol_head": ((1, 2), ("data", "model"),
                         dict(solver="cholesky", n_hot=32)),
    "mesh22_cg_head": ((2, 2), ("data", "model"),
                       dict(solver="conjugate_gradient", n_hot="auto")),
    "mesh22_chol": ((2, 2), ("data", "model"), dict(solver="cholesky")),
    "alx_cg": ((2,), ("data",),
               dict(solver="conjugate_gradient", routing="alx")),
    "alx_nnls": ((2,), ("data",),
                 dict(solver="nnls", nnls_max_iter=3, routing="alx")),
    "ragged_cg": ((2,), ("data",),
                  dict(solver="conjugate_gradient", routing="alx_ragged")),
    "ragged_nnls": ((2,), ("data",),
                    dict(solver="nnls", nnls_max_iter=3,
                         routing="alx_ragged")),
    "alx4_chol": ((4,), ("data",), dict(solver="cholesky", routing="alx")),
    "dcn_chol": (None, "multihost", dict(solver="cholesky")),
    "dcn_alx": (None, "multihost",
                dict(solver="conjugate_gradient", routing="alx")),
}


def data():
    import rsparse_tpu_torch as rt
    return sp.csr_matrix(rt.load_movielens100k())


def make(case):
    from rsparse_tpu_torch.parallel import mesh as pmesh, multihost
    shape, names, kw = CASES[case]
    if names == "multihost":
        return multihost.make_multihost_mesh(device_type="cpu"), kw
    return pmesh.make_mesh(shape, names, device_type="cpu"), kw


def fit_case(case, x):
    """A mesh fit, its transform and predictions."""
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.parallel.alx import EXCHANGES
    mesh, kw = make(case)
    EXCHANGES.clear()
    m = rt.WRMF(mesh=mesh, device="cpu", **FIT, **kw)
    emb = m.fit_transform(x, n_iter=N_ITER, convergence_tol=-1)
    out = dict(U=emb.numpy(), V=m._V.numpy(),
               loss=np.asarray(m.loss_history),
               T=m.transform(x[:200]).numpy())
    p = m.predict(x[:300], k=10)
    out.update(pred_i=p.indices, pred_s=p.scores,
               sent=np.asarray([e["bytes"] for e in EXCHANGES]),
               wire=np.asarray([e["wire"]["routed_total_bytes"]
                                for e in EXCHANGES]))
    return out


def retrieval_case(x):
    """sharded_top_k / sharded_top_product / predict beside top_product,
    on a (2, 1) mesh: with the training mask, without one, with excludes,
    get_similar_items, and sharded_top_k with a dense mask and with bits."""
    import torch

    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.ops.topk import pack_mask_bits, top_product
    from rsparse_tpu_torch.parallel import topk_sharded
    mesh, kw = make("data2_chol")
    m = rt.WRMF(mesh=mesh, device="cpu", **FIT, **kw)
    m.fit_transform(x, n_iter=1, convergence_tol=-1)
    q = x[:257]
    emb = m.transform(q)
    out = {}
    for tag, nr, excl in (("mask", q, None), ("none", None, None),
                          ("excl", q, np.asarray([0, 5, 49]))):
        out[f"{tag}_i"], out[f"{tag}_s"] = topk_sharded.sharded_top_product(
            mesh, emb, m.components, 10, not_recommend=nr, exclude=excl)
        out[f"{tag}_ref_i"], out[f"{tag}_ref_s"] = top_product(
            emb, m.components, 10, not_recommend=nr, exclude=excl)
    p = m.predict(q, k=10, items_exclude=[3, 7])
    out["predict_i"], out["predict_s"] = p.indices, p.scores
    out["predict_ref_i"], out["predict_ref_s"] = top_product(
        emb, m.components, 10, not_recommend=q, exclude=np.asarray([3, 7]))
    sim = m.get_similar_items(11, k=20)
    out["sim_i"] = sim.indices
    n_items = m.components.shape[1]
    comps = m.components.astype(np.float32)
    l2 = comps / np.sqrt((comps ** 2).sum(0))
    out["sim_ref_i"] = top_product(torch.as_tensor(l2[:, 11][None]), l2, 20,
                                   exclude=np.asarray([11]))[0]
    # sharded_top_k itself, on 1,680 items (840 a rank): dense mask, bits
    y = torch.as_tensor(comps[:, :1680])
    xq = torch.as_tensor(emb[:64], dtype=torch.float32)
    dense = torch.as_tensor(q[:64, :1680].toarray() > 0)
    out["k_dense_s"], out["k_dense_i"] = topk_sharded.sharded_top_k(
        mesh, xq, y, 12, mask=dense, glob_mean=0.25)
    bits = torch.from_numpy(pack_mask_bits(1680, dense_rows=dense.numpy()))
    out["k_bits_s"], out["k_bits_i"] = topk_sharded.sharded_top_k(
        mesh, xq, y, 12, mask_bits=bits, glob_mean=0.25)
    out["k_ref_i"], out["k_ref_s"] = top_product(
        xq, y, 12, not_recommend=sp.csr_matrix(dense.numpy()),
        glob_mean=0.25)
    out["n_items"] = np.asarray(n_items)
    return {k: np.asarray(v) for k, v in out.items()}


def checkpoint_case(x, out_dir):
    """A (2, 1) fit of 3 iterations in one go; the same stopped after 1
    with its state written, then resumed to 3; the fitted model saved."""
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import checkpoint
    mesh, _ = make("data2_cg_head")
    kw = dict(FIT, solver="conjugate_gradient", n_hot="auto",
              with_global_bias=True)
    full = rt.WRMF(mesh=mesh, device="cpu", **kw)
    e_full = full.fit_transform(x, n_iter=3, convergence_tol=-1)
    state = os.path.join(out_dir, "fit_state")
    part = rt.WRMF(mesh=mesh, device="cpu", **kw)
    part.fit_transform(x, n_iter=1, convergence_tol=-1,
                       checkpoint_path=state)
    resumed = rt.WRMF(mesh=mesh, device="cpu", **kw)
    e_res = resumed.fit_transform(x, n_iter=3, convergence_tol=-1,
                                  checkpoint_path=state, resume=True)
    checkpoint.save(full, os.path.join(out_dir, "model"))
    p = full.predict(x[:300], k=10)
    return dict(U=e_full.numpy(), U_res=e_res.numpy(), V=full._V.numpy(),
                V_res=resumed._V.numpy(), loss=np.asarray(full.loss_history),
                loss_res=np.asarray(resumed.loss_history),
                pred_i=p.indices, pred_s=p.scores)


def mesh_load_case(x, out_dir):
    """The model the checkpoint case saved, loaded onto a (1, 2) mesh with
    ``load(..., sharding=mesh)``: its tables, its predictions, and the
    tables of the checkpoint it saves again (rank 0 writes)."""
    from rsparse_tpu_torch import checkpoint
    from rsparse_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh((1, 2), ("data", "model"), device_type="cpu")
    m = checkpoint.load(os.path.join(out_dir, "model"), sharding=mesh)
    p = m.predict(x[:300], k=10)
    again = os.path.join(out_dir, "model_again")
    checkpoint.save(m, again)
    m2 = checkpoint.load(again, device="cpu")
    return dict(U=m._U.numpy(), V=m._V.numpy(), pred_i=p.indices,
                pred_s=p.scores, V_again=m2._V.numpy(),
                comps_again=np.asarray(m2.components),
                on_mesh=np.asarray(m.mesh is mesh))


def step_case():
    """``shard_problem`` + ``train_step`` on a (2, world / 2) mesh against
    the two half-sweeps of one process, on a seeded 128 x 96 problem."""
    import torch

    from rsparse_tpu_torch.ops.als import (ALSConfig, CONJUGATE_GRADIENT,
                                           wrmf_sweep)
    from rsparse_tpu_torch.parallel import mesh as pmesh, wrmf_step
    from rsparse_tpu_torch.sparse.device import bucket_rows
    import torch.distributed as dist
    world = dist.get_world_size()
    mesh = pmesh.make_mesh((2, world // 2), ("data", "model"),
                           device_type="cpu")
    rs = np.random.RandomState(0)
    x = sp.random(128, 96, density=0.2, random_state=rs, format="csr")
    x.data = 1.0 + 4.0 * x.data
    iu = bucket_rows(x.T.tocsr(), torch.float64, "cpu", row_align=16,
                     max_buckets=3)
    ui = bucket_rows(x, torch.float64, "cpu", row_align=16, max_buckets=3)
    rng = np.random.default_rng(0)
    U = torch.as_tensor(rng.standard_normal((128, 8)) * 0.01)
    V = torch.as_tensor(rng.standard_normal((96, 8)) * 0.01)
    cfg = ALSConfig(feedback="implicit", solver=CONJUGATE_GRADIENT)
    V1, _ = wrmf_sweep(U, V, iu.buckets, 0.1, 0.0, cfg)
    U1, loss1 = wrmf_sweep(V1, U, ui.buckets, 0.1, 0.0, cfg)
    Us, Vs, iu_s, ui_s = wrmf_step.shard_problem(mesh, U, V, iu, ui)
    U2, V2, loss2 = wrmf_step.train_step(mesh, Us, Vs, iu_s, ui_s, None,
                                         None, 0.1, 0.0, cfg, cfg)
    return dict(U1=U1.numpy(), V1=V1.numpy(), loss1=loss1.numpy(),
                U2=wrmf_step.gather_factors(mesh, U2, 128).numpy(),
                V2=wrmf_step.gather_factors(mesh, V2, 96).numpy(),
                loss2=loss2.numpy(), shard_rows=np.asarray(U2.shape[0]))


def exchange_case():
    """``routed_factor_exchange`` and ``ragged_factor_exchange`` on a data
    mesh: each rank's cache, read through its remapped ids, against the
    global gather of the rows it references."""
    import torch

    from rsparse_tpu_torch.parallel import mesh as pmesh, routing
    mesh = pmesh.make_mesh(None, ("data",), device_type="cpu")
    group = mesh.group("data")
    n_dev, n_src = group.size, 120
    rng = np.random.default_rng(7)
    src = torch.as_tensor(rng.standard_normal((n_src, 6)))
    ids = [rng.integers(0, n_src, size=(int(rng.integers(3, 30)), 5))
           for _ in range(n_dev)]
    out = {"want": src[torch.as_tensor(ids[group.rank])].numpy()}
    for name, build, exchange in (
            ("padded", routing.build_routing_plan,
             routing.routed_factor_exchange),
            ("ragged", routing.build_ragged_routing_plan,
             routing.ragged_factor_exchange)):
        plan, remap = build(ids, n_src, n_dev)
        cache = exchange(group, src, plan)
        out[name] = cache[torch.as_tensor(remap[group.rank]).long()].numpy()
    return out


# -- the SGD family (tests/test_torch_sgd_sharded.py) -----------------------
#
# The sizes of tests/test_sgd_sharded.py.  Each model runs twice: at the
# JAX package's mesh-test settings from its own seed (held to the port's
# one-process fit), and at float64 from weights carried across by
# ``convert`` with the JAX package's bits, no dropout and no shuffle (held
# to the JAX package's mesh fit, ``*_ref``).

SGD_FTRL = dict(learning_rate=0.1, lambda_=0.01, l1_ratio=0.5, dropout=0.2,
                seed=7)
SGD_FTRL_REF = dict(learning_rate=0.1, lambda_=0.01, l1_ratio=0.5,
                    precision="double", seed=7)
SGD_FM = dict(learning_rate_w=0.2, rank=4, lambda_w=0.001, lambda_v=0.001,
              seed=7)
SGD_RANKMF = {
    "warp": dict(rank=8, optimizer="adagrad", gamma=0.9, loss="warp",
                 seed=7, batch_size=64, max_negative_samples=10,
                 lambda_=0.01),
    "bpr": dict(rank=8, optimizer="rmsprop", gamma=0.9, loss="bpr", seed=7,
                batch_size=64, max_negative_samples=10, lambda_=0.01),
    "side": dict(rank=8, seed=3, batch_size=64, max_negative_samples=8)}
SGD_RANKMF_ITER = {"warp": 3, "bpr": 3, "side": 2}
#: the RankMF settings also fitted at precision="bfloat16" (K9's bf16
#: plain version in its row-map mode on the mesh)
SGD_RANKMF_BF16 = ("warp", "side")
SGD_GLOVE = dict(rank=8, x_max=10, learning_rate=0.05, seed=42,
                 batch_size=256, n_hot=32)
SGD_GLOVE_SMALL = dict(rank=4, x_max=10, learning_rate=0.05, seed=0,
                       batch_size=128, n_hot=0)


def sgd_glm():
    rng = np.random.default_rng(0)
    x = sp.random(500, 80, density=0.1, random_state=1, format="csr")
    return x, rng.integers(0, 2, 500).astype(float)


def sgd_interactions():
    return (sp.random(120, 60, density=0.1, random_state=1) > 0).astype(
        np.float64).tocsr()


def sgd_side_features():
    uf = sp.random(120, 30, density=0.2, random_state=2, format="csr")
    uf.data[:] = 1.0
    itf = sp.random(60, 25, density=0.3, random_state=3, format="csr")
    itf.data[:] = 1.0
    return uf, itf


def sgd_cooc():
    """A triangular co-occurrence (the head and both passes)."""
    rng = np.random.default_rng(0)
    n = 100
    rows = rng.integers(0, n, 3000)
    cols = rng.integers(0, n, 3000)
    keep = rows <= cols
    coo = sp.coo_matrix(
        (rng.uniform(1, 5, keep.sum()), (rows[keep], cols[keep])),
        shape=(n, n))
    coo.sum_duplicates()
    return coo


def sgd_cooc_small():
    rng = np.random.default_rng(1)
    n = 40
    coo = sp.coo_matrix(
        (rng.uniform(1, 5, 300), (rng.integers(0, n, 300),
                                  rng.integers(0, n, 300))), shape=(n, n))
    coo.sum_duplicates()
    return coo


def sgd_weights():
    """The float64 starting weights the ``*_ref`` fits carry across."""
    rng = np.random.default_rng(11)
    F1, r = 81, 4
    uf, itf = sgd_side_features()
    return {
        "ftrl": (rng.standard_normal(F1) * 0.1, rng.uniform(0, 1, F1)),
        "fm": (np.float64(0.1), np.float64(1.5), rng.standard_normal(F1)
               * 0.01, rng.standard_normal((F1, r)) * 0.01,
               rng.uniform(1, 2, F1), rng.uniform(1, 2, (F1, r))),
        "rankmf": (rng.standard_normal((120, 8)) * 0.1,
                   rng.standard_normal((60, 8)) * 0.1,
                   rng.uniform(1, 2, 120), rng.uniform(1, 2, 60)),
        "rankmf_side": (rng.standard_normal((uf.shape[1], 8)) * 0.1,
                        rng.standard_normal((itf.shape[1], 8)) * 0.1,
                        rng.uniform(1, 2, uf.shape[1]),
                        rng.uniform(1, 2, itf.shape[1])),
        "glove": {k: rng.uniform(-0.5, 0.5, s) for k, s in (
            ("w_i", (100, 8)), ("w_j", (100, 8)), ("b_i", (100,)),
            ("b_j", (100,)))}}


def _sgd_mesh(world):
    """World 2: a ("data",) mesh; world 4: ("dcn", "ici") = (2, 2), the
    tables sharded over both axes."""
    from rsparse_tpu_torch.parallel import mesh as pmesh
    if world == 2:
        return pmesh.make_mesh((2,), ("data",), device_type="cpu")
    return pmesh.make_mesh((2, 2), ("dcn", "ici"), device_type="cpu")


def _sgd_prims(mesh):
    """ShardedOps on a 43-row table (not divisible by the mesh) against
    DirectOps: gather, gather_many (float32 with float64: the byte path),
    scatter_add, add_dense, add_dense_cols, put, each unsharded."""
    import torch

    from rsparse_tpu_torch.parallel import sgd_sharded as sgd
    rng = np.random.default_rng(0)
    n, r = 43, 5
    table = torch.as_tensor(rng.standard_normal((n, r)), dtype=torch.float32)
    t64 = torch.as_tensor(rng.standard_normal((n,)))
    ids = torch.as_tensor(rng.integers(0, n, (7, 11)))
    upd = torch.as_tensor(rng.standard_normal((7, 11, r)),
                          dtype=torch.float32)
    dense = torch.as_tensor(rng.standard_normal((sgd.padded_rows(n, mesh),
                                                 r)), dtype=torch.float32)
    uniq = torch.as_tensor(rng.permutation(n)[:20])
    rows = torch.as_tensor(rng.standard_normal((20, r)), dtype=torch.float32)
    out = {}
    for tag, ops in (("direct", sgd.DirectOps()),
                     ("sharded", sgd.ShardedOps(mesh))):
        whole = (lambda t: t) if tag == "direct" else (  # noqa: E731
            lambda t: sgd.unshard(t, n, mesh))
        place = (lambda t: t.clone()) if tag == "direct" else (  # noqa: E731
            lambda t: sgd.shard_table(t, mesh))
        out[f"{tag}_gather"] = ops.gather(place(table), ids).numpy()
        g0, g1 = ops.gather_many([(place(table), ids), (place(t64), ids)])
        out[f"{tag}_gm0"], out[f"{tag}_gm1"] = g0.numpy(), g1.numpy()
        out[f"{tag}_scatter"] = whole(ops.scatter_add(place(table), ids,
                                                      upd)).numpy()
        d = dense if tag == "sharded" else dense[:n]
        out[f"{tag}_dense"] = whole(ops.add_dense(place(table), d)).numpy()
        out[f"{tag}_cols"] = whole(ops.add_dense_cols(
            place(table), d[:, :2], 3)).numpy()
        out[f"{tag}_put"] = whole(ops.put(place(table), uniq, rows)).numpy()
        if tag == "sharded":
            out["shard_rows"] = np.asarray(place(table).shape[0])
            out["pad_rows"] = np.asarray(
                sgd.shard_table(table, mesh)[-1].abs().sum().item()
                if mesh.rank == ops.size - 1 else 0.0)
    return out


def _rows_of(m):
    return {k: getattr(m, k).shape[0] for k in m._sharded_tables()}


def _glm_case(mesh, out_dir, x, y):
    """FTRL and FM on the mesh: fits from their seeds (with FTRL's dropout,
    its masks checked alike on every rank), dumps, checkpoints saved and
    loaded back onto the mesh; and the float64 fits from carried
    weights."""
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import checkpoint, convert
    from rsparse_tpu_torch.parallel import sgd_sharded as sgd
    out = {}
    w = sgd_weights()
    m = rt.FTRL(mesh=mesh, **SGD_FTRL)
    out["ftrl_fit"] = m.fit(x, y, n_iter=2)
    out["ftrl_pred"] = m.predict(x)
    out["ftrl_z"], out["ftrl_n"] = m.z.numpy(), m.n.numpy()
    out["ftrl_coef"] = m.coef()
    out["ftrl_dump_z"] = m.dump()["z"]
    out["ftrl_rows"] = np.asarray(m.zn.shape[0])
    out["ftrl_draws"] = np.asarray(m._ops.stats["draw_checks"])
    checkpoint.save(m, os.path.join(out_dir, "ftrl_ckpt"))
    back = checkpoint.load(os.path.join(out_dir, "ftrl_ckpt"), sharding=mesh)
    out["ftrl_load_pred"] = back.predict(x)
    out["ftrl_load_rows"] = np.asarray(back.zn.shape[0])
    d = rt.FTRL.load(m.dump(), mesh=mesh)
    out["ftrl_dumpload_pred"] = d.predict(x)
    m = convert.ftrl_from_numpy(*w["ftrl"], mesh=mesh, **SGD_FTRL_REF)
    out["ftrl_ref_fit"] = m.fit(x, y, n_iter=2)
    out["ftrl_ref_z"], out["ftrl_ref_n"] = m.z.numpy(), m.n.numpy()

    m = rt.FactorizationMachine(mesh=mesh, **SGD_FM)
    out["fm_fit"] = m.fit(x, y, n_iter=2)
    out["fm_pred"] = m.predict(x)
    for k, n in m._sharded_tables().items():
        out[f"fm_{k}"] = sgd.unshard(getattr(m, k), n, mesh).numpy()
    out["fm_w0"] = m.w0.numpy()
    out["fm_rows"] = np.asarray([m.w.shape[0], m.v.shape[0]])
    checkpoint.save(m, os.path.join(out_dir, "fm_ckpt"))
    back = checkpoint.load(os.path.join(out_dir, "fm_ckpt"), sharding=mesh)
    out["fm_load_pred"] = back.predict(x)
    m = convert.fm_from_numpy(*w["fm"], mesh=mesh, precision="double",
                              **{k: v for k, v in SGD_FM.items()
                                 if k != "rank"})
    out["fm_ref_fit"] = m.fit(x, y, n_iter=2)
    out["fm_ref_v"] = sgd.unshard(m.v, 81, mesh).numpy()
    # ranks that draw apart are refused
    bad = rt.FTRL(mesh=mesh, **dict(SGD_FTRL, seed=mesh.rank))
    try:
        bad.fit(x, y)
        out["draws_apart_refused"] = np.asarray(False)
    except RuntimeError as e:
        out["draws_apart_refused"] = np.asarray("differ" in str(e))
    return out


def _rankmf_case(mesh, out_dir, bits):
    """RankMF on the mesh: the two optimizer / loss settings and side
    features from their seeds, and the float64 fits from carried weights
    with the JAX package's bits (``bits[name]``: one (S, K + 2) array a
    batch)."""
    import torch

    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import checkpoint, convert
    x = sgd_interactions()
    uf, itf = sgd_side_features()
    w = sgd_weights()
    out = {}
    for name, kw in SGD_RANKMF.items():
        feats = (dict(user_features=uf, item_features=itf)
                 if name == "side" else {})
        m = rt.RankMF(mesh=mesh, **kw)
        emb = m.partial_fit_transform(x, n_iter=SGD_RANKMF_ITER[name],
                                      **feats)
        out[f"rankmf_{name}_emb"] = np.asarray(emb)
        out[f"rankmf_{name}_comps"] = m.components
        out[f"rankmf_{name}_T"] = np.asarray(m.transform(x))
        out[f"rankmf_{name}_auc"] = np.asarray(m.auc_history)
        out[f"rankmf_{name}_rows"] = np.asarray(list(_rows_of(m).values()))
        out[f"rankmf_{name}_draws"] = np.asarray(
            m._ops.stats["draw_checks"])
        if name in SGD_RANKMF_BF16:
            b = rt.RankMF(mesh=mesh, **dict(kw, precision="bfloat16"))
            emb = b.partial_fit_transform(x, n_iter=SGD_RANKMF_ITER[name],
                                          **feats)
            out.update(rankmf_bf16_outputs(name, b, emb, x))
        if name == "warp":
            checkpoint.save(m, os.path.join(out_dir, "rankmf_ckpt"))
            back = checkpoint.load(os.path.join(out_dir, "rankmf_ckpt"),
                                   sharding=mesh)
            out["rankmf_load_comps"] = back.components
    for name, wk, feats in (("warp", "rankmf", {}),
                            ("side", "rankmf_side",
                             dict(user_features=uf, item_features=itf))):
        kw = dict(SGD_RANKMF[name], precision="double")
        kw.pop("rank")
        m = convert.rankmf_from_numpy(*w[wk], mesh=mesh, **kw)
        it = iter(bits[name])
        m._draw_bits = lambda S, K: torch.as_tensor(  # noqa: E731
            next(it).astype(np.int64))
        emb = m.partial_fit_transform(x, n_iter=SGD_RANKMF_ITER[name],
                                      **feats)
        out[f"rankmf_ref_{name}_emb"] = np.asarray(emb)
        out[f"rankmf_ref_{name}_comps"] = m.components
        out[f"rankmf_ref_{name}_auc"] = np.asarray(m.auc_history)
    return out


def host(t):
    """A tensor as numpy (bf16 as its float32 values: numpy has no bf16)."""
    import torch
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def rankmf_bf16_outputs(name, m, emb, x) -> dict:
    """A bf16 RankMF fit's outputs as float32 arrays (numpy has no bf16):
    the embeddings, components, transform, AUC and the tables' dtypes."""
    import torch
    f = lambda t: (t.float().numpy() if isinstance(t, torch.Tensor)  # noqa
                   else np.asarray(t, np.float64))
    return {f"rankmf_bf16_{name}_emb": f(emb),
            f"rankmf_bf16_{name}_comps": f(m.components),
            f"rankmf_bf16_{name}_T": f(m.transform(x)),
            f"rankmf_bf16_{name}_auc": np.asarray(m.auc_history),
            f"rankmf_bf16_{name}_bf16": np.asarray(all(
                t.dtype == torch.bfloat16 for t in (
                    m.user_features_embeddings, m.item_features_embeddings,
                    m._accW, m._accH)))}


#: the GloVe fits also run at precision="bfloat16" (name, settings, input,
#: epochs): the triangular input with and without the shuffle
GLOVE_BF16 = (("glove_bf16", dict(SGD_GLOVE, precision="bfloat16"),
               sgd_cooc(), 3),
              ("glove_bf16_shuffle", dict(SGD_GLOVE, precision="bfloat16",
                                          shuffle=True), sgd_cooc(), 3))


def _glove_case(mesh, out_dir):
    """GloVe on the mesh: the triangular input (head and tail, both
    passes) with and without the shuffle, the small square input, the
    float64 fit from carried weights; a checkpoint and convert."""
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import checkpoint, convert
    out = {}
    for name, kw, coo, it in (
            ("glove", SGD_GLOVE, sgd_cooc(), 3),
            ("glove_shuffle", dict(SGD_GLOVE, shuffle=True), sgd_cooc(), 3),
            ("glove_small", SGD_GLOVE_SMALL, sgd_cooc_small(), 2),
            ("glove_ref", dict(SGD_GLOVE, precision="double",
                               init=sgd_weights()["glove"]), sgd_cooc(), 3),
            *GLOVE_BF16):
        m = rt.GloVe(mesh=mesh, **kw)
        out[f"{name}_emb"] = host(m.fit_transform(coo, n_iter=it))
        out[f"{name}_comps"] = m.components
        out[f"{name}_bias_i"], out[f"{name}_bias_j"] = m.bias_i, m.bias_j
        out[f"{name}_cost"] = np.asarray(m.cost_history)
        out[f"{name}_rows"] = np.asarray([t.shape[0] for t in m._state])
        out[f"{name}_draws"] = np.asarray(m._ops.stats["draw_checks"])
        if name == "glove":
            checkpoint.save(m, os.path.join(out_dir, "glove_ckpt"))
            st = m._state
            c = convert.glove_from_numpy(
                out["glove_emb"], m.components.T, m.bias_i, m.bias_j,
                mesh=mesh, x_max=10)
            out["glove_convert_comps"] = c.components
            out["glove_convert_rows"] = np.asarray(c._state.w_i.shape[0])
            out["glove_convert_same"] = np.asarray(all(
                bool((a == b).all()) for a, b in zip(c._state[:4], st[:4])))
    return out


def sgd_case(world, out_dir):
    """Every SGD case on this world's mesh (collective: every rank runs
    them in the same order)."""
    mesh = _sgd_mesh(world)
    bits = dict(np.load(os.path.join(out_dir, "..", "rankmf_bits.npz")))
    x, y = sgd_glm()
    out = _sgd_prims(mesh)
    out.update(_glm_case(mesh, out_dir, x, y))
    out.update(_rankmf_case(mesh, out_dir, bits))
    out.update(_glove_case(mesh, out_dir))
    return out


def run(rank: int, world: int, store: str, out_dir: str, cases) -> None:
    import torch

    from rsparse_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, device_type="cpu",
                         timeout_s=240)
    x = data()
    for case in cases:
        if case == "retrieval":
            out = retrieval_case(x)
        elif case == "step":
            out = step_case()
        elif case == "exchange":
            out = exchange_case()
        elif case == "checkpoint":
            out = checkpoint_case(x, out_dir)
        elif case == "mesh_load":
            out = mesh_load_case(x, out_dir)
        elif case == "sgd":
            out = sgd_case(world, out_dir)
        else:
            out = fit_case(case, x)
        np.savez(os.path.join(out_dir, f"{case}.{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
