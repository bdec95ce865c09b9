"""One rank of the port's CPU mesh runs (tests/test_torch_parallel.py).

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
        else:
            out = fit_case(case, x)
        np.savez(os.path.join(out_dir, f"{case}.{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
