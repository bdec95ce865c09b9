#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rsparse_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero before the last
line:

1. environment: torch/CUDA versions, the card's name and power limit, and
   the build of the hand-written kernels (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card, on the same
   inputs, at the shapes the main path gives it, with both times;
3. the main path on MovieLens-100k: WRMF fit_transform -> transform ->
   predict, held to the reference's quality gate (NDCG@10 > 0.31,
   MAP@10 > 0.37) and to fit_transform == transform;
4. the main path at full width: rank 128 on the reference benchmark's
   ML-20M-shaped synthetic (65,536 x 32,768, seed 0), with stage times;
   then K1 and K2 against their plain versions on the heaviest buckets
   that run staged (the most entries, the most rows and the longest rows
   of each sweep, with their dense heads), with its fitted factors;
   last, a warm full-width fit_transform + predict under torch.profiler:
   the device time of each kernel and copy, and the device's busy share
   of the wall time.

The kernels' launch counters are reset right before each main-path phase
and must show every kernel launched in it.  The second-to-last line is a
JSON object describing the kernels; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

REPO = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


# -- timing -------------------------------------------------------------------

def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over ``reps`` calls after one warm-up, by
    CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b) -> float:
    """max |a - b| / max |b|"""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


# -- phase 2: kernels against their plain versions ----------------------------

def _k1_inputs(gen, device, B, L, d, H, n_src=32768):
    import torch
    from rsparse_tpu_torch.sparse.device import RowBucket
    f32 = torch.float32
    V = torch.randn((n_src, d), generator=gen, device=device, dtype=f32) * 0.1
    nnz = torch.randint(L // 2, L + 1, (B,), generator=gen, device=device,
                        dtype=torch.int32)
    live = torch.arange(L, device=device)[None, :] < nnz[:, None]
    col = torch.randint(0, n_src, (B, L), generator=gen, device=device,
                        dtype=torch.int32) * live
    val = (1.0 + torch.rand((B, L), generator=gen, device=device).exp()
           ) * live
    bucket = RowBucket(torch.arange(B, device=device, dtype=torch.int32),
                       col.to(torch.int32).contiguous(), val.to(f32).contiguous(),
                       nnz)
    W = Vh = None
    if H:
        present = torch.rand((B, H), generator=gen, device=device) < 0.05
        W = ((1.0 + torch.rand((B, H), generator=gen, device=device) * 4)
             * present).contiguous()
        Vh = torch.randn((H, d), generator=gen, device=device) * 0.1
    return V, bucket, W, Vh


def check_als_kernels(device, results) -> None:
    import torch
    from rsparse_tpu_torch.ops import als
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lam = 1.0
    for (B, L) in ((4096, 8), (2048, 128), (512, 2048)):
        for d in (10, 128):
            for H in (0, 1024):
                V, bucket, W, Vh = _k1_inputs(gen, device, B, L, d, H)
                ugb = d == 10
                g = 0.05 if ugb else 0.0
                cfg = als.ALSConfig(solver=als.CONJUGATE_GRADIENT,
                                    use_global_bias=ugb)
                XtX, rhs_init = als._sweep_prepare(V, lam, g, cfg,
                                                   torch.float32)
                x0 = torch.randn((B, d), generator=gen, device=device) * 0.01
                yk, lk = als.solve_bucket_cg(V, XtX, rhs_init, bucket, x0,
                                             lam, g, cfg, W, Vh)
                yp, lp = als._solve_bucket_implicit(V, XtX, rhs_init, bucket,
                                                    x0, lam, g, cfg, W, Vh)
                torch.cuda.synchronize()
                ey, el = rel_err(yk, yp), rel_err(lk, lp)
                ms = time_ms(lambda: als.solve_bucket_cg(
                    V, XtX, rhs_init, bucket, x0, lam, g, cfg, W, Vh))
                pms = time_ms(lambda: als._solve_bucket_implicit(
                    V, XtX, rhs_init, bucket, x0, lam, g, cfg, W, Vh))
                shape = f"B={B} L={L} d={d} H={H}"
                log(f"  K1 als_cg   {shape:26s} y_rel={ey:.2e} "
                    f"loss_rel={el:.2e} kernel={ms:.3f} ms plain={pms:.3f} ms")
                require(torch.isfinite(yk).all() and torch.isfinite(lk).all(),
                        f"K1 {shape}: non-finite output")
                require(ey <= 1e-4 and el <= 1e-5, f"K1 {shape}: disagrees "
                        f"with its plain version (y {ey:.2e}, loss {el:.2e})")
                results["als_cg"]["max_abs_err"] = max(
                    results["als_cg"]["max_abs_err"],
                    float((yk - yp).abs().max()))
                if (B, L, d, H) == (2048, 128, 128, 1024):
                    results["als_cg"].update(ms=ms, plain_ms=pms, shape=shape)
    for d in (10, 64, 128):
        B, L = 2048, 128
        V, bucket, _, _ = _k1_inputs(gen, device, B, L, d, 0)
        cfg = als.ALSConfig(solver=als.CHOLESKY)
        XtX, rhs_init = als._sweep_prepare(V, lam, 0.0, cfg, torch.float32)
        x0 = torch.zeros((B, d), device=device)
        yk, lk = als.solve_bucket_cholesky(V, XtX, rhs_init, bucket, lam, 0.0,
                                           cfg)
        yp, lp = als._solve_bucket_implicit(V, XtX, rhs_init, bucket, x0, lam,
                                            0.0, cfg)
        torch.cuda.synchronize()
        ey, el = rel_err(yk, yp), rel_err(lk, lp)
        ms = time_ms(lambda: als.solve_bucket_cholesky(
            V, XtX, rhs_init, bucket, lam, 0.0, cfg))
        pms = time_ms(lambda: als._solve_bucket_implicit(
            V, XtX, rhs_init, bucket, x0, lam, 0.0, cfg))
        shape = f"B={B} L={L} d={d}"
        log(f"  K2 als_chol {shape:26s} y_rel={ey:.2e} loss_rel={el:.2e} "
            f"kernel={ms:.3f} ms plain={pms:.3f} ms")
        require(torch.isfinite(yk).all(), f"K2 {shape}: non-finite output")
        require(ey <= 1e-4, f"K2 {shape}: disagrees with its plain version "
                f"(y {ey:.2e})")
        results["als_chol"]["max_abs_err"] = max(
            results["als_chol"]["max_abs_err"], float((yk - yp).abs().max()))
        if d == 128:
            results["als_chol"].update(ms=ms, plain_ms=pms, shape=shape)


def check_topk_kernel(device, results) -> None:
    import torch
    from rsparse_tpu_torch.ops import topk
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    C = 256
    for n in (1792, 32768):
        # quarter-step scores: many exact ties
        s = (torch.randn((C, n), generator=gen, device=device) * 4).round() / 4
        mask = torch.rand((C, n), generator=gen, device=device) < 0.3
        mask[0] = True                        # all masked
        mask[1] = False                       # nothing masked
        mask[2] = True
        mask[2, :5] = False                   # fewer than k live columns
        bits = torch.from_numpy(np.packbits(mask.cpu().numpy(), axis=1,
                                            bitorder="little")).to(device)
        for k in (1, 10, 100):
            for b in (bits, None):
                sk, ik = topk.masked_top_k_bits(s, b, k, 0.25)
                sp_, ip = topk._masked_top_k_plain(s, b, k, 0.25)
                torch.cuda.synchronize()
                tag = (f"C={C} n={n} k={k} "
                       + ("masked" if b is not None else "no mask"))
                same = torch.equal(ik, ip) and torch.equal(sk, sp_)
                ms = time_ms(lambda: topk.masked_top_k_bits(s, b, k, 0.25))
                pms = time_ms(lambda: topk._masked_top_k_plain(s, b, k, 0.25))
                log(f"  K3 topk     {tag:30s} bitwise_equal={same} "
                    f"kernel={ms:.3f} ms plain={pms:.3f} ms")
                require(same, f"K3 {tag}: differs from its plain version")
                results["topk"]["max_abs_err"] = max(
                    results["topk"]["max_abs_err"],
                    float((sk - sp_).abs().max()))
                if (n, k, b is not None) == (32768, 10, True):
                    results["topk"].update(ms=ms, plain_ms=pms, shape=tag)


# -- phases 3 and 4: the main path --------------------------------------------

def synth_ml20m_like(n_users=65_536, n_items=32_768, mean_nnz=144, seed=0):
    """The reference benchmark's implicit matrix (bench.py
    synth_ml20m_like): log-normal row lengths, zipf item popularity."""
    rng = np.random.default_rng(seed)
    row_nnz = np.clip(rng.lognormal(np.log(mean_nnz * 0.6), 0.9,
                                    n_users).astype(np.int64), 4, 4096)
    total = int(row_nnz.sum())
    pop = 1.0 / (np.arange(n_items) + 10.0)
    pop /= pop.sum()
    cols = rng.choice(n_items, size=total, p=pop)
    rows = np.repeat(np.arange(n_users), row_nnz)
    vals = 1.0 + rng.exponential(3.0, size=total)
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n_users, n_items))
    m.sum_duplicates()
    return m


def check_launched(kernels, phase: str) -> dict:
    counts = dict(kernels.launches)
    log(f"  launches in {phase}: {counts}")
    for name, n in counts.items():
        require(n > 0, f"{phase}: kernel {name} was not launched")
    return counts


def check_predictions(idx, k, n_items, masked: sp.csr_matrix, what: str):
    require(idx.shape == (masked.shape[0], k), f"{what}: shape {idx.shape}")
    require(((idx >= 0) & (idx < n_items)).all(), f"{what}: index range")
    require(all(len(set(r)) == k for r in idx.tolist()),
            f"{what}: duplicate indices")
    hit = masked[np.repeat(np.arange(idx.shape[0]), k), idx.ravel()]
    live = np.diff(masked.indptr) <= n_items - k
    require(not np.asarray(hit).reshape(idx.shape)[live].any(),
            f"{what}: recommended a masked item")


def run_ml100k(device) -> None:
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    x = rt.load_movielens100k()
    train, test = rt.train_test_split(x, 0.2, np.random.default_rng(0))
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.WRMF(rank=10, lambda_=1.0, feedback="implicit",
                solver="conjugate_gradient", seed=0, device=device)
    emb = m.fit_transform(train, n_iter=10)
    preds = m.predict(train, k=10, not_recommend=train)
    emb2 = m.transform(train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launched(_kernels, "ML-100k main path")
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    mapk = float(np.nanmean(rt.ap_k(preds.indices, test)))
    diff = float((emb - emb2).abs().max())
    log(f"  NDCG@10={ndcg:.4f} MAP@10={mapk:.4f} iters={len(m.loss_history)} "
        f"loss={m.loss_history[-1]:.6f} |fit_transform-transform|={diff:.2e} "
        f"stages={m.stage_info} wall={wall:.2f} s")
    require(all(b <= a for a, b in zip(m.loss_history, m.loss_history[1:])),
            f"ML-100k: loss rose: {m.loss_history}")
    require(ndcg > 0.31 and mapk > 0.37, "ML-100k: quality gate failed")
    require(diff <= 1e-5, "ML-100k: fit_transform != transform")
    check_predictions(preds.indices, 10, train.shape[1], train, "ML-100k")


def check_staged_buckets(m, x, results) -> None:
    """K1 and K2 against their plain versions at the shapes the full-width
    run gave them: per sweep, the buckets with the most padded entries
    (B x L), the most rows and the longest rows, staged as fit_transform stages
    them, with the fitted factors as sources and warm starts.  The error
    of each against the plain version at float64 is printed beside."""
    import torch
    from rsparse_tpu_torch.ops import als
    lam, g, incl = m.lambda_, m.global_bias, m.with_global_bias
    csr = m._prepare_input(x)
    t0 = time.perf_counter()
    item = m._stage(csr.T.tocsr(), incl)
    t1 = time.perf_counter()
    user = m._stage(csr, incl)
    t2 = time.perf_counter()
    full = (None, m._bucketize(csr, incl), None)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"  re-staging (host clock, synchronised): item sweep {t1 - t0:.3f} s,"
        f" user sweep {t2 - t1:.3f} s, closing sweep {t3 - t2:.3f} s")
    sweeps = (("item sweep", "als_cg", m._U, m._V, item),
              ("user sweep", "als_cg", m._V, m._U, user),
              ("closing sweep", "als_chol", m._V, None, full))
    for sweep, name, src, old, (hot, br, rows) in sweeps:
        cg = name == "als_cg"
        cfg = m._cfg(als.CONJUGATE_GRADIENT if cg else als.CHOLESKY)
        XtX, rhs_init = als._sweep_prepare(src, lam, g, cfg, torch.float32)
        Vh = None if hot is None else src[hot.long()].contiguous()
        bs = br.buckets
        picks = sorted({max(range(len(bs)), key=key) for key in (
            lambda i: bs[i].batch * bs[i].pad_len,
            lambda i: bs[i].batch, lambda i: bs[i].pad_len)})
        for bi in picks:
            b = bs[bi]
            W = None if rows is None else rows[bi][0]
            if cg:
                x0 = old[b.row_ids.clamp(max=old.shape[0] - 1).long()
                         ].contiguous()
                kern = functools.partial(als.solve_bucket_cg, src, XtX,
                                         rhs_init, b, x0, lam, g, cfg, W, Vh)
            else:
                x0 = torch.zeros((b.batch, src.shape[1]), device=src.device)
                kern = functools.partial(als.solve_bucket_cholesky, src, XtX,
                                         rhs_init, b, lam, g, cfg)
            plain = functools.partial(als._solve_bucket_implicit, src, XtX,
                                      rhs_init, b, x0, lam, g, cfg, W, Vh)
            yk, lk = kern()
            yp, lp = plain()
            y64, l64 = als._solve_bucket_implicit(
                src, XtX.double(), rhs_init, b, x0, lam, g, cfg, W, Vh)
            torch.cuda.synchronize()
            ey, el = rel_err(yk, yp), rel_err(lk, lp)
            ms, pms = time_ms(kern, reps=3), time_ms(plain, reps=3)
            shape = (f"{sweep} B={b.batch} L={b.pad_len} d={src.shape[1]} "
                     f"H={0 if W is None else W.shape[1]}")
            tag = "K1 als_cg  " if cg else "K2 als_chol"
            log(f"  {tag} {shape:42s} y_rel={ey:.2e} loss_rel={el:.2e} "
                f"(vs f64: kernel y {rel_err(yk, y64):.2e} loss "
                f"{rel_err(lk, l64):.2e}, plain y {rel_err(yp, y64):.2e} "
                f"loss {rel_err(lp, l64):.2e}) kernel={ms:.3f} ms "
                f"plain={pms:.3f} ms")
            require(torch.isfinite(yk).all() and torch.isfinite(lk).all(),
                    f"{tag} {shape}: non-finite output")
            require(ey <= 1e-4, f"{tag} {shape}: y disagrees with its plain "
                    f"version ({ey:.2e})")
            require(not cg or el <= 1e-5, f"{tag} {shape}: loss disagrees "
                    f"with its plain version ({el:.2e})")
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], float((yk - yp).abs().max()))
            del yk, lk, yp, lp, y64, l64


def profile_full_width(m, x) -> None:
    """A warm full-width fit_transform + predict under torch.profiler."""
    import torch
    from rsparse_tpu_torch.utils.profiling import profile_device
    q = x[:4096]
    prof = profile_device(lambda: (
        m.fit_transform(x, n_iter=2, convergence_tol=-1),
        m.predict(q, k=10, not_recommend=q)))
    log(f"  wall {prof['wall_s']:.3f} s, device {prof['device_s']:.4f} s, "
        f"busy share {prof['busy_share']:.3f}; sweeps: " + ", ".join(
            f"{r['phase']}#{r['iter']} {r['wall_s'] * 1e3:.2f} ms"
            for r in m.fit_trace))
    if not prof["ops"]:
        log("  the profiler recorded no device activity")
    for name, calls, ms in prof["ops"][:15]:
        log(f"  {ms:10.3f} ms {calls:6d}x  {name[:90]}")
    torch.cuda.synchronize()


def run_full_width(device):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    t0 = time.perf_counter()
    x = synth_ml20m_like()
    log(f"  synth: {x.shape[0]} x {x.shape[1]}, {x.nnz} nnz "
        f"({time.perf_counter() - t0:.2f} s)")
    q = x[:4096]
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    m = rt.WRMF(rank=128, lambda_=0.1, feedback="implicit",
                solver="conjugate_gradient", n_hot="auto", seed=0,
                device=device)
    t0 = time.perf_counter()
    emb = m.fit_transform(x, n_iter=2, convergence_tol=-1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    preds = m.predict(q, k=10, not_recommend=q)
    predict_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = check_launched(_kernels, "full-width main path")
    phases = m.fit_trace.summary()
    staging = fit_s - sum(phases.values())
    log(f"  stages: {m.stage_info}")
    log(f"  fit_transform {fit_s:.3f} s = staging {staging:.3f} s + "
        + " + ".join(f"{k} {v:.4f} s" for k, v in phases.items())
        + "; per sweep: " + ", ".join(
            f"{r['phase']}#{r['iter']} {r['wall_s'] * 1e3:.2f} ms"
            for r in m.fit_trace))
    log(f"  predict 4096 users k=10 (transform + top-k) {predict_s:.3f} s; "
        f"loss {m.loss_history}; peak device memory {peak:.2f} GiB")
    require(tuple(emb.shape) == (x.shape[0], 128), "full width: emb shape")
    require(bool(torch.isfinite(emb).all()), "full width: non-finite emb")
    require(m.loss_history[1] <= m.loss_history[0], "full width: loss rose")
    check_predictions(preds.indices, 10, x.shape[1], sp.csr_matrix(q),
                      "full width")
    return counts, m, x


# -----------------------------------------------------------------------------

KERNELS = {
    "als_cg": ("rsparse_tpu_torch/csrc/als_cg.cu",
               "rsparse_tpu/ops/als.py:138"),
    "als_chol": ("rsparse_tpu_torch/csrc/als_chol.cu",
                 "rsparse_tpu/ops/als.py:138"),
    "topk": ("rsparse_tpu_torch/csrc/topk.cu", "rsparse_tpu/ops/topk.py:134"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    import rsparse_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from rsparse_tpu_torch import _kernels
    device = torch.device("cuda", 0)

    log("phase 1: environment")
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    t0 = time.perf_counter()
    _kernels.lib()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_kernels.build_info['seconds']:.1f} s) -> "
        f"{os.path.relpath(_kernels.build_info['path'], REPO)}")
    from rsparse_tpu_torch.native import get_lib
    log("  host bucket fill: " + ("native/librsparse_host.so"
                                  if get_lib() is not None else "numpy"))
    for line in str(_kernels.build_info["log"]).splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas " + line.split("ptxas info    :")[-1].strip())

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    log("phase 2: kernels against their plain versions")
    check_als_kernels(device, results)
    check_topk_kernel(device, results)

    log("phase 3: main path, ML-100k (rank 10, CG)")
    run_ml100k(device)

    log("phase 4: main path at full width (rank 128, 65,536 x 32,768)")
    counts, m, x = run_full_width(device)
    check_staged_buckets(m, x, results)
    log("  profile of a warm full-width fit_transform + predict")
    profile_full_width(m, x)

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
                "shape": results[name]["shape"]}
               for name, (src, rep) in KERNELS.items()]
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
