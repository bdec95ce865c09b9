#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rsparse_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--phases 1,2,...]

Phases, one line or more each; any failure exits non-zero before the last
line:

1. environment: torch/CUDA versions, the card's name and power limit, and
   the build of the hand-written kernels (nvcc, sm_90a, one process per
   source);
2. each kernel against its plain PyTorch version on the card, on the same
   inputs, at the shapes the main paths give it, with both times: K1 (CG)
   and K2 (Cholesky) for implicit and explicit feedback, with biases,
   dense heads and presence bits, up to d = 129; K3 (top-k); K4 (NNLS)
   with the distribution of its coordinate-descent sweeps;
3. the main paths on MovieLens-100k: implicit WRMF fit_transform ->
   transform -> predict, held to the reference's quality gate
   (NDCG@10 > 0.31, MAP@10 > 0.37) and to fit_transform == transform; the
   explicit rating model (biases, Cholesky) held to RMSE < 1.05 and below
   the global mean; an NNLS fit whose factors must be >= 0;
4. the implicit main path at full width: rank 128 on the reference
   benchmark's ML-20M-shaped synthetic (65,536 x 32,768, seed 0), with
   stage times; then K1 and K2 against their plain versions on the
   heaviest buckets that run staged (the most entries, the most rows and
   the longest rows of each sweep, with their dense heads), with its
   fitted factors; last, a warm full-width fit_transform + predict under
   torch.profiler: the device time of each kernel and copy, and the
   device's busy share of the wall time;
5. the reference benchmark's config #2 at full width on the same matrix
   (its values as ratings), rank 128: (a) explicit CG(3), dynamic lambda,
   n_hot=4096 with presence bits; (b) explicit Cholesky with user/item and
   global biases (d = 129); (c) implicit NNLS on the first 8192 users;
   each re-checks its kernels on its heaviest buckets as phase 4 does.

The kernels' launch counters are reset right before each main-path run
and must show every kernel of that path launched in it.  The
second-to-last line is a JSON object describing the kernels; the last line
is {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero.
``--phases`` runs a subset (phase 1 always runs) and then prints no result
line.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def sweep_summary(sweeps) -> str:
    """The distribution of K4's per-system sweep counts."""
    import torch
    sw = sweeps.float()
    q = torch.quantile(sw, torch.tensor([0.5, 0.9, 0.99], device=sw.device))
    return (f"sweeps p50/p90/p99/max={q[0]:.0f}/{q[1]:.0f}/{q[2]:.0f}/"
            f"{int(sw.max())}")


# -- phase 2: kernels against their plain versions ----------------------------

def _bucket_case(gen, device, B, L, d, H, *, explicit=False, biases=False,
                 bits=False, ugb=False, solver=None, n_src=32768):
    """One bucket with its sweep terms, made on the card: source rows
    (n_src, d), cold entries (implicit confidences 1 + e^u; explicit
    integer ratings -2..2, many stored zeros), source biases, and a dense
    head of H columns about 5% present (explicit: with stored zeros, and
    presence bits when ``bits``; else no zero is stored in the head)."""
    import torch
    from rsparse_tpu_torch.ops import als
    from rsparse_tpu_torch.sparse.device import RowBucket
    f32 = torch.float32
    V = torch.randn((n_src, d), generator=gen, device=device, dtype=f32) * 0.1
    nnz = torch.randint(L // 2, L + 1, (B,), generator=gen, device=device,
                        dtype=torch.int32)
    live = torch.arange(L, device=device)[None, :] < nnz[:, None]
    col = torch.randint(0, n_src, (B, L), generator=gen, device=device,
                        dtype=torch.int32) * live
    u = torch.rand((B, L), generator=gen, device=device)
    val = ((torch.round(u * 4) - 2) if explicit else 1.0 + u.exp()) * live
    bucket = RowBucket(torch.arange(B, device=device, dtype=torch.int32),
                       col.to(torch.int32).contiguous(),
                       val.to(f32).contiguous(), nnz)
    src = V
    if biases:
        xb = torch.randn((n_src, 1), generator=gen, device=device) * 0.1
        src = torch.cat([V, xb], 1)
    cfg = als.ALSConfig(solver=als.CONJUGATE_GRADIENT if solver is None
                        else solver, use_global_bias=ugb,
                        feedback="explicit" if explicit else "implicit",
                        with_biases=biases, dynamic_lambda=explicit)
    g = 0.05 if (ugb or (biases and not explicit)) else 0.0
    lam = 1.0
    src_act, x_biases, XtX, rhs_init = als._sweep_prepare(src, lam, g, cfg,
                                                          f32)
    W = Vh = hb = nnz_tot = None
    if H:
        present = torch.rand((B, H), generator=gen, device=device) < 0.05
        w = torch.rand((B, H), generator=gen, device=device)
        if explicit and bits:
            w = torch.round(w * 4) - 2
        elif explicit:
            w = torch.where(w < 0.5, w - 1.5, w + 0.5)   # no stored zero
        else:
            w = 1.0 + w * 4
        W = (w * present).contiguous()
        Vh = torch.randn((H, d), generator=gen, device=device) * 0.1
        if bits:
            hb = torch.from_numpy(np.packbits(
                present.cpu().numpy(), axis=1, bitorder="little")).to(device)
        if explicit:
            nnz_tot = (nnz + present.sum(1)).to(torch.int32)
    x0 = (torch.rand((B, d), generator=gen, device=device) * 0.01)
    return (src_act, x_biases, XtX, rhs_init, bucket, x0, lam, g, cfg, W, Vh,
            hb, nnz_tot)


def _record(results, name, kern, plain, args, tag, rep, limit_y, limit_loss,
            plain_reps=5, sweeps=None):
    """Hold one kernel against its plain version on the same inputs; time
    both by CUDA events (mean of 5 after a warm-up; ``plain_reps=0`` times
    the single comparison call of the plain version)."""
    import torch
    yk, lk = kern(*args)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    yp, lp = plain(*args)
    t1.record()
    torch.cuda.synchronize()
    ey, el = rel_err(yk, yp), rel_err(lk, lp)
    ms = time_ms(lambda: kern(*args))
    pms = (time_ms(lambda: plain(*args), reps=plain_reps) if plain_reps
           else t0.elapsed_time(t1))
    extra = "" if sweeps is None else " " + sweep_summary(sweeps)
    log(f"  {name:11s} {tag:44s} y_rel={ey:.2e} loss_rel={el:.2e} "
        f"kernel={ms:.3f} ms plain={pms:.3f} ms{extra}")
    require(bool(torch.isfinite(yk).all() and torch.isfinite(lk).all()),
            f"{name} {tag}: non-finite output")
    require(ey <= limit_y and el <= limit_loss, f"{name} {tag}: disagrees "
            f"with its plain version (y {ey:.2e}, loss {el:.2e})")
    r = results[name.split()[1]]
    r["max_abs_err"] = max(r["max_abs_err"], float((yk - yp).abs().max()))
    if rep:
        r.update(ms=ms, plain_ms=pms, shape=tag)
    return yk


def check_als_kernels(device, results) -> None:
    import torch
    from rsparse_tpu_torch.ops import als
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    plain = als._solve_bucket_plain
    cases = []
    # K1, implicit over a grid of row counts and lengths, then with biases
    for (B, L) in ((4096, 8), (2048, 128), (512, 2048)):
        for d in (10, 128):
            for H in (0, 1024):
                cases.append(("K1 als_cg", dict(B=B, L=L, d=d, H=H,
                                                ugb=d == 10),
                              (B, L, d, H) == (2048, 128, 128, 1024)))
    for d in (10, 129):
        cases.append(("K1 als_cg", dict(B=2048, L=128, d=d, H=0, biases=True),
                      False))
    # K1, explicit: biases without a head; a head with presence bits and
    # stored zero ratings; a head without bits
    for d in (10, 128, 129):
        cases.append(("K1 als_cg", dict(B=2048, L=128, d=d, H=0,
                                        explicit=True, biases=True), False))
        cases.append(("K1 als_cg", dict(B=2048, L=128, d=d, H=1024,
                                        explicit=True, bits=True), False))
        cases.append(("K1 als_cg", dict(B=2048, L=128, d=d, H=1024,
                                        explicit=True), False))
    # K2: implicit, with biases, explicit with biases, dense heads
    chol = als.CHOLESKY
    for d in (10, 64, 128):
        cases.append(("K2 als_chol", dict(B=2048, L=128, d=d, H=0,
                                          solver=chol), d == 128))
    for d in (10, 129):
        cases.append(("K2 als_chol", dict(B=2048, L=128, d=d, H=0,
                                          biases=True, solver=chol), False))
        cases.append(("K2 als_chol", dict(B=2048, L=128, d=d, H=0,
                                          explicit=True, biases=True,
                                          solver=chol), False))
    cases.append(("K2 als_chol", dict(B=2048, L=128, d=128, H=1024,
                                      solver=chol), False))
    cases.append(("K2 als_chol", dict(B=2048, L=128, d=128, H=1024,
                                      explicit=True, bits=True, solver=chol),
                  False))
    # K4
    for d, kw in ((10, {}), (64, {}), (129, dict(biases=True)),
                  (64, dict(explicit=True, H=1024, bits=True))):
        cases.append(("K4 als_nnls", dict(B=2048, L=128, d=d,
                                          H=kw.pop("H", 0), solver=als.NNLS,
                                          **kw), d == 129))
    for name, kw, rep in cases:
        B, L, d, H = kw.pop("B"), kw.pop("L"), kw.pop("d"), kw.pop("H")
        args = _bucket_case(gen, device, B, L, d, H, **kw)
        cfg = args[8]
        tag = (f"{cfg.feedback[:3]} B={B} L={L} d={d} H={H}"
               + (" bias" if cfg.with_biases else "")
               + (" bits" if args[11] is not None else "")
               + (" gb" if cfg.use_global_bias else ""))
        if cfg.solver == als.NNLS:
            sweeps = torch.zeros((B,), dtype=torch.int32, device=device)
            kern = functools.partial(als.solve_bucket_nnls, sweeps=sweeps)
            _record(results, name, kern, plain, args, tag, rep, 1e-3, 1e-3,
                    plain_reps=0, sweeps=sweeps)
        else:
            kern = als._SOLVE[cfg.solver]
            _record(results, name, kern, plain, args, tag, rep, 1e-4, 1e-5)


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


# -- phases 3 to 5: the main paths -------------------------------------------

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


def check_launched(kernels, phase: str, names) -> dict:
    """The counts of this run (reset right before it); every kernel of the
    path in ``names`` must have launched."""
    counts = dict(kernels.launches)
    log(f"  launches in {phase}: {counts}")
    for name in names:
        require(counts[name] > 0, f"{phase}: kernel {name} was not launched")
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


def run_ml100k(device, launches) -> None:
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
    launches.append(check_launched(_kernels, "ML-100k implicit main path",
                                   ("als_cg", "als_chol", "topk")))
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

    # the explicit rating gate (rsparse_tpu tests/test_wrmf.py:183-203)
    full = sp.csr_matrix(x)
    tr, te = rt.train_test_split(full, 0.8, np.random.default_rng(7))
    te = te.tocoo()
    mean = tr.data.mean()
    trc = tr.copy()
    trc.data = trc.data - mean
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.WRMF(rank=10, lambda_=0.3, feedback="explicit", solver="cholesky",
                with_user_item_bias=True, seed=0, device=device)
    emb = m.fit_transform(trc, n_iter=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "ML-100k explicit main path",
                                   ("als_chol",)))
    scores = emb.double().cpu().numpy() @ m.components + mean
    rmse = float(np.sqrt(np.mean((scores[te.row, te.col] - te.data) ** 2)))
    base = float(np.sqrt(np.mean((te.data - mean) ** 2)))
    log(f"  explicit biases rank 10: RMSE={rmse:.4f} (global mean {base:.4f})"
        f" iters={len(m.loss_history)} emb {tuple(emb.shape)} "
        f"wall={wall:.2f} s")
    require(bool(torch.isfinite(emb).all()), "ML-100k explicit: non-finite")
    require(rmse < 1.05 and rmse < base, "ML-100k: explicit RMSE gate failed")

    # NNLS (non-negative factors)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.WRMF(rank=10, lambda_=1.0, feedback="implicit", solver="nnls",
                seed=0, device=device)
    m.fit_transform(train, n_iter=5)
    preds = m.predict(train, k=10, not_recommend=train)
    emb = m.transform(train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "ML-100k NNLS main path",
                                   ("als_nnls", "topk")))
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    log(f"  NNLS rank 10: NDCG@10={ndcg:.4f} min(transform)="
        f"{float(emb.min()):.3e} min(components)={m.components.min():.3e} "
        f"loss={m.loss_history} wall={wall:.2f} s")
    require(bool(torch.isfinite(emb).all()), "ML-100k NNLS: non-finite")
    require(float(emb.min()) >= 0 and m.components.min() >= 0,
            "ML-100k NNLS: a negative factor")
    check_predictions(preds.indices, 10, train.shape[1], train, "ML-100k NNLS")


def check_staged_buckets(m, x, results, nnls_max_iter=300) -> None:
    """Each kernel of a fitted model's path against its plain version at
    the shapes the fit gave it: per sweep, the buckets with the most padded
    entries (B x L), the most rows and the longest rows, staged as
    fit_transform stages them, with the fitted factors as sources and warm
    starts.  The error of each against the plain version at float64 is
    printed beside.  K4 is held against its plain version at most
    ``nnls_max_iter`` sweeps (the plain loop costs launches per coordinate
    step); then it runs alone with the fit's own budget, and the
    distribution of its sweeps is printed."""
    import torch
    from rsparse_tpu_torch.ops import als
    lam, g = m.lambda_, m._g
    csr, _, _ = m._fit_matrix(x)
    incl = m._include_empty
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
    closing = als.CHOLESKY if m.solver == als.CONJUGATE_GRADIENT else m.solver
    sweeps = (("item sweep", m._cfg(True), m._U, m._V, item),
              ("user sweep", m._cfg(False), m._V, m._U, user),
              ("closing sweep", m._cfg(False, closing), m._V, None, full))
    for sweep, fit_cfg, src, old, (hot, br, rows) in sweeps:
        cfg = fit_cfg
        if cfg.solver == als.NNLS:
            cfg = dataclasses.replace(cfg, nnls_max_iter=nnls_max_iter)
        name = {als.CONJUGATE_GRADIENT: "K1 als_cg", als.CHOLESKY:
                "K2 als_chol", als.NNLS: "K4 als_nnls"}[cfg.solver]
        src_act, xb, XtX, rhs_init = als._sweep_prepare(src, lam, g, cfg,
                                                        torch.float32)
        _, tgt_sl = als._active_slices(cfg, src.shape[1])
        old_act = (torch.zeros((br.n_rows, src_act.shape[1]),
                               device=src.device) if old is None
                   else old[:, tgt_sl])
        Vh = None if hot is None else src_act[hot.long()].contiguous()
        bs = br.buckets
        picks = sorted({max(range(len(bs)), key=key) for key in (
            lambda i: bs[i].batch * bs[i].pad_len,
            lambda i: bs[i].batch, lambda i: bs[i].pad_len)})
        for bi in picks:
            b = bs[bi]
            W = bits = nnz_tot = None
            if rows is not None:
                W, bits, row_nnz = rows[bi]
                if cfg.feedback == "explicit" and cfg.dynamic_lambda:
                    nnz_tot = row_nnz
            ids = b.row_ids.clamp(max=old_act.shape[0] - 1).long()
            x0 = old_act[ids].contiguous()
            args = (src_act, xb, XtX, rhs_init, b, x0, lam, g, cfg, W, Vh,
                    bits, nnz_tot)
            sw = None
            kern = als._SOLVE[cfg.solver]
            if cfg.solver == als.NNLS:
                sw = torch.zeros((b.batch,), dtype=torch.int32,
                                 device=src.device)
                kern = functools.partial(als.solve_bucket_nnls, sweeps=sw)
            yk, lk = kern(*args)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            yp, lp = als._solve_bucket_plain(*args)
            t1.record()
            d64 = lambda t: None if t is None else t.double()  # noqa: E731
            y64, l64 = als._solve_bucket_plain(
                src_act.double(), d64(xb), d64(XtX), d64(rhs_init), b,
                x0.double(), lam, g, cfg, d64(W), d64(Vh), bits, nnz_tot)
            torch.cuda.synchronize()
            ey, el = rel_err(yk, yp), rel_err(lk, lp)
            ms = time_ms(lambda: kern(*args), reps=3)
            pms = (t0.elapsed_time(t1) if sw is not None else
                   time_ms(lambda: als._solve_bucket_plain(*args), reps=3))
            tag = (f"{sweep} {cfg.feedback[:3]} B={b.batch} L={b.pad_len} "
                   f"d={src_act.shape[1]} H={0 if W is None else W.shape[1]}")
            extra = ("" if sw is None else
                     f" {sweep_summary(sw)} (cap {nnls_max_iter})")
            log(f"  {name:11s} {tag:50s} y_rel={ey:.2e} loss_rel={el:.2e} "
                f"(vs f64: kernel y {rel_err(yk, y64):.2e} loss "
                f"{rel_err(lk, l64):.2e}, plain y {rel_err(yp, y64):.2e} "
                f"loss {rel_err(lp, l64):.2e}) kernel={ms:.3f} ms "
                f"plain={pms:.3f} ms{extra}")
            require(bool(torch.isfinite(yk).all() and torch.isfinite(lk).all()),
                    f"{name} {tag}: non-finite output")
            # K4 squares the conditioning (G = lhs'lhs): where the float32
            # plain version itself is further than 1e-3 from float64, the
            # kernel may differ from it by twice that error
            lim = (max(1e-3, 2 * rel_err(yp, y64)) if sw is not None
                   else 1e-4)
            require(ey <= lim, f"{name} {tag}: y disagrees with its plain "
                    f"version ({ey:.2e} > {lim:.2e})")
            require(cfg.solver != als.CONJUGATE_GRADIENT or el <= 1e-5,
                    f"{name} {tag}: loss disagrees with its plain version "
                    f"({el:.2e})")
            r = results[name.split()[1]]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   float((yk - yp).abs().max()))
            del yk, lk, yp, lp, y64, l64
            if sw is not None:
                # the fit's own budget: the sweeps K4 really runs
                t0.record()
                yk, _ = als.solve_bucket_nnls(*args[:8], fit_cfg, *args[9:],
                                              sweeps=sw)
                t1.record()
                torch.cuda.synchronize()
                log(f"  {name:11s} {tag:50s} budget {fit_cfg.nnls_max_iter}:"
                    f" kernel={t0.elapsed_time(t1):.3f} ms "
                    f"{sweep_summary(sw)}, at the budget "
                    f"{int((sw >= fit_cfg.nnls_max_iter).sum())} of {b.batch}")
                require(bool(torch.isfinite(yk).all()) and
                        float(yk.min()) >= 0, f"{name} {tag}: K4 with the "
                        "fit's budget gave a negative or non-finite factor")


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


def _fit_full_width(device, x, what, names, launches, n_iter=2, **kw):
    """One full-width fit_transform through the public entry point, its
    launch counts and per-sweep times."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    m = rt.WRMF(rank=128, seed=0, device=device, **kw)
    t0 = time.perf_counter()
    emb = m.fit_transform(x, n_iter=n_iter, convergence_tol=-1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches.append(check_launched(_kernels, what, names))
    phases = m.fit_trace.summary()
    staging = fit_s - sum(phases.values())
    log(f"  stages: {m.stage_info}")
    log(f"  fit_transform {fit_s:.3f} s = staging {staging:.3f} s + "
        + " + ".join(f"{k} {v:.4f} s" for k, v in phases.items())
        + "; per sweep: " + ", ".join(
            f"{r['phase']}#{r['iter']} {r['wall_s'] * 1e3:.2f} ms"
            for r in m.fit_trace))
    log(f"  loss {m.loss_history}; peak device memory {peak:.2f} GiB")
    require(tuple(emb.shape) == (x.shape[0], m._R), f"{what}: emb shape")
    require(bool(torch.isfinite(emb).all()), f"{what}: non-finite emb")
    require(np.isfinite(m.components).all(), f"{what}: non-finite items")
    return m, emb


def run_full_width(device, x, launches):
    import torch
    q = x[:4096]
    m, emb = _fit_full_width(
        device, x, "full-width implicit main path",
        ("als_cg", "als_chol"), launches, lambda_=0.1,
        feedback="implicit", solver="conjugate_gradient", n_hot="auto")
    from rsparse_tpu_torch import _kernels
    t0 = time.perf_counter()
    preds = m.predict(q, k=10, not_recommend=q)
    torch.cuda.synchronize()
    log(f"  predict 4096 users k=10 (transform + top-k) "
        f"{time.perf_counter() - t0:.3f} s")
    launches[-1] = check_launched(_kernels, "full-width implicit main path "
                                  "with predict", ("als_cg", "als_chol",
                                                   "topk"))
    require(m.loss_history[1] <= m.loss_history[0], "full width: loss rose")
    check_predictions(preds.indices, 10, x.shape[1], sp.csr_matrix(q),
                      "full width")
    return m


def run_config2(device, x, results, launches) -> None:
    """The reference benchmark's config #2 (bench.py explicit_sweep,
    cholesky_sweep) at full width: rank 128, lambda 0.1, the synthetic's
    values 1 + Exp(3) as ratings."""
    import torch
    log("  (a) explicit, CG(3), dynamic lambda, n_hot=4096 with presence")
    m, _ = _fit_full_width(
        device, x, "config #2 (a)", ("als_cg", "als_chol"), launches,
        lambda_=0.1, feedback="explicit", solver="conjugate_gradient",
        dynamic_lambda=True, n_hot=4096)
    user_s = [r["wall_s"] for r in m.fit_trace if r["phase"] == "users"]
    item_s = [r["wall_s"] for r in m.fit_trace if r["phase"] == "items"]
    log(f"  item half-sweeps {[round(t * 1e3, 2) for t in item_s]} ms, user "
        f"half-sweeps {[round(t * 1e3, 2) for t in user_s]} ms; "
        f"{x.shape[0] / min(user_s):.0f} user-updates/s (best user sweep)")
    require(m.loss_history[1] <= m.loss_history[0], "config #2 (a): loss rose")
    check_staged_buckets(m, x, results)
    del m
    torch.cuda.empty_cache()

    log("  (b) explicit, Cholesky, user/item + global biases (d = 129)")
    m, emb = _fit_full_width(
        device, x, "config #2 (b)", ("als_chol",), launches, lambda_=0.1,
        feedback="explicit", solver="cholesky", with_user_item_bias=True,
        with_global_bias=True)
    require(m.components.shape == (130, x.shape[1]), "config #2 (b): R")
    require(bool((emb[:, 0] == 1).all()), "config #2 (b): user ones column")
    require(m.loss_history[1] <= m.loss_history[0], "config #2 (b): loss rose")
    check_staged_buckets(m, x, results)
    del m, emb
    torch.cuda.empty_cache()

    log("  (c) NNLS, implicit, 1 iteration on the first 8192 users")
    xs = x[:8192]
    m, emb = _fit_full_width(
        device, xs, "config #2 (c)", ("als_nnls",), launches, n_iter=1,
        lambda_=0.1, feedback="implicit", solver="nnls")
    require(float(emb.min()) >= 0 and m.components.min() >= 0,
            "config #2 (c): a negative factor")
    check_staged_buckets(m, xs, results)


# -----------------------------------------------------------------------------

KERNELS = {
    "als_cg": ("rsparse_tpu_torch/csrc/als_cg.cu",
               "rsparse_tpu/ops/als.py:138, rsparse_tpu/ops/als.py:269"),
    "als_chol": ("rsparse_tpu_torch/csrc/als_chol.cu",
                 "rsparse_tpu/ops/als.py:138, rsparse_tpu/ops/als.py:269"),
    "topk": ("rsparse_tpu_torch/csrc/topk.cu", "rsparse_tpu/ops/topk.py:134"),
    "als_nnls": ("rsparse_tpu_torch/csrc/als_nnls.cu",
                 "rsparse_tpu/ops/solvers.py:254"),
}


def main(phases) -> int:
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
    launches = []
    if 2 in phases:
        log("phase 2: kernels against their plain versions")
        check_als_kernels(device, results)
        check_topk_kernel(device, results)
    if 3 in phases:
        log("phase 3: main paths, ML-100k (implicit CG; explicit Cholesky "
            "with biases; NNLS)")
        run_ml100k(device, launches)
    x = None
    if 4 in phases or 5 in phases:
        t0 = time.perf_counter()
        x = synth_ml20m_like()
        log(f"  synth: {x.shape[0]} x {x.shape[1]}, {x.nnz} nnz "
            f"({time.perf_counter() - t0:.2f} s)")
    if 4 in phases:
        log("phase 4: implicit main path at full width (rank 128, "
            "65,536 x 32,768)")
        m = run_full_width(device, x, launches)
        check_staged_buckets(m, x, results)
        log("  profile of a warm full-width fit_transform + predict")
        profile_full_width(m, x)
        del m
        torch.cuda.empty_cache()
    if 5 in phases:
        log("phase 5: config #2 at full width (rank 128, explicit / biases "
            "/ NNLS)")
        run_config2(device, x, results, launches)
    if phases != set(range(1, 6)):
        log(f"phases {sorted(phases)} passed (a subset: no result line)")
        return 0

    total = {name: sum(c[name] for c in launches) for name in KERNELS}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": total[name],
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated phases to run (1 always runs)")
    want = {1} | {int(p) for p in ap.parse_args().phases.split(",") if p}
    try:
        sys.exit(main(want))
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
