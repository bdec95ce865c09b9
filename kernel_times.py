#!/usr/bin/env python3
"""Kernel and staging times of the ``rsparse_tpu_torch`` found under ROOT,
so that two checkouts can be compared within one run on the same card.

    python3 kernel_times.py [--root ROOT] [--reps N] WHAT [WHAT ...]

WHAT is one or more of:

  k1          K1 (the bucketed CG solve) bucket by bucket over both
              half-sweeps of the ML-20M-shaped full-width fits (each
              half-sweep's sum beside the sum of its buckets' bounds, at
              the rates of the routes ``cg_plan`` names), as
              ``chip_smoke.py`` phase 4 fits them (rank 128, implicit CG,
              2 iterations; float32 with ``n_hot="auto"`` and the headline
              ``compute_dtype="bfloat16"``, ``n_hot=4096``), each
              half-sweep's sum, then K1 at the kernel table's shape
              (B=2048 L=128 d=128 H=1024, 5% present, f32 and bf16);
  k8          K8 (FM's block) in predict and update mode from the same
              seeded tables at phase 7 (a)'s shapes, each staged from a
              host CSR by ``staged_glm_blocks``: 32,768 rows x 32 entries
              over 40M features at r = 4 and 8, the same with feature 0 in
              every row, over 10,000 features at r = 8, and config #5's
              131,072 one-hot rows of 2 entries at r = 4;
  k3          K3 (``masked_top_k_bits``) at k = 10 on C = 256 x n = 32,768
              masked, C = 1 x 32,768 masked and C = 256 x 1,682 unmasked,
              each call on other scores than the calls before it (rotating
              copies, together over 64 MB: the L2 holds none of them), and
              ``torch.amax`` over the same rows as a floor for one read;
  fm-staging  ``staged_glm_blocks`` (FM's blocks staged on the host and
              copied to the card, its cache cleared before each call) on
              phase 7 (c)'s two FM inputs: the hashed synthetic (100,000 x
              40M features) and config #5's 2M one-hot rows;
  k8-tiles    K8's update on the k8 blocks with ``csrc/fm.cu`` built at
              tiles of 32, 64, 128 and 256 entries (``RSP_FM_TILE``; the
              ``models/fm.py`` K8_TILE the wrapper plans with set to
              match), each held to the plain version by the largest
              distance of a table's change;
  k7          K7 (FTRL's block) in predict and update mode at phase 7
              (a)'s shapes, each block staged from a host CSR by
              ``staged_glm_blocks``: 32,768 rows x 32 entries over 40M
              features, the same with feature 0 in every row, and over
              10,000 features; on the model's own (z, n) tables
              (``_ensure_state``, filled from a fixed seed) and on two
              separate contiguous copies of them;
  ftrl-pass   FTRL's staged pass at phase 7 (c)'s hashed shape (100,000
              rows x 40M features, 4 blocks): three fresh models, each
              staged (``_stage``) and then passed over (``_run_staged``)
              REPS + 1 times, every pass by the host's clock after a
              synchronise (the first apart, as phase 7 (c) reads it, with
              its device time by CUDA events and the allocator's
              cudaMalloc calls in it), one more pass after
              ``torch.cuda.empty_cache()`` read the same way, and a pass's
              device time by CUDA graphs;
  k10         K10 (GloVe's tail shard) on config #4's first tail shard
              (``_stage_tail(...).shard(0)``, straight and swapped) from
              the model's initial state;

  k2-wide     K2 at d = 514 (``csrc/als_chol_wide.cu``) on phase 11 (a)'s
              synthetic buckets B=256 L=128 and 16 x 8,192 and on 4 x
              2,048 (implicit, no head), with the plan each takes, its
              stages apart (the Gram, the factorisation where
              the design stops after it, the back substitution, the loss)
              beside the plain version and the bound, then the whole
              closing half-sweep of a rank-512 implicit fit (1 iteration)
              on the ML-20M-shaped synthetic, twice;
  k2-wide-buckets  k2-wide's buckets alone (no sweep, no clock build);
  k4-wide     K4 on its wide route (``csrc/als_nnls_wide.cu``) on phase
              11 (a)'s synthetic buckets of 256 rows of up to 128 entries:
              at d = 514 with a 1,024-column head (implicit, global bias:
              the kernels line's shape), at 258 and 161; at the budget of
              ``chip_smoke.WIDE_NNLS_BUDGET`` sweeps beside the plain
              version, and at the fit's own (10,000); each with its plan,
              its launches apart (build, G, mu, the sweeps, the loss), the
              time a coordinate step, the sweeps' percentiles and the
              bound;
  k11-wide    K11's bf16 head on config #4's first tile (3,063 x 3,063)
              at r = 128 and 300, from the model's initial state: CUDA
              events and CUDA-graph device time, the dense mma rate, the
              plain version and the bf16 cuBLAS chain (``chip_smoke.py``
              ``_tile_cublas``), the present cells and the cells flagged
              for an exact re-sum; at 300 on this tree also a build with
              RSP_K11_CLOCKS: the cycles of each phase of one CTA's
              consumer loop and the cells it summed again;

  k9-bf16     K9 at config #5's shape (S = 8,192, K = 20, r = 8, WARP,
              AdaGrad, 200,000 users x 131,072 items) with float32 and with
              bf16 tables from the same seeded values and bits, and at r =
              64: CUDA events over wrapper calls, device time by CUDA
              graphs (the bf16 instance's launches A, G and W), and one
              bf16 wrapper call by op and kernel (``torch.profiler``, CPU
              and CUDA);
  k10-bf16    K10's bf16 instance on config #4's first tail shard,
              straight and swapped, at r = 128 and 300 on both tail paths
              (the scheduled sums, the ordered scatter), beside the float32
              instance on the same shards and the bound
              (``chip_smoke.py`` ``k10_bound``);
  k11-bf16    K11's bf16-state instance on config #4's tiles (0, 0), (1,
              0) transposed and the last (``chip_smoke.py`` ``k11_tiles``)
              at r = 128 and 300, beside the float32-state bf16 head, the
              bf16 cuBLAS chain (``_tile_cublas_bf16``) and the bound
              (``k11_bound``), each launch's device time by
              ``torch.profiler``;
  k11-f32     K11's f32 head (GloVe's default compute dtype) on config
              #4's first tile (0, 0), its last (the padded edge tile, cut to
              its real positions) and the transposed pass's tile (1, 0), at
              r = 128 and 300, from the model's initial state: CUDA events,
              CUDA-graph device time, the present cells, the bound
              (``chip_smoke.py`` ``k11_bound``), the plain version and, at
              tile (0, 0), the f32 cuBLAS chain (``_tile_cublas_f32``);

  k11-walk    K11's bf16-state walk built with RSP_K11_WALK_CLOCKS on
              k11-bf16's tiles at r = 128 and 300: the clock cycles of each
              phase of one CTA's steps, its present cells and those it
              summed again in float64 (this tree only);

k7 and k10 also print each launch's device time by ``torch.profiler``;
k2-wide on this tree also builds ``csrc/als_chol_wide.cu`` with
RSP_CHOL_CLOCKS and prints the cycles of each phase of one cluster's CTAs.

Needs one CUDA card.  The data and the timers are this checkout's
``chip_smoke.py`` (``time_ms``: CUDA events over wrapper calls after a
warm-up; ``graph_ms``: device time by CUDA graphs); its helpers import the
package only inside functions, so they run against the package under ROOT.
k1, k8, k3, fm-staging, k7, ftrl-pass and k10 use only entry points that
older checkouts of the port have too (``_stage_tail(...).shard(0)``,
``_glove_shard``, ``staged_glm_blocks``, ``_ftrl_block``, FTRL's
``_stage`` / ``_run_staged`` and the like); k8-tiles needs a
``csrc/fm.cu`` that reads ``RSP_FM_TILE``.  Every kernel time is printed
twice: CUDA events over wrapper calls, and the device time by CUDA
graphs.  ``chip_smoke.py`` holds each kernel to its plain version.
"""

import argparse
import ctypes
import functools
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

HASHED = 40_000_000
ONE_HOT = (10_000_000, 131_072)
FM_TILES = (32, 64, 128, 256)


def _chip_smoke():
    """This checkout's chip_smoke.py."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bucket_times(m, x, tag, reps):
    """K1's ms on every bucket of both half-sweeps of the fitted model."""
    import torch
    from rsparse_tpu_torch.ops import als
    cs = sys.modules["chip_smoke"]
    lam, g = m.lambda_, m._g
    csr, _, _ = m._fit_matrix(x)
    incl = m._include_empty
    for sweep, cfg, src, old, staged in (
            ("items", m._cfg(True), m._U, m._V, m._stage(csr.T.tocsr(), incl)),
            ("users", m._cfg(False), m._V, m._U, m._stage(csr, incl))):
        hot, br, rows = staged
        src_act, xb, XtX, rhs_init = als._sweep_prepare(src, lam, g, cfg,
                                                        torch.float32)
        src_act = als._gather_src(src_act, cfg, torch.float32)
        _, tgt_sl = als._active_slices(cfg, src.shape[1])
        old_act = old[:, tgt_sl].float()
        Vh = None if hot is None else src_act[hot.long()].contiguous()
        total, tb, to = 0.0, 0.0, 0.0
        for bi, b in enumerate(br.buckets):
            W = bits = scale = None
            if rows is not None:
                W, bits, _, scale = rows[bi]
            x0 = old_act[b.row_ids.clamp(max=old_act.shape[0] - 1).long()
                         ].contiguous()
            args = (src_act, xb, XtX, rhs_init, b, x0, lam, g, cfg, W, Vh,
                    bits, None)
            ms = cs.time_ms(lambda: als.solve_bucket_cg(
                *args, hot_scale=scale), reps=reps)
            total += ms
            if hasattr(als, "cg_plan"):  # the bound at the route's rates
                pb, po = cs.als_bound_parts(
                    args, hot_scale=scale,
                    plan=als.cg_plan(*args, hot_scale=scale))
                tb, to = tb + pb, to + po
            H = 0 if W is None else W.shape[1]
            print(f"  {tag} {sweep} {b.batch} x {b.pad_len} H={H} "
                  f"K1 {ms:.3f} ms", flush=True)
        bound = (f", bound {max(tb, to):.4f} ms "
                 f"({'bytes' if tb >= to else 'operations'})" if tb else "")
        print(f"  {tag} {sweep} half-sweep, {len(br.buckets)} buckets: "
              f"K1 {total:.3f} ms{bound}", flush=True)
        torch.cuda.empty_cache()


def k1_times(dev, reps):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.ops import als
    cs = sys.modules["chip_smoke"]
    x = cs.synth_ml20m_like()
    for tag, kw in (("f32", dict(n_hot="auto")),
                    ("bf16", dict(compute_dtype="bfloat16", n_hot=4096))):
        m = rt.WRMF(rank=128, seed=0, device=dev, lambda_=0.1,
                    feedback="implicit", solver="conjugate_gradient", **kw)
        m.fit_transform(x, n_iter=2, convergence_tol=-1)
        torch.cuda.synchronize()
        bucket_times(m, x, tag, reps)
        del m
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args32 = cs._bucket_case(gen, dev, 2048, 128, 128, 1024)
    for tag, (args, scale) in (
            ("f32", (args32, None)),
            ("bf16", cs._lowp_case(args32, True, "bf16", "bfloat16"))):
        ms = cs.time_ms(lambda: als.solve_bucket_cg(*args, hot_scale=scale))
        print(f"  table shape imp B=2048 L=128 d=128 H=1024 {tag}: "
              f"K1 {ms:.3f} ms", flush=True)


def _csr(rng, n_rows, n_feat, per_row, bias=False):
    cols = rng.integers(0, n_feat, (n_rows, per_row))
    if bias:
        cols[:, 0] = 0
    x = sp.csr_matrix((rng.standard_normal(n_rows * per_row).astype(
        np.float32), cols.reshape(-1), np.arange(0, n_rows * per_row + 1,
                                                 per_row)),
        shape=(n_rows, n_feat))
    x.sum_duplicates()
    return x


def fm_cases(dev):
    """(tag, block, state, y, weights) at phase 7 (a)'s shapes, the blocks
    staged by the package under ROOT, the tables from a fixed seed."""
    import torch
    from rsparse_tpu_torch.ops import segsum
    rng = np.random.default_rng(0)
    u = rng.integers(0, ONE_HOT[0], 131_072)
    i = rng.integers(0, ONE_HOT[1], 131_072)
    one_hot = sp.csr_matrix(
        (np.ones(2 * len(u), np.float32), np.stack(
            [u, ONE_HOT[0] + i], 1).reshape(-1),
         np.arange(0, 2 * len(u) + 1, 2)), shape=(len(u), sum(ONE_HOT)))
    cases = [("B=32768 L=32 F=10000 r=8", _csr(rng, 32768, 10_000, 32), 8),
             ("B=32768 L=32 F=40000000 r=4", _csr(rng, 32768, HASHED, 32), 4),
             ("B=32768 L=32 F=40000000 r=8", _csr(rng, 32768, HASHED, 32), 8),
             ("B=32768 L=32 F=40000000 r=8 bias column",
              _csr(rng, 32768, HASHED, 32, bias=True), 8),
             ("config #5 one-hot B=131072 L=8 r=4", one_hot, 4)]
    gen = torch.Generator(device=dev)
    for tag, x, r in cases:
        gen.manual_seed(7)
        (blk,) = segsum.staged_glm_blocks(x, torch.float32, dev)
        B, F1 = blk.col_idx.shape[0], x.shape[1] + 1
        kw = dict(generator=gen, device=dev)
        state = (torch.full((), 0.1, device=dev),
                 torch.full((), 1.5, device=dev),
                 torch.randn((F1,), **kw) * 0.1,
                 torch.randn((F1, r), **kw) * 0.1,
                 1 + torch.rand((F1,), **kw), 1 + torch.rand((F1, r), **kw))
        y = (torch.rand((B,), **kw) < 0.5).float() * 2 - 1
        w = torch.rand((B,), **kw) + 0.5
        yield tag, blk, state, y, w
        del state, blk
        torch.cuda.empty_cache()


#: FM's hyperparameters in the timed calls (lr_w, lr_v, lambda_w, lambda_v,
#: binomial, intercept)
FM_ARGS = (0.2, 0.2, 0.01, 0.02, 1, True)


def k8_times(dev, reps):
    from rsparse_tpu_torch.models import fm
    cs = sys.modules["chip_smoke"]
    for tag, blk, state, y, w in fm_cases(dev):
        calls = [lambda upd=upd: fm._fm_block(*state, blk, y, w, *FM_ARGS,
                                              upd)
                 for upd in (False, True)]
        ms = [cs.time_ms(fn, reps) for fn in calls]
        dms = [cs.graph_ms([fn], reps) for fn in calls]
        print(f"  K8 {tag}: predict {ms[0]:.4f} ms (device {dms[0]:.4f}), "
              f"update {ms[1]:.4f} ms (device {dms[1]:.4f})", flush=True)


def _variant(source, defines, entries):
    """``csrc/<source>`` alone built with ``defines`` (-D flags), its
    ``entries`` typed as the package's."""
    from rsparse_tpu_torch import _kernels
    tag = "_".join(d.replace("=", "") for d in defines)
    out = os.path.join(_kernels.BUILD_DIR, f"{source}_{tag}.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS[:-2], "-shared",
                    *(f"-D{d}" for d in defines), "-o", out,
                    os.path.join(_kernels.CSRC, f"{source}.cu")],
                   check=True, capture_output=True, text=True, timeout=600)
    so = ctypes.CDLL(out)
    for name in entries:
        fn, ref = getattr(so, name), getattr(_kernels.lib(), name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return so


def _has_define(source, name):
    """Whether ``csrc/<source>.cu`` of the package under test reads the
    -D flag ``name`` (an older checkout may not have a timing build)."""
    from rsparse_tpu_torch import _kernels
    with open(os.path.join(_kernels.CSRC, f"{source}.cu")) as f:
        return f"#ifdef {name}" in f.read()


def _fm_variant(tile):
    """csrc/fm.cu alone built with RSP_FM_TILE = ``tile``."""
    return _variant("fm", [f"RSP_FM_TILE={tile}"], ["rsp_fm_block"])


def k8_tile_times(dev, reps):
    import torch
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.models import fm
    cs = sys.modules["chip_smoke"]
    shipped, lib = fm.K8_TILE, _kernels.lib
    variants = {t: _fm_variant(t) for t in FM_TILES}
    names = ("w0", "acc_w0", "w", "v", "acc_w", "acc_v")
    try:
        for tag, blk, state, y, w in fm_cases(dev):
            sp_ = [t.clone() for t in state]
            fm._fm_block_plain(*sp_, blk, y, w, *FM_ARGS, True)
            rows = blk.feats.long()
            out = []
            for t, so in variants.items():
                fm.K8_TILE, _kernels.lib = t, (lambda so=so: so)
                sk = [s.clone() for s in state]
                fm._fm_block_cuda(*sk, blk, y, w, *FM_ARGS, True)
                torch.cuda.synchronize()
                rel = max(cs._delta_err(a, b, t0, rows if t0.dim() else None
                                        )[0]
                          for a, b, t0 in zip(sk, sp_, state))
                dms = cs.graph_ms([lambda: fm._fm_block_cuda(
                    *sk, blk, y, w, *FM_ARGS, True)], reps=reps)
                out.append(f"{t} entries {dms:.4f} (off plain {rel:.1e})")
                del sk
            print(f"  K8 tiles {tag}: update device ms (CUDA graphs; a "
                  f"table's change off the plain version, max over "
                  f"{', '.join(names)}) at " + ", ".join(out), flush=True)
            del sp_
    finally:
        fm.K8_TILE, _kernels.lib = shipped, lib


def k3_times(dev, reps):
    import torch
    from rsparse_tpu_torch.ops import topk
    cs = sys.modules["chip_smoke"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for C, n, masked in ((256, 32768, True), (1, 32768, True),
                         (256, 1682, False)):
        copies = max(4, -(-(64 << 20) // (C * n * 4)))
        big = (torch.randn((copies * C, n), generator=gen, device=dev)
               * 4).round() / 4
        bits = None
        if masked:
            m = torch.rand((copies * C, n), generator=gen, device=dev) < 0.3
            bits = torch.from_numpy(np.packbits(
                m.cpu().numpy(), axis=1, bitorder="little")).to(dev)
        calls = [functools.partial(
            topk.masked_top_k_bits, big[j * C:(j + 1) * C],
            None if bits is None else bits[j * C:(j + 1) * C], 10, 0.25)
            for j in range(copies)]
        ms = cs.time_ms(cs._rotating(calls), max(reps, copies))
        dms = cs.graph_ms(calls)
        amax = cs.graph_ms([functools.partial(torch.amax, big[j * C:(j + 1)
                                                              * C], 1)
                            for j in range(copies)])
        tag = f"C={C} n={n} k=10 " + ("masked" if masked else "no mask")
        print(f"  K3 {tag}: {ms:.4f} ms (device {dms:.4f}; L2 cold, {copies} "
              f"rotating copies); torch.amax over the same rows: device "
              f"{amax:.4f}", flush=True)
        del big, bits
        torch.cuda.empty_cache()


def fm_staging_times(dev, reps):
    import torch
    from rsparse_tpu_torch.ops import segsum
    from rsparse_tpu_torch.sparse.device import clear_staging_cache
    cs = sys.modules["chip_smoke"]
    x, _ = cs.synth_glm(n_feat=cs.HASHED_FEATURES)
    _, fmx, _ = cs.synth_config5(**cs.CONFIG5)
    for tag, csr in (("FM hashed 100,000 x 40M", sp.csr_matrix(x)),
                     ("config #5 FM one-hot", sp.csr_matrix(fmx))):
        walls = []
        for _ in range(reps):
            clear_staging_cache()
            t0 = time.perf_counter()
            blocks = segsum.staged_glm_blocks(csr, torch.float32, dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del blocks
        print(f"  staged_glm_blocks {tag} ({csr.shape[0]} rows, {csr.nnz} "
              f"nnz): " + ", ".join(f"{s:.3f}" for s in walls) + " s",
              flush=True)
    clear_staging_cache()


def launch_split(fn, reps):
    """Device ms a call of each kernel ``fn`` launches, by torch.profiler
    over ``reps`` calls after a warm-up, as "name ms" pairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = e.cuda_time_total
        if total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            out.append(f"{name} {total / reps / 1e3:.4f}")
    return ", ".join(out)


#: FTRL's hyperparameters in the timed calls (chip_smoke.FTRL_PARAMS:
#: lr, decay, l1, l2; no dropout, binomial)
FTRL_ARGS = (0.1, 0.5, 0.7, 0.3, 0.0, None, 1)


def k7_times(dev, reps):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.models import ftrl
    from rsparse_tpu_torch.ops import segsum
    cs = sys.modules["chip_smoke"]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    for tag, x in (("B=32768 L=32 F=40000000", _csr(rng, 32768, HASHED, 32)),
                   ("B=32768 L=32 F=40000000 bias column",
                    _csr(rng, 32768, HASHED, 32, bias=True)),
                   ("B=32768 L=32 F=10000", _csr(rng, 32768, 10_000, 32))):
        (blk,) = segsum.staged_glm_blocks(x, torch.float32, dev)
        B = blk.col_idx.shape[0]
        gen.manual_seed(7)
        kw = dict(generator=gen, device=dev)
        m = rt.FTRL(learning_rate=0.1, lambda_=1.0, seed=0, device=dev)
        m._ensure_state(x.shape[1])
        m.z.copy_(torch.randn(m.z.shape, **kw))
        m.n.copy_(torch.rand(m.n.shape, **kw) * 4)
        y = (torch.rand((B,), **kw) < 0.5).float()
        w = torch.rand((B,), **kw) + 0.5
        for what, (z, n) in (("model tables", (m.z, m.n)),
                             ("separate tables", (m.z.clone(),
                                                  m.n.clone()))):
            calls = [lambda upd=upd: ftrl._ftrl_block(z, n, blk, y, w,
                                                      *FTRL_ARGS, upd)
                     for upd in (False, True)]
            ms = [cs.time_ms(fn, reps) for fn in calls]
            dms = [cs.graph_ms([fn], reps) for fn in calls]
            print(f"  K7 {tag}, {what}: predict {ms[0]:.4f} ms (device "
                  f"{dms[0]:.4f}), update {ms[1]:.4f} ms (device "
                  f"{dms[1]:.4f}); update by launch: "
                  f"{launch_split(calls[1], reps)}", flush=True)
        del m, blk
        torch.cuda.empty_cache()



#: fresh FTRL models ftrl-pass stages and times
FTRL_PASS_TRIALS = 3


def ftrl_pass_times(dev, reps):
    import torch
    import rsparse_tpu_torch as rt
    cs = sys.modules["chip_smoke"]
    x, truth = cs.synth_glm(n_feat=cs.HASHED_FEATURES)
    n_rows, sync = x.shape[0], torch.cuda.synchronize

    def timed(fn):
        """One call: host ms after a synchronise, device ms by CUDA
        events, and the caching allocator's cudaMalloc calls in it."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
        t0 = time.perf_counter()
        ev[0].record()
        fn()
        ev[1].record()
        sync()
        host = (time.perf_counter() - t0) * 1e3
        mallocs = torch.cuda.memory_stats().get("num_device_alloc",
                                                0) - mallocs
        return host, ev[0].elapsed_time(ev[1]), mallocs

    for trial in range(FTRL_PASS_TRIALS):
        m = rt.FTRL(learning_rate=0.1, lambda_=1.0, seed=0, device=dev)
        m._ensure_state(x.shape[1])
        staged = m._stage(x, truth, None, True)
        fn = lambda: m._run_staged(staged, do_update=True,  # noqa: E731
                                   materialize=False)
        sync()
        first = timed(fn)
        rest = np.sort([timed(fn)[0] for _ in range(reps)])
        med = float(np.median(rest))
        torch.cuda.empty_cache()
        again = timed(fn)
        print(f"  FTRL hashed pass, model {trial} ({len(staged[1])} blocks): "
              f"first {first[0]:.4f} ms = {n_rows / first[0] * 1e3:.0f} "
              f"rows/s (device {first[1]:.4f} by events, {first[2]} "
              f"cudaMalloc); next {reps}: min {rest[0]:.4f} / median "
              f"{med:.4f} / max {rest[-1]:.4f} ms (median "
              f"{n_rows / med * 1e3:.0f} rows/s); after empty_cache "
              f"{again[0]:.4f} ms (device {again[1]:.4f}, {again[2]} "
              f"cudaMalloc); device {cs.graph_ms([fn], reps):.4f} ms a "
              f"pass by CUDA graphs", flush=True)
        del m, staged, fn
        torch.cuda.empty_cache()


def k10_times(dev, reps):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.models import glove
    cs = sys.modules["chip_smoke"]
    x4 = cs.synth_glove(**cs.CONFIG4)
    _, _, rem = glove._split_head(x4, cs.GLOVE_AUTO_HOT, np.float32)
    tail = glove._stage_tail(rem, cs.GLOVE_KW["batch_size"], torch.float32,
                             dev)
    hp = (cs.GLOVE_KW["x_max"], 0.75, cs.GLOVE_KW["learning_rate"])
    st0 = rt.GloVe(**cs.GLOVE_KW, device=dev)._init_state(x4.shape[0])
    for what, sh in (("shard 0", tail.shard(0)),
                     ("swapped shard 0", tail.swapped().shard(0))):
        st = glove.GloveState(*(t.clone() for t in st0))
        fn = lambda: glove._glove_shard(st, sh, *hp)  # noqa: E731
        ms, dms = cs.time_ms(fn, reps), cs.graph_ms([fn], reps)
        print(f"  K10 config #4 {what} (N={sh.rows.shape[0]}, "
              f"U={sh.feats_r.shape[0]}/{sh.feats_c.shape[0]}): {ms:.4f} ms "
              f"(device {dms:.4f}); by launch: {launch_split(fn, reps)}",
              flush=True)
        del st


#: the phases csrc/als_chol_wide.cu's RSP_CHOL_CLOCKS build times
K2_PHASES = ("Gram", "own rows solved", "next diagonal block",
             "panel barriers", "column block copy and trailing updates",
             "back substitution (waits and own blocks)", "its closing barrier",
             "loss")


def k2_wide_clocks(args):
    """The wide K2 built with RSP_CHOL_CLOCKS on ``args``: the clock cycles
    of each phase, summed over the first cluster's rows, a CTA a line."""
    import torch
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.ops import als
    so = _variant("als_chol_wide", ["RSP_CHOL_CLOCKS"], ["rsp_als_chol_wide"])
    a, y, loss = als._bucket_args(*args, kernel="als_chol")
    _kernels.check(so.rsp_als_chol_wide(ctypes.byref(a), 3,
                                        _kernels.stream(loss.device)),
                   "als_chol")
    torch.cuda.synchronize()
    plan = als.cholesky_plan(*args)
    n = plan["cluster"]
    clk = loss[:8 * n].view(n, 8).double().cpu().numpy()
    rows = -(-a.B // plan["clusters"])
    print(f"  K2 wide clocks of cluster 0 ({rows} rows), thousands of cycles"
          f" by phase: {', '.join(K2_PHASES)}", flush=True)
    for c in range(n):
        print("    CTA %d: %s" % (c, " ".join(f"{v / 1e3:9.1f}"
                                             for v in clk[c])), flush=True)


def k2_wide_times(dev, reps, sweep=True):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.ops import als
    cs = sys.modules["chip_smoke"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for B, L in ((256, 128), (16, 8192), (4, 2048)):
        args = cs._bucket_case(gen, dev, B, L, 514, 0, solver=als.CHOLESKY)
        plan = als.cholesky_plan(*args)
        # the cluster design stops after the factorisation too (stages=4)
        cluster = "clusters" in plan
        t = {st: cs.time_ms(lambda st=st: als.solve_bucket_cholesky(
            *args, stages=st), reps) for st in ((1, 4, 2, 3) if cluster
                                                else (1, 2, 3))}
        yk, lk = als.solve_bucket_cholesky(*args)
        yp, lp = als._solve_bucket_plain(*args)
        pms = cs.time_ms(lambda: als._solve_bucket_plain(*args), 3)
        bms, bby = cs.als_bound(args, plan=plan)
        parts = (f"Gram {t[1]:.3f}, factorisation {t[4] - t[1]:.3f}, back "
                 f"substitution {t[2] - t[4]:.3f}" if cluster else
                 f"Gram {t[1]:.3f}, factorisation and back substitution "
                 f"{t[2] - t[1]:.3f}")
        print(f"  K2 wide B={B} L={L} d=514: {t[3]:.3f} ms ({parts}, loss "
              f"{t[3] - t[2]:.3f}) plain {pms:.3f} bound {bms:.4f} ({bby}); "
              f"y_rel {cs.rel_err(yk, yp):.2e} loss_rel "
              f"{cs.rel_err(lk, lp):.2e}; plan {plan}", flush=True)
        if cluster and B == 256 and sweep:
            k2_wide_clocks(args)
        del args, yk, lk, yp, lp
        torch.cuda.empty_cache()
    if not sweep:
        return
    # the closing half-sweep of a rank-512 implicit fit (one iteration) on
    # the ML-20M-shaped synthetic, every bucket as fit_transform launches
    # them
    x = cs.synth_ml20m_like()
    m = rt.WRMF(rank=512, lambda_=0.1, feedback="implicit",
                solver="conjugate_gradient", n_hot="auto", seed=0,
                device=dev)
    m.fit_transform(x, n_iter=1)
    csr, _, _ = m._fit_matrix(x)
    br = m._bucketize(csr, m._include_empty)
    cfg = m._cfg(False, als.CHOLESKY)
    src_act, xb, XtX, rhs_init = als._sweep_prepare(m._V, m.lambda_, m._g,
                                                    cfg, torch.float32)
    src_act = als._gather_src(src_act, cfg, torch.float32)
    for _ in range(2):
        cs._k2_sweep(None, src_act, xb, XtX, rhs_init, br.buckets,
                     m.lambda_, m._g, cfg, br.n_rows)


def k4_wide_times(dev, reps):
    import dataclasses
    import torch
    from rsparse_tpu_torch.ops import als, solvers
    cs = sys.modules["chip_smoke"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    for d, H, kw in ((514, 1024, dict(ugb=True)), (258, 0, {}),
                     (161, 0, {})):
        args = cs._bucket_case(gen, dev, 256, 128, d, H, solver=als.NNLS,
                               nnls_max_iter=cs.WIDE_NNLS_BUDGET, **kw)
        tag = f"B=256 L=128 d={d} H={H}" + (" gb" if kw else "")
        for budget in (cs.WIDE_NNLS_BUDGET, solvers.SCD_MAX_ITER):
            a = (*args[:8], dataclasses.replace(args[8],
                                                nnls_max_iter=budget),
                 *args[9:])
            sw = torch.zeros((256,), dtype=torch.int32, device=dev)
            run = functools.partial(als.solve_bucket_nnls, *a, sweeps=sw)
            yk, _ = run()
            ms = cs.time_ms(run, reps)
            plan, detail = cs.k4_wide_detail(a, None, sw)
            bms, bby = cs.als_bound(a, sw)
            line = (f"  K4 wide {tag} budget {budget}: {ms:.3f} ms; bound "
                    f"{bms:.4f} ms ({bby}); {cs.sweep_summary(sw)}")
            if budget == cs.WIDE_NNLS_BUDGET:
                t0 = time.perf_counter()
                yp, _ = als._solve_bucket_plain(*a)
                torch.cuda.synchronize()
                pms = (time.perf_counter() - t0) * 1e3
                line += (f"; plain {pms:.1f} ms (one call), y_rel "
                         f"{cs.rel_err(yk, yp):.2e}")
            print(line + "\n    " + detail, flush=True)
        del args
        torch.cuda.empty_cache()


#: the phases csrc/glove_dense.cu's RSP_K11_CLOCKS build times (a consumer
#: warpgroup's thread 0 of CTA 0)
K11_PHASES = ("waits for a stage", "S", "cost and cost^2 (with re-sums)",
              "exchange", "waits for the squares", "products",
              "item ends")


def k11_wide_clocks(st, rows, cols, x, hp):
    """K11's wide kernel built with RSP_K11_CLOCKS on one bf16 tile: the
    clock cycles of each phase of CTA 0's consumer loop and the cells CTA 0
    summed again exactly."""
    import torch
    from rsparse_tpu_torch import _kernels
    so = _variant("glove_dense", ["RSP_K11_CLOCKS"],
                  ["rsp_glove_tile", "rsp_glove_tile_scratch"])
    n_r, n_c, r = rows.numel(), cols.numel(), st.w_i.shape[1]
    dev = x.device
    dump = torch.zeros((2, n_r, n_c), dtype=torch.float32, device=dev)
    # an older checkout's entry points may take no state_bf16 flag, or no
    # such flag in the scratch size
    flags = (0,)[:len(so.rsp_glove_tile.argtypes) - 24]
    scratch = torch.empty((so.rsp_glove_tile_scratch(
        n_r, n_c, r, 1, *flags[:len(so.rsp_glove_tile_scratch.argtypes)
                              - 4]),), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    _kernels.check(so.rsp_glove_tile(
        _kernels.ptr(rows), _kernels.ptr(cols), n_r, n_c, _kernels.ptr(x),
        x.stride(0), x.stride(1), 1, *flags,
        *(_kernels.ptr(t) for t in st), r,
        *hp, _kernels.ptr(scratch), _kernels.ptr(loss), _kernels.ptr(dump),
        _kernels.stream(dev)), "glove_dense")
    torch.cuda.synchronize()
    v = dump.view(-1)[:9].double().cpu().numpy()
    print("  K11 wide clocks of CTA 0's consumer loop, thousands of cycles: "
          + ", ".join(f"{n} {c / 1e3:.1f}" for n, c in zip(K11_PHASES, v))
          + f"; cells it summed again exactly {int(v[8])}", flush=True)


def k11_wide_times(dev, reps):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.models import glove
    cs = sys.modules["chip_smoke"]
    x4 = cs.synth_glove(**cs.CONFIG4)
    hot, X, _ = glove._split_head(x4, cs.GLOVE_AUTO_HOT, np.float32)
    head = glove._stage_head(X, hot, torch.bfloat16,
                             cs.GLOVE_KW["batch_size"], dev)
    del X
    hp = (cs.GLOVE_KW["x_max"], 0.75, cs.GLOVE_KW["learning_rate"])
    span = slice(0, min(head.ids.shape[0], head.side))
    rows = cols = head.ids[span]
    xv = head.x[span, span]
    n = rows.numel()
    for r in (128, 300):
        st0 = rt.GloVe(**dict(cs.GLOVE_KW, rank=r),
                       device=dev)._init_state(x4.shape[0])
        st = glove.GloveState(*(t.clone() for t in st0))
        fn = lambda: glove._glove_tile_cuda(  # noqa: E731
            st, rows, cols, xv, *hp, torch.bfloat16)
        ms = cs.time_ms(fn, reps)
        try:
            dms = f"{cs.graph_ms([fn], reps):.4f}"
        except Exception as e:  # noqa: BLE001 - a capture the card refuses
            dms = f"not measured ({type(e).__name__})"
        pms = cs.time_ms(lambda: glove._glove_tile_plain(
            st, rows, cols, xv, *hp, torch.bfloat16), 3)
        lms = cs.time_ms(lambda: cs._tile_cublas(st, rows, cols, xv, *hp),
                         reps)
        flops = 12 * n * n * r
        print(f"  K11 config #4 tile (0, 0) {n} x {n} bf16 r={r}: {ms:.4f} ms"
              f" (device {dms}), {flops / ms / 1e9:.1f} TFLOP/s of dense mma "
              f"work; plain {pms:.3f}, cuBLAS chain {lms:.3f} ms; present "
              f"{int((xv > 0).sum())}, ~{cs.k11_flagged(st0, rows, cols, xv)} "
              "flagged for an exact re-sum a side", flush=True)
        if r > 128 and _has_define("glove_dense", "RSP_K11_CLOCKS"):
            k11_wide_clocks(glove.GloveState(*(t.clone() for t in st0)),
                            rows, cols, xv, hp)
        del st, st0
        torch.cuda.empty_cache()


#: the phases csrc/glove_dense.cu's RSP_K11_WALK_CLOCKS build times (thread
#: 0 of the bf16-state walk's CTA (0, 0, 0), over its steps)
K11_WALK_PHASES = ("wait for the step's rows", "the step's S on mma",
                   "the present cells' S, cost", "wait for the next counts",
                   "compaction and the next rows' issue", "the cost block",
                   "its barrier", "the products on mma")


def k11_walk_times(dev, reps):
    """K11's bf16-state walk built with RSP_K11_WALK_CLOCKS on config #4's
    three tiles at r = 128 and 300: the cycles of each phase of CTA (0, 0,
    0)'s steps, its present cells and those it summed again in float64."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.models import glove
    cs = sys.modules["chip_smoke"]
    so = _variant("glove_dense", ["RSP_K11_WALK_CLOCKS"],
                  ["rsp_glove_tile", "rsp_glove_tile_scratch"])
    x4, head, _ = _glove_config4(dev, torch.float32)
    hp = (cs.GLOVE_KW["x_max"], 0.75, cs.GLOVE_KW["learning_rate"])
    for r in (128, 300):
        st0 = rt.GloVe(**dict(cs.GLOVE_KW, rank=r, precision="bfloat16"),
                       device=dev)._init_state(x4.shape[0])
        hpb = tuple(glove._bf16_value(v) for v in hp)
        for (ti, tj), trans, xv, rows, cols in cs.k11_tiles(head):
            st = glove.GloveState(*(t.clone() for t in st0))
            n_r, n_c = rows.numel(), cols.numel()
            scratch = torch.empty((so.rsp_glove_tile_scratch(
                n_r, n_c, r, 1, 1),), dtype=torch.float32, device=dev)
            loss = torch.empty((), dtype=torch.float32, device=dev)
            _kernels.check(so.rsp_glove_tile(
                _kernels.ptr(rows), _kernels.ptr(cols), n_r, n_c,
                _kernels.ptr(xv), xv.stride(0), xv.stride(1), 1, 1,
                *(_kernels.ptr(t) for t in st), r, *hpb,
                _kernels.ptr(scratch), _kernels.ptr(loss), None,
                _kernels.stream(dev)), "glove_dense")
            torch.cuda.synchronize()
            v = scratch[:10].double().cpu().numpy()
            print(f"  K11 walk clocks r={r} tile ({ti}, {tj})"
                  + (" transposed" if trans else "")
                  + ": thousands of cycles of CTA (0, 0, 0)'s steps: "
                  + ", ".join(f"{n} {c / 1e3:.1f}"
                              for n, c in zip(K11_WALK_PHASES, v))
                  + f"; its present cells {int(v[9])}, summed again "
                  f"{int(v[8])}", flush=True)
            del st
        del st0
        torch.cuda.empty_cache()


def k9_bf16_times(dev, reps):
    import torch
    from rsparse_tpu_torch.models import rankmf
    cs = sys.modules["chip_smoke"]
    x, _, _ = cs.synth_config5(**dict(cs.CONFIG5, n_users=cs.K9_USERS,
                                      fm_rows=0), seed=1)
    pos = rankmf._stage_positives(x, dev)
    n_user, n_item = x.shape
    S, K = cs.K9_BATCH
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    hp = rankmf.BatchParams(lr=0.5, gamma=0.9, lam_u=0.01, lam_ip=0.01,
                            lam_in=0.01, margin=0.1)
    cfg = rankmf.BatchConfig(S, K, rankmf.WARP, rankmf.IDENTITY,
                             rankmf.ADAGRAD, True)
    for r in (8, 64):
        base = (torch.randn((n_user, r), generator=gen, device=dev) * 0.1,
                torch.randn((n_item, r), generator=gen, device=dev) * 0.1,
                1 + torch.rand((n_user,), generator=gen, device=dev),
                1 + torch.rand((n_item,), generator=gen, device=dev))
        bits = torch.randint(0, 1 << 32, (S, K + 2), generator=gen,
                             device=dev, dtype=torch.int64)
        for dt in (torch.float32, torch.bfloat16):
            tabs = [t.to(dt) for t in base]
            h = hp if dt == torch.float32 else rankmf.BatchParams(
                *(rankmf.bf16_value(v) for v in hp))
            fn = lambda: rankmf._rankmf_batch(  # noqa: E731
                *tabs, bits, pos, None, None, h, cfg, n_item)
            ms, dms = cs.time_ms(fn, reps), cs.graph_ms([fn], reps)
            print(f"  K9 S={S} K={K} r={r} WARP AdaGrad {str(dt)[6:]} "
                  f"tables: {ms:.4f} ms (device {dms:.4f})", flush=True)
            if dt == torch.bfloat16 and r == 8:
                # one wrapper call by op and kernel
                act = torch.profiler.ProfilerActivity
                with torch.profiler.profile(
                        activities=[act.CPU, act.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                avg = prof.key_averages()
                print(avg.table(sort_by="self_cpu_time_total", row_limit=12),
                      flush=True)
                print(avg.table(sort_by="self_cuda_time_total", row_limit=6),
                      flush=True)
        del base, tabs
    torch.cuda.empty_cache()


def _glove_config4(dev, dt):
    """Config #4's staged head (bf16 grid) and tail (counts at ``dt``)."""
    import torch
    from rsparse_tpu_torch.models import glove
    cs = sys.modules["chip_smoke"]
    x4 = cs.synth_glove(**cs.CONFIG4)
    hot, X, rem = glove._split_head(x4, cs.GLOVE_AUTO_HOT, np.float32)
    head = glove._stage_head(X, hot, torch.bfloat16,
                             cs.GLOVE_KW["batch_size"], dev)
    tail = glove._stage_tail(rem, cs.GLOVE_KW["batch_size"], dt, dev)
    return x4, head, tail


def k10_bf16_times(dev, reps):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.models import glove
    cs = sys.modules["chip_smoke"]
    hp = (cs.GLOVE_KW["x_max"], 0.75, cs.GLOVE_KW["learning_rate"])
    for dt in (torch.float32, torch.bfloat16):
        x4, _, tail = _glove_config4(dev, dt)
        prec = "bfloat16" if dt == torch.bfloat16 else "float32"
        for r in (128, 300):
            st0 = rt.GloVe(**dict(cs.GLOVE_KW, rank=r, precision=prec),
                           device=dev)._init_state(x4.shape[0])
            for label, sh in (("shard 0", tail.shard(0)),
                              ("swapped shard 0", tail.swapped().shard(0))):
                bnd = cs.k10_bound(sh, r, tb=2 if prec == "bfloat16" else 4)
                for ordered in ((False, True) if prec == "bfloat16"
                                else (False,)):
                    st = glove.GloveState(*(t.clone() for t in st0))
                    fn = lambda: glove._glove_shard(  # noqa: E731
                        st, sh, *hp, ordered=ordered)
                    ms, dms = cs.time_ms(fn, reps), cs.graph_ms([fn], reps)
                    print(f"  K10 config #4 {label} r={r} {prec} state"
                          + (" ordered" if ordered else "")
                          + f" (N={sh.rows.shape[0]}): {ms:.4f} ms (device "
                          f"{dms:.4f}); bound {bnd[0]:.4f} ms ({bnd[1]}); "
                          f"by launch: {launch_split(fn, reps)}", flush=True)
                    del st
            del st0
        del tail
        torch.cuda.empty_cache()


def k11_bf16_times(dev, reps):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.models import glove
    cs = sys.modules["chip_smoke"]
    x4, head, _ = _glove_config4(dev, torch.float32)
    hp = (cs.GLOVE_KW["x_max"], 0.75, cs.GLOVE_KW["learning_rate"])
    for r in (128, 300):
        for (ti, tj), trans, xv, rows, cols in cs.k11_tiles(head):
            present = int((xv > 0).sum())
            name = (f"tile ({ti}, {tj})" + (" transposed" if trans else "")
                    + f" {rows.numel()} x {cols.numel()} (present "
                    f"{present})")
            bnd = cs.k11_bound(rows.numel(), cols.numel(), r, 2, True,
                               present, tb=2)
            for prec in ("float32", "bfloat16"):
                st0 = rt.GloVe(**dict(cs.GLOVE_KW, rank=r, precision=prec),
                               device=dev)._init_state(x4.shape[0])
                st = glove.GloveState(*(t.clone() for t in st0))
                fn = lambda: glove._glove_tile_cuda(  # noqa: E731
                    st, rows, cols, xv, *hp, torch.bfloat16)
                ms, dms = cs.time_ms(fn, reps), cs.graph_ms([fn], reps)
                print(f"  K11 config #4 {name} r={r} {prec} state: "
                      f"{ms:.4f} ms (device {dms:.4f}); bound {bnd[0]:.4f} "
                      f"ms ({bnd[1]}); by launch: {launch_split(fn, reps)}",
                      flush=True)
                lib = (cs._tile_cublas_bf16 if prec == "bfloat16"
                       else cs._tile_cublas)
                lms = cs.time_ms(lambda: lib(st, rows, cols, xv, *hp), reps)
                print(f"  K11 config #4 {name} r={r} {prec} state: cuBLAS "
                      f"chain {lms:.3f} ms", flush=True)
                del st, st0
                torch.cuda.empty_cache()


def k11_f32_times(dev, reps):
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.models import glove
    cs = sys.modules["chip_smoke"]
    x4, head, _ = _glove_config4(dev, torch.float32)
    hp = (cs.GLOVE_KW["x_max"], 0.75, cs.GLOVE_KW["learning_rate"])
    H, side, last = head.ids.shape[0], head.side, head.nt - 1
    span = lambda t: slice(t * side, min(H, (t + 1) * side))  # noqa: E731
    x32 = head.x.float()
    for r in (128, 300):
        st0 = rt.GloVe(**dict(cs.GLOVE_F32_KW, rank=r),
                       device=dev)._init_state(x4.shape[0])
        for (ti, tj), trans in (((0, 0), False), ((last, last), False),
                                ((1, 0), True)):
            rows, cols = head.ids[span(ti)], head.ids[span(tj)]
            xv = (x32.T if trans else x32)[span(ti), span(tj)]
            # agreement: each table's distance from the plain version's
            # by its change, and the loss's
            sk = glove.GloveState(*(t.clone() for t in st0))
            sp = glove.GloveState(*(t.clone() for t in st0))
            lk = glove._glove_tile_cuda(sk, rows, cols, xv, *hp,
                                        torch.float32)
            lp = glove._glove_tile_plain(sp, rows, cols, xv, *hp,
                                         torch.float32)
            rel = max(float((a - b).abs().max())
                      / max(float((b - t).abs().max()), 1e-30)
                      for a, b, t in zip(sk, sp, st0))
            rel = max(rel, abs(float(lk) / float(lp) - 1))
            del sk, sp
            st = glove.GloveState(*(t.clone() for t in st0))
            fn = lambda: glove._glove_tile_cuda(  # noqa: E731
                st, rows, cols, xv, *hp, torch.float32)
            ms = cs.time_ms(fn, reps)
            try:
                dms = f"{cs.graph_ms([fn], reps):.4f}"
            except Exception as e:  # noqa: BLE001 - a capture refused
                dms = f"not measured ({type(e).__name__})"
            pms = cs.time_ms(lambda: glove._glove_tile_plain(
                st, rows, cols, xv, *hp, torch.float32), 3)
            present = int((xv > 0).sum())
            bms, bby = cs.k11_bound(rows.numel(), cols.numel(), r, 4, False,
                                    present)
            lib = ""
            if (ti, tj) == (0, 0):
                lms = cs.time_ms(lambda: cs._tile_cublas_f32(
                    st, rows, cols, xv, *hp), reps)
                lib = f", f32 cuBLAS chain {lms:.4f} ms"
            print(f"  K11 f32 head config #4 tile ({ti}, {tj})"
                  + (" transposed" if trans else "")
                  + f" {rows.numel()} x {cols.numel()} r={r}: {ms:.4f} ms "
                  f"(device {dms}); present {present}; bound {bms:.4f} ms "
                  f"({bby}); plain {pms:.3f} ms{lib}; largest distance from "
                  f"the plain version {rel:.2e} of the change", flush=True)
            del st
        del st0
        torch.cuda.empty_cache()


TIMERS = {"k1": k1_times, "k8": k8_times, "k3": k3_times,
          "fm-staging": fm_staging_times, "k8-tiles": k8_tile_times,
          "k7": k7_times, "ftrl-pass": ftrl_pass_times, "k10": k10_times,
          "k2-wide": k2_wide_times,
          "k2-wide-buckets": lambda dev, reps: k2_wide_times(dev, reps, False),
          "k4-wide": k4_wide_times,
          "k11-wide": k11_wide_times, "k9-bf16": k9_bf16_times,
          "k10-bf16": k10_bf16_times, "k11-bf16": k11_bf16_times,
          "k11-f32": k11_f32_times, "k11-walk": k11_walk_times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="+", choices=sorted(TIMERS))
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=None,
                    help="calls a time (default: 3 for k1 and fm-staging, "
                    "20 otherwise)")
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.modules["chip_smoke"] = _chip_smoke()
    sys.path.insert(0, os.path.abspath(opt.root))
    import rsparse_tpu_torch
    from rsparse_tpu_torch import _kernels
    _kernels.lib()
    print(f"package {os.path.dirname(rsparse_tpu_torch.__file__)} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda", 0)
    for what in opt.what:
        reps = opt.reps or (3 if what in ("k1", "fm-staging") else 20)
        print(f"{what}:", flush=True)
        TIMERS[what](dev, reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
