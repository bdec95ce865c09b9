#!/usr/bin/env python3
"""Kernel and staging times of the ``rsparse_tpu_torch`` found under ROOT,
so that two checkouts can be compared within one run on the same card.

    python3 kernel_times.py [--root ROOT] [--reps N] WHAT [WHAT ...]

WHAT is one or more of:

  k1          K1 (the bucketed CG solve) bucket by bucket over both
              half-sweeps of the ML-20M-shaped full-width fits, as
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
              distance of a table's change.

Needs one CUDA card.  The data and the timers are this checkout's
``chip_smoke.py`` (``time_ms``: CUDA events over wrapper calls after a
warm-up; ``graph_ms``: device time by CUDA graphs); its helpers import the
package only inside functions, so they run against the package under ROOT.
k1, k8, k3 and fm-staging use only entry points that every version of the
port has had since PR 10; k8-tiles needs ``RSP_FM_TILE`` (PR 11 on).
``chip_smoke.py`` holds each kernel to its plain version.
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
        total = 0.0
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
            H = 0 if W is None else W.shape[1]
            print(f"  {tag} {sweep} {b.batch} x {b.pad_len} H={H} "
                  f"K1 {ms:.3f} ms", flush=True)
        print(f"  {tag} {sweep} half-sweep, {len(br.buckets)} buckets: "
              f"K1 {total:.3f} ms", flush=True)
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


def _fm_variant(tile):
    """csrc/fm.cu alone built with RSP_FM_TILE = ``tile``, its entry point
    typed as the package's."""
    from rsparse_tpu_torch import _kernels
    out = os.path.join(_kernels.BUILD_DIR, f"fm_tile{tile}.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS[:-2], "-shared",
                    f"-DRSP_FM_TILE={tile}", "-o", out,
                    os.path.join(_kernels.CSRC, "fm.cu")],
                   check=True, capture_output=True, text=True, timeout=600)
    so = ctypes.CDLL(out)
    so.rsp_fm_block.argtypes = _kernels.lib().rsp_fm_block.argtypes
    so.rsp_fm_block.restype = ctypes.c_int
    return so


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


TIMERS = {"k1": k1_times, "k8": k8_times, "k3": k3_times,
          "fm-staging": fm_staging_times, "k8-tiles": k8_tile_times}


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
