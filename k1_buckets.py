#!/usr/bin/env python3
"""K1 (the bucketed CG solve) timed bucket by bucket over both half-sweeps
of the ML-20M-shaped full-width fits, for the ``rsparse_tpu_torch`` found
under ROOT, so that two checkouts can be compared within one run on the
same card.

    python3 k1_buckets.py [--root ROOT] [--reps 3]

Needs one CUDA card.  Fits WRMF at rank 128 (implicit CG, 2 iterations)
twice, as ``chip_smoke.py`` phase 4 does: at float32 with ``n_hot="auto"``
and the headline fit (``compute_dtype="bfloat16"``, ``n_hot=4096``).  On
each fit's staged buckets of both half-sweeps (the fitted factors as
sources and warm starts) it prints rows x length, the head's columns and
K1's ms (CUDA events, mean of ``--reps`` after a warm-up), and each
half-sweep's sum; then K1 at the kernel table's shape (implicit B=2048
L=128 d=128 H=1024, 5% present, f32 and bf16).  It uses only entry points
that every version of the port has (``solve_bucket_cg`` and the model's
staging); ``chip_smoke.py`` holds each bucket to its plain version.
"""

import argparse
import importlib.util
import os
import sys


def _chip_smoke():
    """This checkout's chip_smoke.py (its helpers import the package only
    inside functions, so they run against the package under ROOT)."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=3)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    sys.modules["chip_smoke"] = cs
    sys.path.insert(0, os.path.abspath(opt.root))
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.ops import als
    print(f"package {os.path.dirname(rt.__file__)}", flush=True)
    _kernels.lib()
    dev = torch.device("cuda", 0)
    x = cs.synth_ml20m_like()
    for tag, kw in (("f32", dict(n_hot="auto")),
                    ("bf16", dict(compute_dtype="bfloat16", n_hot=4096))):
        m = rt.WRMF(rank=128, seed=0, device=dev, lambda_=0.1,
                    feedback="implicit", solver="conjugate_gradient", **kw)
        m.fit_transform(x, n_iter=2, convergence_tol=-1)
        torch.cuda.synchronize()
        bucket_times(m, x, tag, opt.reps)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
