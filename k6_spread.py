#!/usr/bin/env python3
"""How far K6 (the fused soft-impute residual) and its plain version each
lie from the float64 plain version on fitted factors, over many fits.

    python3 k6_spread.py [n_fits]

Needs one CUDA card.  Fits soft_impute (rank 256, 6 iterations, seeds 0-2
in turn) on the first 16,384 users of the ML-20M-shaped synthetic, as
``chip_smoke.py`` phase 6 does; K6's sums combine with atomics, so every
fit ends on slightly different factors.  On each fit's heaviest buckets of
both orientations it prints, at f32: the kernel's distance from the plain
version (max norm), and each version's distance from float64 in the max
norm and the Frobenius norm.  Last it prints, over all buckets, how often
the kernel was further from the plain version than twice the plain
version's max-norm error (a limit that two equally accurate f32 results
can reach by themselves), and the largest ratio of the kernel's error to
the plain version's in each norm (``chip_smoke.py`` holds the Frobenius
one to 2).
"""

import os
import sys

import numpy as np
import scipy.sparse as sp


def main(n_fits: int) -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.models.soft_als import staged_buckets
    from rsparse_tpu_torch.ops import spmm
    dev = torch.device("cuda", 0)
    sub = sp.csr_matrix(cs.synth_ml20m_like()[:16384])
    csr = sub.astype(np.float64)
    x_b = staged_buckets(csr, torch.float32, dev)
    tx_b = staged_buckets(csr, torch.float32, dev, transpose=True)
    rows = []
    for fit_i in range(n_fits):
        fit = rt.soft_impute(sub, rank=256, lambda_=1.0, n_iter=6,
                             convergence_tol=-1, seed=fit_i % 3, device=dev)
        u, d, v = fit.u, fit.d, fit.v
        for orient, br, n_rows, table, rowfac in (
                ("users", x_b, sub.shape[0], v, u),
                ("items", tx_b, sub.shape[1], u, v)):
            for bi in cs._heaviest(br.buckets):
                b = br.buckets[bi]
                pk, _ = spmm.spmm_residual_buckets([b], n_rows, rowfac, table,
                                                   d)
                pp, _, _ = spmm._residual_plain([b], n_rows, rowfac, table, d)
                p64, _, _ = spmm._residual_plain(
                    [b._replace(values=b.values.double())], n_rows,
                    rowfac.double(), table.double(), d.double())
                r = dict(kp=cs.rel_err(pk, pp), k64=cs.rel_err(pk, p64),
                         p64=cs.rel_err(pp, p64), fk64=cs.fro_err(pk, p64),
                         fp64=cs.fro_err(pp, p64))
                rows.append(r)
                print(f"fit {fit_i} seed {fit_i % 3} {orient} B={b.batch} "
                      f"L={b.pad_len}: kernel vs plain {r['kp']:.2e}; vs f64 "
                      f"max norm kernel {r['k64']:.2e} plain {r['p64']:.2e}, "
                      f"Frobenius kernel {r['fk64']:.2e} plain "
                      f"{r['fp64']:.2e}", flush=True)
    old = sum(r["kp"] > max(1e-5, 2 * r["p64"]) for r in rows)
    print(f"{len(rows)} buckets; kernel vs plain above max(1e-5, twice the "
          f"plain version's max-norm f64 error): {old}")
    print(f"kernel / plain error vs f64: max norm up to "
          f"{max(r['k64'] / r['p64'] for r in rows):.3f}, Frobenius up to "
          f"{max(r['fk64'] / r['fp64'] for r in rows):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 16))
