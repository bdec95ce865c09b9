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
   dense heads and presence bits, up to d = 129 (K1 with its launch
   plan, and on a 60%-present head with its panels as tile products and
   walked); K3 (top-k), both routes (one pass for k <= 32, the k rounds
   past it) bit for bit at C = 1 and 256 over 1,682, 1,792 and 32,768
   columns, timed with the L2 cold (rotating copies of the scores) by
   CUDA events and by CUDA graphs beside the round-based kernel and
   torch.topk; K4 (NNLS)
   with the distribution of its coordinate-descent sweeps, the systems it
   sweeps at once per SM, and bit for bit with its scratch in slices; K5
   (bucketed
   SpMM) and K6 (fused soft-impute residual) at k = 10, 128 and 256 with
   f32 and bf16 tables, a values override, the approx-only mode and an
   8 x 41,280 bucket, beside one PyTorch library call for the same
   function (torch.sparse.mm; sampled_addmm + sparse.mm);
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
   fitted factors; K1 bucket by bucket over both half-sweeps of this fit
   and of the headline fit (compute_dtype="bfloat16", n_hot=4096): rows x
   length, head, the launch K1 takes, K1 and plain ms, each bucket held to
   its plain version; WRMF predict by part (transform, the host bit
   packing, the mask's copy, the scoring matmul, K3, the copy back); last,
   a warm full-width fit_transform + predict under torch.profiler: the
   device time of each kernel and copy, and the device's busy share of the
   wall time;
5. the reference benchmark's config #2 at full width on the same matrix
   (its values as ratings), rank 128: (a) explicit CG(3), dynamic lambda,
   n_hot=4096 with presence bits; (b) explicit Cholesky with user/item and
   global biases (d = 129); (c) implicit NNLS on the first 8192 users;
   each re-checks its kernels on its heaviest buckets as phase 4 does;
6. the low-rank family: (a) PureSVD and LinearFlow (rank 10) on
   MovieLens-100k, held to the reference's NDCG@10 / MAP@10 within 0.01;
   (b) the reference benchmark's config #3 at full width: soft-impute
   iterations at rank 256 on the first 16,384 users, LinearFlow rank 256
   fit_transform on the whole matrix with its stage walls, and
   cross_validate_lambda on 16,384 users at 10 iterations and with V run
   to convergence; (c) K5 and K6 against their plain versions on the
   heaviest buckets of those fits, f32 and bf16, and each as a whole
   function at the fit's shape beside the library call (K5 at LinearFlow's
   rhs x'(xV) and at its xV), with K5's gathered GB/s, its wrapper's host
   time a call and its work list (blocks, chunked and packed rows, build
   time), and K6's launches a call, work list and host time a call beside
   K5 on the same buckets and table (the gather alone); K4 prints
   its sweep counts and the systems it sweeps at once per SM, and config
   #2 (c)'s item bucket of the most rows at the fit's budget with a bound
   that counts the sweeps each system ran;
7. the SGD family: (a) K7 (FTRL, on the model's (z, n) pair table and on
   two separate tables) and K8 (FM, r = 4 and 8) on a 32,768 x 32 block
   over 10,000 and 40M features, predict and update, dropout, a feature in
   every row, config #5's one-hot block (K8), each also by CUDA graphs, K7
   launched twice on the same inputs for bitwise-equal tables, and K9
   (RankMF) on S = 8192, K = 20 batches (BPR / WARP, AdaGrad / RMSprop,
   identity and side features, r = 8 and 16) with the same bits, against their plain versions (each table by its change,
   1e-5; K9's counters exactly), K9's launches' device times apart, its
   candidate window and mean candidates tried, and every K9 case again in
   K9's row-map mode (a mesh batch: compact tables of the rows the bits
   reach) against that mode's plain version, its time beside the
   one-process mode's on the same batch; (b) FTRL and FM on the
   reference benchmark's GLM synthetic within 0.01 of the reference's
   train accuracy, FM XOR, RankMF BPR on ML-100k through predict (K3);
   (c) FTRL and FM rank 8 at the hashed shape (100,000 x 40M features)
   and config #5 on one card (RankMF WARP on 10M users, FM rank 4 on 2M
   one-hot rows): stage walls, rows or updates per second, peak memory,
   each kernel re-checked on the fitted state.  At bf16 state
   (``precision="bfloat16"``): (a) K9's bf16 instance in every mode (BPR /
   WARP x identity / sigmoid x AdaGrad / RMSprop x identity / side
   features) at r = 8 and WARP AdaGrad at r = 64, on bf16 tables on the
   grid, against its plain version: counters equal, every cell within one
   bf16 spacing (the share one spacing apart printed), two launches
   bitwise, and its row-map mode the same way and bitwise the one-process
   batch's rows; (c) config #5's RankMF at bf16, one epoch, beside the
   float32 fit: updates/s, table bytes, AUC;
8. GloVe: (a) K10 (tail shard) on config #4's first tail shard, straight
   and swapped (also by CUDA graphs, and launched twice on the same inputs
   for bitwise-equal tables and loss), and K11 (head tile) on its first
   tile, its edge tile and a tile of the transposed pass, bf16 and f32 counts, against their plain
   versions (each table by its change, 1e-5, or twice the plain version's
   distance from float64), K11 beside the cuBLAS chain of the same step;
   (b) GloVe rank 128 with the bf16 head on ML-100k and on the reference
   benchmark's quick shape, each cost history held to the JAX package's
   (pinned, 1e-3 relative); (c) config #4 (vocabulary 50,000, 4.97M
   triplets, head H = 23,170) through GloVe.fit_transform, 3 epochs: stage
   walls, triplets/s, the head / tail split of an epoch, peak memory, both
   kernels re-checked on the fitted state.  At bf16 state: (b) GloVe and
   RankMF at precision="bfloat16" on ML-100k held to the JAX package's
   (``REF_BF16``: the cost history within 2e-3 per epoch, RankMF's AUC
   within 0.01 and the gate); (a) K10's bf16 instance on config #4's first
   shard, straight and swapped, on both tail paths (the scheduled sums;
   the ordered scatter of a shuffled tail), and K11's bf16-state instance
   on the first tile beside the bf16 cuBLAS chain, each against its plain
   version (every cell within one bf16 spacing of the larger of its value
   and its change; K11's cells beyond it held to a float64 twin: S and
   the products summed at float64, each rounded once) and bitwise over
   two launches; (c)
   config #4 at bf16
   state, 3 epochs, beside the float32-state fit: triplets/s, each
   epoch's cost, state bytes, peak memory;
9. reduced precision: (a) K1, K2 and K4 with a bf16 table and a bf16 head
   at compute_dtype="bfloat16", a bf16 table and a uint8 head, a float32
   table and a uint8 head, and a bf16 table at float32 compute, against
   their plain versions (bf16 cells that round apart held by their float64
   twin); K1's bf16 head term alone (rsp_hot_chain, the Pallas probe
   scripts/exp_bisect3.py) at (64, 512, 128) and (2048, 4096, 128), as K1
   takes the head and with every panel a tile product; K12 row
   gather (the probes scripts/exp_gather*.py) at 2,097,152 rows from an
   L2-resident and an HBM-resident table and as the transposed lane gather
   (with the case its plan took), bf16 and f32, bitwise, beside
   torch.index_select and the bound; (b) ML-100k at compute_dtype=
   "bfloat16", hot_dtype="uint8", both, and precision="bfloat16", each
   within 0.005 of the JAX package's NDCG@10 / MAP@10, and explicit CG at
   bf16 held to the RMSE gate; (c) the full-width implicit fit at the
   reference's headline setting (compute_dtype="bfloat16", n_hot=4096),
   with a uint8 head and at precision="bfloat16": user-updates/s, sweep
   ms, peak memory, loss per nnz within 1% of the float32 fit's, the
   kernels re-checked on each fit's heaviest buckets.

10. the command line, in process through ``rsparse_tpu_torch.cli.main``:
   (a) ``fit`` on ML-100k for WRMF, PureSVD and LinearFlow (rank 10,
   lambda 1, 10 iterations, 20% held out, seed 0) with ``--out`` and
   ``--profile-dir``, each ndcg@k / map@k within 0.005 (WRMF) or 0.01 of
   the JAX CLI's (``REF_CLI``), then ``recommend`` from each checkpoint
   against the loaded model's ``predict``, and the WRMF trace naming K1's
   kernel; (b) phase 4's synthetic written as a ``user,item,rating`` CSV
   (a temporary directory), read back by ``load_interactions`` with the
   native parser (host seconds, MB/s) and held equal to the synthetic,
   then ``fit`` at rank 128 (2 iterations, 20% held out) beside phase 4's
   in-process fit, the checkpoint's size and save / load seconds, and
   ``recommend --limit 10`` against the in-process ``predict``; (c) a fit
   of 1 iteration with ``checkpoint_path``, resumed to 2, bitwise equal to
   2 iterations in one go.
11. the wide widths (K1, K2 and K4 above d = 160, K10 and K11 above r =
   128, each on its wide route, with its own row of the kernels line): (a)
   K1 and K2 against their plain versions at d = 161, 192, 256, 258, 512
   and 514 (implicit; at 258 and 514 also a 1,024-column head, implicit
   and explicit with presence bits, explicit with biases, and phase 9's
   reduced-precision variants), on buckets of 256 x 128 and 16 x 8,192,
   with their launch plans and stage times; K4 the same on the
   256 x 128 buckets at a sweep budget of ``WIDE_NNLS_BUDGET`` (y 1e-3 or
   no further from the float64 twin than twice the plain version, the
   loss 1e-5 against the plain loss of its own y), in slices of systems
   and launched twice, bitwise; (b) K10 and K11 on config
   #4's first shard and tiles at r = 129, 256, 300 and 320 (at 300 as
   phase 8 (a): straight and swapped, twice for bitwise-equal tables, the
   edge and transposed tiles, bf16 and float32 counts, beside the cuBLAS
   chain); (c) ML-100k: WRMF rank 192 within 0.005 of the JAX package's
   NDCG@10 / MAP@10 (``REF_WIDE``), WRMF rank 192 with NNLS likewise
   (every factor >= 0), the explicit Cholesky model with
   biases at d = 194 held to the RMSE gate, GloVe rank 300 (bf16 head)
   within 1e-3 of the JAX package's cost history; (d) full width: rank
   512 (f32, n_hot="auto", 2 iterations, transform of 65,536 users,
   predict of 4,096), rank 256 at the headline setting and config #2 (b)
   at rank 256 (d = 258), config #2 (c) (implicit NNLS, 1 iteration) at
   rank 256 and at rank 512 with both biases (d = 514), on the first
   users of ``WIDE_NNLS_USERS``, each with stage walls, sweep ms,
   user-updates/s, peak memory, loss per nnz and its kernels re-checked
   on the heaviest buckets (NNLS: factors >= 0); config #4 GloVe at rank
   300 (3 epochs: walls, triplets/s, peak memory, both kernels re-checked
   on the fitted state), then phase
   8's bf16-state checks and fit at rank 300 (the wide bf16 instances).
12. WRMF on a mesh of processes (``rsparse_tpu_torch.parallel``) at phase
   4's settings (rank 128, 2 iterations of CG(3) on the ML-20M-shaped
   synthetic), after one-process reference fits of the same settings with
   and without the zipf head and of NNLS on 8,192 users: (a) one rank over
   NCCL in this process, the plain mesh path and ``routing="alx"``, NNLS
   routed; (b) two ranks sharing cuda:0 over gloo (spawned; the kernels
   were built here first), the plain path, ``"alx"`` and ``"alx_ragged"``,
   NNLS on ``"alx_ragged"``; (c) the same on two cards over NCCL where the
   machine has them, else one line saying why not.  Each rank prints its
   backend, each half-sweep's ms, each routed exchange's ms and the bytes
   it sent beside ``wire_cost_report*`` (the ranks' bytes must sum to the
   report's), and its launches of K1, K2, K3, K4 and K12 (each must be
   above 0: K12 is the owner's row gather of the routed exchange); U and V
   are held to the one-process fit within 1e-4 (relative Frobenius), the
   loss within 1e-5 (NNLS: the loss within 1e-5, its factors within 1e-2,
   ``MESH_TOL``), and ``predict`` (k = 10, training
   mask, through ``sharded_top_product``) to the one-process indices, rows
   that differ counted and each required to be a near tie.  Then, on the
   same ranks, the SGD family with its state tables row-sharded
   (``parallel/sgd_sharded.py``) at its widths: hashed FTRL and FM rank 8
   (100,000 x 40M features x 32 nnz), config #5 RankMF WARP rank 8 (10M
   users, batch 8,192, 20 negatives), config #4 GloVe rank 128 with the
   bf16 head, depth cut (one fit pass, 8 RankMF batches, one GloVe epoch;
   printed), each held to the one-process fit of the same settings:
   FTRL, FM and GloVe bitwise (every state table's digest summed over the
   ranks' own rows, the predictions, embeddings and costs), RankMF within
   ``MESH_RANKMF_TOL``; then a small RankMF and a small GloVe at
   precision="bfloat16" (``REF_BF16``'s settings on ML-100k, depth cut:
   20 RankMF iterations, 2 GloVe epochs), bitwise the one-process bf16
   fits (no atomics on either bf16 path); each rank prints its resident
   table bytes, the
   gather all-reduce's bytes and ms a step, the kernel's and the
   write-back's ms a step, the draws' check, and its launches of K7, K8,
   K9's row-map mode, K10 and K11 (each must be above 0).

The kernels' launch counters are reset right before each main-path run
and must show every kernel of that path launched in it; K1's head term
alone is the counterpart of a probe, which no model calls, so its count
comes from its probe runs (the timed launches); K12's comes from phase
9's probe runs and from phase 12's routed exchanges.  The
second-to-last line is a JSON object describing the kernels (times, the
bound from the card's peak rates, launches on the main paths); the last
line is {"ok": true, "device": {...}}.  Without a CUDA device it exits
non-zero.
``--phases`` runs a subset (phase 1 always runs) and then prints no result
line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

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


def fro_err(a, b) -> float:
    """||a - b||_F / ||b||_F"""
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def hold_bf16(what, k, p, p64, lim) -> int:
    """Hold a kernel's output ``k`` with bf16 rounding points to its plain
    version ``p``: within ``lim`` (max norm, relative), or, where bf16
    roundings went the other way under the other float32 summation order,
    no further from the float64 twin ``p64`` (the same roundings) than
    twice the plain version, in the Frobenius norm.  Returns the number of
    cells off by more than ``lim``, which it prints."""
    e = rel_err(k, p)
    apart = int(((k.double() - p.double()).abs()
                 > lim * p.double().abs().max()).sum())
    if e <= lim:
        return apart
    fk, fp = fro_err(k, p64), fro_err(p, p64)
    log(f"    {what}: {apart} of {k.numel()} cells round apart "
        f"(max {e:.2e}); vs the float64 twin: kernel {fk:.2e}, plain "
        f"{fp:.2e} (Frobenius)")
    require(fk <= max(2 * fp, 1e-7), f"{what}: off its plain version by "
            f"{e:.2e} and further from the float64 twin ({fk:.2e}) than "
            f"twice the plain version ({fp:.2e})")
    return apart


def hold_loss_at_own_y(what, args, y, loss, hot_scale, lim=1e-5) -> None:
    """Hold a kernel's per-row loss to the plain version's loss of the
    kernel's own solution ``y`` (a CG solve of 0 steps from ``y``: the loss
    code after the solve is the same for every solver).  With bf16
    rounding the loss reads bf16(y), so two solutions a float32 ulp apart
    can give losses 1e-4 apart; at the same y only the summation order
    differs."""
    from rsparse_tpu_torch.ops import als
    a = list(args)
    a[5] = y
    a[8] = dataclasses.replace(args[8], solver=als.CONJUGATE_GRADIENT,
                               cg_steps=0)
    ref = als._solve_bucket_plain(*a, hot_scale=hot_scale)[1]
    e = rel_err(loss, ref)
    require(e <= lim, f"{what}: loss off the plain version's loss of the "
            f"kernel's own solution by {e:.2e} (> {lim:.0e})")


def k2_detail(args, hot_scale=None):
    """K2's plan for a bucket (CTAs an SM, the padded width D, the Gram
    route of the cold and the head entries) and its stages timed apart: the
    Gram (stages=1), the factorisation and the substitutions (stages=2 less
    1), the loss (the whole less stages=2).  Returns (plan, text)."""
    from rsparse_tpu_torch.ops import als
    plan = als.cholesky_plan(*args, hot_scale=hot_scale)
    t = [time_ms(lambda: als.solve_bucket_cholesky(*args, hot_scale=hot_scale,
                                                   stages=st), reps=3)
         for st in (1, 2, 3)]
    return plan, (f"K2 {plan['ctas_per_sm']} CTAs an SM, D={plan['D']}, "
                  f"Gram {plan['cold_route']} / head {plan['head_route']}; "
                  f"Gram {t[0]:.3f} + factor and solve {t[1] - t[0]:.3f} + "
                  f"loss {t[2] - t[1]:.3f} ms")


def k1_detail(args, hot_scale=None):
    """K1's plan for a bucket (ops/als.py cg_plan: rows a CTA, CTAs a
    cluster, the head's panels by kind, the tile products' route).
    Returns (plan, text)."""
    from rsparse_tpu_torch.ops import als
    pl = als.cg_plan(*args, hot_scale=hot_scale)
    return pl, (f"K1 {pl['rows']} rows x {pl['cluster']} CTAs, "
                f"{pl['smem_bytes']} B shared, {pl['ctas_per_sm']} CTA(s) an"
                f" SM, {pl['cache']} cells a warp's cache; head panels: "
                f"{pl['dense_panels']} tile products "
                f"({pl['route']}), {pl['sparse_panels']} walked "
                f"({pl['sparse_cells']} cells), of {pl['panels']}")


#: NVIDIA's data-sheet peaks of one H100 SXM: HBM bytes/s, f32 flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: dense bf16 tensor-core peak
BF16_FLOPS = 989e12
#: dense TF32 tensor-core peak
TF32_FLOPS = 495e12
#: the rate of each of K2's Gram routes (ops/als.py CHOL_ROUTES): bf16
#: products at the bf16 peak; 2xTF32 and 3xTF32 issue two and three TF32
#: products for each one the function needs
K2_ROUTE_FLOPS = {"bf16 mma": BF16_FLOPS, "bf16 mma, both ways": BF16_FLOPS,
                  "2xTF32": TF32_FLOPS / 2, "3xTF32": TF32_FLOPS / 3}


def bound(nbytes: float, flops: float):
    """(least time in ms the card could take, what bounds it): the larger
    of the bytes over the memory rate and the f32 operations over the f32
    rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _touched(col, nnz) -> int:
    """Distinct columns the valid entries of a bucket read."""
    import torch
    live = torch.arange(col.shape[1], device=col.device)[None, :] < \
        nnz[:, None]
    return int(torch.unique(col[live]).numel())


def als_bound(args, sweeps=None, hot_scale=None, plan=None):
    """(least time in ms, what bounds it) of :func:`als_bound_parts`."""
    tb, to = als_bound_parts(args, sweeps, hot_scale, plan)
    return (tb, "bytes") if tb >= to else (to, "operations")


def als_bound_parts(args, sweeps=None, hot_scale=None, plan=None):
    """Bound of one ALS bucket solve (K1, K2, K4) from its inputs: bytes of
    the source rows it touches (at the table's width, 4 or 2 bytes), the
    entries, the Gram, the dense head (at its storage width, with a uint8
    head's scales), the warm start and the outputs, each once; operations
    the function needs
    per row (n entries, d columns, a head of H columns, Hp of them present,
    s CG steps or sweeps), a symmetric d x d result counted at its
    d(d + 1)/2 distinct entries: CG (s + 1)(2d^2 + 4nd + 4Hd) + 4nd + 4Hd;
    Cholesky (n + Hp)d(d + 1) for the Gram, d^3/3 for the factorisation,
    2d^2 for the two triangular solves, 4nd; NNLS the same Gram, d^2(d + 1)
    for G = lhs'lhs, 2 s d^2 for the sweeps, 4nd.  Operations run at the
    float32 rate, except K2's Gram given its ``plan``
    (ops/als.py cholesky_plan): at the rate of the units its route runs on
    (K2_ROUTE_FLOPS), and when the route sums both ways (the symmetric part
    of a Gram of bf16-rounded weighted rows) at 2 n d^2.  Returns (ms for
    the bytes, ms for the operations).

    K1 given its ``plan`` (ops/als.py cg_plan) counts what it runs: per
    pass (the rhs, s + 1 products, the loss) 2d (rhs, loss) or 4d (a
    product) operations a cold entry and a cell of a sparse head panel, at
    the f32 rate; 2d^2 a row a product for XtX p (implicit), at the 3xTF32
    rate it runs at; and the head's tile products, 2 x 16 x 64 x d
    operations each (one a panel for the rhs and the loss, two for a
    product), on the present panels the plan takes as tiles, at the rate
    of their route (K2_ROUTE_FLOPS)."""
    from rsparse_tpu_torch.ops import als
    src, _, _, _, b, _, _, _, cfg, W, Vh, hb, _ = args
    B, d = b.batch, src.shape[1]
    n = b.nnz.double()
    H = 0 if W is None else W.shape[1]
    hp = (W != 0).sum(1).double() if W is not None else n * 0
    nbytes = (_touched(b.col_idx, b.nnz) * d * src.element_size()
              + float(n.sum()) * 8 + B * 8 + d * d * 4 + B * d * 8 + B * 4)
    if W is not None:
        nbytes += B * H * W.element_size() + H * d * Vh.element_size()
    if hot_scale is not None:
        nbytes += B * 4
    if hb is not None:
        nbytes += hb.numel()
    if cfg.solver == als.CONJUGATE_GRADIENT and plan is not None:
        s = cfg.cg_steps
        per = 4 * d * (s + 2)                # per entry: rhs, products, loss
        f32_ops = (float(n.sum()) + plan["sparse_cells"]) * per
        tile_ops = plan["dense_panels"] * 2 * 16 * 64 * d * (2 * s + 4)
        # P XtX: 2 d^2 a row a product, on the tensor cores at 3xTF32
        xtx = B * 2 * d * d * (s + 1) if cfg.feedback == "implicit" else 0
        t_ops = (f32_ops / F32_FLOPS
                 + tile_ops / K2_ROUTE_FLOPS[plan["route"]]
                 + xtx / K2_ROUTE_FLOPS["3xTF32"]) * 1e3
        return nbytes / HBM_BYTES_PER_S * 1e3, t_ops
    if cfg.solver == als.CONJUGATE_GRADIENT:
        s = cfg.cg_steps
        fl = ((s + 1) * (2 * d * d + 4 * n * d + 4 * H * d)
              + 4 * n * d + 4 * H * d)
    elif cfg.solver == als.CHOLESKY and plan is not None:
        cold = n * d * (2 * d if "both" in plan["cold_route"] else d + 1)
        t_ops = float(
            (cold / K2_ROUTE_FLOPS[plan["cold_route"]]
             + hp * d * (d + 1) / K2_ROUTE_FLOPS[plan["head_route"]]
             + (d ** 3 / 3 + 2 * d * d + 4 * n * d) / F32_FLOPS).sum()) * 1e3
        return nbytes / HBM_BYTES_PER_S * 1e3, t_ops
    elif cfg.solver == als.CHOLESKY:
        fl = (n + hp) * d * (d + 1) + d ** 3 / 3 + 2 * d * d + 4 * n * d
    else:
        sw = sweeps.double() if sweeps is not None else n * 0
        fl = ((n + hp) * d * (d + 1) + d * d * (d + 1) + 2 * sw * d * d
              + 4 * n * d)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            float(fl.sum()) / F32_FLOPS * 1e3)


def spmm_bound(buckets, k, tbytes, residual: bool):
    """Bound of K5 (residual=False) or K6 over a list of buckets: bytes of
    the entries (8 each), the table rows they touch, the rows' factors (K6)
    and the output rows, each once; operations 2 nnz k (K5), 4 nnz k + 3
    nnz (K6: the dot product, the SpMM, the squared norm)."""
    import torch
    nnz = sum(float(b.nnz.double().sum()) for b in buckets)
    rows = sum(int((b.nnz > 0).sum()) for b in buckets)
    live = [b.col_idx[torch.arange(b.pad_len, device=b.nnz.device)[None, :]
                      < b.nnz[:, None]] for b in buckets]
    touched = int(torch.unique(torch.cat(live)).numel())
    nbytes = nnz * 8 + touched * k * tbytes + rows * k * 4
    if residual:
        nbytes += rows * k * 4 + k * 4
    fl = (4 * nnz * k + 3 * nnz) if residual else 2 * nnz * k
    return bound(nbytes, fl)


def sweep_summary(sweeps) -> str:
    """The distribution of K4's per-system sweep counts."""
    import torch
    sw = sweeps.float()
    q = torch.quantile(sw, torch.tensor([0.5, 0.9, 0.99], device=sw.device))
    return (f"sweeps p50/p90/p99/max={q[0]:.0f}/{q[1]:.0f}/{q[2]:.0f}/"
            f"{int(sw.max())}")


def nnls_summary(sweeps, src) -> str:
    """K4's sweep counts and the systems its sweep stage holds at once on
    one SM at the width of ``src`` (the active source table)."""
    from rsparse_tpu_torch.ops import als
    return (f"{sweep_summary(sweeps)}, {als.nnls_inflight(src.shape[1])} "
            "systems sweeping an SM")


# -- phase 2: kernels against their plain versions ----------------------------

def _bucket_case(gen, device, B, L, d, H, *, explicit=False, biases=False,
                 bits=False, ugb=False, solver=None, n_src=32768,
                 density=0.05, nnls_max_iter=None):
    """One bucket with its sweep terms, made on the card: source rows
    (n_src, d), cold entries (implicit confidences 1 + e^u; explicit
    integer ratings -2..2, many stored zeros), source biases, and a dense
    head of H columns, ``density`` of its cells present (explicit: with
    stored zeros, and presence bits when ``bits``; else no zero is stored
    in the head); ``nnls_max_iter`` sets the NNLS sweep budget."""
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
                        with_biases=biases, dynamic_lambda=explicit,
                        **({} if nnls_max_iter is None else
                           dict(nnls_max_iter=nnls_max_iter)))
    g = 0.05 if (ugb or (biases and not explicit)) else 0.0
    lam = 1.0
    src_act, x_biases, XtX, rhs_init = als._sweep_prepare(src, lam, g, cfg,
                                                          f32)
    W = Vh = hb = nnz_tot = None
    if H:
        present = torch.rand((B, H), generator=gen, device=device) < density
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
    extra = "" if sweeps is None else " " + nnls_summary(sweeps, args[0])
    plan = None
    if name.startswith("K2"):
        plan, detail = k2_detail(args)
        extra += "\n    " + detail
    elif name.startswith("K1"):
        plan, detail = k1_detail(args)
        extra += "\n    " + detail
    bms, bby = als_bound(args, sweeps, plan=plan)
    log(f"  {name:11s} {tag:44s} y_rel={ey:.2e} loss_rel={el:.2e} "
        f"kernel={ms:.3f} ms plain={pms:.3f} ms bound={bms:.4f} ms ({bby})"
        f"{extra}")
    require(bool(torch.isfinite(yk).all() and torch.isfinite(lk).all()),
            f"{name} {tag}: non-finite output")
    require(ey <= limit_y and el <= limit_loss, f"{name} {tag}: disagrees "
            f"with its plain version (y {ey:.2e}, loss {el:.2e})")
    r = results[name.split()[1]]
    r["max_abs_err"] = max(r["max_abs_err"], float((yk - yp).abs().max()))
    if rep:
        r.update(ms=ms, plain_ms=pms, shape=tag, bound_ms=bms, bound_by=bby,
                 library_ms=None)
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
    # K1 with heads of 30% and 90% present cells, on each side of the
    # threshold (als.CG_TAU) from which its panels are tile products on the
    # tensor cores (3xTF32), implicit and explicit with bits
    for dens in (0.3, 0.9):
        cases.append(("K1 als_cg", dict(B=2048, L=128, d=128, H=1024,
                                        density=dens), False))
        cases.append(("K1 als_cg", dict(B=2048, L=128, d=128, H=1024,
                                        density=dens, explicit=True,
                                        bits=True), False))
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
               + (f" {kw['density']:.0%} present" if "density" in kw
                  else "")
               + (" bias" if cfg.with_biases else "")
               + (" bits" if args[11] is not None else "")
               + (" gb" if cfg.use_global_bias else ""))
        if cfg.solver == als.NNLS:
            sweeps = torch.zeros((B,), dtype=torch.int32, device=device)
            kern = functools.partial(als.solve_bucket_nnls, sweeps=sweeps)
            yk = _record(results, name, kern, plain, args, tag, rep, 1e-3,
                         1e-3, plain_reps=0, sweeps=sweeps)
            if rep:
                check_nnls_slices(args, yk, sweeps, tag)
        else:
            kern = als._SOLVE[cfg.solver]
            _record(results, name, kern, plain, args, tag, rep, 1e-4, 1e-5)
            if "density" in kw:
                k1_tiles_or_walk(args, tag)


def k1_tiles_or_walk(args, tag, hot_scale=None, y64=None) -> None:
    """K1 on one bucket with its head's panels all taken as tile products
    and all walked cell by cell (its launch plan with tau 1, and tau past
    any panel's cells) beside the default (``als.CG_TAU`` of its route),
    each held to the plain version (y 1e-4; given the float64 twin
    ``y64``, bf16 cells that round apart by hold_bf16): what the threshold
    trades."""
    import torch
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.ops import als
    plain = als._solve_bucket_plain(*args, hot_scale=hot_scale)
    cargs, y, loss = als._bucket_args(*args, hot_scale)
    pl = als._cg_launch_plan(cargs, args[4].pad_len)
    out = []
    for tau in (1, 1 << 30):
        plan = _kernels.CgPlan(rows=pl.rows, cluster=pl.cluster, tau=tau)
        run = functools.partial(als._launch_cg, cargs, y, loss, plan,
                                args[8].cg_steps, y.device)
        yk = run()[0].clone()
        torch.cuda.synchronize()
        if y64 is not None:
            hold_bf16(f"K1 {tag} tau {tau}", yk, plain[0], y64, 1e-4)
        else:
            e = rel_err(yk, plain[0])
            require(e <= 1e-4, f"K1 {tag} tau {tau}: disagrees with its "
                    f"plain version ({e:.2e})")
        out.append((tau, time_ms(run)))
    dflt = time_ms(lambda: als.solve_bucket_cg(*args, hot_scale=hot_scale))
    log("    K1 head panels " + ", ".join(
        f"{'as tile products' if t == 1 else 'walked'} {ms:.3f} ms"
        for t, ms in out) + f"; default (tau {pl.tau}, "
        f"{als._cg_route(cargs)}) {dflt:.3f} ms")


def check_nnls_slices(args, y, sweeps, tag, hot_scale=None) -> None:
    """K4 with its scratch cut into slices of a third of the bucket's
    systems, as a bucket larger than ``als.NNLS_SCRATCH_BYTES`` runs: the
    same factors and sweeps, bit for bit (each system is built and swept
    alone)."""
    import torch
    from rsparse_tpu_torch.ops import als
    per = -(-args[4].batch // 3)
    stride, extra = als.nnls_scratch(args[0].shape[1], args[4].batch)
    sw = torch.zeros_like(sweeps)
    kept = als.NNLS_SCRATCH_BYTES
    try:
        als.NNLS_SCRATCH_BYTES = 4 * (stride * per + extra)
        ys, _ = als.solve_bucket_nnls(*args, sweeps=sw, hot_scale=hot_scale)
    finally:
        als.NNLS_SCRATCH_BYTES = kept
    torch.cuda.synchronize()
    same = bool(torch.equal(ys, y) and torch.equal(sw, sweeps))
    log(f"  K4 als_nnls{'_wide' if args[0].shape[1] > als.WIDE_D else ''} "
        f"{tag}: in slices of {per} systems, bitwise equal={same}")
    require(same, f"K4 {tag}: the sliced scratch changed the result")


#: K3's checked shapes: rows (get_similar_items' one, top_product's chunk
#: of 256), columns (ML-100k's items, unmasked and n % 4 == 2; a multiple
#: of 256; the ML-20M-shaped synthetic's items) and k (1, the callers' 10,
#: TOPK_KMAX and past it, the tests' 100)
TOPK_ROWS = (1, 256)
TOPK_COLS = (1682, 1792, 32768)
TOPK_KS = (1, 10, 32, 33, 100)


def _rotating(fns):
    """One call of the next of ``fns`` per call, in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def graph_ms(fns, reps=10) -> float:
    """Device time of one call, free of the host's: a CUDA graph of one
    call of each of ``fns`` in turn, replayed ``reps`` times (CUDA events),
    over the number of calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in fns:
            fn()
    ms = time_ms(g.replay, reps) / len(fns)
    del g
    return ms


def _topk_case(gen, device, C, n):
    """Quarter-step scores (many exact ties) and, where n % 8 == 0, a 30%
    mask with, where C > 2, row 0 all masked, row 1 none and row 2 all but
    5 columns."""
    import torch
    s = (torch.randn((C, n), generator=gen, device=device) * 4).round() / 4
    if n % 8:
        return s, None
    mask = torch.rand((C, n), generator=gen, device=device) < 0.3
    if C > 2:
        mask[0] = True
        mask[1] = False
        mask[2] = True
        mask[2, :5] = False
    return s, torch.from_numpy(np.packbits(mask.cpu().numpy(), axis=1,
                                           bitorder="little")).to(device)


def check_topk_kernel(device, results) -> None:
    """K3's two routes bitwise against the plain version at every TOPK_*
    shape; then timed with the L2 cold: each call reads other scores than
    the calls before it (rotating copies, together over 50 MB), against
    the round-based kernel (the first K3, the route past TOPK_KMAX), the
    plain version and torch.topk on pre-masked scores."""
    import torch
    from rsparse_tpu_torch.ops import topk
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for C in TOPK_ROWS:
        for n in TOPK_COLS:
            s, bits = _topk_case(gen, device, C, n)
            masks = (None,) if bits is None else (bits, None)
            for k, b in itertools.product(TOPK_KS, masks):
                sp_, ip = topk._masked_top_k_plain(s, b, k, 0.25)
                plan = topk.topk_plan(C, n, k, b is not None)
                same = []
                for rounds in ((False, True) if k <= topk.TOPK_KMAX
                               else (True,)):
                    sk, ik = topk._masked_top_k_cuda(s, b, k, 0.25,
                                                     rounds=rounds)
                    torch.cuda.synchronize()
                    same.append(bool(torch.equal(ik, ip)
                                     and torch.equal(sk, sp_)))
                    results["topk"]["max_abs_err"] = max(
                        results["topk"]["max_abs_err"],
                        float((sk - sp_).abs().max()))
                tag = (f"C={C} n={n} k={k} "
                       + ("masked" if b is not None else "no mask"))
                log(f"  K3 topk     {tag:30s} {plan['route']} "
                    f"(parts {plan['parts']}, words {plan['words']}) "
                    f"bitwise_equal={same[0]}"
                    + (f", rounds bitwise_equal={same[1]}"
                       if len(same) > 1 else ""))
                require(all(same), f"K3 {tag}: differs from its plain "
                        "version")
            del s, bits
    for C, n, masked in ((256, 32768, True), (1, 32768, True),
                         (256, 1682, False)):
        k = 10
        copies = max(4, -(-(64 << 20) // (C * n * 4)))
        big, bits = _topk_case(gen, device, copies * C, n)
        if not masked:
            bits = None
        rows = [(big[i * C:(i + 1) * C],
                 None if bits is None else bits[i * C:(i + 1) * C])
                for i in range(copies)]
        pre = [(a + 0.25).clamp_min(topk.NEG_INF).masked_fill(
            topk._expand_bits(b), topk.NEG_INF) if b is not None
            else (a + 0.25).clamp_min(topk.NEG_INF) for a, b in rows]
        t = {"lists": [functools.partial(topk._masked_top_k_cuda, a, b, k,
                                         0.25) for a, b in rows],
             "rounds": [functools.partial(topk._masked_top_k_cuda, a, b, k,
                                          0.25, rounds=True)
                        for a, b in rows],
             "plain": [functools.partial(topk._masked_top_k_plain, a, b, k,
                                         0.25) for a, b in rows],
             "torch.topk": [functools.partial(torch.topk, p, k, dim=1)
                            for p in pre]}
        ms = {name: time_ms(_rotating(fns), reps=4 * copies)
              for name, fns in t.items()}
        dev = {name: graph_ms(t[name]) for name in ("lists", "rounds",
                                                    "torch.topk")}
        warm = time_ms(lambda: topk._masked_top_k_cuda(*rows[0], k, 0.25),
                       reps=20)
        bms, bby = bound(C * n * 4 + (C * n // 8 if masked else 0)
                         + C * k * 8, 2 * C * n)
        tag = f"C={C} n={n} k={k} " + ("masked" if masked else "no mask")
        log(f"  K3 topk     {tag:30s} L2 cold ({copies} rotating copies): "
            f"kernel={ms['lists']:.4f} ms, the round-based kernel "
            f"{ms['rounds']:.4f} ms, plain={ms['plain']:.3f} ms, library "
            f"torch.topk={ms['torch.topk']:.4f} ms, bound={bms:.4f} ms "
            f"({bby}); device time by CUDA graphs: kernel "
            f"{dev['lists']:.4f}, round-based {dev['rounds']:.4f}, "
            f"torch.topk {dev['torch.topk']:.4f} ms; the kernel from L2 "
            f"{warm:.4f} ms")
        if C == 256 and masked:
            results["topk"].update(ms=ms["lists"], plain_ms=ms["plain"],
                                   shape=tag, library_ms=ms["torch.topk"],
                                   bound_ms=bms, bound_by=bby,
                                   device_ms=dev["lists"])
        del big, bits, rows, pre, t
        torch.cuda.empty_cache()


def _spmm_case(gen, device, B, L, n_cols, full=False, n_pad_rows=2):
    """One synthetic bucket of B rows (the last ``n_pad_rows`` padding rows:
    row_id == n_rows, nnz 0) over ``n_cols`` columns, entries N(0, 1); row
    lengths uniform in [L/2, L], or all L with ``full``.  Returns (bucket,
    n_rows)."""
    import torch
    from rsparse_tpu_torch.sparse.device import RowBucket
    n_rows = B - n_pad_rows
    nnz = (torch.full((B,), L, device=device, dtype=torch.int32) if full
           else torch.randint(L // 2, L + 1, (B,), generator=gen,
                              device=device, dtype=torch.int32))
    nnz[n_rows:] = 0
    live = torch.arange(L, device=device)[None, :] < nnz[:, None]
    col = torch.randint(0, n_cols, (B, L), generator=gen, device=device,
                        dtype=torch.int32) * live
    val = torch.randn((B, L), generator=gen, device=device) * live
    row_ids = torch.arange(B, device=device, dtype=torch.int32).clamp(
        max=n_rows)
    return RowBucket(row_ids, col.to(torch.int32).contiguous(),
                     val.contiguous(), nnz), n_rows


def _buckets_csr(buckets, n_cols):
    """The buckets' rows, in bucket order, as one torch CSR tensor (rows,
    n_cols): the library yardstick's input."""
    import torch
    nnz = torch.cat([b.nnz for b in buckets]).long()
    crow = torch.zeros(nnz.numel() + 1, dtype=torch.int64, device=nnz.device)
    crow[1:] = torch.cumsum(nnz, 0)
    live = [torch.arange(b.pad_len, device=nnz.device)[None, :]
            < b.nnz[:, None] for b in buckets]
    cols = torch.cat([b.col_idx[m] for b, m in zip(buckets, live)]).long()
    vals = torch.cat([b.values[m] for b, m in zip(buckets, live)])
    with warnings.catch_warnings():   # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols, vals,
                                       (nnz.numel(), n_cols))


def check_spmm_pair(buckets, n_rows, table, rowfac, scale, cdt, tag,
                    results, rep=False, csr=None, reps=5, which=("K5", "K6")):
    """K5 and K6 against their plain versions on the same buckets: K5
    ``spmm_buckets(buckets, n_rows, table)``, K6 ``spmm_residual_buckets(
    buckets, n_rows, rowfac, table, scale)``.  f32: y and the squared norm
    to 1e-5 relative; bf16 tables: K5 to the plain version in bf16, 1e-3,
    K6's squared norm (of the f32 residuals) 1e-5, and K6's y entry by entry
    (:func:`_k6_bf16_rounding`).  On fitted factors the residual is much
    smaller than the product it is taken from, and f32 cancellation costs
    digits in both versions, each in its own summation order: where K6's y
    at f32 is more than 1e-5 from the plain version's, it must be no
    further from the float64 plain version than twice the f32 plain
    version is, in the Frobenius norm (both printed beside).  Two f32
    results e from the truth may lie 2e apart, so the plain version's own
    error is no limit for the distance between them; and on a 32-row
    bucket the ratio of the two versions' largest entry errors varies from
    fit to fit up to 2.7x, that of their Frobenius errors up to 1.3x
    (``k6_spread.py``).
    With ``csr`` (the buckets' rows as a torch CSR tensor, rows in bucket
    order) the library call is timed too; ``rep`` records the numbers for
    the kernels line."""
    import torch
    from rsparse_tpu_torch.ops import spmm
    lim = 1e-5 if cdt is None else 1e-3
    k = table.shape[1]
    tb = 4 if cdt is None else 2
    if "K5" in which:
        _check_k5(buckets, n_rows, table, cdt, tag, results, rep, csr, reps,
                  lim, tb)
    if "K6" in which:
        _check_k6(buckets, n_rows, table, rowfac, scale, cdt, tag, results,
                  rep, csr, reps, tb)


def _work_list(buckets, table, cdt):
    """The work list K5 and K6 run for these buckets and this table:
    (RowShape, its stats: blocks, chunks, chunked / packed rows, build
    time)."""
    from rsparse_tpu_torch.ops import spmm
    k = table.shape[1]
    shapes = tuple((b.batch, b.pad_len) for b in buckets if b.batch)
    sh = spmm.row_shape(k, spmm._gather_table(table, cdt).data_ptr() % 16
                        == 0, sum(B * L for B, L in shapes))
    return sh, spmm.spmm_layout(shapes, sh, table.device).stats


def _host_ms(fn, reps) -> float:
    """The host time of a call of ``fn`` (checks, work-list lookup,
    launches), with the card busy behind it."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host_ms


def _check_k5(buckets, n_rows, table, cdt, tag, results, rep, csr, reps, lim,
              tb):
    import torch
    from rsparse_tpu_torch.ops import spmm
    k = table.shape[1]
    yk = spmm.spmm_buckets(buckets, n_rows, table, compute_dtype=cdt)
    yp = spmm._spmm_plain(buckets, n_rows, table, compute_dtype=cdt)
    torch.cuda.synchronize()
    e5 = rel_err(yk, yp)
    ms = time_ms(lambda: spmm.spmm_buckets(buckets, n_rows, table,
                                           compute_dtype=cdt), reps)
    pms = time_ms(lambda: spmm._spmm_plain(buckets, n_rows, table,
                                           compute_dtype=cdt), reps)
    lms = None
    if csr is not None and cdt is None:
        lms = time_ms(lambda: torch.sparse.mm(csr, table), reps)
    host_ms = _host_ms(lambda: spmm.spmm_buckets(buckets, n_rows, table,
                                                 compute_dtype=cdt), reps)
    bms, bby = spmm_bound(buckets, k, tb, residual=False)
    nnz = sum(float(b.nnz.double().sum()) for b in buckets)
    sh, st = _work_list(buckets, table, cdt)
    log(f"  K5 spmm     {tag:46s} y_rel={e5:.2e} kernel={ms:.3f} ms "
        f"plain={pms:.3f} ms library={'-' if lms is None else f'{lms:.3f}'}"
        f" ms bound={bms:.4f} ms ({bby}); host {host_ms:.3f} ms a call; "
        f"gathered {nnz * k * tb / ms / 1e6:.0f} GB/s (nnz x k x {tb} B); "
        f"work list {st['blocks']} blocks: {st['chunks']} chunks of "
        f"{sh.chunk} over {st['chunked_rows']} rows, {st['packed_rows']} "
        f"rows of buckets padded to at most {sh.short} packed; built in "
        f"{st['build_s'] * 1e3:.2f} ms")
    require(bool(torch.isfinite(yk).all()), f"K5 {tag}: non-finite output")
    require(e5 <= lim, f"K5 {tag}: disagrees with its plain version "
            f"({e5:.2e})")
    r = results["spmm"]
    r["max_abs_err"] = max(r["max_abs_err"], float((yk - yp).abs().max()))
    if rep:
        r.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                 bound_by=bby, shape=tag)


def _check_k6(buckets, n_rows, table, rowfac, scale, cdt, tag, results, rep,
              csr, reps, tb):
    import torch
    from rsparse_tpu_torch.ops import spmm
    k = table.shape[1]
    pk, sk = spmm.spmm_residual_buckets(buckets, n_rows, rowfac, table,
                                        scale, compute_dtype=cdt)
    pp, sp_, _ = spmm._residual_plain(buckets, n_rows, rowfac, table, scale,
                                      cdt)
    e6, es = rel_err(pk, pp), rel_err(sk[None], sp_[None])
    if cdt is None:
        b64 = [b._replace(values=b.values.double()) for b in buckets]
        p64, _, _ = spmm._residual_plain(b64, n_rows, rowfac.double(),
                                         table.double(), scale.double())
        fk, fp = fro_err(pk, p64), fro_err(pp, p64)
        ok_y = e6 <= 1e-5 or fk <= max(1e-5, 2 * fp)
        f64 = f" (vs f64, Frobenius: kernel {fk:.2e}, plain {fp:.2e})"
        del p64, b64
    else:
        ok_y, f64 = _k6_bf16_rounding(buckets, n_rows, table, rowfac, scale,
                                      pk)
    torch.cuda.synchronize()
    ms = time_ms(lambda: spmm.spmm_residual_buckets(
        buckets, n_rows, rowfac, table, scale, compute_dtype=cdt), reps)
    pms = time_ms(lambda: spmm._residual_plain(
        buckets, n_rows, rowfac, table, scale, cdt), reps)
    lms = None
    if csr is not None and cdt is None:
        rows = torch.cat([b.row_ids for b in buckets]).long().clamp(
            max=rowfac.shape[0] - 1)

        def library():
            lf = rowfac[rows] * scale[None, :]
            delta = torch.sparse.sampled_addmm(csr, lf, table.T, beta=1.0,
                                               alpha=-1.0)
            return (torch.sparse.mm(delta, table),
                    delta.values().square().sum())
        lms = time_ms(library, reps)
    bms, bby = spmm_bound(buckets, k, tb, residual=True)
    log(f"  K6 residual {tag:46s} y_rel={e6:.2e}{f64} sq_rel={es:.2e} "
        f"kernel={ms:.3f} ms plain={pms:.3f} ms library="
        f"{'-' if lms is None else f'{lms:.3f}'} ms bound={bms:.4f} ms "
        f"({bby})")
    if rep:
        _k6_launch_profile(buckets, n_rows, table, rowfac, scale, cdt, reps)
    require(bool(torch.isfinite(pk).all() and torch.isfinite(sk)),
            f"K6 {tag}: non-finite output")
    require(ok_y and es <= 1e-5,
            f"K6 {tag}: disagrees with its plain "
            f"version (y {e6:.2e}{f64}, sq {es:.2e})")
    r = results["spmm_residual"]
    r["max_abs_err"] = max(r["max_abs_err"], float((pk - pp).abs().max()))
    if rep:
        r.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                 bound_by=bby, shape=tag)


def _k6_launch_profile(buckets, n_rows, table, rowfac, scale, cdt, reps):
    """K6 as a whole function: its launches a call, its work list (blocks,
    chunks, packed rows, build time), the wrapper's host time a call and
    its gathered GB/s, beside K5 on the same buckets and table: the gather
    without the dot products."""
    import torch
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.ops import spmm

    def call():
        return spmm.spmm_residual_buckets(buckets, n_rows, rowfac, table,
                                          scale, compute_dtype=cdt)
    before = _kernels.launches["spmm_residual"]
    call()
    per_call = _kernels.launches["spmm_residual"] - before
    host_ms = _host_ms(call, reps)
    sh, st = _work_list(buckets, table, cdt)
    ms = time_ms(call, reps)
    k5_ms = time_ms(lambda: spmm.spmm_buckets(buckets, n_rows, table,
                                              compute_dtype=cdt), reps)
    nnz = sum(float(b.nnz.double().sum()) for b in buckets)
    mb = nnz * table.shape[1] * (4 if cdt is None else 2) / 1e6
    log(f"  K6 residual {len(buckets)} buckets: {per_call} launch(es) a "
        f"call; host {host_ms:.3f} ms a call; work list {st['blocks']} "
        f"blocks: {st['chunks']} chunks of {sh.chunk} over "
        f"{st['chunked_rows']} rows, {st['packed_rows']} rows of buckets "
        f"padded to at most {sh.short} packed; built in "
        f"{st['build_s'] * 1e3:.2f} ms; {ms:.3f} ms ({mb / ms:.0f} GB/s "
        f"gathered); K5 on the same buckets and table {k5_ms:.3f} ms "
        f"({mb / k5_ms:.0f} GB/s)")
    live = sum(1 for b in buckets if b.batch)
    require(per_call == -(-live // spmm.ROW_MAX_BUCKETS),
            f"K6: {per_call} launches for one call over {live} buckets")
    torch.cuda.synchronize()


def _k6_bf16_rounding(buckets, n_rows, table, rowfac, scale, pk):
    """K6 with a bf16 table held to the reference's rounding.  Its
    approx-only mode is the same compiled kernel, with the same dot
    product, as the fused pass (proj is a run-time pointer), so its ``a``
    gives the residuals bf16(val - a) that multiplied the table in the
    fused pass.  Holds (1) that ``a`` to the plain version's, to max(1e-5,
    twice the plain version's distance from float64 on the same bf16 left
    factor): a kernel that left the left factor in f32 is ~1e-3 off; (2)
    K6's proj ``pk`` to the plain SpMM of exactly those residuals, to
    max(1e-5, twice that SpMM's distance from float64): a kernel that
    multiplied by the f32 residual is ~1e-3 off.  Prints how many bf16
    residuals differ from the plain version's (the f32 dot products sum in
    other orders, so a residual next to a rounding boundary may round the
    other way), and how far ``pk`` is from the plain version without
    either rounding.  Returns (ok, text)."""
    import torch
    from rsparse_tpu_torch.ops import spmm
    bf = torch.bfloat16
    ak = spmm._residual(buckets, n_rows, rowfac, table, scale, "bfloat16",
                        proj=False, approx=True)[2]
    _, _, ap = spmm._residual_plain(buckets, n_rows, rowfac, table, scale,
                                    "bfloat16", proj=False, approx=True)
    _, _, a64 = spmm._residual_plain(
        buckets, n_rows, (rowfac * scale[None, :]).double(), table.double(),
        None, "bfloat16", proj=False, approx=True)
    flat = lambda xs: torch.cat([x.reshape(-1) for x in xs])  # noqa: E731
    ea = rel_err(flat(ak), flat(ap))
    lim_a = max(1e-5, 2 * rel_err(flat(ap), flat(a64)))
    differ = live = 0
    dks = []
    for b, a_k, a_p in zip(buckets, ak, ap):
        m = b.mask()
        dk = torch.where(m, b.values - a_k, 0.0).to(bf)
        dp = torch.where(m, b.values - a_p, 0.0).to(bf)
        differ += int((dk != dp).sum())
        live += int(b.nnz.sum())
        dks.append(dk.float())
    ys = spmm._spmm_plain(buckets, n_rows, table, values_list=dks,
                          compute_dtype="bfloat16")
    y64 = spmm._spmm_plain(buckets, n_rows, table.to(bf).double(),
                           values_list=[v.double() for v in dks])
    lim = max(1e-5, 2 * rel_err(ys, y64))
    es = rel_err(pk, ys)
    pf, _, _ = spmm._residual_plain(buckets, n_rows, rowfac,
                                    table.to(bf).float(), scale)
    ok = ea <= lim_a and es <= lim
    return ok, (f" (a vs plain {ea:.2e}, limit {lim_a:.2e}; bf16 residuals "
                f"that differ from the plain version's: {differ} of {live}; "
                f"y vs the plain SpMM of K6's residuals {es:.2e}, limit "
                f"{lim:.2e}; vs no bf16 rounding of lf and delta "
                f"{rel_err(pk, pf):.2e})")


def check_spmm_kernels(device, results) -> None:
    """Phase 2 for K5 / K6 on synthetic buckets over a 32,768-row table:
    short, medium and the 8 x 41,280 long-row bucket; k = 10, 128, 256;
    f32 and bf16 tables; K5 with a values override, K6 in approx-only
    mode."""
    import torch
    from rsparse_tpu_torch.ops import spmm
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    n_cols = 32768
    for (B, L, full) in ((4096, 8, False), (512, 256, False),
                         (8, 41280, True)):
        bucket, n_rows = _spmm_case(gen, device, B, L, n_cols, full)
        csr = _buckets_csr([bucket], n_cols)
        for k in (10, 128, 256):
            table = torch.randn((n_cols, k), generator=gen, device=device)
            rowfac = torch.randn((n_rows, k), generator=gen, device=device)
            scale = torch.rand((k,), generator=gen, device=device) + 0.5
            for cdt in (None, "bfloat16"):
                tag = (f"B={B} L={L} k={k} "
                       + ("f32" if cdt is None else "bf16"))
                check_spmm_pair([bucket], n_rows, table, rowfac, scale, cdt,
                                tag, results, csr=csr)
            # K5 with a values override; K6 approx-only (and residual_values)
            over = [torch.randn(bucket.values.shape, generator=gen,
                                device=device).contiguous()]
            yk = spmm.spmm_buckets([bucket], n_rows, table, values_list=over)
            yp = spmm._spmm_plain([bucket], n_rows, table, values_list=over)
            ak = spmm.sparse_approx_buckets([bucket], rowfac, table, scale)[0]
            _, _, ap = spmm._residual_plain([bucket], n_rows, rowfac, table,
                                            scale, proj=False, approx=True)
            rk = spmm.residual_values([bucket], rowfac, table, scale)[0]
            torch.cuda.synchronize()
            ev, ea = rel_err(yk, yp), rel_err(ak, ap[0])
            er = rel_err(rk, bucket.values - ap[0])
            log(f"  K5 spmm     B={B} L={L} k={k} values override"
                f"{'':20s} y_rel={ev:.2e}; K6 approx-only a_rel={ea:.2e} "
                f"residual_rel={er:.2e}")
            require(ev <= 1e-5 and ea <= 1e-5 and er <= 1e-5,
                    f"K5/K6 B={B} L={L} k={k}: values override or "
                    "approx-only disagrees with the plain version")


# -- phases 3 to 6: the main paths -------------------------------------------

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


def check_staged_buckets(m, x, results, nnls_max_iter=300,
                         record_budget=False, k2_fit=False,
                         max_rows=None) -> None:
    """Each kernel of a fitted model's path against its plain version at
    the shapes the fit gave it: per sweep, the buckets with the most padded
    entries (B x L), the most rows and the longest rows, staged as
    fit_transform stages them (with compute_dtype="bfloat16" from the bf16
    shadow table), with the fitted factors as sources and warm starts.  The
    error of each against the plain version at float64 (with the same bf16
    roundings) is printed beside; a bf16 solve that is off its plain
    version by more than the limit (a bf16 rounding sent the other way by
    the other float32 order) passes when it is no further from the float64
    twin than twice the plain version, in the Frobenius norm, and the y
    cells off by more than the limit are counted.  The loss is held to the
    plain version's loss of the kernel's own solution (1e-5): on rows of
    tens of thousands of entries the solutions themselves differ by ~1e-5
    in float32, which their losses carry.  K4 is held against its
    plain version at most
    ``nnls_max_iter`` sweeps (the plain loop costs launches per coordinate
    step); then it runs alone with the fit's own budget, and the
    distribution of its sweeps is printed; with ``record_budget`` that run
    on the item sweep's bucket of the most rows is K4's second row of the
    kernels line (its bound counts the sweeps each system ran).  K2 prints
    its plan and stages on each bucket, and runs the whole closing sweep
    (every bucket, as fit_transform and transform launch it) timed by CUDA
    events beside the sum of its buckets' bounds; with ``k2_fit`` that is
    K2's second row of the kernels line.  At d > 160 the kernels are the
    wide routes (their own rows of the kernels line); ``max_rows`` checks
    the first rows of each picked bucket only (a float64 Cholesky twin of
    a bucket of 11,272 rows at d = 514 would hold 24 GB of Grams)."""
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
        if src_act.shape[1] > als.WIDE_D:
            name += "_wide"
        src_act = als._gather_src(src_act, cfg, torch.float32)
        rounds = als._rounds_bf16(cfg, torch.float32)
        _, tgt_sl = als._active_slices(cfg, src.shape[1])
        old_act = (torch.zeros((br.n_rows, src_act.shape[1]),
                               device=src.device) if old is None
                   else old[:, tgt_sl].float())
        Vh = None if hot is None else src_act[hot.long()].contiguous()
        bs = br.buckets
        picks = sorted({max(range(len(bs)), key=key) for key in (
            lambda i: bs[i].batch * bs[i].pad_len,
            lambda i: bs[i].batch, lambda i: bs[i].pad_len)})
        for bi in picks:
            b = bs[bi]
            W = bits = nnz_tot = scale = None
            if rows is not None:
                W, bits, row_nnz, scale = rows[bi]
                if cfg.feedback == "explicit" and cfg.dynamic_lambda:
                    nnz_tot = row_nnz
            if max_rows is not None and b.batch > max_rows:
                cut = lambda t: None if t is None else t[:max_rows]  # noqa
                b = type(b)(*(t[:max_rows] for t in b))
                W, bits, nnz_tot, scale = (cut(W), cut(bits), cut(nnz_tot),
                                           cut(scale))
            ids = b.row_ids.clamp(max=old_act.shape[0] - 1).long()
            x0 = old_act[ids].contiguous()
            args = (src_act, xb, XtX, rhs_init, b, x0, lam, g, cfg, W, Vh,
                    bits, nnz_tot)
            sw = None
            kern = functools.partial(als._SOLVE[cfg.solver], hot_scale=scale)
            plain = functools.partial(als._solve_bucket_plain,
                                      hot_scale=scale)
            if cfg.solver == als.NNLS:
                sw = torch.zeros((b.batch,), dtype=torch.int32,
                                 device=src.device)
                kern = functools.partial(als.solve_bucket_nnls, sweeps=sw,
                                         hot_scale=scale)
            yk, lk = kern(*args)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            yp, lp = plain(*args)
            t1.record()
            d64 = lambda t: None if t is None else t.double()  # noqa: E731
            y64, l64 = als._solve_bucket_plain(
                src_act.double(), d64(xb), d64(XtX), d64(rhs_init), b,
                x0.double(), lam, g, cfg,
                W if W is None or W.dtype == torch.uint8 else W.double(),
                d64(Vh), bits, nnz_tot, hot_scale=d64(scale),
                rounding=rounds)
            torch.cuda.synchronize()
            ey, el = rel_err(yk, yp), rel_err(lk, lp)
            ms = time_ms(lambda: kern(*args), reps=3)
            pms = (t0.elapsed_time(t1) if sw is not None else
                   time_ms(lambda: plain(*args), reps=3))
            tag = (f"{sweep} {cfg.feedback[:3]} B={b.batch} L={b.pad_len} "
                   f"d={src_act.shape[1]} H={0 if W is None else W.shape[1]}")
            extra = ("" if sw is None else
                     f" {nnls_summary(sw, src_act)} (cap {nnls_max_iter})")
            if cfg.solver == als.CHOLESKY:
                extra += "\n    " + k2_detail(args, scale)[1]
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
            if rounds:
                hold_bf16(f"{name} {tag}", yk, yp, y64, lim)
            else:
                require(ey <= lim, f"{name} {tag}: y disagrees with its "
                        f"plain version ({ey:.2e} > {lim:.2e})")
            hold_loss_at_own_y(f"{name} {tag}", args, yk, lk, scale)
            r = results[name.split()[1]]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   float((yk - yp).abs().max()))
            del yk, lk, yp, lp, y64, l64
            if sw is not None:
                # the fit's own budget: the sweeps K4 really runs
                t0.record()
                yk, _ = als.solve_bucket_nnls(*args[:8], fit_cfg, *args[9:],
                                              sweeps=sw, hot_scale=scale)
                t1.record()
                torch.cuda.synchronize()
                bms, bby = als_bound((*args[:8], fit_cfg, *args[9:]), sw,
                                     scale)
                fms = t0.elapsed_time(t1)
                log(f"  {name:11s} {tag:50s} budget {fit_cfg.nnls_max_iter}:"
                    f" kernel={fms:.3f} ms bound={bms:.4f} ms ({bby}) "
                    f"{nnls_summary(sw, src_act)}, at the budget "
                    f"{int((sw >= fit_cfg.nnls_max_iter).sum())} of {b.batch}")
                require(bool(torch.isfinite(yk).all()) and
                        float(yk.min()) >= 0, f"{name} {tag}: K4 with the "
                        "fit's budget gave a negative or non-finite factor")
                if record_budget and sweep == "item sweep" and bi == max(
                        range(len(bs)), key=lambda i: bs[i].batch):
                    results["als_nnls"].update(
                        fit_shape=f"{tag}, budget {fit_cfg.nnls_max_iter}",
                        fit_ms=fms, fit_bound_ms=bms, fit_bound_by=bby,
                        fit_sweeps=sweep_summary(sw))
        if cfg.solver == als.CHOLESKY and sweep == "closing sweep":
            _k2_sweep(results if k2_fit else None, src_act, xb, XtX,
                      rhs_init, bs, lam, g, cfg, br.n_rows)


def _k2_sweep(results, src_act, xb, XtX, rhs_init, buckets, lam, g, cfg,
              n_rows) -> None:
    """K2 over every bucket of a closing sweep (no head), one launch a
    bucket as the sweep makes them, timed by CUDA events after a warm-up
    pass; its bound is the larger of the buckets' summed bytes and summed
    operations (als_bound_parts).  ``results`` given: K2's fit row."""
    import torch
    from rsparse_tpu_torch.ops import als
    every = [(src_act, xb, XtX, rhs_init, b, None, lam, g, cfg, None, None,
              None, None) for b in buckets]
    parts = [als_bound_parts(a, plan=als.cholesky_plan(*a)) for a in every]
    tb, to = sum(p[0] for p in parts), sum(p[1] for p in parts)
    bms, bby = (tb, "bytes") if tb >= to else (to, "operations")
    for a in every:
        als.solve_bucket_cholesky(*a)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for a in every:
        als.solve_bucket_cholesky(*a)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1)
    shape = (f"closing {cfg.feedback[:3]} sweep, {n_rows} rows in "
             f"{len(every)} buckets, d={src_act.shape[1]}")
    key = "als_chol_wide" if src_act.shape[1] > als.WIDE_D else "als_chol"
    log(f"  K2 {key} {shape}: kernel={ms:.3f} ms over {len(every)} "
        f"launches, bound={bms:.4f} ms ({bby}), "
        f"{n_rows / ms * 1e3:.0f} rows/s")
    if results is not None:
        results[key].update(fit_shape=shape, fit_ms=ms,
                                   fit_bound_ms=bms, fit_bound_by=bby,
                                   fit_launches=len(every))


def k1_bucket_table(m, x, fit_tag, results=None) -> None:
    """K1 bucket by bucket over both CG half-sweeps of a fitted model, as
    fit_transform stages them (the fitted factors as sources and warm
    starts): rows x length, head columns, the launch K1 takes for it (rows
    a CTA and CTAs a row, from ``als.cg_plan``), K1's and the plain
    version's ms (CUDA events, mean of 3), each half-sweep summed.  Every
    bucket is held to its plain version: y 1e-4 (bf16 rounding: the cells
    that round apart, held by the float64 twin as phase 4 holds them), the
    loss 1e-5 against the plain loss of the kernel's own y."""
    import torch
    from rsparse_tpu_torch.ops import als
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
        rounds = als._rounds_bf16(cfg, torch.float32)
        _, tgt_sl = als._active_slices(cfg, src.shape[1])
        old_act = old[:, tgt_sl].float()
        Vh = None if hot is None else src_act[hot.long()].contiguous()
        tot_k = tot_p = 0.0
        for bi, b in enumerate(br.buckets):
            W = bits = scale = None
            if rows is not None:
                W, bits, _, scale = rows[bi]
            x0 = old_act[b.row_ids.clamp(max=old_act.shape[0] - 1).long()
                         ].contiguous()
            args = (src_act, xb, XtX, rhs_init, b, x0, lam, g, cfg, W, Vh,
                    bits, None)
            kern = functools.partial(als.solve_bucket_cg, hot_scale=scale)
            plain = functools.partial(als._solve_bucket_plain,
                                      hot_scale=scale)
            yk, lk = kern(*args)
            yp, lp = plain(*args)
            ms = time_ms(lambda: kern(*args), reps=3)
            pms = time_ms(lambda: plain(*args), reps=3)
            tot_k += ms
            tot_p += pms
            H = 0 if W is None else W.shape[1]
            pl = als.cg_plan(*args, hot_scale=scale)
            split = (f" {pl['rows']} rows x {pl['cluster']} CTAs, "
                     f"{pl['dense_panels']}/{pl['panels']} dense panels")
            tag = (f"{fit_tag} {sweep} {b.batch} x {b.pad_len} H={H}")
            ey = rel_err(yk, yp)
            log(f"  K1 bucket {tag:44s}{split} kernel={ms:.3f} ms "
                f"plain={pms:.3f} ms y_rel={ey:.2e}")
            require(bool(torch.isfinite(yk).all() and torch.isfinite(lk).all()),
                    f"K1 {tag}: non-finite output")
            if rounds and ey > 1e-4:
                d64 = lambda t: None if t is None else t.double()  # noqa
                y64, _ = als._solve_bucket_plain(
                    src_act.double(), d64(xb), d64(XtX), d64(rhs_init), b,
                    x0.double(), lam, g, cfg,
                    W if W is None or W.dtype == torch.uint8 else W.double(),
                    d64(Vh), bits, None, hot_scale=d64(scale), rounding=True)
                hold_bf16(f"K1 {tag}", yk, yp, y64, 1e-4)
                del y64
            else:
                require(ey <= 1e-4, f"K1 {tag}: y disagrees with its plain "
                        f"version ({ey:.2e})")
            hold_loss_at_own_y(f"K1 {tag}", args, yk, lk, scale)
            if results is not None:
                r = results["als_cg"]
                r["max_abs_err"] = max(r["max_abs_err"],
                                       float((yk - yp).abs().max()))
            del yk, lk, yp, lp
        log(f"  K1 {fit_tag} {sweep} half-sweep, {len(br.buckets)} buckets: "
            f"kernel {tot_k:.3f} ms, plain {tot_p:.3f} ms")
        torch.cuda.empty_cache()


def k1_buckets_full_width(device, x, m32, results) -> None:
    """Phase 4's K1 table: the float32 fit's buckets, then the headline
    fit's (compute_dtype="bfloat16", n_hot=4096, bench.py:744)."""
    import torch
    import rsparse_tpu_torch as rt
    k1_bucket_table(m32, x, "f32", results)
    m = rt.WRMF(rank=128, seed=0, device=device, lambda_=0.1,
                feedback="implicit", solver="conjugate_gradient",
                compute_dtype="bfloat16", n_hot=4096)
    m.fit_transform(x, n_iter=2, convergence_tol=-1)
    torch.cuda.synchronize()
    log("  headline fit per sweep: " + ", ".join(
        f"{r['phase']}#{r['iter']} {r['wall_s'] * 1e3:.2f} ms"
        for r in m.fit_trace))
    k1_bucket_table(m, x, "bf16", results)
    del m
    torch.cuda.empty_cache()


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


#: host wall of each full-width fit_transform, by its name in the log
FIT_WALLS = {}


def _fit_full_width(device, x, what, names, launches, n_iter=2, rank=128,
                    **kw):
    """One full-width fit_transform through the public entry point, its
    launch counts and per-sweep times."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    m = rt.WRMF(rank=rank, seed=0, device=device, **kw)
    t0 = time.perf_counter()
    emb = m.fit_transform(x, n_iter=n_iter, convergence_tol=-1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    FIT_WALLS[what] = fit_s
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
    log(f"  loss {m.loss_history}; peak device memory {peak:.2f} GiB "
        f"({peak - held:.2f} GiB above the {held:.2f} GiB held before)")
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
    for _ in range(2):  # the serving path alone: staging + K2, twice
        t0 = time.perf_counter()
        m.transform(x)
        torch.cuda.synchronize()
        log(f"  transform {x.shape[0]} users (K2, rank 128): "
            f"{time.perf_counter() - t0:.3f} s")
    launches[-1] = check_launched(_kernels, "full-width implicit main path "
                                  "with predict", ("als_cg", "als_chol",
                                                   "topk"))
    predict_parts(m, q)  # after the count: its launches are not the path's
    require(m.loss_history[1] <= m.loss_history[0], "full width: loss rose")
    check_predictions(preds.indices, 10, x.shape[1], sp.csr_matrix(q),
                      "full width")
    return m


def predict_parts(m, q, k=10) -> None:
    """WRMF ``predict(q, k, not_recommend=q)`` at full width by part: the
    transform, then ``top_product``'s loop over chunks of 256 users done as
    it does it, each part summed over the chunks: the host bit packing, the
    mask's copy to the card, the scoring matmul and K3 (CUDA events), and
    the results' copy back."""
    import torch
    from rsparse_tpu_torch.ops import topk
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    emb = m.transform(q)
    torch.cuda.synchronize()
    wall = {"transform": time.perf_counter() - t0}
    x = torch.as_tensor(emb, dtype=torch.float32, device=dev)
    y = torch.as_tensor(m.components, dtype=torch.float32, device=dev)
    n_users, n_items = x.shape[0], y.shape[1]
    n_pad = -(-n_items // 256) * 256
    y = torch.nn.functional.pad(y, (0, n_pad - n_items))
    nr = sp.csr_matrix(q)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for key in ("pack", "upload", "matmul", "K3", "download"):
        wall[key] = 0.0
    for s in range(0, n_users, 256):
        e = min(s + 256, n_users)
        t0 = time.perf_counter()
        packed = topk.pack_mask_bits(n_pad, csr=nr, rows=slice(s, e),
                                     n_rows=e - s)
        t1 = time.perf_counter()
        bits = torch.from_numpy(packed).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ev[0].record()
        sc = x[s:e] @ y
        ev[1].record()
        ts, ti = topk.masked_top_k_bits(sc, bits, k, float(m.global_bias))
        ev[2].record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ts.cpu().numpy()
        ti.cpu().numpy()
        t4 = time.perf_counter()
        wall["pack"] += t1 - t0
        wall["upload"] += t2 - t1
        wall["matmul"] += ev[0].elapsed_time(ev[1]) / 1e3
        wall["K3"] += ev[1].elapsed_time(ev[2]) / 1e3
        wall["download"] += t4 - t3
    log(f"  predict {n_users} users k={k} by part (ms): " + ", ".join(
        f"{key} {v * 1e3:.3f}" for key, v in wall.items())
        + f"; {-(-n_users // 256)} chunks of 256")


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
    check_staged_buckets(m, xs, results, record_budget=True)


# -- phase 6: the low-rank family ---------------------------------------------

#: the reference's ML-100k quality (rsparse_tpu on the CPU, float32; pinned
#: by tests/test_torch_soft_als.py): (NDCG@10, MAP@10)
ML100K_PURESVD = (0.3258, 0.3848)
ML100K_LINEAR_FLOW = (0.3338, 0.3924)


def run_low_rank_ml100k(device, launches) -> None:
    """PureSVD (rank 10, 100 iterations) and LinearFlow (rank 10, lambda 1,
    30 iterations) on the 80/20 split, seed 0: fit_transform -> predict,
    held to the reference's values within 0.01."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    x = rt.load_movielens100k()
    train, test = rt.train_test_split(x, 0.2, np.random.default_rng(0))
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ps = rt.PureSVD(rank=10, seed=0, device=device)
    ps.fit_transform(train, n_iter=100)
    p_ps = ps.predict(train, k=10, not_recommend=train)
    lf = rt.LinearFlow(rank=10, lambda_=1.0, seed=0, device=device)
    lf.fit_transform(train, n_iter=30)
    p_lf = lf.predict(train, k=10, not_recommend=train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "ML-100k low-rank main path",
                                   ("spmm", "spmm_residual", "topk")))
    for name, p, ref, its in (("PureSVD", p_ps, ML100K_PURESVD,
                               len(ps.trace)),
                              ("LinearFlow", p_lf, ML100K_LINEAR_FLOW,
                               len(lf.svd_trace))):
        ndcg = float(np.nanmean(rt.ndcg_k(p.indices, test)))
        mapk = float(np.nanmean(rt.ap_k(p.indices, test)))
        log(f"  {name} rank 10: NDCG@10={ndcg:.4f} MAP@10={mapk:.4f} "
            f"(reference {ref[0]:.4f} / {ref[1]:.4f}) soft-ALS iterations "
            f"{its}")
        require(abs(ndcg - ref[0]) <= 0.01 and abs(mapk - ref[1]) <= 0.01,
                f"ML-100k {name}: quality off the reference by more than "
                "0.01")
        check_predictions(p.indices, 10, train.shape[1], train,
                          f"ML-100k {name}")
    log(f"  wall (both fits and predicts) {wall:.2f} s")


def _heaviest(buckets):
    """Indices of the buckets with the most padded entries and the longest
    rows."""
    return sorted({max(range(len(buckets)), key=lambda i: buckets[i].batch
                       * buckets[i].pad_len),
                   max(range(len(buckets)),
                       key=lambda i: buckets[i].pad_len)})


def run_config3(device, x, results, launches) -> None:
    """The reference benchmark's config #3 (bench.py measure_soft_impute,
    measure_linear_flow) at rank 256 on the ML-20M-shaped synthetic."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.models.soft_als import staged_buckets
    from rsparse_tpu_torch.sparse.device import clear_staging_cache
    rank = 256
    sub = sp.csr_matrix(x[:16384])

    log(f"  (b) soft_impute rank {rank} on the first 16,384 users "
        f"({sub.nnz} nnz): 6 iterations, the first a warm-up")
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fit = rt.soft_impute(sub, rank=rank, lambda_=1.0, n_iter=6,
                         convergence_tol=-1, seed=0, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "config #3 soft_impute",
                                   ("spmm_residual",)))
    its = [r["wall_s"] * 1e3 for r in fit.trace]
    log(f"  soft_impute: {float(np.mean(its[1:])):.3f} ms per iteration "
        f"(iterations {[round(t, 3) for t in its]} ms), wall {wall:.3f} s "
        f"incl. staging and the final SVD; loss/nnz "
        f"{[round(r['loss'], 5) for r in fit.trace]}")
    require(bool(torch.isfinite(fit.d).all()) and fit.u.shape[0] == 16384,
            "config #3 soft_impute: bad result")
    t0 = time.perf_counter()
    fit16 = rt.soft_impute(sub, rank=rank, lambda_=1.0, n_iter=1,
                           convergence_tol=-1, seed=0,
                           compute_dtype="bfloat16", device=device)
    log(f"  soft_impute, compute_dtype=bfloat16: first iteration "
        f"{fit16.trace[0]['wall_s'] * 1e3:.3f} ms (f32 {its[0]:.3f} ms), "
        f"loss/nnz {fit16.trace[0]['loss']:.5f} (f32 "
        f"{fit.trace[0]['loss']:.5f}), wall "
        f"{time.perf_counter() - t0:.3f} s")
    require(abs(fit16.trace[0]["loss"] - fit.trace[0]["loss"])
            <= 1e-2 * abs(fit.trace[0]["loss"]),
            "config #3: the bf16 iteration's loss is off the f32 one")
    del fit16

    log(f"  (b) LinearFlow(rank={rank}, lambda_=1.0, seed=0)"
        ".fit_transform(x, n_iter=10) on the whole matrix")
    clear_staging_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lf = rt.LinearFlow(rank=rank, lambda_=1.0, seed=0, device=device)
    xv = lf.fit_transform(x, n_iter=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "config #3 LinearFlow "
                                   "fit_transform", ("spmm", "spmm_residual")))
    ph = lf.fit_trace.summary()
    it_s = sum(r["wall_s"] for r in lf.svd_trace)
    log(f"  fit_transform {wall:.3f} s = staging {ph['staging']:.3f} s + "
        f"soft-impute {ph['soft_impute']:.3f} s ({len(lf.svd_trace)} "
        f"iterations {it_s:.3f} s, {it_s / len(lf.svd_trace) * 1e3:.3f} ms "
        f"each; staging lookup + final SVD {ph['soft_impute'] - it_s:.3f} s)"
        f" + lhs/rhs {ph['lhs_rhs'] * 1e3:.3f} ms + solve "
        f"{ph['solve'] * 1e3:.3f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(tuple(xv.shape) == (x.shape[0], rank) and
            bool(torch.isfinite(xv).all()) and
            np.isfinite(lf.components).all(), "config #3 LinearFlow: bad "
            "result")
    # the pieces of that wall that are not kernels of the port
    from rsparse_tpu_torch.models.soft_als import svd_tall_skinny
    from rsparse_tpu_torch.sparse.device import _csr_fingerprint
    xc = sp.csr_matrix(x).astype(np.float64)
    t0 = time.perf_counter()
    _csr_fingerprint(xc)
    fp_s = time.perf_counter() - t0
    g = torch.randn((x.shape[0], rank), device=device)
    h = torch.randn((x.shape[1], rank), device=device)
    svd_ms = time_ms(lambda: torch.linalg.svd(g, full_matrices=False), 3)
    ts_ms = time_ms(lambda: svd_tall_skinny(h), 5)
    eigh_ms = time_ms(lambda: torch.linalg.eigh(h.T @ h), 5)
    log(f"  pieces: staging-cache fingerprint of x (host) {fp_s * 1e3:.1f} "
        f"ms; torch.linalg.svd of {x.shape[0]} x {rank} {svd_ms:.3f} ms; "
        f"svd_tall_skinny of {x.shape[1]} x {rank} {ts_ms:.3f} ms, of which"
        f" eigh of the {rank} x {rank} Gram {eigh_ms:.3f} ms")
    del g, h

    sub16, cv_users = sp.csr_matrix(x[:16384]), 16384
    tr, te = rt.train_test_split(sub16, 0.5, np.random.default_rng(0))
    for n_iter in (10, 100):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = rt.LinearFlow(rank=rank, seed=0, device=device)
        res = m.cross_validate_lambda(sub16, tr, te, lambda_="auto@5",
                                      metric="map@10", n_iter=n_iter)
        p = m.predict(tr, k=10, not_recommend=tr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.append(check_launched(
            _kernels, f"config #3 cross_validate_lambda n_iter={n_iter}",
            ("spmm", "spmm_residual", "topk")))
        best = max(res, key=lambda r: r["score"])
        tr_ = m.svd_trace
        log(f"  cross_validate_lambda ({cv_users} users, auto@5, map@10, "
            f"n_iter={n_iter}, tol 1e-3): {len(tr_)} soft-impute iterations"
            f" (last frob_delta {tr_[-1]['frob_delta']:.2e}), best lambda "
            f"{best['lambda']:.4g} map@10={best['score']:.4f}; scores "
            + ", ".join(f"{r['lambda']:.4g}: {r['score']:.4f}" for r in res)
            + f"; wall {wall:.3f} s incl. predict")
        require(all(np.isfinite(r["score"]) for r in res),
                "config #3 CV: a NaN score")
        check_predictions(p.indices, 10, x.shape[1], tr,
                          f"config #3 CV n_iter={n_iter}")
        del m

    log("  (c) K5 / K6 on the heaviest buckets of the soft-impute fit (both"
        " orientations, f32 and bf16), then each as a whole function")
    f32 = torch.float32
    csr = sub.astype(np.float64)
    x_b = staged_buckets(csr, f32, device)
    tx_b = staged_buckets(csr, f32, device, transpose=True)
    u, d, v = fit.u, fit.d, fit.v
    for orient, br, n_rows, table, rowfac in (
            ("users", x_b, sub.shape[0], v, u),
            ("items", tx_b, sub.shape[1], u, v)):
        for bi in _heaviest(br.buckets):
            b = br.buckets[bi]
            for cdt in (None, "bfloat16"):
                tag = (f"{orient} B={b.batch} L={b.pad_len} k={rank} "
                       + ("f32" if cdt is None else "bf16"))
                check_spmm_pair([b], n_rows, table, rowfac, d, cdt, tag,
                                results, reps=3)
    # whole functions at the main path's shapes, with the library calls
    check_spmm_pair(list(tx_b.buckets), sub.shape[1], u, v, d, None,
                    f"soft-impute item step, {len(tx_b.buckets)} buckets",
                    results, rep=True, reps=3, which=("K6",),
                    csr=_buckets_csr(tx_b.buckets, sub.shape[0]))
    txf = staged_buckets(sp.csr_matrix(x).astype(np.float64), f32, device,
                         transpose=True)
    check_spmm_pair(list(txf.buckets), x.shape[1], xv, None, None, None,
                    f"LinearFlow rhs (x'(xV)), {len(txf.buckets)} buckets",
                    results, rep=True, reps=3, which=("K5",),
                    csr=_buckets_csr(txf.buckets, x.shape[0]))
    xf = staged_buckets(sp.csr_matrix(x).astype(np.float64), f32, device)
    check_spmm_pair(list(xf.buckets), x.shape[0], lf.v, None, None, None,
                    f"LinearFlow xV, {len(xf.buckets)} buckets", results,
                    reps=3, which=("K5",),
                    csr=_buckets_csr(xf.buckets, x.shape[1]))


# -- phase 7: the SGD family (FTRL, FM, RankMF) ------------------------------

#: The reference's quality on the CPU (rsparse_tpu, float32), held by
#: ``test_reference_quality`` in tests/test_torch_{ftrl,fm,rankmf}.py: the
#: train accuracy
#: (predict(x) > 0.5 against the labels) of FTRL(learning_rate=0.1,
#: lambda_=1.0, seed=0) and of FactorizationMachine(rank=8,
#: learning_rate_w=0.2, seed=0) after fit(x, truth, n_iter=3) on
#: synth_glm(); and (auc_history[-1], NDCG@10) of RankMF(rank=16,
#: learning_rate=0.5, loss="bpr", seed=0, batch_size=2048)
#: .partial_fit_transform(train, n_iter=200) on the ML-100k 80/20 split
#: (seed 0), scored in float64 with the training items masked.
REF_GLM_ACC = {"ftrl": 0.69577, "fm": 0.98271}
REF_RANKMF_ML100K = (0.8720, 0.2336)

#: phase 7's shapes: the GLM block of the kernel checks (B, L), the hashed
#: feature count (bench.py:760-765), config #5 (bench.py:327-393) and its
#: RankMF batch (S, K), the users of K9's synthetic check
GLM_BLOCK = (32768, 32)
HASHED_FEATURES = 40_000_000
CONFIG5 = dict(n_users=10_000_000, n_items=131_072, nnz_per_user=5,
               fm_rows=2_000_000)
K9_USERS = 200_000
K9_BATCH = (8192, 20)


def synth_glm(n_rows=100_000, n_feat=10_000, nnz_per_row=32, seed=0):
    """The reference benchmark's GLM problem (bench.py:396
    measure_ftrl_fm): N(0, 1) values at uniform columns, duplicates summed,
    labels from the sign of the row's sum over the first 64 columns."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    cols = rng.integers(0, n_feat, n_rows * nnz_per_row)
    vals = rng.standard_normal(n_rows * nnz_per_row).astype(np.float32)
    x = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_feat))
    x.sum_duplicates()
    truth = (np.asarray(x[:, :64].sum(axis=1)).ravel() > 0).astype(np.float64)
    return x, truth


def synth_config5(n_users, n_items, nnz_per_user, fm_rows, seed=0):
    """The reference benchmark's config #5 data (bench.py:327-393): each
    user's ``nnz_per_user`` uniform items, sorted; one-hot (user, item) FM
    rows over n_users + n_items features, labelled u % 3 == 0.  Returns
    (interactions, FM rows, FM labels)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_items, n_users * nnz_per_user, dtype=np.int64)
    indptr = np.arange(0, n_users * nnz_per_user + 1, nnz_per_user,
                       dtype=np.int64)
    cols = np.sort(cols.reshape(n_users, nnz_per_user), axis=1).reshape(-1)
    x = sp.csr_matrix((np.ones(len(cols), np.float32),
                       cols.astype(np.int32), indptr),
                      shape=(n_users, n_items))
    if not fm_rows:
        return x, None, None
    u = rng.integers(0, n_users, fm_rows, dtype=np.int64)
    i = rng.integers(0, n_items, fm_rows, dtype=np.int64)
    fmx = sp.csr_matrix(
        (np.ones(2 * fm_rows, np.float32),
         np.stack([u, n_users + i], 1).reshape(-1),
         np.arange(0, 2 * fm_rows + 1, 2, dtype=np.int64)),
        shape=(fm_rows, n_users + n_items))
    return x, fmx, (u % 3 == 0).astype(np.float64)


def glm_bound(blk, r=None, do_update=True):
    """Bound of K7 (r None) or K8 (rank r) on one block: bytes of the
    entries (column and value, 8 each), of each row's length and prediction
    (8) and, with the update, label and weight (8 more), and of each
    distinct feature of the block: one read of its table rows (K7: z, n;
    K8: w, v) and, with the update, of the accumulators (K8) and one write
    of all of them.  A row's address is its column: the port's slot map
    and feature ids are its own layout and are not counted.  Operations
    per entry ~10 (K7), 3r + 2 (K8), and with the update ~12 (K7), 6r + 6
    (K8) more."""
    n = float(blk.nnz.double().sum())
    B, U = blk.nnz.shape[0], blk.feats.shape[0]
    if r is None:
        feat = 16 if do_update else 8
        fl = n * (22 if do_update else 10)
    else:
        feat = 16 * (r + 1) if do_update else 4 * (r + 1)
        fl = n * ((9 * r + 8) if do_update else (3 * r + 2))
    nbytes = n * 8 + B * (16 if do_update else 8) + U * feat
    return bound(nbytes, fl)


def _delta_err(after_k, after_p, before, rows=None):
    """(max |kernel - plain| / max |plain - before|, max |kernel - plain|,
    that distance in float32 spacings of the largest stored value) of a
    table's change, over ``rows`` (all rows if None).  Where the change is
    far below the stored values (an accumulator of 1.5 that grows by
    1e-3), the two tables can only agree to their own rounding: the third
    number measures that."""
    if rows is not None:
        after_k, after_p, before = after_k[rows], after_p[rows], before[rows]
    if not after_p.numel():
        return 0.0, 0.0, 0.0
    dk = after_k.double() - before.double()
    dp = after_p.double() - before.double()
    diff = float((dk - dp).abs().max())
    spacing = 2.0 ** -23 * float(after_p.double().abs().max())
    return (diff / max(float(dp.abs().max()), 1e-30), diff,
            diff / max(spacing, 1e-45))


def _hold(name, tag, errs, results, lim=1e-5):
    """Print the distances of a kernel from its plain version and hold
    each output to ``lim`` relative to its change, or to 2 float32 spacings
    of its stored values; returns the largest absolute distance."""
    for what, (rel, _, ulps) in errs.items():
        require(rel <= lim or ulps <= 2.0, f"{name} {tag}: {what} disagrees "
                f"with the plain version ({rel:.2e} > {lim:.0e} of its change"
                f", {ulps:.2f} float32 spacings)")
    diff = max(e[1] for e in errs.values())
    r = results[name]
    r["max_abs_err"] = max(r["max_abs_err"], diff)
    return " ".join(f"{k}_rel={v[0]:.2e}" + (f" ({v[2]:.2f} ulp)"
                                             if v[0] > lim else "")
                    for k, v in errs.items())


#: K7 and K8 by launch-counter name, which also names their module in
#: rsparse_tpu_torch/models: the label, and the state tables in the order
#: the block functions take them
GLM_KERNELS = {"ftrl": ("K7 ftrl", ("z", "n")),
               "fm": ("K8 fm", ("w0", "acc_w0", "w", "v", "acc_w", "acc_v"))}


def _glm_clone(name, state, layout):
    """Fresh copies of a block function's state; K7's (z, n) as the two
    columns of one (F + 1, 2) table (``layout="pair"``, the model's) or as
    two separate tables."""
    import torch
    if layout == "pair":
        zn = torch.stack([t.detach() for t in state], 1)
        return [zn[:, 0], zn[:, 1]]
    return [t.clone() for t in state]


def check_glm_block(name, blk, state, y, w, params, tag, results,
                    rep=False, reps=5, twin=False):
    """K7 (``name="ftrl"``, state (z, n), params (lr, decay, l1, l2,
    dropout, keep, family)) or K8 (``"fm"``, state (w0, acc_w0, w, v,
    acc_w, acc_v), params (lr_w, lr_v, lambda_w, lambda_v, family,
    intercept)) against its plain version on one block from ``state``, in
    predict and in update mode; each table held by its change on the
    block's features, with ``twin`` as by_float64_twin says.  K7 runs on
    the model's pair table and on two separate tables, and two launches
    from the same state must give bitwise-equal tables."""
    import importlib
    import torch
    label, names = GLM_KERNELS[name]
    mod = importlib.import_module(f"rsparse_tpu_torch.models.{name}")
    kern = getattr(mod, f"_{name}_block")
    plain = getattr(mod, f"_{name}_block_plain")
    rows = blk.feats.long()
    r = state[3].shape[1] if name == "fm" else None
    layouts = ("pair", "separate") if name == "ftrl" else (None,)
    for do_update, layout in itertools.product((False, True), layouts):
        args = (blk, y, w, *params, do_update)
        sk = _glm_clone(name, state, layout)
        sp_ = [t.clone() for t in state]
        yk = kern(*sk, *args)
        yp = plain(*sp_, *args)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(t).all()) for t in (yk, *sk)),
                f"{label} {tag}: non-finite output")
        errs = {"y": _delta_err(yk, yp, torch.zeros_like(yp))}
        if do_update:
            for tname, a, b, t0 in zip(names, sk, sp_, state):
                errs[tname] = _delta_err(a, b, t0, rows if t0.dim() else None)
                if t0.dim():
                    out = torch.ones(t0.shape[0], dtype=torch.bool,
                                     device=t0.device)
                    out[rows] = False
                    require(torch.equal(a[out], b[out]),
                            f"{label} {tag}: {tname} differs from the plain "
                            "version outside the block's features")
                    del out
        else:
            require(all(torch.equal(a, b) for a, b in zip(sk, state)),
                    f"{label} {tag}: predict mode changed the tables")
        if do_update and name == "ftrl":
            s2 = _glm_clone(name, state, layout)
            y2 = kern(*s2, *args)
            require(torch.equal(y2, yk) and all(
                torch.equal(a, b) for a, b in zip(s2, sk)),
                f"{label} {tag}: two launches on the same inputs differ")
            del s2
        if do_update and twin:
            by_float64_twin(name, blk, state, sk, sp_, y, w, params, tag,
                            errs)
        text = _hold(name, tag, errs, results)
        ms = time_ms(lambda: kern(*sk, *args), reps)
        dms = graph_ms([lambda: kern(*sk, *args)], reps=20)
        pms = time_ms(lambda: plain(*sp_, *args), reps)
        bms, bby = glm_bound(blk, r, do_update)
        mode = "update" if do_update else "predict"
        if layout:
            mode += f" ({layout} tables)"
        log(f"  {label:11s} {tag} {mode:7s} {text} kernel={ms:.3f} ms "
            f"(device {dms:.4f} ms by CUDA graphs) plain={pms:.3f} ms "
            f"bound={bms:.4f} ms ({bby})")
        if rep and do_update and layout in (None, "pair"):
            results[name].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                 bound_by=bby, library_ms=None,
                                 shape=f"{tag} update", device_ms=dms)
        del sk, sp_


def _glm_block(col, val, nnz):
    """A GLMBlock of (B, L) column ids and values with row lengths ``nnz``,
    its slot map and feature-ordered entry list made by torch on the card
    (torch.unique; a stable argsort of the slots; their counts)."""
    import torch
    from rsparse_tpu_torch.ops.segsum import GLMBlock
    B, L = col.shape
    live = torch.arange(L, device=col.device)[None, :] < nnz[:, None]
    col = (col * live).to(torch.int32).contiguous()
    feats, inv = torch.unique(col[live], return_inverse=True)
    slot = torch.full((B, L), feats.numel(), dtype=torch.int32,
                      device=col.device)
    slot[live] = inv.to(torch.int32)
    order = torch.nonzero(live.reshape(-1)).reshape(-1)[
        torch.sort(inv, stable=True).indices]
    offs = torch.zeros(feats.numel() + 1, dtype=torch.int64,
                       device=col.device)
    offs[1:] = torch.cumsum(torch.bincount(inv, minlength=feats.numel()), 0)
    return GLMBlock(torch.arange(B, dtype=torch.int32, device=col.device),
                    col, (val * live).float().contiguous(),
                    nnz.to(torch.int32), feats.to(torch.int32), slot,
                    order.to(torch.int32), offs.to(torch.int32))


def _synthetic_block(gen, device, B, L, n_feat):
    """A GLM block of B full rows of L entries at uniform columns over
    ``n_feat`` features, N(0, 1) values."""
    import torch
    return _glm_block(
        torch.randint(0, n_feat, (B, L), generator=gen, device=device),
        torch.randn((B, L), generator=gen, device=device),
        torch.full((B,), L, device=device))


#: the kernel checks' hyperparameters: FTRL (lr, decay, l1, l2), FM
#: (lr_w, lr_v, lambda_w, lambda_v, binomial, intercept)
FTRL_PARAMS = (0.1, 0.5, 0.7, 0.3)
FM_PARAMS = (0.2, 0.2, 0.01, 0.02, 1, True)


def _glm_state(gen, device, n_feat, r=None):
    """Random FTRL (z, n) or FM (w0, acc_w0, w, v, acc_w, acc_v) state of
    n_feat + 1 rows."""
    import torch
    F1 = n_feat + 1
    kw = dict(generator=gen, device=device)
    if r is None:
        return (torch.randn((F1,), **kw),
                torch.rand((F1,), **kw) * 4)
    return (torch.full((), 0.1, device=device),
            torch.full((), 1.5, device=device),
            torch.randn((F1,), **kw) * 0.1,
            torch.randn((F1, r), **kw) * 0.1,
            1 + torch.rand((F1,), **kw),
            1 + torch.rand((F1, r), **kw))


def rankmf_bound(bits, pos, uf, itf, counters, r, tb=4):
    """Bound of K9 on one batch (tables of ``tb`` bytes a value: 4, or 2 at
    bf16): bytes of the uint32 bits (4 each), of
    each sample's three CSR reads (12), of one hash bucket row and one H
    row per candidate tried, and of one read and one write of the
    embedding row and the accumulator of each distinct user feature and
    positive-item feature the batch updates.  The chosen negatives' writes
    are left out, which outweighs the few candidates tried twice: a lower
    bound.  Operations 2r per score of the positive and each tried
    candidate and ~12r per sample for the updates."""
    import torch
    S, K2 = bits.shape
    b = bits & 0xFFFFFFFF
    n_user = pos.row_nnz.shape[0]
    u = b[:, 0] % n_user
    nnz_u = pos.row_nnz[u].long()
    p = (pos.indptr[u].long() + b[:, 1] % nnz_u.clamp(min=1)).clamp(
        0, pos.flat_idx.shape[0] - 1)
    i = pos.flat_idx[p].long()

    def rows(feats, ids):
        if feats is None:
            return int(torch.unique(ids).numel())
        return int(torch.unique(feats.idx[ids][feats.mask[ids]]).numel())
    tried = int(counters[3])
    nbytes = (S * K2 * 4 + S * 12 + tried * (pos.table.shape[1] * 4 + r * tb)
              + (rows(uf, u) + rows(itf, i)) * (2 * tb * r + 2 * tb))
    return bound(nbytes, 2 * r * (S + tried) + 12 * r * S)


def check_rankmf_batch(tables, bits, pos, uf, itf, hp, cfg, n_item, tag,
                       results, rep=False, reps=5):
    """K9 against its plain version on one batch from the same tables and
    bits: counters exactly, W, H, accW, accH by their change (rows either
    version changed).  The scores must be exact in float32 for the two to
    take the same decisions (first acceptable candidate, AUC): callers pass
    tables on a grid that makes every score exact in any summation order."""
    import torch
    from rsparse_tpu_torch.models import rankmf
    tk = [t.clone() for t in tables]
    tp = [t.clone() for t in tables]
    ck = rankmf._rankmf_batch(*tk, bits, pos, uf, itf, hp, cfg, n_item)
    cp = rankmf._rankmf_batch_plain(*tp, bits, pos, uf, itf, hp, cfg, n_item)
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(t).all()) for t in tk),
            f"K9 {tag}: non-finite output")
    require(torch.equal(ck, cp), f"K9 {tag}: counters {ck.tolist()} != plain"
            f" {cp.tolist()}")
    errs = {}
    for name, a, b, t0 in zip(("W", "H", "accW", "accH"), tk, tp, tables):
        ch = (a != t0) | (b != t0)
        ch = ch.any(1) if ch.dim() == 2 else ch
        errs[name] = _delta_err(a, b, t0, ch)
    text = _hold("rankmf", tag, errs, results)
    ms = time_ms(lambda: rankmf._rankmf_batch(*tk, bits, pos, uf, itf, hp,
                                              cfg, n_item), reps)
    pms = time_ms(lambda: rankmf._rankmf_batch_plain(
        *tp, bits, pos, uf, itf, hp, cfg, n_item), reps)
    bms, bby = rankmf_bound(bits, pos, uf, itf, cp, tables[0].shape[1])
    auc_n, auc_d, found, tried = cp.tolist()
    S = bits.shape[0]
    log(f"  K9 rankmf   {tag} counters auc {auc_n}/{auc_d} found {found} "
        f"tried {tried} of S={S} (equal) {text} kernel={ms:.3f} ms "
        f"plain={pms:.3f} ms bound={bms:.4f} ms ({bby})")
    check_rankmf_rowmap(tables, bits, pos, uf, itf, hp, cfg, n_item, tag,
                        results, ms, (bms, bby) if rep else None, reps)
    if rep:
        results["rankmf"].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                 bound_by=bby, library_ms=None, shape=tag)
        ams, dms, rms = k9_device_ms(tables, bits, pos, uf, itf, hp, cfg,
                                     n_item)
        log(f"  K9 device time of one batch (CUDA graphs, less the tables' "
            f"restore {rms:.4f} ms): {dms:.4f} ms = launch A {ams:.4f} ms + "
            f"launch B {dms - ams:.4f} ms; window {rankmf.K9_WINDOW}; mean "
            f"tried per sample {tried / S:.3f}; the wrapper call's "
            f"{ms:.3f} ms is host time")
        require(0 < ams < dms, f"K9 {tag}: launch A {ams:.4f} ms and the "
                f"batch {dms:.4f} ms were not measured apart")
        results["rankmf"]["device_ms"] = dms
    del tk, tp
    return tried


def check_rankmf_rowmap(tables, bits, pos, uf, itf, hp, cfg, n_item, tag,
                        results, one_ms, rep=None, reps=5):
    """K9's row-map mode (a mesh batch, models/rankmf.py ``_mesh_batch``)
    against its plain version on the same batch: the compact tables of the
    rows the bits reach (``batch_rows``), the maps, counters exactly and
    each compact table by its change (1e-5, as the one-process mode); its
    time beside the one-process mode's ``one_ms`` on the same batch.
    ``rep`` = (bound ms, bound by) records the row for the kernels line."""
    import torch
    from rsparse_tpu_torch.models import rankmf
    rows_w, rows_h = rankmf.batch_rows(bits, pos, uf, itf, n_item)
    maps = []
    for rows, n in ((rows_w, tables[0].shape[0]),
                    (rows_h, tables[1].shape[0])):
        m = torch.full((n,), -1, dtype=torch.int32, device=bits.device)
        m[rows] = torch.arange(rows.shape[0], dtype=torch.int32,
                               device=bits.device)
        maps.append(m)
    # tables are (W, H, accW, accH): rows_w, rows_h, rows_w, rows_h
    comp = [t[r].clone() for t, r in zip(tables, (rows_w, rows_h) * 2)]
    ck = [t.clone() for t in comp]
    cp = [t.clone() for t in comp]
    kw = dict(wmap=maps[0], hmap=maps[1])
    a = rankmf._rankmf_batch(*ck, bits, pos, uf, itf, hp, cfg, n_item, **kw)
    b = rankmf._rankmf_batch_plain(*cp, bits, pos, uf, itf, hp, cfg, n_item,
                                   **kw)
    torch.cuda.synchronize()
    require(torch.equal(a, b), f"K9 row map {tag}: counters {a.tolist()} "
            f"!= plain {b.tolist()}")
    errs = {}
    for name, x, y, t0 in zip(("W", "H", "accW", "accH"), ck, cp, comp):
        ch = (x != t0) | (y != t0)
        ch = ch.any(1) if ch.dim() == 2 else ch
        errs[name] = _delta_err(x, y, t0, ch)
    text = _hold("rankmf_rowmap", tag, errs, results)
    line = (f"  K9 row map  {tag} ({rows_w.shape[0]:,} W rows, "
            f"{rows_h.shape[0]:,} H rows) counters equal {text}")
    if rep is not None:
        ms = time_ms(lambda: rankmf._rankmf_batch(
            *ck, bits, pos, uf, itf, hp, cfg, n_item, **kw), reps)
        pms = time_ms(lambda: rankmf._rankmf_batch_plain(
            *cp, bits, pos, uf, itf, hp, cfg, n_item, **kw), reps)
        results["rankmf_rowmap"].update(
            ms=ms, plain_ms=pms, bound_ms=rep[0], bound_by=rep[1],
            library_ms=None, shape=tag, one_process_ms=one_ms)
        line += (f" kernel={ms:.3f} ms (one-process mode {one_ms:.3f} ms "
                 f"on the same batch) plain={pms:.3f} ms")
    log(line)


def k9_device_ms(tables, bits, pos, uf, itf, hp, cfg, n_item, reps=50):
    """K9's device time on one batch, free of the wrapper's host time, by
    CUDA graphs replayed ``reps`` times (CUDA events): (restore the tables
    from ``tables``, launch A alone) and (restore, the whole batch), each
    less a graph of the restore alone.  Returns (launch A ms, batch ms,
    restore ms); the batch less launch A is launch B (and A2 for
    RMSprop)."""
    import torch
    from rsparse_tpu_torch.models import rankmf
    work = [t.clone() for t in tables]

    def restore():
        for w, t in zip(work, tables):
            w.copy_(t)

    def step(stages):
        restore()
        rankmf._rankmf_batch_cuda(*work, bits, pos, uf, itf, hp, cfg, n_item,
                                  stages=stages)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for st in (1, 2, 1, 2):
            step(st)
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for fn in (restore, lambda: step(1), lambda: step(2)):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        graphs.append(g)
    t_restore, t_a, t_batch = (time_ms(g.replay, reps) for g in graphs)
    return t_a - t_restore, t_batch - t_restore, t_restore


def _grid(t, step=2.0 ** -6):
    """``t`` rounded to multiples of ``step``: rank-r dot products of such
    values, and differences of two of them, are exact in float32 while
    r (max |t| / step)^2 <= 2^23."""
    return (t / step).round() * step


def _exact_step(t, r):
    """The finest power of two that ``_grid`` may round ``t`` to for
    rank-r scores of two such tables to stay exact."""
    top = max(float(t.abs().max()), 2.0 ** -100)
    return 2.0 ** math.ceil(math.log2(top * math.sqrt(r) / 2.0 ** 11.5))


def check_sgd_kernels(device, results) -> None:
    """Phase 7 (a): K7, K8 and K9 against their plain versions on
    synthetic inputs at the main paths' shapes."""
    import torch
    from rsparse_tpu_torch.models import rankmf
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    B, L = GLM_BLOCK
    for n_feat in (10_000, HASHED_FEATURES):
        blk = _synthetic_block(gen, device, B, L, n_feat)
        y = (torch.rand((B,), generator=gen, device=device) < 0.5).float()
        w = torch.rand((B,), generator=gen, device=device) + 0.5
        tag = f"B={B} L={L} F={n_feat}"
        check_glm_block("ftrl", blk, _glm_state(gen, device, n_feat), y, w,
                        FTRL_PARAMS + (0.0, None, 1), tag, results,
                        rep=n_feat == HASHED_FEATURES)
        keep = torch.rand((B, L), generator=gen, device=device) > 0.3
        check_glm_block("ftrl", blk, _glm_state(gen, device, n_feat), y, w,
                        FTRL_PARAMS + (0.3, keep, 1), tag + " dropout 0.3",
                        results)
        for r in (4, 8):
            state = _glm_state(gen, device, n_feat, r)
            check_glm_block("fm", blk, state, y * 2 - 1, w, FM_PARAMS,
                            f"{tag} r={r}", results,
                            rep=(n_feat, r) == (HASHED_FEATURES, 8))
        if n_feat == HASHED_FEATURES:
            # a feature in every row (a bias column): 32,768 entries of one
            # feature, split over every tile of K7's and K8's walks
            col = blk.col_idx.long().clone()
            col[:, 0] = 0
            bias = _glm_block(col, blk.values, blk.nnz)
            check_glm_block("ftrl", bias, _glm_state(gen, device, n_feat), y,
                            w, FTRL_PARAMS + (0.0, None, 1),
                            f"{tag}, feature 0 in every row", results,
                            twin=True)
            state = _glm_state(gen, device, n_feat, 8)
            check_glm_block("fm", bias, state, y * 2 - 1, w, FM_PARAMS,
                            f"{tag} r=8, feature 0 in every row", results,
                            twin=True)
            del col
    # config #5's one-hot FM block: rows (user, n_users + item) of 2 entries
    # of value 1, so L = 8 and B = 2^20 / 8
    n_users, n_items = CONFIG5["n_users"], CONFIG5["n_items"]
    B1, L1 = (1 << 20) // 8, 8
    col = torch.zeros((B1, L1), dtype=torch.int64, device=device)
    col[:, 0] = torch.randint(0, n_users, (B1,), generator=gen, device=device)
    col[:, 1] = n_users + torch.randint(0, n_items, (B1,), generator=gen,
                                        device=device)
    blk = _glm_block(col, torch.ones((B1, L1), device=device),
                     torch.full((B1,), 2, device=device))
    y = (torch.rand((B1,), generator=gen, device=device) < 1 / 3).float()
    state = _glm_state(gen, device, n_users + n_items, 4)
    tag = f"config #5 one-hot B={B1} L={L1} r=4"
    check_glm_block("fm", blk, state, y * 2 - 1,
                    torch.ones((B1,), device=device), FM_PARAMS, tag, results)
    del blk, col, state
    torch.cuda.empty_cache()

    # K9: S = 8192, K = 20 over 200,000 users x 131,072 items, 5 positives
    x, _, _ = synth_config5(**dict(CONFIG5, n_users=K9_USERS, fm_rows=0),
                            seed=1)
    pos = rankmf._stage_positives(x, device)
    n_user, n_item = x.shape
    uf_m = _side_features(n_user, 4096, 11)
    if_m = _side_features(n_item, 2048, 12)
    feats = {"identity": (None, None),
             "side": (rankmf._pad_features(uf_m, torch.float32, device),
                      rankmf._pad_features(if_m, torch.float32, device))}
    S, K = K9_BATCH
    hp = rankmf.BatchParams(lr=0.5, gamma=0.9, lam_u=0.01, lam_ip=0.01,
                            lam_in=0.01, margin=0.1)
    # every instantiation of launch A: the candidates side by side at r <=
    # 8, 16 and 32, one after another at r > 32 (up to MAX_RANK = 128)
    cases = [(r, loss, opt, fk, rankmf.IDENTITY)
             for r in (8, 16, 32, 64, 128) for loss in (rankmf.BPR, rankmf.WARP)
             for opt in (rankmf.ADAGRAD, rankmf.RMSPROP)
             for fk in ("identity", "side")]
    cases.append((8, rankmf.WARP, rankmf.ADAGRAD, "identity",
                  rankmf.SIGMOID))
    for r, loss, opt, fk, kern in cases:
        uf, itf = feats[fk]
        nuf = n_user if uf is None else uf_m.shape[1]
        nif = n_item if itf is None else if_m.shape[1]
        # a sum of up to 3 side features stays on the grid; past r = 32 a
        # smaller scale keeps r (max / step)^2 <= 2^23 (_grid)
        sc = 0.25 if r <= 32 else 0.125
        tables = (_grid(torch.randn((nuf, r), generator=gen, device=device)
                        * sc),
                  _grid(torch.randn((nif, r), generator=gen, device=device)
                        * sc),
                  1 + torch.rand((nuf,), generator=gen, device=device),
                  1 + torch.rand((nif,), generator=gen, device=device))
        bits = torch.randint(0, 1 << 32, (S, K + 2), generator=gen,
                             device=device, dtype=torch.int64)
        cfg = rankmf.BatchConfig(S, K, loss, kern, opt, True)
        tag = (f"S={S} K={K} r={r} {('bpr', 'warp')[loss]} "
               f"{('adagrad', 'rmsprop')[opt]} {fk} features"
               + (" sigmoid" if kern == rankmf.SIGMOID else ""))
        check_rankmf_batch(tables, bits, pos, uf, itf, hp, cfg, n_item, tag,
                           results, rep=(r, loss, opt, fk, kern) == (
                               8, rankmf.WARP, rankmf.ADAGRAD, "identity",
                               rankmf.IDENTITY))


def by_float64_twin(name, blk, state, sk, sp_, y, w, params, tag,
                    errs) -> None:
    """K7 or K8 on a feature in every row: that feature's sums run over
    32,768 entries, added in two float32 orders (the plain version's
    index_add_, the kernel's tiles), so a table ``errs`` holds off its
    plain version by more than _hold's limit is held apart on the features
    whose entries run over more than one tile of the kernel's walk (K7_TILE
    or K8_TILE; and on K8's w0 and acc_w0, sums over the whole block): no
    further from the plain version run at float64 than twice the float32
    plain version (max norm over those features).  Every other feature of
    the block stays held at _hold's limit, and its distance is what
    ``errs`` then holds for the table."""
    import importlib
    from rsparse_tpu_torch.ops.segsum import GLMBlock
    mod = importlib.import_module(f"rsparse_tpu_torch.models.{name}")
    label, names = GLM_KERNELS[name]
    label = label.split()[0]
    tile = mod.K7_TILE if name == "ftrl" else mod.K8_TILE
    bad = [tn for tn, (rel, _, ulps) in errs.items()
           if tn in names and not (rel <= 1e-5 or ulps <= 2.0)]
    if not bad:
        return
    feats = blk.feats.long()
    wide = (blk.offs[1:] - blk.offs[:-1]) > tile
    f64 = GLMBlock(*(t.double() if t.is_floating_point() else t
                     for t in blk))
    s64 = [t.double() for t in state]
    getattr(mod, f"_{name}_block_plain")(*s64, f64, y.double(), w.double(),
                                         *params, True)
    for tn in bad:
        i = names.index(tn)
        rows = feats[wide] if state[i].dim() else None
        sel = (lambda t: t[rows]) if state[i].dim() else (lambda t: t)
        fk = float((sel(sk[i]).double() - sel(s64[i])).abs().max())
        fp = float((sel(sp_[i]).double() - sel(s64[i])).abs().max())
        log(f"    {label} {tag}: {tn} {errs[tn][0]:.2e} of its change off "
            f"the plain version; from float64 on "
            + (f"the features over a tile ({int(wide.sum())})"
               if state[i].dim() else "the block")
            + f": kernel {fk:.3e}, plain {fp:.3e}")
        require(fk <= 2 * fp, f"{label} {tag}: {tn} off the plain version "
                f"by {errs[tn][0]:.2e} of its change and further from "
                f"float64 ({fk:.3e}) than twice the plain version "
                f"({fp:.3e})")
        if state[i].dim():
            rest = _delta_err(sk[i], sp_[i], state[i], feats[~wide])
            errs[tn] = (rest[0], errs[tn][1], rest[2])
        else:
            errs[tn] = (0.0, errs[tn][1], 0.0)


def _side_features(n, n_feat, seed, max_k=3):
    """1 to ``max_k`` distinct features of value 1 per entity."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, max_k + 1, n)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n_feat, int(k.sum()))
    m = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n_feat))
    m.data[:] = 1.0                       # duplicates summed, then reset
    return m


def run_sgd_quality(device, launches) -> None:
    """Phase 7 (b): FTRL and FM on bench.py:396's synthetic within 0.01 of
    the reference's train accuracy; FM XOR; RankMF BPR on ML-100k beside
    the reference's AUC / NDCG@10, through predict (K3)."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    x, truth = synth_glm()
    models = {"ftrl": lambda: rt.FTRL(learning_rate=0.1, lambda_=1.0, seed=0,
                                      device=device),
              "fm": lambda: rt.FactorizationMachine(
                  rank=8, learning_rate_w=0.2, seed=0, device=device)}
    for name, make in models.items():
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = make()
        m.fit(x, truth, n_iter=3)
        p = m.predict(x)
        wall = time.perf_counter() - t0
        launches.append(check_launched(_kernels, f"{name} fit + predict, "
                                       "100,000 x 10,000", (name,)))
        acc = float(((p > 0.5) == truth).mean())
        log(f"  {name}: train accuracy {acc:.5f} (reference "
            f"{REF_GLM_ACC[name]:.5f} on the CPU) wall {wall:.3f} s")
        require(np.isfinite(p).all(), f"{name}: non-finite predictions")
        require(abs(acc - REF_GLM_ACC[name]) <= 0.01,
                f"{name}: train accuracy off the reference by more than 0.01")

    _kernels.reset_launch_counts()
    xor = sp.csr_matrix(np.array([[0, 0], [0, 1], [1, 0], [1, 1]], float))
    fm = rt.FactorizationMachine(learning_rate_w=0.2, rank=2, seed=42,
                                 device=device)
    fm.fit(sp.vstack([xor] * 200).tocsr(), np.tile([0.0, 1, 1, 0], 200),
           n_iter=80)
    p = fm.predict(xor)
    launches.append(check_launched(_kernels, "FM XOR", ("fm",)))
    log(f"  FM XOR predictions {np.round(p, 4).tolist()}")
    require(p[0] < 0.05 and p[3] < 0.05 and p[1] > 0.95 and p[2] > 0.95,
            "FM XOR: not learnt")

    ml = rt.load_movielens100k()
    train, test = rt.train_test_split(ml, 0.2, np.random.default_rng(0))
    tr = sp.csr_matrix(train)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.RankMF(rank=16, learning_rate=0.5, loss="bpr", seed=0,
                  batch_size=2048, device=device)
    emb = m.partial_fit_transform(tr, n_iter=200)
    preds = m.predict(tr, k=10, not_recommend=tr)
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "RankMF ML-100k + predict",
                                   ("rankmf", "topk")))
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    log(f"  RankMF BPR rank 16 ML-100k: AUC {m.auc_history[-1]:.4f} NDCG@10 "
        f"{ndcg:.4f} (reference on the CPU {REF_RANKMF_ML100K[0]:.4f} / "
        f"{REF_RANKMF_ML100K[1]:.4f}) {m.stage_info['batches']} batches, "
        f"wall {wall:.2f} s")
    require(bool(torch.isfinite(emb).all()), "RankMF ML-100k: non-finite")
    require(m.auc_history[-1] > 0.8 and ndcg > 0.15,
            "RankMF ML-100k: quality gate failed")
    check_predictions(preds.indices, 10, tr.shape[1], tr, "RankMF ML-100k")


def _glm_full_width(device, name, make, x, truth, results, launches, what,
                    passes=3):
    """One GLM model at full width: init, staging, a first pass and
    ``fit(n_iter=passes)`` (or, with passes=0, a second partial_fit) with
    their walls and rows/s, peak device memory, the launch count, and the
    kernel re-checked on the largest block with the fitted state."""
    import torch
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.sparse.device import clear_staging_cache
    clear_staging_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    n_rows = x.shape[0]
    m = make()
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    m._ensure_state(x.shape[1])
    sync()
    t1 = time.perf_counter()
    staged = m._stage(x, truth, None, True)
    sync()
    t2 = time.perf_counter()
    m._run_staged(staged, do_update=True, materialize=False)
    sync()
    t3 = time.perf_counter()
    if passes:
        m.fit(x, truth, n_iter=passes)
        label = f"fit(n_iter={passes})"
    else:
        m.partial_fit(x, truth)
        passes, label = 1, "second partial_fit"
    sync()
    t4 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches.append(check_launched(_kernels, what, (name,)))
    _, blocks, labels = staged
    log(f"  {what}: init {t1 - t0:.3f} s, staging {t2 - t1:.3f} s "
        f"({len(blocks)} blocks), first pass {t3 - t2:.3f} s = "
        f"{n_rows / (t3 - t2):.0f} rows/s, {label} {t4 - t3:.3f} s = "
        f"{passes * n_rows / (t4 - t3):.0f} rows/s; peak device memory "
        f"{peak:.2f} GiB")
    k = max(range(len(blocks)), key=lambda i: int(blocks[i].nnz.sum()))
    (y_b, w_b), blk = labels[k], blocks[k]
    tag = f"fitted, {what}, B={blk.col_idx.shape[0]} L={blk.col_idx.shape[1]}"
    if name == "ftrl":
        state = (m.z, m.n)
        params = (m.learning_rate, m.learning_rate_decay, m._l1, m._l2,
                  0.0, None, m.family_code)
    else:
        state = (m.w0, m.acc_w0, m.w, m.v, m.acc_w, m.acc_v)
        params = (m.learning_rate_w, m.learning_rate_v, m.lambda_w,
                  m.lambda_v, m.family_code, m.intercept)
    check_glm_block(name, blk, state, y_b, w_b, params, tag, results, reps=3)
    return m


def run_sgd_full_width(device, results, launches) -> None:
    """Phase 7 (c): FTRL and FM (rank 8) at the hashed shape of
    bench.py:760-765 (100,000 rows x 40,000,000 features x 32 nnz), then
    config #5 on one card (bench.py:327-393 without the mesh): RankMF WARP
    rank 8 on 10M users x 131,072 items, and FM rank 4 on 2M one-hot rows."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.models import rankmf
    from rsparse_tpu_torch.sparse.device import clear_staging_cache
    t0 = time.perf_counter()
    x, truth = synth_glm(n_feat=HASHED_FEATURES)
    log(f"  hashed synthetic: {x.shape[0]} x {x.shape[1]}, {x.nnz} nnz "
        f"({time.perf_counter() - t0:.2f} s)")
    _glm_full_width(device, "ftrl", lambda: rt.FTRL(
        learning_rate=0.1, lambda_=1.0, seed=0, device=device), x, truth,
        results, launches, "FTRL hashed")
    _glm_full_width(device, "fm", lambda: rt.FactorizationMachine(
        rank=8, learning_rate_w=0.2, seed=0, device=device), x, truth,
        results, launches, "FM rank 8 hashed")
    del x, truth

    t0 = time.perf_counter()
    x, fmx, fmy = synth_config5(**CONFIG5)
    log(f"  config #5 synthetic: {x.shape[0]} users x {x.shape[1]} items, "
        f"{x.nnz} nnz; FM {fmx.shape[0]} one-hot rows over {fmx.shape[1]} "
        f"features ({time.perf_counter() - t0:.2f} s)")
    clear_staging_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    m = rt.RankMF(rank=8, learning_rate=0.5, loss="warp", seed=0,
                  batch_size=K9_BATCH[0], max_negative_samples=K9_BATCH[1],
                  device=device)
    t0 = time.perf_counter()
    m.partial_fit_transform(x, n_iter=0)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    info0 = dict(m.stage_info)
    t0 = time.perf_counter()
    emb = m.partial_fit_transform(x, n_iter=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = m.stage_info
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches.append(check_launched(_kernels, "config #5 RankMF", ("rankmf",)))
    log(f"  config #5 RankMF WARP rank 8: first call {first:.3f} s (table "
        f"draw {info0['init_s']:.3f} s, staging with the hash build "
        f"{info0['staging_s']:.3f} s, {info0['batches']} batches); epoch "
        f"{wall:.3f} s for {info['updates']} updates ({info['batches']} "
        f"batches of {K9_BATCH[0]}) = {info['updates'] / wall:.0f} pairwise "
        f"updates/s ({x.shape[0] / wall:.0f} per user of the epoch); AUC~"
        f"{m.auc_history[-1]:.3f}; hash table "
        f"{tuple(m._positives.table.shape)}; peak device memory {peak:.2f} "
        "GiB")
    require(bool(torch.isfinite(emb).all()) and
            np.isfinite(m.components).all(), "config #5 RankMF: non-finite")
    mib32 = sum(t.numel() * t.element_size() for t in (
        m.user_features_embeddings, m.item_features_embeddings, m._accW,
        m._accH)) / 2**20
    f32_line = (f"{info['updates'] / wall:.0f} updates/s, tables "
                f"{mib32:.1f} MiB, AUC~{m.auc_history[-1]:.3f}")
    # K9 on one batch from the fitted tables, each rounded to the finest
    # power-of-two grid on which every score is exact, with the model's own
    # parameters.  Its scores are ~1e-5 against config #5's margin of 0.1,
    # so there WARP takes the first candidate that is not a positive; with
    # margin 0 it takes the first that outscores the positive, and its
    # loop runs over the fitted values.
    pos = m._positives
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    S, K = K9_BATCH
    bits = torch.randint(0, 1 << 32, (S, K + 2), generator=gen,
                         device=device, dtype=torch.int64)
    W, H = m.user_features_embeddings, m.item_features_embeddings
    sw, sh = _exact_step(W, m.rank), _exact_step(H, m.rank)
    tables = (_grid(W, sw), _grid(H, sh), m._accW, m._accH)
    hp = rankmf.BatchParams(m.learning_rate, m.gamma, m.lambda_user,
                            m.lambda_item_positive, m.lambda_item_negative,
                            m.margin)
    cfg = rankmf.BatchConfig(S, K, m.loss, m.kernel, m.optimizer, True)
    for margin in (m.margin, 0.0):
        tried = check_rankmf_batch(
            tables, bits, pos, None, None, hp._replace(margin=margin), cfg,
            x.shape[1], f"fitted config #5 (W, H on grids 2^{math.log2(sw):.0f}"
            f", 2^{math.log2(sh):.0f}) margin {margin}", results, reps=3)
    require(tried > S, "config #5 K9 check: WARP's loop did not run")
    # the candidates the fitted model tries per sample, over 8 batches
    tk = [t.clone() for t in (W, H, m._accW, m._accH)]
    c = sum(rankmf._rankmf_batch(
        *tk, torch.randint(0, 1 << 32, (S, K + 2), generator=gen,
                           device=device, dtype=torch.int64),
        pos, None, None, hp, cfg, x.shape[1]) for _ in range(8)).tolist()
    log(f"  config #5 fitted state: mean tried per sample {c[3] / (8 * S):.3f}"
        f" (found {c[2] / (8 * S):.3f} of samples)")
    del tk
    del m, emb, W, H, tables, pos
    run_rankmf_bf16_full(device, x, f32_line, results, launches)
    del x
    _glm_full_width(device, "fm", lambda: rt.FactorizationMachine(
        rank=4, learning_rate_w=0.2, seed=0, device=device), fmx, fmy,
        results, launches, "config #5 FM rank 4", passes=0)


# -- phase 8: GloVe (K10, K11) ------------------------------------------------

#: config #4 (bench.py:194-264) and the reference benchmark's quick shape
#: of it (bench.py:618): vocabulary, draws
CONFIG4 = dict(vocab=50_000, nnz=8_000_000)
GLOVE_QUICK = dict(vocab=20_000, nnz=2_000_000)
#: GloVe's n_hot="auto" on a square, not triangular input: sqrt(2^29)
GLOVE_AUTO_HOT = 23_170
#: the GloVe of phase 8: config #4's (bench.py:215-248, with the model's own
#: initialisation), on every input (at rank 128 the x_max = 10 and learning
#: rate 0.1 of tests/test_sgd_models.py:16 trip the reference's "cost is
#: too big" guard on ML-100k)
GLOVE_KW = dict(rank=128, x_max=100.0, learning_rate=0.05, batch_size=65_536,
                compute_dtype="bfloat16", seed=0)
#: the JAX package's cost_history (float32 state, bf16 head, on the CPU) of
#: GloVe(**GLOVE_KW).fit_transform(x, n_iter=3) on ML-100k and on the quick
#: shape, each held to GLOVE_REL per epoch; made by
#:   JAX_PLATFORMS=cpu python3 -c "import chip_smoke as c, rsparse_tpu as r
#:   for x in (c.ml100k_cooccurrence(r.load_movielens100k()),
#:             c.synth_glove(**c.GLOVE_QUICK)):
#:       m = r.GloVe(**c.GLOVE_KW); m.fit_transform(x, n_iter=3)
#:       print(m.cost_history)"
#: (tests/test_torch_glove.py test_reference_cost_history recomputes the
#: ML-100k one)
REF_GLOVE = {"ml100k": (0.45488280793498687, 0.07597071868772529,
                        0.03505667713915087),
             "quick": (0.4630190852547191, 0.14129658496505335,
                       0.07906985425764775)}
GLOVE_REL = 1e-3
#: the same as REF_GLOVE["ml100k"] at GloVe's default compute dtype (the
#: state's, float32: K11's f32 head), from the same command with
#: compute_dtype left out of GLOVE_KW (GLOVE_F32_KW); held to GLOVE_REL
#: (tests/test_torch_k11_f32_walk.py test_reference_cost_history_f32
#: recomputes it)
GLOVE_F32_KW = {k: v for k, v in GLOVE_KW.items() if k != "compute_dtype"}
REF_GLOVE_F32 = (0.4548168812058774, 0.07594763162989167,
                 0.03504821400171943)


def synth_glove(vocab, nnz, seed=0):
    """The reference benchmark's text8-scale co-occurrence (bench.py:194-206):
    ``nnz`` (i, j) draws from a zipf-like popularity 1 / (rank + 5), counts
    1 + Exp(5), duplicates summed."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / (np.arange(vocab) + 5.0)
    pop /= pop.sum()
    i = rng.choice(vocab, nnz, p=pop)
    j = rng.choice(vocab, nnz, p=pop)
    v = 1.0 + rng.exponential(5.0, nnz)
    tcm = sp.coo_matrix((v, (i, j)), shape=(vocab, vocab))
    tcm.sum_duplicates()
    return tcm


def ml100k_cooccurrence(ml):
    """crossprod(sign(x)) of MovieLens-100k (tests/test_sgd_models.py:13)."""
    s = sp.csr_matrix(ml).sign()
    return (s.T @ s).tocoo()


def glove_bound(nbytes, prod_flops, elem_flops, bf16):
    """Like :func:`bound`, with the products' operations at the bf16
    tensor-core peak when their operands are bf16."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = (prod_flops / (BF16_FLOPS if bf16 else F32_FLOPS)
          + elem_flops / F32_FLOPS) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k10_bound(sh, r, tb=4):
    """Bound of K10 on one shard (values of ``tb`` bytes: 4, or 2 at bf16
    state): bytes of each valid entry (two ids and a count, 8 + tb) and one
    read and one write of the four table rows (w, acc_w: r values; b,
    acc_b: one) of each distinct id of each side, 4 tb (r + 1);
    operations ~10 r + 30 an entry (the dot product, g and g² on both
    sides, weight, log, clip) and 6 a component in the apply.  The slot
    maps are the port's own layout and are not counted."""
    n = int((sh.slot_r < sh.feats_r.shape[0]).sum())
    U = sh.feats_r.shape[0] + sh.feats_c.shape[0]
    return glove_bound(n * (8 + tb) + U * 4 * tb * (r + 1), 0,
                       n * (10 * r + 30) + U * 6 * (r + 1), False)


def k11_bound(n_r, n_c, r, grid_bytes, bf16, present, tb=4):
    """Bound of K11 on one tile: bytes of the counts, the ids and one read
    and one write of each row's and column's four table rows; operations
    of what the ``present`` cells need (the cost is zero at every other
    cell): S and the four products, 10 r a present cell (at the bf16 peak
    for a bf16 head), and ~20 for the log, weight, clip and roundings.
    (K11's f32 head and its bf16-state head walk only the present cells,
    on the FMA units; the bf16 head over float32 state computes the
    products densely, 12 n_r n_c r on the tensor cores.)"""
    cells = n_r * n_c
    return glove_bound(cells * grid_bytes
                       + (n_r + n_c) * (4 + 4 * tb * (r + 1)),
                       10 * present * r, 20 * present, bf16)


def k11_sides_apart(st, rows, cols, xv, hp) -> str:
    """The bf16 value of clip(S + b_i + b_j - log x) that K11's two sides
    formed at the present cells of a bf16 tile (the row side's [i, j], the
    column side's [j, i]): how many cells the sides round apart, and how
    many round apart from the same value formed with float64 sums, beside
    the float32 plain version's count."""
    import torch
    from rsparse_tpu_torch.config import to_bf16
    from rsparse_tpu_torch.models import glove
    n_r, n_c = rows.numel(), cols.numel()
    s2 = torch.zeros((2, n_r, n_c), dtype=torch.float32, device=xv.device)
    glove._glove_tile_cuda(st, rows, cols, xv, *hp, torch.bfloat16,
                           s_dump=s2)
    i, j = rows.long(), cols.long()
    present = xv.float() > 0

    def sv_bf16(S, dt):
        x = xv.to(dt)
        lx = torch.log(torch.where(present, x, 1.0))
        return to_bf16(torch.clamp(S.to(dt) + st.b_i[i][:, None].to(dt)
                                   + st.b_j[j][None, :].to(dt) - lx, -100.0,
                                   100.0))

    wi, wj = (t.to(torch.bfloat16).double() for t in (st.w_i[i], st.w_j[j]))
    ref = sv_bf16(wi @ wj.T, torch.float64)
    s32 = wi.float() @ wj.float().T
    plain = sv_bf16(s32, torch.float32)
    sides = [s2[k].to(torch.bfloat16) for k in (0, 1)]
    n = lambda a, b: int(((a != b) & present).sum())  # noqa: E731
    near = k11_flagged(st, rows, cols, xv)
    return (f"bf16 clip(S + b - log x): {n(sides[0], sides[1])} present "
            f"cells apart between the two sides; apart from float64 sums: "
            f"row side {n(sides[0], ref)}, column side {n(sides[1], ref)}, "
            f"float32 plain {n(plain, ref)}; of {int(present.sum())} "
            f"present, ~{near} summed again exactly")


def k11_flagged(st, rows, cols, x) -> int:
    """The present cells of a bf16 tile that K11 sums again exactly, a
    side, estimated from the float32 plain S: those whose float32 clip(S +
    b_i + b_j - log x) lies within the kernel's error bound of a bf16
    rounding midpoint (csrc/glove_dense.cu near_midpoint: 2^-21 x 8 slices
    x |w_i| |w_j| at r <= 128; at 320 also near_midpoint_slices, 2^-19 x
    the sum over the k16 slices of the slices' norms)."""
    import torch
    from rsparse_tpu_torch.models import glove
    i, j = rows.long(), cols.long()
    r = st.w_i.shape[1]
    wi, wj = (t.to(torch.bfloat16).float() for t in (st.w_i[i], st.w_j[j]))
    s32 = wi @ wj.T
    present = x.float() > 0
    lx = torch.log(torch.where(present, x.float(), 1.0))
    b_r, b_c = st.b_i[i][:, None], st.b_j[j][None, :]
    sv = torch.clamp(s32 + b_r + b_c - lx, -100.0, 100.0)
    rest = (2.0 ** -22 * (s32.abs() + b_r.abs() + b_c.abs() + lx.abs())
            + 2.0 ** -21 * (1.0 + lx.abs()))
    bits = sv.view(torch.int32)
    ulp = torch.pow(2.0, ((bits >> 23) & 0xFF).float() - 150.0)
    dist = ((bits & 0xFFFF) - 0x8000).abs().float() * ulp
    wide = r > glove.GLOVE_WIDTHS[0]
    slices = -(-r // 16) if wide else 8
    near = present & (dist <= 2.0 ** -21 * slices * wi.norm(dim=1)[:, None]
                      * wj.norm(dim=1)[None, :] + rest)
    if wide:
        pad = lambda t: torch.nn.functional.pad(  # noqa: E731
            t, (0, 16 * slices - r)).view(t.shape[0], slices, 16).norm(dim=2)
        sigma = pad(wi) @ pad(wj).T
        near &= dist <= 2.0 ** -19 * sigma + rest
    return int(near.sum())


def _tile_cublas(st, rows, cols, x, x_max, alpha, lr):
    """K11's step as a chain of PyTorch calls with bf16 operands: the five
    products through cuBLAS on the tensor cores (bf16 outputs, so it rounds
    where K11 does not), the elementwise work and the applies.  Timed as
    the library column's yardstick only."""
    import torch
    from rsparse_tpu_torch.models import glove
    bf = torch.bfloat16
    i, j = rows.long(), cols.long()
    xf = x.float()
    present = xf > 0
    lx = torch.log(torch.where(present, xf, 1.0))
    w = torch.where(present, torch.where(
        xf < x_max, torch.pow(xf / x_max, alpha), 1.0), 0.0)
    wi, wj = st.w_i[i].to(bf), st.w_j[j].to(bf)
    s = torch.clamp((wi @ wj.T).float() + st.b_i[i][:, None]
                    + st.b_j[j][None, :] - lx, -100.0, 100.0)
    cost = w.to(bf) * s.to(bf)
    c2 = cost * cost
    glove._adagrad_apply(st.w_i, st.b_i, st.acc_w_i, st.acc_b_i, i,
                         (cost @ wj).float(), (c2 @ (wj * wj)).float(),
                         cost.float().sum(1), c2.float().sum(1), lr)
    glove._adagrad_apply(st.w_j, st.b_j, st.acc_w_j, st.acc_b_j, j,
                         (cost.T @ wi).float(), (c2.T @ (wi * wi)).float(),
                         cost.float().sum(0), c2.float().sum(0), lr)
    return (cost.float() * s).sum()


def _tile_cublas_f32(st, rows, cols, x, x_max, alpha, lr):
    """K11's f32-head step as a chain of PyTorch calls: the five products
    through cuBLAS at the port's full-f32 matmul setting (no TF32), the
    elementwise work over the whole grid and the applies.  Timed as the
    library column's yardstick only."""
    import torch
    from rsparse_tpu_torch.models import glove
    i, j = rows.long(), cols.long()
    xf = x.float()
    present = xf > 0
    lx = torch.log(torch.where(present, xf, 1.0))
    w = torch.where(present, torch.where(
        xf < x_max, torch.pow(xf / x_max, alpha), 1.0), 0.0)
    wi, wj = st.w_i[i], st.w_j[j]
    s = torch.clamp(wi @ wj.T + st.b_i[i][:, None] + st.b_j[j][None, :]
                    - lx, -100.0, 100.0)
    cost = w * s
    c2 = cost * cost
    glove._adagrad_apply(st.w_i, st.b_i, st.acc_w_i, st.acc_b_i, i,
                         cost @ wj, c2 @ (wj * wj), cost.sum(1), c2.sum(1),
                         lr)
    glove._adagrad_apply(st.w_j, st.b_j, st.acc_w_j, st.acc_b_j, j,
                         cost.T @ wi, c2.T @ (wi * wi), cost.sum(0),
                         c2.sum(0), lr)
    return (cost * s).sum()


def _tile_s_bf16(st, rows, cols, x, acc):
    """bf16(S) of a tile's present cells, S summed at ``acc``: which cells
    of S an f32 sum can round to another bf16 value than float64 does."""
    import torch
    from rsparse_tpu_torch.config import to_bf16
    i, j = rows.long(), cols.long()
    xf = x.to(acc)
    rd = lambda t: to_bf16(t).to(acc)  # noqa: E731
    s = torch.clamp(rd(st.w_i[i]) @ rd(st.w_j[j]).T
                    + st.b_i[i][:, None].to(acc) + st.b_j[j][None, :].to(acc)
                    - torch.log(torch.where(xf > 0, xf, 1.0)), -100.0, 100.0)
    return torch.where(xf > 0, rd(s), 0.0)


def check_glove_step(name, step, plain, state, ids, tag, results, bnd,
                     lib=None, rep=False, reps=5, flops=0, key=None):
    """K10 (``name="glove"``) or K11 (``"glove_dense"``) against its plain
    version on the same state: ``step(st)`` and ``plain(st)`` update st in
    place and return the loss term.  Each table (and the loss) is held by
    its change to 1e-5, or to twice the plain version's distance from the
    plain version at float64 (bf16 cells of S that an f32 sum rounds the
    other way); tables outside ``ids`` (the row and the column side's ids)
    must not move.  K10 and the wide K11 run twice on the same state and
    must give the same tables and loss, bit for bit.  ``flops``: the
    kernel's own work, printed as a rate.
    ``key``: the kernel's row of the kernels line (``name``, or its wide
    route's)."""
    import torch
    from rsparse_tpu_torch.models import glove
    fields = glove.GloveState._fields
    sk = glove.GloveState(*(t.clone() for t in state))
    sp_ = glove.GloveState(*(t.clone() for t in state))
    s64 = glove.GloveState(*(t.double() for t in state))
    lk, lp, l64 = step(sk), plain(sp_), plain(s64)
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(t).all()) for t in (lk, *sk)),
            f"{name} {tag}: non-finite output")
    errs, worst = {}, 0.0
    zero = torch.zeros((), device=lk.device)
    for tname, a, b, c, t0 in zip(fields + ("loss",), (*sk, lk), (*sp_, lp),
                                  (*s64, l64), (*state, zero)):
        rows = None if tname == "loss" else ids[tname.endswith("_j")]
        rel, diff, _ = _delta_err(a, b, t0, rows)
        ek = float((a.double() - c)[rows].abs().max()) if rows is not None \
            else abs(float(a) - float(c))
        ep = float((b.double() - c)[rows].abs().max()) if rows is not None \
            else abs(float(b) - float(c))
        require(rel <= 1e-5 or ek <= 2 * ep, f"{name} {tag}: {tname} "
                f"disagrees with the plain version ({rel:.2e} of its change;"
                f" {ek:.2e} from float64 against the plain version's "
                f"{ep:.2e})")
        errs[tname] = f"{tname}_rel={rel:.2e}" + (
            f" (f64: {ek:.1e} vs {ep:.1e})" if rel > 1e-5 else "")
        worst = max(worst, diff)
        if rows is not None:
            out = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
            out[rows] = False
            require(torch.equal(a[out], t0[out]), f"{name} {tag}: {tname} "
                    "moved outside the step's ids")
    key = key or name
    results[key]["max_abs_err"] = max(results[key]["max_abs_err"], worst)
    dms = None
    if name == "glove" or key in ("glove_dense_wide", "glove_dense_f32",
                                  "glove_dense_wide_f32"):
        # K10, the wide K11 and the f32 head: the same result on every run
        s2 = glove.GloveState(*(t.clone() for t in state))
        l2 = step(s2)
        require(torch.equal(l2, lk) and all(
            torch.equal(a, b) for a, b in zip(s2, sk)),
            f"{name} {tag}: two launches on the same inputs differ")
        del s2
    if name == "glove":  # K10's device time
        dms = graph_ms([lambda: step(sk)], reps=20)
    ms = time_ms(lambda: step(sk), reps)
    if flops:
        bms_note = f" {flops / ms / 1e9:.1f} TFLOP/s (dense mma work)"
    else:
        bms_note = ""
    pms = time_ms(lambda: plain(sp_), reps)
    lms = time_ms(lambda: lib(sp_), reps) if lib is not None else None
    bms, bby = bnd
    log(f"  {name:11s} {tag} {' '.join(errs.values())} kernel={ms:.3f} ms "
        + (f"(device {dms:.4f} ms by CUDA graphs) " if dms else "")
        + f"plain={pms:.3f} ms"
        + (f" cuBLAS chain={lms:.3f} ms" if lms else "")
        + f" bound={bms:.4f} ms ({bby}){bms_note}")
    if rep:
        results[key].update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                            library_ms=lms, shape=tag,
                            **({"device_ms": dms} if dms else {}))


def check_glove_kernels(head, tail, state, tag, results, rep=False,
                        quick=False):
    """K10 on the tail's first shard, straight and swapped (the transposed
    pass's roles); K11 on the head's first tile, its last (the reference's
    padded edge tile, cut to its real positions) and the transposed pass's
    tile (1, 0), with the bf16 grid and with float32 counts.  ``quick``:
    the first shard and the first tile only.  At r > 128 the kernels are
    the wide routes (their own rows of the kernels line)."""
    import torch
    from rsparse_tpu_torch.models import glove
    hp = (GLOVE_KW["x_max"], 0.75, GLOVE_KW["learning_rate"])
    r = state.w_i.shape[1]
    sfx = "_wide" if r > glove.GLOVE_WIDTHS[0] else ""
    shards = (("shard 0", tail.shard(0)),) + (() if quick else (
        ("swapped shard 0", tail.swapped().shard(0)),))
    for label, sh in shards:
        ids = (sh.feats_r.long(), sh.feats_c.long())
        check_glove_step(
            "glove", lambda st: glove._glove_shard_cuda(st, sh, *hp),
            lambda st: glove._glove_shard_plain(st, sh, *hp), state, ids,
            f"{tag} {label}, N={sh.rows.shape[0]} U={ids[0].numel()}/"
            f"{ids[1].numel()}", results, k10_bound(sh, r),
            rep=rep and label == "shard 0", key="glove" + sfx)
    H, side, last = head.ids.shape[0], head.side, head.nt - 1
    span = lambda t: slice(t * side, min(H, (t + 1) * side))  # noqa: E731
    x32 = head.x.float()
    bf = torch.bfloat16
    tiles = (((0, 0), False),) + (() if quick else (
        ((last, last), False), ((1, 0), True)))
    for (ti, tj), trans in tiles:
        rows, cols = head.ids[span(ti)], head.ids[span(tj)]
        ids = (rows.long(), cols.long())
        for x, cdt in ((head.x, bf), (x32, torch.float32)):
            xv = (x.T if trans else x)[span(ti), span(tj)]
            c64 = bf if cdt == bf else torch.float64
            s32 = _tile_s_bf16(state, rows, cols, xv, torch.float32)
            s64 = _tile_s_bf16(state, rows, cols, xv, torch.float64)
            apart = int((s32.double() != s64).sum())
            name = (f"{tag} tile ({ti}, {tj})" + (" transposed" if trans
                                                  else "")
                    + f" {rows.numel()} x {cols.numel()} "
                    + ("bf16" if cdt == bf else "f32")
                    + f" (bf16 S cells rounding apart f32/f64: {apart} of "
                    f"{int((xv > 0).sum())})")
            main = (ti, tj) == (0, 0) and not trans
            if cdt == bf:
                log("    " + k11_sides_apart(state, rows, cols, xv, hp))
            lib = _tile_cublas if cdt == bf else _tile_cublas_f32
            check_glove_step(
                "glove_dense",
                lambda st: glove._glove_tile_cuda(st, rows, cols, xv, *hp,
                                                  cdt),
                lambda st: glove._glove_tile_plain(
                    st, rows, cols, xv, *hp,
                    c64 if st.w_i.dtype == torch.float64 else cdt),
                state, ids, name, results,
                k11_bound(rows.numel(), cols.numel(), r, x.element_size(),
                          cdt == bf, int((xv > 0).sum())),
                lib=(lambda st: lib(st, rows, cols, xv, *hp))
                if main else None, rep=rep and main,
                flops=12 * rows.numel() * cols.numel() * r if cdt == bf
                else 0, key="glove_dense" + sfx + ("" if cdt == bf
                                                   else "_f32"))
    del x32
    torch.cuda.empty_cache()


def run_glove_f32_head(device, x4, launches, rank, bf16_rate) -> float:
    """Config #4 at GloVe's default compute dtype (float32 state, K11's f32
    head) through GloVe.fit_transform, 3 epochs, beside the bf16-head fit
    of the same run (``bf16_rate``: its triplets/s).  Returns its
    triplets/s."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.models import glove
    sfx = "_wide" if rank > glove.GLOVE_WIDTHS[0] else ""
    torch.cuda.empty_cache()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.GloVe(**dict(GLOVE_F32_KW, rank=rank), device=device)
    emb = m.fit_transform(x4, n_iter=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(
        _kernels, f"config #4 GloVe r={rank} f32 head",
        ("glove" + sfx, "glove_dense" + sfx + "_f32")))
    info, hist = m.stage_info, m.cost_history
    require(bool(torch.isfinite(emb).all()) and all(np.isfinite(hist))
            and hist[0] > hist[1] > hist[2],
            f"config #4 GloVe r={rank} f32 head: loss not finite and "
            "decreasing")
    best = min(info["epoch_s"])
    log(f"  config #4 GloVe rank {rank}, f32 head (default compute dtype): "
        f"fit_transform(n_iter=3) {wall:.3f} s, epochs "
        f"{[round(e, 4) for e in info['epoch_s']]} s; {x4.nnz / best:.0f} "
        f"triplets/s (best epoch; the bf16 head in this run: "
        f"{bf16_rate:.0f}); loss/nnz {[round(c, 6) for c in hist]}")
    del m, emb
    return x4.nnz / best


def run_glove(device, results, launches) -> None:
    """Phase 8: (a) K10 / K11 on config #4's staged shards and tiles from
    the model's initial state; (b) GloVe on ML-100k and on the quick shape
    held to the JAX package's cost history; (c) config #4 through
    GloVe.fit_transform with its stage walls, the head / tail split of an
    epoch, triplets/s, peak memory, and both kernels re-checked on the
    fitted state."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.models import glove
    t0 = time.perf_counter()
    x4 = synth_glove(**CONFIG4)
    n = x4.shape[0]
    log(f"  config #4 synthetic: vocabulary {n}, {x4.nnz} triplets "
        f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    hot, X, rem = glove._split_head(x4, GLOVE_AUTO_HOT, np.float32)
    head = glove._stage_head(X, hot, torch.bfloat16, GLOVE_KW["batch_size"],
                             device)
    del X
    tail = glove._stage_tail(rem, GLOVE_KW["batch_size"], torch.float32,
                             device)
    torch.cuda.synchronize()
    log(f"  staged: head H={head.ids.shape[0]} ({x4.nnz - rem.nnz} triplets, "
        f"{head.nt} x {head.nt} tiles of {head.side}), tail {rem.nnz} "
        f"triplets in {tail.rows.shape[0]} shards "
        f"({time.perf_counter() - t0:.2f} s)")
    state0 = rt.GloVe(**GLOVE_KW, device=device)._init_state(n)
    log("phase 8 (a): K10 / K11 against their plain versions (config #4)")
    check_glove_kernels(head, tail, state0, "config #4", results, rep=True)
    del state0

    log("phase 8 (b): GloVe on ML-100k and the quick shape against the JAX "
        "package's cost history")
    for what, make in (
            ("ml100k", lambda: ml100k_cooccurrence(rt.load_movielens100k())),
            ("quick", lambda: synth_glove(**GLOVE_QUICK))):
        x = make()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = rt.GloVe(**GLOVE_KW, device=device)
        emb = m.fit_transform(x, n_iter=3)
        wall = time.perf_counter() - t0
        info = m.stage_info
        names = (("glove_dense",) if info["tiles"] else ()) + (
            ("glove",) if info["shards"] else ())
        launches.append(check_launched(_kernels, f"GloVe {what}", names))
        ref = REF_GLOVE[what]
        rels = [abs(a / b - 1) for a, b in zip(m.cost_history, ref)]
        log(f"  GloVe {what}: {x.nnz} triplets, H={info['head_tokens']} "
            f"({info['tiles']} tiles), {info['shards']} shards; cost history "
            f"{[round(c, 6) for c in m.cost_history]} (JAX on the CPU "
            f"{[round(c, 6) for c in ref]}, largest relative distance "
            f"{max(rels):.2e}); wall {wall:.2f} s")
        require(bool(torch.isfinite(emb).all()), f"GloVe {what}: non-finite")
        require(len(rels) == 3 and max(rels) <= GLOVE_REL,
                f"GloVe {what}: cost history off the JAX package's by more "
                f"than {GLOVE_REL}")

    x = ml100k_cooccurrence(rt.load_movielens100k())
    _kernels.reset_launch_counts()
    m = rt.GloVe(**GLOVE_F32_KW, device=device)
    emb = m.fit_transform(x, n_iter=3)
    launches.append(check_launched(_kernels, "GloVe ml100k f32 head",
                                   ("glove_dense_f32",)))
    rels = [abs(a / b - 1) for a, b in zip(m.cost_history, REF_GLOVE_F32)]
    log(f"  GloVe ml100k, f32 head (the default compute dtype): cost history "
        f"{[round(c, 6) for c in m.cost_history]} (JAX on the CPU "
        f"{[round(c, 6) for c in REF_GLOVE_F32]}, largest relative distance "
        f"{max(rels):.2e})")
    require(bool(torch.isfinite(emb).all()) and len(rels) == 3
            and max(rels) <= GLOVE_REL,
            "GloVe ml100k f32 head: cost history off the JAX package's")

    log("phase 8 (b), bf16: GloVe and RankMF at precision='bfloat16' on "
        "ML-100k against the JAX package's (REF_BF16)")
    run_ml100k_bf16(device, launches)

    log("phase 8 (c): config #4 at full width through GloVe.fit_transform")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30  # (a)'s staged head, tail
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.GloVe(**GLOVE_KW, device=device)
    emb = m.fit_transform(x4, n_iter=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 - base
    launches.append(check_launched(_kernels, "config #4 GloVe",
                                   ("glove", "glove_dense")))
    info = m.stage_info
    hist = m.cost_history
    best = min(info["epoch_s"])
    log(f"  config #4 GloVe rank 128: fit_transform(n_iter=3) {wall:.3f} s = "
        f"split {info['split_s']:.3f} s + head staging {info['head_s']:.3f} "
        f"s + tail staging {info['tail_s']:.3f} s + epochs "
        f"{[round(e, 4) for e in info['epoch_s']]} s; "
        f"{x4.nnz / best:.0f} triplets/s (best epoch); loss/nnz "
        f"{[round(c, 6) for c in hist]}; peak device memory {peak:.2f} GiB "
        f"(above the {base:.2f} GiB that (a) holds)")
    require(bool(torch.isfinite(emb).all()) and all(np.isfinite(hist))
            and hist[0] > hist[1] > hist[2],
            "config #4 GloVe: loss not finite and decreasing")
    # one more epoch, timed by part, on a copy of the fitted state
    st = glove.GloveState(*(t.clone() for t in m._state))
    hp = (GLOVE_KW["x_max"], 0.75, GLOVE_KW["learning_rate"])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    glove._glove_dense_step(st, head, *hp, torch.bfloat16)
    ev[1].record()
    glove._glove_epoch(st, tail, *hp)
    ev[2].record()
    torch.cuda.synchronize()
    h_ms, t_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    log(f"  config #4 epoch by part (device time): head {h_ms:.2f} ms "
        f"({head.nt ** 2} tiles, {h_ms / head.nt ** 2:.3f} ms a tile), tail "
        f"{t_ms:.2f} ms ({tail.rows.shape[0]} shards, "
        f"{t_ms / tail.rows.shape[0]:.3f} ms a shard)")
    del st
    check_glove_kernels(head, tail, m._state, "fitted config #4", results)
    del head, tail, m, emb
    f32_rate = run_glove_f32_head(device, x4, launches, GLOVE_KW["rank"],
                                  x4.nnz / best)
    log("phase 8 (a, c), bf16: K10 / K11's bf16 instances on config #4 and "
        "config #4 at bf16 state")
    run_glove_bf16(device, x4, results, launches, GLOVE_KW["rank"], hist,
                   (x4.nnz / best, f32_rate))


# -- phase 9: reduced precision ------------------------------------------------

#: the JAX package's ML-100k quality at each reduced-precision setting of
#: WRMF (rsparse_tpu on the CPU, bench.py:440's gate setup: rank 10,
#: lambda 1, CG, seed 0, 80/20 split, n_iter=10, n_hot="auto"; held by
#: tests/test_torch_wrmf_lowp_ref.py):
#: setting -> (WRMF arguments, (NDCG@10, MAP@10))
REF_LOWP = {
    "compute_dtype=bfloat16": (dict(compute_dtype="bfloat16"),
                               (0.3469, 0.4120)),
    "hot_dtype=uint8": (dict(hot_dtype="uint8"), (0.3469, 0.4120)),
    "bfloat16 + uint8": (dict(compute_dtype="bfloat16", hot_dtype="uint8"),
                         (0.3469, 0.4121)),
    "precision=bfloat16": (dict(precision="bfloat16"), (0.3465, 0.4117)),
}
LOWP_QUALITY_TOL = 0.005

#: the kernel variants of phase 9 (a): (tag, table bf16, head storage,
#: compute_dtype); uint8 heads are implicit-only (the reference's rule)
LOWP_VARIANTS = (("bf16 table, bf16 head, bf16 compute", True, "bf16",
                  "bfloat16"),
                 ("bf16 table, f32 head, bf16 compute", True, "f32",
                  "bfloat16"),
                 ("bf16 table, uint8 head, bf16 compute", True, "uint8",
                  "bfloat16"),
                 ("f32 table, uint8 head, f32 compute", False, "uint8",
                  "float32"),
                 ("bf16 table, f32 head, f32 compute", True, "f32",
                  "float32"))


def _quantise_rows(W):
    """A dense head as split_hot_cold(w_dtype=uint8) stores it: codes
    clip(rint(w / s), 1, 255) where present, s = rowmax / 255."""
    import torch
    wmax = W.max(1).values
    s = torch.where(wmax > 0, wmax / 255.0, torch.ones_like(wmax))
    codes = torch.where(W > 0, torch.clamp(torch.round(W / s[:, None]), 1,
                                            255), torch.zeros_like(W))
    return codes.to(torch.uint8).contiguous(), s.contiguous()


def _lowp_case(args, table_bf16, head, compute):
    """Phase 2's bucket case at one precision variant: the table (and the
    head's rows) at bf16 where the model would hold them so, the head
    stored as bf16 or uint8 codes with their scales."""
    import torch
    from rsparse_tpu_torch.ops import als
    src, xb, XtX, rhs_init, b, x0, lam, g, cfg, W, Vh, hb, nt = args
    cfg = dataclasses.replace(cfg, compute_dtype=compute)
    scale = None
    if table_bf16:
        src = src.to(torch.bfloat16)
        if compute == "float32":
            # a precision="bfloat16" model: the Gram of its bf16 factors
            XtX = als._sweep_prepare(src, lam, g, cfg, torch.float32)[2]
        Vh = None if Vh is None else Vh.to(torch.bfloat16)
    if W is not None:
        if head == "bf16":
            W = W.to(torch.bfloat16)
        elif head == "uint8":
            W, scale = _quantise_rows(W)
    return (src, xb, XtX, rhs_init, b, x0, lam, g, cfg, W, Vh, hb, nt), scale


def check_lowp_kernels(device, results, base=None, seed=9) -> None:
    """K1, K2 and K4 on phase 2's synthetic cases, implicit and explicit
    (presence bits with stored zero ratings, source biases), at each
    variant of LOWP_VARIANTS that the case admits, against their plain
    versions (y 1e-4, K4 y 1e-3, bf16 cells that round apart by hold_bf16;
    the loss 1e-5 against the plain loss of the kernel's own y), with their
    times and bounds.  ``base`` (name, case) replaces phase 9's cases
    (phase 11 gives the wide widths)."""
    import torch
    from rsparse_tpu_torch.ops import als
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    chol, nnls = als.CHOLESKY, als.NNLS
    base = base or (("K1 als_cg", dict(B=2048, L=128, d=128, H=1024)),
            ("K1 als_cg", dict(B=2048, L=128, d=128, H=1024, ugb=True)),
            ("K1 als_cg", dict(B=2048, L=128, d=128, H=1024, explicit=True,
                               bits=True)),
            ("K1 als_cg", dict(B=2048, L=128, d=129, H=0, explicit=True,
                               biases=True)),
            ("K1 als_cg", dict(B=2048, L=128, d=128, H=1024, density=0.3)),
            ("K1 als_cg", dict(B=2048, L=128, d=128, H=1024, density=0.9)),
            ("K2 als_chol", dict(B=2048, L=128, d=128, H=1024, solver=chol)),
            ("K2 als_chol", dict(B=2048, L=128, d=128, H=1024, explicit=True,
                                 bits=True, solver=chol)),
            ("K4 als_nnls", dict(B=2048, L=128, d=64, H=1024, solver=nnls)),
            ("K4 als_nnls", dict(B=2048, L=128, d=64, H=1024, explicit=True,
                                 bits=True, solver=nnls)))
    for name, kw in base:
        kw = dict(kw)
        B, L, d, H = kw.pop("B"), kw.pop("L"), kw.pop("d"), kw.pop("H")
        args32 = _bucket_case(gen, device, B, L, d, H, **kw)
        seen = set()
        for vtag, tbf16, head, compute in LOWP_VARIANTS:
            key = (tbf16, head if H else None, compute)
            if key in seen or (head == "uint8" and H and
                               args32[8].feedback == "explicit"):
                continue
            seen.add(key)
            args, scale = _lowp_case(args32, tbf16, head, compute)
            cfg, b = args[8], args[4]
            rounds = als._rounds_bf16(cfg, torch.float32)
            tag = (f"{cfg.feedback[:3]} B={b.batch} L={b.pad_len} "
                   f"d={args[0].shape[1]} H={H}"
                   + (f" {kw['density']:.0%}" if "density" in kw else "")
                   + (" bias" if cfg.with_biases else "")
                   + (" bits" if args[11] is not None else "")
                   + (" gb" if cfg.use_global_bias else "")
                   + (f" {vtag}" if H else f" {vtag.split(', ')[0]}, "
                      f"{'bf16' if compute == 'bfloat16' else 'f32'} "
                      "compute"))
            sw = None
            if cfg.solver == als.NNLS:
                sw = torch.zeros((b.batch,), dtype=torch.int32,
                                 device=device)
                kern = functools.partial(als.solve_bucket_nnls, sweeps=sw,
                                         hot_scale=scale)
            else:
                kern = functools.partial(als._SOLVE[cfg.solver],
                                         hot_scale=scale)
            plain = functools.partial(als._solve_bucket_plain,
                                      hot_scale=scale)
            yk, lk = kern(*args)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            yp, lp = plain(*args)
            t1.record()
            src, xb, XtX, rhs_init, b, x0, lam, g, _, W, Vh, hb, nt = args
            d64 = lambda t: None if t is None else t.double()  # noqa: E731
            y64, l64 = als._solve_bucket_plain(
                src.double(), d64(xb), d64(XtX), d64(rhs_init), b,
                x0.double(), lam, g, cfg,
                W if W is None or W.dtype == torch.uint8 else W.double(),
                d64(Vh), hb, nt, hot_scale=d64(scale), rounding=rounds)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(yk).all() and torch.isfinite(lk)
                         .all()), f"{name} {tag}: non-finite output")
            lim_y = 1e-3 if sw is not None else 1e-4
            apart = hold_bf16(f"{name} {tag}", yk, yp, y64, lim_y)
            hold_loss_at_own_y(f"{name} {tag}", args, yk, lk, scale)
            ms = time_ms(lambda: kern(*args))
            pms = (t0.elapsed_time(t1) if sw is not None
                   else time_ms(lambda: plain(*args)))
            plan = None
            extra = "" if sw is None else " " + sweep_summary(sw)
            if cfg.solver == als.CHOLESKY:
                plan, detail = k2_detail(args, scale)
                extra += "\n    " + detail
            elif cfg.solver == als.CONJUGATE_GRADIENT:
                plan, detail = k1_detail(args, scale)
                extra += "\n    " + detail
            bms, bby = als_bound(args, sw, scale, plan)
            log(f"  {name:11s} {tag:78s} y_rel={rel_err(yk, yp):.2e} "
                f"loss_rel={rel_err(lk, lp):.2e} apart={apart} "
                f"kernel={ms:.3f} ms plain={pms:.3f} ms bound={bms:.4f} ms "
                f"({bby}){extra}")
            if "density" in kw:
                k1_tiles_or_walk(args, tag, scale, y64)
            r = results[name.split()[1]]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   float((yk - yp).abs().max()))
            del yk, lk, yp, lp, y64, l64


def hot_chain_bound(W, d, present, mode):
    """Bound of K1's head term alone: W at its width (+ scales), Vh in bf16,
    p (matvec) and the output once; 4 d operations per present entry for
    the matvec term (two products), 2 d for the rhs term, at the bf16
    tensor-core rate (bf16 operands, float32 sums)."""
    B, H = W.shape
    nbytes = (B * H * W.element_size() + (B * 4 if W.element_size() == 1
                                          else 0) + H * d * 2 + B * d * 4
              + (B * d * 4 if mode == "matvec" else 0))
    fl = (4 if mode == "matvec" else 2) * d * present
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = fl / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check_hot_chain(device, results, launches) -> None:
    """rsp_hot_chain (K1's bf16 head term) against the plain chain ka -> kd
    of scripts/exp_bisect3.py at P3's shape (64, 512, 128) and at the full
    width (2048, 4096, 128), bf16 and uint8, with W about 10% present (its
    panels walked cell by cell, as K1 takes them at this density) and 60%
    present (past ``als.CG_TAU["bf16 mma"]``: its panels tile products on
    the tensor cores); then its probe run (the timing launches,
    counted)."""
    import torch
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.ops import als
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    probes = []
    for (B, H, d), dens in itertools.product(
            ((64, 512, 128), (2048, 4096, 128)), (0.1, 0.6)):
        w = ((torch.rand((B, H), generator=gen, device=device) < dens)
             * (1 + torch.rand((B, H), generator=gen, device=device)))
        Vh = (torch.randn((H, d), generator=gen, device=device) * 0.1
              ).to(torch.bfloat16)
        P = torch.randn((B, d), generator=gen, device=device)
        present = int((w > 0).sum())
        for kind in ("bf16", "uint8"):
            if kind == "uint8":
                W, scale = _quantise_rows(w)
            else:
                W, scale = w.to(torch.bfloat16).contiguous(), None
            for mode in ("matvec", "rhs"):
                kw = dict(p=P) if mode == "matvec" else dict(g=0.3)
                yk = als.hot_chain(W, Vh, scale=scale, **kw)
                yp = als._hot_chain_plain(W, Vh, scale=scale, **kw)
                y64 = als._hot_chain_plain(W, Vh, scale=scale,
                                           sdt=torch.float64, **kw)
                torch.cuda.synchronize()
                tag = f"{mode} B={B} H={H} d={d} {kind} {dens:.0%}"
                apart = hold_bf16(f"hot_chain {tag}", yk, yp, y64, 1e-5)
                probes.append((tag, lambda W=W, Vh=Vh, scale=scale, kw=kw:
                               als.hot_chain(W, Vh, scale=scale, **kw),
                               lambda W=W, Vh=Vh, scale=scale, kw=kw:
                               als._hot_chain_plain(W, Vh, scale=scale,
                                                    **kw),
                               hot_chain_bound(W, d, present, mode), apart,
                               rel_err(yk, yp)))
                results["hot_chain"]["max_abs_err"] = max(
                    results["hot_chain"]["max_abs_err"],
                    float((yk - yp).abs().max()))
    _kernels.reset_launch_counts()
    timed = [(tag, time_ms(k), bnd, apart, e)
             for tag, k, _, bnd, apart, e in probes]
    torch.cuda.synchronize()
    launches.append(check_launched(_kernels, "hot_chain probe run",
                                   ("hot_chain",)))
    for (tag, ms, (bms, bby), apart, e), (_, _, p, _, _, _) in zip(timed,
                                                                   probes):
        pms = time_ms(p)
        log(f"  hot_chain   {tag:36s} y_rel={e:.2e} apart={apart} "
            f"kernel={ms:.4f} ms plain={pms:.4f} ms bound={bms:.5f} ms "
            f"({bby})")
        if tag == "matvec B=2048 H=4096 d=128 bf16 10%":
            results["hot_chain"].update(ms=ms, plain_ms=pms, shape=tag,
                                        bound_ms=bms, bound_by=bby,
                                        library_ms=None)


#: K12's probe: P1's gather count and table rows (scripts/exp_gather.py),
#: and the rows of a table that does not fit the 50 MB L2 (1 GiB in bf16)
GATHER_N = 2_097_152
GATHER_ROWS = (32_768, 4_194_304)


def check_gather(device, results, launches) -> None:
    """K12 at P1's shape (2,097,152 indices, d = 128), f32 and bf16: from an
    L2-resident table (32,768 rows, P1's), from an HBM-resident one
    (4,194,304 rows) and as P2's lane gather (the transposed table and
    output as strided views); bitwise against table[idx], timed beside the
    plain version and torch.index_select, with rows/s, GB/s and the
    bound."""
    import torch
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.ops import gather
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    n, d = GATHER_N, 128
    runs = []
    for dt in (torch.bfloat16, torch.float32):
        for how, rows in (("L2", GATHER_ROWS[0]), ("HBM", GATHER_ROWS[1]),
                          ("lanes", GATHER_ROWS[0])):
            table = torch.randn((rows, d), generator=gen, device=device
                                ).to(dt)
            idx = torch.randint(0, rows, (n,), generator=gen, device=device,
                                dtype=torch.int32)
            plan = None
            if how == "lanes":
                sms, smem = gather._device_limits(table.device)
                plan = gather.lane_plan(n, d, rows, table.element_size(),
                                        sms, smem)
                tabT = table.T.contiguous()          # (d, rows)
                outT = torch.empty((d, n), dtype=dt, device=device)
                call = (lambda tabT=tabT, idx=idx, outT=outT:
                        gather.gather_rows(tabT.T, idx, out=outT.T))
                plain = lambda tabT=tabT, idx=idx: tabT[:, idx.long()]  # noqa: E731
                lib = (lambda tabT=tabT, idx=idx:
                       torch.index_select(tabT, 1, idx))
                got = lambda outT=outT: outT  # noqa: E731
            else:
                out = torch.empty((n, d), dtype=dt, device=device)
                call = (lambda table=table, idx=idx, out=out:
                        gather.gather_rows(table, idx, out=out))
                plain = lambda table=table, idx=idx: table[idx.long()]  # noqa: E731
                lib = (lambda table=table, idx=idx:
                       torch.index_select(table, 0, idx))
                got = lambda out=out: out  # noqa: E731
            call()
            same = torch.equal(got(), plain())
            torch.cuda.synchronize()
            tag = f"{how} {str(dt).split('.')[1]} table {rows}x{d}"
            require(same, f"K12 gather {tag}: differs from table[idx]")
            es = table.element_size()
            touched = int(torch.unique(idx).numel())
            nbytes = touched * d * es + n * 4 + n * d * es
            moved = 2 * n * d * es + n * 4      # each gathered row read once
            runs.append((tag, call, plain, lib, moved,
                         bound(nbytes, 0)[0], (table, idx), plan))
    _kernels.reset_launch_counts()
    timed = [time_ms(r[1]) for r in runs]
    torch.cuda.synchronize()
    launches.append(check_launched(_kernels, "K12 gather probe run",
                                   ("gather", "gather_lanes")))
    for (tag, _, plain, lib, moved, bms, _, plan), ms in zip(runs, timed):
        pms, lms = time_ms(plain), time_ms(lib)
        case = "" if plan is None else (
            f" case={plan.case} rt={plan.rt} span={plan.span} grid="
            f"{plan.row_groups}x{plan.n_spans} smem={plan.smem_bytes} B, "
            f"idx read {plan.row_groups}x")
        log(f"  K12 gather  {tag:32s} bitwise_equal=True kernel={ms:.4f} ms "
            f"({n / ms / 1e6:.1f}G rows/s, {moved / ms / 1e6:.0f} GB/s "
            f"read + written) plain={pms:.4f} ms index_select={lms:.4f} ms "
            f"(kernel/index_select {ms / lms:.3f}) bound={bms:.4f} ms "
            f"(bytes, kernel/bound {ms / bms:.2f}){case}")
        if plan is not None:
            require(plan.case == "staged", f"K12 {tag}: took the "
                    f"{plan.case} case")
        name = ("gather_lanes" if tag.startswith("lanes bfloat16") else
                "gather" if tag.startswith("L2 bfloat16") else None)
        if name is not None:
            results[name].update(ms=ms, plain_ms=pms, library_ms=lms,
                                 shape=f"n={n} from {tag}", bound_ms=bms,
                                 bound_by="bytes")
    del runs
    torch.cuda.empty_cache()


def run_ml100k_lowp(device, results, launches) -> None:
    """The four reduced-precision settings of REF_LOWP on ML-100k through
    fit_transform -> transform -> predict, each within LOWP_QUALITY_TOL of
    the JAX package's NDCG@10 / MAP@10 and above the gate; then explicit CG
    with compute_dtype="bfloat16" and a 16-column head, held to phase 3's
    explicit RMSE gate, and implicit NNLS with compute_dtype="bfloat16" and
    a 16-column uint8 head, held to non-negative factors; both re-check
    their kernels on the buckets the fit staged (check_staged_buckets)."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    x = rt.load_movielens100k()
    train, test = rt.train_test_split(x, 0.2, np.random.default_rng(0))
    for what, (kw, ref) in REF_LOWP.items():
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = rt.WRMF(rank=10, lambda_=1.0, feedback="implicit",
                    solver="conjugate_gradient", seed=0, device=device, **kw)
        emb = m.fit_transform(train, n_iter=10)
        emb2 = m.transform(train)
        preds = m.predict(train, k=10, not_recommend=train)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.append(check_launched(_kernels, f"ML-100k {what}",
                                       ("als_cg", "als_chol", "topk")))
        ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
        mapk = float(np.nanmean(rt.ap_k(preds.indices, test)))
        diff = rel_err(emb2, emb)
        log(f"  {what:24s} NDCG@10={ndcg:.4f} MAP@10={mapk:.4f} (JAX "
            f"{ref[0]:.4f} / {ref[1]:.4f}) iters={len(m.loss_history)} "
            f"loss={m.loss_history[-1]:.5f} |fit_transform-transform|/max="
            f"{diff:.2e} emb {emb.dtype} stages={m.stage_info} "
            f"wall={wall:.2f} s")
        require(ndcg > 0.31 and mapk > 0.37,
                f"ML-100k {what}: quality gate failed")
        require(abs(ndcg - ref[0]) <= LOWP_QUALITY_TOL
                and abs(mapk - ref[1]) <= LOWP_QUALITY_TOL,
                f"ML-100k {what}: off the JAX package's quality by more "
                f"than {LOWP_QUALITY_TOL}")
        require(diff <= 1e-5, f"ML-100k {what}: fit_transform != transform")
        check_predictions(preds.indices, 10, train.shape[1], train,
                          f"ML-100k {what}")
    full = sp.csr_matrix(x)
    tr, te = rt.train_test_split(full, 0.8, np.random.default_rng(7))
    te = te.tocoo()
    mean = tr.data.mean()
    trc = tr.copy()
    trc.data = trc.data - mean
    _kernels.reset_launch_counts()
    m = rt.WRMF(rank=10, lambda_=0.3, feedback="explicit",
                solver="conjugate_gradient", compute_dtype="bfloat16",
                n_hot=16, seed=0, device=device)
    emb = m.fit_transform(trc, n_iter=30)
    emb2 = m.transform(trc)
    torch.cuda.synchronize()
    launches.append(check_launched(_kernels, "ML-100k explicit bf16 CG",
                                   ("als_cg", "als_chol")))
    scores = emb.double().cpu().numpy() @ m.components + mean
    rmse = float(np.sqrt(np.mean((scores[te.row, te.col] - te.data) ** 2)))
    base = float(np.sqrt(np.mean((te.data - mean) ** 2)))
    diff = rel_err(emb2, emb)
    log(f"  explicit CG bf16, n_hot=16: RMSE={rmse:.4f} (global mean "
        f"{base:.4f}) iters={len(m.loss_history)} |fit_transform-transform|"
        f"/max={diff:.2e} stages={m.stage_info}")
    require(rmse < 1.05 and rmse < base,
            "ML-100k explicit bf16: RMSE gate failed")
    require(diff <= 1e-5, "ML-100k explicit bf16: fit_transform != transform")
    check_staged_buckets(m, trc, results)

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.WRMF(rank=10, lambda_=1.0, feedback="implicit", solver="nnls",
                compute_dtype="bfloat16", hot_dtype="uint8", n_hot=16,
                seed=0, device=device)
    m.fit_transform(train, n_iter=5)
    emb = m.transform(train)
    preds = m.predict(train, k=10, not_recommend=train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "ML-100k NNLS bf16 + uint8",
                                   ("als_nnls", "topk")))
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    log(f"  NNLS bf16 + uint8, n_hot=16: NDCG@10={ndcg:.4f} min(transform)="
        f"{float(emb.min()):.3e} min(components)={m.components.min():.3e} "
        f"loss={m.loss_history} stages={m.stage_info} wall={wall:.2f} s")
    require(bool(torch.isfinite(emb).all()), "ML-100k NNLS bf16: non-finite")
    require(float(emb.min()) >= 0 and m.components.min() >= 0,
            "ML-100k NNLS bf16: a negative factor")
    check_predictions(preds.indices, 10, train.shape[1], train,
                      "ML-100k NNLS bf16")
    check_staged_buckets(m, train, results)


#: the full-width reduced-precision fits of phase 9 (c)
LOWP_FULL = (("headline: compute_dtype=bfloat16, n_hot=4096",
              dict(compute_dtype="bfloat16", n_hot=4096)),
             ("hot_dtype=uint8, n_hot=auto",
              dict(hot_dtype="uint8", n_hot="auto")),
             ("precision=bfloat16, n_hot=auto",
              dict(precision="bfloat16", n_hot="auto")))


def run_full_width_lowp(device, x, results, launches, f32_loss) -> None:
    """The implicit main path at full width (rank 128, lambda 0.1, CG(3),
    2 iterations + predict) at each LOWP_FULL setting: user-updates/s of
    the best user sweep, each sweep's ms, the closing K2 half-sweep, peak
    memory and launches; the loss per nnz within 1% of the float32 fit's
    (``f32_loss``); each fit's heaviest buckets re-checked."""
    import torch
    from rsparse_tpu_torch import _kernels
    q = x[:4096]
    for what, kw in LOWP_FULL:
        log(f"  {what}")
        m, emb = _fit_full_width(device, x, f"full width {what}",
                                 ("als_cg", "als_chol"), launches,
                                 lambda_=0.1, feedback="implicit",
                                 solver="conjugate_gradient", **kw)
        t0 = time.perf_counter()
        preds = m.predict(q, k=10, not_recommend=q)
        torch.cuda.synchronize()
        launches[-1] = check_launched(_kernels, f"full width {what} with "
                                      "predict", ("als_cg", "als_chol",
                                                  "topk"))
        users = [r["wall_s"] for r in m.fit_trace if r["phase"] == "users"]
        closing = [r["wall_s"] for r in m.fit_trace
                   if r["phase"] == "transform"]
        rel = max(abs(a / b - 1) for a, b in zip(m.loss_history, f32_loss))
        log(f"  {x.shape[0] / min(users):.0f} user-updates/s (best user "
            f"sweep); closing K2 half-sweep {closing[0] * 1e3:.2f} ms; "
            f"predict 4096 users {time.perf_counter() - t0:.3f} s; loss/nnz "
            f"{m.loss_history} vs f32 {f32_loss} (max rel {rel:.2e}); "
            f"factors {emb.dtype}")
        require(rel <= 0.01, f"full width {what}: loss per nnz off the "
                f"float32 fit's by {rel:.2e}")
        check_predictions(preds.indices, 10, x.shape[1], sp.csr_matrix(q),
                          f"full width {what}")
        check_staged_buckets(m, x, results)
        del m, emb, preds
        torch.cuda.empty_cache()


# -- phase 10: the command-line path ------------------------------------------

#: the flags of phase 10 (a)'s ML-100k runs (besides --model, --device, --out
#: and --profile-dir)
CLI_FLAGS = ("--rank", "10", "--lambda", "1", "--n-iter", "10",
             "--eval-holdout", "0.2", "--seed", "0")
#: the JAX package's CLI at CLI_FLAGS on the CPU (``python -m rsparse_tpu fit
#: --data movielens100k --model M`` + CLI_FLAGS, 4 digits; held by
#: tests/test_torch_checkpoint.py): model -> (ndcg@k, map@k)
REF_CLI = {"wrmf": (0.3470, 0.4121), "puresvd": (0.3257, 0.3847),
           "linearflow": (0.3351, 0.3933)}
#: how far phase 10 (a) may read from REF_CLI
CLI_QUALITY_TOL = {"wrmf": 0.005, "puresvd": 0.01, "linearflow": 0.01}
#: the kernels each model's ``fit --eval-holdout`` + ``recommend`` launches
CLI_KERNELS = {"wrmf": ("als_cg", "als_chol", "topk"),
               "puresvd": ("spmm", "topk"),
               "linearflow": ("spmm", "spmm_residual", "topk")}


def cli_lines(argv) -> list:
    """``rsparse_tpu_torch.cli.main(argv)`` in this process: its stdout
    lines (it must exit 0)."""
    from rsparse_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    require(rc == 0, f"cli {' '.join(argv[:3])}: exit code {rc}")
    return buf.getvalue().strip().splitlines()


def check_recommend(lines, model, x, what) -> None:
    """``recommend``'s JSON lines against ``model.predict(x, k)`` in this
    process, formatted as the CLI prints it: the same users and items, the
    printed scores equal (at most one unit of the 4th decimal apart: K5
    sums a long row's chunks with float atomics, in any order)."""
    got = [json.loads(ln) for ln in lines]
    k = len(got[0]["items"])
    p = model.predict(x, k=k)
    ids = p.ids if p.ids is not None else p.indices
    off = 0
    for u, line in enumerate(got):
        uid = p.user_ids[u] if p.user_ids else u
        require(line["user"] == str(uid) and
                line["items"] == [str(i) for i in ids[u]],
                f"{what}: recommend line {u} != predict")
        want = [round(float(s), 4) for s in p.scores[u]]
        diff = max(abs(a - b) for a, b in zip(line["scores"], want))
        require(diff <= 1.5e-4, f"{what}: recommend scores of line {u} "
                f"off predict's by {diff}")
        off += sum(a != b for a, b in zip(line["scores"], want))
    log(f"  {what}: {len(got)} recommend lines == in-process predict "
        f"(items; {off} of {len(got) * k} printed scores a unit apart)")


def write_csv(x: sp.csr_matrix, path: str) -> np.ndarray:
    """Write ``x`` as ``user,item,rating`` lines under a header, ratings
    with 4 decimals, formatted with numpy: each line a row of one byte
    array, the digits filled a column at a time by integer arithmetic, the
    leading zeros masked out; returns the float32 of each written rating in
    CSR order."""
    coo = x.tocoo()
    r = np.rint(coo.data * 1e4).astype(np.int64)
    fields = [(coo.row.astype(np.int32), None), (b",", None),
              (coo.col.astype(np.int32), None), (b",", None),
              ((r // 10_000).astype(np.int32), None), (b".", None),
              ((r % 10_000).astype(np.int32), 4), (b"\n", None)]
    widths = [1 if isinstance(a, bytes) else w or len(str(int(a.max())))
              for a, w in fields]
    chars = np.empty((len(r), sum(widths)), np.uint8)
    keep = np.ones(chars.shape, bool)
    c = 0
    for (a, fixed), w in zip(fields, widths):
        if isinstance(a, bytes):
            chars[:, c] = a[0]
        else:
            v = a.copy()
            for j in range(c + w - 1, c - 1, -1):
                chars[:, j] = v % 10 + ord("0")
                v //= 10
            if not fixed:
                for j in range(w - 1):
                    keep[:, c + j] = a >= 10 ** (w - 1 - j)
        c += w
    with open(path, "wb") as f:
        f.write(b"user,item,rating\n")
        f.write(chars[keep].tobytes())
    return (r / 1e4).astype(np.float32)


def run_cli_ml100k(device, tmp, smi_line, launches) -> None:
    """Phase 10 (a): ``fit`` for each model through ``cli.main`` on ML-100k
    at CLI_FLAGS with a checkpoint and a profiler trace, held to REF_CLI;
    then ``recommend`` from the checkpoint against a loaded model's
    ``predict``."""
    import torch
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.utils import checkpoint
    import rsparse_tpu_torch as rt
    x = rt.load_movielens100k()
    for model, (ref_ndcg, ref_map) in REF_CLI.items():
        ckpt = os.path.join(tmp, f"ml100k_{model}")
        prof = os.path.join(tmp, f"prof_{model}")
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = json.loads(cli_lines(
            ["fit", "--data", "movielens100k", "--model", model,
             *CLI_FLAGS, "--device", "cuda", "--out", ckpt,
             "--profile-dir", prof])[-1])
        fit_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines = cli_lines(["recommend", "--checkpoint", ckpt, "--data",
                           "movielens100k", "--device", "cuda"])
        rec_wall = time.perf_counter() - t0
        launches.append(check_launched(
            _kernels, f"CLI {model} fit + recommend", CLI_KERNELS[model]))
        tol = CLI_QUALITY_TOL[model]
        log(f"  {model}: {json.dumps(res)}; fit command {fit_wall:.2f} s "
            f"(with the trace), recommend {rec_wall:.2f} s [{smi_line}]; "
            f"REF_CLI {ref_ndcg} / {ref_map} (tolerance {tol})")
        require(abs(res["ndcg@k"] - ref_ndcg) <= tol
                and abs(res["map@k"] - ref_map) <= tol,
                f"CLI {model}: ndcg@k / map@k off REF_CLI")
        check_recommend(lines, checkpoint.load(ckpt, device=device), x,
                        f"CLI {model}")
        traces = os.listdir(prof)
        require(len(traces) == 1, f"CLI {model}: {len(traces)} trace files")
        path = os.path.join(prof, traces[0])
        if model == "wrmf":
            with open(path) as f:
                text = f.read()
            require("als_cg_kernel" in text,
                    "CLI wrmf: the trace does not name K1's kernel")
        log(f"  {model} trace: {traces[0]}, "
            f"{os.path.getsize(path) / 2**20:.1f} MiB"
            + (", names als_cg_kernel" if model == "wrmf" else "")
            + f" [{smi_line}]")
        torch.cuda.synchronize()


def run_cli_full_width(device, x, tmp, smi_line, launches) -> None:
    """Phase 10 (b) and (c): phase 4's synthetic as a CSV through
    ``load_interactions`` and ``fit`` / ``recommend`` at rank 128, then a
    fit resumed from its state against the uninterrupted fit."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.data.io import load_interactions
    from rsparse_tpu_torch.utils import checkpoint
    csv = os.path.join(tmp, "ratings.csv")
    t0 = time.perf_counter()
    want = write_csv(x, csv)
    size = os.path.getsize(csv)
    log(f"  wrote {csv.rsplit(os.sep, 1)[-1]}: {x.nnz} lines, "
        f"{size / 1e6:.1f} MB in {time.perf_counter() - t0:.2f} s of host "
        f"time [{smi_line}]")
    t0 = time.perf_counter()
    xl = load_interactions(csv)
    load_s = time.perf_counter() - t0
    log(f"  load_interactions: {load_s:.3f} s of host time, "
        f"{size / 1e6 / load_s:.0f} MB/s, {xl.parser} parser, "
        f"{xl.shape} nnz={xl.nnz} [{smi_line}]")
    require(xl.parser == "native", "the native parser did not run")
    require(xl.shape == x.shape and np.array_equal(xl.indptr, x.indptr)
            and np.array_equal(xl.indices, x.indices),
            "the parsed matrix's shape or indices differ from the synthetic")
    require(xl.row_names == [str(i) for i in range(x.shape[0])]
            and xl.col_names == [str(j) for j in range(x.shape[1])],
            "the parsed matrix's row / column names differ")
    require(np.array_equal(xl.data, want.astype(np.float64)),
            "the parsed values differ from the float32 of the text")

    ckpt = os.path.join(tmp, "full_wrmf")
    _kernels.reset_launch_counts()
    res = json.loads(cli_lines(
        ["fit", "--data", csv, "--model", "wrmf", "--rank", "128",
         "--n-iter", "2", "--eval-holdout", "0.2", "--out", ckpt,
         "--device", "cuda"])[-1])
    t0 = time.perf_counter()
    lines = cli_lines(["recommend", "--checkpoint", ckpt, "--data", csv,
                       "--limit", "10", "--device", "cuda"])
    rec_wall = time.perf_counter() - t0
    launches.append(check_launched(
        _kernels, "CLI full-width fit + recommend", CLI_KERNELS["wrmf"]))
    phase4 = FIT_WALLS.get("full-width implicit main path")
    log(f"  fit: {json.dumps(res)}; fit_seconds {res['fit_seconds']:.3f} "
        "(80% of the entries) beside phase 4's in-process fit_transform "
        + (f"{phase4:.3f} s" if phase4 else "(phase 4 not run)")
        + f"; recommend (parse + load + transform of {x.shape[0]} users + "
        f"top-k) {rec_wall:.2f} s [{smi_line}]")
    require(res["ndcg@k"] > 0 and np.isfinite(res["map@k"]),
            "full-width CLI fit: no quality numbers")
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                 for f in os.listdir(ckpt))
    t0 = time.perf_counter()
    m = checkpoint.load(ckpt, device=device)
    torch.cuda.synchronize()
    load_ck = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.save(m, os.path.join(tmp, "full_wrmf_again"))
    save_ck = time.perf_counter() - t0
    log(f"  checkpoint: {nbytes / 2**20:.1f} MiB, save {save_ck:.2f} s, "
        f"load {load_ck:.2f} s [{smi_line}]")
    check_recommend(lines, m, xl, "CLI full width")
    del m

    # (c) resume: 1 iteration with its state, resumed to 2, beside 2 in one go
    state = os.path.join(tmp, "fit_state")
    kw = dict(rank=128, lambda_=0.1, seed=0, device=device)
    t0 = time.perf_counter()
    rt.WRMF(**kw).fit_transform(xl, n_iter=1, convergence_tol=-1,
                                checkpoint_path=state, checkpoint_every=1)
    part_s = time.perf_counter() - t0
    m2 = rt.WRMF(**kw)
    t0 = time.perf_counter()
    e2 = m2.fit_transform(xl, n_iter=2, convergence_tol=-1,
                          checkpoint_path=state, resume=True)
    torch.cuda.synchronize()
    res_s = time.perf_counter() - t0
    m3 = rt.WRMF(**kw)
    e3 = m3.fit_transform(xl, n_iter=2, convergence_tol=-1)
    same = (torch.equal(e2, e3) and np.array_equal(m2.components,
                                                    m3.components)
            and m2.loss_history == m3.loss_history)
    nbytes = sum(os.path.getsize(os.path.join(state, f))
                 for f in os.listdir(state))
    log(f"  resume: 1 iteration + state {part_s:.2f} s (state "
        f"{nbytes / 2**20:.1f} MiB), resumed to 2 {res_s:.2f} s; loss "
        f"{m2.loss_history} vs uninterrupted {m3.loss_history}; bitwise "
        f"equal: {same} [{smi_line}]")
    require(same, "the resumed fit is not bitwise the uninterrupted one")


# -----------------------------------------------------------------------------

# -- phase 11: the wide widths -------------------------------------------------

#: phase 11 (a)'s widths of K1 and K2 (d = rank, + 2 with both biases): the
#: first past the narrow instances, ranks 192, 256 and 512, with biases
WIDE_DS = (161, 192, 256, 258, 512, 514)
#: phase 11 (b)'s widths of K10 and K11: the first past r = 128, GloVe's
#: published 300 dimensions and the instance's own 320
WIDE_RS = (129, 256, 300, 320)
#: the JAX package's results at the wide widths on ML-100k (rsparse_tpu on
#: the CPU, float32): WRMF rank 192 (lambda 1, CG, seed 0, 80/20 split of
#: seed 0, n_iter=10; predict k=10 masking the training items) NDCG@10 and
#: MAP@10, and GloVe(**GLOVE_KW, rank=300).fit_transform(ml100k_cooccurrence
#: (...), n_iter=3)'s cost history; made by
#:   JAX_PLATFORMS=cpu python3 -c "import numpy as np, chip_smoke as c,
#:   rsparse_tpu as r; x = r.load_movielens100k()
#:   tr, te = r.train_test_split(x, 0.2, np.random.default_rng(0))
#:   m = r.WRMF(rank=192, lambda_=1.0, feedback='implicit',
#:              solver='conjugate_gradient', seed=0)
#:   m.fit_transform(tr, n_iter=10)
#:   p = m.predict(tr, k=10, not_recommend=tr)
#:   print(np.nanmean(r.ndcg_k(p.indices, te)), np.nanmean(r.ap_k(p.indices, te)))
#:   g = r.GloVe(**dict(c.GLOVE_KW, rank=300))
#:   g.fit_transform(c.ml100k_cooccurrence(x), n_iter=3); print(g.cost_history)"
#: and WRMF rank 192 with the NNLS solver at WIDE_NNLS_ML100K's
#: settings (the same split, seed and predict; held by
#: tests/test_torch_k4_wide.py), made by
#:   JAX_PLATFORMS=cpu python3 -c "import numpy as np, chip_smoke as c,
#:   rsparse_tpu as r; x = r.load_movielens100k()
#:   tr, te = r.train_test_split(x, 0.2, np.random.default_rng(0))
#:   kw = c.WIDE_NNLS_ML100K; m = r.WRMF(seed=0, **kw['model'])
#:   m.fit_transform(tr, n_iter=kw['n_iter'])
#:   p = m.predict(tr, k=10, not_recommend=tr)
#:   print(np.nanmean(r.ndcg_k(p.indices, te)), np.nanmean(r.ap_k(p.indices, te)))"
#: (~30 s on the CPU: the JAX package sweeps a bucket until all of its
#: systems stop, so the budget is small)
REF_WIDE = {"wrmf_rank192": (0.16864202811174311, 0.2122274675577552),
            "glove_rank300": (0.5800940529263338, 0.1271744864574558,
                              0.05637187870599677),
            "wrmf_nnls_rank192": (0.10344388322998646, 0.11410046290278318)}
#: phase 11 (c)'s NNLS model on ML-100k (d = 192: the wide K4)
WIDE_NNLS_ML100K = dict(model=dict(rank=192, lambda_=1.0,
                                   feedback="implicit", solver="nnls",
                                   nnls_max_iter=10), n_iter=3)


def check_wide_caps() -> None:
    """The width caps held on the Python side (``_kernels.MAX_D`` for K1
    and K2, ``glove.MAX_RANK`` and ``GLOVE_WIDTHS`` for K10 and K11) against
    the kernels' own checks: the library takes each cap and refuses one
    past it, and picks the instance width the Python plan names."""
    import ctypes
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.models import glove
    lib = _kernels.lib()
    info = (ctypes.c_int * 7)()
    for d, ok in ((_kernels.MAX_D["als_cg"], True),
                  (_kernels.MAX_D["als_cg"] + 1, False)):
        a = _kernels.BucketArgs(B=1, L=1, d=d)
        require((lib.rsp_als_cg_info(ctypes.byref(a), 1, info) == 0) == ok,
                f"K1's own check disagrees with MAX_D at d = {d}")
    for d, ok in ((_kernels.MAX_D["als_chol"], True),
                  (_kernels.MAX_D["als_chol"] + 1, False)):
        a = _kernels.BucketArgs(B=1, L=1, d=d)
        require((lib.rsp_als_chol_wide_info(ctypes.byref(a), info) == 0)
                == ok, f"K2's own check disagrees with MAX_D at d = {d}")
    for d, ok in ((_kernels.MAX_D["als_nnls"], True),
                  (_kernels.MAX_D["als_nnls"] + 1, False)):
        require((lib.rsp_als_nnls_inflight(d) > 0) == ok,
                f"K4's own check disagrees with MAX_D at d = {d}")
    hold_nnls_mirror()
    for r in (1, 128, 129, 300, 320, 321):
        want = glove.glove_width(r) if r <= glove.MAX_RANK else 0
        got = (lib.rsp_glove_shard_width(r), lib.rsp_glove_tile_width(r))
        require(got == (want, want), f"K10 / K11 take r = {r} on {got}, the "
                f"Python plan on {want}")
    log(f"  caps: K1, K2 and K4 d <= {_kernels.MAX_D['als_cg']}, K10 and "
        f"K11 r <= {glove.MAX_RANK} (instances {glove.GLOVE_WIDTHS}), the "
        "library's checks agree")


def hold_nnls_mirror() -> None:
    """The wide K4's layout as ops/als.py mirrors it (``nnls_wide_layout``;
    the CPU tests replay the mirror) against the library: at every width of
    WIDE_DS, float32 and bf16 tables, the scratch floats a system
    (``rsp_als_nnls_stride``), and the build's CTAs a system and shared
    bytes, the row stride and the ring's bytes (``rsp_als_nnls_wide_info``)
    must agree."""
    import ctypes
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.ops import als
    lib = _kernels.lib()
    info = (ctypes.c_int * 8)()
    seen = []
    for d in WIDE_DS:
        for tb in (4, 2):
            L = als.nnls_wide_layout(d, tb)
            a = _kernels.BucketArgs(B=1, L=1, d=d, table_bf16=int(tb == 2))
            _kernels.check(lib.rsp_als_nnls_wide_info(ctypes.byref(a), info),
                           "als_nnls")
            got = (lib.rsp_als_nnls_stride(d), info[0], info[1], info[4],
                   info[6], info[7], lib.rsp_als_nnls_extra(d, 1000))
            want = (L["stride"], L["cluster"], L["smem_bytes"], L["ds"],
                    L["ring_bytes"], L["sub"], L["sub"] * L["stride"])
            require(got == want, f"ops/als.py's wide K4 layout disagrees with "
                    f"the library at d = {d}, table bytes {tb}: (stride, "
                    f"CTAs, bytes, ds, ring, sub-slice, its floats) {want} "
                    f"against {got}")
            seen.append(f"{d}/{tb} B: {info[0]} CTAs, {info[5]} warps an SM")
    log("  K4 wide layout, ops/als.py's mirror held to the library: "
        + "; ".join(seen))


def check_wide_kernels(device, results) -> None:
    """Phase 11 (a): K1 and K2 on their wide routes against their plain
    versions on phase 2's synthetic buckets (256 rows of up to 128 entries,
    and 16 rows of up to 8,192) at every width of WIDE_DS (implicit, no
    head), and at d = 258 and 514 with a 1,024-column head (implicit with a
    global bias, explicit with presence bits) and explicit with source
    biases; y 1e-4, loss 1e-5 (PERF.md section 2); then the reduced
    precision variants of phase 9 at d = 258 and 514 (bf16 tables, bf16 and
    uint8 heads, compute_dtype="bfloat16"), bf16 cells that round apart held
    by the float64 twin."""
    import torch
    from rsparse_tpu_torch.ops import als
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    plain = als._solve_bucket_plain
    chol = als.CHOLESKY
    cg, k2 = "K1 als_cg_wide", "K2 als_chol_wide"
    cases = []
    for d in WIDE_DS:
        cases.append((cg, dict(B=256, L=128, d=d, H=0), False))
        cases.append((k2, dict(B=256, L=128, d=d, H=0, solver=chol),
                      d == 514))
    for d in (258, 514):
        cases += [
            (cg, dict(B=256, L=128, d=d, H=1024, ugb=True), d == 514),
            (cg, dict(B=256, L=128, d=d, H=1024, explicit=True, bits=True),
             False),
            (cg, dict(B=256, L=128, d=d, H=0, explicit=True, biases=True),
             False),
            (k2, dict(B=256, L=128, d=d, H=1024, solver=chol), False),
            (k2, dict(B=256, L=128, d=d, H=1024, explicit=True, bits=True,
                      solver=chol), False),
            (k2, dict(B=256, L=128, d=d, H=0, explicit=True, biases=True,
                      solver=chol), False)]
    cases += [(cg, dict(B=16, L=8192, d=514, H=1024), False),
              (k2, dict(B=16, L=8192, d=514, H=0, solver=chol), False)]
    hold_chol_mirror(device)
    for name, kw, rep in cases:
        B, L, d, H = kw.pop("B"), kw.pop("L"), kw.pop("d"), kw.pop("H")
        args = _bucket_case(gen, device, B, L, d, H, **kw)
        cfg = args[8]
        tag = (f"{cfg.feedback[:3]} B={B} L={L} d={args[0].shape[1]} H={H}"
               + (" bias" if cfg.with_biases else "")
               + (" bits" if args[11] is not None else "")
               + (" gb" if cfg.use_global_bias else ""))
        _record(results, name, als._SOLVE[cfg.solver], plain, args, tag, rep,
                1e-4, 1e-5)
    k4, nnls, bud = "K4 als_nnls_wide", als.NNLS, WIDE_NNLS_BUDGET
    lowp = tuple((name, dict(B=256, L=128, d=d, H=1024, **kw))
                 for d in (258, 514)
                 for name, kw in ((cg, {}), (cg, dict(explicit=True,
                                                       bits=True)),
                                  (k2, dict(solver=chol)),
                                  (k2, dict(explicit=True, bits=True,
                                            solver=chol)),
                                  (k4, dict(solver=nnls, nnls_max_iter=bud)),
                                  (k4, dict(explicit=True, bits=True,
                                            solver=nnls,
                                            nnls_max_iter=bud))))
    check_lowp_kernels(device, results, base=lowp, seed=12)
    check_wide_nnls(device, results)


#: phase 11 (a)'s sweep budget for the wide K4 beside its plain version
#: (the plain loop is a few torch ops a coordinate step: ~0.5 s a bucket
#: of 256 at d = 514 and this budget)
WIDE_NNLS_BUDGET = 20
#: phase 11 (d)'s users of config #2 (c) by rank (cut for time: the fit's
#: own budget, 10,000 sweeps, is not cut, and at d = 514 the item
#: half-sweep of the first 1,024 users ran over a minute, its
#: ill-conditioned items sweeping to the budget)
WIDE_NNLS_USERS = {256: 1024, 512: 256}


def k4_wide_detail(args, hot_scale=None, sweeps=None):
    """The wide K4's plan for a bucket (ops/als.py ``nnls_plan``) and its
    launches timed apart (each slice stopped after the build, G, mu, the
    sweeps; then the loss), with the sweeps' time a coordinate step: the
    slowest system's chain (the sweep launch over its steps, exact where
    every system sweeps at once) and the card's (times the warps
    sweeping, over every system's steps).  Returns (plan, text)."""
    import torch
    from rsparse_tpu_torch.ops import als
    plan = als.nnls_plan(*args, hot_scale=hot_scale)
    cargs, _, _ = als._bucket_args(*args, hot_scale, kernel="als_nnls")
    dev = args[0].device
    sw = (torch.zeros((cargs.B,), dtype=torch.int32, device=dev)
          if sweeps is None else sweeps)
    t = [time_ms(lambda: als._launch_nnls(cargs, args[8].nnls_max_iter, sw,
                                          dev, stages=st), reps=3)
         for st in (1, 2, 3, 4, 5)]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    warps = min(cargs.B, plan["per_sm"] * n_sm)
    sweep_ms = t[3] - t[2]
    chain = sweep_ms * 1e6 / max(1, int(sw.max()) * cargs.d)
    card = sweep_ms * 1e6 * warps / max(1.0, float(sw.double().sum())
                                           * cargs.d)
    return plan, (
        f"K4 wide: build {plan['cluster']} CTAs a system ({plan['passes']} "
        f"pass{'es' if plan['passes'] > 1 else ''}, {plan['smem_bytes']} "
        f"bytes), {plan['g_tiles']} G tiles, {warps} warps sweeping "
        f"({plan['per_sm']} an SM, ring {plan['ring_bytes']} bytes); build "
        f"{t[0]:.3f} + G {t[1] - t[0]:.3f} + mu {t[2] - t[1]:.3f} + sweeps "
        f"{sweep_ms:.3f} + loss {t[4] - t[3]:.3f} ms; a step {chain:.1f} ns "
        f"(slowest system's chain) / {card:.1f} ns (the card's)")


def hold_nnls_wide(args, tag, results, rep=False, hot_scale=None) -> None:
    """The wide K4 on one bucket against its plain version (one timed call)
    and the float64 twin (the same bf16 roundings): y within 1e-3, or no
    further from the float64 twin than twice the plain version (Frobenius;
    G squares the conditioning); its loss within 1e-5 of the plain loss of
    its own y; launched twice and in slices of a third of the systems,
    bitwise (every system is built and swept alone); every factor >= 0.
    ``rep``: the row of the kernels line."""
    import torch
    from rsparse_tpu_torch.ops import als
    name = "K4 als_nnls_wide"
    b = args[4]
    sw = torch.zeros((b.batch,), dtype=torch.int32, device=b.nnz.device)
    kern = functools.partial(als.solve_bucket_nnls, sweeps=sw,
                             hot_scale=hot_scale)
    yk, lk = kern(*args)
    yk, lk = yk.clone(), lk.clone()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    yp, lp = als._solve_bucket_plain(*args, hot_scale=hot_scale)
    t1.record()
    src, xb, XtX, rhs_init, b, x0, lam, g, cfg, W, Vh, hb, nt = args
    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    y64, _ = als._solve_bucket_plain(
        src.double(), d64(xb), d64(XtX), d64(rhs_init), b, x0.double(), lam,
        g, cfg, W if W is None or W.dtype == torch.uint8 else W.double(),
        d64(Vh), hb, nt, hot_scale=d64(hot_scale),
        rounding=als._rounds_bf16(cfg, torch.float32))
    torch.cuda.synchronize()
    require(bool(torch.isfinite(yk).all() and torch.isfinite(lk).all()),
            f"{name} {tag}: non-finite output")
    require(float(yk.min()) >= 0, f"{name} {tag}: a negative factor")
    apart = hold_bf16(f"{name} {tag}", yk, yp, y64, 1e-3)
    hold_loss_at_own_y(f"{name} {tag}", args, yk, lk, hot_scale)
    sw2 = torch.zeros_like(sw)
    y2, l2 = als.solve_bucket_nnls(*args, sweeps=sw2, hot_scale=hot_scale)
    torch.cuda.synchronize()
    require(bool(torch.equal(y2, yk) and torch.equal(l2, lk)
                 and torch.equal(sw2, sw)),
            f"{name} {tag}: two launches differ")
    check_nnls_slices(args, yk, sw, tag, hot_scale)
    plan, detail = k4_wide_detail(args, hot_scale, sw2)
    ms = time_ms(lambda: kern(*args))
    pms = t0.elapsed_time(t1)
    bms, bby = als_bound(args, sw, hot_scale)
    log(f"  {name:11s} {tag:62s} y_rel={rel_err(yk, yp):.2e} "
        f"loss_rel={rel_err(lk, lp):.2e} apart={apart} (vs f64: kernel "
        f"{rel_err(yk, y64):.2e}, plain {rel_err(yp, y64):.2e}) "
        f"kernel={ms:.3f} ms plain={pms:.3f} ms bound={bms:.4f} ms ({bby}) "
        f"{sweep_summary(sw)} (budget {cfg.nnls_max_iter}); two launches "
        f"bitwise\n    {detail}")
    r = results["als_nnls_wide"]
    r["max_abs_err"] = max(r["max_abs_err"], float((yk - yp).abs().max()))
    if rep:
        r.update(ms=ms, plain_ms=pms, shape=f"{tag}, budget "
                 f"{cfg.nnls_max_iter}", bound_ms=bms, bound_by=bby,
                 library_ms=None)


def check_wide_nnls(device, results) -> None:
    """Phase 11 (a): the wide K4 against its plain version at every width
    of WIDE_DS (implicit, 256 rows of up to 128 entries), and at d = 514
    with a 1,024-column head (implicit with a global bias, the kernels
    line's row; explicit with presence bits) and explicit with source
    biases (hold_nnls_wide), at a budget of WIDE_NNLS_BUDGET sweeps."""
    import torch
    from rsparse_tpu_torch.ops import als
    gen = torch.Generator(device=device)
    gen.manual_seed(14)
    cases = [dict(d=d, H=0) for d in WIDE_DS] + [
        dict(d=514, H=1024, ugb=True),
        dict(d=514, H=1024, explicit=True, bits=True),
        dict(d=514, H=0, explicit=True, biases=True)]
    log(f"  K4 wide at a budget of {WIDE_NNLS_BUDGET} sweeps")
    for kw in cases:
        d, H = kw.pop("d"), kw.pop("H")
        args = _bucket_case(gen, device, 256, 128, d, H, solver=als.NNLS,
                            nnls_max_iter=WIDE_NNLS_BUDGET, **kw)
        cfg = args[8]
        tag = (f"{cfg.feedback[:3]} B=256 L=128 d={args[0].shape[1]} H={H}"
               + (" bias" if cfg.with_biases else "")
               + (" bits" if args[11] is not None else "")
               + (" gb" if cfg.use_global_bias else ""))
        hold_nnls_wide(args, tag, results,
                       rep=d == 514 and H and cfg.use_global_bias)
        del args


def hold_chol_mirror(device) -> None:
    """Phase 11 (a): the wide K2's layout as ops/als.py mirrors it
    (``chol_wide_layout``, ``_chol_cluster_layout``; the CPU tests read the
    mirror) against what the library reports for a bucket
    (``cholesky_plan``): at every width of WIDE_DS, float32 and bf16
    tables, 256 rows of up to 128 entries and 16 of up to 8,192, the
    cluster (the width's, or for the long rows a larger one of
    CHOL_SIZES), D, the shared bytes a CTA and the largest CTA's
    panel floats must agree.  Raises where they do not."""
    import torch
    from rsparse_tpu_torch.ops import als
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    for d in WIDE_DS:
        seen = []
        for B, L in ((256, 128), (16, 8192)):
            args = _bucket_case(gen, device, B, L, d, 0, solver=als.CHOLESKY,
                                n_src=4096)
            for src in (args[0], args[0].to(torch.bfloat16)):
                plan = als.cholesky_plan(src, *args[1:])
                tb = plan["table_bytes"]
                base = als.chol_wide_layout(d, tb)["cluster"]
                M = als._chol_cluster_layout(d, tb, plan["cluster"])
                mirror = (M["D"], M["smem_bytes"], max(M["floats"]))
                got = (plan["D"], plan["smem_bytes"], plan["panel_floats"])
                ok = plan["d"] == d and mirror == got and (
                    plan["cluster"] == base or (
                        L >= 2 * M["D"]
                        and base < plan["cluster"] in als.CHOL_SIZES))
                if not ok:
                    raise RuntimeError(
                        f"ops/als.py's wide K2 layout disagrees with the "
                        f"library at d={d} B={B} L={L} table bytes {tb}: "
                        f"mirror cluster >= {base}, (D, bytes, floats) "
                        f"{mirror}; library {plan}")
                seen.append(f"B={B} {tb} B: {plan['cluster']} CTAs, "
                            f"{plan['smem_bytes']} bytes")
            del args
        print(f"  K2 wide layout d={d}, ops/als.py's mirror held to the "
              f"library: {'; '.join(seen)}", flush=True)


def check_wide_glove(device, results):
    """Phase 11 (b): K10 and K11 on their wide routes against their plain
    versions on config #4's staged head and tail, from the model's initial
    state at each rank of WIDE_RS: at r = 300 as phase 8 (a) (the first
    shard straight and swapped, launched twice for bitwise-equal tables
    and loss; the first tile, the edge tile and a transposed tile, bf16 and
    float32 counts, the first beside the cuBLAS chain of the same step), at
    the other ranks the first shard and the first tile.  Returns config
    #4's matrix and its staged head and tail."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch.models import glove
    x4 = synth_glove(**CONFIG4)
    hot, X, rem = glove._split_head(x4, GLOVE_AUTO_HOT, np.float32)
    head = glove._stage_head(X, hot, torch.bfloat16, GLOVE_KW["batch_size"],
                             device)
    del X
    tail = glove._stage_tail(rem, GLOVE_KW["batch_size"], torch.float32,
                             device)
    for r in WIDE_RS:
        st = rt.GloVe(**dict(GLOVE_KW, rank=r),
                      device=device)._init_state(x4.shape[0])
        check_glove_kernels(head, tail, st, f"config #4 r={r}", results,
                            rep=r == 300, quick=r != 300)
        del st
    return x4, head, tail


def run_wide_ml100k(device, launches) -> None:
    """Phase 11 (c): on ML-100k, WRMF rank 192 (implicit CG; d = 192)
    fit_transform -> transform -> predict within 0.005 of the JAX
    package's NDCG@10 / MAP@10 (REF_WIDE) and fit_transform == transform;
    the explicit Cholesky model with biases at rank 192 (d = 194) held to
    phase 3's RMSE gate; GloVe rank 300 with the bf16 head, its cost
    history within GLOVE_REL of the JAX package's."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    x = rt.load_movielens100k()
    train, test = rt.train_test_split(x, 0.2, np.random.default_rng(0))
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.WRMF(rank=192, lambda_=1.0, feedback="implicit",
                solver="conjugate_gradient", seed=0, device=device)
    emb = m.fit_transform(train, n_iter=10)
    preds = m.predict(train, k=10, not_recommend=train)
    emb2 = m.transform(train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "ML-100k WRMF rank 192",
                                   ("als_cg_wide", "als_chol_wide", "topk")))
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    mapk = float(np.nanmean(rt.ap_k(preds.indices, test)))
    ref = REF_WIDE["wrmf_rank192"]
    diff = float((emb - emb2).abs().max())
    log(f"  WRMF rank 192: NDCG@10={ndcg:.4f} MAP@10={mapk:.4f} (JAX on the "
        f"CPU {ref[0]:.4f} / {ref[1]:.4f}) |fit_transform-transform|="
        f"{diff:.2e} wall={wall:.2f} s")
    require(abs(ndcg - ref[0]) <= LOWP_QUALITY_TOL and
            abs(mapk - ref[1]) <= LOWP_QUALITY_TOL,
            "ML-100k rank 192: quality off the JAX package's")
    require(diff <= 1e-5, "ML-100k rank 192: fit_transform != transform")
    check_predictions(preds.indices, 10, train.shape[1], train,
                      "ML-100k rank 192")

    kw = WIDE_NNLS_ML100K
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.WRMF(seed=0, device=device, **kw["model"])
    emb = m.fit_transform(train, n_iter=kw["n_iter"])
    preds = m.predict(train, k=10, not_recommend=train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "ML-100k WRMF NNLS rank 192",
                                   ("als_nnls_wide", "topk")))
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    mapk = float(np.nanmean(rt.ap_k(preds.indices, test)))
    ref = REF_WIDE["wrmf_nnls_rank192"]
    low = min(float(emb.min()), float(np.min(m.components)))
    log(f"  WRMF NNLS rank 192 ({kw['n_iter']} iterations, budget "
        f"{kw['model']['nnls_max_iter']} sweeps): NDCG@10={ndcg:.4f} "
        f"MAP@10={mapk:.4f} (JAX on the CPU {ref[0]:.4f} / {ref[1]:.4f}); "
        f"smallest factor {low:.3g}; wall={wall:.2f} s")
    require(abs(ndcg - ref[0]) <= LOWP_QUALITY_TOL and
            abs(mapk - ref[1]) <= LOWP_QUALITY_TOL,
            "ML-100k NNLS rank 192: quality off the JAX package's")
    require(low >= 0, "ML-100k NNLS rank 192: a negative factor")
    check_predictions(preds.indices, 10, train.shape[1], train,
                      "ML-100k NNLS rank 192")

    full = sp.csr_matrix(x)
    tr, te = rt.train_test_split(full, 0.8, np.random.default_rng(7))
    te = te.tocoo()
    mean = tr.data.mean()
    trc = tr.copy()
    trc.data = trc.data - mean
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.WRMF(rank=192, lambda_=0.3, feedback="explicit", solver="cholesky",
                with_user_item_bias=True, seed=0, device=device)
    emb = m.fit_transform(trc, n_iter=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.append(check_launched(_kernels, "ML-100k explicit rank 192",
                                   ("als_chol_wide",)))
    scores = emb.double().cpu().numpy() @ m.components + mean
    rmse = float(np.sqrt(np.mean((scores[te.row, te.col] - te.data) ** 2)))
    base = float(np.sqrt(np.mean((te.data - mean) ** 2)))
    log(f"  explicit biases rank 192 (d = {emb.shape[1]}): RMSE={rmse:.4f} "
        f"(global mean {base:.4f}) iters={len(m.loss_history)} "
        f"wall={wall:.2f} s")
    require(bool(torch.isfinite(emb).all()), "ML-100k rank 192 explicit: "
            "non-finite")
    require(rmse < 1.05 and rmse < base, "ML-100k rank 192: explicit RMSE "
            "gate failed")

    xg = ml100k_cooccurrence(x)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    g = rt.GloVe(**dict(GLOVE_KW, rank=300), device=device)
    ge = g.fit_transform(xg, n_iter=3)
    wall = time.perf_counter() - t0
    info = g.stage_info
    names = (("glove_dense_wide",) if info["tiles"] else ()) + (
        ("glove_wide",) if info["shards"] else ())
    launches.append(check_launched(_kernels, "GloVe rank 300 ML-100k", names))
    ref = REF_WIDE["glove_rank300"]
    rels = [abs(a / b - 1) for a, b in zip(g.cost_history, ref)]
    log(f"  GloVe rank 300: cost history "
        f"{[round(c, 6) for c in g.cost_history]} (JAX on the CPU "
        f"{[round(c, 6) for c in ref]}, largest relative distance "
        f"{max(rels):.2e}); wall {wall:.2f} s")
    require(bool(torch.isfinite(ge).all()), "GloVe rank 300: non-finite")
    require(len(rels) == 3 and max(rels) <= GLOVE_REL,
            "GloVe rank 300: cost history off the JAX package's")


def _wide_fit(device, x, what, launches, rank, q=None, **kw):
    """A full-width WRMF fit at a wide rank (phase 11 (d)): stage walls,
    sweep ms, user-updates/s, peak memory and loss per nnz; with ``q``,
    transform of every user and predict of the users in ``q`` by the host
    clock, counted with the fit's launches."""
    import torch
    from rsparse_tpu_torch import _kernels
    names = {"nnls": ("als_nnls_wide",),
             "conjugate_gradient": ("als_chol_wide", "als_cg_wide")}.get(
                 kw.get("solver"), ("als_chol_wide",))
    m, emb = _fit_full_width(device, x, what, names, launches, rank=rank,
                             **kw)
    users = [r["wall_s"] for r in m.fit_trace if r["phase"] == "users"]
    items = [r["wall_s"] for r in m.fit_trace if r["phase"] == "items"]
    closing = [r["wall_s"] for r in m.fit_trace if r["phase"] == "transform"]
    log(f"  {what}: d={emb.shape[1]}; item half-sweeps "
        f"{[round(t * 1e3, 2) for t in items]} ms, user half-sweeps "
        f"{[round(t * 1e3, 2) for t in users]} ms, closing half-sweep "
        f"{[round(t * 1e3, 2) for t in closing]} ms; "
        f"{x.shape[0] / min(users or closing):.0f} user-updates/s (best "
        f"user sweep); loss/nnz {m.loss_history}")
    require(all(np.isfinite(m.loss_history)), f"{what}: non-finite loss")
    if q is not None:
        t0 = time.perf_counter()
        e2 = m.transform(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        preds = m.predict(q, k=10, not_recommend=q)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches[-1] = check_launched(_kernels, f"{what} with transform and "
                                      "predict", names + ("topk",))
        log(f"  transform {x.shape[0]} users {t1 - t0:.3f} s "
            f"({x.shape[0] / (t1 - t0):.0f} users/s); predict "
            f"{q.shape[0]} users k=10 {t2 - t1:.3f} s")
        require(bool(torch.isfinite(e2).all()), f"{what}: transform")
        check_predictions(preds.indices, 10, x.shape[1], sp.csr_matrix(q),
                          what)
        del e2, preds
    return m, emb


def run_wide_full(device, x, x4, results, launches) -> None:
    """Phase 11 (d): the wide widths at full width.  On phase 4's
    ML-20M-shaped synthetic, implicit CG(3): rank 512 (d = 512), n_hot=
    "auto", float32, 2 iterations, then transform of all 65,536 users and
    predict of 4,096; rank 256 at the headline setting (compute_dtype=
    "bfloat16", n_hot=4096), 2 iterations; config #2 (b) at rank 256
    (explicit Cholesky with user, item and global biases, d = 258), 1
    iteration.  Each re-checks its kernels on its heaviest buckets (their
    first 1,024 rows) against the plain version; rank 512 times its whole
    closing K2 sweep (K2's wide fit row).  Then config #4 GloVe at rank 300
    (bf16 head), 3 epochs, with both kernels re-checked on the fitted
    state."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    q = x[:4096]
    log("  rank 512, implicit CG(3), n_hot=auto, float32")
    m, emb = _wide_fit(device, x, "rank 512 implicit", launches, 512, q=q,
                       lambda_=0.1, feedback="implicit",
                       solver="conjugate_gradient", n_hot="auto")
    check_staged_buckets(m, x, results, k2_fit=True, max_rows=1024)
    del m, emb
    torch.cuda.empty_cache()
    log("  rank 256, the headline setting (compute_dtype=bfloat16, "
        "n_hot=4096)")
    m, emb = _wide_fit(device, x, "rank 256 headline", launches, 256,
                       lambda_=0.1, feedback="implicit",
                       solver="conjugate_gradient", compute_dtype="bfloat16",
                       n_hot=4096)
    check_staged_buckets(m, x, results, max_rows=1024)
    del m, emb
    torch.cuda.empty_cache()
    log("  config #2 (b) at rank 256: explicit Cholesky, user/item + global "
        "biases (d = 258), 1 iteration")
    m, emb = _wide_fit(device, x, "config #2 (b) rank 256", launches, 256,
                       n_iter=1, lambda_=0.1, feedback="explicit",
                       solver="cholesky", with_user_item_bias=True,
                       with_global_bias=True)
    require(m.components.shape == (258, x.shape[1]),
            "config #2 (b) rank 256: R")
    check_staged_buckets(m, x, results, max_rows=1024)
    del m, emb
    torch.cuda.empty_cache()
    for rank, kw in ((256, {}), (512, dict(with_user_item_bias=True))):
        xs = x[:WIDE_NNLS_USERS[rank]]
        log(f"  config #2 (c) at rank {rank}: implicit NNLS"
            + (", user/item biases (d = 514)" if kw else "") + ", 1 "
            f"iteration, the first {xs.shape[0]} of {x.shape[0]} users "
            f"({xs.nnz} entries; cut for time)")
        m, emb = _wide_fit(device, xs, f"config #2 (c) rank {rank}",
                           launches, rank, n_iter=1, lambda_=0.1,
                           feedback="implicit", solver="nnls", **kw)
        require(float(emb.min()) >= 0 and float(np.min(m.components)) >= 0,
                f"config #2 (c) rank {rank}: a negative factor")
        check_staged_buckets(m, xs, results, nnls_max_iter=WIDE_NNLS_BUDGET,
                             max_rows=256)
        del m, emb
        torch.cuda.empty_cache()

    log("  config #4 GloVe rank 300 (bf16 head), 3 epochs")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    g = rt.GloVe(**dict(GLOVE_KW, rank=300), device=device)
    ge = g.fit_transform(x4, n_iter=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches.append(check_launched(_kernels, "config #4 GloVe rank 300",
                                   ("glove_wide", "glove_dense_wide")))
    info, hist = g.stage_info, g.cost_history
    log(f"  config #4 GloVe rank 300: fit_transform(n_iter=3) {wall:.3f} s ="
        f" split {info['split_s']:.3f} s + head staging {info['head_s']:.3f}"
        f" s + tail staging {info['tail_s']:.3f} s + epochs "
        f"{[round(e, 4) for e in info['epoch_s']]} s; "
        f"{x4.nnz / min(info['epoch_s']):.0f} triplets/s (best epoch); "
        f"loss/nnz {[round(c, 6) for c in hist]}; peak device memory "
        f"{peak:.2f} GiB ({peak - held:.2f} GiB above the {held:.2f} GiB "
        "held before)")
    require(bool(torch.isfinite(ge).all()) and all(np.isfinite(hist))
            and hist[0] > hist[1] > hist[2],
            "config #4 GloVe rank 300: loss not finite and decreasing")
    f32_rate = run_glove_f32_head(device, x4, launches, 300,
                                  x4.nnz / min(info["epoch_s"]))
    log("phase 11 (b, d), bf16: K10 / K11's wide bf16 instances on config "
        "#4 and config #4 at bf16 state, rank 300")
    run_glove_bf16(device, x4, results, launches, 300, hist,
                   (x4.nnz / min(info["epoch_s"]), f32_rate))
    return g


# -- phase 12: the mesh -------------------------------------------------------

#: phase 4's settings, on a mesh: rank 128, lambda 0.1, implicit CG(3)
MESH_FIT = dict(rank=128, lambda_=0.1, feedback="implicit",
                solver="conjugate_gradient", seed=0)
#: the routes of a mesh fit: the plain path (with phase 4's zipf head) and
#: the routed ALX sweeps (no head, as in the JAX package)
MESH_ROUTES = (("plain", dict(n_hot="auto")), ("alx", dict(routing="alx")),
               ("alx_ragged", dict(routing="alx_ragged")))
#: NNLS (K4) on the mesh: config #2 (c)'s 8192 users, 1 iteration
MESH_NNLS = dict(rank=128, lambda_=0.1, feedback="implicit", solver="nnls",
                 seed=0)
MESH_NNLS_USERS = 8192
MESH_Q = 4096                   # users predicted (k = 10, training mask)
#: a mesh fit against the one-process fit of the same settings: U and V
#: by relative Frobenius distance, the loss relatively.  NNLS is held by
#: its loss: each system stops on its own once a sweep changes it by less
#: than 1e-4 relatively, so a Gram that differs in its last bits stops
#: some systems a sweep apart, and a slowly converging coordinate descent
#: then ends elsewhere on a flat objective (its factors 7.3e-4 apart in
#: the first H100 run, its loss 1.1e-7): its factors are held to 1e-2
MESH_TOL = {"U": 1e-4, "V": 1e-4, "loss": 1e-5, "nnls": 1e-2}
#: near tie: a predicted item that differs from the one-process list is
#: one whose score under the one-process model is within this share of
#: the row's top score of the item it replaced
MESH_TIE = 1e-3
MESH_KERNELS = ("als_cg", "als_chol", "topk", "als_nnls", "gather")


#: phase 12's SGD parts: phase 7 (c)'s hashed FTRL and FM (rank 8,
#: 100,000 rows x 40,000,000 features x 32 nnz), config #5's RankMF WARP
#: rank 8 (10M users x 131,072 items, batch 8,192, 20 negatives) and phase
#: 8 (c)'s config #4 GloVe (rank 128, bf16 head), each at its widths with
#: its state tables row-sharded over the mesh.  Depth is cut (printed): one
#: fit pass of FTRL and FM (phase 7 (c): a first pass and 3), RankMF's
#: ``n_iter=0``, one chunk of 8 batches (an epoch of config #5 is 1,221),
#: and one GloVe epoch (phase 8 (c): 3)
MESH_SGD_PASSES = 1
MESH_RANKMF_ITER = 0
MESH_GLOVE_EPOCHS = 1
#: a mesh RankMF fit against the one-process fit, W, H, accW and accH
#: absolutely: K9 sums duplicate rows with atomics, so neither fit repeats
#: itself bit for bit (tests/test_sgd_sharded.py holds the JAX package's
#: mesh fit to 1e-6); FTRL, FM and GloVe are held bitwise
MESH_RANKMF_TOL = 1e-6
MESH_SGD_KERNELS = ("ftrl", "fm", "rankmf_rowmap", "glove", "glove_dense",
                    "rankmf_rowmap_bf16", "glove_bf16", "glove_dense_bf16")
#: the bf16 parts' depth: RankMF (REF_BF16's setting) batches of ML-100k's
#: users, GloVe (REF_BF16's) epochs
MESH_BF16_RANKMF_ITER = 20
MESH_BF16_GLOVE_EPOCHS = 2


def mesh_sgd_data():
    """The SGD parts' inputs, made from their seeds: the hashed GLM rows
    and labels, config #5's interactions, config #4's co-occurrences."""
    x, truth = synth_glm(n_feat=HASHED_FEATURES)
    x5, _, _ = synth_config5(**dict(CONFIG5, fm_rows=0))
    xg, tr, _ = ml100k_bf16_inputs()
    return x, truth, x5, synth_glove(**CONFIG4), xg, tr


def mesh_sgd_models(**where):
    """(name, model) of each SGD part, on ``where`` (``device=`` or
    ``mesh=``), in the order they run."""
    import rsparse_tpu_torch as rt
    yield "ftrl", rt.FTRL(learning_rate=0.1, lambda_=1.0, seed=0, **where)
    yield "fm", rt.FactorizationMachine(rank=8, learning_rate_w=0.2, seed=0,
                                        **where)
    yield "rankmf", rt.RankMF(rank=8, learning_rate=0.5, loss="warp", seed=0,
                              batch_size=K9_BATCH[0],
                              max_negative_samples=K9_BATCH[1], **where)
    yield "glove", rt.GloVe(**GLOVE_KW, **where)
    # the small bf16 parts: REF_BF16's settings on ML-100k
    yield "rankmf_bf16", rt.RankMF(**REF_BF16_KW["rankmf"], **where)
    yield "glove_bf16", rt.GloVe(**REF_BF16_KW["glove"], **where)


def shard_digest(t, row0: int, n: int) -> int:
    """A position-weighted sum of the bit patterns of rows ``row0..`` of
    table ``t`` that lie below global row ``n`` (mod 2^64): the sum over a
    table's row shards is the whole table's, and one flipped bit changes
    it."""
    import torch
    rows = max(0, min(t.shape[0], n - row0))
    if rows == 0:
        return 0
    b = t[:rows].contiguous()
    bits = b.view({2: torch.int16, 4: torch.int32}.get(b.element_size(),
                                                       torch.int64))
    bits = bits.reshape(rows, -1).long()
    c = bits.shape[1]
    g = (torch.arange(row0, row0 + rows, device=b.device)[:, None] * c
         + torch.arange(c, device=b.device))
    return int((bits * (g % 65521 + 1)).sum()) % 2 ** 64


def _sgd_tables(name, m):
    """{table: (tensor, logical rows)} of an SGD model's state (this
    rank's shards on a mesh)."""
    if name.startswith("glove"):
        import rsparse_tpu_torch.models.glove as glove
        return {f: (t, m._n_vocab if m.mesh is not None else t.shape[0])
                for f, t in zip(glove.GloveState._fields, m._state)}
    return {k: (getattr(m, k), n) for k, n in m._sharded_tables().items()}


def _sgd_fit(name, m, data):
    """Fit one SGD model of :func:`mesh_sgd_models` (depth cut as
    MESH_SGD_PASSES etc. say); returns (wall s, outputs to hold)."""
    import torch
    x, truth, x5, x4, xg, tr = data
    t0 = time.perf_counter()
    if name in ("ftrl", "fm"):
        y_fit = m.fit(x, truth, n_iter=MESH_SGD_PASSES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = dict(y_fit=y_fit, y_pred=m.predict(x))
        if name == "fm":
            out.update(w0=m.w0.cpu().numpy(), acc_w0=m.acc_w0.cpu().numpy())
    elif name.startswith("rankmf"):
        bf16 = name == "rankmf_bf16"
        emb = m.partial_fit_transform(
            tr if bf16 else x5,
            n_iter=MESH_BF16_RANKMF_ITER if bf16 else MESH_RANKMF_ITER)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = dict(auc=np.asarray(m.auc_history),
                   finite=np.asarray(bool(torch.isfinite(emb.float()).all())))
        if bf16:
            out["emb"] = emb.float().cpu().numpy()
    else:
        bf16 = name == "glove_bf16"
        emb = m.fit_transform(
            xg if bf16 else x4,
            n_iter=MESH_BF16_GLOVE_EPOCHS if bf16 else MESH_GLOVE_EPOCHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = dict(w_i=emb.float().cpu().numpy(), components=m.components,
                   bias_i=m.bias_i, bias_j=m.bias_j,
                   cost=np.asarray(m.cost_history))
    return wall, out


def mesh_sgd_refs(device, data, ref_dir):
    """The one-process fits each SGD part is held to: outputs and table
    digests; RankMF's tables written to ``ref_dir`` (every rank compares
    its own rows)."""
    import torch
    refs = {}
    for name, m in mesh_sgd_models(device=device):
        wall, out = _sgd_fit(name, m, data)
        tabs = _sgd_tables(name, m)
        out["digests"] = {k: shard_digest(t, 0, n)
                          for k, (t, n) in tabs.items()}
        if name == "rankmf":
            for k, (t, n) in tabs.items():
                np.save(os.path.join(ref_dir, f"rankmf_{k}.npy"),
                        t[:n].cpu().numpy())
        out["wall_s"] = wall
        refs[name] = out
        log(f"  one-process {name}: {wall:.3f} s")
        del m
        torch.cuda.empty_cache()
    return refs


def mesh_sgd_path(mesh, data, ref_dir) -> dict:
    """Every rank: the four SGD models on ``mesh`` (row-sharded tables),
    the launch counts set to 0 just before and read just after, then each
    model's stats: the fit's wall, this rank's resident table bytes, the
    gathers (one all-reduce a step: a block, a batch, a head pass or a tail
    shard) with their bytes and ms, the kernels' and write-backs' ms, the
    draws' check, its tables' digests over its own rows and (RankMF) its
    rows' largest distance from the one-process tables."""
    import torch
    from rsparse_tpu_torch import _kernels
    stats, outs = {"models": {}}, {}
    models = list(mesh_sgd_models(mesh=mesh))
    for _, m in models:
        m._ops.timed = True
    _kernels.reset_launch_counts()
    for name, m in models:
        wall, out = _sgd_fit(name, m, data)
        st = dict(m._ops.stats)
        tabs = _sgd_tables(name, m)
        i = m._ops.index     # table t's rows here start at i * t.shape[0]
        st.update(wall_s=wall, resident_bytes=sum(
            t.numel() * t.element_size() for t, _ in tabs.values()),
            digests={k: shard_digest(t, i * t.shape[0], n)
                     for k, (t, n) in tabs.items()},
            rows={k: t.shape[0] for k, (t, _) in tabs.items()})
        if name == "rankmf":
            st["map_bytes"] = sum(t.numel() * 4 for t in m._maps)
            st["max_abs"] = {}
            for k, (t, n) in tabs.items():
                ref = np.load(os.path.join(ref_dir, f"rankmf_{k}.npy"),
                              mmap_mode="r")
                row0 = i * t.shape[0]
                hi = min(row0 + t.shape[0], n)
                mine = t[:max(hi - row0, 0)].cpu().numpy()
                st["max_abs"][k] = float(np.abs(
                    mine - ref[row0:hi]).max()) if hi > row0 else 0.0
        stats["models"][name] = st
        outs[name] = out
    stats["launches"] = dict(_kernels.launches)
    del models
    torch.cuda.empty_cache()
    return stats, outs


def log_mesh_sgd(tag, stats_by_rank, outs, refs) -> dict:
    """Print the SGD parts of one mesh run and hold each model to its
    one-process fit: FTRL, FM and GloVe bitwise (every table's digest
    summed over the ranks, the predictions or embeddings, the cost),
    RankMF within MESH_RANKMF_TOL.  Returns the launches by rank."""
    world = len(stats_by_rank)
    for name in stats_by_rank[0]["models"]:
        per_rank = [s["models"][name] for s in stats_by_rank]
        ref = refs[name]
        s0 = per_rank[0]
        steps = max(s0["gathers"], 1)
        walls = ", ".join(f"{s['wall_s']:.3f}" for s in per_rank)
        log(f"  {tag} {name}: fit {walls} s by rank (one process "
            f"{ref['wall_s']:.3f} s); resident table "
            f"bytes by rank {[s['resident_bytes'] for s in per_rank]} "
            f"(rows a table on each of {world}: {s0['rows']})"
            + (f", row maps {s0['map_bytes']:,} B" if "map_bytes" in s0
               else "")
            + f"; {s0['gathers']} gathers (one all-reduce a step): "
            f"{s0['gather_bytes'] / steps:,.0f} B and "
            f"{s0['gather_s'] * 1e3 / steps:.3f} ms a step, kernel "
            f"{s0['kernel_s'] * 1e3 / steps:.3f} ms a step, write-back "
            f"{s0['put_s'] * 1e3 / steps:.3f} ms a step (rank 0, the fit "
            f"and the reads after it); draws checked "
            f"{s0['draw_checks']} time(s), spread {s0['draw_spread']}")
        want = ref["digests"]
        got = {k: sum(s["digests"][k] for s in per_rank) % 2 ** 64
               for k in want}
        if name == "rankmf":
            worst = {k: max(s["max_abs"][k] for s in per_rank)
                     for k in want}
            log(f"    {tag} rankmf: largest |mesh - one process| {worst} "
                f"(limit {MESH_RANKMF_TOL:g}); AUC {outs[name]['auc']} "
                f"against {ref['auc']}")
            require(all(v <= MESH_RANKMF_TOL for v in worst.values())
                    and bool(outs[name]["finite"]),
                    f"{tag} rankmf: off the one-process fit")
            continue
        same = {k: got[k] == want[k] for k in want}
        keys = [k for k in ref if k not in ("digests", "wall_s")]
        eq = {k: bool(np.array_equal(outs[name][k], ref[k])) for k in keys}
        log(f"    {tag} {name}: tables bitwise the one-process fit's "
            f"{same}; outputs equal {eq}")
        require(all(same.values()) and all(eq.values()),
                f"{tag} {name}: not bitwise the one-process fit")
    counts = [s["launches"] for s in stats_by_rank]
    for r, c in enumerate(counts):
        log(f"  {tag} rank {r} SGD launches: "
            + ", ".join(f"{k} {c[k]}" for k in MESH_SGD_KERNELS))
        for k in MESH_SGD_KERNELS:
            require(c[k] > 0, f"{tag} rank {r}: kernel {k} was not launched "
                    "in the SGD parts")
    return counts


def mesh_main_path(mesh, x, routes, nnls_routing) -> tuple:
    """Every rank of ``mesh`` (or this process at one rank): the mesh fits
    of ``routes`` (2 iterations, then ``predict`` of the first MESH_Q users
    through ``sharded_top_product``) and an NNLS fit, the launch counts set
    to 0 just before and read just after.  Returns (arrays by route for
    rank 0 to keep, this rank's stats)."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.ops.topk import top_product
    from rsparse_tpu_torch.parallel.alx import EXCHANGES
    q = x[:MESH_Q]
    arrays, stats = {}, {"mesh": repr(mesh), "routes": {}}
    _kernels.reset_launch_counts()
    for name, kw in routes:
        EXCHANGES.clear()
        m = rt.WRMF(mesh=mesh, **MESH_FIT, **kw)
        t0 = time.perf_counter()
        emb = m.fit_transform(x, n_iter=2, convergence_tol=-1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = m.predict(q, k=10, not_recommend=q)
        predict_s = time.perf_counter() - t0
        arrays[name] = dict(U=emb.cpu().numpy(), V=m._V.cpu().numpy(),
                            loss=np.asarray(m.loss_history),
                            pred_i=p.indices, pred_s=p.scores,
                            q_emb=m.transform(q).cpu().numpy())
        stats["routes"][name] = dict(
            fit_s=fit_s, predict_s=predict_s, stage_info=m.stage_info,
            sweeps=[(r["phase"], r["iter"], r["wall_s"] * 1e3)
                    for r in m.fit_trace],
            exchanges=list(EXCHANGES))
        del m, emb
    xs = x[:MESH_NNLS_USERS]
    m = rt.WRMF(mesh=mesh, routing=nnls_routing, **MESH_NNLS)
    t0 = time.perf_counter()
    emb = m.fit_transform(xs, n_iter=1, convergence_tol=-1)
    torch.cuda.synchronize()
    stats["nnls"] = dict(routing=nnls_routing,
                         fit_s=time.perf_counter() - t0,
                         sweeps=[(r["phase"], r["iter"], r["wall_s"] * 1e3)
                                 for r in m.fit_trace])
    arrays["nnls"] = dict(U=emb.cpu().numpy(), V=m._V.cpu().numpy(),
                          loss=np.asarray(m.loss_history))
    stats["launches"] = dict(_kernels.launches)
    # after the count: the mesh's embeddings through one-process retrieval
    for name, _ in routes:
        a = arrays[name]
        a["solo_i"], a["solo_s"] = top_product(
            torch.as_tensor(a["q_emb"], device=mesh.device), a["V"].T, 10,
            not_recommend=q)
    return arrays, stats


def _mesh_rank(rank, world, store, out_dir, share_card, nnls_routing,
               ref_dir):
    """One rank of phase 12 (b) / (c), started by torch.multiprocessing:
    on ``cuda:0`` shared by every rank (gloo) or on a card of its own
    (NCCL); the synthetics made again from their seeds."""
    if share_card:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = (
        str(rank), str(world))
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from rsparse_tpu_torch.parallel import mesh as pmesh, multihost
    multihost.initialize(f"file://{store}", world, rank, timeout_s=600)
    try:
        mesh = pmesh.make_mesh((world,), ("data",))
        arrays, stats = mesh_main_path(mesh, synth_ml20m_like(),
                                       MESH_ROUTES, nnls_routing)
        if rank == 0:
            for name, a in arrays.items():
                np.savez(os.path.join(out_dir, f"{name}.npz"), **a)
        del arrays
        import torch
        torch.cuda.empty_cache()
        stats["sgd"], outs = mesh_sgd_path(mesh, mesh_sgd_data(), ref_dir)
        if rank == 0:
            for name, a in outs.items():
                np.savez(os.path.join(out_dir, f"sgd_{name}.npz"), **a)
        with open(os.path.join(out_dir, f"stats.{rank}.json"), "w") as f:
            json.dump(stats, f)
    finally:
        dist.destroy_process_group()


def _mesh_refs(device, x):
    """The one-process fits each mesh fit is held to: phase 4's settings
    with its zipf head (the plain route) and without (ALX), and the NNLS
    fit, each with the one-process embeddings of the predicted users."""
    import torch
    import rsparse_tpu_torch as rt
    q = x[:MESH_Q]
    refs = {}
    for key, kw in (("head", dict(n_hot="auto")), ("cold", dict(n_hot=0))):
        m = rt.WRMF(device=device, **MESH_FIT, **kw)
        emb = m.fit_transform(x, n_iter=2, convergence_tol=-1)
        p = m.predict(q, k=10, not_recommend=q)
        refs[key] = dict(U=emb.cpu().numpy(), V=m._V.cpu().numpy(),
                         loss=np.asarray(m.loss_history), pred_i=p.indices,
                         pred_s=p.scores, q_emb=m.transform(q).cpu().numpy())
    m = rt.WRMF(device=device, **MESH_NNLS)
    emb = m.fit_transform(x[:MESH_NNLS_USERS], n_iter=1, convergence_tol=-1)
    refs["nnls"] = dict(U=emb.cpu().numpy(), V=m._V.cpu().numpy(),
                        loss=np.asarray(m.loss_history))
    torch.cuda.empty_cache()
    return refs


def _np_fro(a, b) -> float:
    return float(np.linalg.norm((a.astype(np.float64) - b)) /
                 max(np.linalg.norm(b.astype(np.float64)), 1e-30))


def _near_ties(idx, scores, ref_idx, ref_s, q_emb, V) -> tuple:
    """(rows whose indices differ, the largest gap): each differing row
    must be a near tie, the sorted scores of its items under the model
    ``(q_emb, V)`` within MESH_TIE of the row's top score from ``ref_s``."""
    rows = np.flatnonzero((idx != ref_idx).any(axis=1))
    worst = 0.0
    for r in rows:
        s = np.sort(q_emb[r].astype(np.float64) @ V[idx[r]].T.astype(
            np.float64))[::-1]
        worst = max(worst, float(np.abs(s - ref_s[r]).max()
                                 / max(abs(float(ref_s[r][0])), 1e-30)))
    return len(rows), worst


def hold_mesh(tag, arrays, refs, q) -> None:
    """Hold each mesh fit to its one-process fit (MESH_TOL) and its
    predictions to the one-process indices, near ties counted: against
    the one-process fit's own list, and against one-process retrieval on
    the mesh's embeddings."""
    for name, a in arrays.items():
        ref = refs["nnls" if name == "nnls" else
                   "head" if name == "plain" else "cold"]
        errs = {k: _np_fro(a[k], ref[k]) for k in ("U", "V")}
        errs["loss"] = float(np.abs(a["loss"] - ref["loss"]).max()
                             / np.abs(ref["loss"]).max())
        lim = MESH_TOL
        line = (f"  {tag} {name}: U {errs['U']:.3e}, V {errs['V']:.3e}, "
                f"loss {errs['loss']:.3e} from the one-process fit")
        if name == "nnls":
            log(line + f" (limits: factors {lim['nnls']:g}, loss "
                f"{lim['loss']:g}); factors >= 0: "
                f"{bool((a['U'] >= 0).all() and (a['V'] >= 0).all())}")
            require(max(errs["U"], errs["V"]) <= lim["nnls"]
                    and errs["loss"] <= lim["loss"]
                    and (a["U"] >= 0).all() and (a["V"] >= 0).all(),
                    f"{tag} {name}: off the one-process NNLS fit")
            continue
        n_fit, gap_fit = _near_ties(a["pred_i"], a["pred_s"], ref["pred_i"],
                                    ref["pred_s"], ref["q_emb"], ref["V"])
        n_solo, gap_solo = _near_ties(a["pred_i"], a["pred_s"], a["solo_i"],
                                      a["solo_s"], a["q_emb"], a["V"])
        log(line + f"; predict k=10: {n_fit} of {MESH_Q} rows differ from "
            f"the one-process fit's (near ties, largest gap {gap_fit:.2e}), "
            f"{n_solo} from one-process retrieval on the mesh's embeddings "
            f"(largest gap {gap_solo:.2e})")
        for k in ("U", "V", "loss"):
            require(errs[k] <= lim[k], f"{tag} {name}: {k} {errs[k]:.3e} "
                    f"from the one-process fit (limit {lim[k]:g})")
        require(gap_fit <= MESH_TIE and gap_solo <= MESH_TIE,
                f"{tag} {name}: predictions differ beyond near ties")
        check_predictions(a["pred_i"], 10, a["V"].shape[0], q,
                          f"{tag} {name}")


def log_mesh_rank(tag, rank, stats) -> dict:
    """Print one rank's phase-12 stats: the backend, each half-sweep's ms,
    each exchange's ms and bytes, the launches; return the launches."""
    log(f"  {tag} rank {rank}: {stats['mesh']}")
    for name, st in stats["routes"].items():
        log(f"    {name}: fit_transform {st['fit_s']:.3f} s, predict "
            f"{MESH_Q} users {st['predict_s']:.3f} s; stages "
            f"{st['stage_info']}; half-sweeps (ms) " + ", ".join(
                f"{p}#{i} {ms:.2f}" for p, i, ms in st["sweeps"]))
        ex = st["exchanges"]
        if ex:
            log(f"      {len(ex)} exchanges "
                f"({'ragged' if ex[0]['ragged'] else 'padded'}; the fit's "
                "half-sweeps, the closing one, predict's transform, the "
                "transform): ms " + ", ".join(f"{e['ms']:.2f}" for e in ex)
                + "; bytes this rank sent " + ", ".join(
                    f"{e['bytes']:,}" for e in ex)
                + "; all ranks by wire_cost_report: routed " + ", ".join(
                    f"{e['wire']['routed_total_bytes']:,}" for e in ex)
                + ", by all-gather " + ", ".join(
                    f"{e['wire']['allgather_bytes']:,}" for e in ex)
                + "; cache rows " + ", ".join(
                    f"{e['cache_rows']:,}" for e in ex))
    st = stats["nnls"]
    log(f"    nnls ({st['routing']}, {MESH_NNLS_USERS} users, 1 iteration): "
        f"fit_transform {st['fit_s']:.3f} s; half-sweeps (ms) " + ", ".join(
            f"{p}#{i} {ms:.2f}" for p, i, ms in st["sweeps"]))
    counts = stats["launches"]
    log(f"    launches: " + ", ".join(f"{k} {counts[k]}"
                                      for k in MESH_KERNELS))
    for k in MESH_KERNELS:
        require(counts[k] > 0, f"{tag} rank {rank}: kernel {k} was not "
                "launched")
    return counts


def hold_exchange_bytes(tag, stats_by_rank) -> None:
    """The bytes the ranks sent in each exchange sum to the plan's
    ``wire_cost_report*`` ``routed_total_bytes``."""
    for name in stats_by_rank[0]["routes"]:
        ex = [s["routes"][name]["exchanges"] for s in stats_by_rank]
        for i, e0 in enumerate(ex[0]):
            sent = sum(e[i]["bytes"] for e in ex)
            require(sent == e0["wire"]["routed_total_bytes"],
                    f"{tag} {name}: exchange {i} sent {sent} B, the report "
                    f"says {e0['wire']['routed_total_bytes']} B")


def run_mesh(device, x, launches) -> None:
    """Phase 12: (a) one rank over NCCL in this process, (b) two ranks
    sharing cuda:0 over gloo, (c) two ranks on two cards over NCCL where
    the machine has them; each held to the one-process fits."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from rsparse_tpu_torch.parallel import mesh as pmesh, multihost
    t0 = time.perf_counter()
    refs = _mesh_refs(device, x)
    q = sp.csr_matrix(x[:MESH_Q])
    log(f"  one-process reference fits (head, no head, NNLS): "
        f"{time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="rsparse_mesh_")
    try:
        t0 = time.perf_counter()
        sgd_data = mesh_sgd_data()
        log(f"  SGD inputs: hashed GLM {sgd_data[0].shape}, config #5 "
            f"{sgd_data[2].shape}, config #4 {sgd_data[3].shape} "
            f"({sgd_data[3].nnz} nnz) in {time.perf_counter() - t0:.1f} s; "
            f"depth cut: FTRL / FM {MESH_SGD_PASSES} fit pass, RankMF "
            f"n_iter={MESH_RANKMF_ITER} (8 batches), GloVe "
            f"{MESH_GLOVE_EPOCHS} epoch")
        sgd_refs = mesh_sgd_refs(device, sgd_data, tmp)
        log("phase 12 (a): one rank over NCCL in this process (the plain "
            "path and routing='alx'; NNLS routed)")
        multihost.initialize(f"file://{tmp}/store_a", 1, 0, timeout_s=600)
        try:
            mesh = pmesh.make_mesh((1,), ("data",))
            require(mesh.backend == "nccl", f"(a) backend {mesh.backend}")
            arrays, stats = mesh_main_path(mesh, x, MESH_ROUTES[:2], "alx")
            torch.cuda.empty_cache()
            sgd_stats, sgd_outs = mesh_sgd_path(mesh, sgd_data, tmp)
        finally:
            dist.destroy_process_group()
        launches.append(log_mesh_rank("(a)", 0, stats))
        hold_exchange_bytes("(a)", [stats])
        hold_mesh("(a)", arrays, refs, q)
        launches.extend(log_mesh_sgd("(a)", [sgd_stats], sgd_outs, sgd_refs))
        del arrays, sgd_outs, sgd_data
        torch.cuda.empty_cache()
        for part, world, share in (("(b)", 2, True), ("(c)", 2, False)):
            if not share and torch.cuda.device_count() < 2:
                log("phase 12 (c): did not run: this machine has "
                    f"{torch.cuda.device_count()} card (two ranks on two "
                    "cards over NCCL need a second card)")
                continue
            log(f"phase 12 {part}: {world} ranks "
                + ("sharing cuda:0 over gloo" if share else
                   "on a card each over NCCL")
                + " (the plain path, 'alx', 'alx_ragged'; NNLS on "
                "'alx_ragged')")
            out = os.path.join(tmp, part.strip("()"))
            os.makedirs(out)
            t0 = time.perf_counter()
            ctx = mp.start_processes(
                _mesh_rank, args=(world, f"{out}/store", out, share,
                                  "alx_ragged", tmp),
                nprocs=world, join=False, start_method="spawn")
            try:
                deadline = time.monotonic() + 600
                while not ctx.join(timeout=30):
                    require(time.monotonic() < deadline,
                            f"{part}: ranks still running after 600 s")
            except mp.ProcessRaisedException as e:
                raise SmokeFailure(f"{part}: a rank failed:\n{e}") from None
            except mp.ProcessExitedException as e:
                raise SmokeFailure(f"{part}: a rank died: {e}") from None
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
            log(f"  {part}: {world} ranks ran in "
                f"{time.perf_counter() - t0:.1f} s (start, synthetic, fits)")
            stats = []
            for r in range(world):
                with open(os.path.join(out, f"stats.{r}.json")) as f:
                    stats.append(json.load(f))
                launches.append(log_mesh_rank(part, r, stats[-1]))
            hold_exchange_bytes(part, stats)
            arrays = {}
            for name in [n for n, _ in MESH_ROUTES] + ["nnls"]:
                with np.load(os.path.join(out, f"{name}.npz")) as z:
                    arrays[name] = dict(z)
            hold_mesh(part, arrays, refs, q)
            outs = {}
            for name in sgd_refs:
                with np.load(os.path.join(out, f"sgd_{name}.npz")) as z:
                    outs[name] = dict(z)
            launches.extend(log_mesh_sgd(part, [s["sgd"] for s in stats],
                                         outs, sgd_refs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- bf16 state: the bf16 instances of K9, K10 and K11 ------------------------

#: RankMF and GloVe at precision="bfloat16" on ML-100k: the JAX package's
#: results (rsparse_tpu on the CPU with float64 enabled, as its tests run;
#: recomputed and held by tests/test_torch_glove_bf16.py and
#: tests/test_torch_rankmf_bf16.py), made by
#:   JAX_PLATFORMS=cpu python3 -c "import jax, numpy as np, chip_smoke as c
#:   import rsparse_tpu as rj; jax.config.update('jax_enable_x64', True)
#:   x, tr, test = c.ml100k_bf16_inputs()
#:   g = rj.GloVe(**c.REF_BF16_KW['glove']); g.fit_transform(x, n_iter=3)
#:   m = rj.RankMF(**c.REF_BF16_KW['rankmf'])
#:   m.partial_fit_transform(tr, n_iter=200)
#:   p = m.predict(tr, k=10, not_recommend=tr)
#:   print(g.cost_history, m.auc_history[-1],
#:         np.nanmean(rj.ndcg_k(p.indices, test)))"
#: GloVe on the upper triangle of crossprod(sign(x)): cost_history of three
#: epochs (no shuffle: the port's fit is deterministic, held per epoch to
#: GLOVE_BF16_REL); RankMF BPR on the 80/20 split: (AUC, NDCG@10), the port
#: drawing its own bits (AUC held within RANKMF_BF16_AUC, and the gate)
REF_BF16 = {"glove": (0.6498200810650551, 0.11316616711747934,
                      0.0829007968418744),
            "rankmf": (0.8722163308589608, 0.2308303976518771)}
REF_BF16_KW = {"glove": dict(rank=16, x_max=10.0, learning_rate=0.05,
                             n_hot=256, seed=0, precision="bfloat16"),
               "rankmf": dict(rank=16, learning_rate=0.5, loss="bpr",
                              seed=0, batch_size=2048,
                              precision="bfloat16")}
GLOVE_BF16_REL = 2e-3
RANKMF_BF16_AUC = 0.01


def ml100k_bf16_inputs():
    """REF_BF16's inputs: ML-100k's upper-triangular co-occurrence, and its
    80/20 split (train CSR, test)."""
    import rsparse_tpu_torch as rt
    ml = rt.load_movielens100k()
    x = sp.triu(ml100k_cooccurrence(ml)).tocoo()
    train, test = rt.train_test_split(ml, 0.2, np.random.default_rng(0))
    return x, sp.csr_matrix(train), test


def bf16_spacing(*ts):
    """The bf16 spacing at the largest magnitude of float32 tensors ``ts``,
    cell by cell."""
    import torch
    m = ts[0].abs()
    for t in ts[1:]:
        m = torch.maximum(m, t.abs())
    e = ((m.view(torch.int32) >> 23) & 0xFF).clamp(min=1)
    return torch.pow(2.0, (e - 134).float())


def bf16_apart(a, b, before):
    """Two bf16 tables cell by cell, each grown from ``before``: (cells
    more than one bf16 spacing apart, the spacing taken at the largest of
    the two values and their changes, so that a step that cancels the
    value is held to its own spacing; cells apart at all; cells; the
    largest |a - b|)."""
    af, bf_ = a.float().reshape(-1), b.float().reshape(-1)
    t0 = before.float().reshape(-1)
    d = (af - bf_).abs()
    sp = bf16_spacing(af, bf_, af - t0, bf_ - t0)
    return (int((d > sp).sum()), int((d > 0).sum()), d.numel(),
            float(d.max()) if d.numel() else 0.0)


def hold_bf16_tables(key, tag, names, ka, pa, before, results,
                     twin=None) -> str:
    """A bf16 instance's tables ``ka`` against its plain version's ``pa``,
    both from ``before``: every cell within one bf16 spacing (of the larger
    of its value and its change), or, given ``twin`` (K11: the plain
    version with S and the products summed at float64, each rounded once:
    bf16(S) as K11 forms it, where the plain version's float32 sum can
    round the other way, and a product whose terms cancel read without
    either float32 order's error), within two spacings of the twin's (a
    sum one spacing off reaches the step through three rounded ops: -lr
    s1, the quotient, the add) or no further from it than twice the plain
    version; returns the share of cells one spacing apart, a table."""
    parts, worst = [], 0.0
    for q, (name, a, b, t0) in enumerate(zip(names, ka, pa, before)):
        over, apart, n, dmax = bf16_apart(a, b, t0)
        note = ""
        if over and twin is not None:
            ak, bp = a.float().reshape(-1), b.float().reshape(-1)
            tw, t0f = twin[q].float().reshape(-1), t0.float().reshape(-1)
            far = (ak - bp).abs() > bf16_spacing(ak, bp, ak - t0f, bp - t0f)
            near = ((ak - tw).abs() <= 2 * bf16_spacing(ak, tw, ak - t0f,
                                                       tw - t0f)) | (
                (ak - tw).abs() <= 2 * (bp - tw).abs())
            worse = int((far & ~near).sum())
            require(worse == 0, f"{key} {tag}: {name} has {over} cells more "
                    f"than one bf16 spacing from the plain version's, "
                    f"{worse} of them also from the float64 twin's")
            note = f" ({over} beyond a spacing, at the float64 twin)"
            over = 0
        require(over == 0, f"{key} {tag}: {name} has {over} cells more than "
                f"one bf16 spacing from the plain version's")
        parts.append(f"{name} {apart}/{n}{note}")
        worst = max(worst, dmax)
    results[key]["max_abs_err"] = max(results[key]["max_abs_err"], worst)
    return "cells one bf16 spacing apart: " + ", ".join(parts)


def check_rankmf_bf16_batch(tables, bits, pos, uf, itf, hp, cfg, n_item,
                            tag, results, rep=False, reps=3):
    """K9's bf16 instance against its plain version on one batch from the
    same bf16 tables (on a grid on which every score is exact, so that both
    take the same decisions): counters equal, every cell within one bf16
    spacing, two launches bitwise; then its row-map mode the same way.
    ``hp`` is rounded to bf16 as the model rounds it."""
    import torch
    from rsparse_tpu_torch.models import rankmf
    hp = rankmf.BatchParams(*(rankmf.bf16_value(v) for v in hp))
    names = ("W", "H", "accW", "accH")
    runs = []
    for _ in range(2):
        tk = [t.clone() for t in tables]
        runs.append((tk, rankmf._rankmf_batch(*tk, bits, pos, uf, itf, hp,
                                              cfg, n_item)))
    tp = [t.clone() for t in tables]
    cp = rankmf._rankmf_batch_plain_bf16(*tp, bits, pos, uf, itf, hp, cfg,
                                         n_item)
    torch.cuda.synchronize()
    (tk, ck), (tk2, ck2) = runs
    require(all(bool(torch.isfinite(t.float()).all()) for t in tk),
            f"K9 bf16 {tag}: non-finite output")
    require(torch.equal(ck, cp), f"K9 bf16 {tag}: counters {ck.tolist()} != "
            f"plain {cp.tolist()}")
    require(torch.equal(ck, ck2) and all(torch.equal(a, b)
                                         for a, b in zip(tk, tk2)),
            f"K9 bf16 {tag}: two launches on the same inputs differ")
    text = hold_bf16_tables("rankmf_bf16", tag, names, tk, tp, tables,
                            results)
    auc_n, auc_d, found, tried = cp.tolist()
    line = (f"  K9 bf16     {tag} counters auc {auc_n}/{auc_d} found {found} "
            f"tried {tried} (equal; two launches bitwise) {text}")
    # the row-map mode (a mesh batch) on the compact tables
    rows_w, rows_h = rankmf.batch_rows(bits, pos, uf, itf, n_item)
    maps = []
    for rows, n in ((rows_w, tables[0].shape[0]),
                    (rows_h, tables[1].shape[0])):
        m = torch.full((n,), -1, dtype=torch.int32, device=bits.device)
        m[rows] = torch.arange(rows.shape[0], dtype=torch.int32,
                               device=bits.device)
        maps.append(m)
    comp = [t[r].clone() for t, r in zip(tables, (rows_w, rows_h) * 2)]
    mk, mp = [t.clone() for t in comp], [t.clone() for t in comp]
    kw = dict(wmap=maps[0], hmap=maps[1])
    a = rankmf._rankmf_batch(*mk, bits, pos, uf, itf, hp, cfg, n_item, **kw)
    b = rankmf._rankmf_batch_plain_bf16(*mp, bits, pos, uf, itf, hp, cfg,
                                        n_item, **kw)
    torch.cuda.synchronize()
    require(torch.equal(a, b), f"K9 bf16 row map {tag}: counters "
            f"{a.tolist()} != plain {b.tolist()}")
    # the compact rows are the one-process batch's rows, bit for bit
    for t1, tm, rows in zip(tk, mk, (rows_w, rows_h) * 2):
        require(torch.equal(t1[rows], tm), f"K9 bf16 row map {tag}: the "
                "compact tables differ from the one-process batch's rows")
    hold_bf16_tables("rankmf_rowmap_bf16", tag, names, mk, mp, comp,
                     results)
    line += "; row map: counters equal, rows bitwise the one-process batch's"
    if rep:
        ms = time_ms(lambda: rankmf._rankmf_batch(*tk, bits, pos, uf, itf,
                                                  hp, cfg, n_item), reps)
        pms = time_ms(lambda: rankmf._rankmf_batch_plain_bf16(
            *tp, bits, pos, uf, itf, hp, cfg, n_item), reps)
        rms = time_ms(lambda: rankmf._rankmf_batch(
            *mk, bits, pos, uf, itf, hp, cfg, n_item, **kw), reps)
        rpms = time_ms(lambda: rankmf._rankmf_batch_plain_bf16(
            *mp, bits, pos, uf, itf, hp, cfg, n_item, **kw), reps)
        bms, bby = rankmf_bound(bits, pos, uf, itf, cp, tables[0].shape[1],
                                tb=2)
        try:   # device time: launches A, G and W
            dms = graph_ms([lambda: rankmf._rankmf_batch(
                *tk, bits, pos, uf, itf, hp, cfg, n_item)], reps=20)
        except RuntimeError as e:   # a capture the card refuses
            dms = None
            log(f"    K9 bf16 {tag}: device time not measured ({e})")
        results["rankmf_bf16"].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                      bound_by=bby, library_ms=None,
                                      shape=tag,
                                      **({"device_ms": dms} if dms else {}))
        line += f" device={dms:.4f} ms" if dms else ""
        results["rankmf_rowmap_bf16"].update(ms=rms, plain_ms=rpms,
                                             bound_ms=bms, bound_by=bby,
                                             library_ms=None, shape=tag)
        line += (f" kernel={ms:.3f} ms (row map {rms:.3f} ms) plain="
                 f"{pms:.3f} ms (row map {rpms:.3f} ms) bound={bms:.4f} ms "
                 f"({bby})")
        line += "; " + k9_bf16_audit(lambda: rankmf._rankmf_batch(
            *tk, bits, pos, uf, itf, hp, cfg, n_item), tag)
        line += "; row map: " + k9_bf16_audit(lambda: rankmf._rankmf_batch(
            *mk, bits, pos, uf, itf, hp, cfg, n_item, **kw), tag)
    log(line)


def k9_bf16_audit(fn, tag) -> str:
    """What one K9 bf16 wrapper call ``fn`` puts on the card: its kernel
    launches and memsets (torch.profiler's CUDA runtime events and device
    kernels, after a warm call).  Fails if the call reaches torch.sort, the
    plain pair order (``_walk_pairs``) or the plain batch, or launches more
    than four kernels or a sort kernel."""
    import torch
    from rsparse_tpu_torch.models import rankmf
    calls = []

    def spy(name, f):
        def g(*a, **k):
            calls.append(name)
            return f(*a, **k)
        return g

    saved = {n: getattr(rankmf, n) for n in ("_walk_pairs",
                                             "_rankmf_batch_plain_bf16")}
    sort0 = torch.sort
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    try:
        for n, f in saved.items():
            setattr(rankmf, n, spy(n, f))
        torch.sort = spy("torch.sort", sort0)
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for n, f in saved.items():
            setattr(rankmf, n, f)
        torch.sort = sort0
    names = [e.name for e in prof.events()]
    api = sum(n.startswith("cudaLaunchKernel") for n in names)
    memsets = sum(n.startswith("cudaMemset") for n in names)
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.lower().startswith("memset")]
    sorts = [n for n in dev + names if "sort" in n.lower()]
    require(not calls, f"K9 bf16 {tag}: the call reached {sorted(set(calls))}")
    require(not sorts, f"K9 bf16 {tag}: a sort ran: {sorts[:3]}")
    require(max(api, len(dev)) <= 4, f"K9 bf16 {tag}: {max(api, len(dev))} "
            "kernel launches a batch (at most 4)")
    return (f"{api} kernel launches and {memsets} memsets a batch "
            f"(device kernels seen: {len(dev)}; no sort, no plain version)")


def check_rankmf_bf16(device, results) -> None:
    """Phase 7 (a), bf16: K9's bf16 instance in every mode (BPR / WARP x
    identity / sigmoid x AdaGrad / RMSprop x identity / side features) at r
    = 8 (candidates side by side) and at r = 64 (one after another, WARP
    AdaGrad), S = 8192, K = 20, over phase 7's 200,000 users."""
    import torch
    t0 = time.perf_counter()
    from rsparse_tpu_torch.models import rankmf
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    x, _, _ = synth_config5(**dict(CONFIG5, n_users=K9_USERS, fm_rows=0),
                            seed=1)
    pos = rankmf._stage_positives(x, device)
    n_user, n_item = x.shape
    uf_m = _side_features(n_user, 4096, 11)
    if_m = _side_features(n_item, 2048, 12)
    bf = torch.bfloat16
    feats = {"identity": (None, None),
             "side": (rankmf._pad_features(uf_m, bf, device),
                      rankmf._pad_features(if_m, bf, device))}
    S, K = K9_BATCH
    hp = rankmf.BatchParams(lr=0.5, gamma=0.9, lam_u=0.01, lam_ip=0.01,
                            lam_in=0.01, margin=0.1)
    cases = [(8, loss, kern, opt, fk)
             for loss in (rankmf.BPR, rankmf.WARP)
             for kern in (rankmf.IDENTITY, rankmf.SIGMOID)
             for opt in (rankmf.ADAGRAD, rankmf.RMSPROP)
             for fk in ("identity", "side")]
    cases.append((64, rankmf.WARP, rankmf.IDENTITY, rankmf.ADAGRAD,
                  "identity"))
    for r, loss, kern, opt, fk in cases:
        uf, itf = feats[fk]
        nuf = n_user if uf is None else uf_m.shape[1]
        nif = n_item if itf is None else if_m.shape[1]
        sc = 0.25 if r <= 32 else 0.125
        tables = tuple(t.to(bf) for t in (
            _grid(torch.randn((nuf, r), generator=gen, device=device) * sc),
            _grid(torch.randn((nif, r), generator=gen, device=device) * sc),
            1 + torch.rand((nuf,), generator=gen, device=device),
            1 + torch.rand((nif,), generator=gen, device=device)))
        bits = torch.randint(0, 1 << 32, (S, K + 2), generator=gen,
                             device=device, dtype=torch.int64)
        cfg = rankmf.BatchConfig(S, K, loss, kern, opt, True)
        tag = (f"S={S} K={K} r={r} {('bpr', 'warp')[loss]} "
               f"{('identity', 'sigmoid')[kern]} "
               f"{('adagrad', 'rmsprop')[opt]} {fk} features")
        check_rankmf_bf16_batch(
            tables, bits, pos, uf, itf, hp, cfg, n_item, tag, results,
            rep=(r, loss, kern, opt, fk) == (8, rankmf.WARP, rankmf.IDENTITY,
                                             rankmf.ADAGRAD, "identity"))
    del pos, feats
    torch.cuda.empty_cache()
    log(f"  (bf16 part: {time.perf_counter() - t0:.1f} s)")


def _tile_cublas_bf16(st, rows, cols, x, x_max, alpha, lr):
    """K11's bf16-state step as a chain of PyTorch calls: the five products
    through cuBLAS on the tensor cores with bf16 outputs, the elementwise
    work at bf16 and the applies.  Timed as the library column only."""
    import torch
    from rsparse_tpu_torch.models import glove
    i, j = rows.long(), cols.long()
    xf = x.float()
    present = xf > 0
    lx = torch.log(torch.where(present, xf, 1.0)).bfloat16()
    w = torch.where(present, torch.where(
        xf < x_max, torch.pow(xf / x_max, alpha), 1.0), 0.0).bfloat16()
    wi, wj = st.w_i[i], st.w_j[j]
    s = torch.clamp(wi @ wj.T + st.b_i[i][:, None] + st.b_j[j][None, :]
                    - lx, -100.0, 100.0)
    cost = w * s
    c2 = cost * cost
    f = lambda t: t.float()  # noqa: E731
    glove._adagrad_apply_bf16(st.w_i, st.b_i, st.acc_w_i, st.acc_b_i, i,
                              f(cost @ wj), f(c2 @ (wj * wj)),
                              f(cost.sum(1)), f(c2.sum(1)), lr)
    glove._adagrad_apply_bf16(st.w_j, st.b_j, st.acc_w_j, st.acc_b_j, j,
                              f(cost.T @ wi), f(c2.T @ (wi * wi)),
                              f(cost.sum(0)), f(c2.sum(0)), lr)
    return (cost * s).float().sum()


def check_glove_bf16_step(key, step, plain, state, tag, results, bnd,
                          lib=None, rep=False, reps=5, graphs=False,
                          plain_reps=None, twin=None):
    """A bf16 instance of K10 or K11 against its plain version on the same
    bf16 state: every cell of the eight tables and the loss within one bf16
    spacing of the larger of its value and its change (K11: or at its
    ``twin``, :func:`hold_bf16_tables`), and two launches on the same
    inputs bitwise."""
    import torch
    from rsparse_tpu_torch.models import glove
    fields = glove.GloveState._fields
    sk = glove.GloveState(*(t.clone() for t in state))
    sk2 = glove.GloveState(*(t.clone() for t in state))
    sp_ = glove.GloveState(*(t.clone() for t in state))
    lk, lk2, lp = step(sk), step(sk2), plain(sp_)
    tw = None
    if twin is not None:
        st_t = glove.GloveState(*(t.clone() for t in state))
        tw = (*st_t, twin(st_t).reshape(1))
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(t.float()).all()) for t in (lk, *sk)),
            f"{key} {tag}: non-finite output")
    require(torch.equal(lk, lk2) and all(torch.equal(a, b)
                                         for a, b in zip(sk, sk2)),
            f"{key} {tag}: two launches on the same inputs differ")
    text = hold_bf16_tables(key, tag, fields + ("loss",),
                            (*sk, lk.reshape(1)), (*sp_, lp.reshape(1)),
                            (*state, torch.zeros(1, device=lk.device)),
                            results, twin=tw)
    ms = time_ms(lambda: step(sk), reps)
    pms = (None if plain_reps == 0 else
           time_ms(lambda: plain(sp_), plain_reps or reps))
    lms = time_ms(lambda: lib(sp_), reps) if lib is not None else None
    dms = None
    if graphs:
        try:
            dms = graph_ms([lambda: step(sk)], reps=20)
        except RuntimeError as e:   # a capture the card refuses
            log(f"    {key} {tag}: device time not measured ({e})")
    bms, bby = bnd
    log(f"  {key:21s} {tag} (two launches bitwise) {text} kernel={ms:.3f} "
        f"ms" + (f" (device {dms:.4f} ms by CUDA graphs)" if dms else "")
        + (f" plain={pms:.3f} ms" if pms is not None else
           " plain not timed (its ordered adds take ~0.7 s a call)")
        + (f" cuBLAS bf16 chain={lms:.3f} ms" if lms else "")
        + f" bound={bms:.4f} ms ({bby})")
    if rep:
        results[key].update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                            library_ms=lms, shape=tag,
                            **({"device_ms": dms} if dms else {}))


def check_glove_bf16(head, tail, state, tag, results, rep=False) -> None:
    """K10's bf16 instance on the tail's first shard, straight and swapped,
    on both tail paths (the scheduled sums, shuffle off; the ordered
    scatter, shuffle on), its audit (:func:`k10_bf16_audit`), and K11's
    bf16-state instance on the head's tiles (0, 0), (1, 0) transposed and
    the last, each against its plain version (:func:`check_glove_bf16_step`).
    At r > 128 the wide instances."""
    import torch
    from rsparse_tpu_torch.models import glove
    hp = (GLOVE_KW["x_max"], 0.75, GLOVE_KW["learning_rate"])
    r = state.w_i.shape[1]
    sfx = "_wide" if r > glove.GLOVE_WIDTHS[0] else ""
    for label, sh in (("shard 0", tail.shard(0)),
                      ("swapped shard 0", tail.swapped().shard(0))):
        for ordered in (False, True):
            path = "ordered (shuffle on)" if ordered else "sums (shuffle off)"
            check_glove_bf16_step(
                "glove" + sfx + "_bf16",
                lambda st: glove._glove_shard_cuda(st, sh, *hp,
                                                   ordered=ordered),
                lambda st: glove._glove_shard_plain_bf16(st, sh, *hp,
                                                         ordered=ordered),
                state, f"{tag} {label} {path}, N={sh.rows.shape[0]} "
                f"U={sh.feats_r.shape[0]}/{sh.feats_c.shape[0]}", results,
                k10_bound(sh, r, tb=2),
                rep=rep and label == "shard 0" and not ordered, graphs=True,
                plain_reps=0 if ordered else None)
    sh = tail.shard(0)
    log("  " + k10_bf16_audit(
        lambda ordered: glove._glove_shard_cuda(
            glove.GloveState(*(t.clone() for t in state)), sh, *hp,
            ordered=ordered), sh, r, f"{tag} shard 0"))
    for (ti, tj), trans, xv, rows, cols in k11_tiles(head):
        check_glove_bf16_step(
            "glove_dense" + sfx + "_bf16",
            lambda st: glove._glove_tile_cuda(st, rows, cols, xv, *hp,
                                              torch.bfloat16),
            lambda st: glove._glove_tile_plain_bf16(st, rows, cols, xv, *hp),
            state, f"{tag} tile ({ti}, {tj})"
            + (" transposed" if trans else "")
            + f" {rows.numel()} x {cols.numel()} (present "
            f"{int((xv > 0).sum())})", results,
            k11_bound(rows.numel(), cols.numel(), r, 2, True,
                      int((xv > 0).sum()), tb=2),
            lib=lambda st: _tile_cublas_bf16(st, rows, cols, xv, *hp),
            rep=rep and (ti, tj) == (0, 0), graphs=True,
            twin=lambda st: glove._glove_tile_plain_bf16(
                st, rows, cols, xv, *hp, exact=True))
    torch.cuda.empty_cache()


def k11_tiles(head):
    """Config #4's head tiles that K11's checks take: (0, 0), the densest;
    (1, 0) of the transposed pass (a view with a unit row stride); the
    last tile (the padded edge, cut to its real positions), the sparsest.
    Yields ((ti, tj), transposed, counts, rows, cols)."""
    H, side, last = head.ids.shape[0], head.side, head.nt - 1
    span = lambda t: slice(t * side, min(H, (t + 1) * side))  # noqa: E731
    for (ti, tj), trans in (((0, 0), False), ((1, 0), True),
                            ((last, last), False)):
        x = head.x.T if trans else head.x
        yield ((ti, tj), trans, x[span(ti), span(tj)],
               head.ids[span(ti)], head.ids[span(tj)])


def k10_bf16_audit(fn, sh, r, tag) -> str:
    """What one K10 bf16 call ``fn(ordered)`` puts on the card on both tail
    paths (torch.profiler's device kernels after a warm call), and how many
    warps the shard's hottest feature of each side takes from its work
    list.  Fails if a path launches more than K10's three kernels and the
    loss's bf16 copy, reaches the plain version, or leaves a feature's
    entries to a single warp: on the scheduled path every item holds at
    most a chunk (128 entries) and a longer feature takes a CTA a chunk."""
    import torch
    from rsparse_tpu_torch.models import glove
    from rsparse_tpu_torch.ops import segsum
    act = torch.profiler.ProfilerActivity
    warps = glove.glove_width(r) // 32    # a CTA of the walk: a component
                                          # a thread
    out = []
    for ordered in (False, True):
        fn(ordered)
        torch.cuda.synchronize()
        saved = glove._glove_shard_plain_bf16
        calls = []
        glove._glove_shard_plain_bf16 = lambda *a, **k: calls.append(1)
        try:
            with torch.profiler.profile(
                    activities=[act.CPU, act.CUDA]) as prof:
                fn(ordered)
                torch.cuda.synchronize()
        finally:
            glove._glove_shard_plain_bf16 = saved
        names = [e.name for e in prof.events()]
        api = sum(n.startswith("cudaLaunchKernel") for n in names)
        dev = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "glove" in e.name]
        require(not calls, f"K10 bf16 {tag}: the call reached the plain "
                "version")
        require(len(dev) <= 3 and api <= 4, f"K10 bf16 {tag}: {len(dev)} "
                f"K10 kernels and {api} launches a shard (three: the costs, "
                "the walk, the finish; and the loss's bf16 copy)")
        out.append(f"{'ordered' if ordered else 'sums'} path {api} kernel "
                   f"launches a shard (K10's seen on the device: "
                   f"{len(dev)}; the rest the loss's bf16 copy)")
    for side, bounds, work in (("row", sh.bounds_r, sh.work_r),
                               ("column", sh.bounds_c, sh.work_c)):
        n = (bounds[1:] - bounds[:-1]).long()
        hot = int(n.max())
        items = work.items.long()
        require(int((items[:, 1] - items[:, 0]).max())
                <= segsum.SCHED_CHUNK, f"K10 bf16 {tag}: an item over a "
                "chunk")
        ctas = -(-hot // segsum.SCHED_CHUNK)
        out.append(f"{side} side: hottest feature {hot} entries on "
                   f"{ctas} CTAs x {warps} warps (sums; chains of at most "
                   f"{min(hot, segsum.SCHED_CHUNK)} entries), one CTA of "
                   f"{warps} warps (ordered; chains of {hot}); "
                   f"{items.shape[0]} items, {work.multi.shape[0]} features "
                   "over chunks")
    return f"K10 bf16 audit {tag}: " + "; ".join(out)


def run_glove_bf16(device, x4, results, launches, rank, f32_hist,
                   f32_rates=None, check=True) -> None:
    """Config #4 at bf16 state through GloVe.fit_transform, 3 epochs, beside
    the float32-state fits of the same run (``f32_hist``, the bf16-head
    fit's cost history; ``f32_rates``, the bf16-head and the f32-head fits'
    triplets/s): triplets/s, each epoch's cost, peak memory; with ``check``
    first the bf16 instances on its staged shards and tiles from the
    initial state."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    from rsparse_tpu_torch.models import glove
    t_part = time.perf_counter()
    kw = dict(GLOVE_KW, rank=rank, precision="bfloat16")
    sfx = "_wide" if rank > glove.GLOVE_WIDTHS[0] else ""
    if check:
        hot, X, rem = glove._split_head(x4, GLOVE_AUTO_HOT, np.float32)
        head = glove._stage_head(X, hot, torch.bfloat16, kw["batch_size"],
                                 device)
        del X
        tail = glove._stage_tail(rem, kw["batch_size"], torch.bfloat16,
                                 device)
        st0 = rt.GloVe(**kw, device=device)._init_state(x4.shape[0])
        check_glove_bf16(head, tail, st0, f"config #4 r={rank} bf16 state",
                         results, rep=True)
        del head, tail, st0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = rt.GloVe(**kw, device=device)
    emb = m.fit_transform(x4, n_iter=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 - base
    launches.append(check_launched(
        _kernels, f"config #4 GloVe r={rank} bf16",
        ("glove" + sfx + "_bf16", "glove_dense" + sfx + "_bf16")))
    hist, info = m.cost_history, m.stage_info
    require(emb.dtype == torch.bfloat16 and all(
        t.dtype == torch.bfloat16 for t in m._state),
        "config #4 GloVe bf16: a state table is not bfloat16")
    require(bool(torch.isfinite(emb.float()).all())
            and all(np.isfinite(hist)) and hist[0] > hist[1] > hist[2],
            f"config #4 GloVe r={rank} bf16: loss not finite and decreasing")
    best = min(info["epoch_s"])
    tb = sum(t.numel() * t.element_size() for t in m._state) / 2**20
    rates = ("" if f32_rates is None else
             f" (float32 state, this run: {f32_rates[0]:.0f} with the bf16 "
             f"head, {f32_rates[1]:.0f} with the f32 head)")
    log(f"  config #4 GloVe rank {rank} bf16 state: fit_transform(n_iter=3)"
        f" {wall:.3f} s, epochs {[round(e, 4) for e in info['epoch_s']]} s;"
        f" {x4.nnz / best:.0f} triplets/s (best epoch){rates}; loss/nnz "
        f"{[round(c, 6) for c in hist]} (float32 state, this run: "
        f"{[round(c, 6) for c in f32_hist]}); state {tb:.1f} MiB; peak "
        f"device memory {peak:.2f} GiB (above {base:.2f} GiB held)")
    del m, emb
    log(f"  (bf16 part: {time.perf_counter() - t_part:.1f} s)")


def run_ml100k_bf16(device, launches) -> None:
    """GloVe and RankMF at precision="bfloat16" on ML-100k against the JAX
    package's (REF_BF16): GloVe's cost history per epoch within
    GLOVE_BF16_REL; RankMF's AUC within RANKMF_BF16_AUC (its own bits) and
    the reference's gate (AUC > 0.8, NDCG@10 > 0.15), through predict."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    t0 = time.perf_counter()
    x, tr, test = ml100k_bf16_inputs()
    _kernels.reset_launch_counts()
    g = rt.GloVe(**REF_BF16_KW["glove"], device=device)
    emb = g.fit_transform(x, n_iter=3)
    launches.append(check_launched(_kernels, "ML-100k GloVe bf16",
                                   ("glove_bf16", "glove_dense_bf16")))
    ref = REF_BF16["glove"]
    rels = [abs(a / b - 1) for a, b in zip(g.cost_history, ref)]
    log(f"  ML-100k GloVe bf16: cost history "
        f"{[round(c, 6) for c in g.cost_history]} (JAX on the CPU "
        f"{[round(c, 6) for c in ref]}, largest relative distance "
        f"{max(rels):.2e})")
    require(emb.dtype == torch.bfloat16
            and bool(torch.isfinite(emb.float()).all()),
            "ML-100k GloVe bf16: not bf16 or not finite")
    require(len(rels) == 3 and max(rels) <= GLOVE_BF16_REL,
            f"ML-100k GloVe bf16: off the JAX package's history by more "
            f"than {GLOVE_BF16_REL}")
    _kernels.reset_launch_counts()
    m = rt.RankMF(**REF_BF16_KW["rankmf"], device=device)
    emb = m.partial_fit_transform(tr, n_iter=200)
    launches.append(check_launched(_kernels, "ML-100k RankMF bf16",
                                   ("rankmf_bf16",)))
    p = m.predict(tr, k=10, not_recommend=tr)
    ndcg = float(np.nanmean(rt.ndcg_k(p.indices, test)))
    auc = m.auc_history[-1]
    log(f"  ML-100k RankMF BPR rank 16 bf16: AUC {auc:.4f} NDCG@10 "
        f"{ndcg:.4f} (JAX on the CPU, its own bits: "
        f"{REF_BF16['rankmf'][0]:.4f} / {REF_BF16['rankmf'][1]:.4f})")
    require(emb.dtype == torch.bfloat16 and
            m.user_features_embeddings.dtype == torch.bfloat16,
            "ML-100k RankMF bf16: tables not bf16")
    require(abs(auc - REF_BF16["rankmf"][0]) <= RANKMF_BF16_AUC
            and auc > 0.8 and ndcg > 0.15,
            f"ML-100k RankMF bf16: AUC {auc:.4f} / NDCG {ndcg:.4f} off the "
            "reference's or below the gate")
    log(f"  (bf16 part: {time.perf_counter() - t0:.1f} s)")


def run_rankmf_bf16_full(device, x, f32_line, results, launches) -> None:
    """Config #5 RankMF WARP rank 8 at bf16, one epoch, beside the float32
    fit of the same run (``f32_line``: its updates/s, table MiB, AUC)."""
    import torch
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import _kernels
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    m = rt.RankMF(rank=8, learning_rate=0.5, loss="warp", seed=0,
                  batch_size=K9_BATCH[0], max_negative_samples=K9_BATCH[1],
                  precision="bfloat16", device=device)
    m.partial_fit_transform(x, n_iter=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = m.partial_fit_transform(x, n_iter=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = m.stage_info
    launches.append(check_launched(_kernels, "config #5 RankMF bf16",
                                   ("rankmf_bf16",)))
    tabs = (m.user_features_embeddings, m.item_features_embeddings,
            m._accW, m._accH)
    require(all(t.dtype == torch.bfloat16 for t in tabs),
            "config #5 RankMF bf16: a table is not bfloat16")
    require(bool(torch.isfinite(emb.float()).all()),
            "config #5 RankMF bf16: non-finite")
    mib = sum(t.numel() * t.element_size() for t in tabs) / 2**20
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  config #5 RankMF WARP rank 8 bf16: epoch {wall:.3f} s = "
        f"{info['updates'] / wall:.0f} pairwise updates/s; tables "
        f"{mib:.1f} MiB; AUC~{m.auc_history[-1]:.3f}; peak device memory "
        f"{peak:.2f} GiB (float32, this run: {f32_line})")
    del m, emb, tabs
    log(f"  (bf16 part: {time.perf_counter() - t0:.1f} s)")


KERNELS = {
    "als_cg": ("rsparse_tpu_torch/csrc/als_cg.cu",
               "rsparse_tpu/ops/als.py:138, rsparse_tpu/ops/als.py:269"),
    "als_chol": ("rsparse_tpu_torch/csrc/als_chol.cu",
                 "rsparse_tpu/ops/als.py:138, rsparse_tpu/ops/als.py:269"),
    "topk": ("rsparse_tpu_torch/csrc/topk.cu", "rsparse_tpu/ops/topk.py:134"),
    "als_nnls": ("rsparse_tpu_torch/csrc/als_nnls.cu",
                 "rsparse_tpu/ops/solvers.py:254"),
    "spmm": ("rsparse_tpu_torch/csrc/spmm.cu", "rsparse_tpu/ops/spmm.py:35"),
    "spmm_residual": ("rsparse_tpu_torch/csrc/spmm_residual.cu",
                      "rsparse_tpu/ops/spmm.py:81, "
                      "rsparse_tpu/ops/spmm.py:59"),
    "ftrl": ("rsparse_tpu_torch/csrc/ftrl.cu", "rsparse_tpu/models/ftrl.py:64"),
    "fm": ("rsparse_tpu_torch/csrc/fm.cu", "rsparse_tpu/models/fm.py:39"),
    "rankmf": ("rsparse_tpu_torch/csrc/rankmf.cu",
               "rsparse_tpu/models/rankmf.py:202"),
    "rankmf_rowmap": ("rsparse_tpu_torch/csrc/rankmf.cu",
                      "rsparse_tpu/models/rankmf.py:202"),
    "glove": ("rsparse_tpu_torch/csrc/glove.cu",
              "rsparse_tpu/models/glove.py:50, rsparse_tpu/models/glove.py:109"),
    "glove_dense": ("rsparse_tpu_torch/csrc/glove_dense.cu",
                    "rsparse_tpu/models/glove.py:206"),
    "hot_chain": ("rsparse_tpu_torch/csrc/als_cg.cu",
                  "scripts/exp_bisect3.py:17, scripts/exp_bisect3.py:80"),
    "gather": ("rsparse_tpu_torch/csrc/gather.cu",
               "scripts/exp_gather.py:74, scripts/exp_gather2.py:45, "
               "scripts/exp_gather2.py:63"),
    "gather_lanes": ("rsparse_tpu_torch/csrc/gather.cu",
                     "scripts/exp_gather2.py:79"),
    "als_cg_wide": ("rsparse_tpu_torch/csrc/als_cg.cuh",
                    "rsparse_tpu/ops/als.py:138, rsparse_tpu/ops/als.py:269"),
    "als_chol_wide": ("rsparse_tpu_torch/csrc/als_chol_wide.cu",
                      "rsparse_tpu/ops/als.py:138, "
                      "rsparse_tpu/ops/als.py:269"),
    "als_nnls_wide": ("rsparse_tpu_torch/csrc/als_nnls_wide.cu",
                      "rsparse_tpu/ops/solvers.py:254"),
    "glove_wide": ("rsparse_tpu_torch/csrc/glove.cu",
                   "rsparse_tpu/models/glove.py:50, "
                   "rsparse_tpu/models/glove.py:109"),
    "glove_dense_wide": ("rsparse_tpu_torch/csrc/glove_dense.cu",
                         "rsparse_tpu/models/glove.py:206"),
    # the bf16-state instances (RankMF, GloVe precision="bfloat16")
    "rankmf_bf16": ("rsparse_tpu_torch/csrc/rankmf.cu",
                    "rsparse_tpu/models/rankmf.py:202"),
    "rankmf_rowmap_bf16": ("rsparse_tpu_torch/csrc/rankmf.cu",
                           "rsparse_tpu/models/rankmf.py:202"),
    "glove_bf16": ("rsparse_tpu_torch/csrc/glove.cu",
                   "rsparse_tpu/models/glove.py:50, "
                   "rsparse_tpu/models/glove.py:109"),
    "glove_wide_bf16": ("rsparse_tpu_torch/csrc/glove.cu",
                        "rsparse_tpu/models/glove.py:50, "
                        "rsparse_tpu/models/glove.py:109"),
    "glove_dense_bf16": ("rsparse_tpu_torch/csrc/glove_dense.cu",
                         "rsparse_tpu/models/glove.py:206"),
    "glove_dense_wide_bf16": ("rsparse_tpu_torch/csrc/glove_dense.cu",
                              "rsparse_tpu/models/glove.py:206"),
    # K11's f32 head (GloVe's default compute dtype)
    "glove_dense_f32": ("rsparse_tpu_torch/csrc/glove_dense.cu",
                        "rsparse_tpu/models/glove.py:206"),
    "glove_dense_wide_f32": ("rsparse_tpu_torch/csrc/glove_dense.cu",
                             "rsparse_tpu/models/glove.py:206"),
}


def main(phases) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    t_main = time.perf_counter()
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
        check_spmm_kernels(device, results)
    if 3 in phases:
        log("phase 3: main paths, ML-100k (implicit CG; explicit Cholesky "
            "with biases; NNLS)")
        run_ml100k(device, launches)
    x = f32_loss = None
    if phases & {4, 5, 6, 9, 10, 11, 12}:
        t0 = time.perf_counter()
        x = synth_ml20m_like()
        log(f"  synth: {x.shape[0]} x {x.shape[1]}, {x.nnz} nnz "
            f"({time.perf_counter() - t0:.2f} s)")
    if 4 in phases:
        log("phase 4: implicit main path at full width (rank 128, "
            "65,536 x 32,768)")
        m = run_full_width(device, x, launches)
        f32_loss = list(m.loss_history)
        check_staged_buckets(m, x, results, k2_fit=True)
        log("  K1 bucket by bucket (f32 fit, then the headline bf16 fit)")
        k1_buckets_full_width(device, x, m, results)
        log("  profile of a warm full-width fit_transform + predict")
        profile_full_width(m, x)
        del m
        torch.cuda.empty_cache()
    if 5 in phases:
        log("phase 5: config #2 at full width (rank 128, explicit / biases "
            "/ NNLS)")
        run_config2(device, x, results, launches)
    if 6 in phases:
        log("phase 6: the low-rank family: (a) ML-100k PureSVD / LinearFlow")
        run_low_rank_ml100k(device, launches)
        log("phase 6 (b): config #3 at full width (rank 256, 65,536 x "
            "32,768)")
        run_config3(device, x, results, launches)
    if 7 in phases:
        t7 = time.perf_counter()
        log("phase 7 (a): the SGD family's kernels against their plain "
            "versions")
        check_sgd_kernels(device, results)
        log("phase 7 (a), bf16: K9's bf16 instance against its plain "
            "version in every mode")
        check_rankmf_bf16(device, results)
        log("phase 7 (b): quality (FTRL / FM on bench.py:396's synthetic, "
            "FM XOR, RankMF on ML-100k)")
        run_sgd_quality(device, launches)
        log("phase 7 (c): full width (hashed FTRL / FM; config #5 RankMF and"
            " FM)")
        run_sgd_full_width(device, results, launches)
        log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")
    if 8 in phases:
        t8 = time.perf_counter()
        log("phase 8: GloVe (config #4: vocabulary 50,000, rank 128, bf16 "
            "head)")
        run_glove(device, results, launches)
        log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")
    if 9 in phases:
        t9 = time.perf_counter()
        log("phase 9 (a): reduced precision: K1/K2/K4 variants, K1's bf16 "
            "head term (P3), K12 gather (P1/P2)")
        check_lowp_kernels(device, results)
        check_hot_chain(device, results, launches)
        check_gather(device, results, launches)
        log("phase 9 (b): ML-100k at each reduced-precision setting")
        run_ml100k_lowp(device, results, launches)
        log("phase 9 (c): full width (rank 128, 65,536 x 32,768) at "
            "reduced precision")
        if f32_loss is None:
            m, _ = _fit_full_width(device, x, "full-width f32 fit",
                                   ("als_cg", "als_chol"), launches,
                                   lambda_=0.1, feedback="implicit",
                                   solver="conjugate_gradient", n_hot="auto")
            f32_loss = list(m.loss_history)
            del m
        run_full_width_lowp(device, x, results, launches, f32_loss)
        log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")
    if 10 in phases:
        t10 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="rsparse_smoke_")
        try:
            log("phase 10 (a): the CLI on ML-100k (fit --eval-holdout "
                "--out --profile-dir, then recommend)")
            run_cli_ml100k(device, tmp, smi_line, launches)
            log("phase 10 (b), (c): the synthetic of phase 4 as a CSV "
                "through load_interactions and the CLI at rank 128; a "
                "resumed fit")
            run_cli_full_width(device, x, tmp, smi_line, launches)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")
    if 11 in phases:
        t11 = time.perf_counter()
        log("phase 11 (a): K1 / K2 wide routes against their plain versions "
            f"(d in {WIDE_DS})")
        check_wide_caps()
        check_wide_kernels(device, results)
        log("phase 11 (b): K10 / K11 wide routes against their plain "
            f"versions (config #4, r in {WIDE_RS})")
        x4, head4, tail4 = check_wide_glove(device, results)
        torch.cuda.empty_cache()
        log("phase 11 (c): ML-100k at rank 192 (WRMF) and 300 (GloVe) "
            "against the JAX package")
        run_wide_ml100k(device, launches)
        log("phase 11 (d): full width: rank 512 and 256 on the synthetic, "
            "config #4 GloVe at rank 300")
        g = run_wide_full(device, x, x4, results, launches)
        check_glove_kernels(head4, tail4, g._state, "fitted config #4 r=300",
                            results, quick=True)
        log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")
        del g, head4, tail4, x4
    if 12 in phases:
        t12 = time.perf_counter()
        log("phase 12: WRMF on a mesh of processes (phase 4's settings; "
            "one-process reference fits first)")
        run_mesh(device, x, launches)
        log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")
    del x
    if phases != set(range(1, 13)):
        log(f"phases {sorted(phases)} passed (a subset: no result line)")
        return 0

    total = {name: sum(c[name] for c in launches) for name in KERNELS}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": total[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
                "bound_ms": results[name]["bound_ms"],
                "bound_by": results[name]["bound_by"],
                "library_ms": results[name]["library_ms"],
                "shape": results[name]["shape"],
                **{key: v for key, v in results[name].items()
                   if key.startswith("fit_") or key == "device_ms"}}
               for name, (src, rep) in KERNELS.items()]
    log(f"  the whole run took {time.perf_counter() - t_main:.1f} s")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12",
                    help="comma-separated phases to run (1 always runs)")
    want = {1} | {int(p) for p in ap.parse_args().phases.split(",") if p}
    try:
        sys.exit(main(want))
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
