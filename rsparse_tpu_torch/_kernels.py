"""Build and bind the port's hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all at
once) and links them into one shared library with a plain C interface for
``sm_90a`` (Hopper), at first use, into ``build/rsparse_tpu_torch/`` beside
the package.  The library's file name carries a hash of the sources and
flags, so an edit triggers a rebuild.  It is loaded with ctypes: each C
entry takes raw device pointers (the ALS kernels take them gathered in a
:class:`BucketArgs`) and the CUDA stream, launches on that stream and
returns ``cudaGetLastError()``, which :func:`check` turns into an
exception.

Nothing here runs at import: the CPU tests import every module of the port
on machines without ``nvcc``.

``launches`` counts the launches of each kernel; the wrappers in
``ops/als.py``, ``ops/topk.py``, ``ops/spmm.py``, ``ops/gather.py``,
``models/ftrl.py``, ``models/fm.py``, ``models/rankmf.py`` and
``models/glove.py`` add one where they launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import torch

from .config import logger

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "rsparse_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

#: widest d each ALS kernel takes on the card, one entry a kernel, held
#: equal to the kernel's own check: K1 (csrc/als_cg.cu kMaxD; instances
#: for d <= 128, 160, 288 and 544), K2 (csrc/als_chol.cu d <= 160 in
#: shared memory, csrc/als_chol_wide.cu kWideMaxD across a cluster) and K4
#: (csrc/als_nnls.cu d <= 160, d x d matrices in shared memory;
#: csrc/als_nnls_wide.cu kWideMaxD, the lhs over the wide K2's panels and
#: G in device memory) take rank 512 with both biases, d = 514
MAX_D = {"als_cg": 514, "als_chol": 514, "als_nnls": 514}

#: launches per kernel, counted by the wrappers (the wide routes apart:
#: K1, K2 and K4 at d > 160, K10 and K11 at r > 128; the bf16-state
#: instances of K9, K10 and K11, "_bf16"; K11's f32 head, "_f32")
launches: Dict[str, int] = {"als_cg": 0, "als_chol": 0, "als_nnls": 0,
                            "topk": 0, "spmm": 0, "spmm_residual": 0,
                            "ftrl": 0, "fm": 0, "rankmf": 0,
                            "rankmf_rowmap": 0, "glove": 0,
                            "glove_dense": 0, "hot_chain": 0, "gather": 0,
                            "gather_lanes": 0, "als_cg_wide": 0,
                            "als_chol_wide": 0, "glove_wide": 0,
                            "glove_dense_wide": 0, "rankmf_bf16": 0,
                            "rankmf_rowmap_bf16": 0, "glove_bf16": 0,
                            "glove_wide_bf16": 0, "glove_dense_bf16": 0,
                            "glove_dense_wide_bf16": 0,
                            "glove_dense_f32": 0,
                            "glove_dense_wide_f32": 0, "als_nnls_wide": 0}
#: what the last build did: {"seconds": ..., "log": ..., "path": ...}
build_info: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build() -> str:
    """Compile csrc/*.cu unless a library for these exact sources exists;
    return its path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR,
                      f"librsparse_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        build_info.update(seconds=0.0, log="(cached)", path=so)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for cu in (p for p in _sources() if p.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(cu)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    log, failed = [], []
    for proc in procs:
        out, _ = proc.communicate(timeout=600)
        log.append(out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}.tmp", *objs],
            capture_output=True, text=True, timeout=600)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(link.stdout + link.stderr)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    seconds = time.perf_counter() - t0
    os.replace(f"{tmp}.tmp", so)
    build_info.update(seconds=seconds, log="\n".join(log), path=so)
    logger.info("built %s in %.1f s", so, seconds)
    return so


class BucketArgs(ctypes.Structure):
    """One bucket of ALS solves as K1, K2 and K4 take it: the ctypes mirror
    of ``rsp::BucketArgs`` in ``csrc/common.cuh`` (same fields, same
    order).  Pointers are device addresses, 0 for an absent input."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "V", "xbias", "col", "val", "nnz", "nnz_total", "XtX", "rhs_init",
        "W", "Vh", "bits", "x0", "y", "loss", "w_scale")] + [
        (name, ctypes.c_int) for name in (
            "B", "L", "d", "H", "explicit_fb", "dynamic_lambda", "table_bf16",
            "w_kind", "round_bf16")] + [
        (name, ctypes.c_float) for name in ("lam", "g_rhs", "g_loss")]


class CgPlan(ctypes.Structure):
    """K1's launch for one bucket (``Plan`` in ``csrc/als_cg.cuh``): target
    rows a CTA, CTAs a cluster sharing them (``ops/als.py`` ``cg_split``),
    and the present cells from which a head panel is a tile product."""

    _fields_ = [("rows", ctypes.c_int), ("cluster", ctypes.c_int),
                ("tau", ctypes.c_int)]


class RankMFArgs(ctypes.Structure):
    """One RankMF minibatch as K9 takes it: the ctypes mirror of
    ``RankMFArgs`` in ``csrc/rankmf.cu`` (same fields, same order).
    Pointers are device addresses, 0 for an absent input."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "bits", "flat_idx", "indptr", "row_nnz", "table", "boff", "bmask",
        "bshift", "uf_idx", "uf_val", "uf_mask", "if_idx", "if_val",
        "if_mask", "W", "H", "accW", "accH", "iscratch", "fscratch", "cntW",
        "cntH", "counters", "wmap", "hmap", "gscratch")] + [
        (name, ctypes.c_int) for name in (
            "S", "K", "r", "n_user", "n_item", "flat_len", "lanes", "Fu",
            "Fi", "loss", "kernel", "optimizer", "update_items",
            "table_bf16", "n_wrows", "n_hrows")] + [
        (name, ctypes.c_float) for name in (
            "lr", "gamma", "lam_u", "lam_ip", "lam_in", "margin", "norm")]


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    so = ctypes.CDLL(_build())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    args = ctypes.POINTER(BucketArgs)
    plan = ctypes.POINTER(CgPlan)
    # args, plan, cg_steps, tol, stream
    so.rsp_als_cg.argtypes = [args, plan, i, f, p]
    so.rsp_als_cg.restype = i
    # args, rows, info (7 int32 on the host: shared bytes a CTA, CTAs an
    # SM, clusters of 1, 2, 4, 8, 16 CTAs that run at once)
    so.rsp_als_cg_info.argtypes = [args, i, p]
    so.rsp_als_cg_info.restype = i
    # d, H, table bytes, cluster, rows, cache (int32 out) -> shared bytes
    so.rsp_als_cg_layout.argtypes = [i, i, i, i, i, p]
    so.rsp_als_cg_layout.restype = i
    # args, stages (1 the Gram, 2 + the solve, 3 + the loss), stream
    so.rsp_als_chol.argtypes = [args, i, p]
    so.rsp_als_chol.restype = i
    # args, info (5 int32 on the host: CTAs an SM, the cold and the head
    # entries' Gram routes, D, shared bytes)
    so.rsp_als_chol_info.argtypes = [args, p]
    so.rsp_als_chol_info.restype = i
    # the wide K2 (d > 160): args, stages, stream; info (7 int32: clusters
    # at once, the two routes, D, shared bytes, CTAs a cluster, the largest
    # CTA's panel floats)
    so.rsp_als_chol_wide.argtypes = [args, i, p]
    so.rsp_als_chol_wide.restype = i
    so.rsp_als_chol_wide_info.argtypes = [args, p]
    so.rsp_als_chol_wide_info.restype = i
    # args, max_iter, rel_tol, sweeps (int32, or NULL), scratch, systems a
    # slice, counter, stream
    so.rsp_als_nnls.argtypes = [args, i, f, p, p, i, p, p]
    so.rsp_als_nnls.restype = i
    # d -> floats of scratch a system; d -> systems sweeping at once an SM
    # (both minus a CUDA error past the widest d)
    so.rsp_als_nnls_stride.argtypes = [i]
    so.rsp_als_nnls_stride.restype = i
    so.rsp_als_nnls_inflight.argtypes = [i]
    so.rsp_als_nnls_inflight.restype = i
    # d, B -> floats of scratch past the slice (the wide K4's lhs)
    so.rsp_als_nnls_extra.argtypes = [i, i]
    so.rsp_als_nnls_extra.restype = ctypes.c_longlong
    # the wide K4 (d > 160; rsp_als_nnls runs it): the same arguments and
    # stages (1 the build, 2 + G, 3 + mu, 4 + the sweeps, 5 + the loss)
    # before the stream; info (8 int32: CTAs a system in the build, their
    # shared bytes, build passes, G tiles a system, row stride, sweeping
    # warps an SM, ring bytes, systems an lhs sub-slice)
    so.rsp_als_nnls_wide_staged.argtypes = [args, i, f, p, p, i, p, i, p]
    so.rsp_als_nnls_wide_staged.restype = i
    so.rsp_als_nnls_wide_info.argtypes = [args, p]
    so.rsp_als_nnls_wide_info.restype = i
    # args, plan, mode (1: matvec term of x0, 0: rhs term of g_rhs), stream
    so.rsp_hot_chain.argtypes = [args, plan, i, p]
    so.rsp_hot_chain.restype = i
    # scores, bits, C, n, k, glob_mean, route, list_k, parts, words,
    # out_scores, out_idx, stream
    so.rsp_topk.argtypes = [p, p, i, i, i, f, i, i, i, i, p, p, p]
    so.rsp_topk.restype = i
    # bucket pointers (host int64 array), n_buckets, desc, n_blocks, table,
    # table_bf16, aligned, k, n_rows, chunk, out, stream
    so.rsp_spmm.argtypes = [ctypes.POINTER(ctypes.c_longlong), i, p, i, p, i,
                            i, i, i, i, p, p]
    so.rsp_spmm.restype = i
    # bucket pointers (host int64 array), n_buckets, approx pointers (host
    # int64 array or NULL), desc, n_blocks, rowfac, scale, n_fac, table,
    # table_bf16, aligned, k, n_rows, chunk, proj, sq_part, stream
    so.rsp_spmm_residual.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), i,
        ctypes.POINTER(ctypes.c_longlong), p, i, p, p, i, p, i, i, i, i, i,
        p, p, p]
    so.rsp_spmm_residual.restype = i
    # col, val, nnz, slot, keep, keep_scale, y, sample_w, z, n, pair, feats,
    # order, offs, scratch, U, N, B, L, lr, decay, l1, l2, family,
    # do_update, y_hat, stream
    so.rsp_ftrl_block.argtypes = [p, p, p, p, p, f, p, p, p, p, i, p, p, p,
                                  p, i, i, i, i, f, f, f, f, i, i, p, p]
    so.rsp_ftrl_block.restype = i
    # col, val, nnz, slot, y, sample_w, w0, acc_w0, w, v, acc_w, acc_v,
    # feats, order, offs, scratch, U, N, B, L, r, tpe, G, lr_w, lr_v, lam_w,
    # lam_v, family, intercept, do_update, y_hat, stream
    so.rsp_fm_block.argtypes = ([p] * 16 + [i] * 7 + [f] * 4 + [i] * 3
                                + [p, p])
    so.rsp_fm_block.restype = i
    # args, stages (1 launch A, 2 the batch), stream
    so.rsp_rankmf_batch.argtypes = [ctypes.POINTER(RankMFArgs), i, p]
    so.rsp_rankmf_batch.restype = i
    # S, Fu, Fi, update_items: ints of the bf16 instance's gscratch
    so.rsp_rankmf_group_ints.argtypes = [i, i, i, i]
    so.rsp_rankmf_group_ints.restype = ctypes.c_longlong
    # rows, cols, vals, slot_r, slot_c, feats_r, feats_c, order_r, order_c,
    # bounds_r, bounds_c, N, U_r, U_c, r, w_i, w_j, b_i, b_j, acc_w_i,
    # acc_w_j, acc_b_i, acc_b_j, x_max, alpha, lr, bf16, ordered, the work
    # lists (items_r, n_items_r, multi_r, n_multi_r, the same _c), scratch,
    # loss, stream
    so.rsp_glove_shard.argtypes = [p] * 11 + [i] * 4 + [p] * 8 + [f] * 3 + [
        i, i] + [p, i] * 4 + [p, p, p]
    so.rsp_glove_shard.restype = i
    # r -> the instance width of K10 / K11 that takes it (0: none)
    so.rsp_glove_shard_width.argtypes = [i]
    so.rsp_glove_shard_width.restype = i
    so.rsp_glove_tile_width.argtypes = [i]
    so.rsp_glove_tile_width.restype = i
    ll = ctypes.c_longlong
    # N, U_r, U_c, r, bf16 -> floats of scratch
    so.rsp_glove_shard_scratch.argtypes = [i, i, i, i, i]
    so.rsp_glove_shard_scratch.restype = ll
    # n_r, n_c, r, bf16, state_bf16 -> floats of scratch
    so.rsp_glove_tile_scratch.argtypes = [i, i, i, i, i]
    so.rsp_glove_tile_scratch.restype = ll
    # rows, cols, n_r, n_c, X, row stride, col stride, bf16, state_bf16,
    # the 8 tables, r, x_max, alpha, lr, scratch, loss, S of both sides (or
    # NULL), stream
    so.rsp_glove_tile.argtypes = [p, p, i, i, p, ll, ll, i, i] + [p] * 8 + [
        i, f, f, f, p, p, p, p]
    so.rsp_glove_tile.restype = i
    # table, row stride, col stride, bf16, int32 idx, n, d, out, row
    # stride, col stride, table rows, lane rows per block, lane span, stream
    so.rsp_gather_rows.argtypes = [p, ll, ll, i, p, i, i, p, ll, ll, i, i, i,
                                   p]
    so.rsp_gather_rows.restype = i
    return so


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """Device pointer of a tensor (NULL for None)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_tensor(name: str, t: torch.Tensor, shape, dtype) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this shape and
    dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} is not supported by the "
                        f"CUDA kernel (needs {dtype})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
