"""Build and bind the port's hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface for ``sm_90a`` (Hopper), at first use, into
``build/rsparse_tpu_torch/`` beside the package.  The library's file name
carries a hash of the sources and flags, so an edit triggers a rebuild.
It is loaded with ctypes: each C entry takes raw device pointers and the
CUDA stream, launches on that stream and returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Nothing here runs at import: the CPU tests import every module of the port
on machines without ``nvcc``.

``launches`` counts the launches of each kernel; the wrappers in
``ops/als.py`` and ``ops/topk.py`` add one where they launch.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

#: largest rank the ALS kernels take (K2 holds a d x d lhs in shared memory;
#: the per-lane register budgets in csrc/*.cu are sized for it)
MAX_D = 128

#: launches per kernel, counted by the wrappers
launches: Dict[str, int] = {"als_cg": 0, "als_chol": 0, "topk": 0}
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
    tmp = f"{so}.{os.getpid()}.tmp"
    cus = [p for p in _sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({out.returncode}):\n{out.stdout}\n{out.stderr}")
    os.replace(tmp, so)
    build_info.update(seconds=seconds, log=out.stdout + out.stderr, path=so)
    logger.info("built %s in %.1f s", so, seconds)
    return so


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    so = ctypes.CDLL(_build())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # V, col, val, nnz, B, L, d, XtX, rhs_init, then the kernel's own
    so.rsp_als_cg.argtypes = [p, p, p, p, i, i, i, p, p,
                              p, p, p, i, f, f, i, f, p, p, p]
    so.rsp_als_cg.restype = i
    so.rsp_als_chol.argtypes = [p, p, p, p, i, i, i, p, p, f, f, p, p, p]
    so.rsp_als_chol.restype = i
    # scores, bits, C, n, k, glob_mean, out_scores, out_idx, stream
    so.rsp_topk.argtypes = [p, p, i, i, i, f, p, p, p]
    so.rsp_topk.restype = i
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
