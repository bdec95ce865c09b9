"""ctypes binding for the native host runtime (``native/librsparse_host.so``).

The library is framework-neutral C++ (padded-bucket fill with OpenMP); the
port loads it through its own loader.  Only ``fill_bucket`` is bound.  When
the library is missing or cannot be loaded, callers use the numpy fallback
in ``sparse/device.py``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

from .config import logger

_SO_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "librsparse_host.so")


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if it is missing or unloadable."""
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        logger.warning("native library load failed: %s", e)
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.fill_bucket_f32.argtypes = [i64p, i32p, f64p, i64p, i64, i64, i64,
                                    i64, i32p, f32p, i32p, i32p]
    lib.fill_bucket_f32.restype = None
    lib.fill_bucket_f64.argtypes = [i64p, i32p, f64p, i64p, i64, i64, i64,
                                    i64, i32p, f64p, i32p, i32p]
    lib.fill_bucket_f64.restype = None
    return lib


def fill_bucket(indptr, indices, data, rows, B: int, L: int,
                n_rows_total: int, val_dtype) -> Optional[tuple]:
    """Native padded-bucket fill: ``(col_idx, values, nnz, row_ids)`` numpy
    arrays, or None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    rows = np.ascontiguousarray(rows, np.int64)
    col_idx = np.empty((B, L), np.int32)
    nnz = np.empty((B,), np.int32)
    row_ids = np.empty((B,), np.int32)
    if np.dtype(val_dtype) == np.float64:
        values = np.empty((B, L), np.float64)
        fill = lib.fill_bucket_f64
    else:
        values = np.empty((B, L), np.float32)
        fill = lib.fill_bucket_f32
    fill(indptr, indices, data, rows, len(rows), B, L, n_rows_total,
         col_idx, values, nnz, row_ids)
    return col_idx, values, nnz, row_ids
