"""ctypes binding for the native host runtime (``native/librsparse_host.so``).

The library is framework-neutral C++ with OpenMP; the port loads it through
its own loader and binds two of its functions: the padded-bucket fill
(:func:`fill_bucket`; without the library ``sparse/device.py`` fills in
numpy) and the interaction-log parser (:func:`parse_interactions_bytes`,
which falls back to ``numpy.genfromtxt``).
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
    lib.parse_interactions.argtypes = [ctypes.c_char_p, i64, ctypes.c_char,
                                       ctypes.c_int, i32p, i32p, f32p, i64]
    lib.parse_interactions.restype = i64
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


def parse_interactions_bytes(buf: bytes, sep: str = ",",
                             skip_header: bool = True):
    """Parse ``user<sep>item[<sep>rating]`` lines with integer ids into COO
    arrays ``(users int32, items int32, ratings float32, parser)``, where
    ``parser`` is "native" (the library's OpenMP parser) or "numpy"
    (``numpy.genfromtxt``, when the library is missing).  A missing rating
    reads 1; a line whose ids do not parse as integers is skipped, so a log
    of string ids gives empty arrays (``data/io.py`` then tokenizes it)."""
    lib = get_lib()
    n_lines = buf.count(b"\n") + 1
    if lib is not None:
        users = np.empty(n_lines, np.int32)
        items = np.empty(n_lines, np.int32)
        ratings = np.empty(n_lines, np.float32)
        n = lib.parse_interactions(buf, len(buf), sep.encode()[0],
                                   int(skip_header), users, items, ratings,
                                   n_lines)
        if n >= 0:
            return (users[:n].copy(), items[:n].copy(), ratings[:n].copy(),
                    "native")
    import io
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # "empty input" on an empty log
        arr = np.genfromtxt(io.BytesIO(buf), delimiter=sep,
                            skip_header=1 if skip_header else 0)
    arr = np.atleast_2d(arr)
    if arr.size == 0:
        arr = np.empty((0, 2))
    arr = arr[~np.isnan(arr[:, :2]).any(axis=1)]
    r = (np.nan_to_num(arr[:, 2], nan=1.0) if arr.shape[1] > 2
         else np.ones(len(arr))).astype(np.float32)
    return (arr[:, 0].astype(np.int32), arr[:, 1].astype(np.int32), r,
            "numpy")
