"""Configuration of rsparse_tpu_torch: precision names, dtypes, logger.

Mirrors ``rsparse_tpu/config.py`` with torch dtypes.  The reference's
precision vocabulary ("double"/"float", reference R/model_WRMF.R:102) maps
to float64/float32, and "bfloat16"/"bf16" to bfloat16, which WRMF, RankMF and
GloVe take so far (:func:`resolve_full_dtype` is what the other models call;
ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
from typing import Union

import numpy as np
import torch

logger = logging.getLogger("rsparse_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] [%(asctime)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("RSPARSE_TPU_LOGLEVEL", "WARNING").upper())

_PRECISIONS = {
    "double": torch.float64,
    "float": torch.float32,
    "float64": torch.float64,
    "float32": torch.float32,
}


def resolve_dtype(precision: Union[str, torch.dtype]) -> torch.dtype:
    """Resolve a precision name or torch dtype to float32, float64 or
    bfloat16."""
    if isinstance(precision, torch.dtype):
        dt = precision
    elif precision in ("bfloat16", "bf16"):
        dt = torch.bfloat16
    else:
        try:
            dt = _PRECISIONS[precision]
        except KeyError:
            raise ValueError(
                f"unknown precision {precision!r}; one of {sorted(_PRECISIONS)}"
            ) from None
    if dt not in (torch.float32, torch.float64, torch.bfloat16):
        raise NotImplementedError(
            f"precision {dt} is not ported yet (see ROADMAP.md)")
    return dt


def resolve_full_dtype(precision: Union[str, torch.dtype]) -> torch.dtype:
    """:func:`resolve_dtype` for the models that keep their state at float32
    or float64: ``precision="bfloat16"`` is ported for WRMF, RankMF and
    GloVe only."""
    dt = resolve_dtype(precision)
    if dt == torch.bfloat16:
        raise NotImplementedError(
            "precision bfloat16 is ported for WRMF, RankMF and GloVe only, "
            "not for this model yet (see ROADMAP.md)")
    return dt


def default_device_count() -> int:
    """Devices a mesh could span in this process's node: the CUDA cards
    it sees, 1 without any (rsparse_tpu/config.py)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype for losses and Grams: never below float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy counterpart of a torch dtype: float64, else float32 (numpy has
    no bfloat16; values are rounded when they reach the device)."""
    return np.dtype(np.float64 if dtype == torch.float64 else np.float32)


def bf16_value(v: float) -> float:
    """A Python scalar rounded to bf16 through float32: the value a weakly
    typed scalar (or one the JAX package stores at the table dtype) takes
    at bf16."""
    return float(torch.tensor(float(v), dtype=torch.float32).to(
        torch.bfloat16))


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to bf16 and kept as float32: one op of the JAX
    package's bf16 arithmetic (computed at float32, rounded)."""
    return t.to(torch.bfloat16).float()


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 once, to nearest even, from any float
    dtype.  torch's float64 -> bfloat16 cast rounds through float32, which
    sends a value within a float32 rounding of a bf16 midpoint the other
    way; here float64 goes to float32 by rounding to odd (inexact results
    keep a set last bit), from which the float32 -> bf16 rounding is the
    single rounding (float32 keeps more than two bits beyond bf16's)."""
    if t.dtype != torch.float64:
        return t.to(torch.bfloat16)
    f = t.to(torch.float32)
    fd = f.to(torch.float64)
    inexact = fd != t
    away = inexact & (fd.abs() > t.abs())
    bits = f.view(torch.int32) - away.to(torch.int32)
    bits = bits | inexact.to(torch.int32)
    return bits.view(torch.float32).to(torch.bfloat16)
