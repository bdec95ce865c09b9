"""Row gather ``out[i, :] = table[idx[i], :]``: K12 (``csrc/gather.cu``).

The counterpart of the JAX package's gather probes, the Pallas kernels of
scripts/exp_gather.py and scripts/exp_gather2.py.  It measures the card's
random row-read rate, which bounds the port's sparse kernels; no model
calls it.  :func:`_gather_rows_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _kernels

#: widest row K12 takes (csrc/gather.cu)
MAX_D = 512


def _gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`gather_rows`."""
    rows = table[idx.long()]
    if out is None:
        return rows
    out.copy_(rows)
    return out


def _layout(table: torch.Tensor, out: torch.Tensor) -> Optional[str]:
    """K12's layout for these strides (csrc/gather.cu), or None: "vector"
    with unit column strides and 16-byte aligned rows, "lanes" with unit
    row strides (a transposed table and output)."""
    es = table.element_size()
    if (table.stride(1) == 1 and out.stride(1) == 1
            and all((v * es) % 16 == 0 for v in
                    (table.shape[1], table.stride(0), out.stride(0)))
            and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0):
        return "vector"
    if table.stride(0) == 1 and out.stride(0) == 1:
        return "lanes"
    return None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[idx]`` for a 2-D float32 or bfloat16 ``table`` of at most
    ``MAX_D`` columns and 1-D int32 indices, which must lie in
    ``[0, len(table))`` (not checked: that would read them back).  ``out``
    ((n, d), the table's dtype) receives the rows; without it a contiguous
    tensor is returned.  The table and ``out`` have unit column strides and
    16-byte aligned rows, or both unit row strides (P2's lane gather on a
    transposed table, written into a transposed output in place); any other
    layout raises.  CPU tensors take the plain version; CUDA tensors launch
    K12."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError("expected a 2-D table and 1-D indices")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table: dtype {table.dtype} is not supported "
                        "(float32 or bfloat16)")
    if idx.dtype != torch.int32 or idx.device != table.device \
            or not idx.is_contiguous():
        raise ValueError("idx must be contiguous int32 on the table's "
                         "device")
    n, d = idx.shape[0], table.shape[1]
    if d > MAX_D:
        raise NotImplementedError(f"gather_rows takes d <= {MAX_D}, got {d}")
    if out is None:
        out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    elif (tuple(out.shape) != (n, d) or out.dtype != table.dtype
            or out.device != table.device):
        raise ValueError(f"out must be ({n}, {d}) {table.dtype} on "
                         f"{table.device}")
    if _layout(table, out) is None:
        raise ValueError("gather_rows takes a table and out with unit "
                         "column strides and 16-byte aligned rows, or both "
                         "with unit row strides")
    if table.device.type == "cpu":
        return _gather_rows_plain(table, idx, out)
    rc = _kernels.lib().rsp_gather_rows(
        _kernels.ptr(table), table.stride(0), table.stride(1),
        int(table.dtype == torch.bfloat16), _kernels.ptr(idx), n, d,
        _kernels.ptr(out), out.stride(0), out.stride(1),
        _kernels.stream(table.device))
    _kernels.check(rc, "gather")
    _kernels.launches["gather"] += 1
    return out
