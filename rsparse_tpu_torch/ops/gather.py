"""Row gather ``out[i, :] = table[idx[i], :]``: K12 (``csrc/gather.cu``).

The counterpart of the JAX package's gather probes, the Pallas kernels of
scripts/exp_gather.py and scripts/exp_gather2.py.  It measures the card's
random row-read rate, which bounds the port's sparse kernels, and it is
the owner's row gather of the routed ALX exchange
(``parallel/routing.py``).  :func:`_gather_rows_plain` is its plain
PyTorch version.  The lane layout (P2's transposed gather) stages rows of
the transposed table in shared memory when they fit; :func:`lane_plan`
picks its case.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import _kernels

#: widest row K12 takes (csrc/gather.cu)
MAX_D = 512
#: the H100's shared memory per block (opt-in) and SM count, for plans made
#: off the card
H100_SMEM_BYTES = 232_448
H100_SMS = 132


class LanePlan(NamedTuple):
    """How K12 runs the lane layout ``outT[:, j] = tabT[:, idx[j]]`` (tabT
    (d, N), n indices): ``case`` "staged" copies ``rt`` rows of tabT into
    shared memory per block and walks ``span`` indices, on a grid of
    ``row_groups`` x ``n_spans`` blocks, reading idx ``row_groups`` times;
    "elementwise" (a row of tabT longer than shared memory) reads one
    random element per output, and the other fields are 0."""

    case: str
    rt: int
    span: int
    row_groups: int
    n_spans: int
    smem_bytes: int


def lane_plan(n: int, d: int, n_tab: int, elem_size: int,
              sms: int = H100_SMS,
              smem_bytes: int = H100_SMEM_BYTES) -> LanePlan:
    """K12's plan for the lane layout.  rt rows of tabT a block: as many as
    leave room for two blocks an SM, so that one block's staging overlaps
    the other's gather, else the one row that fits (d = 128 at N = 32,768:
    bf16 1 row of 64 KB, two or three blocks an SM; f32 1 row of 128 KB,
    one block); spread evenly over the row groups.  Then the span: with
    two blocks an SM, twice the table's length (many short blocks, each
    staging what it reads about twice over); with one, at least two waves
    of ``sms`` blocks, chosen for the fullest last wave (few long blocks,
    each staging once); a multiple of the 16-byte vector."""
    row = max(n_tab * elem_size, 1)
    if row > smem_bytes or n <= 0:
        return LanePlan("elementwise", 0, 0, 0, 0, 0)
    rt = min(d, max(1, smem_bytes // 2 // row))
    groups = math.ceil(d / rt)
    rt = math.ceil(d / groups)
    vec = 16 // elem_size
    if 2 * rt * row <= smem_bytes:
        span = 2 * n_tab
    else:
        s_min = max(1, math.ceil(2 * sms / groups))
        best = max(range(s_min, 2 * s_min + 1),
                   key=lambda s: (groups * s / (math.ceil(groups * s / sms)
                                                * sms), -s))
        span = math.ceil(n / best)
    span = max(vec, math.ceil(span / vec) * vec)
    return LanePlan("staged", rt, span, groups, math.ceil(n / span),
                    rt * row)


def _device_limits(device: torch.device):
    """(SMs, shared memory per block) of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", H100_SMEM_BYTES))


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
    K12 (the lane layout in the case :func:`lane_plan` picks, counted as
    ``gather_lanes``)."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError("expected a 2-D table and 1-D indices")
    if table.dtype not in (torch.float32, torch.bfloat16) and not (
            table.dtype == torch.float64 and table.device.type == "cpu"):
        raise TypeError(f"table: dtype {table.dtype} is not supported "
                        "(float32 or bfloat16; float64 on the CPU)")
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
    layout = _layout(table, out)
    if layout is None:
        raise ValueError("gather_rows takes a table and out with unit "
                         "column strides and 16-byte aligned rows, or both "
                         "with unit row strides")
    if table.device.type == "cpu":
        return _gather_rows_plain(table, idx, out)
    plan, name = None, "gather"
    if layout == "lanes":
        sms, smem = _device_limits(table.device)
        plan = lane_plan(n, d, table.shape[0], table.element_size(), sms,
                         smem)
        name = "gather_lanes"
    rc = _kernels.lib().rsp_gather_rows(
        _kernels.ptr(table), table.stride(0), table.stride(1),
        int(table.dtype == torch.bfloat16), _kernels.ptr(idx), n, d,
        _kernels.ptr(out), out.stride(0), out.stride(1), table.shape[0],
        0 if plan is None else plan.rt, 0 if plan is None else plan.span,
        _kernels.stream(table.device))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out
