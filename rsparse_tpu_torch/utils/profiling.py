"""Per-phase fit telemetry, a profiler trace and a device-time profile.

:class:`FitTrace` is the structured record WRMF fills during a fit
(iteration, phase, loss, wall time).  Kernels launch asynchronously, so on a
CUDA device each phase ends with ``torch.cuda.synchronize`` before the clock
is read; the wall time then covers the device work of the phase.

:func:`profile_device` runs a callable under ``torch.profiler`` and returns
the device time of each kernel and copy, and the device's busy share of the
wall time (``chip_smoke.py`` prints it for the full-width run).

:func:`trace` captures a ``torch.profiler`` trace of a block into one
Chrome trace file (the counterpart of the reference's ``jax.profiler``
trace, rsparse_tpu/utils/profiling.py:26-38); the CLI's ``--profile-dir``
uses it.
"""

from __future__ import annotations

import contextlib
import os
import time
import types
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from ..config import logger


@contextlib.contextmanager
def trace(log_dir: Optional[str],
          cuda: Optional[bool] = None) -> Iterator[types.SimpleNamespace]:
    """Record the block under ``torch.profiler`` (CPU activity, and CUDA
    activity when ``cuda``, by default when a CUDA device is available) and
    write one Chrome trace file, which chrome://tracing, Perfetto and
    TensorBoard's profiler open, into ``log_dir``; its path is logged and
    left in the yielded namespace's ``path``.  With ``log_dir=None`` it
    records nothing (``path`` stays None)."""
    out = types.SimpleNamespace(path=None)
    if not log_dir:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield out
        if cuda:
            torch.cuda.synchronize()
    out.path = os.path.join(
        log_dir, f"rsparse_tpu_torch_{os.getpid()}_{time.time_ns()}"
        ".pt.trace.json")
    prof.export_chrome_trace(out.path)
    logger.info("profiler trace written to %s", out.path)


@dataclass
class FitTrace:
    """Structured per-phase fit telemetry."""

    device: torch.device = torch.device("cpu")
    records: List[Dict[str, Any]] = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, iteration: int, name: str) -> Iterator[Dict[str, Any]]:
        rec: Dict[str, Any] = {"iter": iteration, "phase": name}
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            rec["wall_s"] = time.perf_counter() - t0
            self.records.append(rec)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["phase"]] = out.get(r["phase"], 0.0) + r["wall_s"]
        return out

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)


def _self_device_us(event) -> float:
    # the attribute was renamed from *_cuda_* to *_device_* in torch 2.4
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(event, name, None)
        if v:
            return float(v)
    return 0.0


def profile_device(fn: Callable[[], Any]) -> Dict[str, Any]:
    """Run ``fn()`` twice: once on its own for the host wall time
    (``wall_s``), then under ``torch.profiler`` with CUDA activity only, so
    that host-side tracing does not stretch the wall time it is held to.

    Returns ``wall_s``, the summed device time of every kernel, copy and
    memset of the profiled call (``device_s``; the port issues them on one
    stream, so they do not overlap), ``busy_share = device_s / wall_s``,
    and ``ops``: (name, calls, device ms) per device activity, longest
    first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.count, _self_device_us(e) / 1e3)
                  for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU and _self_device_us(e)),
                 key=lambda r: -r[2])
    device_s = sum(r[2] for r in ops) / 1e3
    return {"wall_s": wall, "device_s": device_s,
            "busy_share": device_s / wall, "ops": ops}
