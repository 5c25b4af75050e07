"""Profiling and timing harnesses (counterpart of ``pwcnet_tpu/utils/profiling.py``).

- `device_timeit`: mean seconds per call on the device, from CUDA events
  around a run of many calls (PyTorch returns before the device finishes,
  so a host clock without a synchronise would time the enqueue);
- `trace`: context manager around ``torch.profiler`` that writes a Chrome
  trace of the enclosed block;
- `op_profile`: per-kernel device-time table of a function, from
  ``torch.profiler``'s ``key_averages``;
- `flops_estimate`: floating-point operations of one call, counted by
  ``torch.utils.flop_counter``.

The device functions need a CUDA device and raise without one: a CPU time
is not a device metric.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch

__all__ = ["device_timeit", "trace", "op_profile", "flops_estimate"]


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times the GPU and needs a CUDA device")


def device_timeit(fn: Callable, *args, iters: int = 50, warmup: bool = True) -> float:
    """Mean seconds per call of ``fn(*args)`` on the current CUDA device."""
    _require_cuda("device_timeit")
    if warmup:
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Capture a torch.profiler trace of the enclosed block into
    ``<logdir>/trace.json`` (Chrome / Perfetto format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield logdir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def op_profile(fn: Callable, *args, iters: int = 3):
    """Per-kernel device-time table for ``fn(*args)``: rows ``{"name",
    "ms_per_iter", "count"}`` sorted by total time."""
    _require_cuda("op_profile")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    rows = [
        {"name": e.key, "ms_per_iter": e.self_device_time_total / 1e3 / iters, "count": e.count}
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    rows.sort(key=lambda r: -r["ms_per_iter"])
    return rows


def flops_estimate(fn: Callable, *args) -> dict:
    """Operations of one ``fn(*args)`` as ``torch.utils.flop_counter`` counts
    them (matrix products and convolutions of PyTorch's own operators; the
    hand-written kernels are opaque to it). ``bytes_accessed`` is not
    counted by PyTorch and is None."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": counter.get_total_flops(), "bytes_accessed": None}
