"""The traced stretch: ``torch.profiler`` over a few units of a cell's own
work, read back from its Chrome trace into the numbers the per-layer
readers take (``Trace``) and the breakdown of the result line.

- device operations are the trace's ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events; a kernel belongs to the first of
  ``kernels.PROFILE_GROUPS`` whose pattern its name holds, and to one of
  three categories: the port's hand-written kernels, cuDNN's convs, and
  the eager tail (every other kernel);
- the window is the harness's ``bench.window`` range, which ends after a
  synchronise; ``busy_s`` is the union of the device operations' intervals
  inside it;
- an idle gap is the time before a device operation in which the device
  ran nothing; it is put down to the innermost host operation that
  launched that device operation (by the trace's correlation ids, on the
  launching thread), the gap after the last one to the closing synchronise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable, Optional

import torch

from benchmark import kernels

__all__ = ["WINDOW", "Trace", "hand_bound", "read_trace", "traced"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read: of the profiled stretch, its pairs,
    window and busy seconds, device seconds by category and group, the
    kernels and copies launched, the hand kernels' least time and the idle
    gaps; of the unprofiled stretch, the pairs a second; the analytic FLOPs
    a pair and the peak of the cell's precision. ``extra`` holds every
    other reading the cell's loop returned, by its name (the stream's
    ``overhead_pct`` and ``p95_ms``): a new reading is a key of a loop and
    a reader that indexes it."""

    pairs: int
    window_s: float
    busy_s: float
    category_s: dict
    group_s: dict
    launches: int
    hand_bound_s: Optional[float]
    rate: float
    flops_per_pair: float
    peak_flops: float
    gaps: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, raw: dict) -> "Trace":
        """The Trace of a loop's traced readings: the named fields, the hand
        kernels' bound from their ``calls`` and ``unit_calls``, the rest in
        ``extra``."""
        raw = dict(raw)
        raw["hand_bound_s"] = hand_bound(raw.pop("calls"), raw.pop("unit_calls"))
        names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        return cls(**{k: raw.pop(k) for k in names if k in raw}, extra=raw)

    def breakdown(self) -> dict:
        top = sorted(self.group_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def category(group: str) -> str:
    if group in kernels.HAND_GROUPS:
        return "hand"
    if group in kernels.CUDNN_GROUPS:
        return "cudnn"
    return "eager"


def _union(intervals) -> float:
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (end - start if end is not None else 0.0)


def _launchers(host: list) -> dict:
    """correlation id -> the innermost host operation around its launch, by
    a sweep over each thread's nested ranges."""
    out = {}
    by_thread = {}
    for e in host:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for events in by_thread.values():
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []
        for e in events:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            corr = (e.get("args") or {}).get("correlation")
            if e["cat"] in ("cuda_runtime", "cuda_driver") and corr is not None:
                ops = [s["name"] for s in stack if s["cat"] in ("cpu_op", "user_annotation") and s["name"] != WINDOW]
                out[corr] = ops[-1] if ops else e["name"]
            stack.append(e)
    return out


def read_trace(events: list) -> dict:
    """The window, busy seconds, device seconds by group and category, the
    device operations counted, and the idle seconds by launching host op."""
    win = next(e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
                  and w0 <= e["ts"] < w1), key=lambda e: e["ts"])
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"]
    launcher = _launchers(host)
    group_s, category_s, gaps = {}, {"hand": 0.0, "cudnn": 0.0, "eager": 0.0, "copy": 0.0}, {}
    end = w0
    for e in dev:
        dur = e.get("dur", 0) * 1e-6
        group = kernels.group_of(e["name"])
        group_s[group] = group_s.get(group, 0.0) + dur
        category_s[category(group) if e["cat"] == "kernel" else "copy"] += dur
        if e["ts"] > end:
            label = launcher.get((e.get("args") or {}).get("correlation"), "unknown")
            gaps[label] = gaps.get(label, 0.0) + (e["ts"] - end) * 1e-6
        end = max(end, e["ts"] + e.get("dur", 0))
    if w1 > end:
        gaps["closing synchronize"] = gaps.get("closing synchronize", 0.0) + (w1 - end) * 1e-6
    busy = _union((e["ts"], min(e["ts"] + e.get("dur", 0), w1)) for e in dev) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6, "busy_s": busy, "group_s": group_s, "category_s": category_s,
        "launches": sum(e["cat"] in ("kernel", "gpu_memcpy") for e in dev), "gaps": gaps,
    }


def traced(work: Callable[[], int], device) -> dict:
    """Run ``work`` (which returns the pairs it processed) under the
    profiler inside the window range, and read the trace, which is written
    under ``TMPDIR`` and deleted. Adds ``pairs`` and ``calls``, the hand
    kernels' launches (the port's counter) during the stretch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pwcnet_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            pairs = work()
            torch.cuda.synchronize(device)
    after = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = read_trace(events)
    out["pairs"] = pairs
    out["calls"] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    return out


def hand_bound(calls: dict, unit_calls: dict) -> Optional[float]:
    """Least seconds of the hand kernels' ``calls`` in the stretch: each
    kernel's launches times the mean bound of its calls in one unit of the
    cell's work. None when no hand kernel ran."""
    total = sum(n * sum(unit_calls[k]) / len(unit_calls[k]) for k, n in calls.items() if k in unit_calls)
    return total if calls else None
