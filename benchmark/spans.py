#!/usr/bin/env python3
"""The program's spans in a traced stretch: which phase of the port holds
the host, and which phase launched each device operation and each idle gap.

The port records spans at its layer boundaries (``pwcnet_tpu_torch.utils.
profiling``: ``serve.*``, ``model.*``, ``step.*``). On, inside an active
``torch.profiler``, each span is also a range named ``pwc/<span>`` in the
trace, on the same clock as the device operations.

- `traced(work, device)`: the stretch of ``tracing.traced`` with the spans
  on. First ``work()`` runs once without the profiler: ``spans``, the
  spans' host-clock reading (free of the profiler's slow-down), and
  ``spans_rate``, that stretch's pairs a second. Then the profiled stretch
  runs with the spans still on. Its trace is read twice: by
  ``tracing.read_trace`` with the program's ranges left out, so that the
  gaps, launches, busy time and breakdown read as ``tracing.traced`` reads
  them, and whole by `read_spans`. Prints the top ten of ``span_device_s``
  and ``span_gaps`` on standard error as ``spans:`` lines.
- `read_spans(events)`: device seconds and idle seconds by the innermost
  program span open when each device operation was launched, and the
  host's waits on the device by the span they began in.

Attribution is by time, not by thread: the backward's kernels are launched
from autograd's device thread, not from the thread that opened
``step.backward``, so a device operation belongs to the innermost program
range open (on the thread that opens spans) at the timestamp of its
launch's runtime event; ``outside`` where none was open, ``unknown``
where its launch is not in the trace. An idle gap belongs to the device
operation that ends it; the gap after the last one, to ``outside``.

``benchmark/run.py`` does not call `traced`. Run as a script, this file runs
one cell's traced run with `traced` in place of ``tracing.traced`` and
prints one JSON line: the check, the cell's per-layer metrics and
breakdown, the span readings and the metrics of `METRICS` read from them:

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> [--turns N]

With ``--turns N`` it first times the traced ``work()`` N times each way,
spans off / on / on / off, without the profiler (``turns``: pairs a
second, by side).
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark import harness, kernels, tracing  # noqa: E402

__all__ = ["PREFIX", "METRICS", "read_spans", "without_program", "traced"]

PREFIX = "pwc/"  # the port's span prefix (``pwcnet_tpu_torch.utils.profiling.PREFIX``)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the per-layer metrics the span readings give, by cell (one reader each in metrics/)
METRICS = {
    "pwcdcnet.stream.bf16": ("forward_enqueue_ms_per_pair.serve", "stream_stage_ms_per_pair.serve",
                             "stream_wait_ms_per_pair.serve"),
    "pwcdcnet.train.f32": ("step_enqueue_ms_per_pair.train", "adam_ms_per_pair.train"),
    "pwcnet.forward.bf16": ("forward_enqueue_ms_per_pair.forward",),
    "pwcdcnet.train.bf16.b64": ("step_enqueue_ms_per_pair.train_bf16", "adam_ms_per_pair.train_bf16"),
}


def _is_program(e: dict) -> bool:
    return e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)


def without_program(events: list) -> list:
    """The trace without the program's ranges: what ``tracing.traced`` reads."""
    return [e for e in events if not _is_program(e)]


def _innermost(ranges: list, stamps: list) -> dict:
    """key -> the innermost of ``ranges`` open at time ``ts``, or None, for
    each ``(ts, key)`` of ``stamps``. A sweep in time order: the ranges
    (sorted by start, the longer first) nest on the thread that opens them,
    so the innermost open one is the last opened that has not ended."""
    owner, stack, i = {}, [], 0
    for ts, key in sorted(stamps):
        while i < len(ranges) and ranges[i]["ts"] <= ts:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= ts:
            stack.pop()
        owner[key] = stack[-1] if stack else None
    return owner


def _name(rng) -> str:
    return rng["name"][len(PREFIX):] if rng is not None else "outside"


def read_spans(events: list) -> dict:
    """Of the window's device operations, by innermost program span at their
    launch: device seconds (``span_device_s``), idle seconds before them
    (``span_gaps``), device seconds by kernel group (``span_group_s``) and
    device seconds launched from a thread other than the span's
    (``span_other_thread_s``); and the host's waits on the device (the
    runtime's ``*Synchronize`` calls, a pageable copy's included) by the
    innermost span open when each began (``span_syncs``: ``[calls,
    seconds]``)."""
    win = next(e for e in events if e.get("name") == tracing.WINDOW and e.get("cat") == "user_annotation")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted((e for e in events if e.get("cat") in tracing.DEVICE_CATS and e.get("ph") == "X"
                  and w0 <= e["ts"] < w1), key=lambda e: e["ts"])
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X" and "correlation" in (e.get("args") or {})}
    syncs = [e for e in events if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X"
             and "Synchronize" in e.get("name", "") and w0 <= e["ts"] < w1]
    ranges = sorted((e for e in events if _is_program(e) and e.get("ph") == "X"),
                    key=lambda e: (e["ts"], -e.get("dur", 0)))
    corrs = {(e.get("args") or {}).get("correlation") for e in dev} & set(launch)
    owner = _innermost(ranges, [(launch[c]["ts"], c) for c in corrs])
    device_s, gaps, group_s, other_s = {}, {}, {}, {}
    end = w0
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        rng = owner.get(corr)
        label = _name(rng) if corr in launch else "unknown"
        dur = e.get("dur", 0) * 1e-6
        device_s[label] = device_s.get(label, 0.0) + dur
        groups = group_s.setdefault(label, {})
        group = kernels.group_of(e["name"])
        groups[group] = groups.get(group, 0.0) + dur
        if rng is not None and launch[corr].get("tid") != rng.get("tid"):
            other_s[label] = other_s.get(label, 0.0) + dur
        if e["ts"] > end:
            gaps[label] = gaps.get(label, 0.0) + (e["ts"] - end) * 1e-6
        end = max(end, e["ts"] + e.get("dur", 0))
    if w1 > end:
        gaps["outside"] = gaps.get("outside", 0.0) + (w1 - end) * 1e-6
    waits = {}
    for k, rng in _innermost(ranges, [(e["ts"], k) for k, e in enumerate(syncs)]).items():
        n_s = waits.setdefault(_name(rng), [0, 0.0])
        n_s[0] += 1
        n_s[1] += syncs[k].get("dur", 0) * 1e-6
    return {"span_device_s": device_s, "span_gaps": gaps, "span_group_s": group_s, "span_other_thread_s": other_s,
            "span_syncs": waits}


def _top(d: dict) -> str:
    return ", ".join(f"{k} {v:.6f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10])


def traced(work, device) -> dict:
    """``tracing.traced``'s readings of ``work`` (which returns the pairs
    it processed), with ``spans``, ``spans_rate`` and `read_spans`' readings."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pwcnet_tpu_torch.ops.cuda import launch_counts
    from pwcnet_tpu_torch.utils import profiling

    profiling.reset()
    profiling.enable(True)
    try:
        t0 = time.perf_counter()
        pairs = work()
        torch.cuda.synchronize(device)
        spans_rate = pairs / (time.perf_counter() - t0)
        spans = profiling.snapshot()
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.WINDOW):
                pairs = work()
                torch.cuda.synchronize(device)
        after = launch_counts()
    finally:
        profiling.enable(False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = tracing.read_trace(without_program(events))
    out.update(read_spans(events))
    out.update(pairs=pairs, calls={k: after[k] - before[k] for k in after if after[k] > before[k]},
               spans=spans, spans_rate=spans_rate)
    print(f"spans: device_s {_top(out['span_device_s'])}", file=sys.stderr)
    print(f"spans: idle_s {_top(out['span_gaps'])}", file=sys.stderr)
    return out


def _turns(work, device, n: int) -> dict:
    """Pairs a second of ``work`` with the spans off and on, in turns."""
    from pwcnet_tpu_torch.utils import profiling

    rates = {"off": [], "on": []}
    try:
        for _ in range(n):
            for side in ("off", "on", "on", "off"):
                profiling.enable(side == "on")
                t0 = time.perf_counter()
                pairs = work()
                torch.cuda.synchronize(device)
                rates[side].append(pairs / (time.perf_counter() - t0))
    finally:
        profiling.enable(False)
        profiling.reset()
    return rates


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--turns", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans reads the card and needs a CUDA device", file=sys.stderr)
        return 2
    from benchmark.run import run_cell

    kept = []

    def stretch(work, device):
        turns = _turns(work, device, args.turns) if args.turns else None
        out = traced(work, device)
        kept.append((out, turns))
        return out

    tracing.traced = stretch
    cell = harness.load_cell(args.workload)
    ctx = harness.Ctx(name=args.workload, cell=cell, seed=args.seed, seconds=args.seconds, trace=True,
                      device=torch.device("cuda", 0), t_start=time.perf_counter())
    result, _, _ = run_cell(ctx)
    raw, turns = kept[0]
    trace = tracing.Trace.of(raw)
    new = {}
    for name in METRICS[args.workload]:
        base = name.split(".")[0]
        reader = harness.load_module(harness.BENCH / "metrics" / f"{base}.py", f"benchmark_metric_{base}")
        new[name] = reader.read(trace)
    line = {"workload": args.workload, "seed": args.seed, "correct": result["correct"], "device": result["device"],
            "metrics": {k: m["value"] for k, m in result["metrics"].items()}, "span_metrics": new,
            "rate": raw["rate"], "spans_rate": raw["spans_rate"], "breakdown": result["breakdown"],
            **{k: raw[k] for k in ("spans", "span_device_s", "span_gaps", "span_group_s", "span_other_thread_s",
                                 "span_syncs")}}
    if turns:
        line["turns"] = turns
        line["spans_on_cost_pct"] = 100.0 * (1.0 - statistics.median(turns["on"]) / statistics.median(turns["off"]))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
