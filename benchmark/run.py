#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pwcnet_tpu_torch`` on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels loaded or built, weights and inputs drawn on
the card from the seed, every shape of the cell warmed up) is timed from
the start of this file to the first timed step. Then the cell's traffic
runs for ``--seconds``; the program's answers are checked against the
plain reference after the window has closed. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``,
each compared number with its limit, which also close standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; if JAX or the JAX package was loaded, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)

import torch  # noqa: E402

from benchmark import harness, tracing  # noqa: E402

T_IMPORTED = time.perf_counter()


def per_layer(cell: dict, raw: dict) -> tuple:
    """The cell's per-layer metrics, read from its traced stretch."""
    trace = tracing.Trace.of(raw)
    out = {}
    for m in cell["per_layer"]:
        base = m["name"].split(".")[0]
        reader = harness.load_module(harness.BENCH / "metrics" / f"{base}.py", f"benchmark_metric_{base}")
        value = reader.read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out, trace


def run_cell(ctx: harness.Ctx) -> tuple:
    """Run the cell and check it: ``(result, checks, readings)``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # the host work is dispatch: fewer threads, less contention between runs
    if ctx.device.type == "cuda":
        from pwcnet_tpu_torch.ops.cuda import _build

        _build.build()  # every kernel library at once, from the checkout's build cache when it holds them
        ctx.mark("kernels built")
    loop = harness.load_module(harness.BENCH / "loops" / f"{ctx.traffic['loop']}.py",
                                 f"benchmark_loop_{ctx.traffic['loop']}")
    outcome = loop.run(ctx)
    ctx.mark("checked")
    correct, checks = harness.judge(outcome.numbers, ctx.cell["limits"])
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": bool(correct and outcome.failed == 0), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": {}, "device": device}
    if ctx.trace:
        result["metrics"], trace = per_layer(ctx.cell, outcome.device_trace)
        device["busy_s"], device["window_s"] = trace.busy_s, trace.window_s
        result["breakdown"] = trace.breakdown()
    else:
        for m in ctx.cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks, {"program": outcome.numbers, **outcome.readings}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: {args.workload} needs {chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    marks = [("python and torch imported", T_IMPORTED - T_START), ("CUDA up", time.perf_counter() - T_START)]
    ctx = harness.Ctx(name=args.workload, cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0), t_start=T_START, marks=marks)
    result, checks, _ = run_cell(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: modules of JAX or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print("phases: " + ", ".join(f"{label} {t:.3f} s" for label, t in ctx.marks), file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
