#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control 12 --faults 3 --seconds 10 [--first <seed>]

For each of ``--seeds`` seeds, one process runs the cell as ``run.py``
does, with a short window at the cell's own load, and prints the numbers
its check compares (the lower readings). For the first ``--control``
seeds it also reads, on the same answers, the control (the plain reference
one precision below the cell's, in the program's place: fp8 for bfloat16,
TF32 for float32), and for the first ``--faults`` seeds, in the train
cells, the reference with half of each batch left out (upper readings)
and the reference with its weights moved by 1e-7 of themselves (what
rounding alone does to each number). A train cell's window sets how far
its last steps lie from the start, so give it the cell's own.
One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--first", type=int, default=3_000_000_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate reads the card and needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        readings = (("control",) if i < args.control else ()) + (("half", "jitter") if i < args.faults else ())
        ctx = harness.Ctx(name=args.workload, cell=cell, seed=seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda", 0), t_start=time.perf_counter(), readings=readings)
        t0 = time.perf_counter()
        result, _, extra = run_cell(ctx)
        line = {"workload": args.workload, "seed": seed, "readings": extra, "correct": result["correct"],
                "seconds": time.perf_counter() - t0, "metrics": {k: m["value"] for k, m in result["metrics"].items()}}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
