#!/usr/bin/env python3
"""What a reproducible train step costs on the card: the step of this tree
against the step of an earlier tree, in turns.

    python3 scripts/torch_step_determinism_cost.py --old <root of an earlier checkout>
                                                   [--rounds 2] [--steps 10] [--warmup 3]
                                                   [--out <file.jsonl>]

Each turn is one process that imports ``pwcnet_tpu_torch`` from one tree
and times ``make_train_step`` at 384x448, B=8, float32 parameters, TF32
off, in float32 and bf16 compute, on four of ``chip_smoke.py``'s
``[determinism]`` paths (its models and batch, taken from this tree's
``chip_smoke.py``): the default kernel path, ``use_fused=False`` (the
plain warp, K2 at every level), the nearest warp, and the legacy
``PWCNet`` (6 levels, 'final', BatchNorm under ``train=True``, K2 as its
cost volume). The time of a step is CUDA events around ``--steps`` steps
after ``--warmup`` on one seeded state and batch.
The turns run old, new, new, old in every round; each tree's time is the
median over its turns. In the new tree's turns the three paths that run
the plain warp are also timed with the warp's gather replaced by
``torch.gather`` (whose backward is ``scatter_add_`` with float atomics),
the sorted gather first in the first new turn of a round and second in
the other, to read what the gather alone costs in the step. The first
new turn also runs the gather alone at the four warped levels of the step
(forward and backward of the bilinear and nearest warp, B=8): its time
with either backward and whether two backwards give the same bits.

The old tree's kernels are built from its own sources; where they are the
same as this tree's, the libraries this tree built are copied there first
(same source hash, same file name). Prints one JSON object per turn and a
summary, then the card's name and power limit (``nvidia-smi``). Needs an
NVIDIA card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
PATHS = ("kernels", "unfused", "nearest", "legacy")
GATHER_PATHS = ("unfused", "nearest", "legacy")  # the paths that run the plain warp
# (B, h, w, C) of the warped levels 1-4 of the 384x448 step, deep to fine
WARP_SHAPES = ((BATCH, 12, 14, 128), (BATCH, 24, 28, 96), (BATCH, 48, 56, 64), (BATCH, 96, 112, 32))


def atomic_gather_2d(torch):
    """The plain warp's gather as it was before: ``torch.gather``, whose
    backward is ``scatter_add_`` (float atomics on the card)."""

    def gather(x, yi, xi):
        b, hf, w, c = x.shape
        ho = yi.shape[1]
        idx = (yi * w + xi).reshape(b, ho * w, 1).expand(b, ho * w, c)
        return torch.gather(x.reshape(b, hf * w, c), 1, idx).reshape(b, ho, w, c)

    return gather


def smoke():
    """``chip_smoke.py`` of this tree, as a module: its models and batch."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_ms(torch, cs, path, dtype, images, flows, steps, warmup):
    from pwcnet_tpu_torch.train_lib.step import create_train_state, make_train_step

    model = cs.determinism_model(torch, path, dtype)
    state = create_train_state(model, device=images.device)
    step = make_train_step(model)
    for _ in range(warmup):
        step(state, images, flows)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        step(state, images, flows)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def gather_alone(torch, np, warp_mod, device):
    """The warp's forward + backward at the step's warped levels, with the
    sorted and the atomic gather: ms by CUDA events (20 after 3) and
    whether two backwards give the same bits."""
    sorted_gather, atomic = warp_mod._gather_2d, atomic_gather_2d(torch)
    rng = np.random.default_rng(1)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for warp_type in ("bilinear", "nearest"):
            for shape in WARP_SHAPES:
                x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
                flow = torch.as_tensor((rng.standard_normal(shape[:3] + (2,)) * 3).astype(np.float32)).to(device)
                g = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
                row = {"dtype": str(dtype).split(".")[1], "warp": warp_type, "shape": list(shape)}
                for name, fn in (("sorted", sorted_gather), ("atomic", atomic)):
                    warp_mod._gather_2d = fn
                    a = x.clone().requires_grad_()

                    def once():
                        return torch.autograd.grad(warp_mod.warp(a, flow, warp_type), a, g)[0]

                    first, second = once(), once()
                    row[f"{name}_bitwise"] = bool(torch.equal(first, second))
                    for _ in range(3):
                        once()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(20):
                        once()
                    end.record()
                    torch.cuda.synchronize()
                    row[f"{name}_ms"] = start.elapsed_time(end) / 20
                warp_mod._gather_2d = sorted_gather
                out.append(row)
    return out


def worker(args) -> int:
    sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    import pwcnet_tpu_torch
    from pwcnet_tpu_torch.ops import warp as warp_mod
    from pwcnet_tpu_torch.ops.cuda import _build

    if os.path.dirname(os.path.dirname(os.path.abspath(pwcnet_tpu_torch.__file__))) != os.path.abspath(args.tree):
        raise SystemExit(f"imported {pwcnet_tpu_torch.__file__}, not the package of {args.tree}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    device = torch.device("cuda", 0)
    cs = smoke()
    images, flows = cs.train_batch(torch, np, device, BATCH)
    sorted_gather = warp_mod._gather_2d
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for path in PATHS:
            variants = (("atomic", "sorted") if args.flip else ("sorted", "atomic")) if (
                args.label == "new" and path in GATHER_PATHS) else ("as is",)
            for variant in variants:
                warp_mod._gather_2d = atomic_gather_2d(torch) if variant == "atomic" else sorted_gather
                ms = step_ms(torch, cs, path, dtype, images, flows, args.steps, args.warmup)
                key = f"{path} {dname}" + ("" if variant in ("as is", "sorted") else " atomic gather")
                rows.setdefault(key, []).append(ms)
                torch.cuda.empty_cache()
            warp_mod._gather_2d = sorted_gather
    out = {"tree": args.label, "step_ms": rows}
    if args.gather:
        out["gather_alone"] = gather_alone(torch, np, warp_mod, device)
    print(json.dumps(out), flush=True)
    return 0


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", required=True, help="root of an earlier checkout (holds pwcnet_tpu_torch/)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--out", default=None, help="also append each turn's JSON line here")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--tree", default=HERE, help=argparse.SUPPRESS)
    parser.add_argument("--label", default="new", help=argparse.SUPPRESS)
    parser.add_argument("--gather", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--flip", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args)

    import torch

    if not torch.cuda.is_available():
        print("torch_step_determinism_cost: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pwcnet_tpu_torch.ops.cuda import _build

    _build.build()
    old = os.path.abspath(args.old)
    os.makedirs(os.path.join(old, "pwcnet_tpu_torch", "build"), exist_ok=True)
    for lib in glob.glob(os.path.join(HERE, "pwcnet_tpu_torch", "build", "lib*.so")):
        shutil.copy2(lib, os.path.join(old, "pwcnet_tpu_torch", "build"))
    turns = []
    for r in range(args.rounds):
        for i, (label, tree) in enumerate((("old", old), ("new", HERE), ("new", HERE), ("old", old))):
            cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--old", old, "--tree", tree,
                   "--label", label, "--steps", str(args.steps), "--warmup", str(args.warmup)]
            if r == 0 and i == 1:
                cmd.append("--gather")
            if i == 2:
                cmd.append("--flip")
            done = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
            if done.returncode != 0:
                print(done.stdout + done.stderr, file=sys.stderr)
                raise SystemExit(f"the {label} turn of round {r} failed")
            line = done.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            turns.append(json.loads(line))
    summary = {}
    for label in ("old", "new"):
        ms = {}
        for t in turns:
            if t["tree"] == label:
                for k, v in t["step_ms"].items():
                    ms.setdefault(k, []).extend(v)
        summary[label] = {k: {"median_ms": statistics.median(v), "ms": v} for k, v in ms.items()}
    print(json.dumps({"summary": summary}))
    for key, row in summary["new"].items():
        if key in summary["old"]:
            o, n = summary["old"][key]["median_ms"], row["median_ms"]
            print(f"{key}: new {n:.2f} ms against old {o:.2f} ms ({100 * (n / o - 1):+.1f}%), medians of "
                  f"{len(row['ms'])} / {len(summary['old'][key]['ms'])} turns")
        else:
            base = summary["new"][key.replace(" atomic gather", "")]["median_ms"]
            print(f"{key}: {row['median_ms']:.2f} ms; the sorted gather {base:.2f} ms "
                  f"({100 * (base / row['median_ms'] - 1):+.1f}%), in one process")
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
