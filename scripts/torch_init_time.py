#!/usr/bin/env python
"""Host time of the port's parameter init and of the entry points that
build a model, at full size (PWCDCNet's defaults: 6 levels, 5 029 868
parameters).

    python scripts/torch_init_time.py [--device cpu] [--repeat 5] [--old <tree>]

Times, each the median of ``--repeat`` runs after one warm-up, host clock
(a CUDA device synchronised after each):

- ``draw``: the init alone on a built model (``weights.init_params`` under
  ``prng.PRNGKey(0)``; in a tree without it, the torch-generator draw);
- ``model``: ``PWCDCNet()``, the draw included; ``model_no_draw``:
  ``PWCDCNet(init=False)`` where the tree has it;
- ``predictor`` / ``predictor_ckpt``: ``FlowPredictor()`` without and with
  a parameter checkpoint;
- ``trainer`` / ``trainer_resume``: ``Trainer`` on a Synthetic set, without
  ``-r`` and with a whole-state checkpoint.

``--old <tree>`` times an earlier checkout too (for example ``git archive
<commit> | tar -x -C tree_check/parent``), each tree in a process of its
own, in turns old, new, new, old. One JSON line a tree and turn, then the
machine: the CPU, or the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def child(device: str, repeat: int) -> dict:
    import torch

    from pwcnet_tpu_torch import weights
    from pwcnet_tpu_torch.inference import FlowPredictor
    from pwcnet_tpu_torch.models import PWCDCNet
    from pwcnet_tpu_torch.train import build_parser
    from pwcnet_tpu_torch.train_lib import create_train_state, save_checkpoint, save_params
    from pwcnet_tpu_torch.train_lib.trainer import Trainer

    has_key = hasattr(weights, "init_params")

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def timed(fn) -> float:
        fn()
        sync()
        out = []
        for _ in range(repeat):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    if has_key:
        from pwcnet_tpu_torch.prng import PRNGKey

        bare = PWCDCNet(init=False)
        draw = lambda: weights.init_params(bare, PRNGKey(0))  # noqa: E731
    else:
        from pwcnet_tpu_torch.models.conv import glorot_init_

        bare = PWCDCNet()
        draw = lambda: glorot_init_(bare, torch.Generator().manual_seed(0))  # noqa: E731
    res = {"parameters": sum(p.numel() for p in bare.parameters()), "draw_s": timed(draw),
           "model_s": timed(lambda: PWCDCNet())}
    if has_key:
        res["model_no_draw_s"] = timed(lambda: PWCDCNet(init=False))
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        params = save_params(Path(tmp) / "params.msgpack", bare.state_dict())
        full = save_checkpoint(Path(tmp) / "model_1.msgpack", create_train_state(PWCDCNet(), device="cpu"))
        res["predictor_s"] = timed(lambda: FlowPredictor(device=device))
        res["predictor_ckpt_s"] = timed(lambda: FlowPredictor(checkpoint=params, device=device))
        argv = ["-d", "Synthetic", "-dd", ".", "-e", "1", "-b", "4", "--crop_type", "none", "--no-visualize",
                "--device", device]
        res["trainer_s"] = timed(lambda: Trainer(build_parser().parse_args(argv)))
        res["trainer_resume_s"] = timed(lambda: Trainer(build_parser().parse_args(argv + ["-r", full])))
    return res


def machine(device: str) -> str:
    if device == "cpu":
        import platform

        return f"CPU {platform.processor() or platform.machine()}, {os.cpu_count()} cores"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0] + f" (host {os.cpu_count()} cores)"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", help="cpu, or cuda (the default)")
    parser.add_argument("--repeat", type=int, default=5)
    parser.add_argument("--old", default=None, help="an earlier checkout to time in turns with this one")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.device, args.repeat)), flush=True)
        return
    trees = [("new", REPO)] if args.old is None else [("old", Path(args.old)), ("new", REPO), ("new", REPO),
                                                     ("old", Path(args.old))]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for label, tree in trees:
        out = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_init_time.py"), "--child", "--device",
                              args.device, "--repeat", str(args.repeat)],
                             cwd=tree, env={**env, "PYTHONPATH": str(tree.resolve())}, capture_output=True,
                             text=True, timeout=1800)
        if out.returncode:
            sys.exit(f"{label} ({tree}) failed:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        print(json.dumps({"tree": label, "path": str(tree), **json.loads(out.stdout.strip().splitlines()[-1])}),
              flush=True)
    print(machine(args.device), flush=True)


if __name__ == "__main__":
    main()
