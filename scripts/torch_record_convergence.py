#!/usr/bin/env python
"""Record the port's SyntheticFlow convergence curve, and the sweep of
JAX keys behind the card's convergence proof.

    python scripts/torch_record_convergence.py [--device cpu] [--seed S]
    python scripts/torch_record_convergence.py --device cpu --sweep 0 1 2 3 4 5 6 7 8
    python scripts/torch_record_convergence.py --device cpu --seed S --cases

The default run trains the multiscale float32 configuration of the proof
(``pwcnet_tpu_torch/train_lib/convergence.py``) for 600 steps from the
parameters that the JAX package's ``PRNGKey(S)`` init draws (the port
draws them without JAX, bit for bit: ``convergence.jax_init``), logs the loss
and EPE of the training batch every 10 steps and writes
``docs/torch_convergence_synthetic.csv`` and ``.pdf`` (the JAX package's
curve, ``docs/convergence_synthetic.*``, stays as it is). The PDF needs
matplotlib; without it the script says so and writes the CSV alone.

``--sweep`` trains the same configuration for 400 steps from each key
given and prints each seed's full-set EPE (``--json`` writes the table).
``--cases`` runs the proof's four cases from ``--seed`` and prints each
one's full-set EPE and seconds. ``--device`` is CUDA unless ``cpu`` is
asked; on CUDA ``--kernels`` runs the hand-written kernels.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STEPS, LOG_EVERY, SWEEP_STEPS = 600, 10, 400
DEFAULT_SEED = 0  # the JAX proof's PRNGKey(0), chip_smoke.py's [converge] key


def record(conv, device, seed, use_kernels):
    import torch

    dset = conv.dataset()
    state = conv.start_state(conv.jax_init(seed), device, use_kernels=use_kernels)
    rows = []

    def log_step(i, m):
        if (i + 1) % LOG_EVERY == 0:
            rows.append((i + 1, float(m["loss"]), float(m["epe"])))
            print(f"step {i + 1}: loss {rows[-1][1]:.4f} epe {rows[-1][2]:.4f}", flush=True)

    t0 = time.perf_counter()
    state = conv.train(state, conv.batches(dset), STEPS, on_step=log_step)
    epe = conv.full_set_epe(state.model, dset)
    print(f"seed {seed}: full-set EPE {epe:.4f} px after {STEPS} steps in {time.perf_counter() - t0:.1f} s "
          f"({device}{where(device)}, torch {torch.__version__})")
    docs = REPO / "docs"
    with open(docs / "torch_convergence_synthetic.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "train_loss", "train_epe_px"])
        w.writerows(rows)
    print(f"wrote {docs / 'torch_convergence_synthetic.csv'}")
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {docs / 'torch_convergence_synthetic.pdf'} not written")
        return
    matplotlib.use("Agg")
    plot(rows, docs / "torch_convergence_synthetic.pdf", seed, device)
    print(f"wrote {docs / 'torch_convergence_synthetic.pdf'}")


def plot(rows, path, seed, device):
    import matplotlib.pyplot as plt

    steps = [r[0] for r in rows]
    ink, muted, grid = "#1f2430", "#5c6470", "#e3e6ea"
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(6.0, 4.6), sharex=True, constrained_layout=True)
    # two measures of different scale: two stacked panels, never dual axes
    for ax, ys, color, title in (
        (ax1, [r[1] for r in rows], "#4063d8", "training loss (multiscale + weight decay)"),
        (ax2, [r[2] for r in rows], "#8549ba", "training EPE (px)"),
    ):
        ax.plot(steps, ys, color=color, linewidth=2)
        ax.set_title(title, loc="left", fontsize=10, color=ink)
        ax.grid(True, color=grid, linewidth=0.8)
        ax.set_axisbelow(True)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
        for spine in ("left", "bottom"):
            ax.spines[spine].set_color(muted)
        ax.tick_params(colors=muted, labelsize=8)
    ax2.axhline(0.5, color=muted, linewidth=1, linestyle="--")
    ax2.annotate("0.5 px test threshold", (steps[0], 0.5), textcoords="offset points", xytext=(2, 4),
                 fontsize=8, color=muted)
    ax2.set_xlabel("step", fontsize=9, color=muted)
    fig.suptitle(f"port PWCDCNet on SyntheticFlow: 16 samples, 32x32, b8, lr 1e-3, seed {seed}, {device}",
                 fontsize=10, color=ink)
    fig.savefig(path)


def where(device) -> str:
    """The CPU's thread count (the float order of its sums), or the card's
    name and power limit."""
    import subprocess

    import torch

    if device.type != "cuda":
        return f", {torch.get_num_threads()} threads"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return f", {out.stdout.strip().splitlines()[0] if out.returncode == 0 else torch.cuda.get_device_name(0)}"


def sweep(conv, device, seeds, use_kernels, json_path):
    dset = conv.dataset()
    table = []
    for seed in seeds:
        t0 = time.perf_counter()
        state = conv.train(conv.start_state(conv.jax_init(seed), device, use_kernels=use_kernels),
                           conv.batches(dset), SWEEP_STEPS)
        epe = conv.full_set_epe(state.model, dset)
        table.append({"seed": seed, "epe": epe, "converged": epe < conv.EPE_TARGET,
                      "seconds": time.perf_counter() - t0})
        print(f"seed {seed}: full-set EPE {epe:.4f} px after {SWEEP_STEPS} multiscale float32 steps "
              f"({'converged' if epe < conv.EPE_TARGET else 'not converged'}) in {table[-1]['seconds']:.1f} s "
              f"({device}{where(device)})", flush=True)
    if json_path:
        Path(json_path).write_text(json.dumps({"device": str(device), "steps": SWEEP_STEPS, "sweep": table}))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED, help="the init's JAX key, PRNGKey(S)")
    parser.add_argument("--kernels", action="store_true", help="the hand-written kernels (CUDA only)")
    parser.add_argument("--sweep", type=int, nargs="+", help="JAX keys to sweep (400 multiscale float32 steps each)")
    parser.add_argument("--cases", action="store_true", help="the proof's four cases from --seed")
    parser.add_argument("--json", default=None, help="write the sweep's or the cases' table here")
    args = parser.parse_args(argv)

    import torch

    from pwcnet_tpu_torch.inference import resolve_device
    from pwcnet_tpu_torch.train_lib import convergence as conv

    device = resolve_device(args.device)
    if args.kernels and device.type != "cuda":
        parser.error("--kernels runs on CUDA only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.sweep:
        sweep(conv, device, args.sweep, args.kernels, args.json)
    elif args.cases:
        res = conv.run_cases(conv.jax_init(args.seed), device, use_kernels=args.kernels)
        for name, r in res.items():
            print(f"seed {args.seed} {name}: {r['steps']} steps, full-set EPE {r['epe']:.4f} px, "
                  f"{r['seconds']:.1f} s ({device}{where(device)})")
        if args.json:
            cases = {name: {k: v for k, v in r.items() if k != "params"} for name, r in res.items()}
            Path(args.json).write_text(json.dumps({"device": str(device), "seed": args.seed, "cases": cases}))
    else:
        record(conv, device, args.seed, args.kernels)


if __name__ == "__main__":
    main()
