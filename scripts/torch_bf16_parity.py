#!/usr/bin/env python3
"""bf16 serving accuracy of pwcnet_tpu_torch in pixels (the counterpart of
scripts/bf16_parity.py).

Runs the default PWCDCNet (6 levels, search range 4, output level 4)
through ``FlowPredictor`` in float32 and in bfloat16 on the same weights
and frames, and measures the bf16 final flow against the float32 one in
pixels, on the kernel path (K1, K2, K3) and on the plain path
(``use_kernels=False``):

- weights: variance-scaled random, std 1/sqrt(fan_in) for conv kernels and
  0.05 for biases, drawn from ``default_rng(seed)`` in the leaf order of
  the flax-named parameter tree (sorted keys, as jax flattens a dict), so
  a seed gives both packages the same weights;
- frames: ``default_rng(42).random((b, h, w, 3))`` for frame 0, then frame
  1, float32 in [0, 1].

Prints one JSON line per (path, shape) with the JAX script's keys and the
card's name and power limit.

    python3 scripts/torch_bf16_parity.py [--height 448 --width 1024 --batch 4] [--device cuda]

On the CPU (``--device cpu``) only the plain path runs: the kernels need
an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sorted_leaves(tree: dict, path=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _sorted_leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def scaled_params(template: dict, seed: int = 0) -> dict:
    """Variance-scaled random weights shaped like ``template`` (nested
    dicts of arrays), drawn as ``scripts/bf16_parity.py`` draws them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, leaf in _sorted_leaves(template):
        shape = np.shape(leaf)
        std = 1.0 / np.sqrt(np.prod(shape[:3])) if len(shape) == 4 else 0.05
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (rng.standard_normal(shape) * std).astype(np.float32)
    return out


def frames(b: int, h: int, w: int):
    """The script's frames: (images_0, images_1), each (b, h, w, 3) float32."""
    import numpy as np

    rng = np.random.default_rng(42)
    images_0 = rng.random((b, h, w, 3)).astype(np.float32)
    images_1 = rng.random((b, h, w, 3)).astype(np.float32)
    return images_0, images_1


def flows(params: dict, images_0, images_1, use_kernels: bool, device, **cfg) -> dict:
    """Final flows {'float32', 'bfloat16'} (numpy float32) of FlowPredictors
    holding ``params`` (a flax-named tree) on ``device``."""
    import numpy as np
    import torch

    from pwcnet_tpu_torch.inference import FlowPredictor
    from pwcnet_tpu_torch.weights import from_jax_params

    state = from_jax_params(params)
    batch = np.stack([images_0, images_1], axis=1)  # floats: taken as normalised
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        pred = FlowPredictor(dtype=dtype, use_kernels=use_kernels, device=device, **cfg)
        pred.model.load_state_dict(state)
        out[str(dtype).replace("torch.", "")] = pred.raw_forward(batch)[0].float().cpu().numpy()
    return out


def stats(f32, f16) -> dict:
    """The JAX script's measures of bf16 against float32 flow, in pixels."""
    import numpy as np

    delta = np.abs(f32 - f16)
    mag = np.sqrt((f32**2).sum(-1))
    return {
        "delta_px_mean": float(delta.mean()),
        "delta_px_p99": float(np.percentile(delta, 99)),
        "delta_px_max": float(delta.max()),
        "epe_bf16_vs_f32": float(np.sqrt(((f32 - f16) ** 2).sum(-1)).mean()),
        "f32_flow_px_mean_mag": float(mag.mean()),
        "f32_flow_px_max_mag": float(mag.max()),
    }


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or 'cpu'."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def measure(path_name: str, h: int, w: int, b: int, use_kernels: bool, device="cuda", seed: int = 0,
            **cfg) -> dict:
    """bf16 against float32 final flow on one path; prints and returns the
    JSON line. ``cfg``: PWCDCNet's configuration (the default model when
    empty)."""
    from pwcnet_tpu_torch.models import PWCDCNet
    from pwcnet_tpu_torch.weights import to_jax_params

    params = scaled_params(to_jax_params(PWCDCNet(**cfg, init=False).state_dict()), seed)
    got = flows(params, *frames(b, h, w), use_kernels, device, **cfg)
    out = {"path": path_name, "shape": f"{h}x{w} b{b}", **stats(got["float32"], got["bfloat16"]),
           "card": card_name(device)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=448)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu for the plain path on the CPU")
        torch.backends.cudnn.allow_tf32 = False  # float32 is the true float32 reference
        torch.backends.cuda.matmul.allow_tf32 = False
        measure("kernels", args.height, args.width, args.batch, True, args.device, args.seed)
    measure("plain", args.height, args.width, args.batch, False, args.device, args.seed)


if __name__ == "__main__":
    main()
