#!/usr/bin/env python3
"""Time the correlation kernels (K1, K2, K8, K9) and K6 on one NVIDIA GPU.

    python3 scripts/torch_corr_k6_time.py [--dtypes bfloat16 float32] [--profile] [--sweep]

Run from the repository root. Builds the kernels, then prints, with CUDA
events after warm-up and the same helpers and shapes as ``chip_smoke.py``'s
``[time]`` phase: K1 and K2 at every level of the 448x1024 serving forward
(B=8), K6 at both levels of the 384x448 training step (B=8) beside cuDNN's
``conv2d_input`` chain, K8 and K9 at one rank's shard shapes; each beside
its plain version and its bound. ``--profile`` also serves seeded random
weights and prints the forward's device time by kernel (torch.profiler).
``--sweep`` times K1 and K2 at the serving levels (B=8, bf16) under every
tile width and cluster split the kernel takes, in place of the plan's own
choice (device time per launch, torch.profiler).
The card's name and power limit (nvidia-smi) head the output.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from pwcnet_tpu_torch.ops.cuda import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtypes", nargs="*", default=["bfloat16", "float32"])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_corr_k6_time: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs.log_build(_build.build(["cost_volume", "warped_cv", "pyramid_conv_bwd", "pyramid_conv", "estimator_conv"]))
    device = torch.device("cuda", 0)
    for name in args.dtypes:
        dtype = getattr(torch, name)
        rows, _ = cs.time_kernels(torch, F, device, dtype=dtype)
        rows.update(cs.time_training_kernels(torch, device, dtype=dtype))
        rows.update(cs.time_shard_kernels(torch, F, device, dtype=dtype))
        for kid in ("K1", "K2", "K6", "K8", "K9"):
            rs = rows[kid]
            lib = [r["library_ms"] for r in rs]
            print(f"  {kid} {name} summed: kernel {sum(r['ms'] * r['times'] for r in rs):.4f} ms, "
                  f"bound {sum(r['bound_ms'] * r['times'] for r in rs):.4f} ms, library "
                  f"{None if None in lib else round(sum(v * r['times'] for v, r in zip(lib, rs)), 4)} ms",
                  flush=True)
    if args.sweep:
        sweep(torch, device)
    if args.profile:
        _, pairs, pred, batch = cs.serve(torch, np, device)
        cs.profile_steps(torch, lambda: pred.raw_forward(batch), 3, "forwards at 448x1024 B=8 bf16",
                         8e3 / pairs["bfloat16 kernels"])
    return 0


def device_ms(torch, fn, name, iters=10):
    """Device time per launch of the kernels whose name holds ``name``
    (torch.profiler), over ``iters`` calls of ``fn`` after a warm-up: the
    kernel's own time, whatever the host adds around it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and name in e.key]
    return sum(e.self_device_time_total for e in evs) / 1e3 / max(1, sum(e.count for e in evs))


def sweep(torch, device):
    """K1 and K2 at the serving levels (B=8, bf16) under each tile width and
    split the kernel takes: device time per launch."""
    import chip_smoke as cs
    from pwcnet_tpu_torch.ops.cuda import _common
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

    plan = _common.correlation_plan
    gen = torch.Generator(device=device).manual_seed(1)
    try:
        with torch.inference_mode():
            for kid, shapes in (("K2", cs.K2_SHAPES), ("K1", cs.K1_SHAPES)):
                for h, w, c in shapes:
                    a = (cs.k2_inputs if kid == "K2" else cs.k1_inputs)(torch, 8, h, w, c, torch.bfloat16, device, gen)
                    fn = cost_volume_cuda if kid == "K2" else warped_cost_volume
                    times = {}
                    for tw in (16, 32):
                        for split in _common.CORR_SPLITS:
                            _common.correlation_plan = lambda w_, c_, t=tw, s=split: (t, s)
                            times[tw, split] = device_ms(torch, lambda: fn(*a, cs.SEARCH_RANGE), "correlation_kernel")
                    _common.correlation_plan = plan
                    print(f"  sweep {kid} bfloat16 8x{h}x{w}x{c} device ms: plan {plan(w, c)}; "
                          + ", ".join(f"tw {t} split {k} {v:.4f}" for (t, k), v in times.items()), flush=True)
    finally:
        _common.correlation_plan = plan


if __name__ == "__main__":
    sys.exit(main())
