"""RAFT's offline batch serving of clips already on the card:
``make_forward(RAFT(iters).to(dtype))(images_0, images_1)`` back to back
on a pool of seeded device-resident batches of consecutive frames, cycled;
the flows stay on the card.

The rate is the pairs of all forwards issued in the window over the window,
which ends in a synchronise. The traced run (``spans.traced``, the port's
spans on) times one stretch the same way and then profiles a few forwards;
it adds the least seconds a pair of the lookups and of the correlation
volume (``raft_work``), which the rooflines set against the device seconds
of ``model.lookup`` and ``model.corr``.

Weights: ``harness.draw_weights`` on the reference's parameters; cnet's
BatchNorm scales at ``BN_SCALE`` of their draw, its running means ``0.1
N(0, 1)`` and variances ``0.5 + U(0, 1)`` from the seed (the identity
would hide a model that ignores them); and ``update_block.flow_head.conv2``
at ``FLOW_HEAD_SCALE`` of its draw, which keeps the final flows inside the
frame (at the full draw they leave it within a few updates, and every
lookup would read zeros).

The check: the final flows of a sample of the window's forwards, drawn from
the seed, against the plain reference in float32 on the same frames and
weights, over the gap of the reference with its convs' operands rounded to
the cell's precision.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import harness, kernels, raft_work, spans
from benchmark.reference import raft as reference

FLOW_HEAD_SCALE = 1 / 16  # a power of two: the scaled draw is still exact in bf16
BN_SCALE = 0.5**0.5  # BatchNorm scales: variance 1, not He's 2 (the conv after the ReLU has He's factor)
FLOW_HEAD = ("update_block.flow_head.conv2.weight", "update_block.flow_head.conv2.bias")


def draw(ref: torch.nn.Module, ctx: harness.Ctx, dtype) -> dict:
    """The parameters and the BatchNorm running statistics of the cell's
    seed, by the reference's names, in ``dtype``."""
    tensors = harness.draw_weights(ref, ctx.gen(0), ctx.device, dtype)
    for k in FLOW_HEAD:
        tensors[k] = tensors[k] * FLOW_HEAD_SCALE
    g = ctx.gen(2)
    for name, norm in ref.named_modules():
        if isinstance(norm, torch.nn.BatchNorm2d):
            c, dev = norm.num_features, ctx.device
            tensors[f"{name}.weight"] = tensors[f"{name}.weight"] * BN_SCALE
            tensors[f"{name}.running_mean"] = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
            tensors[f"{name}.running_var"] = (0.5 + torch.rand(c, generator=g, device=dev)).to(dtype)
    return tensors


def load(model: torch.nn.Module, tensors: dict) -> None:
    """Copy ``tensors`` into ``model`` by name; a shortcut norm is named
    twice (``norm3``, ``downsample.1``) and loads through either name."""
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    unset = [k for k in missing if not k.endswith("num_batches_tracked") and ".downsample.1." not in k]
    if unexpected or unset:
        raise KeyError(f"state mismatch: unexpected {unexpected}, missing {unset}")


def build(cfg: dict, dtype, dev):
    from pwcnet_tpu_torch.models.raft import RAFT

    return RAFT(iters=cfg["iters"]).to(device=dev, dtype=dtype)


def run(ctx: harness.Ctx) -> harness.Outcome:
    from pwcnet_tpu_torch.train_lib.step import make_forward

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    h, w, b = tr["height"], tr["width"], tr["batch"]
    dtype = harness.DTYPES[tr["dtype"]]
    tensors = draw(reference.build(cfg, "meta"), ctx, dtype)
    model = build(cfg, dtype, dev)
    load(model, tensors)
    forward = make_forward(model)
    ctx.mark("model")
    frames = harness.stream_frames(ctx.gen(1), tr["pool"] * b + 1, h, w, tr["drift"], dev).float() / 255.0
    pool = [(frames[j * b:(j + 1) * b], frames[j * b + 1:(j + 1) * b + 1]) for j in range(tr["pool"])]
    ctx.mark("inputs")
    sample = harness.Reservoir(tr["sample"], ctx.seed)
    kept: list = [None] * tr["sample"]
    issued = 0

    def issue(deadline=None, count=None, keep=True) -> int:
        nonlocal issued
        n = 0
        while True:
            flow = forward(*pool[issued % len(pool)])[0]
            if keep:
                slot = sample.offer(issued)
                if slot is not None:
                    kept[slot] = flow
            issued += 1
            n += 1
            if n == count or (deadline is not None and time.perf_counter() >= deadline):
                return n * b

    issue(count=tr["warm_batches"], keep=False)
    harness.sync(dev)
    ctx.mark("warm-up")
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t_start
    harness.reset_peak(dev)
    pairs = issue(deadline=t_open + ctx.seconds)
    harness.sync(dev)
    rate = pairs / (time.perf_counter() - t_open)
    metrics, device_trace = {"setup_s": setup_s, tr["rate_metric"]: rate}, None
    if ctx.trace:
        device_trace = spans.traced(lambda: issue(count=tr["profile_batches"]), dev)
        device_trace.update(
            rate=rate, flops_per_pair=raft_work.pair_flops(cfg, h, w), peak_flops=kernels.PEAK_OPS[tr["dtype"]],
            unit_calls={}, lookup_bound_s_per_pair=raft_work.lookup_bound(cfg, h, w),
            corr_bound_s_per_pair=raft_work.corr_volume_bound(cfg, h, w),
        )
    harness.sync(dev)
    peak = harness.peak_bytes(dev)
    attempted = (issued - tr["warm_batches"]) * b
    keys = sample.keys
    got = torch.cat([kept[i].float() for i in range(len(keys))])
    del forward, model, kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("window closed, state freed")

    ref = reference.build(cfg, dev)
    load(ref, {k: v.float() for k, v in tensors.items()})

    def flows_of(precision):
        # cuDNN's heuristics pick FFT convs for the reference's float32 NCHW shapes, 13 s a forward of 16 on
        # an H100; its benchmark mode times the algorithms once a shape and takes the fastest
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
            return torch.cat([ref(*pool[k % len(pool)], precision)[0] for k in keys])

    want = flows_of(None)
    rounded = flows_of(harness.ROUNDED[tr["dtype"]]) if tr["dtype"] in harness.ROUNDED else None
    numbers = harness.flow_gaps(got, want, rounded)
    readings = {}
    if "control" in ctx.readings:
        readings["control"] = harness.flow_gaps(flows_of(harness.CONTROL[tr["dtype"]]), want, rounded)
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=0, numbers=numbers,
                           memory_peak_bytes=peak, device_trace=device_trace, readings=readings)
