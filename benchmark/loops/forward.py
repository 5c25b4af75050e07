"""Offline batch serving of clips already on the card:
``make_forward(model)(images_0, images_1)`` back to back on a pool of
seeded device-resident batches of consecutive frames, cycled; the flows
stay on the card.

The rate is the pairs of all forwards issued in the window over the window,
which ends in a synchronise. The traced run times one stretch the same way
and then profiles a few forwards.

The check: the final flows of a sample of the window's forwards, drawn from
the seed, against the plain reference in float32 on the same frames and
weights.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import flops, harness, kernels, tracing
from benchmark.reference import model as reference


def build(cfg: dict, dtype, dev):
    from pwcnet_tpu_torch.models.pwcnet import PWCNet

    kw = {k: cfg[k] for k in ("num_levels", "search_range", "output_level", "warp_type", "context", "batch_norm")}
    return PWCNet(init=False, **kw).to(device=dev, dtype=dtype)


def run(ctx: harness.Ctx) -> harness.Outcome:
    from pwcnet_tpu_torch.train_lib.step import make_forward

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    h, w, b = tr["height"], tr["width"], tr["batch"]
    dtype = harness.DTYPES[tr["dtype"]]
    weights = harness.draw_weights(reference.build(cfg, "meta"), ctx.gen(0), dev, dtype)
    model = build(cfg, dtype, dev)
    model.load_state_dict(weights)
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
        device_trace = tracing.traced(lambda: issue(count=tr["profile_batches"]), dev)
        device_trace.update(
            rate=rate, flops_per_pair=flops.pair_flops(cfg, h, w),
            peak_flops=kernels.PEAK_OPS[tr["dtype"]], unit_calls=kernels.calls(cfg, False, b, h, w, tr["dtype"]),
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
    ref.load_state_dict({k: v.float() for k, v in weights.items()})

    def flows_of(precision):
        with torch.no_grad():
            return torch.cat([ref(*pool[k % len(pool)], precision) for k in keys])

    want = flows_of(None)
    rounded = flows_of(harness.ROUNDED[tr["dtype"]]) if tr["dtype"] in harness.ROUNDED else None
    numbers = harness.flow_gaps(got, want, rounded)
    readings = {}
    if "control" in ctx.readings:
        readings["control"] = harness.flow_gaps(flows_of(harness.CONTROL[tr["dtype"]]), want, rounded)
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=0, numbers=numbers,
                           memory_peak_bytes=peak, device_trace=device_trace, readings=readings)
