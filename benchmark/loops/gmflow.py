"""GMFlow's offline batch serving of clips already on the card:
``make_forward(GMFlow(attn_splits).to(dtype))(images_0, images_1)`` back
to back on a pool of seeded device-resident batches of consecutive frames,
cycled; the flows stay on the card.

The rate is the pairs of all forwards issued in the window over the window,
which ends in a synchronise. The traced run (``spans.traced``, the port's
spans on) times one stretch the same way and then profiles a few forwards;
it adds the least seconds a pair of the transformer's 12 layers and of the
global matching and propagation (``gmflow_work``), which the rooflines set
against the device seconds of ``model.transformer`` and of ``model.match``
and ``model.propagate``.

Weights: ``harness.draw_weights`` on the reference's parameters, with
three scales (powers of two, so the draw stays exact in bf16): the
encoder's output conv ``backbone.conv2`` at ``ENCODER_SCALE``, every
LayerNorm scale of the transformer at ``NORM_SCALE`` and the propagation's
two Linears' weights at ``PROPAGATION_SCALE``. At the full draw the
features grow over the 12 layers until every softmax is decided by its
largest score (the matching's largest probability 0.97-1.0 in the median
on the CPU at 224x512) and bf16 rounding moves the flow by 50-140% of
itself: the check would compare ties. At the scales, on the card at the
cell's size, the matching's largest probability has a median of
0.0013-0.0030 (9-22 times uniform's 1/7168), a 99th percentile of
0.06-0.23, the flow a mean of 2.0-3.0 px at 1/8 and 93-96% of the 1/8
grid's end points stay inside the frame (``PERF.md`` §4).

The check: the final flows of a sample of the window's forwards, drawn from
the seed, against the plain reference in float32 on the same frames and
weights, over the gap of the reference with its operands rounded to the
cell's precision. Readings for the limit, named in ``Ctx.readings``
(``calibrate.py`` asks for ``control``; the CPU tests for all three):
``control``, the reference one precision below the cell's in the
program's place; ``long``, the program's flows 10% too long; ``nomask``,
the float32 reference with the shifted windows' mask left out.
"""

from __future__ import annotations

import gc
import time
from unittest import mock

import torch

from benchmark import gmflow_work, harness, kernels, spans
from benchmark.reference import gmflow as reference

ENCODER_SCALE = 1 / 4
NORM_SCALE = 1 / 8
PROPAGATION_SCALE = 1 / 2


def draw(ref: torch.nn.Module, ctx: harness.Ctx, dtype) -> dict:
    """The parameters of the cell's seed, by the reference's names, in ``dtype``."""
    tensors = harness.draw_weights(ref, ctx.gen(0), ctx.device, dtype)
    for k in tensors:
        if k.startswith("backbone.conv2."):
            tensors[k] = tensors[k] * ENCODER_SCALE
        elif k.startswith("transformer.") and (".norm1." in k or ".norm2." in k) and k.endswith("weight"):
            tensors[k] = tensors[k] * NORM_SCALE
        elif k.startswith("feature_flow_attn.") and k.endswith("weight"):
            tensors[k] = tensors[k] * PROPAGATION_SCALE
    return tensors


def build(cfg: dict, dtype, dev):
    from pwcnet_tpu_torch.models.gmflow import GMFlow

    return GMFlow(attn_splits=cfg["attn_splits"]).to(device=dev, dtype=dtype)


_MASK = reference.generate_shift_window_attn_mask


def _unmasked(*args, **kwargs):
    """The reference's shifted-window mask with every entry 0 (the ``nomask`` reading)."""
    return torch.zeros_like(_MASK(*args, **kwargs))


def run(ctx: harness.Ctx) -> harness.Outcome:
    from pwcnet_tpu_torch.train_lib.step import make_forward

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    h, w, b = tr["height"], tr["width"], tr["batch"]
    dtype = harness.DTYPES[tr["dtype"]]
    tensors = draw(reference.build(cfg, "meta"), ctx, dtype)
    model = build(cfg, dtype, dev)
    model.load_state_dict(tensors)
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
            rate=rate, flops_per_pair=gmflow_work.pair_flops(cfg, h, w), peak_flops=kernels.PEAK_OPS[tr["dtype"]],
            unit_calls={}, transformer_bound_s_per_pair=gmflow_work.transformer_bound(cfg, h, w),
            match_bound_s_per_pair=gmflow_work.match_bound(cfg, h, w),
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
    ref.load_state_dict({k: v.float() for k, v in tensors.items()})

    def flows_of(precision):
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
            return torch.cat([ref(*pool[k % len(pool)], precision)[0] for k in keys])

    want = flows_of(None)
    rounded = flows_of(harness.ROUNDED[tr["dtype"]]) if tr["dtype"] in harness.ROUNDED else None
    numbers = harness.flow_gaps(got, want, rounded)
    readings = {}
    if "control" in ctx.readings:
        readings["control"] = harness.flow_gaps(flows_of(harness.CONTROL[tr["dtype"]]), want, rounded)
    if "long" in ctx.readings:
        readings["long"] = harness.flow_gaps(got * 1.1, want, rounded)
    if "nomask" in ctx.readings:
        with mock.patch.object(reference, "generate_shift_window_attn_mask", _unmasked):
            readings["nomask"] = harness.flow_gaps(flows_of(None), want, rounded)
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=0, numbers=numbers,
                           memory_peak_bytes=peak, device_trace=device_trace, readings=readings)
