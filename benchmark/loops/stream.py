"""Serving a frame stream: ``FlowPredictor(dtype).predict_sequence(frames,
batch, depth, fetch='flow')`` in a closed loop.

The frames are seeded uint8 frames of one texture drifting a few pixels a
frame, held in host memory and cycled. The rate is the pairs handed out in
the window over the window, which runs on to the last of them.

Every stretch of the stream starts from an empty pipeline and ends with
every pair it pulled handed out, at the first dispatch's boundary past
its deadline, and a synchronise. The traced run times, in turns, two such
stretches and two of ``raw_forward`` on the same frames already on the
card, then profiles a stretch of the stream. In the stream's stretches the
benchmark's iterator stamps each pull and each flow is stamped as it is
handed out: a pair's latency runs from the pull of its second frame to its
flow's hand-out, all inside one stretch. (A closed loop saturates the
system, so the tail of its latencies is a per-layer reading, not a user's.)

The check: a sample of the pairs handed out in the timed stretches, drawn
from the seed, against the plain reference in float32 on the same frames
and weights.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import flops, harness, kernels, tracing
from benchmark.reference import model as reference


def port_kwargs(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("num_levels", "search_range", "output_level", "warp_type", "use_dc")}


def run(ctx: harness.Ctx) -> harness.Outcome:
    from pwcnet_tpu_torch.inference import FlowPredictor

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    h, w, b = tr["height"], tr["width"], tr["batch"]
    dtype = harness.DTYPES[tr["dtype"]]
    weights = harness.draw_weights(reference.build(cfg, "meta"), ctx.gen(0), dev, dtype)
    pred = FlowPredictor(dtype=dtype, device=dev, **port_kwargs(cfg))
    pred.model.load_state_dict(weights)
    ctx.mark("model")
    frames_dev = harness.stream_frames(ctx.gen(1), tr["frames"], h, w, tr["drift"], dev)
    frames = list(frames_dev.cpu().numpy())
    n_frames = len(frames)
    ctx.mark("inputs")
    sample = harness.Reservoir(tr["sample"], ctx.seed)
    kept = np.empty((tr["sample"], h, w, 2), np.float32)
    latencies: list = []
    at = 0  # the frame the next stretch starts from

    def stretch(deadline=None, pairs=None, keep=True) -> int:
        """One stream from an empty pipeline: frames from ``at`` on, pulled
        until ``pairs`` pairs or, past ``deadline``, the next dispatch's
        boundary; every flow of it handed out, then the device synchronised.
        Returns the pairs handed out."""
        nonlocal at
        pulls: list = []

        def source():
            while True:
                pulls.append(time.perf_counter())
                yield frames[(at + len(pulls) - 1) % n_frames]
                done = len(pulls) - 1
                if done % b == 0 and ((pairs is not None and done >= pairs)
                                      or (deadline is not None and time.perf_counter() >= deadline)):
                    return

        handed = 0
        for flow in pred.predict_sequence(source(), depth=tr["depth"], batch=b, fetch="flow"):
            if keep:
                latencies.append(time.perf_counter() - pulls[handed + 1])
                slot = sample.offer((at + handed) % n_frames)
                if slot is not None:
                    np.copyto(kept[slot], flow)
            handed += 1
        harness.sync(dev)
        at = (at + handed) % n_frames
        return handed

    stretch(pairs=tr["warm_pairs"], keep=False)
    ctx.mark("warm-up")
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t_start
    harness.reset_peak(dev)
    metrics, device_trace = {"setup_s": setup_s}, None
    if not ctx.trace:
        pairs = stretch(deadline=t_open + ctx.seconds)
        metrics[tr["rate_metric"]] = pairs / (time.perf_counter() - t_open)
    else:
        raw = [frames_dev[i:i + 2] for i in range(n_frames - 1)]
        raw = [torch.stack(raw[j:j + b]) for j in range(0, len(raw) - b + 1, b)]
        span = ctx.seconds / 4
        done = {"stream": [0, 0.0], "raw": [0, 0.0]}
        for _turn in range(2):
            t0 = time.perf_counter()
            done["stream"][0] += stretch(deadline=t0 + span)
            done["stream"][1] += time.perf_counter() - t0
            t0, n = time.perf_counter(), 0
            while time.perf_counter() < t0 + span:
                pred.raw_forward(raw[n % len(raw)])
                n += 1
            harness.sync(dev)
            done["raw"][0] += n * b
            done["raw"][1] += time.perf_counter() - t0
        rate = done["stream"][0] / done["stream"][1]
        p95_ms = float(np.percentile(latencies, 95)) * 1e3
        device_trace = tracing.traced(lambda: stretch(pairs=tr["profile_pairs"], keep=False), dev)
        device_trace.update(
            rate=rate, overhead_pct=100.0 * (1.0 - rate * done["raw"][1] / done["raw"][0]), p95_ms=p95_ms,
            flops_per_pair=flops.pair_flops(cfg, h, w), peak_flops=kernels.PEAK_OPS[tr["dtype"]],
            unit_calls=kernels.calls(cfg, False, b, h, w, tr["dtype"], pred.model.fp_extractor.fused_levels),
        )
    harness.sync(dev)
    peak = harness.peak_bytes(dev)
    attempted = len(latencies)
    del pred
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("window closed, state freed")

    ref = reference.build(cfg, dev)
    ref.load_state_dict({k: v.float() for k, v in weights.items()})
    keys = sample.keys
    got = torch.from_numpy(kept[:len(keys)]).to(dev)

    def flows_of(precision):
        out = []
        with torch.no_grad():
            for s in range(0, len(keys), b):
                idx = [(k, (k + 1) % n_frames) for k in keys[s:s + b]]
                pair = torch.stack([torch.stack([frames_dev[i], frames_dev[j]]) for i, j in idx]).float() / 255.0
                out.append(ref(pair[:, 0], pair[:, 1], precision)[0])
        return torch.cat(out)

    want = flows_of(None)
    rounded = flows_of(harness.ROUNDED[tr["dtype"]]) if tr["dtype"] in harness.ROUNDED else None
    numbers = harness.flow_gaps(got, want, rounded)
    readings = {}
    if "control" in ctx.readings:
        readings["control"] = harness.flow_gaps(flows_of(harness.CONTROL[tr["dtype"]]), want, rounded)
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=0, numbers=numbers,
                           memory_peak_bytes=peak, device_trace=device_trace, readings=readings)
