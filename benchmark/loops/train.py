"""Training: ``make_train_step(PWCDCNet(...))`` issued back to back on a
pool of seeded batches made on the card and cycled, so no loader paces
the step.

Set-up builds one training state from the seed's weights and drives it
through its first steps with the window's own call, on three batches whose
rows all differ; the same state then runs the window. The rate is the
pairs of all steps issued in the window over the window, which ends in a
synchronise; the peak is ``max_memory_allocated`` over the window. The
window's last two steps start from a copy of the state taken before them
(parameters, Adam's moments, the step count). The traced run times one
stretch the same way and then profiles a few steps.

The check, after the window, against the plain reference:

- the first three steps, followed from the same weights and batches: each
  step's multiscale loss (the weight decay, a function of the parameters
  alone, left out), the first gradient as Adam got it (its first moment
  over 1 - b1) and the parameters' change over the three steps;
- the window's last two steps, followed from the copy of the state before
  them (the program's own state: its start is what the first three steps
  check): each step's multiscale loss and the parameters' change over the
  two, with Adam's moments and step count as the window left them.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import flops, harness, kernels, tracing
from benchmark.reference import model as reference
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3  # the first steps, from the seed's weights
WINDOW_CHECKED = 2  # the window's last steps, from the state before them


def build(cfg: dict, compute_dtype, dev):
    """PWCDCNet wired as the port's trainer wires it on the card by default
    (``Trainer._build_model``): K2 and K1 through the cost-volume hooks,
    K3 on the port's ``FUSED_PYRAMID_LEVELS``, no K7."""
    from pwcnet_tpu_torch.inference import FUSED_PYRAMID_LEVELS
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

    kw = {k: cfg[k] for k in ("num_levels", "search_range", "output_level", "warp_type", "use_dc")}
    model = PWCDCNet(init=False, cost_volume_fn=cost_volume_cuda, warp_cv_fn=warped_cost_volume,
                     fused_pyramid_levels=FUSED_PYRAMID_LEVELS,
                     compute_dtype=None if compute_dtype == torch.float32 else compute_dtype, **kw)
    return model.to(dev)


def run(ctx: harness.Ctx) -> harness.Outcome:
    from pwcnet_tpu_torch.train_lib.step import create_train_state, make_train_step

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    h, w, b = tr["height"], tr["width"], tr["batch"]
    weights = harness.draw_weights(reference.build(cfg, "meta"), ctx.gen(0), dev)
    model = build(cfg, harness.DTYPES[tr["dtype"]], dev)
    model.load_state_dict(weights)
    state = create_train_state(model, learning_rate=ref_train.LR, device=dev)
    step = make_train_step(model)
    ctx.mark("model")
    pool = harness.train_pool(ctx.gen(1), tr["pool"], b, h, w, tr["max_flow"], dev)
    ctx.mark("inputs")
    losses, grad1 = [], None
    for i in range(CHECKED_STEPS):
        state, m = step(state, *pool[i])
        losses.append(m["data_loss"])
        if i == 0:
            grad1 = {k: v / (1.0 - ref_train.B1) for k, v in state.mu.items()}
    change = {k: p.detach() - weights[k] for k, p in model.named_parameters()}
    issued = CHECKED_STEPS

    def steps(deadline=None, count=None) -> list:
        nonlocal state, issued
        out = []
        while True:
            state, m = step(state, *pool[issued % len(pool)])
            out.append(m["loss"])
            issued += 1
            if len(out) == count or (deadline is not None and time.perf_counter() >= deadline):
                return out

    steps(count=tr["warm_steps"])
    harness.sync(dev)
    ctx.mark("warm-up")
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t_start
    harness.reset_peak(dev)
    window = steps(deadline=t_open + ctx.seconds)
    peak = harness.peak_bytes(dev)  # the steps' own, before the copy of the state
    before = {"params": {k: p.detach().clone() for k, p in model.named_parameters()},
              "mu": {k: v.clone() for k, v in state.mu.items()}, "nu": {k: v.clone() for k, v in state.nu.items()},
              "count": state.step}
    tail = [pool[(issued + i) % len(pool)] for i in range(WINDOW_CHECKED)]
    tail_losses = []
    for batch in tail:
        state, m = step(state, *batch)
        tail_losses.append(m["data_loss"])
        window.append(m["loss"])
        issued += 1
    harness.sync(dev)
    rate = len(window) * b / (time.perf_counter() - t_open)
    metrics = {"setup_s": setup_s, tr["rate_metric"]: rate, "train_peak_gib": peak / 2**30}
    tail_change = {k: p.detach() - before["params"][k] for k, p in model.named_parameters()}
    device_trace = None
    if ctx.trace:
        device_trace = tracing.traced(lambda: len(steps(count=tr["profile_steps"])) * b, dev)
        device_trace.update(
            rate=rate, flops_per_pair=flops.pair_flops(cfg, h, w, train=True),
            peak_flops=kernels.PEAK_OPS[tr["dtype"]],
            unit_calls=kernels.calls(cfg, True, b, h, w, tr["dtype"], model.fp_extractor.fused_levels),
        )
    attempted = issued - CHECKED_STEPS - tr["warm_steps"]
    failed = int((~torch.isfinite(torch.stack(window))).sum())
    losses = [float(v) for v in losses]
    tail_losses = [float(v) for v in tail_losses]
    del state, step, model, window
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("window closed, state freed")

    def follow(start=None, precision=None, rows=1.0, jitter=0.0):
        """The reference's steps from the seed's weights (or from ``start``,
        the state before the window's last steps)."""
        ref = reference.build(cfg, dev)
        ref.load_state_dict(weights if start is None else start["params"])
        if jitter:
            g = ctx.gen(2)
            with torch.no_grad():
                for p in ref.parameters():
                    p.mul_(1 + jitter * torch.randn(p.shape, generator=g, device=dev))
        begin = {k: p.detach().clone() for k, p in ref.named_parameters()}
        if start is None:
            out = ref_train.follow_steps(ref, pool[:CHECKED_STEPS], precision, tr["check_chunk"], rows)
        else:
            out = ref_train.follow_steps(ref, tail, precision, tr["check_chunk"], rows,
                                         moments=(start["mu"], start["nu"]), count=start["count"])
        out["change"] = {k: p.detach() - begin[k] for k, p in ref.named_parameters()}
        return out

    rounding = harness.ROUNDED.get(tr["dtype"])

    def gaps(got_first, got_tail):
        """Every number of the check, of ``got_*`` against the reference."""
        return {**harness.train_gaps(got_first, want, rounded and rounded[0]),
                **harness.window_gaps(got_tail, want_tail, rounded and rounded[1])}

    want, want_tail = follow(), follow(before)
    rounded = (follow(precision=rounding), follow(before, precision=rounding)) if rounding else None
    numbers = gaps({"losses": losses, "grad1": grad1, "change": change},
                   {"losses": tail_losses, "change": tail_change})
    readings = {"losses": {"program": losses, "reference": want["losses"],
                           "window_program": tail_losses, "window_reference": want_tail["losses"]}}
    for name, kw in (("control", {"precision": harness.CONTROL[tr["dtype"]]}), ("half", {"rows": 0.5}),
                     ("jitter", {"jitter": 1e-7})):
        if name in ctx.readings:
            readings[name] = gaps(follow(**kw), follow(before, **kw))
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=failed, numbers=numbers,
                           memory_peak_bytes=peak, device_trace=device_trace, readings=readings)
