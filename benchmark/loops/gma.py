"""GMA's offline batch serving of clips already on the card:
``make_forward(GMA(iters).to(dtype))(images_0, images_1)`` back to back
on a pool of seeded device-resident batches of consecutive frames, cycled;
the flows stay on the card.

The rate is the pairs of all forwards issued in the window over the window,
which ends in a synchronise. The traced run (``spans.traced``, the port's
spans on) times one stretch the same way and then profiles a few forwards;
it adds the least seconds a pair of the correlation volume and of the
lookups (``raft_work``) and of the attention's products (``gma_work``),
which the rooflines set against the device seconds of ``model.corr``, of
``model.lookup`` and of ``model.attend`` and ``model.aggregate``.

Weights: RAFT's draw (``loops/raft.py`` `draw`: ``harness.draw_weights``,
cnet's BatchNorm statistics, the flow head at 1/16), with ``att.to_qk`` at
``QK_SCALE`` of its draw and ``gamma`` set to ``GAMMA`` (both powers of
two, exact in bf16). GMA initialises ``gamma`` at 0, which would leave the
aggregation out, and the trained value is learned; at ``GAMMA`` the global
term ``gamma attention to_v(mf)`` is 0.49-0.71 of ``mf`` in norm (the card,
1088x1920, 8 seeds). At the full draw of ``to_qk`` the scores' rows spread
with a standard deviation of 9-175 and the softmax is one-hot on most rows
(each row's largest probability 0.40-1.0 in the median at N = 2048, CPU,
256x512); at 1/4 the spread is 1/16 of that, and each row's largest
probability has a median of 2-7300 times uniform's (the card, 8 seeds: the
context features' scale varies 3-fold from seed to seed under RAFT's draw,
the scores' as its square).

The check has two parts, on the same sample of the window's forwards,
drawn from the seed:

- ``flow_gap_ratio``: the final flows against the plain reference in
  float32 on the same frames and weights, a pair at a time, over the gap of
  the reference with its operands rounded to the cell's precision.
- ``score_ulps``: ``SCORE_ROWS`` rows of each forward's own attention
  (``model.att``'s output, with the q and k that ``att.to_qk`` gave it,
  held by forward hooks on the sampled forwards only) against the float64
  softmax of the float64 scores of those q and k: the largest error, in
  units in the last place of the attention's dtype at the float64
  probability, over the probabilities of 2**-100 or more. Rounding a
  float32 softmax once reads at most half a unit and a little more; scores
  rounded to bf16 before the softmax move each probability by up to its
  score times 2**-8 more, which the flows cannot show at bf16 (the rounding
  of q and k that the cell's own precision makes moves them as far).

Readings for the limits, named in ``Ctx.readings``: ``control``, the
reference one precision below the cell's in the program's place; ``long``,
the program's flows 10% too long; ``gamma0``, the float32 reference with
``gamma`` at 0 (the aggregation left out); ``bf16_scores``, with its
scores rounded to bf16 before the softmax (its ``score_ulps`` from the same
rounding of the float64 scores of the sampled rows); ``queries``, with the
softmax over the queries instead of the keys; each of these that changes
only the flows carries the program's own ``score_ulps``. And ``stats``, the
attention and flows of the first sampled pair (each row's largest
probability by quantile, ``|gamma out| / |mf|`` at the first and last
update, the mean flow at 1/8 and the share of its end points inside the
frame).
"""

from __future__ import annotations

import gc
import math
import time
from unittest import mock

import torch

from benchmark import gma_work, harness, kernels, raft_work, spans
from benchmark.loops import raft as raft_loop
from benchmark.reference import gma as reference

QK_SCALE = 1 / 4
GAMMA = 0.5
SCORE_ROWS = 64  # rows of each batch element's attention that ``score_ulps`` reads, a sampled forward
FAULTS = {
    "gamma0": None,
    "bf16_scores": lambda sim: sim.to(torch.bfloat16).float().softmax(dim=-1),
    "queries": lambda sim: sim.softmax(dim=-2),
}


def draw(ref: torch.nn.Module, ctx: harness.Ctx, dtype) -> dict:
    """The parameters and the BatchNorm running statistics of the cell's
    seed, by the reference's names, in ``dtype``."""
    tensors = raft_loop.draw(ref, ctx, dtype)
    tensors["att.to_qk.weight"] = tensors["att.to_qk.weight"] * QK_SCALE
    tensors["update_block.aggregator.gamma"] = torch.full_like(tensors["update_block.aggregator.gamma"], GAMMA)
    return tensors


def load(model: torch.nn.Module, tensors: dict) -> None:
    """``raft_loop.load``, with the model's own position index (a buffer
    that no draw makes)."""
    raft_loop.load(model, {**tensors, "att.pos_emb.rel_ind": model.att.pos_emb.rel_ind})


def build(cfg: dict, dtype, dev):
    from pwcnet_tpu_torch.models.gma import GMA

    return GMA(iters=cfg["iters"]).to(device=dev, dtype=dtype)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` in units in the last place of ``got``'s
    dtype at ``want`` (float64), over ``want`` of 2**-100 or more."""
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.full_like(want, torch.finfo(got.dtype).eps), e - 1)
    return float(((got.double() - want).abs() / ulp)[want >= 2.0**-100].max())


def score_ulps(p: torch.Tensor, q: torch.Tensor, k: torch.Tensor) -> dict:
    """``{"program", "bf16_scores"}``: `_ulps` of the attention's rows ``p``
    (B, R, N) and of the softmax of scores rounded to bf16, rounded to
    ``p``'s dtype, against the float64 softmax of ``q k^T / sqrt(C)``, q (B,
    R, C) the rows' queries, k (B, N, C) the keys."""
    scores = torch.matmul(q.double(), k.double().transpose(1, 2)) / math.sqrt(q.shape[-1])
    want = scores.softmax(dim=-1)
    rounded = scores.to(torch.bfloat16).double().softmax(dim=-1).to(p.dtype)
    return {"program": _ulps(p, want), "bf16_scores": _ulps(rounded, want)}


def _stats(ref: torch.nn.Module, x0: torch.Tensor, x1: torch.Tensor) -> dict:
    """The attention's and the flow's figures of one pair in the float32 reference."""
    seen = {"attention": None, "share": []}
    attend, aggregate = reference.Attention.forward, reference.Aggregate.forward

    def attention(self, fmap, precision=None):
        seen["attention"] = attn = attend(self, fmap, precision)
        return attn

    def aggregated(self, attn, fmap, precision=None):
        out = aggregate(self, attn, fmap, precision)
        seen["share"].append(float((out - fmap).norm() / fmap.norm()))
        return out

    with mock.patch.object(reference.Attention, "forward", attention), \
            mock.patch.object(reference.Aggregate, "forward", aggregated), torch.no_grad():
        low = ref(x0, x1)[1]
    top = seen["attention"].amax(-1).flatten().float()
    qs = torch.tensor([0.1, 0.5, 0.9, 0.99], device=top.device)
    _, h, w, _ = low.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=low.device), torch.arange(w, device=low.device), indexing="ij")
    end = low + torch.stack([xs, ys], -1)
    inside = (end[..., 0] >= 0) & (end[..., 0] <= w - 1) & (end[..., 1] >= 0) & (end[..., 1] <= h - 1)
    n = top.numel()
    top = top[torch.randperm(n, device=top.device)[:2**24]] if n > 2**24 else top  # quantile takes 2**24 at most
    return {"top_probability": dict(zip(("q10", "q50", "q90", "q99"), torch.quantile(top, qs).tolist())),
            "top_probability_max": float(seen["attention"].amax()), "uniform": 1.0 / seen["attention"].shape[-1],
            "global_share_first": seen["share"][0], "global_share_last": seen["share"][-1],
            "flow_mean_low": float(low.norm(dim=-1).mean()), "inside": float(inside.float().mean())}


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
    kept_rows: list = [None] * tr["sample"]  # (attention rows, their q, every k) of the sampled forwards
    rows = torch.randperm((h // 8) * (w // 8), generator=ctx.gen(3), device=dev)[:SCORE_ROWS].sort().values
    seen: dict = {"on": False}

    def qk_hook(module, args, qk):
        if seen["on"]:
            seen["qk"] = qk

    def attention_hook(module, args, p):
        if seen["on"]:
            qk = seen.pop("qk").permute(0, 2, 3, 1).reshape(p.shape[0], p.shape[1], -1)
            q, k = qk.chunk(2, dim=-1)
            seen["rows"] = (p[:, rows].clone(), q[:, rows].clone(), k.clone())

    hooks = [model.att.to_qk.register_forward_hook(qk_hook), model.att.register_forward_hook(attention_hook)]
    issued = 0

    def issue(deadline=None, count=None, keep=True) -> int:
        nonlocal issued
        n = 0
        while True:
            slot = sample.offer(issued) if keep else None
            seen["on"] = slot is not None
            flow = forward(*pool[issued % len(pool)])[0]
            if slot is not None:
                kept[slot], kept_rows[slot] = flow, seen.pop("rows")
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
            rate=rate, flops_per_pair=gma_work.pair_flops(cfg, h, w), peak_flops=kernels.PEAK_OPS[tr["dtype"]],
            unit_calls={}, lookup_bound_s_per_pair=raft_work.lookup_bound(cfg, h, w),
            corr_bound_s_per_pair=raft_work.corr_volume_bound(cfg, h, w),
            aggregate_bound_s_per_pair=gma_work.aggregate_bound(cfg, h, w),
        )
    harness.sync(dev)
    peak = harness.peak_bytes(dev)
    attempted = (issued - tr["warm_batches"]) * b
    keys = sample.keys
    got = torch.cat([kept[i].float() for i in range(len(keys))])
    scores = [score_ulps(*kept_rows[i]) for i in range(len(keys))]
    score = {k: max(r[k] for r in scores) for k in ("program", "bf16_scores")}
    for hook in hooks:
        hook.remove()
    del forward, model, kept, kept_rows
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("window closed, state freed")

    ref = reference.build(cfg, dev)
    load(ref, {k: v.float() for k, v in tensors.items()})
    pairs_of = [(k, i) for k in keys for i in range(b)]

    def flows_of(precision):
        # one pair at a time: the reference's (1, 1, N, N) float32 scores and probabilities are 4.3 GB each at
        # 1088x1920; cuDNN's benchmark mode times its float32 convs' algorithms once a shape
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
            return torch.cat([ref(pool[k % len(pool)][0][i:i + 1], pool[k % len(pool)][1][i:i + 1], precision)[0]
                              for k, i in pairs_of])

    want = flows_of(None)
    rounded = flows_of(harness.ROUNDED[tr["dtype"]]) if tr["dtype"] in harness.ROUNDED else None
    numbers = {**harness.flow_gaps(got, want, rounded), "score_ulps": score["program"]}
    readings = {}
    if "control" in ctx.readings:
        readings["control"] = harness.flow_gaps(flows_of(harness.CONTROL[tr["dtype"]]), want, rounded)
    if "long" in ctx.readings:
        readings["long"] = harness.flow_gaps(got * 1.1, want, rounded)
    for fault, softmax in FAULTS.items():
        if fault not in ctx.readings:
            continue
        if softmax is None:
            gamma = ref.update_block.aggregator.gamma
            saved = gamma.detach().clone()
            with torch.no_grad():
                gamma.zero_()
            readings[fault] = harness.flow_gaps(flows_of(None), want, rounded)
            with torch.no_grad():
                gamma.copy_(saved)
        else:
            with mock.patch.object(reference, "attention_softmax", softmax):
                readings[fault] = harness.flow_gaps(flows_of(None), want, rounded)
    for name, reading in readings.items():
        reading["score_ulps"] = score.get(name, score["program"])
    if "stats" in ctx.readings:
        k, i = pairs_of[0]
        readings["stats"] = _stats(ref, pool[k % len(pool)][0][i:i + 1], pool[k % len(pool)][1][i:i + 1])
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=0, numbers=numbers,
                           memory_peak_bytes=peak, device_trace=device_trace, readings=readings)
