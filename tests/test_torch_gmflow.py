"""GMFlow in the port (``pwcnet_tpu_torch.models.gmflow``,
``ops.attention``) on the CPU, against the benchmark's plain reference
(``benchmark/reference/gmflow.py``) on the cell's seeded draw of weights:
float32 tightly, bf16 against the rounded reference's gap; the parameter
count and names at published widths; the shifted mask and the positions;
the fused route's layout (the CPU's own attention in place of the card's
restricted one, R4's math in place of R4) and its counts; the benchmark's GMFlow cell driven at a
small size: its work counts, its check and the faults the check must
catch; and the card's bf16 forward at the cell's size (``-m cuda``).

The CPU comparisons run at 64x128: a 1/8 grid of 8x16, windows of 4x8,
the shifted windows rolled by (2, 4).
"""

import functools
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import gmflow_work, harness
from benchmark.loops import gmflow as loop
from benchmark.reference import gmflow as reference
from benchmark.reference import raft as raft_reference
from pwcnet_tpu_torch.models import gmflow as gmflow_module
from pwcnet_tpu_torch.models.gmflow import GMFlow, add_window_positions, sine_positions
from pwcnet_tpu_torch.models.raft import RAFT, BasicEncoder
from pwcnet_tpu_torch.ops import attention
from pwcnet_tpu_torch.train_lib.step import make_forward
from pwcnet_tpu_torch.utils import profiling

CELL = "gmflow.split2.bf16"
CONFIG = harness._json(harness.BENCH / "configs" / "gmflow.json")
H, W = 64, 128


def _ctx(seed: int, readings=()) -> harness.Ctx:
    cell = harness.load_cell(CELL)
    cell["traffic"].update(height=H, width=W, batch=2, pool=2, warm_batches=1, sample=2)
    return harness.Ctx(name=CELL, cell=cell, seed=seed, seconds=0.3, trace=False, device=torch.device("cpu"),
                       t_start=time.perf_counter(), readings=readings)


def _pair(seed: int, dtype=torch.float32):
    """The port and the reference on the cell's draw of ``seed`` (in
    ``dtype``; the reference gets the same values in float32), and frames."""
    ctx = _ctx(seed)
    tensors = loop.draw(reference.build(CONFIG, "meta"), ctx, dtype)
    port = GMFlow().to(dtype)
    port.load_state_dict(tensors)
    ref = reference.build(CONFIG)
    ref.load_state_dict({k: v.float() for k, v in tensors.items()})
    frames = harness.stream_frames(ctx.gen(1), 3, H, W, (3, 1), "cpu").float() / 255.0
    return port, ref, frames[:2], frames[1:]


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_float32_flows_match_the_reference(seed):
    port, ref, x0, x1 = _pair(seed)
    with torch.no_grad():
        flow, low = port(x0, x1)
        want, want_low = ref(x0, x1)
    assert flow.shape == (2, H, W, 2) and low.shape == (2, H // 8, W // 8, 2)
    assert flow.dtype == low.dtype == torch.float32
    assert want_low.norm(dim=-1).mean() > 0.1  # the flows moved
    assert float(harness._pair_gaps(flow, want).max()) < 1e-5
    assert float(harness._pair_gaps(low, want_low).max()) < 1e-5


@pytest.mark.parametrize("seed", [7, 2**31 + 7, 4_000_000_001])
def test_bf16_flow_is_within_the_cells_limit_of_the_bf16_rounded_reference(seed):
    port, ref, x0, x1 = _pair(seed, torch.bfloat16)
    with torch.no_grad():
        got = port(x0, x1)[0]
        want, rounded = ref(x0, x1)[0], ref(x0, x1, "bf16")[0]
    gap, base = harness._pair_gaps(got, want), harness._pair_gaps(rounded, want)
    assert (base > 0).all()
    assert (gap <= harness.load_cell(CELL)["limits"]["flow_gap_ratio"] * base).all(), (gap, base)


def test_module_names_and_parameter_count_are_gmflows():
    with torch.device("meta"):
        port = GMFlow()
    ref = reference.build(CONFIG, "meta")
    names = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert names == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    for k in ("backbone.conv1.weight", "backbone.layer2.0.downsample.0.weight", "backbone.layer2.0.downsample.0.bias",
              "backbone.conv2.bias", "transformer.layers.3.cross_attn_ffn.mlp.0.weight",
              "transformer.layers.5.self_attn.norm1.bias", "feature_flow_attn.k_proj.bias", "upsampler.2.weight"):
        assert k in names, k
    assert names["transformer.layers.0.cross_attn_ffn.mlp.0.weight"] == (1024, 256)
    assert names["transformer.layers.0.cross_attn_ffn.mlp.2.weight"] == (128, 1024)
    assert names["upsampler.0.weight"] == (256, 130, 3, 3) and names["upsampler.2.weight"] == (576, 256, 1, 1)
    # bias-free: the encoder's 7x7 and 3x3 convs, every Linear of the transformer
    assert "backbone.conv1.bias" not in names and "backbone.layer1.0.conv1.bias" not in names
    assert not any(k.startswith("transformer.") and k.endswith("bias") and "norm" not in k for k in names)
    assert "transformer.layers.0.self_attn.mlp.0.weight" not in names  # the self-attention layer has no FFN
    count = sum(p.numel() for p in port.parameters())
    assert count == sum(p.numel() for p in ref.parameters()) == CONFIG["parameters"] == 4_680_288


@pytest.mark.parametrize("h, w, splits", [(8, 16, 2), (56, 128, 2), (12, 12, 3)])
def test_the_shifted_mask_is_gmflows(h, w, splits):
    got = attention.shift_window_mask(h, w, splits, "cpu")
    wh, ww = h // splits, w // splits
    want = reference.generate_shift_window_attn_mask((h, w), wh, ww, wh // 2, ww // 2)
    assert torch.equal(got, want)
    assert set(got.unique().tolist()) == {-100.0, 0.0}
    assert not got[0].any() and got[-1].any()  # the first window holds one region, the last four


def test_positions_are_per_window():
    g = torch.Generator().manual_seed(0)
    f0, f1 = torch.randn(2, 2, 128, 8, 16, generator=g)
    want0, want1 = reference.feature_add_position(f0, f1, 2, 128)
    got0 = add_window_positions(f0.permute(0, 2, 3, 1).contiguous(), 2).permute(0, 3, 1, 2)
    got1 = add_window_positions(f1.permute(0, 2, 3, 1).contiguous(), 2).permute(0, 3, 1, 2)
    assert torch.allclose(got0, want0, atol=1e-6) and torch.allclose(got1, want1, atol=1e-6)
    window = sine_positions(4, 8, 128, "cpu")
    assert torch.equal(window, reference.PositionEmbeddingSine(64)(torch.zeros(1, 128, 4, 8))[0].permute(1, 2, 0))
    whole = reference.feature_add_position(f0, f1, 1, 128)[0]
    assert (whole - want0).abs().max() > 0.5  # a grid's positions are not its windows'


def test_window_split_and_merge_are_gmflows():
    x = torch.randn(2, 8, 16, 5)
    windows = attention.split_windows(x, 2)
    want = reference.split_feature(x, 2, channel_last=True).reshape(2, 4, 32, 5)
    assert torch.equal(windows, want)
    assert torch.equal(attention.merge_windows(windows, 2, 8, 16), x)


def _sdpa_anywhere(q, k, v, mask, scale):
    """The fused route's call on the CPU: PyTorch's own choice of kernel."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _r4_anywhere(q, k, v):
    """R4's math on the CPU, with its layout: (B, N, 128) q and k, a (B, N,
    2) float32 value -> (B, N, 2) float32, ``softmax(q k^T / sqrt(128)) v``
    with float32 scores."""
    assert q.shape == k.shape and q.shape[2] == 128 and v.shape == (*q.shape[:2], 2) and v.dtype == torch.float32
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / 128**0.5
    return torch.matmul(torch.softmax(scores, -1), v)


def test_the_fused_route_lays_out_what_the_plain_route_computes(monkeypatch):
    """With the route of CUDA tensors taken on the CPU (the restricted call
    swapped for the CPU's own, R4's entry for its math), a float32 forward
    equals the plain one and counts 12 window and 2 global calls; the plain
    one counts 14 plain."""
    port, _, x0, x1 = _pair(11)
    attention.reset_attention_counts()
    with torch.no_grad():
        plain = port(x0, x1)[0]
    assert attention.attention_counts() == {"window": 0, "global": 0, "scores": 0, "aggregate": 0, "plain": 14}
    monkeypatch.setattr(attention, "_fused", lambda x: True)
    monkeypatch.setattr(attention, "_sdpa", _sdpa_anywhere)
    monkeypatch.setattr(attention, "global_attention_cuda", _r4_anywhere)
    attention.reset_attention_counts()
    with torch.no_grad():
        fused = port(x0, x1)[0]
    assert attention.attention_counts() == {"window": 12, "global": 2, "scores": 0, "aggregate": 0, "plain": 0}
    assert float(harness._pair_gaps(fused, plain).max()) < 1e-5


def test_bf16_keeps_the_matching_and_the_propagation_in_float32(monkeypatch):
    seen = []

    def watch(q, k, v):
        out = attention.global_attention(q, k, v)
        seen.append((q.dtype, k.dtype, v.dtype, out.dtype))
        return out

    monkeypatch.setattr(gmflow_module, "global_attention", watch)
    model = GMFlow().to(torch.bfloat16)
    x = torch.rand(1, H, W, 3)
    with torch.no_grad():
        flow, low = model(x, x.flip(2))
    assert flow.dtype == low.dtype == torch.float32
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)] * 2
    assert model.transformer.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16


def test_frames_not_a_multiple_of_16_are_refused():
    x = torch.rand(1, 72, 128, 3)
    with pytest.raises(ValueError, match="multiples of 16"):
        GMFlow()(x, x)


def test_make_forward_serves_gmflow():
    model = GMFlow()
    x0, x1 = torch.rand(2, H, W, 3), torch.rand(2, H, W, 3)
    flow, low = make_forward(model)(x0, x1)
    with torch.no_grad():
        want, want_low = model(x0, x1)
    assert torch.equal(flow, want) and torch.equal(low, want_low)


def test_spans_of_a_forward():
    profiling.reset()
    profiling.enable(True)
    try:
        with torch.no_grad():
            GMFlow()(torch.rand(2, H, W, 3), torch.rand(2, H, W, 3))
        got = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert {k: v["count"] for k, v in got.items()} == {
        "model.forward": 1, "model.encode": 1, "model.transformer": 1, "model.match": 1, "model.propagate": 1,
        "model.upsample": 1}
    assert got["model.forward"]["pairs"] == 2 and got["model.forward"]["parent"] is None
    assert all(v["parent"] == "model.forward" for k, v in got.items() if k != "model.forward")


def test_rafts_encoder_keeps_its_biases_and_names():
    """``bias=True``, the default, is RAFT's encoder as it was: every conv
    with a bias, the same names and count; ``bias=False`` drops exactly the
    7x7 and the blocks' 3x3 biases."""
    raft = BasicEncoder(256, "instance")
    names = [k for k, _ in raft.named_parameters()]
    assert all(getattr(m, "bias", None) is not None for m in raft.modules() if isinstance(m, torch.nn.Conv2d))
    assert names == [k[len("fnet."):] for k, _ in RAFT().named_parameters() if k.startswith("fnet.")]
    raft_ref = raft_reference.build(harness._json(harness.BENCH / "configs" / "raft.json"), "meta")
    assert sum(p.numel() for p in raft.parameters()) == sum(
        p.numel() for k, p in raft_ref.named_parameters() if k.startswith("fnet."))
    gm = BasicEncoder(256, "instance", bias=False)
    dropped = {k for k in names} - {k for k, _ in gm.named_parameters()}
    assert dropped == {k for k in names if k.endswith("bias") and "downsample" not in k and k != "conv2.bias"}
    assert len(dropped) == 13


# ---------------------------------------------------------- the benchmark
def test_conv_and_matmul_flops_match_the_flop_counter():
    ref = reference.build(CONFIG)
    x = torch.rand(1, H, W, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(x, x)
    want = counter.get_total_flops()
    assert gmflow_work.conv_flops(CONFIG, H, W) + gmflow_work.matmul_flops(CONFIG, H, W) == want
    assert want < gmflow_work.pair_flops(CONFIG, H, W) < 1.1 * want


def test_work_counts_at_the_cell_size():
    """Hand-worked at 448x1024: 7168 pixels a frame, windows of 1792, both
    frames' 14336 tokens in each layer."""
    n, t, win, c = 7168, 14336, 1792, 128
    assert gmflow_work.conv_flops(CONFIG, 448, 1024) == 130_630_549_504  # the encoders' 124.2 G, the upsampler's 6.4
    layers = 6 * (2 * (4 * 2 * t * c * c + 2 * 2 * t * win * c) + 2 * t * 256 * 1024 + 2 * t * 1024 * 128)
    products = 2 * (2 * n * n * c + 2 * n * n * 2) + 2 * 2 * n * c * c
    assert gmflow_work.matmul_flops(CONFIG, 448, 1024) == layers + products
    assert 0.40e12 < gmflow_work.pair_flops(CONFIG, 448, 1024) < 0.42e12
    self_layer, cross_layer = gmflow_work.transformer_work(CONFIG, 448, 1024)[:2]
    assert self_layer[0] == (2 * t * c + 4 * c * c + 2 * c) * 2
    assert cross_layer[0] == (3 * t * c + 4 * c * c + 2 * c + 256 * 1024 + 1024 * 128 + 2 * c) * 2
    # compute-bound: every layer and both global products at the bf16 peak
    assert gmflow_work.transformer_bound(CONFIG, 448, 1024) == pytest.approx(
        sum(f for _, f in gmflow_work.transformer_work(CONFIG, 448, 1024)) / 989e12)
    assert gmflow_work.match_bound(CONFIG, 448, 1024) == pytest.approx(
        sum(f for _, f in gmflow_work.match_work(CONFIG, 448, 1024)) / 989e12)


def test_the_cell_draws_the_scaled_weights_from_its_seed():
    tensors = loop.draw(reference.build(CONFIG, "meta"), _ctx(11), torch.float32)
    plain = harness.draw_weights(reference.build(CONFIG, "meta"), _ctx(11).gen(0), "cpu")
    for k, v in tensors.items():
        scale = (loop.ENCODER_SCALE if k.startswith("backbone.conv2.") else
                 loop.NORM_SCALE if k.startswith("transformer.") and ".norm" in k and k.endswith("weight") else
                 loop.PROPAGATION_SCALE if k.startswith("feature_flow_attn.") and k.endswith("weight") else 1.0)
        assert torch.equal(v, plain[k] * scale), k
    assert sum(k.startswith("transformer.") and ".norm" in k and k.endswith("weight") for k in tensors) == 18


def _run(ctx):
    from benchmark.run import run_cell

    threads = torch.get_num_threads()
    try:
        return run_cell(ctx)
    finally:
        torch.set_num_threads(threads)  # run_cell sets its own; the next test file runs in this process


def test_a_sound_run_is_correct():
    result, checks, _ = _run(_ctx(2**31 + 11))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


def test_the_control_and_its_faults_are_not_correct():
    ctx = _ctx(2**31 + 11, readings=("control", "long", "nomask"))
    _, _, readings = _run(ctx)
    for name in ("control", "long", "nomask"):
        assert not harness.judge(readings[name], ctx.cell["limits"])[0], (name, readings)


def _no_mask(h, w, splits, device, dtype=torch.float32):
    return torch.zeros(splits * splits, (h // splits) * (w // splits), (h // splits) * (w // splits), dtype=dtype)


def _whole_grid_positions(features, splits):
    _, h, w, c = features.shape
    return features + sine_positions(h, w, c, features.device)


@pytest.mark.parametrize("fault", ["no mask", "whole-grid positions", "no propagation", "altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The shifted windows without their mask, positions of the whole grid
    in place of each window's, the matching's flow not propagated, or the
    flows 10% too long."""
    if fault == "no mask":
        monkeypatch.setattr(gmflow_module, "shift_window_mask", _no_mask)
    elif fault == "whole-grid positions":
        monkeypatch.setattr(gmflow_module, "add_window_positions", _whole_grid_positions)
    elif fault == "no propagation":
        monkeypatch.setattr(gmflow_module.FeatureFlowAttention, "forward", lambda self, f0, flow: flow)
    else:
        forward = GMFlow.forward

        def altered(self, a, b):
            flow, low = forward(self, a, b)
            return flow * 1.1, low

        monkeypatch.setattr(GMFlow, "forward", altered)
    result, checks, _ = _run(_ctx(2**31 + 11))
    assert not result["correct"], checks


@pytest.mark.parametrize("base, device_s, bound, want", [
    ("transformer_ms_per_pair", {"model.transformer": 0.064}, None, 1.0),
    ("match_ms_per_pair", {"model.match": 0.016, "model.propagate": 0.016}, None, 0.5),
    ("transformer_roofline", {"model.transformer": 0.064}, ("transformer_bound_s_per_pair", 2.5e-4), 25.0),
    ("match_roofline", {"model.match": 0.016, "model.propagate": 0.016}, ("match_bound_s_per_pair", 5e-5), 10.0),
])
def test_the_readers_read_their_spans_or_nothing(base, device_s, bound, want):
    from benchmark import tracing

    reader = harness.load_module(harness.BENCH / "metrics" / f"{base}.py", f"benchmark_metric_{base}")

    def trace(spans):
        raw = {"pairs": 64, "window_s": 1.0, "busy_s": 0.5, "category_s": {}, "group_s": {}, "launches": 8,
               "rate": 2.0, "flops_per_pair": 1.0, "peak_flops": 1.0, "gaps": {}, "calls": {}, "unit_calls": {}}
        if spans is not None:
            raw["span_device_s"] = spans
        if bound is not None:
            raw[bound[0]] = bound[1]
        return tracing.Trace.of(raw)

    assert reader.read(trace(device_s)) == pytest.approx(want)
    assert reader.read(trace(None)) is None
    assert reader.read(trace({"model.update": 1.0})) is None


# ---------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the fused attention runs only on CUDA tensors)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=1)
def _limit() -> float:
    return harness.load_cell(CELL)["limits"]["flow_gap_ratio"]


@pytest.mark.cuda
def test_a_bf16_forward_on_the_card_is_within_the_cells_limit(cuda_device, monkeypatch):
    """One bf16 ``GMFlow()`` forward at the cell's 448x1024 on the cell's
    draw of weights, B=2: on the fused attention (12 window and 2 global
    calls, none plain; the global ones R4's 2 launches) and on the plain
    path (the route of CPU tensors on the card), each held to the cell's
    ``flow_gap_ratio`` limit against the float32 reference, and the two
    paths within that limit of each other."""
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    ctx = _ctx(2**31 + 21)
    ctx.device = cuda_device
    tensors = loop.draw(reference.build(CONFIG, "meta"), ctx, torch.bfloat16)
    model = GMFlow().to(cuda_device, torch.bfloat16)
    model.load_state_dict(tensors)
    frames = harness.stream_frames(ctx.gen(1), 3, 448, 1024, (3, 1), cuda_device).float() / 255.0
    x0, x1 = frames[:2], frames[1:]
    attention.reset_attention_counts()
    reset_launch_counts()
    got = make_forward(model)(x0, x1)[0]
    assert attention.attention_counts() == {"window": 12, "global": 2, "scores": 0, "aggregate": 0, "plain": 0}
    assert {k: v for k, v in launch_counts().items() if v} == {"R4": 2}
    monkeypatch.setattr(attention, "_fused", lambda x: False)
    plain = make_forward(model)(x0, x1)[0]
    del model
    ref = reference.build(CONFIG, cuda_device)
    ref.load_state_dict({k: v.float() for k, v in tensors.items()})
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
        want, rounded = ref(x0, x1)[0], ref(x0, x1, "bf16")[0]
    base = harness._pair_gaps(rounded, want)
    assert (base > 0).all()
    for flow in (got, plain):
        assert (harness._pair_gaps(flow, want) <= _limit() * base).all(), (harness._pair_gaps(flow, want), base)
    assert (harness._pair_gaps(got, plain) <= _limit() * base).all(), (harness._pair_gaps(got, plain), base)


@pytest.mark.cuda
def test_the_global_attention_keeps_float32_on_the_card(cuda_device):
    """The fused global product against the plain one on the card, at the
    cell's 7168 keys: float32 out, within float32's rounding of the grid's
    coordinates (a bf16 output would miss by up to 0.25 px)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, c = 7168, 128
    q, k = (torch.randn(2, n, c, generator=g, device=cuda_device).to(torch.bfloat16) for _ in range(2))
    grid = gmflow_module.coords_grid(56, 128, cuda_device).expand(2, n, 2)
    attention.reset_attention_counts()
    fused = attention.global_attention(q, k, grid)
    assert attention.attention_counts()["global"] == 1 and fused.dtype == torch.float32
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / c**0.5
    want = torch.matmul(torch.softmax(scores, -1), grid)
    assert (fused - want).abs().max() < 1e-3


@pytest.mark.cuda
def test_a_warmed_forward_waits_on_nothing(cuda_device):
    """After its first forward on a device, a forward makes no copy from
    the host and no other call that waits for the card's queue."""
    model = GMFlow().to(cuda_device, torch.bfloat16)
    x = torch.rand(1, 448, 1024, 3, device=cuda_device)
    forward = make_forward(model)
    forward(x, x.flip(2))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flow = forward(x, x.flip(2))[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert flow.shape == (1, 448, 1024, 2)
