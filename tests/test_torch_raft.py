"""RAFT in the port (``pwcnet_tpu_torch.models.raft``, ``ops.corr_lookup``)
on the CPU, against the benchmark's plain reference
(``benchmark/reference/raft.py``) on seeded random weights with BatchNorm
statistics that are not the identity, against loop oracles of the lookup
and the convex upsample, and the benchmark's RAFT cell driven at a small
size: its work counts, its check, its spans.

The reference comparisons run at 128x160: RAFT's sampler divides by a
pyramid level's width less one, and below 128 pixels a side the coarsest
level is 1 wide, where the reference (as RAFT) reads NaN. The port pads
such a level and is held at 64x96 by the lookup's oracle instead.
"""

import functools
import importlib.util
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, raft_work
from benchmark.loops import raft as loop
from benchmark.reference import raft as reference
from pwcnet_tpu_torch.models.raft import RAFT, convex_upsample
from pwcnet_tpu_torch.ops.corr_lookup import corr_pyramid, lookup, lookup_plain
from pwcnet_tpu_torch.train_lib.step import make_forward
from pwcnet_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
CELL = "raft.iters32.bf16"
CONFIG = harness._json(harness.BENCH / "configs" / "raft.json")
H, W = 128, 160


def _ctx(seed: int, iters: int = 32, readings=()) -> harness.Ctx:
    cell = harness.load_cell(CELL)
    cell["config"]["iters"] = iters
    cell["traffic"].update(height=H, width=W, batch=2, pool=2, warm_batches=1, sample=2)
    return harness.Ctx(name=CELL, cell=cell, seed=seed, seconds=0.3, trace=False, device=torch.device("cpu"),
                       t_start=time.perf_counter(), readings=readings)


def _pair(seed: int, iters: int, dtype=torch.float32, h=H, w=W):
    """The port and the reference on the cell's draw of ``seed`` (in
    ``dtype``; the reference gets the same values in float32), and frames."""
    ctx = _ctx(seed, iters)
    tensors = loop.draw(reference.build(ctx.config, "meta"), ctx, dtype)
    port = RAFT(iters=iters).to(dtype)
    loop.load(port, tensors)
    ref = reference.build(ctx.config)
    loop.load(ref, {k: v.float() for k, v in tensors.items()})
    frames = harness.stream_frames(ctx.gen(1), 3, h, w, (3, 1), "cpu").float() / 255.0
    return port, ref, frames[:2], frames[1:]


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_float32_flows_match_the_reference(seed):
    port, ref, x0, x1 = _pair(seed, 12)
    with torch.no_grad():
        flow, low = port(x0, x1)
        want, want_low = ref(x0, x1)
    assert flow.shape == (2, H, W, 2) and low.shape == (2, H // 8, W // 8, 2)
    assert flow.dtype == low.dtype == torch.float32
    assert want_low.norm(dim=-1).mean() > 0.2  # the flows moved
    assert float(harness._pair_gaps(flow, want).max()) < 1e-5
    assert float(harness._pair_gaps(low, want_low).max()) < 1e-5


def test_module_names_and_parameter_count_are_rafts():
    port, ref = RAFT(), reference.build(CONFIG, "meta")
    names = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert names == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    for k in ("fnet.conv1.weight", "fnet.layer1.0.conv1.weight", "cnet.norm1.running_mean",
              "cnet.layer2.0.norm3.running_var", "cnet.layer2.0.downsample.1.running_var",
              "update_block.encoder.convc1.weight", "update_block.gru.convz1.weight",
              "update_block.flow_head.conv2.weight", "update_block.mask.0.weight", "update_block.mask.2.bias"):
        assert k in names, k
    assert names["update_block.gru.convz1.weight"] == (128, 384, 1, 5)
    assert names["update_block.gru.convq2.weight"] == (128, 384, 5, 1)
    assert not any("fnet" in k and "norm" in k for k in names)  # instance norm: no statistics
    count = sum(p.numel() for p in port.parameters())
    assert count == sum(p.numel() for p in ref.parameters()) == CONFIG["parameters"] == 5_257_536


def _bilinear_zero(m: np.ndarray, x: float, y: float) -> float:
    """``m`` (h, w) at (x, y) on pixel centres, zero outside."""
    x0, y0 = math.floor(x), math.floor(y)
    out = 0.0
    for yy, wy in ((y0, 1 - (y - y0)), (y0 + 1, y - y0)):
        for xx, wx in ((x0, 1 - (x - x0)), (x0 + 1, x - x0)):
            if 0 <= yy < m.shape[0] and 0 <= xx < m.shape[1]:
                out += wy * wx * float(m[yy, xx])
    return out


def test_lookup_matches_a_loop_oracle():
    """The pyramid (64x96 frames: levels 8x12, 4x6, 2x3, 1x1) and the
    lookup's 324 channels, coordinates in and out of the frame."""
    g = torch.Generator().manual_seed(0)
    b, c, h, w, r = 2, 8, 8, 12, 4
    f1, f2 = torch.randn(b, c, h, w, generator=g), torch.randn(b, c, h, w, generator=g)
    corr = np.einsum("bcp,bcq->bpq", f1.reshape(b, c, -1).numpy(), f2.reshape(b, c, -1).numpy()) / math.sqrt(c)
    maps = [corr.reshape(b * h * w, h, w)]
    while len(maps) < 4:
        m = maps[-1]
        hh, ww = m.shape[1] // 2, m.shape[2] // 2
        maps.append(m[:, :2 * hh, :2 * ww].reshape(-1, hh, 2, ww, 2).mean((2, 4)))
    pyramid = corr_pyramid(f1, f2, 4)
    for got, want in zip(pyramid, maps):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got[:, 0, :want.shape[1], :want.shape[2]].numpy(), want, rtol=1e-5, atol=1e-5)
    coords = torch.rand(b, h, w, 2, generator=g) * torch.tensor([w + 12.0, h + 12.0]) - 6.0
    out = lookup(pyramid, coords, r)
    assert out.shape == (b, 4 * 81, h, w) and out.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    want = np.zeros((b, 4 * 81, h, w))
    for n in range(b * h * w):
        bb, yy, xx = n // (h * w), (n // w) % h, n % w
        x, y = coords[bb, yy, xx].tolist()
        for k, m in enumerate(maps):
            for i in range(2 * r + 1):
                for j in range(2 * r + 1):
                    want[bb, 81 * k + 9 * i + j, yy, xx] = _bilinear_zero(m[n], x / 2**k + i - r, y / 2**k + j - r)
    assert np.abs(want).max() > 1 and (want == 0).any()  # taps inside and outside the maps
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_convex_upsample_matches_a_loop_oracle():
    g = torch.Generator().manual_seed(1)
    b, h, w = 2, 3, 4
    flow, mask = torch.randn(b, h, w, 2, generator=g) * 3, torch.randn(b, 576, h, w, generator=g)
    got = convex_upsample(flow, mask)
    assert got.shape == (b, 8 * h, 8 * w, 2) and got.dtype == torch.float32
    want = np.zeros((b, 8 * h, 8 * w, 2))
    f, m = flow.double().numpy(), mask.double().numpy()
    for bb in range(b):
        for oy in range(8 * h):
            for ox in range(8 * w):
                y, sy, x, sx = oy // 8, oy % 8, ox // 8, ox % 8
                logits = np.array([m[bb, 64 * t + 8 * sy + sx, y, x] for t in range(9)])
                weights = np.exp(logits - logits.max())
                weights /= weights.sum()
                for t in range(9):
                    yy, xx = y + t // 3 - 1, x + t % 3 - 1
                    if 0 <= yy < h and 0 <= xx < w:
                        want[bb, oy, ox] += weights[t] * 8 * f[bb, yy, xx]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_keeps_the_correlation_the_lookup_and_the_coordinates_in_float32(monkeypatch):
    import pwcnet_tpu_torch.models.raft as raft_module

    seen = []

    def watch(fn):
        def wrapped(*args):
            out = fn(*args)
            seen.append((fn.__name__, [a.dtype for a in args if torch.is_tensor(a)],
                         [o.dtype for o in (out if isinstance(out, list) else [out])]))
            return out
        return wrapped

    monkeypatch.setattr(raft_module, "corr_pyramid", watch(corr_pyramid))
    monkeypatch.setattr(raft_module, "lookup", watch(lookup))
    model = RAFT(iters=3).to(torch.bfloat16)
    x = torch.rand(1, 64, 96, 3)
    with torch.no_grad():
        flow, low = model(x, x.flip(2))
    assert flow.dtype == low.dtype == torch.float32
    assert seen[0] == ("corr_pyramid", [torch.float32] * 2, [torch.float32] * 4)
    assert seen[1:] == [("lookup", [torch.float32], [torch.float32])] * 3  # the coordinates in, the taps out
    assert model.update_block.gru.convz1.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [7, 2**31 + 7, 4_000_000_001])
def test_bf16_flow_is_within_4x_the_bf16_rounded_reference(seed):
    port, ref, x0, x1 = _pair(seed, 12, torch.bfloat16)
    with torch.no_grad():
        got = port(x0, x1)[0]
        want, rounded = ref(x0, x1)[0], ref(x0, x1, "bf16")[0]
    gap, base = harness._pair_gaps(got, want), harness._pair_gaps(rounded, want)
    assert (base > 0).all()
    assert (gap <= 4 * base).all(), (gap, base)


def test_frames_not_a_multiple_of_8_are_refused():
    x = torch.rand(1, 68, 96, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        RAFT(iters=1)(x, x)


def test_make_forward_serves_raft():
    model = RAFT(iters=2)
    x0, x1 = torch.rand(2, 64, 96, 3), torch.rand(2, 64, 96, 3)
    flow, low = make_forward(model)(x0, x1)
    with torch.no_grad():
        want, want_low = model(x0, x1)
    assert torch.equal(flow, want) and torch.equal(low, want_low)


def test_spans_of_a_forward():
    profiling.reset()
    profiling.enable(True)
    try:
        with torch.no_grad():
            RAFT(iters=4)(torch.rand(2, 64, 96, 3), torch.rand(2, 64, 96, 3))
        got = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert {k: v["count"] for k, v in got.items()} == {
        "model.forward": 1, "model.encode": 1, "model.corr": 1, "model.lookup": 4, "model.update": 4,
        "model.upsample": 1}
    assert got["model.forward"]["pairs"] == 2 and got["model.forward"]["parent"] is None
    assert all(v["parent"] == "model.forward" for k, v in got.items() if k != "model.forward")


# ---------------------------------------------------------- R1, the lookup's CUDA kernel
@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (R1 is a CUDA kernel with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_raft", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _lookup_inputs(b: int, h: int, w: int, device, seed: int = 0):
    """``chip_smoke.raft_lookup_inputs``: a pyramid of seeded features and
    coordinates inside the maps, out of them, on integer points and far
    outside."""
    return _chip_smoke().raft_lookup_inputs(torch, b, h, w, device, seed)


def _scale(pyramid) -> float:
    return max(float(m.abs().max()) for m in pyramid)


def test_lookup_on_cpu_tensors_is_the_plain_version_and_launches_nothing():
    from pwcnet_tpu_torch.ops.cuda import launch_counts

    pyramid, coords = _lookup_inputs(2, 8, 12, torch.device("cpu"))
    before = launch_counts()["R1"]
    got = lookup(pyramid, coords)
    assert torch.equal(got, lookup_plain(pyramid, coords))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert launch_counts()["R1"] == before


def _r1_box_misses(pyramid, coords):
    """R1's boxes (``csrc/corr_lookup.cu`` ``lookup_tap``, ``lookup_extent``)
    in NumPy float32, each operation rounded on its own as the kernel's
    ``__f*_rn``: on each axis of each level, the taps' floors and the 11-wide
    box from the extent of the first and last. Returns the corners in the
    map of taps that reach it which the box would not hold (counted per
    axis), and whether each query reaches some map."""
    f32 = np.float32
    xy = coords.reshape(-1, 2).numpy()
    offsets = np.arange(-4, 5, dtype=f32)
    missed, reaching = 0, np.zeros(xy.shape[0], bool)
    for k, m in enumerate(pyramid):
        reach = []
        for a, size in ((0, m.shape[3]), (1, m.shape[2])):
            span = f32(size - 1)
            at = (xy[:, a:a + 1] / f32(2**k)).astype(f32) + offsets
            pos = (((f32(2) * at) / span - f32(1) + f32(1)) * f32(0.5)) * span
            fl = np.floor(pos)
            valid = (fl >= -1) & (fl <= span)
            lo, hi = np.maximum(fl[:, :1], -1), np.minimum(fl[:, -1:] + 1, span)
            origin = np.where(lo <= hi, lo, 0)
            count = np.where(lo <= hi, np.minimum(hi - origin + 1, 11), 0)
            for corner in (fl, fl + 1):
                in_map = valid & (corner >= 0) & (corner <= span)
                missed += int((in_map & ((corner < origin) | (corner - origin >= count))).sum())
            reach.append(valid.any(1))
        reaching |= reach[0] & reach[1]
    return missed, reaching


@pytest.mark.parametrize("b,h,w", [(2, 8, 12), (1, 16, 20)])
def test_r1_box_holds_every_corner_in_its_map(b, h, w):
    """The kernel blends each level's taps from one 11x11 box that it loads
    from the extent of the first and last taps' floors: every corner in the
    map of a tap that reaches it lies in the loaded part of the box, and the
    far coordinates reach no map (so read exact zeros)."""
    pyramid, coords = _lookup_inputs(b, h, w, torch.device("cpu"), seed=h)
    missed, reaching = _r1_box_misses(pyramid, coords)
    assert missed == 0
    assert not reaching[::7].any() and reaching.mean() > 0.5


@pytest.mark.parametrize("fault", ["levels", "radius", "coords", "side_1", "float64", "grad", "cpu"])
def test_r1_refuses_what_it_does_not_take(fault):
    """The wrapper's checks, which all run before the launch (so on CPU
    tensors here): RAFT's 4 levels of radius 4, padded levels, float32, no
    grad, CUDA tensors."""
    from pwcnet_tpu_torch.ops.cuda.corr_lookup import corr_lookup_cuda

    pyramid, coords = _lookup_inputs(1, 8, 12, torch.device("cpu"))
    radius, want = 4, (ValueError, "CUDA device")
    if fault == "levels":
        pyramid, want = pyramid[:3], (ValueError, "4 levels of radius 4")
    elif fault == "radius":
        radius, want = 3, (ValueError, "4 levels of radius 4")
    elif fault == "coords":
        coords, want = coords[..., :1], (ValueError, r"\(B, h, w, 2\)")
    elif fault == "side_1":
        pyramid[3], want = pyramid[3][:, :, :1, :1], (ValueError, "sides of at least 2")
    elif fault == "float64":
        coords, want = coords.double(), (TypeError, "float32")
    elif fault == "grad":
        pyramid[0].requires_grad_(True)
        want = (RuntimeError, "no backward")
    before = corr_lookup_cuda.launches
    with pytest.raises(want[0], match=want[1]):
        corr_lookup_cuda(pyramid, coords, radius)
    assert corr_lookup_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 8, 12), (2, 16, 20), (2, 56, 128)])
def test_r1_matches_the_plain_lookup_on_the_card(cuda_device, b, h, w):
    """64x96 (levels 8x12 ... 1x1, padded to 2x2), 128x160 and 448x1024
    frames. Tolerance: float32, 1e-5 + 1e-5 of the maps' scale, since the
    plain path on the card samples through cuDNN's grid sampler, which
    rounds the positions and the blend its own way; against the plain
    version on the CPU, which rounds the positions as the kernel does,
    1e-6 of the scale."""
    from pwcnet_tpu_torch.ops.cuda.corr_lookup import corr_lookup_cuda

    pyramid, coords = _lookup_inputs(b, h, w, cuda_device, seed=h)
    before = corr_lookup_cuda.launches
    with torch.inference_mode():
        got = lookup(pyramid, coords)
        want = lookup_plain(pyramid, coords)
    torch.cuda.synchronize()
    assert corr_lookup_cuda.launches == before + 1
    assert got.shape == (b, 324, h, w) and got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    scale = _scale(pyramid)
    assert float((got - want).abs().max()) <= 1e-5 + 1e-5 * scale
    outside = got.permute(0, 2, 3, 1).reshape(-1, 324)[::7]
    assert bool((outside == 0).all()) and bool((want.permute(0, 2, 3, 1).reshape(-1, 324)[::7] == 0).all())
    assert float(got.abs().max()) > 0.1 * scale  # taps inside the maps too
    if h * w <= 16 * 20:
        cpu = lookup_plain([m.cpu() for m in pyramid], coords.cpu())
        assert float((got.cpu() - cpu).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_r1_reads_past_2_gib_of_level_0(cuda_device):
    """B=12 at 448x1024: level 0 is 86 016 maps of 56x128 floats, 2.47 GB,
    so the last frame's maps lie past 2**31 bytes; its queries against the
    plain version on those maps alone."""
    b, h, w = 12, 56, 128
    pyramid, coords = _lookup_inputs(b, h, w, cuda_device, seed=12)
    assert pyramid[0].numel() * 4 > 2**31
    with torch.inference_mode():
        got = lookup(pyramid, coords)[-1:]
        want = lookup_plain([m[-h * w:] for m in pyramid], coords[-1:])
    assert float((got - want).abs().max()) <= 1e-5 + 1e-5 * _scale(pyramid)
    assert float(got.abs().max()) > 0


@pytest.mark.cuda
def test_r1_launches_once_a_lookup_and_refuses_grad(cuda_device):
    """One R1 launch a `lookup` call and 32 a `RAFT(iters=32)` forward; a
    pyramid that requires grad under grad mode is refused."""
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    pyramid, coords = _lookup_inputs(1, 16, 20, cuda_device)
    reset_launch_counts()
    with torch.no_grad():
        lookup(pyramid, coords)
    assert {k: v for k, v in launch_counts().items() if v} == {"R1": 1}
    model = RAFT(iters=32).to(cuda_device, torch.bfloat16)
    x = torch.rand(1, 128, 160, 3, device=cuda_device)
    reset_launch_counts()
    flow, _ = make_forward(model)(x, x.roll(3, 2))
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {"R1": 32}
    assert bool(flow.isfinite().all())
    pyramid[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        lookup(pyramid, coords)


# ---------------------------------------------------------- the benchmark
def test_conv_and_corr_flops_match_the_flop_counter():
    cfg = dict(CONFIG, iters=2)
    ref = reference.build(cfg)
    x = torch.rand(1, H, W, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(x, x)
    want = counter.get_total_flops()
    assert raft_work.conv_flops(cfg, H, W) + raft_work.corr_flops(cfg, H, W) == want
    assert want < raft_work.pair_flops(cfg, H, W) < 1.02 * want


def test_work_counts_at_the_cell_size():
    """Hand-worked at 448x1024: 56 x 128 = 7168 query pixels."""
    px = 7168
    # per pixel: 4 levels x (10 x 10 window + 81 outputs) + 2 coordinates, 4 bytes each
    assert raft_work.lookup_work(CONFIG, 448, 1024) == (px * (4 * (100 + 81) + 2) * 4, px * 4 * 81 * 7)
    assert raft_work.lookup_work(CONFIG, 448, 1024)[0] == 20_815_872  # 20.8 MB a pair and update
    product, *pools = raft_work.corr_volume_work(CONFIG, 448, 1024)
    assert product == ((2 * px * 256 + px * px) * 4, 2 * px * px * 256 + px * 256)
    assert [p[0] for p in pools] == [px * (56 * 128 + 28 * 64) * 4, px * (28 * 64 + 14 * 32) * 4,
                                     px * (14 * 32 + 7 * 16) * 4]
    assert raft_work.corr_flops(CONFIG, 448, 1024) == 26_306_674_688
    # 32 updates of 38.36 GFLOP of convs, the encoders' 0.19 TFLOP, the mask once
    assert 1.42e12 < raft_work.conv_flops(CONFIG, 448, 1024) < 1.43e12
    # the bound: the product at the float32 peak, the rest at the card's bandwidth
    assert raft_work.corr_volume_bound(CONFIG, 448, 1024) == pytest.approx(
        (2 * px * px * 256 + px * 256) / 67e12 + sum(p[0] for p in pools) / 3.35e12)
    assert raft_work.lookup_bound(CONFIG, 448, 1024) == pytest.approx(32 * 20_815_872 / 3.35e12)


def test_the_cell_draws_batchnorm_statistics_that_are_not_the_identity():
    ctx = _ctx(11)
    tensors = loop.draw(reference.build(ctx.config, "meta"), ctx, torch.float32)
    means = [v for k, v in tensors.items() if k.endswith("running_mean")]
    variances = [v for k, v in tensors.items() if k.endswith("running_var")]
    assert len(means) == len(variances) == 15  # cnet's norms, each shortcut's once
    assert all(m.abs().max() > 0.05 for m in means) and all((v - 1).abs().max() > 0.2 for v in variances)
    again = loop.draw(reference.build(ctx.config, "meta"), _ctx(11), torch.float32)
    assert all(torch.equal(tensors[k], again[k]) for k in tensors)


def _run(ctx):
    from benchmark.run import run_cell

    threads = torch.get_num_threads()
    try:
        return run_cell(ctx)
    finally:
        torch.set_num_threads(threads)  # run_cell sets its own; the next test file runs in this process


def test_a_sound_run_is_correct():
    result, checks, _ = _run(_ctx(2**31 + 11, iters=8))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


def test_the_control_is_not_correct():
    ctx = _ctx(2**31 + 11, iters=8, readings=("control",))
    _, _, readings = _run(ctx)
    assert not harness.judge(readings["control"], ctx.cell["limits"])[0], readings


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The forward runs on the first half of each batch (the rest repeats
    it), or its flows come out 10% too long."""
    forward = RAFT.forward

    def broken(self, a, b):
        if fault == "altered":
            flow, low = forward(self, a, b)
            return flow * 1.1, low
        n = a.shape[0] // 2
        flow, low = forward(self, a[:n], b[:n])
        return torch.cat([flow, flow[:a.shape[0] - n]]), torch.cat([low, low[:a.shape[0] - n]])

    monkeypatch.setattr(RAFT, "forward", broken)
    result, checks, _ = _run(_ctx(2**31 + 11, iters=8))
    assert not result["correct"], checks
