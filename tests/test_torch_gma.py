"""GMA in the port (``pwcnet_tpu_torch.models.gma``, the global softmax and
aggregation of ``ops.attention``, the aggregation's epilogue of
``ops.raft_update``) on the CPU, against the benchmark's plain reference
(``benchmark/reference/gma.py``) on the cell's seeded draw of weights
(``gamma`` 0.5, not GMA's initial 0); the parameter count and names at
published widths; the spans and the counters; the plain operations against
loop oracles; the benchmark's GMA cell driven at a small size: its work
counts and the faults its check must catch. The kernels R5 and R6, the
card's attention path and a bf16 forward at the cell's 1088x1920 are held
on the card (``-m cuda``).

The reference comparisons run at 128x128, 4 updates: RAFT's sampler divides
by a pyramid level's side less one, and below 128 pixels a side the
coarsest level has a side of 1, where the reference (as GMA) reads NaN.
The rest runs at 64x128.
"""

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import gma_work, harness, raft_work
from benchmark.loops import gma as loop
from benchmark.reference import gma as reference
from pwcnet_tpu_torch.models import gma as gma_module
from pwcnet_tpu_torch.models.conv import to_nchw
from pwcnet_tpu_torch.models.gma import GMA
from pwcnet_tpu_torch.ops import attention
from pwcnet_tpu_torch.ops.raft_update import aggregate_epilogue, aggregate_epilogue_plain
from pwcnet_tpu_torch.train_lib.step import make_forward
from pwcnet_tpu_torch.utils import profiling

CELL = "gma.1080p.iters32.bf16"
CONFIG = harness._json(harness.BENCH / "configs" / "gma.json")
H, W = 128, 128


def _ctx(seed: int, iters: int = 4, readings=(), h: int = H, w: int = W) -> harness.Ctx:
    cell = harness.load_cell(CELL)
    cell["config"]["iters"] = iters
    cell["traffic"].update(height=h, width=w, batch=2, pool=2, warm_batches=1, sample=2)
    return harness.Ctx(name=CELL, cell=cell, seed=seed, seconds=0.2, trace=False, device=torch.device("cpu"),
                       t_start=time.perf_counter(), readings=readings)


def _pair(seed: int, iters: int = 4, dtype=torch.float32):
    """The port and the reference on the cell's draw of ``seed`` (in
    ``dtype``; the reference gets the same values in float32), and frames."""
    ctx = _ctx(seed, iters)
    tensors = loop.draw(reference.build(ctx.config, "meta"), ctx, dtype)
    port = GMA(iters=iters).to(dtype)
    loop.load(port, tensors)
    ref = reference.build(ctx.config)
    loop.load(ref, {k: v.float() for k, v in tensors.items()})
    frames = harness.stream_frames(ctx.gen(1), 3, H, W, (3, 1), "cpu").float() / 255.0
    return port, ref, frames[:2], frames[1:]


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_float32_flows_match_the_reference(seed):
    """float32 on both sides: the port's scale on the scores, the
    reference's on q, and the sums' order differ by float32 rounding,
    which 4 updates of RAFT's block carry to 0.8-5e-6 of the flow (4 seeds)."""
    port, ref, x0, x1 = _pair(seed)
    assert float(port.update_block.aggregator.gamma.detach()) == loop.GAMMA
    with torch.no_grad():
        flow, low = port(x0, x1)
        want, want_low = ref(x0, x1)
    assert flow.shape == (2, H, W, 2) and low.shape == (2, H // 8, W // 8, 2)
    assert flow.dtype == low.dtype == torch.float32
    assert want_low.norm(dim=-1).mean() > 0.1  # the flows moved
    assert float(harness._pair_gaps(flow, want).max()) < 1e-5
    assert float(harness._pair_gaps(low, want_low).max()) < 1e-5
    with torch.no_grad():  # the aggregation is a real part of the answer
        port.update_block.aggregator.gamma.zero_()
        without = port(x0, x1)[0]
    assert float(harness._pair_gaps(without, want).max()) > 100 * float(harness._pair_gaps(flow, want).max())


def test_module_names_and_parameter_count_are_gmas():
    port, ref = GMA(), reference.build(CONFIG, "meta")
    names = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert names == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert names["att.to_qk.weight"] == (256, 128, 1, 1)
    assert names["att.pos_emb.rel_height.weight"] == names["att.pos_emb.rel_width.weight"] == (319, 128)
    assert names["att.pos_emb.rel_ind"] == (160, 160)
    assert names["update_block.aggregator.to_v.weight"] == (128, 128, 1, 1)
    assert names["update_block.aggregator.gamma"] == (1,)
    assert names["update_block.gru.convz1.weight"] == (128, 512, 1, 5)
    assert names["update_block.gru.convq2.weight"] == (128, 512, 5, 1)
    assert not any("project" in k for k in names)  # one head of 128: no projection
    with torch.device("meta"):
        count = sum(p.numel() for p in GMA().parameters())
    assert count == sum(p.numel() for p in ref.parameters()) == CONFIG["parameters"] == 5_879_873
    raft_count = harness._json(harness.BENCH / "configs" / "raft.json")["parameters"]
    assert count - raft_count == 32_768 + 2 * 319 * 128 + 16_384 + 1 + 6 * 128 * 128 * 5


def test_frames_not_a_multiple_of_8_are_refused():
    x = torch.rand(1, 68, 96, 3)
    with pytest.raises(ValueError, match="GMA needs H and W multiples of 8"):
        GMA(iters=1)(x, x)


def test_make_forward_serves_gma():
    model = GMA(iters=2)
    x0, x1 = torch.rand(2, 64, 128, 3), torch.rand(2, 64, 128, 3)
    flow, low = make_forward(model)(x0, x1)
    with torch.no_grad():
        want, want_low = model(x0, x1)
    assert torch.equal(flow, want) and torch.equal(low, want_low)


def test_spans_and_counters_of_a_forward():
    """``model.attend`` once after ``model.encode``; ``model.aggregate``
    inside each ``model.update``. On CPU tensors the attention's two
    operations count ``plain`` (1 + iters) and launch nothing."""
    from pwcnet_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    attention.reset_attention_counts()
    profiling.reset()
    profiling.enable(True)
    try:
        with torch.no_grad():
            GMA(iters=4)(torch.rand(2, 64, 128, 3), torch.rand(2, 64, 128, 3))
        got = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert {k: v["count"] for k, v in got.items()} == {
        "model.forward": 1, "model.encode": 1, "model.attend": 1, "model.corr": 1, "model.lookup": 4,
        "model.update": 4, "model.aggregate": 4, "model.upsample": 1}
    assert got["model.aggregate"]["parent"] == "model.update"
    assert all(v["parent"] == "model.forward" for k, v in got.items() if k not in ("model.forward", "model.aggregate"))
    assert attention.attention_counts() == {"window": 0, "global": 0, "scores": 0, "aggregate": 0, "plain": 5}
    assert launch_counts() == before


# ---------------------------------------------------------- the plain operations against loop oracles
def test_global_softmax_plain_matches_a_loop_oracle(monkeypatch):
    """Every row a softmax over the keys of the scores scaled by 1 /
    sqrt(C), in blocks of rows (here 3 a block, the last one short),
    rounded once to q's dtype."""
    monkeypatch.setattr(attention, "SCORE_BLOCK_BYTES", 4 * 2 * 11 * 3)
    assert attention.score_rows(2, 11) == 3
    g = torch.Generator().manual_seed(4)
    b, n, c = 2, 11, 8
    q, k = (2 * torch.randn(b, n, c, generator=g, dtype=torch.float64) for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd = q.to(dtype), k.to(dtype)
        got = attention.global_softmax(qd, kd)
        assert got.dtype == dtype and got.shape == (b, n, n)
        qf, kf = qd.double(), kd.double()
        for i in range(b):
            for r in range(n):
                scores = [sum(qf[i, r, j] * kf[i, col, j] for j in range(c)) / math.sqrt(c) for col in range(n)]
                top = max(scores)
                e = [math.exp(s - top) for s in scores]
                want = torch.tensor([x / sum(e) for x in e], dtype=torch.float64)
                tol = 1e-6 if dtype == torch.float32 else 2**-8
                assert torch.allclose(got[i, r].double(), want, rtol=tol, atol=1e-7), (dtype, i, r)


def test_aggregate_plain_matches_a_loop_oracle():
    g = torch.Generator().manual_seed(5)
    p = torch.softmax(torch.randn(2, 6, 6, generator=g), -1)
    v = torch.randn(2, 6, 3, generator=g)
    got = attention.aggregate(p.to(torch.bfloat16), v.to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (2, 6, 3)
    pb, vb = p.to(torch.bfloat16).double(), v.to(torch.bfloat16).double()
    for i in range(2):
        for r in range(6):
            for d in range(3):
                want = sum(pb[i, r, j] * vb[i, j, d] for j in range(6))
                assert abs(float(got[i, r, d]) - float(want)) < 1e-6


def _slots(g, b, h, w, dtype=torch.float32):
    """A 512-channel buffer as GMA's update lays it out, random, and its
    ``mf`` slot (channels 256-383) and global slots (384-511) of two such."""
    a = to_nchw(torch.randn(b, h, w, 512, generator=g).to(dtype))
    q = to_nchw(torch.zeros(b, h, w, 512, dtype=dtype))
    return a, q, a[:, 256:384], (a[:, 384:], q[:, 384:])


def test_aggregate_epilogue_plain_matches_a_loop_oracle():
    """``mf + gamma agg``, the product and the sum each rounded in float32,
    then once to the slots' dtype, into both global slots and nowhere else."""
    g = torch.Generator().manual_seed(6)
    b, h, w = 1, 2, 3
    for dtype in (torch.float32, torch.bfloat16):
        a, q, mf, globals_ = _slots(g, b, h, w, dtype)
        before_a, before_q = a.clone(), q.clone()
        agg = torch.randn(b, h * w, 128, generator=g)
        gamma = torch.tensor([0.375]).to(dtype)
        aggregate_epilogue(mf, agg, gamma, *globals_)
        for y in range(h):
            for x in range(w):
                for ch in range(128):
                    m = mf[0, ch, y, x].float()
                    prod = torch.tensor(float(gamma), dtype=torch.float32) * agg[0, y * w + x, ch]
                    want = (m + prod).to(dtype)
                    assert a[0, 384 + ch, y, x] == want and q[0, 384 + ch, y, x] == want
        assert torch.equal(a[:, :384], before_a[:, :384]) and torch.equal(q[:, :384], before_q[:, :384])


@pytest.mark.parametrize("op,fault", [(op, fault) for op in ("softmax", "epilogue")
                                      for fault in ("cpu", "dtype", "grad", "shape")])
def test_r5_r6_refuse_what_they_do_not_take(op, fault):
    """The wrappers' checks, which all run before the launch (so on CPU
    tensors here). Nothing launches."""
    from pwcnet_tpu_torch.ops.cuda import global_attention as r5
    from pwcnet_tpu_torch.ops.cuda import launch_counts
    from pwcnet_tpu_torch.ops.cuda import raft_update as r6

    g = torch.Generator().manual_seed(7)
    if op == "softmax":
        args = [torch.randn(2, 3, 5, generator=g), 0.5, torch.empty(2, 3, 5, dtype=torch.bfloat16)]
        fn = r5.attention_softmax_cuda
    else:
        _, _, mf, globals_ = _slots(g, 1, 2, 3)
        args = [mf, torch.randn(1, 6, 128, generator=g), torch.tensor([0.5]), *globals_]
        fn = r6.aggregate_epilogue_cuda
    want = {"cpu": (ValueError, "CUDA device"), "dtype": (TypeError, None), "grad": (RuntimeError, "no backward"),
            "shape": (ValueError, None)}[fault]
    if fault == "dtype":
        args[2] = args[2].to(torch.float64)
    elif fault == "grad":
        args[0].requires_grad_(True)
    elif fault == "shape":
        args[1 if op == "epilogue" else 0] = args[1 if op == "epilogue" else 0][:, :-1]
    before = {k: launch_counts()[k] for k in ("R5", "R6")}
    with pytest.raises(want[0], match=want[1]):
        fn(*args)
    assert {k: launch_counts()[k] for k in ("R5", "R6")} == before


# ---------------------------------------------------------- the benchmark
def test_conv_and_matmul_flops_match_the_flop_counter():
    cfg = dict(CONFIG, iters=2)
    ref = reference.build(cfg)
    x = torch.rand(1, 128, 160, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(x, x)
    want = counter.get_total_flops()
    assert gma_work.conv_flops(cfg, 128, 160) + gma_work.matmul_flops(cfg, 128, 160) == want
    assert want < gma_work.pair_flops(cfg, 128, 160) < 1.02 * want


def test_work_counts_at_the_cell_size():
    """Hand-worked at 1088x1920: a 136x240 grid, N = 32 640 pixels."""
    n = 136 * 240
    assert gma_work.matmul_flops(CONFIG, 1088, 1920) - raft_work.corr_flops(CONFIG, 1088, 1920) == 33 * 2 * n * n * 128
    assert 17.09e12 < gma_work.pair_flops(CONFIG, 1088, 1920) < 17.10e12  # 8.73 TF of it the 32 aggregations
    assert 2.11e12 < gma_work.pair_flops(CONFIG, 448, 1024) < 2.12e12
    assert gma_work.aggregate_work(CONFIG, 1088, 1920) == (33 * 2 * n * 128 * 2, 33 * 2 * n * n * 128)
    # compute-bound: 9.0 TFLOP at 989 TFLOP/s, 0.55 GB at 3.35 TB/s
    assert gma_work.aggregate_bound(CONFIG, 1088, 1920) == pytest.approx(33 * 2 * n * n * 128 / 989e12)


def test_the_cell_draws_gamma_and_the_scaled_query_key():
    ctx = _ctx(11)
    tensors = loop.draw(reference.build(ctx.config, "meta"), ctx, torch.bfloat16)
    assert float(tensors["update_block.aggregator.gamma"]) == 0.5
    from benchmark.loops import raft as raft_loop

    plain = raft_loop.draw(reference.build(ctx.config, "meta"), _ctx(11), torch.bfloat16)
    assert torch.equal(tensors["att.to_qk.weight"], plain["att.to_qk.weight"] * loop.QK_SCALE)
    again = loop.draw(reference.build(ctx.config, "meta"), _ctx(11), torch.bfloat16)
    assert all(torch.equal(tensors[k], again[k]) for k in tensors)


def _run(ctx):
    from benchmark.run import run_cell

    threads = torch.get_num_threads()
    try:
        return run_cell(ctx)
    finally:
        torch.set_num_threads(threads)  # run_cell sets its own; the next test file runs in this process


SEED = 2**31 + 11


def test_a_sound_run_is_correct_and_the_control_and_faults_are_not():
    """The program passes; the fp8 control, the reference with ``gamma``
    at 0, with its softmax over the queries and with its scores rounded to
    bf16 fail the cell's limits."""
    ctx = _ctx(SEED, readings=("control", "gamma0", "queries", "bf16_scores"))
    result, checks, readings = _run(ctx)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    for name in ("control", "gamma0", "queries", "bf16_scores"):
        assert not harness.judge(readings[name], ctx.cell["limits"])[0], (name, readings)


def test_score_ulps_reads_a_rounded_float32_softmax_within_half_a_unit():
    """`loop.score_ulps`: a float32 softmax of float32 scores rounded once
    to bf16 reads half a unit in the last place and a little more; the same
    scores rounded to bf16 first read several units."""
    g = torch.Generator().manual_seed(5)
    q, k = (torch.randn(2, n, 128, generator=g).to(torch.bfloat16) for n in (8, 300))
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(128)
    got = loop.score_ulps(torch.softmax(scores, dim=-1).to(torch.bfloat16), q, k)
    assert 0.45 < got["program"] <= 0.51 and got["bf16_scores"] > 2, got


def _broken_aggregate(self, s):
    """The aggregation left out: ``mf`` into the global slots, as ``gamma`` 0 gives."""
    for out in s.globals:
        out.copy_(s.mf)


def _queries_softmax(q, k):
    b, n, c = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
    return torch.softmax(scores, dim=1).to(q.dtype)


@pytest.mark.parametrize("fault", ["gamma0", "queries", "long"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The program's own aggregation left out, its softmax over the queries,
    or its flows 10% too long."""
    if fault == "gamma0":
        monkeypatch.setattr(gma_module.Aggregate, "forward", _broken_aggregate)
    elif fault == "queries":
        monkeypatch.setattr(gma_module, "global_softmax", _queries_softmax)
    else:
        forward = GMA.forward

        def longer(self, a, b):
            flow, low = forward(self, a, b)
            return flow * 1.1, low

        monkeypatch.setattr(GMA, "forward", longer)
    result, checks, _ = _run(_ctx(SEED))
    assert not result["correct"], checks


def test_scores_rounded_to_bf16_are_not_correct(monkeypatch):
    """A program that rounds its float32 scores to bf16 before the softmax
    (a bf16-output score GEMM): its flows stay within the cell's own
    rounding, so ``flow_gap_ratio`` passes it, and ``score_ulps`` fails it."""
    def rounded_scores(q, k, scale):
        scores = (torch.matmul(q.float(), k.float().transpose(1, 2)) * scale).to(torch.bfloat16).float()
        return torch.softmax(scores, dim=-1).to(q.dtype)

    monkeypatch.setattr(attention, "_softmax_plain", rounded_scores)
    ctx = _ctx(SEED)
    result, checks, readings = _run(ctx)
    assert not result["correct"], checks
    limits = ctx.cell["limits"]
    assert readings["program"]["flow_gap_ratio"] <= limits["flow_gap_ratio"], (readings, limits)
    assert readings["program"]["score_ulps"] > limits["score_ulps"], (readings, limits)


# ---------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (R5 and R6 are CUDA kernels with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,n", [(1, 5, 7), (2, 3, 130), (2, 64, 2048), (1, 8, 32640)])
def test_r5_matches_the_plain_softmax_on_the_card(cuda_device, b, r, n):
    """R5 against ``torch.softmax`` of the scaled float32 scores, rounded to
    bf16: each probability within one bf16 rounding (the kernel's exp and
    sums are float32 too, in another order), rows written into a strided
    view of (B, N, N) probabilities and nowhere else."""
    from pwcnet_tpu_torch.ops.cuda.global_attention import attention_softmax_cuda

    g = torch.Generator(device=cuda_device).manual_seed(b * r + n)
    scores = 4 * torch.randn(b, r, n, generator=g, device=cuda_device)
    p = torch.zeros(b, n, n, dtype=torch.bfloat16, device=cuda_device)
    r0 = min(2, n - r)
    before = attention_softmax_cuda.launches
    attention_softmax_cuda(scores, 0.125, p[:, r0:r0 + r])
    torch.cuda.synchronize()
    assert attention_softmax_cuda.launches == before + 1
    want = torch.softmax(scores * 0.125, dim=-1)
    got = p[:, r0:r0 + r].float()
    assert float(((got - want).abs() - want * 2**-8).max()) <= 1e-7
    assert not p[:, :r0].any() and not p[:, r0 + r:].any()
    assert torch.allclose(got.sum(-1), torch.ones(b, r, device=cuda_device), atol=n * 2**-9 / 16 + 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(2, 300), (1, 7168)])
def test_the_cards_global_softmax_and_aggregate_match_the_plain_path(cuda_device, b, n, monkeypatch):
    """`global_softmax` on bf16 CUDA tensors (cuBLAS's float32 scores, R5, in
    blocks of rows with a short last block) against the plain path on the
    card; `aggregate` against a float32 product of the same bf16 operands;
    the counters; float32 operands refused."""
    monkeypatch.setattr(attention, "SCORE_BLOCK_BYTES", 4 * b * n * 97)
    g = torch.Generator(device=cuda_device).manual_seed(n)
    q, k = (torch.randn(b, n, 128, generator=g, device=cuda_device).to(torch.bfloat16) for _ in range(2))
    v = torch.randn(b, n, 128, generator=g, device=cuda_device).to(torch.bfloat16)
    attention.reset_attention_counts()
    with torch.inference_mode():
        p = attention.global_softmax(q, k)
        out = attention.aggregate(p, v)
    want = attention._softmax_plain(q, k, 1 / math.sqrt(128))
    assert float(((p.float() - want.float()).abs() - want.float() * 2**-7).max()) <= 1e-7
    assert out.dtype == torch.float32
    exact = torch.matmul(p.float(), v.float())
    assert float((out - exact).abs().max()) <= 1e-4 * float(exact.abs().max())
    assert attention.attention_counts() == {"window": 0, "global": 0, "scores": 1, "aggregate": 1, "plain": 0}
    with pytest.raises(TypeError, match="bfloat16"):
        attention.global_softmax(q.float(), k.float())
    with pytest.raises(TypeError, match="bfloat16"):
        attention.aggregate(p.float(), v.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("b,h,w", [(2, 136, 240), (1, 5, 7)])
def test_r6_is_the_plain_epilogue_bit_for_bit(cuda_device, b, h, w, dtype):
    from pwcnet_tpu_torch.ops.cuda.raft_update import aggregate_epilogue_cuda

    g = torch.Generator(device=cuda_device).manual_seed(h)
    a = to_nchw(torch.randn(b, h, w, 512, generator=g, device=cuda_device).to(dtype))
    a2 = a.clone(memory_format=torch.channels_last)
    q, q2 = (to_nchw(torch.zeros(b, h, w, 512, dtype=dtype, device=cuda_device)) for _ in range(2))
    agg = torch.randn(b, h * w, 128, generator=g, device=cuda_device)
    gamma = torch.tensor([0.375], device=cuda_device).to(dtype)
    before = aggregate_epilogue_cuda.launches
    aggregate_epilogue(a[:, 256:384], agg, gamma, a[:, 384:], q[:, 384:])
    aggregate_epilogue_plain(a2[:, 256:384], agg, gamma, a2[:, 384:], q2[:, 384:])
    torch.cuda.synchronize()
    assert aggregate_epilogue_cuda.launches == before + 1
    assert torch.equal(a, a2) and torch.equal(q, q2)


@pytest.mark.cuda
def test_a_bf16_forward_at_the_cells_size_is_within_its_limit_and_counts(cuda_device):
    """One bf16 ``GMA(iters=32)`` forward at the cell's 1088x1920 on the
    cell's draw, B=2: one score call and 32 aggregations a forward, R5 once
    a block of rows, R6 once an update, RAFT's R1-R3 as in RAFT; each pair
    against the float32 reference within the cell's ``flow_gap_ratio``."""
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    ctx = _ctx(2**31 + 21, iters=32, h=1088, w=1920)
    ctx.device = cuda_device
    tensors = loop.draw(reference.build(ctx.config, "meta"), ctx, torch.bfloat16)
    model = GMA(iters=32).to(cuda_device, torch.bfloat16)
    loop.load(model, tensors)
    frames = harness.stream_frames(ctx.gen(1), 3, 1088, 1920, (3, 1), cuda_device).float() / 255.0
    x0, x1 = frames[:2], frames[1:]
    reset_launch_counts()
    attention.reset_attention_counts()
    got = make_forward(model)(x0, x1)[0]
    torch.cuda.synchronize()
    n = 136 * 240
    blocks = -(-n // attention.score_rows(2, n))
    assert attention.attention_counts() == {"window": 0, "global": 0, "scores": 1, "aggregate": 32, "plain": 0}
    assert {k: v for k, v in launch_counts().items() if v} == {
        "R1": 32, "R2": 7 * 32, "R3": 4 * 32, "R5": blocks, "R6": 32}
    del model
    torch.cuda.empty_cache()
    ref = reference.build(ctx.config, cuda_device)
    loop.load(ref, {k: v.float() for k, v in tensors.items()})
    limit = harness.load_cell(CELL)["limits"]["flow_gap_ratio"]
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
        for i in range(2):
            want, rounded = ref(x0[i:i + 1], x1[i:i + 1])[0], ref(x0[i:i + 1], x1[i:i + 1], "bf16")[0]
            base = harness._pair_gaps(rounded, want)
            assert (base > 0).all()
            assert (harness._pair_gaps(got[i:i + 1], want) <= limit * base).all()
