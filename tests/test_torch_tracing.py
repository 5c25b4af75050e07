"""The port's spans (``pwcnet_tpu_torch.utils.profiling``) on the CPU: off
they record nothing and touch neither the clock nor the profiler; on they
count, sum pairs and split total from self time by nesting; the train step,
both models' forwards and ``predict_sequence`` open the spans the benchmark
reads; inside ``torch.profiler`` each span is a prefixed range of the trace."""

import json
import threading

import numpy as np
import pytest
import torch

from pwcnet_tpu_torch.utils import profiling

TINY = dict(num_levels=3, output_level=1, search_range=2)


@pytest.fixture
def spans_on():
    profiling.reset()
    profiling.enable(True)
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", refuse)


def test_off_returns_one_shared_no_op_and_touches_neither_clock_nor_profiler(monkeypatch):
    profiling.reset()
    _no_record_function(monkeypatch)
    monkeypatch.setattr(profiling._autograd_profiler, "_is_profiler_enabled", True)

    def no_clock():
        raise AssertionError("clock read")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    assert profiling.span("a", 4) is profiling.span("b")
    with profiling.span("a", 4) as s, profiling.span("b"):
        pass
    assert s is profiling.span("c")
    assert profiling.snapshot() == {}


def test_nested_spans_count_pairs_and_split_self_from_total(spans_on, monkeypatch):
    ticks = iter([0, 10, 30, 40, 45, 100])  # outer in, inner in, out, inner in, out, outer out
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks) * 1000)
    with profiling.span("outer", 8):
        with profiling.span("inner", 2):
            pass
        with profiling.span("inner", 3):
            pass
    got = profiling.snapshot()
    assert got["outer"] == {"count": 1, "pairs": 8, "total_s": pytest.approx(100e-6), "self_s": pytest.approx(75e-6),
                            "parent": None}
    assert got["inner"] == {"count": 2, "pairs": 5, "total_s": pytest.approx(25e-6), "self_s": pytest.approx(25e-6),
                            "parent": "outer"}


def test_a_parent_covers_its_children_on_the_real_clock(spans_on):
    for _ in range(3):
        with profiling.span("p", 1):
            torch.ones(64, 64).sum()
            with profiling.span("c1"):
                torch.ones(64, 64).sum()
            with profiling.span("c2"):
                with profiling.span("g"):
                    torch.ones(64, 64).sum()
    got = profiling.snapshot()
    assert {k: v["count"] for k, v in got.items()} == {"p": 3, "c1": 3, "c2": 3, "g": 3}
    assert got["p"]["total_s"] >= got["p"]["self_s"] + got["c1"]["total_s"] + got["c2"]["total_s"] - 1e-9
    assert got["c2"]["self_s"] == pytest.approx(got["c2"]["total_s"] - got["g"]["total_s"], abs=1e-9)
    assert got["g"]["parent"] == "c2" and got["p"]["pairs"] == 3
    assert all(v["self_s"] >= 0 for v in got.values())


def test_snapshot_is_a_copy_reset_forgets_and_disable_stops(spans_on):
    with profiling.span("a"):
        pass
    snap = profiling.snapshot()
    snap["a"]["count"] = 99
    assert profiling.snapshot()["a"]["count"] == 1
    profiling.reset()
    assert profiling.snapshot() == {}
    profiling.enable(False)
    with profiling.span("a"):
        pass
    assert profiling.snapshot() == {}


def test_each_thread_keeps_its_own_stack(spans_on):
    opened, closed = threading.Event(), threading.Event()

    def other():
        opened.wait(10)
        with profiling.span("other"):
            pass
        closed.set()

    t = threading.Thread(target=other)
    t.start()
    with profiling.span("main"):
        opened.set()
        assert closed.wait(10)
    t.join(10)
    assert not t.is_alive()
    assert profiling.snapshot()["other"]["parent"] is None


def test_a_train_step_opens_its_spans_once_each_and_nested(spans_on):
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet
    from pwcnet_tpu_torch.train_lib.step import create_train_state, make_train_step

    torch.manual_seed(0)
    model = PWCDCNet(init=False, **TINY)
    state = create_train_state(model, device="cpu")
    step = make_train_step(model, weights=[0.32, 0.08])
    profiling.reset()
    step(state, torch.rand(2, 2, 16, 16, 3), torch.rand(2, 16, 16, 2))
    got = profiling.snapshot()
    parents = {"step": None, "step.forward": "step", "step.backward": "step", "step.adam": "step",
               "model.forward": "step.forward", "model.pyramid": "model.forward", "model.level0": "model.forward",
               "model.level1": "model.forward", "model.context": "model.forward"}
    assert {k: (v["count"], v["parent"]) for k, v in got.items()} == {k: (1, p) for k, p in parents.items()}
    assert got["step"]["pairs"] == 2 and got["model.forward"]["pairs"] == 2
    children = sum(got[k]["total_s"] for k in ("step.forward", "step.backward", "step.adam"))
    assert got["step"]["self_s"] == pytest.approx(got["step"]["total_s"] - children, abs=1e-9)


@pytest.mark.parametrize("context", ["final", "all"])
def test_the_legacy_forward_opens_a_context_span_for_each_context_net(spans_on, context):
    from pwcnet_tpu_torch.models.pwcnet import PWCNet
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume

    torch.manual_seed(0)
    model = PWCNet(init=False, context=context, cost_volume_fn=cost_volume, **TINY)
    with torch.no_grad():
        want = model(torch.rand(3, 16, 16, 3), torch.rand(3, 16, 16, 3))[0]
    got = profiling.snapshot()
    assert got["model.forward"]["count"] == 1 and got["model.forward"]["pairs"] == 3
    assert got["model.context"]["count"] == (2 if context == "all" else 1)
    assert {got[f"model.level{l}"]["parent"] for l in range(2)} == {"model.forward"}
    assert want.shape == (3, 16, 16, 2)


def test_spans_leave_the_forward_unchanged():
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet

    torch.manual_seed(0)
    model = PWCDCNet(init=False, **TINY)
    x0, x1 = torch.rand(2, 16, 16, 3), torch.rand(2, 16, 16, 3)
    with torch.no_grad():
        off = model(x0, x1)
        profiling.enable(True)
        try:
            on = model(x0, x1)
        finally:
            profiling.enable(False)
            profiling.reset()
    torch.testing.assert_close(on[0], off[0], rtol=0, atol=0)
    for a, b in zip(on[1], off[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_sequence_counts_frames_dispatches_and_pairs(spans_on, monkeypatch):
    from pwcnet_tpu_torch.inference import FlowPredictor

    _no_record_function(monkeypatch)  # on, but no profiler is active
    pred = FlowPredictor(device="cpu", **TINY)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(9)]  # 8 pairs: 3 + 3 + a tail of 2
    profiling.reset()
    handed = list(pred.predict_sequence(iter(frames), depth=2, batch=3, fetch="flow"))
    got = profiling.snapshot()
    assert len(handed) == 8
    assert got["serve.load"]["count"] == 9 and got["serve.load"]["pairs"] == 0
    for name in ("serve.stage", "serve.enqueue", "serve.wait"):
        assert (got[name]["count"], got[name]["pairs"], got[name]["parent"]) == (3, 8, None), name
    assert got["model.forward"]["parent"] == "serve.enqueue" and got["model.forward"]["pairs"] == 9


def test_inside_the_profiler_each_span_is_a_prefixed_range_of_the_trace(spans_on, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet

    torch.manual_seed(0)
    model = PWCDCNet(init=False, **TINY)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(torch.rand(1, 16, 16, 3), torch.rand(1, 16, 16, 3))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith(profiling.PREFIX)}
    assert ranges == {profiling.PREFIX + n for n in
                      ("model.forward", "model.pyramid", "model.level0", "model.level1", "model.context")}
    assert profiling.snapshot()["model.forward"]["count"] == 1
