"""The span reader of ``benchmark/spans.py`` on synthetic Chrome traces, and
the readers of the span metrics: a kernel launched from another thread
inside a program range is put down to that range, the program's ranges
change nothing ``tracing.read_trace`` reads once they are left out, and
each reader reads its span or returns None."""

import json

import pytest

from benchmark import harness, spans, tracing


def _host(name, cat, ts, dur, tid=1, corr=None):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _dev(name, ts, dur, corr, cat="kernel"):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def _step_trace(with_program=True):
    """A step: the forward's conv launched on the main thread (tid 1), the
    backward's wgrad launched from autograd's thread (tid 2) while
    ``step.backward`` is open on tid 1, Adam's kernel by a bare runtime
    call (no cpu_op around it), then a copy launched outside every span."""
    ev = [
        _host(tracing.WINDOW, "user_annotation", 0, 200),
        _host("aten::conv2d", "cpu_op", 2, 10),
        _host("cudaLaunchKernel", "cuda_runtime", 3, 1, corr=1),
        _host("autograd::engine::evaluate_function: ConvolutionBackward0", "cpu_op", 40, 30, tid=2),
        _host("aten::convolution_backward", "cpu_op", 41, 20, tid=2),
        _host("cudaLaunchKernel", "cuda_runtime", 45, 1, tid=2, corr=2),
        _host("cudaLaunchKernelExC", "cuda_runtime", 110, 1, corr=3),
        _host("aten::copy_", "cpu_op", 150, 10),
        _host("cudaMemcpyAsync", "cuda_runtime", 151, 1, corr=4),
        _dev("sm90_xmma_fprop_implicit_gemm", 10, 20, 1),
        _dev("sm90_xmma_wgrad_implicit_gemm", 50, 30, 2),
        _dev("multi_tensor_apply_kernel", 115, 10, 3),
        _dev("Memcpy DtoH (Device -> Pinned)", 160, 5, 4, cat="gpu_memcpy"),
    ]
    if with_program:
        ev += [
            _host("pwc/step", "user_annotation", 1, 130),
            _host("pwc/step.forward", "user_annotation", 1, 35),
            _host("pwc/model.forward", "user_annotation", 1, 30),
            _host("pwc/step.backward", "user_annotation", 36, 70),
            _host("pwc/step.adam", "user_annotation", 106, 25),
        ]
    return ev


def test_a_kernel_launched_from_autograds_thread_belongs_to_step_backward():
    got = spans.read_spans(_step_trace())
    assert got["span_device_s"] == pytest.approx(
        {"model.forward": 20e-6, "step.backward": 30e-6, "step.adam": 10e-6, "outside": 5e-6})
    # each gap to the operation that ends it; the one after the last, to outside
    assert got["span_gaps"] == pytest.approx(
        {"model.forward": 10e-6, "step.backward": 20e-6, "step.adam": 35e-6, "outside": 35e-6 + 35e-6})
    assert got["span_other_thread_s"] == pytest.approx({"step.backward": 30e-6})
    assert got["span_group_s"]["step.backward"] == pytest.approx({"cuDNN wgrad": 30e-6})


def test_the_gaps_and_device_seconds_add_up_to_the_window():
    ev = _step_trace()
    got, base = spans.read_spans(ev), tracing.read_trace(spans.without_program(ev))
    assert sum(got["span_device_s"].values()) == pytest.approx(sum(base["category_s"].values()))
    assert sum(got["span_gaps"].values()) == pytest.approx(sum(base["gaps"].values()))
    assert sum(got["span_gaps"].values()) == pytest.approx(base["window_s"] - base["busy_s"])


def test_the_program_ranges_left_out_read_trace_reads_as_before():
    plain = tracing.read_trace(_step_trace(with_program=False))
    assert tracing.read_trace(spans.without_program(_step_trace())) == plain
    # kept in, they would name the gap of a launch no host op encloses
    assert "pwc/step.adam" in tracing.read_trace(_step_trace())["gaps"]
    assert "pwc/step.adam" not in plain["gaps"]


def test_the_hosts_waits_on_the_device_go_to_the_span_they_began_in():
    ev = _step_trace() + [_host("cudaStreamSynchronize", "cuda_runtime", 20, 8),
                          _host("cudaStreamSynchronize", "cuda_runtime", 33, 2),
                          _host("cudaDeviceSynchronize", "cuda_runtime", 170, 30),
                          _host("cudaStreamSynchronize", "cuda_runtime", 250, 5)]  # after the window
    got = spans.read_spans(ev)["span_syncs"]
    assert got == {"model.forward": [1, pytest.approx(8e-6)], "step.forward": [1, pytest.approx(2e-6)],
                   "outside": [1, pytest.approx(30e-6)]}


def test_a_launch_missing_from_the_trace_is_unknown_and_no_range_is_outside():
    ev = [_host(tracing.WINDOW, "user_annotation", 0, 50),
          _host("pwc/serve.enqueue", "user_annotation", 1, 5),
          _host("cudaLaunchKernel", "cuda_runtime", 10, 1, corr=1),
          _dev("vectorized_elementwise_kernel", 12, 4, 1),
          _dev("vectorized_elementwise_kernel", 20, 4, 2)]
    got = spans.read_spans(ev)
    assert got["span_device_s"] == pytest.approx({"outside": 4e-6, "unknown": 4e-6})
    assert got["span_gaps"] == pytest.approx({"outside": 12e-6 + 26e-6, "unknown": 4e-6})


def _trace(spans_reading=None, device_s=None, pairs=64):
    raw = {"pairs": pairs, "window_s": 1.0, "busy_s": 0.5, "category_s": {}, "group_s": {}, "launches": 8,
           "rate": 2.0, "flops_per_pair": 1.0, "peak_flops": 1.0, "gaps": {}, "calls": {}, "unit_calls": {}}
    if spans_reading is not None:
        raw["spans"] = spans_reading
    if device_s is not None:
        raw["span_device_s"] = device_s
    return tracing.Trace.of(raw)


def _reader(base):
    return harness.load_module(harness.BENCH / "metrics" / f"{base}.py", f"benchmark_metric_{base}")


def _span(total_s, pairs, count=1):
    return {"count": count, "pairs": pairs, "total_s": total_s, "self_s": total_s, "parent": None}


@pytest.mark.parametrize("base, reading, want", [
    ("step_enqueue_ms_per_pair", {"step": _span(0.032, 8)}, 4.0),
    ("forward_enqueue_ms_per_pair", {"model.forward": _span(0.064, 32)}, 2.0),
    ("stream_stage_ms_per_pair", {"serve.load": _span(0.010, 0, 33), "serve.stage": _span(0.006, 32)}, 0.5),
    ("stream_wait_ms_per_pair", {"serve.wait": _span(0.016, 32)}, 0.5),
])
def test_each_host_span_reader_reads_its_span_or_nothing(base, reading, want):
    reader = _reader(base)
    assert reader.read(_trace(reading)) == pytest.approx(want)
    assert reader.read(_trace()) is None
    assert reader.read(_trace({"other": _span(1.0, 8)})) is None


def test_the_adam_reader_reads_the_device_seconds_under_its_span_or_nothing():
    reader = _reader("adam_ms_per_pair")
    assert reader.read(_trace(device_s={"step.adam": 0.0128}, pairs=64)) == pytest.approx(0.2)
    assert reader.read(_trace()) is None
    assert reader.read(_trace(device_s={"step.backward": 1.0})) is None


def test_every_metric_named_has_a_reader_and_a_cell():
    cells = {w["name"] for w in json.loads((harness.REPO / "BENCHMARK.json").read_text())["workloads"]}
    assert set(spans.METRICS) <= cells
    for names in spans.METRICS.values():
        for name in names:
            assert (harness.BENCH / "metrics" / f"{name.split('.')[0]}.py").is_file()


def test_the_prefix_is_the_ports():
    from pwcnet_tpu_torch.utils import profiling

    assert spans.PREFIX == profiling.PREFIX
