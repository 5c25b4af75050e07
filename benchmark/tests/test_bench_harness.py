"""The benchmark's files and rules on the CPU: every entry of
``BENCHMARK.json`` resolves to its files by name, names and units keep to
their characters, a run without a card prints no result, no module of the
benchmark loads JAX or the JAX package, and the trace reader's arithmetic."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness, tracing

SPEC = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves_to_its_files(work):
    cell = harness.load_cell(work["name"])
    assert (harness.BENCH / "loops" / f"{cell['traffic']['loop']}.py").is_file()
    assert work["name"] == f"{work['config']}.{work['traffic']}"
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        assert m["moves"] in reported


def test_a_metric_without_workloads_goes_to_every_cell_that_reports_what_it_moves():
    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"].append({"name": "mfu.any_train", "unit": "%", "better": "higher", "source": "host_clock",
                              "layer": "Model", "moves": "train_pairs_per_s"})
    for work in spec["workloads"]:
        cell = harness.load_cell(work["name"], spec)
        reported = {m["name"] for m in cell["end_to_end"]}
        assert ("mfu.any_train" in {m["name"] for m in cell["per_layer"]}) == ("train_pairs_per_s" in reported)


def test_a_trace_keeps_every_reading_of_its_loop():
    raw = {"pairs": 4, "window_s": 1.0, "busy_s": 0.5, "category_s": {}, "group_s": {}, "launches": 8, "rate": 2.0,
           "flops_per_pair": 1.0, "peak_flops": 1.0, "gaps": {}, "calls": {"K2": 2}, "unit_calls": {"K2": [0.1, 0.3]},
           "p95_ms": 12.5}
    t = tracing.Trace.of(raw)
    assert t.hand_bound_s == pytest.approx(0.4) and t.extra == {"p95_ms": 12.5} and t.pairs == 4


def test_names_units_and_paths_keep_to_their_characters():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[key]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    assert all(NAME.match(n) for n in names), names
    assert len(names) - 2 * len(SPEC["workloads"]) == len(set(names[:len(names) - 2 * len(SPEC["workloads"])]))
    assert all(UNIT.match(m["unit"]) for key in ("end_to_end", "per_layer") for m in SPEC[key])
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (harness.REPO / c["file"]).is_file()
    for path in harness.BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(harness.REPO))), path
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]


def _run(args, env=None):
    return subprocess.run([sys.executable, *args], cwd=harness.REPO, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["benchmark/run.py", "--workload", "pwcdcnet.stream.bf16", "--seed", str(2**31 + 5),
                "--seconds", "1", "--trace", "0"], env)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no result" in out.stderr


def test_no_benchmark_module_loads_jax():
    code = (
        "import sys, importlib, pathlib\n"
        "sys.path.insert(0, '.')\n"
        "for p in sorted(pathlib.Path('benchmark').rglob('*.py')):\n"
        "    if p.name != '__init__.py' or p.parent.name != 'tests':\n"
        "        importlib.import_module('.'.join(p.with_suffix('').parts).replace('.__init__', ''))\n"
        "from benchmark import harness\n"
        "print(harness.forbidden_modules())\n"
    )
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pwcnet_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert harness.forbidden_modules() == ["jaxlib"]


def test_the_trace_reader_unions_and_splits_device_time():
    ev = [
        {"name": tracing.WINDOW, "cat": "user_annotation", "ph": "X", "ts": 0, "dur": 100, "pid": 1, "tid": 1},
        {"name": "aten::conv2d", "cat": "cpu_op", "ph": "X", "ts": 1, "dur": 20, "pid": 1, "tid": 1},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": "X", "ts": 2, "dur": 1, "pid": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"name": "aten::add", "cat": "cpu_op", "ph": "X", "ts": 30, "dur": 5, "pid": 1, "tid": 1},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": "X", "ts": 31, "dur": 1, "pid": 1, "tid": 1,
         "args": {"correlation": 8}},
        {"name": "sm90_xmma_fprop_implicit_gemm", "cat": "kernel", "ph": "X", "ts": 10, "dur": 30,
         "args": {"correlation": 7}},
        {"name": "vectorized_elementwise_kernel", "cat": "kernel", "ph": "X", "ts": 35, "dur": 10,
         "args": {"correlation": 8}},
        {"name": "void correlation_kernel<__nv_bfloat16, 4, 32, WarpLoader<__nv_bfloat16> >", "cat": "kernel",
         "ph": "X", "ts": 60, "dur": 20, "args": {"correlation": 9}},
        {"name": "Memcpy DtoH (Device -> Pinned)", "cat": "gpu_memcpy", "ph": "X", "ts": 85, "dur": 5},
    ]
    got = tracing.read_trace(ev)
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(60e-6)  # [10, 45] + [60, 80] + [85, 90]
    assert got["category_s"] == pytest.approx({"hand": 20e-6, "cudnn": 30e-6, "eager": 10e-6, "copy": 5e-6})
    assert got["launches"] == 4
    assert got["gaps"] == pytest.approx({"aten::conv2d": 10e-6, "unknown": 20e-6, "closing synchronize": 10e-6})
