"""scripts/torch_bf16_parity.py against scripts/bf16_parity.py, on the CPU
at the tiny model (``num_levels=3, search_range=2, output_level=1``).

Both scripts are loaded by file path. The weight draw must be the JAX
script's bit for bit (one numpy stream over the same sorted leaves). The
float32 flows of the two packages agree within rtol=1e-4, atol=1e-4, as
tests/test_torch_model.py holds the full-resolution flow.

The bf16 deltas are reported beside the JAX XLA path's, not held to its
values: both are the rounding noise of the same weights and frames, but
the port's bf16 plain ops sum in float32 and round once per op (a recorded
deliberate difference), so the roundings land elsewhere. The port's
EPE(bf16 vs f32) and mean |delta| must lie within a factor of 2 of the JAX
path's either way: a port that kept float32 somewhere would read far
below, one that rounded more often far above. (Read here: 0.92 and 0.92 of
the JAX values at this size; 0.94 and 0.92 at the default 6-level model on
64x128.)
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.weights import to_jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_levels=3, output_level=1, search_range=2)
B, H, W = 2, 32, 48


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _load("jax_bf16_parity", "scripts/bf16_parity.py"), _load("torch_bf16_parity", "scripts/torch_bf16_parity.py")


@pytest.fixture(scope="module")
def jax_run(scripts):
    """The JAX script's measure at the tiny model: its weights, f32 flow, stats."""
    jax_script, port = scripts
    x0, x1 = port.frames(B, H, W)
    m32 = JaxPWCDCNet(dtype=jnp.float32, **SMALL)
    m16 = JaxPWCDCNet(dtype=jnp.bfloat16, **SMALL)
    template = jax.eval_shape(lambda: m32.init(jax.random.PRNGKey(0), x0[:1], x1[:1]))["params"]
    params = jax_script.scaled_params(template)
    f32 = np.asarray(m32.apply({"params": params}, x0, x1)[0])
    f16 = np.asarray(m16.apply({"params": params}, x0.astype(jnp.bfloat16), x1.astype(jnp.bfloat16))[0]
                     .astype(jnp.float32))
    return params, f32, port.stats(f32, f16)


def test_frames_are_the_jax_scripts(scripts):
    rng = np.random.default_rng(42)
    want = rng.random((B, H, W, 3)).astype(np.float32), rng.random((B, H, W, 3)).astype(np.float32)
    got = scripts[1].frames(B, H, W)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_weight_draw_is_the_jax_scripts(scripts, jax_run):
    _, port = scripts
    got = port.scaled_params(to_jax_params(PWCDCNet(**SMALL).state_dict()))
    want = jax_run[0]
    paths = [tuple(k.key for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert paths == [p for p, _ in port._sorted_leaves(got)]
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        assert node.dtype == np.float32
        np.testing.assert_array_equal(node, leaf)


def test_float32_flows_agree_and_bf16_deltas_are_reported(scripts, jax_run):
    _, port = scripts
    params, want_f32, jax_stats = jax_run
    got = port.flows(params, *port.frames(B, H, W), False, "cpu", **SMALL)
    np.testing.assert_allclose(got["float32"], want_f32, rtol=1e-4, atol=1e-4)
    port_stats = port.stats(got["float32"], got["bfloat16"])
    print(json.dumps({"jax xla": jax_stats, "port plain": port_stats}))
    for key in ("epe_bf16_vs_f32", "delta_px_mean"):
        ratio = port_stats[key] / jax_stats[key]
        assert 0.5 <= ratio <= 2.0, (key, port_stats[key], jax_stats[key])
    assert port_stats["f32_flow_px_max_mag"] == pytest.approx(jax_stats["f32_flow_px_max_mag"], rel=1e-4)


def test_measure_prints_one_line_with_the_jax_keys(scripts, capsys):
    _, port = scripts
    out = port.measure("plain", H, W, B, False, "cpu", **SMALL)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"path", "shape", "delta_px_mean", "delta_px_p99", "delta_px_max", "epe_bf16_vs_f32",
                         "f32_flow_px_mean_mag", "f32_flow_px_max_mag", "card"}
    assert line["card"] == "cpu" and line["shape"] == f"{H}x{W} b{B}"
    assert 0 < line["epe_bf16_vs_f32"] < 0.05


def test_main_runs_the_plain_path_on_the_cpu_and_needs_a_card_for_cuda(scripts, capsys, monkeypatch):
    _, port = scripts
    port.main(["--device", "cpu", "--height", "64", "--width", "64", "--batch", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["path"] for x in lines] == ["plain"] and lines[0]["shape"] == "64x64 b1"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        port.main(["--height", "64", "--width", "64", "--batch", "1"])
