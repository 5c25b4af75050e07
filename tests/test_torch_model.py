"""The port's PWCDCNet, weights, FlowPredictor and CLI against the JAX package.

Parameters are one numpy tree in the JAX package's layout (its structure
from ``jax.eval_shape`` of the JAX model's init, its values drawn here),
handed to the JAX model as it is and to the port through
``weights.from_jax_params``. On the JAX side the model runs its XLA path,
the Pallas kernels' plain reference. All float32 on the CPU.

Tolerances: rtol=1e-4, atol=1e-5 on per-level flows and rtol=1e-4,
atol=1e-4 on the full-resolution flow (x20 upsampled), as
tests/test_golden.py holds the JAX model to its NumPy oracle: the two
frameworks sum the convolutions in different orders through up to 50
layers.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.models.pwcnet import kernel_hooks
from pwcnet_tpu_torch.prng import PRNGKey
from pwcnet_tpu_torch.weights import from_jax_params, init_params, load_params, to_jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_levels=3, output_level=1, search_range=2)


def _jax_tree(cfg, hw, seed):
    """A parameter tree shaped by the JAX model's init, filled from numpy:
    fan-in scaled kernels keep activations O(1), small random biases."""
    model = JaxPWCDCNet(**cfg)
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 4:
            return (rng.standard_normal(s.shape) / np.sqrt(9.0 * s.shape[2])).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _frames(seed, hw):
    rng = np.random.default_rng(seed)
    return (rng.random((1, hw, hw, 3)).astype(np.float32), rng.random((1, hw, hw, 3)).astype(np.float32))


def _compare(jax_out, torch_out, final_atol=1e-4):
    (jf, jp), (tf, tp) = jax_out, torch_out
    assert len(jp) == len(tp)
    for l, (a, b) in enumerate(zip(jp, tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5, err_msg=f"level {l}")
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=final_atol)


def _port(cfg, tree, **hooks):
    model = PWCDCNet(**cfg, **hooks)
    model.load_state_dict(from_jax_params(tree))
    return model.eval()


@pytest.fixture(scope="module")
def full_tree():
    return _jax_tree({}, 64, seed=7)


class TestWeights:
    def test_round_trip_is_bit_exact_on_the_full_tree(self, full_tree):
        state = from_jax_params(full_tree)
        assert len(state) == 110  # 18 pyramid + 5 x 6 estimator + 7 context convs, kernel and bias
        port_keys = PWCDCNet().state_dict()
        assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in port_keys.items()}
        assert state["fp_extractor.conv2d.weight"].shape == (16, 3, 3, 3)  # OIHW
        back = to_jax_params(state)
        flat_a = jax.tree_util.tree_flatten_with_path(full_tree)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path

    @pytest.mark.parametrize("wrap", ["params", "train_state"])
    def test_load_params_reads_flax_msgpack(self, tmp_path, wrap):
        from flax import serialization

        tree = _jax_tree(SMALL, 16, seed=1)
        payload = tree
        if wrap == "train_state":  # what the JAX trainer checkpoints: params + Adam state + step
            import optax

            from pwcnet_tpu.train_lib.step import TrainState

            payload = TrainState.create(apply_fn=None, params=tree, tx=optax.adam(1e-4))
        path = tmp_path / "ckpt.msgpack"
        path.write_bytes(serialization.to_bytes(payload))
        got = load_params(path)
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            assert np.array_equal(a, b)
        _port(SMALL, got)  # loads strictly into the port

    def test_load_params_widens_bfloat16(self, tmp_path):
        from flax import serialization

        tree = {"context": {"conv2d": {"bias": jnp.asarray([1.5, -2.0, 0.1], jnp.bfloat16)}}}
        path = tmp_path / "bf16.msgpack"
        path.write_bytes(serialization.to_bytes(tree))
        got = load_params(path)["context"]["conv2d"]["bias"]
        np.testing.assert_array_equal(got, np.asarray(tree["context"]["conv2d"]["bias"], np.float32))

    def test_glorot_init_like_flax(self):
        """One key draws one model; each kernel fills its glorot bounds with
        a uniform's mean and variance; biases are zero; another key draws
        another model (``tests/test_torch_init.py`` holds the bits to JAX's)."""
        model = PWCDCNet(**SMALL, key=PRNGKey(3))
        again = PWCDCNet(**SMALL, key=PRNGKey(3))
        for (name, p), q in zip(model.state_dict().items(), again.state_dict().values()):
            assert p.dtype == torch.float32 and torch.equal(p, q), name
            if name.endswith("bias"):
                assert not p.any()
            else:
                cout, cin, kh, kw = p.shape
                limit = np.sqrt(6.0 / (kh * kw * (cin + cout)))
                assert p.abs().max() <= limit and p.abs().max() > 0.9 * limit
                if p.numel() >= 1000:  # mean 0 and variance limit**2 / 3, within 5 standard errors
                    n = p.numel()
                    assert abs(float(p.mean())) < 5 * limit / np.sqrt(3 * n), name
                    assert abs(float(p.var()) / (limit**2 / 3) - 1) < 5 * np.sqrt(0.8 / n), name
        init_params(model, PRNGKey(4))
        assert not torch.equal(model.context.conv2d.weight, again.context.conv2d.weight)


class TestModel:
    def test_full_depth_gate(self, full_tree):
        """The production configuration: 6 levels, d=4, output level 4, 64x64."""
        a, b = _frames(0, 64)
        want = JaxPWCDCNet().apply({"params": full_tree}, jnp.asarray(a), jnp.asarray(b))
        with torch.no_grad():
            got = _port({}, full_tree)(torch.from_numpy(a), torch.from_numpy(b))
        assert got[0].shape == (1, 64, 64, 2) and len(got[1]) == 5
        _compare(want, got)

    @pytest.mark.parametrize(
        "extra", [{}, {"warp_type": "nearest"}, {"use_dc": True}], ids=["bilinear", "nearest", "dense"]
    )
    def test_three_levels(self, extra):
        cfg = {**SMALL, **extra}
        tree = _jax_tree(cfg, 16, seed=2)
        a, b = _frames(1, 16)
        want = JaxPWCDCNet(**cfg).apply({"params": tree}, jnp.asarray(a), jnp.asarray(b))
        with torch.no_grad():
            got = _port(cfg, tree)(torch.from_numpy(a), torch.from_numpy(b))
        _compare(want, got)

    def test_kernel_hooks_on_cpu_match_plain(self):
        """The kernel wrappers wired as on the card (K2, K1 and two fused
        pyramid levels) give the plain model's output on CPU tensors."""
        tree = _jax_tree(SMALL, 16, seed=3)
        a, b = (torch.from_numpy(x) for x in _frames(2, 16))
        hooked = _port(SMALL, tree, **kernel_hooks(True))
        with torch.no_grad():
            got, want = hooked(a, b), _port(SMALL, tree)(a, b)
        assert torch.equal(got[0], want[0])

    def test_invalid_configs_raise(self):
        with pytest.raises(ValueError):
            PWCDCNet(num_levels=3, output_level=3)
        with pytest.raises(ValueError):
            PWCDCNet(warp_type="nearest", **kernel_hooks(True, fused=True))


class TestFlowPredictor:
    @pytest.mark.parametrize("size_handling", ["crop", "pad"])
    def test_matches_jax_predictor(self, tmp_path, size_handling):
        from flax import serialization

        from pwcnet_tpu.inference import FlowPredictor as JaxFlowPredictor
        from pwcnet_tpu_torch.inference import FlowPredictor

        tree = _jax_tree(SMALL, 16, seed=4)
        ckpt = tmp_path / "model.msgpack"
        ckpt.write_bytes(serialization.to_bytes(tree))
        rng = np.random.default_rng(5)
        img0 = (rng.random((27, 35, 3)) * 255).astype(np.uint8)
        img1 = np.roll(img0, (1, 2), (0, 1))
        jax_pred = JaxFlowPredictor(use_pallas=False, size_handling=size_handling, **SMALL)
        jax_pred._params = tree  # the checkpoint's tree, without an eager JAX init
        want = jax_pred(img0, img1)
        got = FlowPredictor(device="cpu", checkpoint=str(ckpt), size_handling=size_handling, **SMALL)(img0, img1)
        shape = (24, 32) if size_handling == "crop" else (27, 35)
        assert got[0].shape == shape + (2,) and got[0].dtype == np.float32
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
        assert len(got[1]) == len(want[1]) == 2
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got[2], want[2])

    def test_raw_forward_takes_a_batch(self):
        from pwcnet_tpu_torch.inference import FlowPredictor

        pred = FlowPredictor(device="cpu", **SMALL)
        batch = (np.random.default_rng(6).random((2, 2, 16, 24, 3)) * 255).astype(np.uint8)
        flow, pyramid = pred.raw_forward(batch)
        assert flow.shape == (2, 16, 24, 2) and [p.shape[:3] for p in pyramid] == [(2, 2, 3), (2, 4, 6)]
        one, _ = pred.raw_forward(batch[1:])
        torch.testing.assert_close(one[0], flow[1], rtol=1e-5, atol=1e-6)

    def test_float_frames_are_normalised(self):
        """Raw frames as floats on the 0..255 scale give the uint8 result."""
        from pwcnet_tpu_torch.inference import FlowPredictor

        pred = FlowPredictor(device="cpu", **SMALL)
        img0 = (np.random.default_rng(9).random((16, 24, 3)) * 255).astype(np.uint8)
        img1 = np.roll(img0, 1, 1)
        want = pred(img0, img1)
        got = pred(img0.astype(np.float32), img1.astype(np.float32))
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])

    def test_no_device_without_cuda_raises(self, monkeypatch):
        from pwcnet_tpu_torch.inference import FlowPredictor

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FlowPredictor()

    def test_invalid_size_handling_raises(self):
        from pwcnet_tpu_torch.inference import FlowPredictor

        with pytest.raises(ValueError):
            FlowPredictor(size_handling="stretch", device="cpu")


class TestCli:
    def test_writes_flow_and_times(self, tmp_path, capsys, monkeypatch):
        from PIL import Image

        from pwcnet_tpu.utils.flo_io import load_flow as jax_load_flow
        from pwcnet_tpu_torch.test import main
        from pwcnet_tpu_torch.utils import load_flow

        rng = np.random.default_rng(8)
        base = (rng.random((20, 28, 3)) * 255).astype(np.uint8)
        paths = [tmp_path / "a.png", tmp_path / "b.png"]
        Image.fromarray(base).save(paths[0])
        Image.fromarray(np.roll(base, (1, 1), (0, 1))).save(paths[1])
        out = tmp_path / "out.flo"
        monkeypatch.chdir(tmp_path)  # the figure goes to ./test_figure
        main(["--input_images", str(paths[0]), str(paths[1]), "--device", "cpu", "--num_levels", "3",
              "--search_range", "2", "--output_level", "1", "--save_flow", str(out), "--time", "--iters", "2",
              "--size_handling", "pad"])
        flow = load_flow(out)
        assert flow.shape == (20, 28, 2) and np.isfinite(flow).all()
        np.testing.assert_array_equal(flow, jax_load_flow(out))
        assert "Inference time:" in capsys.readouterr().out
        assert (tmp_path / "test_figure" / f"test_{tmp_path.name}_a.pdf").is_file()


class TestNoJax:
    def test_package_imports_neither_jax_nor_the_jax_package(self):
        code = (
            "import pkgutil, importlib, sys, pwcnet_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(pwcnet_tpu_torch.__path__, 'pwcnet_tpu_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pwcnet_tpu'))\n"
            "want = {'pwcnet_tpu_torch.' + n for n in (\n"
            "    'losses', 'ops.activation', 'train_lib.step', 'train_lib.schedule', 'train_lib.checkpoint',\n"
            "    'ops.estimator_conv', 'ops.cuda.estimator_conv', 'utils.config', 'utils.flow_viz', 'utils.profiling',\n"
            "    'data.datasets', 'data.native', 'data.cache', 'data.pipeline', 'train_lib.metrics',\n"
            "    'train_lib.trainer', 'train', 'evaluate', 'test', 'parallel', 'parallel.mesh',\n"
            "    'parallel.spatial', 'parallel._comm', 'test_continuous', 'convert_checkpoint',\n"
            "    'train_lib.tf_converter', 'transcode_dataset', 'models', 'models.pwcnet', 'models.pyramid',\n"
            "    'models.estimator', 'weights', 'orbax_format', 'prng')}\n"
            "print(len(names), bad, want - set(names))\n"
            "sys.exit(1 if bad or len(names) < 50 or want - set(names) else 0)\n"
        )
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stdout + res.stderr

    def test_training_and_data_code_does_not_import_the_serving_entry(self):
        """The hooks come from ``models.pwcnet`` and the device from
        ``utils.device``; ``inference`` keeps the constant's old name."""
        from pwcnet_tpu_torch import inference
        from pwcnet_tpu_torch.models import pwcnet

        found = []
        sources = [p for sub in ("data", "train_lib") for p in (REPO / "pwcnet_tpu_torch" / sub).rglob("*.py")]
        for path in sorted(sources):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
                else:
                    names = [a.name for a in node.names] if isinstance(node, ast.Import) else []
                found += [(path.name, n) for n in names if n == "pwcnet_tpu_torch.inference"]
        assert not found, found
        assert inference.FUSED_PYRAMID_LEVELS is pwcnet.FUSED_PYRAMID_LEVELS
        assert not hasattr(inference, "spatial_hooks")

    def test_chip_smoke_imports_neither(self):
        tree = ast.parse((REPO / "chip_smoke.py").read_text())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert roots.isdisjoint({"jax", "jaxlib", "flax", "optax", "pwcnet_tpu"}), roots
        assert "pwcnet_tpu_torch" in roots
