"""The port's TF-checkpoint reader, converter and CLIs against the JAX
package's (``pwcnet_tpu/train_lib/tf_converter.py``, the root
``convert_checkpoint.py``), on the CPU.

Bundles are written by ``tests/test_tf_converter.py``'s independent
minimal writer (``_write_bundle``: one uncompressed shard). The reader must
give the JAX reader's arrays bit for bit, and names, errors and the
converted tree must be the same. A bundle of a tiny model's parameters
(``num_levels=3, search_range=2, output_level=1``) gives both packages'
``FlowPredictor`` the same flow: float32 through about 30 layers summed in
different orders, so within 1e-4 of the flow's largest entry, as
tests/test_torch_model.py holds the two predictors.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tf_converter import _write_bundle

from pwcnet_tpu.inference import FlowPredictor as JaxFlowPredictor
from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.train_lib import tf_converter as jax_tfc
from pwcnet_tpu_torch import convert_checkpoint as port_convert_cli
from pwcnet_tpu_torch import test as port_test_cli
from pwcnet_tpu_torch.inference import FlowPredictor
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.train_lib import tf_converter as tfc
from pwcnet_tpu_torch.weights import load_params, load_tree, to_jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_levels=3, output_level=1, search_range=2)
SMALL_FLAGS = ["--num_levels", "3", "--search_range", "2", "--output_level", "1"]
# what the reference bundles carry beside the model: Adam slots, beta powers, the step
DISTRACTORS = {
    "pwcdcnet/context/conv2d/bias/Adam": np.ones(32, np.float32),
    "pwcdcnet/context/conv2d/bias/Adam_1": np.full(32, 2.0, np.float32),
    "beta1_power": np.array(0.9, np.float32),
    "beta2_power": np.array(0.999, np.float32),
    "Variable": np.array(600.0, np.float32),
    "global_step": np.array(7.0, np.float32),
}


def _model_tensors(seed, cfg=SMALL):
    """TF-named tensors of a model's parameter tree (shapes from the JAX
    model's init), filled from numpy: fan-in scaled kernels, small biases."""
    model = JaxPWCDCNet(**cfg)
    x = jnp.zeros((1, 8, 8, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)
    tensors = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        scale = 1.0 / np.sqrt(9.0 * s.shape[2]) if len(s.shape) == 4 else 0.05
        tensors["pwcdcnet/" + "/".join(k.key for k in path)] = (rng.standard_normal(s.shape) * scale).astype(
            np.float32)
    return tensors


def _load_root_cli(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree, path=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg="/".join(k))


@pytest.fixture
def small_bundle(tmp_path):
    tensors = {**_model_tensors(seed=3), **DISTRACTORS}
    return _write_bundle(tmp_path, tensors), tensors


class TestReader:
    @pytest.mark.parametrize("case", ["tiny_model", "distractors", "odd_shapes"])
    def test_read_tf_checkpoint_is_the_jax_readers(self, tmp_path, case):
        rng = np.random.default_rng(1)
        tensors = {
            "tiny_model": {**_model_tensors(seed=1), **DISTRACTORS},
            "distractors": DISTRACTORS,
            "odd_shapes": {"pwcdcnet/optflow_0/conv2d/kernel": rng.standard_normal((3, 3, 5, 7)),
                           "pwcdcnet/optflow_0/conv2d/bias": rng.standard_normal(7),
                           "scalar": np.array(3.5), "long/name/" + "x" * 300: rng.standard_normal((2, 1, 4))},
        }[case]
        prefix = _write_bundle(tmp_path, tensors)
        for path in (prefix, str(prefix) + ".index"):
            got, want = tfc.read_tf_checkpoint(path), jax_tfc.read_tf_checkpoint(path)
            assert got.keys() == want.keys() == tensors.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                np.testing.assert_array_equal(got[k], want[k])
                np.testing.assert_array_equal(got[k], np.asarray(tensors[k], np.float32))
        got_idx = tfc.read_index_entries(str(prefix) + ".index")
        want_idx = jax_tfc.read_index_entries(str(prefix) + ".index")
        assert {k: repr(v) for k, v in got_idx.items()} == {k: repr(v) for k, v in want_idx.items()}

    @pytest.mark.parametrize("name", [
        "pwcdcnet/fp_extractor/conv2d_3/kernel", "pwcdcnet/context/conv2d/bias", "pwcnet/optflow_4/conv2d_5/bias",
        "optflow_0/conv2d/kernel", "pwcdcnet/context/conv2d/bias/Adam", "pwcdcnet/context/conv2d/bias/Adam_1",
        "beta1_power", "beta2_power", "Variable", "global_step", "pwcdcnet/global_step", "pwcdcnet/kernel",
        "pwcdcnet/context/conv2d/gamma", "",
    ])
    def test_tf_name_to_path_is_the_jax_mapping(self, name):
        assert tfc.tf_name_to_path(name) == jax_tfc.tf_name_to_path(name)

    def test_skipped_names_are_skipped(self):
        for name in DISTRACTORS:
            assert tfc.tf_name_to_path(name) is None

    def test_missing_data_shard_raises(self, small_bundle):
        prefix, _ = small_bundle
        for shard in prefix.parent.glob(prefix.name + ".data-*"):
            shard.unlink()
        for reader in (tfc.read_tf_checkpoint, jax_tfc.read_tf_checkpoint):
            with pytest.raises(FileNotFoundError, match="data"):
                reader(prefix)
        with pytest.raises(FileNotFoundError, match="data"):
            FlowPredictor(checkpoint=str(prefix), device="cpu", **SMALL)

    def test_chip_smokes_writer_is_read_by_both_packages(self, tmp_path):
        """chip_smoke.py's [ckpt] phase writes its bundle with a writer of
        its own (the card machine has no JAX tests); both readers take it."""
        spec = importlib.util.spec_from_file_location("chip_smoke_writer", REPO / "chip_smoke.py")
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        tensors = {**_model_tensors(seed=4), **DISTRACTORS}
        prefix = tmp_path / "model_600.ckpt"
        chip_smoke.write_tf_bundle(np, str(prefix), tensors)
        for reader in (tfc.read_tf_checkpoint, jax_tfc.read_tf_checkpoint):
            got = reader(prefix)
            assert got.keys() == tensors.keys()
            for k, v in tensors.items():
                np.testing.assert_array_equal(got[k], v)
        template = to_jax_params(PWCDCNet(**SMALL).state_dict())
        _assert_trees_equal(tfc.load_tf_checkpoint_params(prefix, template),
                            jax_tfc.load_tf_checkpoint_params(prefix, template))

    def test_bad_magic_raises(self, tmp_path):
        bad = tmp_path / "bad.ckpt.index"
        bad.write_bytes(b"\0" * 64)
        with pytest.raises(ValueError, match="magic"):
            tfc.read_index_entries(bad)


class TestConversion:
    def test_convert_is_the_jax_converters(self, small_bundle):
        prefix, _ = small_bundle
        _assert_trees_equal(tfc.convert_tf_checkpoint(prefix), jax_tfc.convert_tf_checkpoint(prefix))
        _assert_trees_equal(load_params(str(prefix)), jax_tfc.convert_tf_checkpoint(prefix))
        with pytest.raises(NotImplementedError, match="load_params"):
            load_tree(str(prefix))

    def test_load_against_the_models_tree(self, small_bundle):
        prefix, tensors = small_bundle
        template = to_jax_params(PWCDCNet(**SMALL).state_dict())
        got = tfc.load_tf_checkpoint_params(prefix, template)
        _assert_trees_equal(got, jax_tfc.load_tf_checkpoint_params(prefix, template))
        for path, leaf in _leaves(got):
            np.testing.assert_array_equal(leaf, tensors["pwcdcnet/" + "/".join(path)])

    @pytest.mark.parametrize("fault", ["wrong_shape", "missing", "both"])
    def test_incompatible_bundle_raises_the_jax_error(self, tmp_path, fault):
        tensors = _model_tensors(seed=2)
        if fault in ("wrong_shape", "both"):
            tensors["pwcdcnet/optflow_1/conv2d_2/kernel"] = np.zeros((3, 3, 128, 95), np.float32)
        if fault in ("missing", "both"):
            for k in [k for k in tensors if k.startswith("pwcdcnet/context/")]:
                del tensors[k]
        prefix = _write_bundle(tmp_path, tensors)
        template = to_jax_params(PWCDCNet(**SMALL).state_dict())
        with pytest.raises(ValueError, match="incompatible") as got:
            tfc.load_tf_checkpoint_params(prefix, template)
        with pytest.raises(ValueError, match="incompatible") as want:
            jax_tfc.load_tf_checkpoint_params(prefix, template)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="incompatible") as port_pred:
            FlowPredictor(checkpoint=str(prefix), device="cpu", **SMALL)
        with pytest.raises(ValueError, match="incompatible") as jax_pred:
            JaxFlowPredictor(checkpoint=str(prefix), use_pallas=False, **SMALL)(*_pair(16, 16))
        assert str(port_pred.value) == str(jax_pred.value)


def _pair(h, w, seed=5):
    rng = np.random.default_rng(seed)
    img0 = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    return img0, np.roll(img0, (1, 2), (0, 1))


class TestPredictor:
    @pytest.mark.parametrize("suffix", ["", ".index"])
    def test_flow_is_the_jax_predictors(self, small_bundle, suffix):
        prefix, _ = small_bundle
        ckpt = str(prefix) + suffix
        img0, img1 = _pair(27, 35)
        want = JaxFlowPredictor(checkpoint=ckpt, use_pallas=False, **SMALL)(img0, img1)
        got = FlowPredictor(checkpoint=ckpt, device="cpu", **SMALL)(img0, img1)
        assert got[0].shape == want[0].shape == (24, 32, 2)
        assert np.abs(got[0] - want[0]).max() <= 1e-4 * np.abs(want[0]).max()
        for a, b in zip(got[1], want[1]):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()

    def test_test_cli_takes_a_tf_checkpoint(self, small_bundle, tmp_path, monkeypatch):
        from PIL import Image

        from pwcnet_tpu_torch.utils import load_flow

        prefix, _ = small_bundle
        img0, img1 = _pair(24, 40)
        paths = [tmp_path / "a.png", tmp_path / "b.png"]
        Image.fromarray(img0).save(paths[0])
        Image.fromarray(img1).save(paths[1])
        out = tmp_path / "out.flo"
        monkeypatch.chdir(tmp_path)  # the figure goes to ./test_figure
        port_test_cli.main(["--input_images", str(paths[0]), str(paths[1]), "-r", str(prefix), "--device", "cpu",
                            "--save_flow", str(out), *SMALL_FLAGS])
        want = FlowPredictor(checkpoint=str(prefix), device="cpu", **SMALL)(img0, img1)[0]
        np.testing.assert_array_equal(load_flow(out), want)


class TestConvertCli:
    def test_writes_the_jax_clis_tree(self, small_bundle, tmp_path, capsys):
        prefix, _ = small_bundle
        port_out, jax_out = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
        port_convert_cli.main([str(prefix), str(port_out), *SMALL_FLAGS])
        assert f"-> {port_out}" in capsys.readouterr().out
        _load_root_cli("convert_checkpoint").main([str(prefix), str(jax_out), *SMALL_FLAGS])
        _assert_trees_equal(load_tree(port_out), load_tree(jax_out))
        # both packages read the port's file back
        from flax import serialization

        template = jax.tree_util.tree_map(np.asarray, load_tree(jax_out))
        _assert_trees_equal(serialization.from_bytes(template, port_out.read_bytes()), load_tree(jax_out))
        _assert_trees_equal(load_params(port_out), tfc.convert_tf_checkpoint(prefix))

    def test_check_only_lists_the_jax_clis_tensors(self, small_bundle, capsys):
        prefix, tensors = small_bundle
        port_convert_cli.main([str(prefix), "/dev/null", "--check-only"])
        got = capsys.readouterr().out
        _load_root_cli("convert_checkpoint").main([str(prefix), "/dev/null", "--check-only"])
        want = capsys.readouterr().out
        assert got == want
        n_model = len(tensors) - len(DISTRACTORS)
        assert f"{len(tensors)} entries, {n_model} model tensors:" in got
        assert "pwcdcnet/context/conv2d/kernel  (3, 3, 34, 128)" in got

    def test_mismatched_model_flags_raise(self, small_bundle, tmp_path):
        prefix, _ = small_bundle
        with pytest.raises(ValueError, match="incompatible"):
            port_convert_cli.main([str(prefix), str(tmp_path / "out.msgpack"), "--num_levels", "4",
                                   "--search_range", "2", "--output_level", "1"])
