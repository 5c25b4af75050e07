"""Orbax checkpoint directories in the port (``pwcnet_tpu_torch/orbax_format.py``,
through tensorstore) against the JAX package's orbax backend.

A directory written by either package restores in the other bitwise: the
whole TrainState (with and without the learning-rate schedule, whose state
is then optax's empty one) and the parameters alone. The state is the tiny
model of tests/test_cli.py with parameters, Adam moments and step drawn
from a numpy seed, so that no entry is left at its initial value.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.train_lib import checkpoint as jax_checkpoint
from pwcnet_tpu.train_lib import step as jax_step
from pwcnet_tpu_torch import orbax_format
from pwcnet_tpu_torch import train as port_train_cli
from pwcnet_tpu_torch.inference import FlowPredictor
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.train_lib import (
    create_train_state, load_params, restore_checkpoint_auto, restore_checkpoint_orbax, save_checkpoint_orbax,
    wait_for_orbax_saves)
from pwcnet_tpu_torch.weights import load_tree, save_tree, to_jax_params, to_jax_state

torch.set_num_threads(1)

TINY = dict(num_levels=3, output_level=1, search_range=2)
TINY_MODEL = ["--num_levels", "3", "--search_range", "2", "--output_level", "1"]
STEP = 7


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bitwise(got: dict, want: dict):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _jax_state(scheduled: bool, seed: int):
    """A JAX TrainState of the tiny model, every array drawn from ``seed``."""
    model = JaxPWCDCNet(**TINY)
    state = jax_step.create_train_state(model, jax.random.PRNGKey(0), (1, 32, 32, 3), lr_scheduling=scheduled)
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return np.asarray(STEP, np.int32)
        return rng.standard_normal(x.shape).astype(x.dtype)

    return state.replace(step=STEP, params=jax.tree_util.tree_map(fill, state.params),
                         opt_state=jax.tree_util.tree_map(fill, state.opt_state))


def _port_state(scheduled: bool, seed: int):
    """The port's TrainState of the tiny model, every tensor drawn from ``seed``."""
    state = create_train_state(PWCDCNet(**TINY, init=False), lr_scheduling=scheduled, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in [*state.model.parameters(), *state.mu.values(), *state.nu.values()]:
            t.copy_(torch.randn(t.shape, generator=gen))
    state.step = STEP
    return state


def _port_tree(state):
    return to_jax_state(state.model.state_dict(), state.mu, state.nu, state.step, callable(state.learning_rate))


@pytest.mark.parametrize("scheduled", [True, False], ids=["schedule", "constant"])
class TestAcrossPackages:
    def test_jax_directory_restores_in_the_port(self, tmp_path, scheduled):
        jstate = _jax_state(scheduled, 1)
        path = jax_checkpoint.save_checkpoint_orbax(tmp_path / "jax_ckpt", jstate)
        assert (tmp_path / "jax_ckpt" / "_METADATA").is_file()
        state = restore_checkpoint_orbax(path, _port_state(scheduled, 2))
        assert state.step == STEP
        _assert_bitwise(_port_tree(state), serialization.to_state_dict(jstate))

    def test_port_directory_restores_in_jax(self, tmp_path, scheduled):
        state = _port_state(scheduled, 3)
        path = save_checkpoint_orbax(tmp_path / "port_ckpt", state)
        assert sorted(p.name for p in (tmp_path / "port_ckpt").iterdir() if p.is_file()) == [
            "_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt"]
        meta = json.loads((tmp_path / "port_ckpt" / "_METADATA").read_text())
        assert meta["use_ocdbt"] and not meta["use_zarr3"]
        template = _jax_state(scheduled, 4)
        restored = jax_checkpoint.restore_checkpoint_orbax(path, template)
        assert int(restored.step) == STEP
        _assert_bitwise(serialization.to_state_dict(restored), _port_tree(state))
        # and back through the port's own reader
        again = restore_checkpoint_auto(path, _port_state(scheduled, 5))
        _assert_bitwise(_port_tree(again), _port_tree(state))


class TestParams:
    @pytest.mark.parametrize("whole", [True, False], ids=["whole_state", "params_only"])
    def test_jax_directory_loads_in_the_port(self, tmp_path, whole):
        jstate = _jax_state(True, 6)
        if whole:
            jax_checkpoint.save_checkpoint_orbax(tmp_path / "d", jstate)
        else:
            import orbax.checkpoint as ocp

            ckptr = ocp.StandardCheckpointer()
            ckptr.save((tmp_path / "d").absolute(), jax.device_get(jstate.params))
            ckptr.wait_until_finished()
        got = to_jax_params(load_params(tmp_path / "d"))
        _assert_bitwise(got, jax.device_get(jstate.params))

    @pytest.mark.parametrize("whole", [True, False], ids=["whole_state", "params_only"])
    def test_port_directory_loads_in_jax(self, tmp_path, whole):
        state = _port_state(True, 7)
        params = to_jax_params(state.model.state_dict())
        if whole:
            save_checkpoint_orbax(tmp_path / "d", state)
        else:
            orbax_format.save_tree(tmp_path / "d", params)
        template = jax.tree_util.tree_map(np.zeros_like, params)
        _assert_bitwise(jax_checkpoint.load_params(tmp_path / "d", template), params)
        _assert_bitwise(to_jax_params(load_params(tmp_path / "d")), params)


class TestAsyncSaves:
    def test_background_save_then_overwrite(self, tmp_path):
        """wait=False copies the state at the call: training on does not
        reach the file. A second save replaces the directory."""
        state = _port_state(True, 8)
        want = jax.tree_util.tree_map(np.copy, _port_tree(state))
        save_checkpoint_orbax(tmp_path / "ckpt", state, wait=False)
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        state.step = STEP + 1
        for t in [*state.mu.values(), *state.nu.values()]:
            t.zero_()
        wait_for_orbax_saves()
        _assert_bitwise(load_tree(tmp_path / "ckpt"), want)
        state.step = STEP  # Adam's counts stay at STEP
        save_checkpoint_orbax(tmp_path / "ckpt", state, wait=False)
        wait_for_orbax_saves()
        _assert_bitwise(load_tree(tmp_path / "ckpt"), _port_tree(state))
        assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]  # no temporary sibling left

    def test_a_reader_waits_for_the_save_in_flight(self, tmp_path):
        state = _port_state(False, 9)
        save_checkpoint_orbax(tmp_path / "ckpt", state, wait=False)
        got = restore_checkpoint_orbax(tmp_path / "ckpt", _port_state(False, 10))
        _assert_bitwise(_port_tree(got), _port_tree(state))


def test_flow_predictor_from_a_directory_equals_the_msgpack_file(tmp_path):
    state = _port_state(True, 11)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(0.1)  # keep the activations O(1)
    save_checkpoint_orbax(tmp_path / "ckpt", state)
    save_tree(tmp_path / "params.msgpack", to_jax_params(state.model.state_dict()))
    rng = np.random.default_rng(12)
    a, b = (rng.integers(0, 256, (32, 40, 3), dtype=np.uint8) for _ in range(2))
    flows = [FlowPredictor(checkpoint=str(path), device="cpu", **TINY)(a, b)[0]
             for path in (tmp_path / "ckpt", tmp_path / "params.msgpack")]
    assert flows[0].shape == (32, 40, 2) and np.isfinite(flows[0]).all()
    np.testing.assert_array_equal(flows[0], flows[1])


def test_train_cli_saves_and_resumes_orbax_directories(tmp_path, monkeypatch):
    """``--ckpt_backend orbax`` writes ./model/model_1 as a directory (the
    epoch save on the background thread, flushed at the end); ``-r`` on it
    continues at epoch 1 by its name and at the step it holds, and a
    preemption-style cursor beside it is read."""
    monkeypatch.chdir(tmp_path)
    args = ["-d", "Synthetic", "-dd", ".", "-b", "4", "--crop_type", "center", "--crop_shape", "32", "32",
            "--no-visualize", "--log_interval", "1", "--device", "cpu", "--ckpt_backend", "orbax"] + TINY_MODEL
    first = port_train_cli.main(args + ["-e", "1"])
    (ckpt,) = tmp_path.glob("logs/history_*/model/model_1")
    assert ckpt.is_dir() and (ckpt / "_METADATA").is_file()
    assert not list(ckpt.parent.glob("*.orbax-*"))
    steps = first.state.step
    assert steps > 0 and load_tree(ckpt)["step"] == steps
    resumed = port_train_cli.main(args + ["-e", "2", "-r", str(ckpt)])
    assert resumed._resume_epoch == 1 and resumed.state.step == 2 * steps
    # the JAX package reads the resumed run's directory
    (ckpt2,) = [p for p in tmp_path.glob("logs/history_*/model/model_2")]
    template = jax.tree_util.tree_map(np.zeros_like, to_jax_params(resumed.model.state_dict()))
    _assert_bitwise(jax_checkpoint.load_params(ckpt2, template), to_jax_params(resumed.model.state_dict()))
    # a cursor sidecar beside a directory: X -> X.cursor.json
    (ckpt.parent / "model_1.cursor.json").write_text(json.dumps({"epoch": 1, "batch": 3}))
    again = port_train_cli.main(args + ["-e", "2", "-r", str(ckpt)])
    assert (again._resume_epoch, again._resume_batch) == (1, 3)
    assert again.state.step == steps + (steps - 3)


class TestWithoutTensorstore:
    @pytest.fixture
    def no_tensorstore(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "tensorstore", None)  # import raises ImportError

    def test_reading_and_writing_are_refused_by_name(self, tmp_path, no_tensorstore):
        state = _port_state(True, 13)
        for call in (lambda: save_checkpoint_orbax(tmp_path / "ckpt", state),
                     lambda: restore_checkpoint_orbax(tmp_path, state),
                     lambda: load_params(tmp_path)):
            with pytest.raises(ModuleNotFoundError, match="tensorstore"):
                call()
        assert list(tmp_path.iterdir()) == []

    def test_the_train_cli_refuses_before_anything_is_written(self, tmp_path, monkeypatch, no_tensorstore):
        monkeypatch.chdir(tmp_path)
        with pytest.raises(ModuleNotFoundError, match="tensorstore"):
            port_train_cli.main(["-d", "Synthetic", "-dd", ".", "-e", "1", "--device", "cpu",
                                 "--ckpt_backend", "orbax"] + TINY_MODEL)
        assert not (tmp_path / "logs").exists()
