"""The port's training step, whole-model gradient and checkpoints against
the JAX package.

Parameters are one numpy tree in the JAX package's layout, handed to the
JAX ``TrainState`` as it is and to the port through
``weights.from_jax_params``; the batch comes from a numpy seed. The JAX
model runs its XLA path (the Pallas kernels' plain reference), the port
its plain ops: everything on the CPU, at ``num_levels=3, output_level=1,
search_range=2`` and 16x16 frames, plus one 6-level 64x64 gradient gate.

Tolerances.

- float32 gradient: the two frameworks sum the convolutions and their
  gradients in different orders through every layer; each tensor's
  gradient agrees within 2e-4 of its largest entry (1e-3 through the 50
  layers of the 6-level model).
- float32 steps: the loss per step within rtol 1e-4. Adam divides each
  update by sqrt(nu): an entry whose gradient is itself at rounding level
  can step by up to lr in either direction, so after N steps the
  parameters agree within N * lr / 10 everywhere and within 1e-3 * N * lr
  on average.
- bfloat16 compute, float32 parameters: activations are rounded to 8
  bits at every layer, at places that differ between XLA and PyTorch, and
  one flipped bit feeds every later layer. The loss per step agrees within
  2 % (read: 0.2 %), and the parameter *updates* of the two packages are
  the same vector: cosine >= 0.98 over all parameters after N steps
  (read: 0.9967) and a mean difference per entry of at most N * lr / 10
  (read: 0.022 N * lr, where the mean update is 0.73 N * lr). No bound per
  entry is taken: N Adam steps move any two runs at most 2 * N * lr apart,
  so such a bound could not fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.train_lib import checkpoint as jax_checkpoint
from pwcnet_tpu.train_lib import step as jax_step
from pwcnet_tpu.train_lib.schedule import make_lr as jax_make_lr
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume
from pwcnet_tpu_torch.prng import PRNGKey
from pwcnet_tpu_torch.train_lib import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from pwcnet_tpu_torch.weights import from_jax_params, from_jax_state, load_tree, to_jax_params

torch.set_num_threads(1)

TINY = dict(num_levels=3, output_level=1, search_range=2)
HW = 16
LR = 1e-3
N_STEPS = 5


def _jax_tree(cfg, hw, seed, zero_bias=False):
    """A parameter tree shaped by the JAX model's init, filled from numpy:
    fan-in scaled kernels keep activations O(1); small random biases, or
    flax's zero biases."""
    model = JaxPWCDCNet(**cfg)
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 4:
            return (rng.standard_normal(s.shape) / np.sqrt(9.0 * s.shape[2])).astype(np.float32)
        return (rng.standard_normal(s.shape) * (0.0 if zero_bias else 0.05)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _batch(seed, b=4, hw=HW):
    rng = np.random.default_rng(seed)
    images = rng.random((b, 2, hw, hw, 3)).astype(np.float32)
    flows = (rng.standard_normal((b, hw, hw, 2)) * 2).astype(np.float32)
    return images, flows


def _jax_state(model, tree, lr=LR, scheduling=False):
    tx = optax.adam(jax_make_lr(lr, scheduling), b1=0.9, b2=0.999, eps=1e-8)
    return jax_step.TrainState.create(apply_fn=model.apply, params=tree, tx=tx)


def _port_state(cfg, tree, lr=LR, scheduling=False, **model_kwargs):
    model = PWCDCNet(**cfg, **model_kwargs)
    model.load_state_dict(from_jax_params(tree))
    return create_train_state(model, learning_rate=lr, lr_scheduling=scheduling, device="cpu")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(state, images, flows_gt, **loss_kwargs):
    total, metrics = make_loss_fn(state.model, **loss_kwargs)(torch.from_numpy(images), torch.from_numpy(flows_gt))
    named = dict(state.model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    return _flat(to_jax_params(grads)), metrics


def _assert_grads_close(got, want, rel):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.dtype == np.float32 and g.shape == w.shape, key
        assert np.abs(g - w).max() <= rel * np.abs(w).max() + 1e-7, key


class TestWholeModelGradient:
    @pytest.mark.parametrize("loss_name", ["multiscale", "robust"])
    def test_matches_jax_grad(self, loss_name):
        tree = _jax_tree(TINY, HW, seed=1)
        images, flows_gt = _batch(2)
        loss_fn = jax_step.make_loss_fn(JaxPWCDCNet(**TINY), loss_name=loss_name)
        (_, want_metrics), want = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            tree, jnp.asarray(images), jnp.asarray(flows_gt))
        got, metrics = _port_grads(_port_state(TINY, tree), images, flows_gt, loss_name=loss_name)
        for key in ("loss", "data_loss", "epe"):
            np.testing.assert_allclose(float(metrics[key]), float(want_metrics[key]), rtol=1e-5)
        _assert_grads_close(got, _flat(want), 2e-4)

    def test_decoupled_decay_keeps_the_term_out_of_the_gradient(self):
        tree = _jax_tree(TINY, HW, seed=1)
        images, flows_gt = _batch(2)
        state = _port_state(TINY, tree)
        with_wd, m1 = _port_grads(state, images, flows_gt, gamma=0.1)
        without, m2 = _port_grads(state, images, flows_gt, gamma=0.1, decoupled_wd=True)
        assert float(m1["loss"]) == float(m2["loss"]) > float(m1["data_loss"])
        params = _flat(to_jax_params(state.model.state_dict()))
        for key, g in with_wd.items():
            np.testing.assert_allclose(g, without[key] + 0.1 * params[key], rtol=1e-5, atol=1e-6)

    def test_black_regions_follow_jax_at_leaky_relu_zero(self, monkeypatch):
        """With zero biases every conv over a black region is exactly 0,
        where jax.nn.leaky_relu has gradient 1 and F.leaky_relu 0.1: the
        port must follow the JAX package (the bias gradients show it)."""
        tree = _jax_tree(TINY, HW, seed=3, zero_bias=True)
        images, flows_gt = _batch(4)
        images[:, :, :, : HW // 2] = 0.0
        loss_fn = jax_step.make_loss_fn(JaxPWCDCNet(**TINY))
        want = _flat(jax.jit(jax.grad(lambda p: loss_fn(p, jnp.asarray(images), jnp.asarray(flows_gt))[0]))(tree))
        state = _port_state(TINY, tree)
        got, _ = _port_grads(state, images, flows_gt)
        _assert_grads_close(got, want, 2e-4)

        # the same model with PyTorch's own LeakyReLU gradient is caught
        import pwcnet_tpu_torch.models.pyramid as pyramid_module

        monkeypatch.setattr(pyramid_module, "leaky_relu", torch.nn.functional.leaky_relu)
        theirs, _ = _port_grads(state, images, flows_gt)
        key = "['fp_extractor']['conv2d']['bias']"
        assert np.abs(theirs[key] - want[key]).max() > 1e-2 * np.abs(want[key]).max()

    def test_full_depth_gate(self):
        """The production configuration: 6 levels, d=4, output level 4, 64x64."""
        tree = _jax_tree({}, 64, seed=7)
        images, flows_gt = _batch(5, b=2, hw=64)
        loss_fn = jax_step.make_loss_fn(JaxPWCDCNet())
        want = jax.jit(jax.grad(lambda p, i, f: loss_fn(p, i, f)[0]))(tree, jnp.asarray(images), jnp.asarray(flows_gt))
        got, _ = _port_grads(_port_state({}, tree), images, flows_gt)
        assert len(got) == 110
        _assert_grads_close(got, _flat(want), 1e-3)

    def test_kernel_hooks_on_cpu_give_the_plain_gradient(self):
        """Wired as on the card (K2, K1, two fused pyramid levels), CPU
        tensors take the plain versions under ordinary autograd."""
        tree = _jax_tree(TINY, HW, seed=1)
        images, flows_gt = _batch(2)
        hooks = dict(cost_volume_fn=cost_volume_cuda, warp_cv_fn=warped_cost_volume, fused_pyramid_levels=2)
        got, _ = _port_grads(_port_state(TINY, tree, **hooks), images, flows_gt)
        want, _ = _port_grads(_port_state(TINY, tree), images, flows_gt)
        _assert_grads_close(got, want, 1e-5)

    def test_bfloat16_compute_gives_float32_gradients(self):
        tree = _jax_tree(TINY, HW, seed=1)
        images, flows_gt = _batch(2)
        state = _port_state(TINY, tree, compute_dtype=torch.bfloat16)
        got, metrics = _port_grads(state, images, flows_gt)
        want, _ = _port_grads(_port_state(TINY, tree), images, flows_gt)
        assert metrics["loss"].dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
        flat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])
        a, b = flat(got), flat(want)
        assert all(g.dtype == np.float32 for g in got.values())
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.98


def _run_both(loss_name, jax_dtype=None, torch_dtype=None, scheduling=False):
    tree = _jax_tree(TINY, HW, seed=11)
    images, flows_gt = _batch(12)
    jax_kwargs = {} if jax_dtype is None else {"dtype": jax_dtype}
    jax_model = JaxPWCDCNet(**TINY, **jax_kwargs)
    jstate = _jax_state(jax_model, tree, scheduling=scheduling)
    jstep = jax_step.make_train_step(jax_model, donate=False, loss_name=loss_name)
    state = _port_state(TINY, tree, scheduling=scheduling, compute_dtype=torch_dtype)
    step = make_train_step(state.model, loss_name=loss_name)
    rows = []
    for _ in range(N_STEPS):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(flows_gt))
        state, m = step(state, torch.from_numpy(images), torch.from_numpy(flows_gt))
        rows.append(({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in jm.items()}))
    return tree, jstate, state, rows


class TestTrainSteps:
    @pytest.mark.parametrize("loss_name", ["multiscale", "robust"])
    def test_five_steps_match_jax_float32(self, loss_name):
        tree, jstate, state, rows = _run_both(loss_name)
        assert state.step == int(jstate.step) == N_STEPS
        for got, want in rows:
            assert set(got) == {"loss", "data_loss", "epe"}
            for key in got:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
        assert rows[-1][0]["loss"] < rows[0][0]["loss"]
        got = _flat(to_jax_params(state.model.state_dict()))
        want = _flat(jstate.params)
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert diffs.max() <= N_STEPS * LR / 10 and diffs.mean() <= 1e-3 * N_STEPS * LR
        # the moments too
        mu = _flat(to_jax_params(state.mu))
        for key, w in _flat(jstate.opt_state[0].mu).items():
            assert np.abs(mu[key] - w).max() <= 2e-4 * np.abs(w).max() + 1e-7, key

    def test_five_steps_match_jax_bfloat16_compute(self):
        tree, jstate, state, rows = _run_both("multiscale", jnp.bfloat16, torch.bfloat16)
        for got, want in rows:
            for key in got:
                np.testing.assert_allclose(got[key], want[key], rtol=2e-2, err_msg=key)
        start = _flat(tree)
        got = _flat(to_jax_params(state.model.state_dict()))
        want = _flat(jstate.params)
        for key in want:
            assert got[key].dtype == want[key].dtype == np.float32
        a = np.concatenate([(got[k] - start[k]).ravel() for k in want])
        b = np.concatenate([(want[k] - start[k]).ravel() for k in want])
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.98
        assert np.abs(a - b).mean() <= N_STEPS * LR / 10

    def test_the_schedule_is_read_before_the_count_moves(self):
        """Across a boundary the step with count == boundary already uses
        the halved rate, as optax reads its schedule."""
        tree = _jax_tree(TINY, HW, seed=11)
        images, flows_gt = _batch(12)
        state = _port_state(TINY, tree, lr=1e-3, scheduling=True)
        assert state.lr() == 1e-3
        state.step = 199_999
        assert state.lr() == 1e-3
        state.step = 200_000
        assert state.lr() == 5e-4
        step = make_train_step(state.model)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, _ = step(state, torch.from_numpy(images), torch.from_numpy(flows_gt))
        assert state.step == 200_001
        # first update from zero moments at count 200001: bias correction
        # makes |delta| = lr * |g| / (|g| + eps') <= lr, lr = 5e-4 here
        moved = max((v - before[k]).abs().max().item() for k, v in state.model.state_dict().items())
        assert 0 < moved <= 5e-4 * 1.001 * (1 - 0.9) / (1 - 0.9 ** 200_001) / (1 - 0.999) ** 0.5

    def test_eval_step_does_not_update(self):
        tree = _jax_tree(TINY, HW, seed=11)
        images, flows_gt = _batch(12)
        jax_model = JaxPWCDCNet(**TINY)
        want = jax_step.make_eval_step(jax_model)(_jax_state(jax_model, tree), jnp.asarray(images),
                                                  jnp.asarray(flows_gt))
        state = _port_state(TINY, tree)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        metrics = make_eval_step(state.model)(state, torch.from_numpy(images), torch.from_numpy(flows_gt))
        assert state.step == 0
        assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
        for key in ("loss", "data_loss", "epe"):
            np.testing.assert_allclose(float(metrics[key]), float(want[key]), rtol=1e-5)

    def test_unknown_loss_raises(self):
        with pytest.raises(ValueError, match="multiscale"):
            make_loss_fn(PWCDCNet(**TINY), loss_name="charbonnier")
        with pytest.raises(ValueError):
            make_train_step(PWCDCNet(**TINY), loss_name="l2")


class TestCreateTrainState:
    def test_fresh_state(self):
        model = PWCDCNet(**TINY)
        state = create_train_state(model, PRNGKey(5), device="cpu")
        again = create_train_state(PWCDCNet(**TINY, init=False), PRNGKey(5), device="cpu")
        assert isinstance(state, TrainState) and state.step == 0 and state.model is model
        assert state.lr() == 1e-4 and callable(state.learning_rate)  # scheduled by default
        assert create_train_state(PWCDCNet(**TINY), lr_scheduling=False, device="cpu").learning_rate == 1e-4
        names = [k for k, _ in model.named_parameters()]
        assert list(state.mu) == list(state.nu) == names
        for (k, p), q in zip(model.named_parameters(), again.model.parameters()):
            assert p.dtype == torch.float32 and torch.equal(p, q), k
            assert not state.mu[k].any() and not state.nu[k].any() and state.mu[k].shape == p.shape

    def test_runs_on_the_card_unless_asked_for_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_train_state(PWCDCNet(**TINY))


class TestCheckpoint:
    def _trained(self, scheduling):
        tree = _jax_tree(TINY, HW, seed=21)
        images, flows_gt = _batch(22)
        jax_model = JaxPWCDCNet(**TINY)
        jstate = _jax_state(jax_model, tree, scheduling=scheduling)
        jstep = jax_step.make_train_step(jax_model, donate=False)
        state = _port_state(TINY, tree, scheduling=scheduling)
        step = make_train_step(state.model)
        for _ in range(2):
            jstate, _ = jstep(jstate, jnp.asarray(images), jnp.asarray(flows_gt))
            state, _ = step(state, torch.from_numpy(images), torch.from_numpy(flows_gt))
        return tree, (images, flows_gt), (jax_model, jstate, jstep), (state, step)

    @pytest.mark.parametrize("scheduling", [False, True], ids=["constant", "scheduled"])
    def test_written_by_jax_restores_in_the_port(self, tmp_path, scheduling):
        tree, (images, flows_gt), (jax_model, jstate, jstep), _ = self._trained(scheduling)
        path = jax_checkpoint.save_checkpoint(tmp_path / "model_2.msgpack", jstate)
        state = restore_checkpoint(path, _port_state(TINY, _jax_tree(TINY, HW, seed=99), scheduling=scheduling))
        assert state.step == 2
        for name, got, want in (("params", state.model.state_dict(), jstate.params),
                                ("mu", state.mu, jstate.opt_state[0].mu), ("nu", state.nu, jstate.opt_state[0].nu)):
            got = _flat(to_jax_params(got))
            for key, w in _flat(want).items():
                np.testing.assert_array_equal(got[key], w, err_msg=f"{name} {key}")
        # and training resumes alike from it
        state, m = make_train_step(state.model)(state, torch.from_numpy(images), torch.from_numpy(flows_gt))
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(flows_gt))
        assert state.step == int(jstate.step) == 3
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)

    @pytest.mark.parametrize("scheduling", [False, True], ids=["constant", "scheduled"])
    def test_written_by_the_port_restores_in_jax(self, tmp_path, scheduling):
        tree, _, (jax_model, _, _), (state, _) = self._trained(scheduling)
        path = save_checkpoint(tmp_path / "ckpt" / "model_2.msgpack", state)
        assert path.endswith("model_2.msgpack") and not list((tmp_path / "ckpt").glob("*.tmp"))
        template = _jax_state(jax_model, _jax_tree(TINY, HW, seed=98), scheduling=scheduling)
        restored = jax_checkpoint.restore_checkpoint(path, template)
        assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
        if scheduling:
            assert int(restored.opt_state[1].count) == 2
        for name, got, want in (("params", restored.params, state.model.state_dict()),
                                ("mu", restored.opt_state[0].mu, state.mu), ("nu", restored.opt_state[0].nu, state.nu)):
            want = _flat(to_jax_params(want))
            for key, g in _flat(got).items():
                np.testing.assert_array_equal(g, want[key], err_msg=f"{name} {key}")
        # the JAX package's params-only loader reads it too
        params = jax_checkpoint.load_params(path, template.params)
        np.testing.assert_array_equal(np.asarray(params["context"]["conv2d"]["kernel"]),
                                      _flat(to_jax_params(state.model.state_dict()))["['context']['conv2d']['kernel']"])

    def test_round_trip_in_the_port_and_mismatches_raise(self, tmp_path):
        _, _, _, (state, _) = self._trained(False)
        path = save_checkpoint(tmp_path / "a.msgpack", state)
        fresh = restore_checkpoint(path, _port_state(TINY, _jax_tree(TINY, HW, seed=97)))
        assert fresh.step == state.step
        for k, v in state.model.state_dict().items():
            assert torch.equal(v, fresh.model.state_dict()[k])
            assert torch.equal(state.mu[k], fresh.mu[k]) and torch.equal(state.nu[k], fresh.nu[k])
        params, mu, nu, step = from_jax_state(load_tree(path))
        assert step == 2 and params.keys() == mu.keys() == nu.keys()
        other = create_train_state(PWCDCNet(num_levels=4, output_level=1, search_range=2), device="cpu")
        with pytest.raises((KeyError, RuntimeError)):
            restore_checkpoint(path, other)
        tree = load_tree(path)
        tree["opt_state"]["0"]["count"] = np.asarray(7, np.int32)
        with pytest.raises(ValueError, match="disagree"):
            from_jax_state(tree)
