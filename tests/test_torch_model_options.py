"""PWCDCNet's ``remat``, ``batched_pyramid`` and ``with_features``,
FlowPredictor's ``use_fused`` / ``fused_pyramid`` / ``batched_pyramid``, the
transcode entry point and the test CLI's figure, against the JAX package on
the CPU.

Parameters are one numpy tree in the JAX package's layout, handed to the
JAX model as it is and to the port through ``weights.from_jax_params``;
inputs come from numpy seeds. The JAX model runs its XLA path, the port its
plain ops, at ``num_levels=3, output_level=1, search_range=2`` (plus the
6-level model where said).

Tolerances.

- Remat against the port without it: bitwise (``torch.equal``). The
  recompute runs the same ops on the same inputs, and the backward sums
  the same cotangents in the same order.
- Remat against the JAX ``remat=True`` model: as
  ``tests/test_torch_train.py`` holds the port without remat (each
  gradient within 2e-4 of its largest entry, metrics rtol 1e-5; five
  steps: loss rtol 1e-4, parameters within N * lr / 10 and on average
  1e-3 * N * lr).
- ``batched_pyramid`` against the JAX model with it: rtol 1e-4, atol 1e-6
  on every level's flow and on the final flow, the bound of
  ``tests/test_models.py::test_batched_pyramid_matches_default``; against
  the port without it: the forward bitwise on the CPU, the gradient to
  summation order.
- Forwards and predictors against JAX: rtol 1e-4, atol 1e-5 per level and
  atol 1e-4 on the full-resolution flow, as ``tests/test_torch_model.py``.
"""

import importlib.util
import json
import re
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import pwcnet_tpu_torch.models.pyramid as pyramid_module
from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.train_lib import step as jax_step
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.models.pwcnet import kernel_hooks
from pwcnet_tpu_torch.ops.cuda import estimator_conv, pyramid_conv
from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume
from pwcnet_tpu_torch.ops.estimator_conv import estimator_chain_bwd_plain, estimator_chain_plain
from pwcnet_tpu_torch.train_lib import create_train_state, make_loss_fn, make_train_step
from pwcnet_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(num_levels=3, output_level=1, search_range=2)
TINY_FLAGS = ["--num_levels", "3", "--search_range", "2", "--output_level", "1"]
HW = 16
LR = 1e-3
N_STEPS = 5
KERNEL_HOOKS = kernel_hooks(True, fused_estimator=2)


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


def _batch(seed, b=2, hw=HW):
    rng = np.random.default_rng(seed)
    images = rng.random((b, 2, hw, hw, 3)).astype(np.float32)
    flows = (rng.standard_normal((b, hw, hw, 2)) * 2).astype(np.float32)
    return images, flows


def _port(cfg, tree, **kwargs):
    model = PWCDCNet(**cfg, **kwargs)
    model.load_state_dict(from_jax_params(tree))
    return model


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads(model, images, flows_gt, **loss_kwargs):
    """The loss, its metrics and every parameter's gradient, by name."""
    total, metrics = make_loss_fn(model, **loss_kwargs)(torch.from_numpy(images), torch.from_numpy(flows_gt))
    named = dict(model.named_parameters())
    return total, metrics, dict(zip(named, torch.autograd.grad(total, list(named.values()))))


def _assert_grads_close(got, want, rel):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.dtype == np.float32 and g.shape == w.shape, key
        assert np.abs(g - w).max() <= rel * np.abs(w).max() + 1e-7, key


@pytest.mark.parametrize("mesh", [None, "one-row"])
@pytest.mark.parametrize("warp_type", ["bilinear", "nearest"])
@pytest.mark.parametrize("fused_estimator", [0, 2])
@pytest.mark.parametrize("fused", [None, True, False], ids=["auto", "fused", "unfused"])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_kernel_hooks_table(use_kernels, fused, fused_estimator, warp_type, mesh):
    """``kernel_hooks`` off a spatial mesh: with the kernels K2, K1 when
    fused (auto: with the bilinear warp), K3 on two pyramid levels, K7 on
    ``fused_estimator`` levels; without them no hook. A mesh of one row
    (data 2, spatial 1) wires as no mesh. An explicit ``fused=True`` with
    the nearest warp reaches the constructor, which refuses it."""
    from pwcnet_tpu_torch.models.pwcnet import FUSED_PYRAMID_LEVELS
    from pwcnet_tpu_torch.parallel.mesh import Mesh

    if mesh == "one-row":
        mesh = Mesh(data=2, spatial=1, rank=0, device=torch.device("cpu"), rows=None, column=None)
    hooks = kernel_hooks(use_kernels, fused=fused, fused_estimator=fused_estimator, mesh=mesh, warp_type=warp_type)
    fuses = fused if fused is not None else warp_type == "bilinear"
    if not use_kernels:
        assert hooks == {}
    else:
        assert set(hooks) == {"cost_volume_fn", "warp_cv_fn", "fused_pyramid_levels", "fused_estimator_levels"}
        assert hooks["cost_volume_fn"] is cost_volume_cuda
        assert hooks["warp_cv_fn"] is (warped_cost_volume if fuses else None)
        assert hooks["fused_pyramid_levels"] == FUSED_PYRAMID_LEVELS == 2
        assert hooks["fused_estimator_levels"] == fused_estimator
    if use_kernels and fuses and warp_type == "nearest":
        with pytest.raises(ValueError, match="warp_cv_fn fuses the bilinear warp"):
            PWCDCNet(**TINY, warp_type=warp_type, init=False, **hooks)
    else:
        model = PWCDCNet(**TINY, warp_type=warp_type, init=False, **hooks)
        assert model.fp_extractor.fused_levels == (2 if use_kernels else 0)
        assert [model.optflow_0.fused, model.optflow_1.fused] == [use_kernels and fused_estimator == 2] * 2


@pytest.fixture
def kernel_functions(monkeypatch):
    """CPU tensors through K3's and K7's card paths (``_on_card``: their
    ``torch.autograd.Function``s), each kernel launch replaced by its plain
    version and counted, K6 and K7b included. Returns the counter."""
    launches = Counter()

    def k3_forward(x, k1, b1, k2, b2, k3, b3, save):
        launches["K3"] += 1
        out, s1, s2 = pyramid_conv.pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts=True)
        return (out, s1, s2) if save else (out, None, None)

    def k6(*args, **kwargs):
        launches["K6"] += 1
        return pyramid_conv.pyramid_level_bwd_plain(*args, **kwargs)

    def k7_forward(xin, kbs):
        launches["K7"] += 1
        flow, feat, acts = estimator_chain_plain(xin, *kbs, return_acts=True)
        return flow, [*acts, feat]

    def k7b(ks, chans, acts, g_flow, g_feat, need_dx):
        launches["K7b"] += 1
        return estimator_chain_bwd_plain(ks, acts, g_flow, g_feat, need_dx)

    def k7_wrapper(xin, *kbs):
        xin, kbs = estimator_conv._pad_input(xin, kbs)
        return estimator_conv._on_card(xin, kbs)

    monkeypatch.setattr(pyramid_conv, "_forward", k3_forward)
    monkeypatch.setattr(pyramid_conv, "pyramid_level_bwd", k6)
    monkeypatch.setattr(pyramid_module, "pyramid_level_fused", pyramid_conv._on_card)
    monkeypatch.setattr(estimator_conv, "_forward", k7_forward)
    monkeypatch.setattr(estimator_conv, "_backward", k7b)
    monkeypatch.setattr(estimator_conv, "estimator_chain_fused", k7_wrapper)
    return launches


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, the caller's count restored after
    it. At two, PyTorch's CPU convolution backward does not give the same
    input gradient twice for the 6-level model's level-0 estimator (its
    1x1 rows): the first tensor to differ between two identical runs is
    ``optflow_0.conv2d_3``'s input gradient, its output gradient equal.
    The module sets one thread when it is imported, but a test that runs
    ``benchmark.run.run_cell`` in the same process may have set two since."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.usefixtures("one_thread")
class TestRemat:
    @pytest.mark.parametrize("cfg,hw,hooks", [
        (TINY, HW, {}),
        (TINY, HW, KERNEL_HOOKS),
        ({}, 64, {}),
    ], ids=["3-level", "3-level-kernel-hooks", "6-level"])
    def test_bitwise_the_model_without_remat(self, cfg, hw, hooks):
        """The loss and every gradient, and one Adam step's parameters."""
        tree = _jax_tree(cfg, hw, seed=1)
        images, flows_gt = _batch(2, b=1 if hw == 64 else 2, hw=hw)
        out = {}
        for remat in (False, True):
            model = _port(cfg, tree, remat=remat, **hooks)
            total, metrics, grads = _grads(model, images, flows_gt, decoupled_wd=True)
            state = create_train_state(model, learning_rate=LR, lr_scheduling=False, device="cpu")
            make_train_step(model)(state, torch.from_numpy(images), torch.from_numpy(flows_gt))
            out[remat] = total, metrics, grads, dict(model.named_parameters())
        assert out[True][0].requires_grad and torch.equal(out[True][0], out[False][0])
        for key in ("data_loss", "epe"):
            assert torch.equal(out[True][1][key], out[False][1][key]), key
        assert len(out[True][2]) == (110 if cfg == {} else len(out[False][2]))
        for name, g in out[False][2].items():
            assert torch.equal(out[True][2][name], g), name
            assert torch.equal(out[True][3][name], out[False][3][name]), name

    @pytest.mark.parametrize("loss_name", ["multiscale", "robust"])
    def test_matches_jax_remat_grad(self, loss_name):
        tree = _jax_tree(TINY, HW, seed=1)
        images, flows_gt = _batch(2)
        loss_fn = jax_step.make_loss_fn(JaxPWCDCNet(**TINY, remat=True), loss_name=loss_name)
        (_, want_metrics), want = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            tree, jnp.asarray(images), jnp.asarray(flows_gt))
        _, metrics, grads = _grads(_port(TINY, tree, remat=True), images, flows_gt, loss_name=loss_name)
        for key in ("loss", "data_loss", "epe"):
            np.testing.assert_allclose(float(metrics[key]), float(want_metrics[key]), rtol=1e-5)
        _assert_grads_close(_flat(to_jax_params(grads)), _flat(want), 2e-4)

    @pytest.mark.parametrize("loss_name", ["multiscale", "robust"])
    def test_five_steps_match_jax_remat(self, loss_name):
        tree = _jax_tree(TINY, HW, seed=11)
        images, flows_gt = _batch(12, b=4)
        jax_model = JaxPWCDCNet(**TINY, remat=True)
        tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
        jstate = jax_step.TrainState.create(apply_fn=jax_model.apply, params=tree, tx=tx)
        jstep = jax_step.make_train_step(jax_model, donate=False, loss_name=loss_name)
        model = _port(TINY, tree, remat=True)
        state = create_train_state(model, learning_rate=LR, lr_scheduling=False, device="cpu")
        step = make_train_step(model, loss_name=loss_name)
        losses = []
        for _ in range(N_STEPS):
            jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(flows_gt))
            state, m = step(state, torch.from_numpy(images), torch.from_numpy(flows_gt))
            for key in ("loss", "data_loss", "epe"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
            losses.append(float(m["loss"]))
        assert state.step == int(jstate.step) == N_STEPS and losses[-1] < losses[0]
        got, want = _flat(to_jax_params(state.model.state_dict())), _flat(jstate.params)
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert diffs.max() <= N_STEPS * LR / 10 and diffs.mean() <= 1e-3 * N_STEPS * LR

    @pytest.mark.parametrize("batched", [False, True], ids=["two-calls", "batched"])
    def test_kernel_functions_rerun_under_the_checkpoint(self, kernel_functions, batched):
        """K3's and K7's autograd Functions (their bodies the plain
        versions) under the checkpoint: the gradient is bitwise the one
        without remat, and a step reruns each forward once more: K3 4 -> 8,
        K7 2 -> 4 (2 -> 4 and 2 -> 4 with the batched pyramid: one call on
        both frames), K6 and K7b as without remat."""
        tree = _jax_tree(TINY, HW, seed=1)
        images, flows_gt = _batch(2)
        out = {}
        for remat in (False, True):
            kernel_functions.clear()
            _, _, out[remat] = _grads(_port(TINY, tree, remat=remat, batched_pyramid=batched, **KERNEL_HOOKS),
                                      images, flows_gt, decoupled_wd=True)
            k3 = 2 if batched else 4
            assert dict(kernel_functions) == {"K3": k3 * (1 + remat), "K6": k3, "K7": 2 * (1 + remat), "K7b": 2}
        for name, g in out[False].items():
            assert torch.equal(out[True][name], g), name
        # and the plain path's gradient, to rounding
        _, _, plain = _grads(_port(TINY, tree), images, flows_gt, decoupled_wd=True)
        for name, g in plain.items():
            assert (out[True][name] - g).abs().max() <= 1e-5 * g.abs().max() + 1e-7, name

    def test_level_zero_skips_dx_in_the_recompute(self, kernel_functions, monkeypatch):
        """K6 on level 0 (the images need no gradient) is asked for no dx,
        level 1 is, with and without remat."""
        need = []
        k6 = pyramid_conv.pyramid_level_bwd

        def recording(*args, need_dx=True):
            need.append(need_dx)
            return k6(*args, need_dx=need_dx)

        monkeypatch.setattr(pyramid_conv, "pyramid_level_bwd", recording)
        tree = _jax_tree(TINY, HW, seed=1)
        images, flows_gt = _batch(2)
        for remat in (False, True):
            need.clear()
            _grads(_port(TINY, tree, remat=remat, **KERNEL_HOOKS), images, flows_gt)
            assert sorted(need) == [False, False, True, True]

    def test_no_checkpoint_without_grad(self, monkeypatch):
        """Under no_grad (evaluation, serving) remat changes nothing."""
        import pwcnet_tpu_torch.models.pwcnet as pwcnet_module

        monkeypatch.setattr(pwcnet_module, "checkpoint", lambda *a, **k: pytest.fail("checkpoint under no_grad"))
        tree = _jax_tree(TINY, HW, seed=1)
        images, _ = _batch(2)
        x0, x1 = torch.from_numpy(images[:, 0]), torch.from_numpy(images[:, 1])
        with torch.no_grad():
            got = _port(TINY, tree, remat=True)(x0, x1)
            want = _port(TINY, tree)(x0, x1)
        assert torch.equal(got[0], want[0])


class TestBatchedPyramid:
    def test_matches_jax_batched(self):
        tree = _jax_tree(TINY, HW, seed=3)
        images, _ = _batch(4)
        want, want_pyr = JaxPWCDCNet(**TINY, batched_pyramid=True).apply(
            {"params": tree}, jnp.asarray(images[:, 0]), jnp.asarray(images[:, 1]))
        with torch.no_grad():
            got, got_pyr = _port(TINY, tree, batched_pyramid=True)(
                torch.from_numpy(images[:, 0]), torch.from_numpy(images[:, 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
        assert len(got_pyr) == len(want_pyr) == 2
        for g, w in zip(got_pyr, want_pyr):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("hooks", [{}, KERNEL_HOOKS], ids=["plain", "kernel-hooks"])
    def test_bitwise_two_calls(self, hooks):
        """The forward and frame 0's pyramid: the 2B call split at B gives
        each frame's levels bit for bit. The gradient to summation order
        (each tensor within 1e-5 of its largest entry): a pyramid weight's
        gradient sums over 2B in one call instead of adding two calls'."""
        tree = _jax_tree(TINY, HW, seed=3)
        images, flows_gt = _batch(5)
        x0, x1 = torch.from_numpy(images[:, 0]), torch.from_numpy(images[:, 1])
        with torch.no_grad():
            got = _port(TINY, tree, batched_pyramid=True, **hooks)(x0, x1, with_features=True)
            want = _port(TINY, tree, **hooks)(x0, x1, with_features=True)
        assert torch.equal(got[0], want[0])
        for g, w in zip(got[1] + got[2], want[1] + want[2]):
            assert torch.equal(g, w)
        _, _, g_batched = _grads(_port(TINY, tree, batched_pyramid=True, **hooks), images, flows_gt)
        _, _, g_two = _grads(_port(TINY, tree, **hooks), images, flows_gt)
        for name, g in g_two.items():
            assert (g_batched[name] - g).abs().max() <= 1e-5 * g.abs().max() + 1e-9, name


class TestWithFeatures:
    def test_matches_jax(self):
        tree = _jax_tree(TINY, 32, seed=4)
        images, _ = _batch(6, hw=32)
        want = JaxPWCDCNet(**TINY).apply({"params": tree}, jnp.asarray(images[:, 0]), jnp.asarray(images[:, 1]),
                                         with_features=True)
        with torch.no_grad():
            got = _port(TINY, tree)(torch.from_numpy(images[:, 0]), torch.from_numpy(images[:, 1]),
                                    with_features=True)
        assert len(got) == len(want) == 3
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
        for g, w in zip(got[1], want[1]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
        assert [tuple(p.shape) for p in got[2]] == [tuple(p.shape) for p in want[2]] == [
            (2, 4, 4, 64), (2, 8, 8, 32), (2, 16, 16, 16)]
        for g, w in zip(got[2], want[2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)

    def test_six_levels_deep_first(self):
        """The default model's frame-0 pyramid, as tests/test_models.py
        reads the JAX one: six levels, 1x1x192 first, 32x32x16 last."""
        images = torch.zeros((1, 64, 64, 3))
        with torch.no_grad():
            out = PWCDCNet()(images, images, with_features=True)
            plain = PWCDCNet()(images, images)
        assert len(out) == 3 and len(out[2]) == 6
        assert out[2][0].shape == (1, 1, 1, 192) and out[2][5].shape == (1, 32, 32, 16)
        assert all(p.is_contiguous() for p in out[2])
        assert torch.equal(out[0], plain[0])


@pytest.fixture(scope="module")
def predictor_ckpt(tmp_path_factory):
    from flax import serialization

    tree = _jax_tree(TINY, 16, seed=4)
    path = tmp_path_factory.mktemp("predictor") / "model.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    return tree, str(path)


def _pair():
    rng = np.random.default_rng(5)
    img0 = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
    return img0, np.roll(img0, (1, 2), (0, 1))


class TestFlowPredictorOptions:
    @pytest.mark.parametrize("option", [
        dict(use_fused=False), dict(fused_pyramid=0), dict(batched_pyramid=True),
    ], ids=["use_fused", "fused_pyramid", "batched_pyramid"])
    def test_matches_jax_and_the_default(self, predictor_ckpt, option):
        """Each option against the JAX predictor with the same argument, and
        against the port's default predictor, on one msgpack. The port runs
        with the kernels' wrappers wired in (their plain versions here), so
        each option changes what is wired."""
        from pwcnet_tpu.inference import FlowPredictor as JaxFlowPredictor
        from pwcnet_tpu_torch.inference import FlowPredictor

        tree, ckpt = predictor_ckpt
        img0, img1 = _pair()
        jax_pred = JaxFlowPredictor(use_pallas=False, **option, **TINY)
        jax_pred._params = tree
        want = jax_pred(img0, img1)
        pred = FlowPredictor(device="cpu", checkpoint=ckpt, use_kernels=True, **option, **TINY)
        model = pred.model
        assert (model.warp_cv_fn is None) == ("use_fused" in option)
        assert model.fp_extractor.fused_levels == (0 if "fused_pyramid" in option else 2)
        assert model.batched_pyramid == ("batched_pyramid" in option)
        got = pred(img0, img1)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        default = FlowPredictor(device="cpu", checkpoint=ckpt, **TINY)(img0, img1)
        np.testing.assert_allclose(got[0], default[0], rtol=1e-5, atol=1e-5)

    def test_auto_resolves_as_jax(self):
        from pwcnet_tpu_torch.inference import FUSED_PYRAMID_LEVELS, FlowPredictor

        plain = FlowPredictor(device="cpu", **TINY).model
        assert plain.warp_cv_fn is None and plain.fp_extractor.fused_levels == 0 and not plain.batched_pyramid
        kernels = FlowPredictor(device="cpu", use_kernels=True, **TINY).model
        assert kernels.warp_cv_fn is warped_cost_volume and kernels.cost_volume_fn is cost_volume_cuda
        assert kernels.fp_extractor.fused_levels == FUSED_PYRAMID_LEVELS == 2 and not kernels.batched_pyramid
        nearest = FlowPredictor(device="cpu", use_kernels=True, warp_type="nearest", **TINY).model
        assert nearest.warp_cv_fn is None
        assert FlowPredictor(device="cpu", fused_pyramid=1, **TINY).model.fp_extractor.fused_levels == 1

    @pytest.mark.parametrize("option,match", [
        (dict(fused_pyramid="two"), "invalid literal"),
        (dict(use_fused=True, warp_type="nearest"), "warp_cv_fn fuses the bilinear warp"),
    ], ids=["fused_pyramid", "use_fused-nearest"])
    def test_what_is_refused_raises_as_jax(self, predictor_ckpt, option, match):
        """The JAX predictor raises when it is built or first called (its
        model is set up lazily); the port when it is built."""
        from pwcnet_tpu.inference import FlowPredictor as JaxFlowPredictor
        from pwcnet_tpu_torch.inference import FlowPredictor

        img0, img1 = _pair()
        with pytest.raises(ValueError, match=match):
            jax_pred = JaxFlowPredictor(use_pallas=True, **option, **TINY)
            jax_pred._params = predictor_ckpt[0]
            jax_pred(img0, img1)
        with pytest.raises(ValueError, match=match):
            FlowPredictor(device="cpu", use_kernels=True, **option, **TINY)


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class TestTranscodeCli:
    def test_same_bytes_as_the_jax_tool(self, tmp_path, monkeypatch, capsys):
        from pwcnet_tpu_torch import transcode_dataset
        from pwcnet_tpu_torch.utils import save_flow

        rng = np.random.default_rng(0)
        data = tmp_path / "chairs" / "data"
        data.mkdir(parents=True)
        for i in range(1, 13):
            for tag in ("img1", "img2"):
                Image.fromarray((rng.random((24, 32, 3)) * 255).astype(np.uint8)).save(data / f"{i:05d}_{tag}.ppm")
            save_flow(data / f"{i:05d}_flow.flo", rng.standard_normal((24, 32, 2)).astype(np.float32))
        common = ["-d", "FlyingChairs", "-dd", str(tmp_path / "chairs")]
        records = transcode_dataset.main(common + ["--out", str(tmp_path / "port")])
        port_lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
        assert port_lines == records and [r["split"] for r in records] == ["train", "val"]
        monkeypatch.setattr("sys.argv", ["transcode_dataset.py"] + common + ["--out", str(tmp_path / "jax")])
        _load_script(REPO / "scripts" / "transcode_dataset.py", "jax_transcode_dataset").main()
        jax_lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
        assert len(jax_lines) == 2
        for mine, theirs in zip(port_lines, jax_lines):
            assert mine["cache_dir"] == str(tmp_path / f"port_{mine['split']}")
            assert theirs["cache_dir"] == str(tmp_path / f"jax_{theirs['split']}")
            drop = ("transcode_sec", "cache_dir")
            assert {k: v for k, v in mine.items() if k not in drop} == {
                k: v for k, v in theirs.items() if k not in drop}
            assert mine["samples"] > 0 and mine["frames_bytes"] == mine["samples"] * 2 * 24 * 32 * 3
            for name in ("frames.u8", "flows.f32", "index.json"):
                assert (Path(mine["cache_dir"]) / name).read_bytes() == (
                    Path(theirs["cache_dir"]) / name).read_bytes(), name
        # a second run keeps the cache
        again = transcode_dataset.main(common + ["--out", str(tmp_path / "port"), "--split", "val"])
        assert again[0]["frames_bytes"] == port_lines[1]["frames_bytes"]


class TestTestFigure:
    def test_the_figure_is_where_the_root_cli_writes_it(self, tmp_path, monkeypatch):
        from pwcnet_tpu_torch import test as port_test_cli

        rng = np.random.default_rng(8)
        frames = tmp_path / "clip"
        frames.mkdir()
        paths = [frames / f"frame_{i:04d}.png" for i in (1, 2)]
        base = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
        Image.fromarray(base).save(paths[0])
        Image.fromarray(np.roll(base, (1, 2), (0, 1))).save(paths[1])
        argv = ["--input_images", *map(str, paths)] + TINY_FLAGS
        runs = {}
        for name in ("port", "root"):
            (tmp_path / name).mkdir()
            monkeypatch.chdir(tmp_path / name)
            if name == "port":
                port_test_cli.main(argv + ["--device", "cpu"])
            else:
                _load_script(REPO / "test.py", "jax_test_cli").main(argv + ["--platform", "cpu"])
            runs[name] = sorted(p.relative_to(tmp_path / name) for p in (tmp_path / name).rglob("*") if p.is_file())
        assert runs["port"] == runs["root"] == [Path("test_figure/test_clip_frame_0001.pdf")]
        assert (tmp_path / "port" / runs["port"][0]).read_bytes().startswith(b"%PDF")
        assert port_test_cli.figure_path(str(paths[0])) == "./" + str(runs["root"][0])
        assert re.fullmatch(r"\./test_figure/test_\w+\.pdf", port_test_cli.figure_path("a/b.png"))
