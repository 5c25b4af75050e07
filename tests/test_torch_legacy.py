"""The port's legacy PWCNet and its parts against the JAX package, and
``make_forward``.

Variables are one numpy tree in the JAX package's layout (its structure from
``jax.eval_shape`` of the JAX model's init, its values drawn here: fan-in
scaled kernels, small biases, BatchNorm scales near 1 and running statistics
away from their init), handed to the JAX model as they are and to the port
through ``weights.from_jax_variables``. All float32 on the CPU; the JAX
PWCNet runs its plain XLA warp and cost volume, the port the plain versions
(the K2 wrapper's CPU route).

Tolerances are tests/test_torch_model.py's: per-level flows and features
rtol 1e-4, atol 1e-5; the full-resolution flow rtol 1e-4, atol 1e-4;
parameter gradients within 1e-4 of each tensor's largest entry; running
statistics rtol 1e-5, atol 1e-6 (one update of values the forward agrees
on to 1e-6).

Two numerical facts shape the cases, both measured here on the port alone:

- In train mode BatchNorm divides by the batch's standard deviation, taken
  as E[x^2] - E[x]^2 in float32 (flax's fast variance): a channel whose
  spread is small against its mean, or against sqrt(eps), turns the two
  frameworks' last-bit differences in the conv sums into 1e-5 .. 1e-4 of
  the flow at the 4-level size (8 samples a statistic at the deepest
  level). The whole model in train mode is therefore held at 1e-4 of each
  output's largest entry, the bound of the card's float32 flow gates, and
  not at 6 levels and 64x64: there the deepest level is 1x1, a statistic is
  over the batch of 2 alone, and a channel whose two values lie within
  sqrt(eps) moves the flow by percent. The estimator alone (8x12, 192
  samples) holds the usual tolerances, gradients included; the gradients
  of the conv biases in front of a train-mode BatchNorm are zero in exact
  arithmetic (the batch mean removes them), so those are held to rounding
  level instead.
- The gradient of the 6-level model is not continuous everywhere: from
  weight seeds 12 and 32 it moves by 1.2-1.5% of a tensor's largest entry
  when the port's own weights move by 1e-7 of themselves (a preactivation
  within rounding of zero takes the other LeakyReLU slope; ROADMAP Queue 3
  records the same for PWCDCNet), and the JAX gradient differs by as much.
  The 6-level gradient is compared from seed 22, where both agree to 4e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.models.estimator import FlowEstimatorLegacy as JaxFlowEstimatorLegacy
from pwcnet_tpu.models.pyramid import FeaturePyramidExtractorLegacy as JaxPyramidLegacy
from pwcnet_tpu.train_lib.step import make_forward as jax_make_forward
from pwcnet_tpu_torch.models import FeaturePyramidExtractorLegacy, FlowEstimatorLegacy, PWCDCNet, PWCNet
from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
from pwcnet_tpu_torch.train_lib import make_forward
from pwcnet_tpu_torch.weights import from_jax_params, from_jax_variables, to_jax_params, to_jax_variables

torch.set_num_threads(1)

# (name, config, frame size): 6 levels at 64x64, 4 levels with output level 2 at 32x32
SIZES = [("6lv64", dict(num_levels=6), 64), ("4lv32", dict(num_levels=4, output_level=2), 32)]
BATCH = 2


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(9.0 * s.shape[2])).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "mean":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "var":
            return (1.0 + 0.5 * rng.random(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _variables(model, seed, *inputs):
    """The JAX module's variables shaped by its init on ``inputs``, filled from numpy."""
    return _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs), seed)


def _frames(seed, hw, b=BATCH):
    rng = np.random.default_rng(seed)
    return tuple(rng.random((b, hw, hw, 3)).astype(np.float32) for _ in range(2))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=1e-5, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), rtol=1e-4, atol=atol, err_msg=what)


def _compare_outputs(jax_out, torch_out):
    (jf, jflows, jpyr), (tf, tflows, tpyr) = jax_out, torch_out
    assert len(jflows) == len(tflows) and len(jpyr) == len(tpyr)
    for l, (a, b) in enumerate(zip(jflows, tflows)):
        _close(b, a, what=f"flow level {l}")
    for l, (a, b) in enumerate(zip(jpyr, tpyr)):
        _close(b, a, what=f"pyramid level {l}")
    _close(tf, jf, atol=1e-4, what="final flow")


def _pair(cfg, hw, seed, **kw):
    """The JAX PWCNet with its variables, and the port's on the same ones."""
    jm = JaxPWCNet(**cfg, **kw)
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    variables = _variables(jm, seed, x, x)
    pm = PWCNet(**cfg, **kw)
    pm.load_state_dict(from_jax_variables(variables))
    return jm, variables, pm


def _apply(jm, variables, x0, x1, train):
    if train:
        return jm.apply(variables, x0, x1, train=True, mutable=["batch_stats"])
    return jm.apply(variables, x0, x1), None


class TestParts:
    def test_pyramid_extractor(self):
        jm = JaxPyramidLegacy(num_levels=6)
        (x, _) = _frames(1, 64)
        params = _variables(jm, 2, jnp.zeros((1, 64, 64, 3)))
        pm = FeaturePyramidExtractorLegacy(6)
        assert [k for k in pm.state_dict()][-2:] == ["conv2d_11.weight", "conv2d_11.bias"]
        pm.load_state_dict(from_jax_params(params["params"]))
        want = jm.apply(params, x)
        got = pm(_t(x).permute(0, 3, 1, 2))
        assert [tuple(g.shape) for g in got] == [(BATCH, a.shape[3], a.shape[1], a.shape[2]) for a in want]
        for l, (a, b) in enumerate(zip(want, got)):
            _close(b.permute(0, 2, 3, 1), a, what=f"level {l}")

    @pytest.mark.parametrize("batch_norm,train", [(False, False), (False, True), (True, False), (True, True)],
                             ids=["plain", "plain-train", "bn-eval", "bn-train"])
    def test_flow_estimator(self, batch_norm, train):
        rng = np.random.default_rng(3)
        cost, x, flow = (rng.standard_normal((BATCH, 8, 12, c)).astype(np.float32) for c in (81, 32, 2))
        jm = JaxFlowEstimatorLegacy(batch_norm=batch_norm)
        variables = _variables(jm, 4, cost, x, flow)
        pm = FlowEstimatorLegacy(81 + 32 + 2, batch_norm=batch_norm)
        pm.load_state_dict(from_jax_variables(variables))
        (jfeat, jflow), updates = (jm.apply(variables, cost, x, flow, train=True, mutable=["batch_stats"])
                                   if train and batch_norm else (jm.apply(variables, cost, x, flow, train=train), None))
        nchw = [_t(a).permute(0, 3, 1, 2) for a in (cost, x, flow)]
        feat, fl = pm(*nchw, train=train)
        _close(feat.permute(0, 2, 3, 1), jfeat, what="features")
        _close(fl.permute(0, 2, 3, 1), jflow, what="flow")
        if updates is not None:
            self._stats_equal(pm, updates["batch_stats"])

    def test_flow_estimator_gradients_with_batch_norm_in_train_mode(self):
        rng = np.random.default_rng(5)
        cost, x, flow = (rng.standard_normal((BATCH, 8, 12, c)).astype(np.float32) for c in (81, 32, 2))
        cots = [rng.standard_normal((BATCH, 8, 12, c)).astype(np.float32) for c in (32, 2)]
        jm = JaxFlowEstimatorLegacy(batch_norm=True)
        variables = _variables(jm, 6, cost, x, flow)
        pm = FlowEstimatorLegacy(81 + 32 + 2, batch_norm=True)
        pm.load_state_dict(from_jax_variables(variables))

        def jax_loss(params):
            (feat, fl), _ = jm.apply({**variables, "params": params}, cost, x, flow, train=True,
                                     mutable=["batch_stats"])
            return (feat * cots[0]).sum() + (fl * cots[1]).sum()

        want = jax.grad(jax_loss)(variables["params"])
        feat, fl = pm(*[_t(a).permute(0, 3, 1, 2) for a in (cost, x, flow)], train=True)
        total = sum((o.permute(0, 2, 3, 1) * _t(c)).sum() for o, c in zip((feat, fl), cots))
        # the five hidden convs' biases feed a train-mode BatchNorm
        _assert_gradients(pm, total, want, zero={f"['{n}']['bias']" for n in
                                                 ["conv2d"] + [f"conv2d_{i}" for i in range(1, 5)]})

    @staticmethod
    def _stats_equal(pm, batch_stats):
        got = to_jax_variables(pm.state_dict())["batch_stats"]
        flat_w = jax.tree_util.tree_flatten_with_path(batch_stats)[0]
        flat_g = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for p, v in flat_w:
            np.testing.assert_allclose(flat_g[jax.tree_util.keystr(p)], np.asarray(v), rtol=1e-5, atol=1e-6,
                                       err_msg=jax.tree_util.keystr(p))

    def test_running_statistics_after_a_train_call_match_flax(self):
        """PWCNet 'all' with BN, 4 levels: every bn_i's mean and var after
        one train=True call against flax's mutable=["batch_stats"] result
        (flax keeps the biased variance; BatchNorm2d would not)."""
        cfg, hw = SIZES[1][1], SIZES[1][2]
        jm, variables, pm = _pair(cfg, hw, 5, context="all", batch_norm=True)
        x0, x1 = _frames(6, hw)
        _, updates = _apply(jm, variables, x0, x1, True)
        pm(_t(x0), _t(x1), train=True)
        self._stats_equal(pm, updates["batch_stats"])
        assert not np.allclose(np.asarray(updates["batch_stats"]["optflow_0"]["bn_0"]["var"]),
                               np.asarray(variables["batch_stats"]["optflow_0"]["bn_0"]["var"]))


def _assert_gradients(pm, total, want, zero=()):
    """Every parameter gradient of ``total`` within 1e-4 of the largest
    entry of JAX's; the tensors in ``zero`` (zero in exact arithmetic)
    within 1e-6 of the largest entry of all the gradients, on both sides."""
    params = dict(pm.named_parameters())
    got = to_jax_params(dict(zip(params, torch.autograd.grad(total, list(params.values())))))
    flat_w = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_w.keys() == flat_g.keys()
    top = max(np.abs(w).max() for w in flat_w.values())
    for k, w in flat_w.items():
        g = flat_g[k]
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top, k
        else:
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k


def _within_scale(got, want, what):
    """max |got - want| <= 1e-4 max |want|."""
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-4 * np.abs(want).max(), what


class TestPWCNet:
    @pytest.mark.parametrize("size", SIZES, ids=[s[0] for s in SIZES])
    @pytest.mark.parametrize("context", ["final", "all"])
    @pytest.mark.parametrize("warp_type", ["bilinear", "nearest"])
    def test_forward(self, size, context, warp_type):
        _, cfg, hw = size
        jm, variables, pm = _pair(cfg, hw, 7, context=context, warp_type=warp_type)
        x0, x1 = _frames(8, hw)
        out = pm(_t(x0), _t(x1))
        assert out[0].shape == (BATCH, hw, hw, 2) and len(out[1]) == cfg.get("output_level", 4) + 1
        _compare_outputs(jm.apply(variables, x0, x1), out)

    @pytest.mark.parametrize("size", SIZES, ids=[s[0] for s in SIZES])
    @pytest.mark.parametrize("context", ["final", "all"])
    def test_forward_with_batch_norm(self, size, context):
        _, cfg, hw = size
        jm, variables, pm = _pair(cfg, hw, 9, context=context, batch_norm=True)
        x0, x1 = _frames(10, hw)
        _compare_outputs(jm.apply(variables, x0, x1), pm(_t(x0), _t(x1)))

    @pytest.mark.parametrize("context", ["final", "all"])
    def test_forward_with_batch_norm_in_train_mode(self, context):
        """At 4 levels, each output within 1e-4 of its largest entry (see
        the module docstring); the running statistics move alike."""
        _, cfg, hw = SIZES[1]
        jm, variables, pm = _pair(cfg, hw, 9, context=context, batch_norm=True)
        x0, x1 = _frames(10, hw)
        (jf, jflows, jpyr), updates = _apply(jm, variables, x0, x1, True)
        tf, tflows, tpyr = pm(_t(x0), _t(x1), train=True)
        for l, (a, b) in enumerate(zip(jflows, tflows)):
            _within_scale(b, a, f"flow level {l}")
        for l, (a, b) in enumerate(zip(jpyr, tpyr)):
            _close(b, a, what=f"pyramid level {l}")
        _within_scale(tf, jf, "final flow")
        TestParts._stats_equal(pm, updates["batch_stats"])

    def test_parameters_exist_to_the_output_level(self):
        """As flax creates them lazily: 4 levels, output level 2, 'all', BN."""
        _, variables, pm = _pair(dict(num_levels=4, output_level=2), 32, 11, context="all", batch_norm=True)
        assert sorted(variables["params"]) == ["context_0", "context_1", "context_2", "fp_extractor",
                                               "optflow_0", "optflow_1", "optflow_2"]
        assert sorted(variables["params"]["optflow_1"]) == sorted(
            [f"bn_{i}" for i in range(5)] + ["conv2d"] + [f"conv2d_{i}" for i in range(1, 6)])
        sd = pm.state_dict()
        assert sorted({k.split(".")[0] for k in sd}) == sorted(variables["params"])
        assert len(sd) == sum(x.size > 0 for x in jax.tree_util.tree_leaves(variables))

    @pytest.mark.parametrize("case", ["final-6lv64", "final-4lv32", "all-bn-4lv32"])
    def test_parameter_gradients(self, case):
        """Every parameter's gradient of one seeded scalar of all the flows
        against jax.grad, within 1e-4 of each tensor's largest entry (6
        levels from weight seed 22, see the module docstring)."""
        context, *rest = case.split("-")
        six = case.endswith("6lv64")
        _, cfg, hw = SIZES[0] if six else SIZES[1]
        jm, variables, pm = _pair(cfg, hw, 22 if six else 12, context=context, batch_norm="bn" in rest)
        x0, x1 = _frames(13, hw)
        f, flows, _ = jm.apply(variables, x0, x1)
        rng = np.random.default_rng(14)
        cots = [rng.standard_normal(a.shape).astype(np.float32) for a in [f, *flows]]

        def jax_loss(params):
            jf, jflows, _ = jm.apply({**variables, "params": params}, x0, x1)
            return sum((o * c).sum() for o, c in zip([jf, *jflows], cots))

        want = jax.jit(jax.grad(jax_loss))(variables["params"])
        tf, tflows, _ = pm(_t(x0), _t(x1))
        _assert_gradients(pm, sum((o * _t(c)).sum() for o, c in zip([tf, *tflows], cots)), want)

    def test_the_default_call_leaves_the_statistics_untouched(self):
        """train=False by default, as in JAX: a module in training mode (as
        every fresh nn.Module is) must not update its running statistics."""
        _, variables, pm = _pair(dict(num_levels=4, output_level=2), 32, 15, context="all", batch_norm=True)
        assert pm.training
        before = {k: v.clone() for k, v in pm.state_dict().items()}
        x0, x1 = _frames(16, 32)
        pm(_t(x0), _t(x1))
        for k, v in pm.state_dict().items():
            assert torch.equal(v, before[k]), k
        pm(_t(x0), _t(x1), train=True)
        assert not torch.equal(pm.state_dict()["optflow_0.bn_0.mean"], before["optflow_0.bn_0.mean"])

    def test_the_k2_wrapper_default_equals_the_plain_hook_on_the_cpu(self):
        default = PWCNet(num_levels=4, output_level=2)
        assert default.cost_volume_fn is cost_volume_cuda
        plain = PWCNet(num_levels=4, output_level=2, cost_volume_fn=cost_volume)
        plain.load_state_dict(default.state_dict())
        x0, x1 = _frames(17, 32)
        for a, b in zip(jax.tree_util.tree_leaves(default(_t(x0), _t(x1))),
                        jax.tree_util.tree_leaves(plain(_t(x0), _t(x1)))):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("kwargs,match", [
        (dict(num_levels=4, output_level=4), "output_level"),
        (dict(context="some"), "all/final"),
        (dict(warp_type="bicubic"), "warp_type"),
    ])
    def test_bad_arguments_raise(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            PWCNet(**kwargs)

    def test_bf16_compute_keeps_float32_parameters(self):
        pm = PWCNet(num_levels=4, output_level=2, context="all", batch_norm=True, compute_dtype=torch.bfloat16)
        x0, x1 = _frames(18, 32)
        f, flows, pyr = pm(_t(x0), _t(x1), train=True)
        assert f.dtype == torch.bfloat16 and pyr[0].dtype == torch.bfloat16 and torch.isfinite(f.float()).all()
        assert all(p.dtype == torch.float32 for p in pm.parameters())
        assert all(b.dtype == torch.float32 for b in pm.buffers())


class TestMakeForward:
    @pytest.mark.parametrize("legacy", [False, True], ids=["PWCDCNet", "PWCNet"])
    def test_against_the_jax_make_forward(self, legacy):
        cfg = dict(num_levels=4, output_level=2, search_range=2)
        jm = JaxPWCNet(**cfg) if legacy else JaxPWCDCNet(**cfg)
        x = jnp.zeros((1, 32, 32, 3), jnp.float32)
        params = _variables(jm, 19, x, x)["params"]
        pm = PWCNet(**cfg) if legacy else PWCDCNet(**cfg)
        pm.load_state_dict(from_jax_params(params))
        x0, x1 = _frames(20, 32)
        want = jax_make_forward(jm)(params, x0, x1)
        got = make_forward(pm.eval(), with_pyramid=False)(_t(x0), _t(x1))
        assert len(got) == len(want) == (3 if legacy else 2)
        assert got[0].is_inference()
        if legacy:
            _compare_outputs(want, got)
        else:
            for l, (a, b) in enumerate(zip(want[1], got[1])):
                _close(b, a, what=f"level {l}")
            _close(got[0], want[0], atol=1e-4, what="final flow")


class TestWeights:
    def test_round_trip_of_a_legacy_tree_with_batch_stats_is_bit_exact(self):
        jm = JaxPWCNet(num_levels=4, output_level=2, context="all", batch_norm=True)
        x = jnp.zeros((1, 32, 32, 3), jnp.float32)
        variables = _variables(jm, 21, x, x)
        state = from_jax_variables(variables)
        pm = PWCNet(num_levels=4, output_level=2, context="all", batch_norm=True)
        assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in pm.state_dict().items()}
        pm.load_state_dict(state)
        back = to_jax_variables(pm.state_dict())
        flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b), path
        with pytest.raises(KeyError, match="to_jax_variables"):
            to_jax_params(pm.state_dict())
