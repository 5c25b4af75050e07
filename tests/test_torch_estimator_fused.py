"""K7's plain version (pwcnet_tpu_torch.ops.estimator_conv) and the model's
``fused_estimator_levels`` switch against the JAX package.

The same numpy-seeded input and the same twelve kernels and biases go
through the JAX kernel ``estimator_chain_fused(..., interpret=True)``, its
XLA reference ``_xla_chain`` and the port's plain chain (HWIO kernels
transposed to OIHW), forward and gradient, on the CPU. On the CPU the
port's wrapper ``ops.cuda.estimator_conv.estimator_chain_fused`` must hand
over to that plain chain and launch nothing; the kernel-vs-plain tests on
the card are in tests/test_torch_kernels.py (``cuda`` marker).

Tolerances.

- float32 forward: rtol=1e-5, atol=1e-5, what tests/test_estimator_fused.py
  holds the JAX kernel to against XLA: the three differ only in summation
  order, at O(1) activations.
- float32 gradients: rtol=1e-4, atol=1e-4, that file's gradient tolerance
  (sums over every pixel of six stacked convs).
- bfloat16 forward: rtol=3e-2, atol=3e-2, that file's bf16 tolerance: every
  stage reads an activation rounded to 8 bits, at an O(1) scale 3e-2 is
  four ulps.
- the whole model: rtol=1e-4, atol=1e-4 as tests/test_torch_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.ops.pallas.estimator_conv import _xla_chain, estimator_chain_fused as jax_chain_fused
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_bwd, estimator_chain_fused
from pwcnet_tpu_torch.ops.estimator_conv import (
    chain_weight_grads,
    estimator_chain_bwd_plain,
    estimator_chain_plain,
)
from pwcnet_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

FILTERS = (16, 16, 8, 8, 8, 2)
# the shapes of tests/test_estimator_fused.py and a non-square one with odd sizes
SHAPES = [(1, 8, 8, 12), (2, 12, 16, 25), (1, 6, 7, 11)]
TINY = dict(num_levels=3, output_level=1, search_range=2)


def _chain_params(rng, cin, filters=FILTERS):
    """HWIO kernels scaled by fan-in (activations stay O(1)) and biases."""
    kbs = []
    for f in filters:
        kbs.append((rng.standard_normal((3, 3, cin, f)) / np.sqrt(9.0 * cin)).astype(np.float32))
        kbs.append((rng.standard_normal((f,)) * 0.1).astype(np.float32))
        cin = f
    return kbs


def _to_torch(kbs, dtype=torch.float32):
    return [
        torch.from_numpy(np.ascontiguousarray(p.transpose(3, 2, 0, 1) if p.ndim == 4 else p)).to(dtype)
        for p in kbs
    ]


def _case(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    kbs = _chain_params(rng, shape[-1])
    g_flow = rng.standard_normal(shape[:3] + (FILTERS[-1],)).astype(np.float32)
    g_feat = rng.standard_normal(shape[:3] + (FILTERS[-2],)).astype(np.float32)
    return x, kbs, g_flow, g_feat


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def jax_case(request):
    """One shape's inputs with the JAX results, each JAX function built once:
    forward and gradients of the interpret-mode kernel and of the XLA chain."""
    shape = request.param
    x, kbs, g_flow, g_feat = _case(3, shape)
    jx, jk = jnp.asarray(x), [jnp.asarray(p) for p in kbs]
    gf, gt = jnp.asarray(g_flow), jnp.asarray(g_feat)

    def loss(fn):
        def f(x, *p):
            flow, feat = fn(x, *p)
            return jnp.sum(flow * gf) + jnp.sum(feat * gt)

        return f

    argnums = tuple(range(1 + len(kbs)))
    out = {"inputs": (x, kbs, g_flow, g_feat)}
    for name, fn in (("pallas", lambda x, *p: jax_chain_fused(x, *p, interpret=True)), ("xla", _xla_chain)):
        out[name] = [np.asarray(a) for a in fn(jx, *jk)]
        out[name + "_grads"] = [np.asarray(a) for a in jax.grad(loss(fn), argnums=argnums)(jx, *jk)]
    return out


def _hwio(t):
    """A port gradient in the JAX layout."""
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 and a.shape[-1] == 3 and a.shape[-2] == 3 else a


class TestPlainChainAgainstJax:
    @pytest.mark.parametrize("ref", ["pallas", "xla"])
    def test_forward_float32(self, jax_case, ref):
        x, kbs, _, _ = jax_case["inputs"]
        flow, feat = estimator_chain_plain(torch.from_numpy(x), *_to_torch(kbs))
        want_flow, want_feat = jax_case[ref]
        assert flow.shape == want_flow.shape and feat.shape == want_feat.shape
        np.testing.assert_allclose(flow.numpy(), want_flow, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(feat.numpy(), want_feat, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("ref", ["pallas", "xla"])
    def test_gradients_float32(self, jax_case, ref):
        """dxin and all twelve kernels and biases, both cotangents."""
        x, kbs, g_flow, g_feat = jax_case["inputs"]
        tx = torch.from_numpy(x).requires_grad_()
        tk = [p.requires_grad_() for p in _to_torch(kbs)]
        flow, feat = estimator_chain_plain(tx, *tk)
        got = torch.autograd.grad([flow, feat], [tx, *tk], [torch.from_numpy(g_flow), torch.from_numpy(g_feat)])
        want = jax_case[ref + "_grads"]
        assert len(got) == len(want) == 13
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(_hwio(a), b, rtol=1e-4, atol=1e-4, err_msg=f"gradient {i}")

    def test_written_out_backward_is_the_autograd_backward(self, jax_case):
        """estimator_chain_bwd_plain + chain_weight_grads (what K7's backward
        kernel is held against) equal jax.grad of the kernel."""
        x, kbs, g_flow, g_feat = jax_case["inputs"]
        tx, tk = torch.from_numpy(x), _to_torch(kbs)
        gf, gt = torch.from_numpy(g_flow), torch.from_numpy(g_feat)
        _, feat, acts = estimator_chain_plain(tx, *tk, return_acts=True)
        saved = [*acts, feat]
        gzs, dxin = estimator_chain_bwd_plain(tk[0::2], saved, gf, gt)
        grads = [dxin] + chain_weight_grads(tx, saved, gzs, gf, [k.shape for k in tk[0::2]])
        for i, (a, b) in enumerate(zip(grads, jax_case["pallas_grads"])):
            np.testing.assert_allclose(_hwio(a), b, rtol=1e-4, atol=1e-4, err_msg=f"gradient {i}")
        assert estimator_chain_bwd_plain(tk[0::2], saved, gf, gt, need_dx=False)[1] is None

    def test_forward_bfloat16(self):
        x, kbs, _, _ = _case(5, (1, 8, 8, 12))
        jx = jnp.asarray(x, jnp.bfloat16)
        jk = [jnp.asarray(p, jnp.bfloat16) for p in kbs]
        want_flow, want_feat = jax_chain_fused(jx, *jk, interpret=True)
        flow, feat = estimator_chain_plain(torch.from_numpy(x).bfloat16(), *_to_torch(kbs, torch.bfloat16))
        assert flow.dtype == feat.dtype == torch.bfloat16
        np.testing.assert_allclose(flow.float().numpy(), np.asarray(want_flow, np.float32), rtol=3e-2, atol=3e-2)
        np.testing.assert_allclose(feat.float().numpy(), np.asarray(want_feat, np.float32), rtol=3e-2, atol=3e-2)


class TestWrapperOnCpu:
    def test_cpu_tensors_go_to_the_plain_chain_and_launch_nothing(self):
        x, kbs, g_flow, g_feat = _case(7, (1, 6, 7, 11))
        tx = torch.from_numpy(x).requires_grad_()
        tk = [p.requires_grad_() for p in _to_torch(kbs)]
        reset_launch_counts()
        flow, feat = estimator_chain_fused(tx, *tk)
        want_flow, want_feat, acts = estimator_chain_plain(tx, *tk, return_acts=True)
        assert torch.equal(flow, want_flow) and torch.equal(feat, want_feat)
        gs = [torch.from_numpy(g_flow), torch.from_numpy(g_feat)]
        got = torch.autograd.grad([flow, feat], [tx, *tk], gs)
        want = torch.autograd.grad([want_flow, want_feat], [tx, *tk], gs)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        with torch.no_grad():
            saved = [a.detach() for a in (*acts, want_feat)]
            ks = [k.detach() for k in tk[0::2]]
            gzs, dxin = estimator_chain_bwd(ks, saved, *gs)
        np.testing.assert_allclose(dxin.numpy(), got[0].numpy(), rtol=1e-5, atol=1e-6)
        assert len(gzs) == 5 and not any(launch_counts().values())

    def test_wrong_number_of_kernels_raises(self):
        x, kbs, _, _ = _case(7, (1, 6, 7, 11))
        with pytest.raises(ValueError, match="12 kernels and biases"):
            estimator_chain_fused(torch.from_numpy(x), *_to_torch(kbs)[:-2])


class TestModelFusedEstimator:
    @pytest.fixture(scope="class")
    def tree_and_frames(self):
        model = JaxPWCDCNet(**TINY)
        x = jnp.zeros((1, 16, 16, 3), jnp.float32)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
        rng = np.random.default_rng(11)

        def fill(s):
            if len(s.shape) == 4:
                return (rng.standard_normal(s.shape) / np.sqrt(9.0 * s.shape[2])).astype(np.float32)
            return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

        tree = jax.tree_util.tree_map(fill, shapes)
        frames = rng.random((2, 1, 16, 16, 3)).astype(np.float32)
        return tree, frames

    def test_state_dict_keys_unchanged(self):
        base, fused = PWCDCNet(**TINY), PWCDCNet(fused_estimator_levels=2, **TINY)
        assert list(base.state_dict()) == list(fused.state_dict())
        assert {k: v.shape for k, v in base.state_dict().items()} == {
            k: v.shape for k, v in fused.state_dict().items()
        }
        # the JAX rule l > output_level - N: both of the tiny model's estimators
        assert [getattr(fused, f"optflow_{l}").fused for l in range(2)] == [True, True]
        one = PWCDCNet(fused_estimator_levels=1, **TINY)
        assert [getattr(one, f"optflow_{l}").fused for l in range(2)] == [False, True]
        assert not PWCDCNet(fused_estimator_levels=2, use_dc=True, **TINY).optflow_1.fused

    def test_matches_the_jax_model_with_the_same_setting_and_the_default_port(self, tree_and_frames):
        tree, (x0, x1) = tree_and_frames
        jax_model = JaxPWCDCNet(fused_estimator_levels=2, **TINY)
        # off the TPU the JAX kernel runs in interpret mode by itself
        jf, jp = jax_model.apply({"params": tree}, jnp.asarray(x0), jnp.asarray(x1))
        outs = {}
        for n in (0, 2):
            model = PWCDCNet(fused_estimator_levels=n, **TINY)
            model.load_state_dict(from_jax_params(tree))
            with torch.no_grad():
                outs[n] = model.eval()(torch.from_numpy(x0), torch.from_numpy(x1))
        for n, (tf, tp) in outs.items():
            np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4, err_msg=f"N={n}")
            for l, (a, b) in enumerate(zip(tp, jp)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=f"N={n} level {l}")
        np.testing.assert_allclose(outs[2][0].numpy(), outs[0][0].numpy(), rtol=1e-5, atol=1e-5)

    def test_predictor_takes_fused_estimator(self):
        from pwcnet_tpu_torch.inference import FlowPredictor

        off = FlowPredictor(device="cpu", use_kernels=True, **TINY)
        on = FlowPredictor(device="cpu", use_kernels=True, fused_estimator=1, **TINY)
        assert not off.model.optflow_1.fused and on.model.optflow_1.fused and not on.model.optflow_0.fused
        assert list(off.model.state_dict()) == list(on.model.state_dict())
