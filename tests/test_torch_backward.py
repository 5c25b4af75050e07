"""The port's gradients against the JAX package: the plain ops under
autograd, and the plain versions of the backward kernels K4, K5 and K6.

Inputs come from a numpy seed and go through the JAX function and its
counterpart. On the JAX side the backward kernels run as the JAX package's
own tests run them on the CPU: ``_cv_bwd``, ``warp_bwd_pallas`` and the
VJP of ``pyramid_level_fused`` in interpret mode.

Tolerances. All float32 on the CPU; the two sides differ only in
summation order over at most a few hundred terms of O(1): rtol=1e-5 and
atol=1e-5. bfloat16 cases compare results that were rounded to bf16 from
float32 sums taken in a different order, so they may land one bf16 ulp
apart: 2**-7 of the result's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.ops.cost_volume import cost_volume as jax_cost_volume
from pwcnet_tpu.ops.pallas.cost_volume import _cv_bwd
from pwcnet_tpu.ops.pallas.pyramid_conv import _xla_level
from pwcnet_tpu.ops.pallas.pyramid_conv import pyramid_level_fused as jax_pyramid_level_fused
from pwcnet_tpu.ops.pallas.warped_cv import warp_bwd_pallas
from pwcnet_tpu.ops.warp import _bilinear_warp_bwd
from pwcnet_tpu.ops.warp import bilinear_warp as jax_bilinear_warp
from pwcnet_tpu_torch.ops.activation import leaky_mask, leaky_relu
from pwcnet_tpu_torch.ops.cost_volume import cost_volume, cost_volume_bwd_plain
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import (
    _weight_grads,
    pyramid_level_bwd_plain,
    pyramid_level_plain,
)
from pwcnet_tpu_torch.ops.warp import bilinear_warp, warp_bwd_plain

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


def _bf16_close(got, want):
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert np.abs(got - want).max() <= np.abs(want).max() / 128.0


# flows for the warp: sub-pixel, a few pixels, far out of the frame, and
# exactly-integer ones whose corners clamp and fold onto the border
def _flow_cases(rng, shape):
    b, h, w = shape
    cases = {f"scale{s}": _normal(rng, (b, h, w, 2), s) for s in (0.4, 3.0, 50.0)}
    cases["integer"] = np.tile(np.array([2.0, -3.0], np.float32), (b, h, w, 1))
    cases["integer_out"] = np.tile(np.array([-float(w), float(h)], np.float32), (b, h, w, 1))
    return cases


FLOW_IDS = ["scale0.4", "scale3.0", "scale50.0", "integer", "integer_out"]


class TestLeakyRelu:
    def test_gradient_at_zero_is_one_as_in_jax(self):
        x = np.array([-2.0, -0.0, 0.0, 1e-30, 3.0], np.float32)
        t = _t(x).requires_grad_()
        (got,) = torch.autograd.grad(leaky_relu(t, 0.1).sum(), t)
        want = jax.grad(lambda v: jnp.sum(jax.nn.leaky_relu(v, 0.1)))(jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.tolist() == pytest.approx([0.1, 1.0, 1.0, 1.0, 1.0])
        # PyTorch's own differs exactly there
        t2 = _t(x).requires_grad_()
        (theirs,) = torch.autograd.grad(torch.nn.functional.leaky_relu(t2, 0.1).sum(), t2)
        assert theirs[2].item() == pytest.approx(0.1)

    def test_forward_is_unchanged_and_mask_reads_the_output(self, rng):
        x = _t(_normal(rng, (64,)))
        y = leaky_relu(x.clone().requires_grad_(), 0.1)
        assert torch.equal(y.detach(), torch.nn.functional.leaky_relu(x, 0.1))
        assert torch.equal(leaky_mask(y.detach()), leaky_mask(x))
        assert leaky_mask(torch.zeros(1)).item() == 1.0


class TestPlainOpsUnderAutograd:
    """torch.autograd through the plain ops against jax.vjp of the JAX ops."""

    @pytest.mark.parametrize("shape,d", [((2, 6, 7, 5), 2), ((1, 9, 8, 3), 4)])
    def test_cost_volume(self, rng, shape, d):
        f0, f1 = _normal(rng, shape), _normal(rng, shape)
        g = _normal(rng, shape[:3] + ((2 * d + 1) ** 2,))
        a, b = _t(f0).requires_grad_(), _t(f1).requires_grad_()
        got = torch.autograd.grad(cost_volume(a, b, d), (a, b), _t(g))
        _, vjp = jax.vjp(lambda p, q: jax_cost_volume(p, q, search_range=d), jnp.asarray(f0), jnp.asarray(f1))
        for x, y in zip(got, vjp(jnp.asarray(g))):
            _close(x, y)

    @pytest.mark.parametrize("case", FLOW_IDS)
    def test_bilinear_warp(self, rng, case):
        shape = (2, 7, 9, 5)
        x, g = _normal(rng, shape), _normal(rng, shape)
        flow = _flow_cases(rng, shape[:3])[case]
        a, f = _t(x).requires_grad_(), _t(flow).requires_grad_()
        got = torch.autograd.grad(bilinear_warp(a, f), (a, f), _t(g))
        _, vjp = jax.vjp(jax_bilinear_warp, jnp.asarray(x), jnp.asarray(flow))
        want = vjp(jnp.asarray(g))
        _close(got[0], want[0])
        _close(got[1], want[1], rtol=1e-5, atol=1e-4)  # sums g * corner differences over C

    @pytest.mark.parametrize("shape,c", [((1, 8, 12, 3), 16), ((2, 8, 8, 16), 32), ((1, 6, 10, 4), 8)])
    def test_pyramid_level(self, rng, shape, c):
        x, params = _normal(rng, shape), _level_params(rng, shape[-1], c)
        g = _normal(rng, (shape[0], shape[1] // 2, shape[2] // 2, c))
        leaves = [_t(x).requires_grad_()] + [p.requires_grad_() for p in _oihw(params)]
        got = torch.autograd.grad(pyramid_level_plain(*leaves), leaves, _t(g))
        _, vjp = jax.vjp(_xla_level, jnp.asarray(x), *[jnp.asarray(p) for p in params])
        want = vjp(jnp.asarray(g))
        for a, b in zip(got, want):
            _close(_hwio(a), b)


def _level_params(rng, cin, c):
    """HWIO kernels scaled by fan-in (activations stay O(1)) and biases."""
    out = []
    for ci in (cin, c, c):
        out.append(_normal(rng, (3, 3, ci, c), 1.0 / np.sqrt(9.0 * ci)))
        out.append(_normal(rng, (c,), 0.1))
    return out


def _oihw(params):
    return [_t(p.transpose(3, 2, 0, 1)) if p.ndim == 4 else _t(p) for p in params]


def _hwio(t):
    return t.permute(2, 3, 1, 0) if t.dim() == 4 and t.shape[-1] == 3 and t.shape[-2] == 3 else t


class TestCostVolumeBwdPlain:
    """K4's plain version against the JAX package's ``_cv_bwd`` (interpret mode)."""

    @pytest.mark.parametrize("shape,d", [((1, 8, 8, 4), 2), ((2, 6, 7, 5), 2), ((1, 9, 10, 3), 4)])
    def test_matches_jax_backward(self, rng, shape, d):
        f0, f1 = _normal(rng, shape), _normal(rng, shape)
        out = cost_volume(_t(f0), _t(f1), d)
        g = _normal(rng, tuple(out.shape))
        got = cost_volume_bwd_plain(_t(f0), _t(f1), out, _t(g), d)
        want = _cv_bwd(d, None, True, (jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(out.numpy())), jnp.asarray(g))
        for a, b in zip(got, want):
            _close(a, b)

    def test_equals_autograd_of_the_plain_forward(self, rng):
        f0, f1 = _t(_normal(rng, (2, 6, 7, 5))).requires_grad_(), _t(_normal(rng, (2, 6, 7, 5))).requires_grad_()
        out = cost_volume(f0, f1, 2)
        g = _t(_normal(rng, tuple(out.shape)))
        want = torch.autograd.grad(out, (f0, f1), g)
        got = cost_volume_bwd_plain(f0.detach(), f1.detach(), out.detach(), g, 2)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)

    def test_the_sign_comes_from_the_saved_output(self, rng):
        """``out`` is a residual, not recomputed: flipping its sign changes
        the mask and so the result."""
        f0, f1 = _t(_normal(rng, (1, 5, 5, 3))), _t(_normal(rng, (1, 5, 5, 3)))
        out = cost_volume(f0, f1, 1)
        g = torch.ones_like(out)
        a = cost_volume_bwd_plain(f0, f1, out, g, 1)[0]
        b = cost_volume_bwd_plain(f0, f1, -out, g, 1)[0]
        assert (a - b).abs().max() > 1e-3

    def test_bfloat16_matches_jax_backward(self, rng):
        shape, d = (1, 8, 8, 8), 2
        f0 = jnp.asarray(_normal(rng, shape), jnp.bfloat16)
        f1 = jnp.asarray(_normal(rng, shape), jnp.bfloat16)
        tf0 = _t(np.asarray(f0.astype(jnp.float32))).bfloat16()
        tf1 = _t(np.asarray(f1.astype(jnp.float32))).bfloat16()
        out = cost_volume(tf0, tf1, d)
        g = _t(_normal(rng, tuple(out.shape))).bfloat16()
        got = cost_volume_bwd_plain(tf0, tf1, out, g, d)
        want = _cv_bwd(d, None, True, (f0, f1, jnp.asarray(out.float().numpy(), jnp.bfloat16)),
                       jnp.asarray(g.float().numpy(), jnp.bfloat16))
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            _bf16_close(a, b)


class TestWarpBwdPlain:
    """K5's plain version against ``warp_bwd_pallas`` (interpret mode) and
    the row-scatter VJP it replaces."""

    @pytest.mark.parametrize("case", FLOW_IDS)
    def test_matches_jax_backward(self, rng, case):
        shape = (2, 10, 12, 5)
        f1, g = _normal(rng, shape), _normal(rng, shape)
        flow = _flow_cases(rng, shape[:3])[case]
        got = warp_bwd_plain(_t(f1), _t(flow), _t(g))
        kernel = warp_bwd_pallas(jnp.asarray(f1), jnp.asarray(flow), jnp.asarray(g), interpret=True)
        assert kernel is not None
        xla = _bilinear_warp_bwd((jnp.asarray(f1), jnp.asarray(flow)), jnp.asarray(g))
        for want in (kernel, xla):
            _close(got[0], want[0])
            _close(got[1], want[1], rtol=1e-5, atol=1e-4)

    def test_clamped_corners_fold_onto_the_border(self):
        """A flow far to the left sends every corner to column 0: all of
        ``g`` lands there, and ``dflow`` is zero (the corners coincide)."""
        f1 = torch.arange(24.0).reshape(1, 3, 4, 2)
        flow = torch.tensor([-9.5, 0.0]).expand(1, 3, 4, 2).contiguous()
        g = torch.ones_like(f1)
        df1, dflow = warp_bwd_plain(f1, flow, g)
        assert torch.equal(df1[:, :, 0], torch.full((1, 3, 2), 4.0)) and not df1[:, :, 1:].any()
        assert not dflow[..., 0].any()

    def test_bfloat16_rounds_once(self, rng):
        shape = (1, 6, 6, 4)
        f1 = _t(_normal(rng, shape)).bfloat16()
        g = _t(_normal(rng, shape)).bfloat16()
        flow = _t(_normal(rng, shape[:3] + (2,), 2.0)).bfloat16()
        df1, dflow = warp_bwd_plain(f1, flow, g)
        assert df1.dtype == torch.bfloat16 and dflow.dtype == torch.bfloat16
        ref = warp_bwd_plain(f1.float(), flow.float(), g.float())
        assert torch.equal(df1, ref[0].bfloat16()) and torch.equal(dflow, ref[1].bfloat16())


class TestPyramidLevelBwdPlain:
    """K6's plain version (with the weight gradients the wrapper takes
    outside the kernel) against the VJP of the JAX package's fused level in
    interpret mode."""

    @pytest.mark.parametrize("shape,c", [((1, 8, 8, 3), 8), ((2, 16, 24, 3), 16), ((1, 16, 16, 16), 32)])
    def test_matches_jax_backward(self, rng, shape, c):
        x, params = _normal(rng, shape), _level_params(rng, shape[-1], c)
        g = _normal(rng, (shape[0], shape[1] // 2, shape[2] // 2, c))
        k1, b1, k2, b2, k3, b3 = _oihw(params)
        out, s1, s2 = pyramid_level_plain(_t(x), k1, b1, k2, b2, k3, b3, return_acts=True)
        gz1, gz2, gz3, dx = pyramid_level_bwd_plain(_t(x), k1, k2, k3, out, s1, s2, _t(g))
        grads = _weight_grads(_t(x), s1, s2, gz1, gz2, gz3, (k1.shape, k2.shape, k3.shape))
        _, vjp = jax.vjp(lambda *a: jax_pyramid_level_fused(*a, interpret=True),
                         jnp.asarray(x), *[jnp.asarray(p) for p in params])
        want = vjp(jnp.asarray(g))
        _close(dx, want[0])
        for a, b in zip(grads, want[1:]):
            _close(_hwio(a), b, rtol=1e-5, atol=5e-5)  # sums over every position of the level

    def test_cotangents_equal_autograd_of_the_plain_forward(self, rng):
        x = _t(_normal(rng, (2, 8, 12, 3)))
        k1, b1, k2, b2, k3, b3 = _oihw(_level_params(rng, 3, 16))
        leaves = [t.clone().requires_grad_() for t in (x, k1, b1, k2, b2, k3, b3)]
        out, s1, s2 = pyramid_level_plain(*leaves, return_acts=True)
        g = _t(_normal(rng, tuple(out.shape)))
        want = torch.autograd.grad(out, leaves, g)
        gz1, gz2, gz3, dx = pyramid_level_bwd_plain(x, k1, k2, k3, out.detach(), s1.detach(), s2.detach(), g)
        grads = _weight_grads(x, s1.detach(), s2.detach(), gz1, gz2, gz3, (k1.shape, k2.shape, k3.shape))
        for a, b in zip((dx, *grads), want):
            torch.testing.assert_close(a, b, **TOL)

    def test_no_dx_when_not_asked(self, rng):
        x = _t(_normal(rng, (1, 8, 8, 3)))
        k1, b1, k2, b2, k3, b3 = _oihw(_level_params(rng, 3, 16))
        out, s1, s2 = pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts=True)
        g = torch.ones_like(out)
        with_dx = pyramid_level_bwd_plain(x, k1, k2, k3, out, s1, s2, g)
        without = pyramid_level_bwd_plain(x, k1, k2, k3, out, s1, s2, g, need_dx=False)
        assert without[3] is None and with_dx[3].shape == x.shape
        assert all(torch.equal(a, b) for a, b in zip(with_dx[:3], without[:3]))

    def test_bfloat16_matches_jax_backward(self, rng):
        shape, c = (1, 16, 16, 3), 16
        x, params = _normal(rng, shape), _level_params(rng, 3, c)
        g = _normal(rng, (1, 8, 8, c))
        tx = _t(x).bfloat16()
        k1, b1, k2, b2, k3, b3 = [p.bfloat16() for p in _oihw(params)]
        out, s1, s2 = pyramid_level_plain(tx, k1, b1, k2, b2, k3, b3, return_acts=True)
        tg = _t(g).bfloat16()
        dx = pyramid_level_bwd_plain(tx, k1, k2, k3, out, s1, s2, tg)[3]
        _, vjp = jax.vjp(lambda *a: jax_pyramid_level_fused(*a, interpret=True),
                         jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(p, jnp.bfloat16) for p in params])
        want = vjp(jnp.asarray(g, jnp.bfloat16))[0]
        assert dx.dtype == torch.bfloat16
        # three chained stages, each reading a rounded cotangent: 2 ulps
        w = np.asarray(want.astype(jnp.float32))
        assert np.abs(dx.float().numpy() - w).max() <= 2 * np.abs(w).max() / 128.0
