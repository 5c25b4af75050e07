"""The port's plain ops (pwcnet_tpu_torch.ops) against the JAX package.

Each op gets the same numpy inputs as its JAX counterpart and, where the
JAX function reaches a Pallas kernel, that kernel in interpret mode; the
NumPy oracles in tests/oracles.py (the reference's own formulation) are a
third witness. Everything runs in float32 on the CPU.

Tolerance: rtol=1e-5, atol=1e-6 on op outputs. The two sides run the same
float32 arithmetic and differ only in summation order (a few ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from pwcnet_tpu.ops.cost_volume import cost_volume as jax_cost_volume
from pwcnet_tpu.ops.pallas.cost_volume import cost_volume_pallas
from pwcnet_tpu.ops.pallas.warped_cv import warped_cost_volume as jax_warped_cost_volume
from pwcnet_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from pwcnet_tpu.ops.warp import bilinear_warp as jax_bilinear_warp
from pwcnet_tpu.ops.warp import nearest_warp as jax_nearest_warp
from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume_plain
from pwcnet_tpu_torch.ops import resize as resize_mod
from pwcnet_tpu_torch.ops.resize import resize_bilinear, upsample2x_bilinear
from pwcnet_tpu_torch.ops.warp import bilinear_warp, nearest_warp, warp

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edge_flow(rng, shape, scale):
    """Random flow plus pixels pushed far out of the frame on every side."""
    flow = _normal(rng, shape[:3] + (2,), scale)
    flow[:, 0, :, 1] = -40.0  # top row looks above the frame
    flow[:, -1, :, 1] = 40.0  # bottom row below it
    flow[:, :, 0, 0] = -40.0  # left column
    flow[:, :, -1, 0] = 40.0  # right column
    flow[:, 1, 1] = (0.5, -1.5)  # fractional step across the top-left corner
    return flow


class TestResize:
    @pytest.mark.parametrize(
        "shape,size",
        [
            ((1, 5, 7, 3), (10, 14)),   # 2x: the inter-level upsample
            ((2, 4, 6, 2), (16, 24)),   # 4x: the final flow upsample
            ((1, 5, 7, 3), (9, 11)),    # non-integer up
            ((1, 8, 12, 4), (5, 7)),    # non-integer down
            ((1, 6, 4, 2), (12, 6)),    # integer in H only
        ],
    )
    def test_matches_jax_and_oracle(self, rng, shape, size):
        x = _normal(rng, shape)
        got = resize_bilinear(_t(x), size).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_resize_bilinear(jnp.asarray(x), size)), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, oracles.tf1_resize_bilinear(x, *size), rtol=RTOL, atol=ATOL)

    def test_not_half_pixel_interpolate(self, rng):
        """F.interpolate(align_corners=False) samples half-pixel centres:
        a different function, which the port must not use."""
        x = _normal(rng, (1, 4, 4, 1))
        ours = upsample2x_bilinear(_t(x))
        theirs = torch.nn.functional.interpolate(
            _t(x).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear", align_corners=False
        ).permute(0, 2, 3, 1)
        assert not torch.allclose(ours, theirs, atol=1e-3)
        np.testing.assert_allclose(ours.numpy(), oracles.tf1_resize_bilinear(x, 8, 8), rtol=RTOL, atol=ATOL)

    def test_same_size_is_identity(self, rng):
        x = _t(_normal(rng, (1, 3, 5, 2)))
        assert resize_bilinear(x, (3, 5)) is x

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize(
        "shape,size", [((1, 5, 7, 3), (9, 11)), ((1, 8, 12, 4), (5, 7)), ((2, 436, 1024, 2), (448, 1024))])
    def test_non_integer_is_bitwise_the_numpy_tables(self, rng, shape, size, dtype):
        """The device-resident tables gather and lerp exactly as the numpy
        tables copied up on every call did."""
        x = _t(_normal(rng, shape)).to(dtype)
        (y_lo, y_hi, y_lerp), (x_lo, x_hi, x_lerp) = (
            [torch.from_numpy(a) for a in resize_mod._bilinear_table(i, o)] for i, o in zip(shape[1:3], size))
        top, bot = x.index_select(-3, y_lo), x.index_select(-3, y_hi)
        tl, tr = top.index_select(-2, x_lo), top.index_select(-2, x_hi)
        bl, br = bot.index_select(-2, x_lo), bot.index_select(-2, x_hi)
        wy, wx = y_lerp.to(dtype)[:, None, None], x_lerp.to(dtype)[:, None]
        t, b = tl + (tr - tl) * wx, bl + (br - bl) * wx
        assert torch.equal(resize_bilinear(x, size), t + (b - t) * wy)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("in_size,out_size", [(5, 9), (12, 7), (436, 448), (7, 7)])
    def test_device_tables_are_the_numpy_tables_uploaded_once(self, in_size, out_size, dtype):
        cpu = torch.device("cpu")
        low, high, lerp = resize_mod._bilinear_tensors(in_size, out_size, cpu, dtype)
        want = resize_mod._bilinear_table(in_size, out_size)
        np.testing.assert_array_equal(low.numpy(), want[0])
        np.testing.assert_array_equal(high.numpy(), want[1])
        assert lerp.dtype == dtype and torch.equal(lerp, torch.from_numpy(want[2]).to(dtype))
        near = resize_mod.nearest_tensor(in_size, out_size, cpu)
        np.testing.assert_array_equal(near.numpy(), resize_mod._nearest_table(in_size, out_size))
        before = resize_mod.table_counts()
        again = resize_mod._bilinear_tensors(in_size, out_size, cpu, dtype)
        assert all(a is b for a, b in zip(again, (low, high, lerp)))
        assert resize_mod.nearest_tensor(in_size, out_size, cpu) is near
        after = resize_mod.table_counts()
        assert after["uploads"] == before["uploads"] and after["lookups"] == before["lookups"] + 2

    def test_a_table_first_used_in_inference_mode_serves_a_backward(self, rng):
        size = (13, 17)  # a shape no other test resizes to
        x = _t(_normal(rng, (1, 6, 8, 2)))
        with torch.inference_mode():
            resize_bilinear(x, size)
        xg = x.clone().requires_grad_()
        (grad,) = torch.autograd.grad(resize_bilinear(xg, size).sum(), xg)
        assert grad.shape == x.shape and torch.isfinite(grad).all()


class TestCostVolume:
    @pytest.mark.parametrize("shape,d", [((2, 6, 10, 5), 2), ((1, 9, 7, 4), 4), ((1, 5, 12, 3), 1)])
    def test_matches_jax_and_oracle(self, rng, shape, d):
        f0, f1 = _normal(rng, shape), _normal(rng, shape)
        got = cost_volume(_t(f0), _t(f1), d).numpy()
        assert got.shape == shape[:3] + ((2 * d + 1) ** 2,)
        want = np.asarray(jax_cost_volume(jnp.asarray(f0), jnp.asarray(f1), d))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, oracles.cost_volume(f0, f1, d), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("shape,d", [((1, 6, 10, 5), 2), ((1, 9, 8, 3), 4)])
    def test_matches_pallas_kernel(self, rng, shape, d):
        """K2's TPU kernel, run in interpret mode."""
        f0, f1 = _normal(rng, shape), _normal(rng, shape)
        got = cost_volume(_t(f0), _t(f1), d).numpy()
        want = np.asarray(cost_volume_pallas(jnp.asarray(f0), jnp.asarray(f1), d, None, True))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_bfloat16_accumulates_in_float32(self, rng):
        """bf16 inputs: float32 products and sums, one rounding at the end."""
        f0, f1 = _normal(rng, (1, 4, 5, 64)), _normal(rng, (1, 4, 5, 64))
        a, b = _t(f0).bfloat16(), _t(f1).bfloat16()
        got = cost_volume(a, b, 2)
        assert got.dtype == torch.bfloat16
        want = cost_volume(a.float(), b.float(), 2).bfloat16()
        assert torch.equal(got, want)


class TestWarp:
    @pytest.mark.parametrize("shape,scale", [((2, 7, 9, 3), 1.5), ((1, 10, 6, 4), 6.0), ((1, 5, 5, 2), 0.3)])
    def test_bilinear_matches_jax_and_oracle(self, rng, shape, scale):
        x = _normal(rng, shape)
        flow = _edge_flow(rng, shape, scale)
        got = bilinear_warp(_t(x), _t(flow)).numpy()
        want = np.asarray(jax_bilinear_warp(jnp.asarray(x), jnp.asarray(flow)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, oracles.bilinear_warp(x, flow), rtol=RTOL, atol=ATOL)

    def test_bilinear_is_not_grid_sample(self, rng):
        """Independent corner clamps with unclamped weights differ from
        grid_sample's border handling at the frame's edge."""
        x = _normal(rng, (1, 6, 6, 1))
        flow = np.zeros((1, 6, 6, 2), np.float32)
        flow[..., 0] = 0.5
        ours = bilinear_warp(_t(x), _t(flow))
        gy, gx = torch.meshgrid(torch.arange(6.0), torch.arange(6.0), indexing="ij")
        grid = torch.stack([(gx + 0.5) / 5 * 2 - 1, gy / 5 * 2 - 1], -1)[None]
        theirs = torch.nn.functional.grid_sample(
            _t(x).permute(0, 3, 1, 2), grid, align_corners=True, padding_mode="zeros"
        ).permute(0, 2, 3, 1)
        assert not torch.allclose(ours[:, :, -1], theirs[:, :, -1], atol=1e-3)
        np.testing.assert_allclose(ours.numpy(), oracles.bilinear_warp(x, flow), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("shape,scale", [((2, 7, 9, 3), 2.5), ((1, 6, 11, 2), 8.0)])
    def test_nearest_matches_jax_and_oracle(self, rng, shape, scale):
        x = _normal(rng, shape)
        flow = _edge_flow(rng, shape, scale)
        flow[:, 2, 2] = (-0.7, 0.7)  # truncation toward zero, not floor
        got = nearest_warp(_t(x), _t(flow)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_nearest_warp(jnp.asarray(x), jnp.asarray(flow))))
        np.testing.assert_array_equal(got, oracles.nearest_warp(x, flow))

    def test_dispatch(self, rng):
        x = _t(_normal(rng, (1, 4, 4, 2)))
        flow = _t(_normal(rng, (1, 4, 4, 2)))
        assert torch.equal(warp(x, flow, "nearest"), nearest_warp(x, flow))
        assert torch.equal(warp(x, flow), bilinear_warp(x, flow))
        with pytest.raises(ValueError):
            warp(x, flow, "cubic")


class TestWarpedCostVolumePlain:
    """K1's plain version against K1's TPU kernel in interpret mode."""

    @pytest.mark.parametrize(
        "shape,d,scale",
        [((2, 8, 16, 8), 2, 1.5), ((1, 12, 8, 3), 4, 3.0), ((1, 6, 10, 5), 2, 30.0)],
    )
    def test_matches_pallas_kernel(self, rng, shape, d, scale):
        f0, f1 = _normal(rng, shape), _normal(rng, shape)
        flow = _normal(rng, shape[:3] + (2,), scale)
        got = warped_cost_volume_plain(_t(f0), _t(f1), _t(flow), d).numpy()
        want = np.asarray(
            jax_warped_cost_volume(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(flow), d, None, True)
        )
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        composed = oracles.cost_volume(f0, oracles.bilinear_warp(f1, flow), d)
        np.testing.assert_allclose(got, composed, rtol=RTOL, atol=ATOL)
