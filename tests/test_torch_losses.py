"""The port's losses, TF1 nearest resize and learning-rate schedule against the JAX package.

Inputs come from a numpy seed and go through the JAX function and its
counterpart. All float32 on the CPU; the two differ only in summation
order, so rtol=1e-5 (the losses sum over pixels, so atol scales with the
value: 1e-5 of it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu import losses as jax_losses
from pwcnet_tpu.ops.resize import resize_nearest as jax_resize_nearest
from pwcnet_tpu.train_lib.schedule import make_lr as jax_make_lr
from pwcnet_tpu_torch import losses
from pwcnet_tpu_torch.ops.resize import resize_nearest
from pwcnet_tpu_torch.train_lib.schedule import DEFAULT_BOUNDARIES, make_lr, piecewise_halving

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _flows(rng, b=3, h=16, w=24, scale=4.0):
    return (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)


def _pyramid(rng, b=3, h=16, w=24, levels=5):
    """Deep -> shallow flow pyramid as the model returns it."""
    sizes = [(h >> (levels - l), w >> (levels - l)) for l in range(levels)]
    return [(rng.standard_normal((b, max(hh, 1), max(ww, 1), 2)) * 0.2).astype(np.float32) for hh, ww in sizes]


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


class TestPointLosses:
    @pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "epe"])
    def test_matches_jax(self, rng, name):
        x, y = _flows(rng), _flows(rng)
        got = getattr(losses, name)(torch.from_numpy(x), torch.from_numpy(y))
        _close(got, getattr(jax_losses, name)(jnp.asarray(x), jnp.asarray(y)))

    def test_sum_over_pixels_mean_over_batch(self):
        x = torch.ones((2, 3, 4, 2))
        y = torch.zeros((2, 3, 4, 2))
        assert losses.l1_loss(x, y).item() == pytest.approx(3 * 4 * 2)
        assert losses.l2_loss(x, y).item() == pytest.approx(3 * 4 * 2**0.5)
        assert losses.epe(x, y).item() == pytest.approx(2**0.5)


class TestPyramidLosses:
    @pytest.mark.parametrize("shape", [(16, 24), (32, 32), (24, 40)])
    def test_multiscale_matches_jax(self, rng, shape):
        gt = _flows(rng, h=shape[0], w=shape[1])
        pyr = _pyramid(rng, h=shape[0], w=shape[1])
        got = losses.multiscale_loss(torch.from_numpy(gt), [torch.from_numpy(p) for p in pyr])
        _close(got, jax_losses.multiscale_loss(jnp.asarray(gt), [jnp.asarray(p) for p in pyr]))

    @pytest.mark.parametrize("epsilon,q", [(0.01, 0.4), (0.02, 0.4), (0.1, 0.8)])
    def test_multirobust_matches_jax(self, rng, epsilon, q):
        gt, pyr = _flows(rng), _pyramid(rng)
        got = losses.multirobust_loss(
            torch.from_numpy(gt), [torch.from_numpy(p) for p in pyr], epsilon=epsilon, q=q
        )
        want = jax_losses.multirobust_loss(jnp.asarray(gt), [jnp.asarray(p) for p in pyr], epsilon=epsilon, q=q)
        _close(got, want)

    def test_custom_weights_and_fewer_levels(self, rng):
        gt, pyr = _flows(rng), _pyramid(rng, levels=2)
        w = (0.5, 0.25)
        got = losses.multiscale_loss(torch.from_numpy(gt), [torch.from_numpy(p) for p in pyr], weights=w)
        _close(got, jax_losses.multiscale_loss(jnp.asarray(gt), [jnp.asarray(p) for p in pyr], weights=w))

    def test_ground_truth_is_scaled_by_20_and_not_by_level(self):
        """A flow pyramid equal to gt / 20 at every level has zero loss:
        the downsampling does not rescale magnitudes."""
        gt = torch.full((1, 8, 8, 2), 40.0)
        pyr = [torch.full((1, 2, 2, 2), 2.0), torch.full((1, 4, 4, 2), 2.0)]
        assert losses.multiscale_loss(gt, pyr).item() == 0.0
        assert losses.DEFAULT_WEIGHTS == jax_losses.DEFAULT_WEIGHTS

    def test_gradient_matches_jax(self, rng):
        import jax

        gt, pyr = _flows(rng), _pyramid(rng)
        tp = [torch.from_numpy(p).requires_grad_() for p in pyr]
        grads = torch.autograd.grad(losses.multiscale_loss(torch.from_numpy(gt), tp), tp)
        want = jax.grad(lambda ps: jax_losses.multiscale_loss(jnp.asarray(gt), ps))([jnp.asarray(p) for p in pyr])
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


class TestWeightDecay:
    def test_matches_jax_over_a_tree_with_biases(self, rng):
        tree = {
            "a": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                  "bias": rng.standard_normal((8,)).astype(np.float32)},
            "b": {"kernel": rng.standard_normal((3, 3, 8, 2)).astype(np.float32),
                  "bias": rng.standard_normal((2,)).astype(np.float32)},
        }
        leaves = [torch.from_numpy(v) for mod in tree.values() for v in mod.values()]
        got = losses.weight_decay(leaves)
        assert got.dtype == torch.float32
        _close(got, jax_losses.weight_decay(tree))

    def test_bfloat16_parameters_sum_in_float32(self):
        p = torch.full((4096,), 0.1, dtype=torch.bfloat16)
        got = losses.weight_decay([p])
        assert got.dtype == torch.float32
        assert got.item() == pytest.approx(0.5 * 4096 * float(p[0]) ** 2, rel=1e-6)


class TestResizeNearest:
    @pytest.mark.parametrize(
        "in_hw,out_hw", [((16, 24), (8, 12)), ((16, 24), (1, 1)), ((17, 23), (5, 7)), ((6, 8), (12, 16)), ((8, 8), (8, 8))]
    )
    def test_matches_jax(self, rng, in_hw, out_hw):
        x = rng.standard_normal((2, *in_hw, 2)).astype(np.float32)
        got = resize_nearest(torch.from_numpy(x), out_hw).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_resize_nearest(jnp.asarray(x), out_hw)))

    def test_takes_the_top_left_sample(self):
        x = torch.arange(16.0).reshape(1, 4, 4, 1)
        assert resize_nearest(x, (2, 2)).flatten().tolist() == [0.0, 2.0, 8.0, 10.0]


class TestSchedule:
    @pytest.mark.parametrize(
        "count", [0, 1, 199_999, 200_000, 200_001, 249_999, 250_000, 300_000, 350_000, 399_999, 400_000, 4_000_000]
    )
    def test_matches_optax_at_the_boundaries(self, count):
        assert make_lr(1e-4, True)(count) == pytest.approx(float(jax_make_lr(1e-4, True)(count)), rel=1e-6)

    def test_halves_at_the_boundary_step_itself(self):
        lr = piecewise_halving(1e-4)
        assert lr(199_999) == 1e-4 and lr(200_000) == 5e-5 and lr(200_001) == 5e-5
        assert lr(4_000_000) == pytest.approx(1e-4 / 32)
        assert DEFAULT_BOUNDARIES == (200_000, 250_000, 300_000, 350_000, 400_000)

    def test_constant(self):
        assert make_lr(3e-4, scheduling=False) == 3e-4
        assert jax_make_lr(3e-4, scheduling=False) == 3e-4
