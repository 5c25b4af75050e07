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
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.ops import resize as resize_mod
from pwcnet_tpu_torch.ops.resize import nearest_indices, resize_nearest
from pwcnet_tpu_torch.train_lib import create_train_state, make_train_step
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


def _numpy_nearest(x, size):
    """The TF1 nearest resize by the numpy tables, copied up on every call."""
    ys = torch.from_numpy(resize_mod._nearest_table(x.shape[-3], size[0])).to(x.device)
    xs = torch.from_numpy(resize_mod._nearest_table(x.shape[-2], size[1])).to(x.device)
    return x.index_select(-3, ys).index_select(-2, xs)


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

    @pytest.mark.parametrize("name", ["multiscale_loss", "multirobust_loss"])
    def test_bitwise_the_numpy_tables(self, rng, name, monkeypatch):
        """The losses on the device-resident tables give the bits of the
        same losses with the numpy tables copied up at every level."""
        gt, pyr = torch.from_numpy(_flows(rng, h=24, w=40)), [torch.from_numpy(p) for p in _pyramid(rng, h=24, w=40)]
        got = getattr(losses, name)(gt, pyr)
        monkeypatch.setattr(losses, "resize_nearest", _numpy_nearest)
        assert torch.equal(got, getattr(losses, name)(gt, pyr))

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
        np.testing.assert_array_equal(got, _numpy_nearest(torch.from_numpy(x), out_hw).numpy())

    def test_takes_the_top_left_sample(self):
        x = torch.arange(16.0).reshape(1, 4, 4, 1)
        assert resize_nearest(x, (2, 2)).flatten().tolist() == [0.0, 2.0, 8.0, 10.0]


class TestDeviceTables:
    @pytest.mark.parametrize("in_size,out_size", [(384, 6), (448, 112), (17, 5), (6, 12)])
    def test_the_numpy_table_uploaded_once(self, in_size, out_size):
        cpu = torch.device("cpu")
        table = resize_mod.nearest_tensor(in_size, out_size, cpu)
        assert table.dtype == torch.int64
        np.testing.assert_array_equal(table.numpy(), resize_mod._nearest_table(in_size, out_size))
        before = resize_mod.table_counts()
        assert resize_mod.nearest_tensor(in_size, out_size, cpu) is table
        after = resize_mod.table_counts()
        assert after == {"lookups": before["lookups"] + 1, "uploads": before["uploads"]}

    def test_a_train_step_uploads_each_table_once(self, monkeypatch):
        """The first step builds one table per distinct (frame size, level
        size) of the loss; a second step builds none and looks each up
        again."""
        monkeypatch.setattr(resize_mod, "_tables", {})
        resize_mod.reset_table_counts()
        model = PWCDCNet(num_levels=3, output_level=1, search_range=2)
        state = create_train_state(model, learning_rate=1e-4, device="cpu")
        step = make_train_step(model)
        g = torch.Generator().manual_seed(0)
        images, flows = torch.rand((2, 2, 16, 24, 3), generator=g), torch.randn((2, 16, 24, 2), generator=g)
        state, _ = step(state, images, flows)
        _, pyramid = model(images[:, 0], images[:, 1])
        distinct = {(16, p.shape[1]) for p in pyramid} | {(24, p.shape[2]) for p in pyramid}
        assert len(distinct) == 4
        first = resize_mod.table_counts()
        assert first == {"lookups": 2 * len(pyramid), "uploads": len(distinct)}
        state, _ = step(state, images, flows)
        assert resize_mod.table_counts() == {"lookups": 4 * len(pyramid), "uploads": len(distinct)}


class TestScoredRows:
    @pytest.mark.parametrize("sharded", [True, False])
    @pytest.mark.parametrize("frame_rows,level_rows", [(32, 8), (48, 12), (40, 10)])
    def test_two_shards_score_the_rows_they_did(self, rng, frame_rows, level_rows, sharded):
        """Each of 2 shards gets the rows the numpy-table version gave it,
        a second call the same cached rows."""
        n, w_full, wp = 2, 12, 3
        hp = level_rows // n if sharded else level_rows
        for index in range(n):
            gt = torch.from_numpy(_flows(rng, b=2, h=frame_rows // n, w=w_full))
            pred = torch.from_numpy(_flows(rng, b=2, h=hp, w=wp))
            hs, g0, p0 = frame_rows // n, index * (frame_rows // n), (index * hp if sharded else 0)
            src = nearest_indices(frame_rows, hp * n if sharded else hp)[p0 : p0 + hp]
            keep = np.flatnonzero((src >= g0) & (src < g0 + hs))
            want_gt = gt.index_select(1, torch.from_numpy(src[keep] - g0)).index_select(
                2, torch.from_numpy(nearest_indices(w_full, wp)))
            want_pred = pred.narrow(1, int(keep[0]) if keep.size else 0, keep.size)
            for _ in range(2):
                got_gt, got_pred = losses.scored_rows(gt, pred, frame_rows, index, n, sharded)
                assert torch.equal(got_gt, want_gt) and torch.equal(got_pred, want_pred)


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
