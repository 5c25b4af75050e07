"""Serving on a mesh: the unfused and the nearest warp under H-sharding,
and ``predict_sequence`` on a (data, spatial) mesh, against the port's
unsharded predictor and the JAX package's sharded one.

The port's ranks run as ``tests/_torch_spatial_worker.py`` processes in
gloo groups on the CPU (``test_torch_spatial.run_ranks``); the JAX side
runs ``FlowPredictor(spatial=..., data=..., use_pallas=False)`` on the
8-device virtual CPU mesh of ``tests/conftest.py``, from the same msgpack
weights. Inputs come from numpy seeds.

Tolerances (float32 throughout). The sharded warp gathers frame 1 whole
and warps each flow row at its global row: its rows are the unsharded
warp's bit for bit, and its gradients within 1e-6 (the gather's backward
sums the ranks' contributions in another order). The predictors within
rtol 1e-5 / atol 1e-5 of the flow in pixels, as
``test_torch_spatial.TestSpatialServing`` holds them (``__call__`` on a
frame pair within atol 1e-4 there too); against the JAX predictors the
same bounds, as ``tests/test_spatial.py`` holds its sharded stream.
"""

import jax
import numpy as np
import pytest
import torch

from pwcnet_tpu.inference import FlowPredictor as JaxFlowPredictor
from pwcnet_tpu.ops.warp import bilinear_warp as jax_bilinear_warp
from pwcnet_tpu.ops.warp import nearest_warp as jax_nearest_warp
from pwcnet_tpu_torch.inference import FlowPredictor
from pwcnet_tpu_torch.ops.warp import bilinear_warp, bilinear_warp_rows, nearest_warp, nearest_warp_rows
from pwcnet_tpu_torch.weights import from_jax_params, save_tree
from test_torch_spatial import TINY, _jax_tree, _rows, _state_inputs, run_ranks

torch.set_num_threads(1)

OPTIONS = {"unfused": dict(use_fused=False), "nearest": dict(warp_type="nearest")}


def _ckpt(tmp_path, tree):
    path = tmp_path / "model_0.msgpack"
    save_tree(path, jax.tree_util.tree_map(np.asarray, tree))
    return str(path)


def _warp_inputs(seed, b=2, h=24, w=10, c=3):
    """Frame 1 and a flow whose y parts include fractions in (-1, 0) and
    reach across the shards and out of the frame."""
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * 3).astype(np.float32)
    flow[:, ::3, :, 1] = -rng.random((b, len(range(0, h, 3)), w)).astype(np.float32)  # in (-1, 0)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return f1, flow, g


class TestRowWarps:
    """The warps of a row shard against the whole frame, without ranks."""

    def test_nearest_truncates_before_the_row_offset(self):
        f1, flow, _ = _warp_inputs(0)
        x, fl = torch.from_numpy(f1), torch.from_numpy(flow)
        whole = nearest_warp(x, fl)
        for row0 in (12, 6, 18):
            got = nearest_warp_rows(x, fl[:, row0 : row0 + 6], row0)
            assert torch.equal(got, whole[:, row0 : row0 + 6])
        # the offset folded into flow y before truncating moves the rows
        # whose flow y lies in (-1, 0): trunc(12 - 0.5) = 11, 12 + trunc(-0.5) = 12
        shifted = fl[:, 12:].clone()
        shifted[..., 1] += 12
        folded = nearest_warp_rows(x, shifted, 0)
        assert not torch.equal(folded, whole[:, 12:])
        np.testing.assert_array_equal(nearest_warp(x, fl).numpy(), np.asarray(jax_nearest_warp(f1, flow)))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_bilinear_rows_are_the_unsharded_rows(self, dtype):
        f1, flow, _ = _warp_inputs(1)
        x, fl = torch.from_numpy(f1).to(dtype), torch.from_numpy(flow).to(dtype)
        whole = bilinear_warp(x, fl)
        for row0 in (0, 12, 18):
            assert torch.equal(bilinear_warp_rows(x, fl[:, row0 : row0 + 6], row0), whole[:, row0 : row0 + 6])


class TestShardedWarp:
    @pytest.mark.parametrize("world", [2, 4])
    def test_guard_warp_matches_unsharded_and_jax(self, tmp_path, world):
        """``SpatialGuard.warp`` over gloo ranks: each rank's rows against
        the unsharded port warp (bitwise) and the JAX warp, and the bilinear
        warp's gradients (frame 1 reduce-scattered back to its rows)."""
        f1, flow, g = _warp_inputs(world)
        outs = run_ranks("warp", world, tmp_path, dict(f1=f1, flow=flow, g=g), {})
        x, fl = torch.from_numpy(f1).requires_grad_(), torch.from_numpy(flow).requires_grad_()
        np.testing.assert_array_equal(_rows(outs, "nearest"), nearest_warp(x, fl).detach().numpy())
        np.testing.assert_array_equal(_rows(outs, "nearest"), np.asarray(jax_nearest_warp(f1, flow)))
        want = bilinear_warp(x, fl)
        np.testing.assert_array_equal(_rows(outs, "bilinear"), want.detach().numpy())
        np.testing.assert_allclose(_rows(outs, "bilinear"), np.asarray(jax_bilinear_warp(f1, flow)),
                                   rtol=1e-6, atol=1e-6)
        df1, dflow = torch.autograd.grad(want, [x, fl], torch.from_numpy(g))
        np.testing.assert_allclose(_rows(outs, "df1"), df1.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_rows(outs, "dflow"), dflow.numpy(), rtol=1e-6, atol=1e-6)


class TestUnfusedAndNearestServing:
    @pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2)])
    @pytest.mark.parametrize("option", sorted(OPTIONS))
    def test_matches_unsharded_and_jax(self, tmp_path, option, data, spatial):
        """``FlowPredictor(spatial=2, use_fused=False)`` and ``(...,
        warp_type='nearest')``: a batch whose every level is sharded, and a
        pair whose level 0 stays whole while level 1 is sharded (the guard's
        switch), against the unsharded predictor with the same option and
        the JAX sharded predictor."""
        kwargs = OPTIONS[option]
        rng = np.random.default_rng(7)
        tree = _jax_tree(TINY, (64, 32), seed=5)
        frames = rng.integers(0, 255, (4, 2, 64, 32, 3), dtype=np.uint8)
        pair = rng.integers(0, 255, (2, 36, 40, 3), dtype=np.uint8)  # cropped to 32x40
        inp = dict(frames=frames, pair=pair, **_state_inputs(tree))
        outs = run_ranks("predictor", data * spatial, tmp_path, inp,
                         {"model": {**TINY, **kwargs}, "data": data, "spatial": spatial})
        assert not any(bool(o["fused"]) for o in outs)
        assert list(outs[0]["sharded"]) == [True, True]
        assert list(outs[0]["sharded_call"]) == [False, True]

        ref = FlowPredictor(**TINY, **kwargs, device="cpu")
        ref.model.load_state_dict(from_jax_params(tree))
        want, want_pyr = ref.raw_forward(frames)
        want_call = ref(pair[0], pair[1])[0]
        jax_pred = JaxFlowPredictor(checkpoint=_ckpt(tmp_path, tree), spatial=spatial, data=data, use_pallas=False,
                                    **TINY, **kwargs)
        jax_flow, jax_pyr = jax_pred.raw_forward(frames)
        jax_call = jax_pred(pair[0], pair[1])[0]
        for o in outs:
            np.testing.assert_allclose(o["flow"], want.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(o["flow"], np.asarray(jax_flow), rtol=1e-5, atol=1e-5)
            for l, (wp, jp) in enumerate(zip(want_pyr, jax_pyr)):
                np.testing.assert_allclose(o[f"pyramid_{l}"], wp.numpy(), rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(o[f"pyramid_{l}"], np.asarray(jp), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(o["call_flow"], want_call, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(o["call_flow"], jax_call, rtol=1e-5, atol=1e-4)


def _drifting(n, h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h + 2 * n, w + 3 * n, 3), dtype=np.uint8)
    return np.stack([base[2 * k : 2 * k + h, 3 * k : 3 * k + w] for k in range(n)])


class TestShardedSequence:
    @pytest.mark.parametrize("data,spatial,batch,depth", [(1, 2, 2, 2), (2, 2, 2, 2), (2, 2, 3, 1)])
    def test_flow_stream_matches_unsharded_and_jax(self, tmp_path, data, spatial, batch, depth):
        """``predict_sequence(fetch='flow')`` on 6 frames (5 pairs: the tail
        dispatch holds fewer pairs than ``batch``; at batch 3 no dispatch
        divides over ``data``): every rank yields every pair, in order,
        equal to the unsharded port stream and the JAX sharded stream. The
        predictor's default here (no kernels) is the unfused warp."""
        outs = self._check(tmp_path, data, spatial, batch, depth, use_fused=False)
        assert not any(bool(o["fused"]) for o in outs)

    @pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2)])
    def test_fused_stream_matches_unsharded_and_jax(self, tmp_path, data, spatial):
        """The same with ``use_fused=True``, the card's default: every
        dispatch through the spatial warped cost volume (K9's plain version
        here), against the unsharded port stream and the JAX sharded
        stream with the fused warp."""
        outs = self._check(tmp_path, data, spatial, 2, 2, use_fused=True)
        assert all(bool(o["fused"]) for o in outs)

    def _check(self, tmp_path, data, spatial, batch, depth, use_fused):
        tree = _jax_tree(TINY, (64, 48), seed=9)
        frames = _drifting(6, 64, 48, seed=data + batch)
        seq = dict(batch=batch, depth=depth, fetch="flow")
        outs = run_ranks("sequence", data * spatial, tmp_path, dict(frames=frames, **_state_inputs(tree)),
                         {"model": dict(TINY, use_fused=use_fused), "data": data, "spatial": spatial,
                          "sequence": seq})
        ref = FlowPredictor(**TINY, device="cpu")
        ref.model.load_state_dict(from_jax_params(tree))
        want = list(ref.predict_sequence(list(frames), batch=batch, fetch="flow"))
        jax_pred = JaxFlowPredictor(checkpoint=_ckpt(tmp_path, tree), spatial=spatial, data=data, use_pallas=False,
                                    use_fused=use_fused, **TINY)
        jax_want = list(jax_pred.predict_sequence(list(frames), batch=batch, fetch="flow"))
        assert len(want) == len(jax_want) == 5
        for o in outs:
            assert int(o["pairs"]) == 5
            for i, (w, jw) in enumerate(zip(want, jax_want)):
                np.testing.assert_allclose(o[f"flow_{i}"], w, rtol=1e-5, atol=1e-5, err_msg=f"pair {i}")
                np.testing.assert_allclose(o[f"flow_{i}"], jw, rtol=1e-5, atol=1e-5, err_msg=f"pair {i}")
        return outs

    def test_fetch_all_returns_the_pyramids_whole(self, tmp_path):
        """``fetch='all'`` on a (2, 2) mesh: each pair's flow, every pyramid
        level whole and the pair's frames, as the unsharded stream yields
        them."""
        tree = _jax_tree(TINY, (64, 48), seed=10)
        frames = _drifting(6, 64, 48, seed=3)
        seq = dict(batch=2, depth=2, fetch="all")
        outs = run_ranks("sequence", 4, tmp_path, dict(frames=frames, **_state_inputs(tree)),
                         {"model": TINY, "data": 2, "spatial": 2, "sequence": seq})
        ref = FlowPredictor(**TINY, device="cpu")
        ref.model.load_state_dict(from_jax_params(tree))
        want = list(ref.predict_sequence(list(frames), batch=2, fetch="all"))
        for o in outs:
            assert int(o["pairs"]) == len(want) == 5
            for i, (flow, pyramid, images) in enumerate(want):
                np.testing.assert_allclose(o[f"flow_{i}"], flow, rtol=1e-5, atol=1e-5)
                for l, p in enumerate(pyramid):
                    assert o[f"pyramid_{i}_{l}"].shape == p.shape
                    np.testing.assert_allclose(o[f"pyramid_{i}_{l}"], p, rtol=1e-5, atol=1e-5)
                np.testing.assert_array_equal(o[f"images_{i}"], images)
