"""Sequence serving (``FlowPredictor.predict_sequence``) and the
``test_continuous`` CLI of the port, on the CPU at the tiny model
(``num_levels=3, search_range=2, output_level=1``).

``predict_sequence`` must yield, for every consecutive pair and in order,
what ``__call__`` gives for that pair: batch 1 differs from it in nothing
(bitwise); a batch of B pairs runs the convolutions at batch B, whose CPU
kernels may sum in another order, so rtol=1e-5, atol=1e-5 there (the flows
are O(1) px). Against the JAX ``predict_sequence`` from one shared
``model_0.msgpack``: float32 through about 30 layers in two frameworks,
within 1e-4 of the flow's largest entry, as tests/test_torch_model.py holds
the two predictors.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pwcnet_tpu.inference import FlowPredictor as JaxFlowPredictor
from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu_torch import test_continuous as port_cli
from pwcnet_tpu_torch.inference import FlowPredictor
from pwcnet_tpu_torch.weights import save_tree

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_levels=3, output_level=1, search_range=2)
SMALL_FLAGS = ["--num_levels", "3", "--search_range", "2", "--output_level", "1"]


def _frames(n, h, w, seed=0):
    """A drifting random texture: n uint8 frames."""
    rng = np.random.default_rng(seed)
    base = (rng.random((h + 2 * n, w + 3 * n, 3)) * 255).astype(np.uint8)
    return [np.ascontiguousarray(base[2 * k : 2 * k + h, 3 * k : 3 * k + w]) for k in range(n)]


def _write_pngs(directory, frames, stem="frame_"):
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for k, f in enumerate(frames):
        paths.append(directory / f"{stem}{k + 1:04d}.png")
        Image.fromarray(f).save(paths[-1])
    return [str(p) for p in paths]


def _jax_tree(seed):
    model = JaxPWCDCNet(**SMALL)
    x = jnp.zeros((1, 8, 8, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def fill(s):
        scale = 1.0 / np.sqrt(9.0 * s.shape[2]) if len(s.shape) == 4 else 0.05
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "model_0.msgpack"
    save_tree(path, jax.tree_util.tree_map(np.asarray, _jax_tree(seed=11)))
    return str(path)


def _assert_pairs(got, frames, pred, fetch, rtol):
    assert len(got) == len(frames) - 1
    for i, out in enumerate(got):
        want = pred(frames[i], frames[i + 1])
        flow = out if fetch == "flow" else out[0]
        assert flow.shape == want[0].shape and flow.dtype == np.float32
        np.testing.assert_allclose(flow, want[0], rtol=rtol, atol=rtol, err_msg=f"pair {i}")
        if fetch == "all":
            assert len(out[1]) == len(want[1])
            for a, b in zip(out[1], want[1]):
                assert a.dtype == np.float32
                np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol, err_msg=f"pair {i}")
            assert out[2].dtype == np.float32
            np.testing.assert_array_equal(out[2], want[2])


class TestPredictSequence:
    @pytest.mark.parametrize("batch,n_frames", [(1, 5), (3, 7), (3, 5), (4, 6), (8, 4)])
    @pytest.mark.parametrize("fetch", ["flow", "all"])
    def test_every_pair_is_call(self, ckpt, batch, n_frames, fetch):
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", **SMALL)
        frames = _frames(n_frames, 33, 40)
        got = list(pred.predict_sequence(frames, batch=batch, fetch=fetch))
        _assert_pairs(got, frames, pred, fetch, 0.0 if batch == 1 else 1e-5)

    @pytest.mark.parametrize("batch", [1, 3])
    def test_pad_crops_each_flow_to_its_frame(self, ckpt, batch):
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", size_handling="pad", **SMALL)
        frames = _frames(5, 30, 36, seed=1)
        got = list(pred.predict_sequence(frames, batch=batch))
        assert got[0][0].shape == (30, 36, 2) and got[0][2].shape == (2, 32, 40, 3)
        _assert_pairs(got, frames, pred, "all", 0.0 if batch == 1 else 1e-5)

    def test_paths_and_arrays_give_the_same_pairs(self, ckpt, tmp_path):
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", **SMALL)
        frames = _frames(4, 32, 40, seed=2)
        paths = _write_pngs(tmp_path, frames)
        by_path = list(pred.predict_sequence(paths, batch=2))
        by_array = list(pred.predict_sequence(frames, batch=2))
        by_pathlike = list(pred.predict_sequence([Path(p) for p in paths], batch=2, fetch="flow"))
        for a, b, c in zip(by_path, by_array, by_pathlike):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[0], c)
            np.testing.assert_array_equal(a[2], b[2])

    def test_uint8_frames_come_back_normalised_float32(self, ckpt):
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", **SMALL)
        frames = _frames(4, 35, 41, seed=3)
        for i, (_, _, images) in enumerate(pred.predict_sequence(frames, batch=2)):
            assert images.dtype == np.float32 and images.shape == (2, 32, 40, 3)
            np.testing.assert_array_equal(images, np.stack(frames[i : i + 2])[:, :32, :40].astype(np.float32) / 255.0)

    def test_float_frames_on_the_255_scale_are_normalised(self, ckpt):
        """As ``__call__`` takes them (a recorded difference from the JAX package)."""
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", **SMALL)
        frames = _frames(4, 32, 40, seed=4)
        want = list(pred.predict_sequence(frames, batch=3))
        got = list(pred.predict_sequence([f.astype(np.float32) for f in frames], batch=3))
        mixed = list(pred.predict_sequence([frames[0].astype(np.float64), *frames[1:]], batch=3))
        for a, b, c in zip(got, want, mixed):
            np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(c[0], b[0], rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(a[2], b[2])

    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_depth_dispatches_are_in_flight_before_the_first_pair(self, ckpt, depth):
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", **SMALL)
        calls = []
        pred.model.register_forward_hook(lambda m, args, out: calls.append(args[0].shape[0]))
        seq = pred.predict_sequence(_frames(8, 32, 32, seed=5), depth=depth, batch=2, fetch="flow")
        next(seq)
        assert len(calls) == depth
        assert len(list(seq)) == 6 and calls == [2, 2, 2, 2]  # 7 pairs: 3 full batches + the padded tail

    def test_short_sequences(self, ckpt):
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", **SMALL)
        frames = _frames(2, 32, 32, seed=6)
        assert list(pred.predict_sequence(frames[:1])) == []
        assert len(list(pred.predict_sequence(frames, batch=4))) == 1

    def test_invalid_arguments_raise(self, ckpt):
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", **SMALL)
        frames = _frames(3, 32, 32)
        for kwargs in (dict(fetch="pyramid"), dict(batch=0), dict(depth=0)):
            with pytest.raises(ValueError):
                next(pred.predict_sequence(frames, **kwargs))

    @pytest.mark.parametrize("size_handling,batch", [("crop", 3), ("pad", 2), ("crop", 1)])
    def test_matches_the_jax_predict_sequence(self, ckpt, size_handling, batch):
        frames = _frames(6, 30, 45, seed=7)
        jax_pred = JaxFlowPredictor(checkpoint=ckpt, use_pallas=False, size_handling=size_handling, **SMALL)
        want = list(jax_pred.predict_sequence(frames, batch=batch))
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", size_handling=size_handling, **SMALL)
        got = list(pred.predict_sequence(frames, batch=batch))
        assert len(got) == len(want) == 5
        for (gf, gp, gi), (wf, wp, wi) in zip(got, want):
            assert gf.shape == wf.shape
            assert np.abs(gf - wf).max() <= 1e-4 * np.abs(wf).max()
            for a, b in zip(gp, wp):
                assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
            np.testing.assert_array_equal(gi, np.asarray(wi, np.float32))
        flows = list(pred.predict_sequence(frames, batch=batch, fetch="flow"))
        jax_flows = list(jax_pred.predict_sequence(frames, batch=batch, fetch="flow"))
        for a, b in zip(flows, jax_flows):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def _root_cli():
    spec = importlib.util.spec_from_file_location("root_test_continuous", REPO / "test_continuous.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestCli:
    def test_expand_wildcards_is_the_root_clis(self, tmp_path, monkeypatch):
        for name in ("b_2.png", "a_1.png", "a_10.png", "c.jpg", "a_[x].png"):
            (tmp_path / name).write_bytes(b"")
        monkeypatch.chdir(tmp_path)
        cases = [["*.png"], ["a_?.png", "c.jpg"], ["a_*.png", "*.jpg", "missing.png"], ["nothing_*"], ["b_2.png"]]
        root = _root_cli()
        for args in cases:
            assert port_cli.expand_wildcards(args) == root.expand_wildcards(args)
        assert port_cli.expand_wildcards(["a_*.png"]) == ["a_1.png", "a_10.png", "a_[x].png"]

    def test_fewer_than_two_images_raise(self, tmp_path):
        path = _write_pngs(tmp_path, _frames(1, 32, 32))
        for args in (path, [str(tmp_path / "none_*.png")]):
            with pytest.raises(ValueError, match=">= 2"):
                port_cli.main(["-i", *args, "--device", "cpu", *SMALL_FLAGS])

    def test_time_prints_the_sequence_throughput(self, tmp_path, capsys):
        _write_pngs(tmp_path, _frames(5, 32, 40))
        port_cli.main(["-i", str(tmp_path / "frame_*.png"), "--device", "cpu", "--time", "--batch", "2",
                       "--depth", "1", *SMALL_FLAGS])
        out = capsys.readouterr().out
        assert "sequence throughput: 4 pairs in " in out and "(batch=2, depth=1, decode excluded)" in out

    def test_figures_land_where_the_root_clis_do(self, tmp_path, monkeypatch):
        frames = _frames(3, 32, 40)
        _write_pngs(tmp_path / "data" / "clip", frames)
        _write_pngs(tmp_path / "data", frames[:2], stem="top_")
        made = {}
        for name, main, flag in (("port", port_cli.main, ["--device", "cpu"]),
                                 ("root", _root_cli().main, ["--platform", "cpu"])):
            work = tmp_path / name
            work.mkdir()
            monkeypatch.chdir(work)
            for pattern in ("../data/clip/frame_*.png", "../data/top_*.png"):
                main(["-i", pattern, *flag, *SMALL_FLAGS])
            made[name] = sorted(str(p.relative_to(work)) for p in work.rglob("*.png"))
        assert made["port"] == made["root"]
        assert made["port"] == ["test_figure/clip/frame_0001.png", "test_figure/clip/frame_0002.png",
                                "test_figure/data/top_0001.png"]
        assert port_cli.figure_path("a.png") == ("seq", "a")

    def test_resume_takes_a_tf_checkpoint(self, tmp_path, monkeypatch):
        """``-r <prefix>.ckpt``: the figures' pyramids are those of a
        predictor loaded from the same bundle."""
        from test_tf_converter import _write_bundle

        import pwcnet_tpu_torch.utils as port_utils

        tree = jax.tree_util.tree_map(np.asarray, _jax_tree(seed=12))
        tensors = {"pwcdcnet/" + "/".join(k.key for k in p): v
                   for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        prefix = _write_bundle(tmp_path, tensors)
        frames = _frames(3, 32, 40, seed=8)
        paths = _write_pngs(tmp_path / "clip", frames)
        shown = []
        monkeypatch.setattr(port_utils, "vis_flow_pyramid", lambda pyr, images, filename: shown.append(pyr))
        monkeypatch.chdir(tmp_path)
        port_cli.main(["-i", *paths, "-r", str(prefix), "--device", "cpu", "--batch", "2", *SMALL_FLAGS])
        pred = FlowPredictor(checkpoint=str(prefix), device="cpu", **SMALL)
        assert len(shown) == 2
        for i, pyramid in enumerate(shown):
            for a, b in zip(pyramid, pred(frames[i], frames[i + 1])[1]):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
