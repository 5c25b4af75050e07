"""The port's data package against the JAX package's, on the CPU.

For the same (seed, epoch, sample) the port's ``DataLoader`` must yield the
bytes the JAX package's does: on the PIL, native (C++) and raw-cache paths,
with random crop and flip, across a resume partway through an epoch, and per
process slice. Datasets are written here from a numpy seed (FlyingChairs
layout with PPM frames, Sintel layout with PNG frames). Equality is exact
(``np.array_equal``): both packages decode losslessly and divide by 255 in
float32; nothing is summed.

``device_prefetch`` on the CPU must hand over the values the JAX one puts on
its device (a uint8 feed divided by 255 in float32 by both), and an error of
the producer thread must surface in the consumer.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from pwcnet_tpu import data as jax_data
from pwcnet_tpu.data import cache as jax_cache
from pwcnet_tpu_torch import data as port_data
from pwcnet_tpu_torch.data import cache as port_cache
from pwcnet_tpu_torch.data import native as port_native
from pwcnet_tpu_torch.utils import save_flow

PATHS = {
    "pil": dict(use_native=False, use_cache=False),
    "native": dict(use_native=True, use_cache=False),
    "cache": dict(use_native=False, use_cache=True),
}


def _make_chairs(root, n=20, hw=(32, 40)):
    rng = np.random.default_rng(0)
    data = root / "data"
    data.mkdir(parents=True)
    for i in range(1, n + 1):
        for tag in ("img1", "img2"):
            Image.fromarray((rng.random(hw + (3,)) * 255).astype(np.uint8)).save(data / f"{i:05d}_{tag}.ppm")
        save_flow(data / f"{i:05d}_flow.flo", rng.standard_normal(hw + (2,)).astype(np.float32))


def _make_sintel(root, scenes=("alley_1", "alley_2"), frames=5, hw=(36, 48)):
    rng = np.random.default_rng(1)
    for scene in scenes:
        img_dir = root / "training" / "clean" / scene
        flow_dir = root / "training" / "flow" / scene
        img_dir.mkdir(parents=True)
        flow_dir.mkdir(parents=True)
        for t in range(1, frames + 1):
            Image.fromarray((rng.random(hw + (3,)) * 255).astype(np.uint8)).save(img_dir / f"frame_{t:04d}.png")
            if t < frames:
                save_flow(flow_dir / f"frame_{t:04d}.flo", rng.standard_normal(hw + (2,)).astype(np.float32))


@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chairs")
    _make_chairs(root)
    return root


@pytest.fixture(scope="module")
def sintel(tmp_path_factory):
    root = tmp_path_factory.mktemp("sintel")
    _make_sintel(root)
    return root


def _loaders(name, root, path, cache_dirs=None, loader_kwargs=None, **ds_kwargs):
    """(JAX loader, port loader) over the same files with the same settings."""
    ds_kwargs = dict(dict(train_or_val="train", dataset_dir=root, crop_type="random", crop_shape=(24, 32),
                          random_flip=True, seed=3), **ds_kwargs)
    kw = dict(dict(batch_size=4, shuffle=True, num_workers=2, seed=3), **(loader_kwargs or {}), **PATHS[path])
    out = []
    for pkg, cache_mod, tag in ((jax_data, jax_cache, "jax"), (port_data, port_cache, "port")):
        ds = pkg.get_dataset(name)(**ds_kwargs)
        extra = {}
        if path == "cache":
            # each package builds and opens its own cache: the files must agree too
            extra["cache_dir"] = cache_mod.build_cache(ds, cache_dirs / f"{tag}_{name}")
        out.append(pkg.DataLoader(ds, **kw, **extra))
    return out


def _assert_same_batches(a, b, expect=None):
    a, b = list(a), list(b)
    assert len(a) == len(b) and (expect is None or len(a) == expect)
    for (ia, fa), (ib, fb) in zip(a, b):
        assert ia.dtype == ib.dtype and fa.dtype == fb.dtype == np.float32
        assert np.array_equal(ia, ib) and np.array_equal(fa, fb)


class TestLoaderBytes:
    @pytest.mark.parametrize("path", list(PATHS))
    def test_chairs_two_epochs_with_crop_and_flip(self, chairs, tmp_path, path):
        jl, pl = _loaders("FlyingChairs", chairs, path, tmp_path)
        assert (pl._native is not None) == (path == "native") and (pl._cache is not None) == (path == "cache")
        assert len(pl) == len(jl) == 4  # 18 train samples, batches of 4, drop_last
        for epoch in range(2):
            assert pl.epoch == jl.epoch == epoch
            _assert_same_batches(jl, pl, expect=4)

    @pytest.mark.parametrize("path", list(PATHS))
    def test_sintel_png(self, sintel, tmp_path, path):
        jl, pl = _loaders("SintelClean", sintel, path, tmp_path, loader_kwargs=dict(batch_size=3))
        _assert_same_batches(jl, pl, expect=2)  # 2 scenes x 4 pairs, none to val: 8 train, the last 2 dropped

    @pytest.mark.parametrize("path", list(PATHS))
    def test_resume_partway_through_an_epoch(self, chairs, tmp_path, path):
        """epoch / start_batch position the port's loader where the JAX
        loader is after the same number of batches."""
        jl, pl = _loaders("FlyingChairs", chairs, path, tmp_path)
        jl.epoch = 2
        whole = list(jl)
        pl.epoch, pl.start_batch = 2, 2
        rest = list(pl)
        assert len(whole) == 4 and len(rest) == 2 and pl.start_batch == 0 and pl.epoch == 3
        _assert_same_batches(whole[2:], rest)

    @pytest.mark.parametrize("path", ["pil", "native"])
    def test_process_slices(self, chairs, tmp_path, path):
        seen = []
        for rank in range(2):
            jl, pl = _loaders("FlyingChairs", chairs, path, tmp_path,
                              loader_kwargs=dict(process_index=rank, process_count=2, batch_size=3))
            assert np.array_equal(pl.epoch_order(1), jl.epoch_order(1))
            seen.append(set(pl.epoch_order(1).tolist()))
            _assert_same_batches(jl, pl, expect=3)
        assert not seen[0] & seen[1] and len(seen[0] | seen[1]) == 18

    @pytest.mark.parametrize("crop_type,flip", [("center", False), ("none", True)])
    def test_other_crops(self, chairs, tmp_path, crop_type, flip):
        for path in ("pil", "native"):
            jl, pl = _loaders("FlyingChairs", chairs, path, tmp_path, crop_type=crop_type, random_flip=flip)
            _assert_same_batches(jl, pl, expect=4)

    @pytest.mark.parametrize("normalize", [False, "device"])
    def test_uint8_feeds(self, chairs, tmp_path, normalize):
        path = "cache" if normalize == "device" else "pil"
        jl, pl = _loaders("FlyingChairs", chairs, path, tmp_path, loader_kwargs=dict(normalize=normalize))
        first = next(iter(pl))[0]
        assert first.dtype == np.uint8
        _assert_same_batches(jl, pl)

    def test_validation_split_and_resize(self, chairs, tmp_path):
        jl, pl = _loaders("FlyingChairs", chairs, "pil", tmp_path, train_or_val="val", crop_type="none",
                          crop_shape=None, resize_scale=0.5, loader_kwargs=dict(batch_size=2, shuffle=False))
        assert pl.dataset.image_size == jl.dataset.image_size == (16, 20)
        _assert_same_batches(jl, pl, expect=1)

    def test_invalid_settings_raise(self, chairs):
        ds = port_data.FlyingChairs("train", chairs, crop_shape=(24, 32))
        with pytest.raises(ValueError, match="normalize"):
            port_data.DataLoader(ds, 2, normalize="host")
        with pytest.raises(ValueError, match="process_index"):
            port_data.DataLoader(ds, 2, process_index=2, process_count=2)
        with pytest.raises(ValueError, match="no valid cache"):
            port_data.DataLoader(ds, 2, use_cache=True)
        with pytest.raises(KeyError, match="Unknown dataset"):
            port_data.get_dataset("Middlebury")
        with pytest.raises(FileNotFoundError):
            port_data.SintelClean("train", chairs)


class TestSyntheticFlow:
    @pytest.mark.parametrize("split", ["train", "val"])
    def test_equal_sample_by_sample(self, split):
        kw = dict(train_or_val=split, num_samples=6, image_shape=(18, 22), max_disp=3, seed=5)
        a, b = jax_data.SyntheticFlow(**kw), port_data.SyntheticFlow(**kw)
        assert a.samples == b.samples and a.image_size == b.image_size
        for i in range(6):
            (ia, fa), (ib, fb) = a[i], b[i]
            assert np.array_equal(ia, ib) and np.array_equal(fa, fb)

    def test_loader_with_flip(self):
        kw = dict(num_samples=8, image_shape=(16, 16), random_flip=True, seed=2)
        jl = jax_data.DataLoader(jax_data.SyntheticFlow(**kw), 4, shuffle=True, seed=2)
        pl = port_data.DataLoader(port_data.SyntheticFlow(**kw), 4, shuffle=True, seed=2)
        _assert_same_batches(jl, pl, expect=2)


class TestNativeAndCache:
    def test_library_is_the_ports_own_build(self, chairs):
        lib_path = port_native.library_path()
        port_native.load_library()
        assert lib_path.is_file() and lib_path.parent.name == "build"
        assert lib_path.parent.parent.name == "pwcnet_tpu_torch"
        ds = port_data.FlyingChairs("train", chairs, crop_type="none", crop_shape=None)
        assert port_native.image_size(ds.samples[0][0]) == (32, 40)
        from pwcnet_tpu_torch.utils import load_flow

        assert np.array_equal(port_native.read_flo(ds.samples[0][2]), load_flow(ds.samples[0][2]))

    def test_a_cache_built_by_either_package_opens_in_the_other(self, chairs, tmp_path):
        ds_j = jax_data.FlyingChairs("train", chairs, crop_shape=(24, 32))
        ds_p = port_data.FlyingChairs("train", chairs, crop_shape=(24, 32))
        by_port = port_cache.build_cache(ds_p, tmp_path / "p")
        by_jax = jax_cache.build_cache(ds_j, tmp_path / "j")
        for name in ("frames.u8", "flows.f32"):
            assert (by_port / name).read_bytes() == (by_jax / name).read_bytes()
        assert isinstance(port_cache.open_cache(ds_p, by_jax), port_cache.RawCache)
        assert jax_cache.open_cache(ds_j, by_port) is not None
        # the numpy assembly equals the native one (which multiplies by
        # 1/255 where numpy divides: one float32 ulp)
        cache = port_cache.open_cache(ds_p, by_port)
        args = ([0, 5, 7], (24, 32), [1, 2, 3], [0, 4, 8], [0, 1, 3])
        images, flows = cache.assemble(*args)
        cache._native = None
        images_np, flows_np = cache.assemble(*args)
        np.testing.assert_allclose(images, images_np, rtol=2e-7, atol=0)
        assert np.array_equal(flows, flows_np)
        assert port_cache.open_cache(port_data.FlyingChairs("val", chairs, crop_shape=(24, 32)), by_port) is None


class TestDevicePrefetch:
    def test_cpu_values_equal_the_jax_prefetch(self, chairs, tmp_path):
        jl, pl = _loaders("FlyingChairs", chairs, "cache", tmp_path, loader_kwargs=dict(normalize="device"))
        got = list(port_data.device_prefetch(iter(pl), device="cpu"))
        want = list(jax_data.device_prefetch(iter(jl)))
        assert len(got) == len(want) == 4
        for (gi, gf), (wi, wf) in zip(got, want):
            assert isinstance(gi, torch.Tensor) and gi.dtype == torch.float32 and gi.device.type == "cpu"
            assert np.array_equal(gi.numpy(), np.asarray(wi)) and np.array_equal(gf.numpy(), np.asarray(wf))
            assert float(gi.max()) <= 1.0

    def test_float_feed_and_raw_uint8_pass_through(self):
        ds = port_data.SyntheticFlow(num_samples=4, image_shape=(16, 16))
        host = list(port_data.DataLoader(ds, 2))
        dev = list(port_data.device_prefetch(iter(port_data.DataLoader(ds, 2)), device="cpu"))
        for (hi, hf), (di, df) in zip(host, dev):
            assert np.array_equal(hi, di.numpy()) and np.array_equal(hf, df.numpy())
        raw = next(port_data.device_prefetch(iter(port_data.DataLoader(ds, 2, normalize=False)),
                                             device="cpu", device_normalize=False))
        assert raw[0].dtype == torch.uint8

    def test_a_producer_error_surfaces(self):
        def batches():
            yield np.zeros((1, 2, 4, 4, 3), np.float32), np.zeros((1, 4, 4, 2), np.float32)
            raise OSError("disk went away")

        it = port_data.device_prefetch(batches(), device="cpu")
        next(it)
        with pytest.raises(OSError, match="disk went away"):
            next(it)

    def test_no_device_means_the_gpu(self):
        """Like every entry point of the port: None is CUDA, and without a
        GPU it raises instead of yielding CPU tensors."""
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a GPU")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(port_data.device_prefetch(iter(())))


class TestLoaderPath:
    def test_path_names_the_batch_path(self, chairs):
        ds = port_data.FlyingChairs("train", chairs, crop_type="random", crop_shape=(24, 32))
        assert port_data.DataLoader(ds, 4).path == "native"
        assert port_data.DataLoader(ds, 4, use_native=False).path == "pil"
        assert port_data.DataLoader(port_data.SyntheticFlow(num_samples=4, image_shape=(16, 16)), 2).path == "pil"

    def test_a_library_that_fails_to_load_is_reported(self, chairs, monkeypatch):
        """'auto' goes on with PIL and warns; use_native=True raises."""
        def broken():
            raise port_native.NativeUnavailable("g++ build failed")

        monkeypatch.setattr(port_native, "load_library", broken)
        ds = port_data.FlyingChairs("train", chairs, crop_type="random", crop_shape=(24, 32))
        with pytest.warns(RuntimeWarning, match="native data loader unavailable"):
            assert port_data.DataLoader(ds, 4).path == "pil"
        with pytest.raises(port_native.NativeUnavailable):
            port_data.DataLoader(ds, 4, use_native=True)
