"""The CUDA kernel wrappers (pwcnet_tpu_torch.ops.cuda) and K3's plain version.

On the CPU each wrapper must hand a CPU tensor to its plain version and
launch nothing; K3's plain version is held against the JAX package's fused
pyramid-level kernel (interpret mode) and its XLA chain. The kernel-vs-
plain tests need an NVIDIA card: they carry the ``cuda`` marker and skip
here (``chip_smoke.py`` holds every kernel at the full-size shapes).

Tolerances: float32 on the CPU differs only in summation order, rtol=1e-5
and atol=1e-5 (the activations are O(1)). On the card, float32 with TF32
off differs likewise (atol 1e-5 at O(1) outputs); bfloat16 outputs are
rounded from float32 sums and may land one or two bf16 ulps apart
(2/128 of the output's scale).

The JAX package is imported inside the tests that compare with it, so the
card-only tests also run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.cuda import _build, _common, launch_counts, reset_launch_counts
from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import (
    pyramid_level_fused,
    pyramid_level_plain,
    same_pad_stride2,
)
from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume, warped_cost_volume_plain

torch.set_num_threads(1)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _level_params(rng, cin, c):
    """HWIO kernels scaled by fan-in (activations stay O(1)), biases."""
    out = []
    for ci in (cin, c, c):
        out.append(_normal(rng, (3, 3, ci, c), 1.0 / np.sqrt(9.0 * ci)))
        out.append(_normal(rng, (c,), 0.1))
    return out


def _to_torch_params(params):
    """HWIO -> OIHW for the kernels; biases as they are."""
    return [
        torch.from_numpy(np.ascontiguousarray(p.transpose(3, 2, 0, 1) if p.ndim == 4 else p))
        for p in params
    ]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds the kernels on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class TestPyramidLevelPlain:
    @pytest.mark.parametrize(
        "shape,c",
        [((1, 16, 24, 3), 16), ((2, 12, 16, 16), 32), ((1, 8, 10, 4), 8)],
    )
    def test_matches_jax_kernel_and_xla_chain(self, rng, shape, c):
        import jax.numpy as jnp

        from pwcnet_tpu.ops.pallas.pyramid_conv import _xla_level
        from pwcnet_tpu.ops.pallas.pyramid_conv import pyramid_level_fused as jax_pyramid_level_fused

        x = _normal(rng, shape)
        params = _level_params(rng, shape[-1], c)
        got = pyramid_level_plain(torch.from_numpy(x), *_to_torch_params(params)).numpy()
        jparams = [jnp.asarray(p) for p in params]
        want_kernel = np.asarray(jax_pyramid_level_fused(jnp.asarray(x), *jparams, interpret=True))
        want_xla = np.asarray(_xla_level(jnp.asarray(x), *jparams))
        assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, c)
        np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)

    def test_symmetric_stride2_pad_would_fail(self, rng):
        """The stride-2 conv pads only bottom/right on even sizes; the
        symmetric padding=1 shifts every sample and is caught by the
        tolerance above."""
        import jax.numpy as jnp

        from pwcnet_tpu.ops.pallas.pyramid_conv import _xla_level

        x = _normal(rng, (1, 8, 12, 3))
        params = _level_params(rng, 3, 8)
        tp = _to_torch_params(params)
        want = np.asarray(_xla_level(jnp.asarray(x), *[jnp.asarray(p) for p in params]))
        y = torch.from_numpy(x).permute(0, 3, 1, 2)
        y = F.leaky_relu(F.conv2d(y, tp[0], tp[1], stride=2, padding=1), 0.1)
        y = F.leaky_relu(F.conv2d(y, tp[2], tp[3], padding=1), 0.1)
        y = F.leaky_relu(F.conv2d(y, tp[4], tp[5], padding=1), 0.1)
        wrong = y.permute(0, 2, 3, 1).numpy()
        assert wrong.shape == want.shape
        assert np.abs(wrong - want).max() > 1e-2
        got = pyramid_level_plain(torch.from_numpy(x), *tp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_bfloat16_rounds_between_convs(self, rng):
        x = torch.from_numpy(_normal(rng, (1, 8, 8, 3))).bfloat16()
        tp = [p.bfloat16() for p in _to_torch_params(_level_params(rng, 3, 16))]
        got = pyramid_level_plain(x, *tp)
        assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 4, 16)
        # the float32 chain without the intermediate rounding differs
        unrounded = pyramid_level_plain(x.float(), *[p.float() for p in tp])
        assert torch.allclose(got.float(), unrounded, rtol=2e-2, atol=2e-2)

    @pytest.mark.parametrize(
        "h,w,pads",
        [(16, 24, (0, 1, 0, 1)), (7, 9, (1, 1, 1, 1)), (6, 5, (1, 1, 0, 1)), (1, 2, (0, 1, 1, 1))],
    )
    def test_same_pad_stride2(self, h, w, pads):
        assert same_pad_stride2(h, w) == pads


class TestWrappersOnCpu:
    """A CPU tensor goes to the plain version; nothing launches."""

    def test_each_wrapper_routes_cpu_to_plain(self, rng):
        reset_launch_counts()
        f0 = torch.from_numpy(_normal(rng, (1, 6, 8, 4)))
        f1 = torch.from_numpy(_normal(rng, (1, 6, 8, 4)))
        flow = torch.from_numpy(_normal(rng, (1, 6, 8, 2), 2.0))
        assert torch.equal(cost_volume_cuda(f0, f1, 2), cost_volume(f0, f1, 2))
        assert torch.equal(warped_cost_volume(f0, f1, flow, 2), warped_cost_volume_plain(f0, f1, flow, 2))
        x = torch.from_numpy(_normal(rng, (1, 8, 8, 3)))
        tp = _to_torch_params(_level_params(rng, 3, 16))
        assert torch.equal(pyramid_level_fused(x, *tp), pyramid_level_plain(x, *tp))
        assert launch_counts() == {"K1": 0, "K2": 0, "K3": 0}

    def test_kernels_refuse_a_gradient(self):
        t = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="forward-only"):
            _common.check_no_grad("k", t)
        with torch.no_grad():
            _common.check_no_grad("k", t)

    def test_build_raises_without_nvcc(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(["cost_volume"])

    def test_library_path_tracks_the_source(self):
        paths = {name: _build.library_path(name) for name in _build.SOURCES}
        assert len(set(paths.values())) == len(_build.SOURCES)
        for name, p in paths.items():
            assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{name}-")
            assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build.library_path("cost_volume") == paths["cost_volume"]


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each kernel against its plain version on the card (small shapes)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,d", [((2, 9, 37, 40), 4), ((1, 7, 16, 192), 4), ((1, 5, 6, 3), 2)])
    def test_cost_volume(self, cuda_device, rng, dtype, shape, d):
        f0 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        f1 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        before = cost_volume_cuda.launches
        got = cost_volume_cuda(f0, f1, d)
        torch.cuda.synchronize()
        assert cost_volume_cuda.launches == before + 1
        _assert_close(got, cost_volume(f0, f1, d), dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,d", [((2, 14, 33, 32), 4), ((1, 10, 12, 5), 3)])
    def test_warped_cost_volume(self, cuda_device, rng, dtype, shape, d):
        f0 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        f1 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        flow = torch.from_numpy(_normal(rng, shape[:3] + (2,), 6.0)).to(cuda_device, dtype)
        before = warped_cost_volume.launches
        got = warped_cost_volume(f0, f1, flow, d)
        torch.cuda.synchronize()
        assert warped_cost_volume.launches == before + 1
        _assert_close(got, warped_cost_volume_plain(f0, f1, flow, d), dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,c", [((2, 20, 70, 3), 16), ((1, 18, 36, 16), 32)])
    def test_pyramid_level(self, cuda_device, rng, dtype, shape, c):
        x = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        tp = [p.to(cuda_device, dtype) for p in _to_torch_params(_level_params(rng, shape[-1], c))]
        before = pyramid_level_fused.launches
        got = pyramid_level_fused(x, *tp)
        torch.cuda.synchronize()
        assert pyramid_level_fused.launches == before + 1
        _assert_close(got, pyramid_level_plain(x, *tp), dtype)

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, cuda_device):
        x = torch.zeros((1, 8, 8, 16), device=cuda_device)
        with pytest.raises(ValueError):
            cost_volume_cuda(x, x, 5)
        with pytest.raises(ValueError):
            cost_volume_cuda(x[:, :, ::2], x[:, :, ::2], 4)
        with pytest.raises(TypeError):
            cost_volume_cuda(x.half(), x.half(), 4)
        k = torch.zeros((32, 16, 3, 3), device=cuda_device)
        b = torch.zeros((32,), device=cuda_device)
        kk = torch.zeros((32, 32, 3, 3), device=cuda_device)
        with pytest.raises(ValueError):
            pyramid_level_fused(x[:, :7], k, b, kk, b, kk, b)  # odd H


def _assert_close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    scale = w.abs().max().item()
    tol = 1e-5 * (1 + scale) if dtype == torch.float32 else 2 * scale / 128
    assert (g - w).abs().max().item() <= tol
