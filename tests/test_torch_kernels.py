"""The CUDA kernel wrappers (pwcnet_tpu_torch.ops.cuda) and K3's plain version.

On the CPU each wrapper must hand a CPU tensor to its plain version, let
a gradient flow through it under ordinary autograd, and launch nothing;
K3's plain version is held against the JAX package's fused pyramid-level
kernel (interpret mode) and its XLA chain. The kernel-vs-plain tests (K1-K9,
and the backward kernels under autograd) need an NVIDIA card: they carry
the ``cuda`` marker and skip where there is none (``chip_smoke.py`` holds
every kernel at the full-size shapes).

Tolerances: float32 on the CPU differs only in summation order, rtol=1e-5
and atol=1e-5 (the activations are O(1)). On the card, float32 with TF32
off differs likewise (atol 1e-5 at O(1) outputs); bfloat16 outputs are
rounded from float32 sums and may land one or two bf16 ulps apart
(2/128 of the output's scale; 4/128 for K6, whose three stages each read
the rounded cotangent of the stage before; K7's tensor-core chain is held
to 2/128 too, twice its worst reading at the full-size shapes).

The JAX package is imported inside the tests that compare with it, so the
card-only tests also run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.models.pwcnet import kernel_hooks
from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
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


def _chain_params(rng, cin, couts):
    """HWIO kernels and biases of an estimator chain, scaled by fan-in."""
    out = []
    for c in couts:
        out.append(_normal(rng, (3, 3, cin, c), 1.0 / np.sqrt(9.0 * cin)))
        out.append(_normal(rng, (c,), 0.1))
        cin = c
    return out


# (B, H, W, Cin), couts: the real widths, and narrow ones (hidden widths are
# multiples of 8) that leave every tile ragged
_CHAIN_CASES = [
    ((2, 6, 7, 273), (128, 128, 96, 64, 32, 2)),
    ((1, 12, 14, 37), (24, 16, 8, 8, 40, 3)),
    ((1, 19, 35, 147), (128, 128, 96, 64, 32, 2)),
    ((1, 6, 7, 147), (128, 128, 96, 64, 32, 2)),
    ((2, 9, 61, 273), (128, 128, 96, 64, 32, 2)),
]
# K3 levels whose half height and half width are no multiple of the bf16
# kernel's 8 x 64 tile (nor of the float32 kernel's 8 x 32)
_LEVEL_CASES = [
    ((2, 20, 70, 3), 16), ((1, 18, 36, 16), 32), ((1, 34, 150, 3), 16), ((2, 26, 140, 16), 32),
]


# the float32 estimator core at its real input widths on frames no 8 x 16
# tile divides (B, H, W, Cin): small grids take the narrow tiles, the last
# (over two waves of blocks) the wide ones
_F32_CHAIN_EDGE = [(1, 11, 37, 147), (2, 9, 21, 179), (1, 13, 45, 273), (8, 67, 150, 147)]
# float32 K3 at the edge shapes of chip_smoke.py (K3_EDGE) and at frames
# whose level output is smaller than one 14 x 28 tile
_F32_LEVEL_EDGE = [
    ((1, 34, 150, 3), 16), ((1, 26, 140, 16), 32), ((2, 10, 12, 3), 16), ((1, 8, 22, 16), 32), ((1, 2, 2, 16), 32),
]


# K6 levels whose half sizes no tile of its kernels divides (bf16 8 x 56;
# float32 16 x 28 at level 0, 12 x 28 at level 1), and a frame smaller than
# one tile at each level
_BWD_EDGE = [((1, 34, 150, 3), 16), ((2, 26, 130, 16), 32), ((1, 2, 2, 16), 32), ((1, 6, 10, 3), 16)]


# K4 at the five calls of the 384x448 training step (B=1; deep to fine)
_CV_BWD_TRAIN = [((1, 6, 7, 192), 4), ((1, 12, 14, 128), 4), ((1, 24, 28, 96), 4), ((1, 48, 56, 64), 4),
                 ((1, 96, 112, 32), 4)]


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
        counts = launch_counts()
        assert set(counts) == {"K1", "K2", "K3", "K4", "K5", "K6", "K7", "K7b", "K8", "K8b", "K9", "K9b", "R1"}
        assert not any(counts.values())

    def test_shard_wrappers_route_cpu_to_plain(self, rng):
        """K8, K8b, K9 and K9b on CPU tensors are their plain versions, and
        a gradient through K8 and K9 equals autograd through the plain
        compositions; nothing launches."""
        from pwcnet_tpu_torch.ops.cost_volume import cost_volume_hpad, cost_volume_hpad_bwd_plain
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_hpad_bwd, cost_volume_hpad_cuda
        from pwcnet_tpu_torch.ops.cuda.warped_cv import (
            warped_cost_volume_global, warped_cost_volume_global_bwd, warped_cost_volume_global_bwd_plain,
            warped_cost_volume_global_plain, warped_cost_volume_global_residual)

        reset_launch_counts()
        d, vb = 2, (-6, 11)  # the middle of three 6-row shards
        f0 = torch.from_numpy(_normal(rng, (1, 6, 8, 4))).requires_grad_()
        f1e = torch.from_numpy(_normal(rng, (1, 10, 8, 4))).requires_grad_()
        full = torch.from_numpy(_normal(rng, (1, 18, 8, 4))).requires_grad_()
        flow = torch.from_numpy(_normal(rng, (1, 10, 8, 2), 3.0))
        flow[..., 1] += 6.0
        flow.requires_grad_()
        out = cost_volume_hpad_cuda(f0, f1e, d)
        assert torch.equal(out, cost_volume_hpad(f0, f1e, d))
        g = torch.from_numpy(_normal(rng, tuple(out.shape)))
        want = cost_volume_hpad_bwd_plain(f0.detach(), f1e.detach(), out.detach(), g, d)
        for a, b, c in zip(torch.autograd.grad(out, [f0, f1e], g),
                           cost_volume_hpad_bwd(f0.detach(), f1e.detach(), out.detach(), g, d), want):
            assert torch.allclose(a, c, rtol=1e-5, atol=1e-6) and torch.equal(b, c)
        out = warped_cost_volume_global(f0, full, flow, vb, d)
        assert torch.equal(out, warped_cost_volume_global_plain(f0, full, flow, vb, d))
        with torch.no_grad():
            o, we = warped_cost_volume_global_residual(f0, full, flow, vb, d)
        assert we.shape == (1, 10, 8, 4) and torch.equal(o, out.detach())
        args = (f0.detach(), full.detach(), flow.detach(), vb, o, we, g, d)
        want = warped_cost_volume_global_bwd_plain(*args)
        for a, b, c in zip(torch.autograd.grad(out, [f0, full, flow], g), warped_cost_volume_global_bwd(*args), want):
            assert torch.allclose(a, c, rtol=1e-5, atol=1e-5) and torch.equal(b, c)
        assert not any(launch_counts().values())

    def test_a_gradient_flows_through_each_wrapper(self, rng):
        """On CPU tensors autograd runs through the plain versions: every
        wrapper's gradient equals its plain version's, and nothing launches."""
        reset_launch_counts()

        def leaf(shape, scale=1.0):
            return torch.from_numpy(_normal(rng, shape, scale)).requires_grad_()

        def grads(fn, args):
            out = fn(*args)
            g = torch.from_numpy(_normal(np.random.default_rng(1), tuple(out.shape)))
            return torch.autograd.grad(out, [a for a in args if isinstance(a, torch.Tensor)], g)

        f0, f1, flow = leaf((2, 6, 8, 4)), leaf((2, 6, 8, 4)), leaf((2, 6, 8, 2), 2.0)
        cases = [
            (cost_volume_cuda, cost_volume, (f0, f1, 2)),
            (warped_cost_volume, warped_cost_volume_plain, (f0, f1, flow, 2)),
            (pyramid_level_fused, pyramid_level_plain,
             (leaf((1, 8, 8, 3)), *[p.requires_grad_() for p in _to_torch_params(_level_params(rng, 3, 16))])),
        ]
        for wrapper, plain, args in cases:
            got, want = grads(wrapper, args), grads(plain, args)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.abs().max() > 0 and torch.equal(a, b), wrapper.__name__
        assert not any(launch_counts().values())

    def test_backward_wrappers_route_cpu_to_plain(self, rng):
        from pwcnet_tpu_torch.ops.cost_volume import cost_volume_bwd_plain
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_bwd
        from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_bwd, pyramid_level_bwd_plain
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd, warped_cost_volume_residual
        from pwcnet_tpu_torch.ops.warp import bilinear_warp, warp_bwd_plain

        reset_launch_counts()
        f0 = torch.from_numpy(_normal(rng, (1, 6, 8, 4)))
        f1 = torch.from_numpy(_normal(rng, (1, 6, 8, 4)))
        flow = torch.from_numpy(_normal(rng, (1, 6, 8, 2), 2.0))
        out, f1w = warped_cost_volume_residual(f0, f1, flow, 2)
        assert torch.equal(f1w, bilinear_warp(f1, flow)) and torch.equal(out, cost_volume(f0, f1w, 2))
        g = torch.from_numpy(_normal(rng, tuple(out.shape)))
        for a, b in zip(cost_volume_bwd(f0, f1w, out, g, 2), cost_volume_bwd_plain(f0, f1w, out, g, 2)):
            assert torch.equal(a, b)
        for a, b in zip(warp_bwd(f1, flow, f0), warp_bwd_plain(f1, flow, f0)):
            assert torch.equal(a, b)
        x = torch.from_numpy(_normal(rng, (1, 8, 8, 3)))
        k1, b1, k2, b2, k3, b3 = _to_torch_params(_level_params(rng, 3, 16))
        o, s1, s2 = pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts=True)
        gl = torch.from_numpy(_normal(rng, tuple(o.shape)))
        got = pyramid_level_bwd(x, k1, k2, k3, o, s1, s2, gl, need_dx=False)
        want = pyramid_level_bwd_plain(x, k1, k2, k3, o, s1, s2, gl, need_dx=False)
        assert got[3] is None and all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
        assert not any(launch_counts().values())

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
        # every header the sources include is hashed: an edit to one rebuilds them
        included = set()
        for name in _build.SOURCES:
            for line in (_build.CSRC / f"{name}.cu").read_text().splitlines():
                if line.startswith('#include "'):
                    included.add(line.split('"')[1])
        for header in _build.HEADERS:
            for line in (_build.CSRC / header).read_text().splitlines():
                if line.startswith('#include "'):
                    included.add(line.split('"')[1])
        assert "hopper.cuh" in included and included <= set(_build.HEADERS)


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
    @pytest.mark.parametrize("shape,c", _LEVEL_CASES)
    def test_pyramid_level(self, cuda_device, rng, dtype, shape, c):
        x = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        tp = [p.to(cuda_device, dtype) for p in _to_torch_params(_level_params(rng, shape[-1], c))]
        before = pyramid_level_fused.launches
        got = pyramid_level_fused(x, *tp)
        torch.cuda.synchronize()
        assert pyramid_level_fused.launches == before + 1
        _assert_close(got, pyramid_level_plain(x, *tp), dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,d", [((2, 9, 37, 40), 4), ((1, 6, 7, 192), 4), ((1, 5, 6, 3), 2)] + _CV_BWD_TRAIN
                             + [((1, 9, 13, 5), 1)])
    def test_cost_volume_bwd(self, cuda_device, rng, dtype, shape, d):
        """K4 in one launch, against its plain version; a rerun gives the
        same bits (no atomics: each output is one ordered sum)."""
        from pwcnet_tpu_torch.ops.cost_volume import cost_volume_bwd_plain
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_bwd

        f0 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        f1 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        out = cost_volume(f0, f1, d)
        g = torch.from_numpy(_normal(rng, tuple(out.shape))).to(cuda_device, dtype)
        before = cost_volume_bwd.launches
        got = cost_volume_bwd(f0, f1, out, g, d)
        torch.cuda.synchronize()
        assert cost_volume_bwd.launches == before + 1
        for a, b in zip(got, cost_volume_bwd_plain(f0, f1, out, g, d)):
            _assert_close(a, b, dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, cost_volume_bwd(f0, f1, out, g, d)))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,fscale", [((2, 14, 33, 32), 3.0), ((1, 10, 12, 5), 40.0), ((1, 12, 14, 128), 0.4),
                                              ((1, 9, 13, 40), 6.0), ((2, 8, 10, 96), 3.0), ((1, 5, 7, 304), 3.0)])
    def test_warp_bwd(self, cuda_device, rng, dtype, shape, fscale):
        """K5 in one launch, against its plain version: a whole warp a
        pixel (32, 40, 96, 128: lanes that loop), 8 lanes of which 3 idle
        (5) and lanes that loop ten times (304); a second launch gives the
        same bits (df1 summed in fixed point)."""
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd
        from pwcnet_tpu_torch.ops.warp import warp_bwd_plain

        f1 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        g = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        flow = torch.from_numpy(_normal(rng, shape[:3] + (2,), fscale)).to(cuda_device, dtype)
        before = warp_bwd.launches
        got = warp_bwd(f1, flow, g)
        torch.cuda.synchronize()
        assert warp_bwd.launches == before + 1
        for a, b in zip(got, warp_bwd_plain(f1, flow, g)):
            _assert_close(a, b, dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, warp_bwd(f1, flow, g)))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("warp_type", ["bilinear", "nearest"])
    @pytest.mark.parametrize("shape", [(8, 12, 14, 128), (8, 24, 28, 96), (8, 48, 56, 64), (8, 96, 112, 32)])
    def test_plain_warp_backward_is_bitwise(self, cuda_device, rng, dtype, warp_type, shape):
        """The plain warp's backward (the gather's transpose, a sorted
        ``index_put_``) at the four warped levels of the 384x448 training
        step, B=8, with edge pixels clamped onto the border: two backwards
        give the same bits, and they equal the CPU's within the tolerance."""
        from pwcnet_tpu_torch.ops.warp import warp

        x = _normal(rng, shape)
        flow = _normal(rng, shape[:3] + (2,), 3.0)
        flow[:, :, :2, 0] = -40.0  # two columns onto the left border
        g = _normal(rng, shape)

        def grads(device):
            a = torch.from_numpy(x).to(device, dtype).requires_grad_()
            f = torch.from_numpy(flow).to(device).requires_grad_()
            leaves = (a, f) if warp_type == "bilinear" else (a,)
            return torch.autograd.grad(warp(a, f, warp_type), leaves, torch.from_numpy(g).to(device, dtype))

        first, second = grads(cuda_device), grads(cuda_device)
        assert all(torch.equal(p, q) for p, q in zip(first, second))
        for got, want in zip(first, grads("cpu")):
            _assert_close(got.cpu(), want, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("case", ["nan", "+inf", "-inf", "+inf and -inf"])
    @pytest.mark.parametrize("kid", ["K5", "K9b"])
    def test_warp_bwd_non_finite_g(self, cuda_device, rng, dtype, case, kid):
        """NaN in g, or +Inf and -Inf whose corners meet, give NaN; +Inf or
        -Inf alone the infinity: element by element the class of the plain
        version's float32 sum, the finite elements within tolerance, the
        same bits in a second launch."""
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd, warped_rows_bwd, warped_rows_bwd_plain
        from pwcnet_tpu_torch.ops.warp import warp_bwd_plain

        b, h, w, c, d = 2, 8, 9, 40, 2
        f1 = torch.from_numpy(_normal(rng, (b, h, w, c))).to(cuda_device, dtype)
        ho = h if kid == "K5" else h // 2 + 2 * d
        flow = torch.from_numpy(0.3 + 0.2 * rng.random((b, ho, w, 2)).astype(np.float32)).to(cuda_device)
        g = torch.from_numpy(_normal(rng, (b, ho, w, c))).to(cuda_device, dtype)
        row = 3 + d if kid == "K9b" else 3
        if case == "+inf and -inf":  # corners p, p+1, p+W, p+W+1: two elements meet
            g[1, row, 4, 7], g[1, row, 5, 7] = float("inf"), float("-inf")
        else:
            g[1, row, 4, 7] = {"nan": float("nan"), "+inf": float("inf"), "-inf": float("-inf")}[case]
        if kid == "K5":
            flow = flow.to(dtype)
            run, plain = (lambda: warp_bwd(f1, flow, g)), (lambda: warp_bwd_plain(f1, flow, g))
        else:
            vb = (0, h - 1)  # the first of two shards of an h-row frame: rows [-d, h/2 + d) read the frame
            run = lambda: warped_rows_bwd(f1, flow, vb, g, d)  # noqa: E731
            plain = lambda: warped_rows_bwd_plain(f1, flow, vb, g.clone(), d)  # noqa: E731
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}  # bits: NaN equals itself
        assert all(torch.equal(a.view(ints[a.dtype]), e.view(ints[e.dtype])) for a, e in zip(got, again))
        df1, want_df1 = got[0].float(), want[0].float()
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(df1), test(want_df1))
        bad = ~torch.isfinite(want_df1)
        assert bad.sum().item() == (6 if case == "+inf and -inf" else 4)
        _assert_close(got[0][~bad], want[0][~bad], dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kid", ["K5", "K9b"])
    def test_warp_bwd_each_image_its_own_scale(self, cuda_device, rng, dtype, kid):
        """One image's g at 1e-8 of the others': each image's df1 and dflow
        have the bits of a call on that image alone, and the small image's
        df1 is within tolerance of its own scale (float32 1e-5 of its
        largest entry, bf16 2 ulps) of the plain version."""
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd, warped_rows_bwd, warped_rows_bwd_plain
        from pwcnet_tpu_torch.ops.warp import warp_bwd_plain

        b, h, w, c, d = 3, 24, 28, 16, 4
        f1 = torch.from_numpy(_normal(rng, (b, h, w, c))).to(cuda_device, dtype)
        ho = h if kid == "K5" else h // 2 + 2 * d
        flow = torch.from_numpy(_normal(rng, (b, ho, w, 2), 3.0)).to(cuda_device)
        g = torch.from_numpy(_normal(rng, (b, ho, w, c))).to(cuda_device, dtype)
        g[1] *= 1e-8
        if kid == "K5":
            flow = flow.to(dtype)
            run = lambda i: warp_bwd(f1[i], flow[i], g[i])  # noqa: E731
            want = warp_bwd_plain(f1, flow, g)[0]
        else:
            vb = (0, h - 1)
            run = lambda i: warped_rows_bwd(f1[i], flow[i], vb, g[i], d)  # noqa: E731
            want = warped_rows_bwd_plain(f1, flow, vb, g.clone(), d)[0]
        got = run(slice(None))
        for i in range(b):
            assert all(torch.equal(a[i : i + 1], e) for a, e in zip(got, run(slice(i, i + 1))))
        scale = want[1].float().abs().max().item()
        tol = 1e-5 * scale if dtype == torch.float32 else 2 * scale / 128
        assert (got[0][1].float() - want[1].float()).abs().max().item() <= tol

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("need_dx", [True, False])
    @pytest.mark.parametrize("shape,c", [((2, 20, 70, 3), 16), ((1, 18, 36, 16), 32), *_BWD_EDGE])
    def test_pyramid_level_bwd(self, cuda_device, rng, dtype, need_dx, shape, c):
        """K6 at both levels, with and without dx, at half sizes that no
        tile of its kernels divides (bf16: 8 x 56; float32: 16 x 28 and
        12 x 28) and at frames under one tile; two launches on the same
        inputs give the same bits."""
        from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_bwd, pyramid_level_bwd_plain

        x = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        k1, b1, k2, b2, k3, b3 = [p.to(cuda_device, dtype) for p in _to_torch_params(_level_params(rng, shape[-1], c))]
        out, s1, s2 = pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts=True)
        g = torch.from_numpy(_normal(rng, tuple(out.shape))).to(cuda_device, dtype)
        args = (x, k1, k2, k3, out, s1, s2, g)
        before = pyramid_level_bwd.launches
        got = pyramid_level_bwd(*args, need_dx=need_dx)
        again = pyramid_level_bwd(*args, need_dx=need_dx)
        torch.cuda.synchronize()
        assert pyramid_level_bwd.launches == before + 2
        for a, b, r in zip(got, pyramid_level_bwd_plain(*args, need_dx=need_dx), again):
            if b is None:
                assert a is None and r is None
                continue
            _assert_close(a, b, dtype, ulps=4)  # each stage reads the rounded cotangent before it
            assert torch.equal(a, r)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("c", [3, 5, 40, 192])
    @pytest.mark.parametrize("d", [1, 2, 3, 4])
    @pytest.mark.parametrize("b,h,w", [(1, 5, 6), (8, 7, 16), (1, 11, 37), (8, 14, 33)])
    def test_correlation_core(self, cuda_device, rng, dtype, c, d, b, h, w):
        """The correlation kernel under its four Loaders at every tile
        width and cluster split the plan picks (frames under one tile
        included): K2, K1 with its warped map f1w, K8 on halo rows, K9 with
        its warped rows f1w_ext, each against its plain version; two
        launches on the same inputs give the same bits."""
        from pwcnet_tpu_torch.ops.cost_volume import cost_volume_hpad
        from pwcnet_tpu_torch.ops.cuda._common import correlation_plan
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_hpad_cuda
        from pwcnet_tpu_torch.ops.cuda.warped_cv import (
            warped_cost_volume_global_plain, warped_cost_volume_global_residual, warped_cost_volume_residual)
        from pwcnet_tpu_torch.ops.warp import bilinear_warp, masked_warp_rows

        def t(shape, scale=1.0):
            return torch.from_numpy(_normal(rng, shape, scale)).to(cuda_device, dtype)

        assert correlation_plan(w, c)[1] in (1, 2, 4, 8)
        f0, f1, flow = t((b, h, w, c)), t((b, h, w, c)), t((b, h, w, 2), 4.0)
        got = cost_volume_cuda(f0, f1, d)
        _assert_close(got, cost_volume(f0, f1, d), dtype)
        assert torch.equal(got, cost_volume_cuda(f0, f1, d))
        out, f1w = warped_cost_volume_residual(f0, f1, flow, d)
        _assert_close(f1w, bilinear_warp(f1, flow), dtype)
        _assert_close(out, warped_cost_volume_plain(f0, f1, flow, d), dtype)
        out2, f1w2 = warped_cost_volume_residual(f0, f1, flow, d)
        assert torch.equal(out, out2) and torch.equal(f1w, f1w2)
        f1e = t((b, h + 2 * d, w, c))
        got = cost_volume_hpad_cuda(f0, f1e, d)
        _assert_close(got, cost_volume_hpad(f0, f1e, d), dtype)
        assert torch.equal(got, cost_volume_hpad_cuda(f0, f1e, d))
        # the middle one of three shards: flows reach both neighbours
        full = t((b, 3 * h, w, c))
        flow_ext = torch.from_numpy(_normal(rng, (b, h + 2 * d, w, 2), 4.0)).to(cuda_device)
        flow_ext[..., 1] += h
        vb = (-h, 2 * h - 1)
        out, we = warped_cost_volume_global_residual(f0, full, flow_ext, vb, d)
        _assert_close(out, warped_cost_volume_global_plain(f0, full, flow_ext, vb, d), dtype)
        _assert_close(we, masked_warp_rows(full, flow_ext, vb, d), dtype)
        out2, we2 = warped_cost_volume_global_residual(f0, full, flow_ext, vb, d)
        assert torch.equal(out, out2) and torch.equal(we, we2)

    def test_autograd_runs_the_backward_kernels(self, cuda_device, rng):
        """A gradient through K1-K3 on CUDA tensors launches K4-K6 and
        equals ordinary autograd through the plain versions."""
        def leaf(shape, scale=1.0):
            return torch.from_numpy(_normal(rng, shape, scale)).to(cuda_device).requires_grad_()

        f0, f1, flow = leaf((2, 12, 14, 32)), leaf((2, 12, 14, 32)), leaf((2, 12, 14, 2), 2.0)
        params = [p.to(cuda_device).requires_grad_() for p in _to_torch_params(_level_params(rng, 3, 16))]
        cases = [
            (cost_volume_cuda, cost_volume, (f0, f1, 4), {"K2": 1, "K4": 1}),
            (warped_cost_volume, warped_cost_volume_plain, (f0, f1, flow, 4), {"K1": 1, "K4": 1, "K5": 1}),
            (pyramid_level_fused, pyramid_level_plain, (leaf((1, 16, 24, 3)), *params), {"K3": 1, "K6": 1}),
        ]
        for wrapper, plain, args, launches in cases:
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            reset_launch_counts()
            out = wrapper(*args)
            g = torch.randn(out.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
            got = torch.autograd.grad(out, tensors, g)
            assert {k: v for k, v in launch_counts().items() if v} == launches
            want = torch.autograd.grad(plain(*args), tensors, g)
            for a, b in zip(got, want):
                _assert_close(a, b, torch.float32)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_remat_step_reruns_k3_and_k7(self, cuda_device, rng, dtype):
        """PWCDCNet(remat=True) with the kernels (K7 on 2 levels) at 128x192
        B=2: the loss as without remat (rtol 1e-6), the gradients within
        1e-4 of each tensor's largest entry in float32 (the backwards run
        other cuDNN calls) and at cosine 0.999 in bf16; K3 8, K7 4 and
        K7b 2 launches a step. Then batched_pyramid: K3 2 a forward, the
        flow as two pyramid calls give it."""
        from pwcnet_tpu_torch.models import PWCDCNet
        from pwcnet_tpu_torch.train_lib import make_loss_fn

        images = torch.from_numpy(rng.random((2, 2, 128, 192, 3)).astype(np.float32)).to(cuda_device)
        flows = torch.from_numpy(_normal(rng, (2, 128, 192, 2), 2.0)).to(cuda_device)
        hooks = dict(kernel_hooks(True, fused_estimator=2), compute_dtype=dtype)
        out = {}
        for remat in (False, True):
            model = PWCDCNet(remat=remat, **hooks).to(cuda_device)
            reset_launch_counts()
            total, _ = make_loss_fn(model, decoupled_wd=True)(images, flows)
            grads = torch.autograd.grad(total, list(model.parameters()))
            counts = {k: v for k, v in launch_counts().items() if v}
            assert counts == {"K1": 4, "K2": 1, "K3": 4 * (1 + remat), "K4": 5, "K5": 4, "K6": 4,
                              "K7": 2 * (1 + remat), "K7b": 2}
            out[remat] = total.detach(), grads
        torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-6, atol=0)
        if dtype == torch.float32:
            for a, b in zip(out[True][1], out[False][1]):
                assert (a - b).abs().max() <= 1e-4 * b.abs().max()
        else:
            a, b = (torch.cat([g.flatten() for g in out[k][1]]) for k in (True, False))
            assert F.cosine_similarity(a, b, dim=0) >= 0.999
        model = PWCDCNet(batched_pyramid=True, **hooks).to(cuda_device)
        with torch.no_grad():
            reset_launch_counts()
            got = model(images[:, 0], images[:, 1])[0]
            assert {k: v for k, v in launch_counts().items() if v} == {"K1": 4, "K2": 1, "K3": 2, "K7": 2}
            model.batched_pyramid = False
            want = model(images[:, 0], images[:, 1])[0]
        rtol = 1e-4 if dtype == torch.float32 else 5e-2
        assert (got - want).abs().max() <= rtol * want.abs().max() + 1e-4

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_predict_sequence_is_call(self, cuda_device, rng, dtype):
        """FlowPredictor.predict_sequence through the kernels (pinned staging,
        copies back, events, two dispatches in flight) against __call__ on
        every pair: the flow within 1e-4 of its scale in float32 and 5% in
        bf16 (chip_smoke.py's [serve] bounds), the frames equal; K1 4, K2 1
        and K3 4 launches a dispatch."""
        from pwcnet_tpu_torch.inference import FlowPredictor

        base = (rng.random((140, 220, 3)) * 255).astype(np.uint8)
        frames = [np.ascontiguousarray(base[2 * k : 2 * k + 128, 3 * k : 3 * k + 192]) for k in range(6)]
        pred = FlowPredictor(dtype=dtype, device=cuda_device)
        rtol = 1e-4 if dtype == torch.float32 else 5e-2
        for batch, depth, fetch in ((3, 2, "all"), (2, 1, "flow"), (8, 2, "flow")):
            reset_launch_counts()
            got = list(pred.predict_sequence(frames, depth=depth, batch=batch, fetch=fetch))
            n = -(-5 // batch)
            assert {k: v for k, v in launch_counts().items() if v} == {"K1": 4 * n, "K2": n, "K3": 4 * n}
            assert len(got) == 5
            for i, out in enumerate(got):
                want = pred(frames[i], frames[i + 1])
                flow = out[0] if fetch == "all" else out
                assert flow.shape == (128, 192, 2) and flow.dtype == np.float32
                assert np.abs(flow - want[0]).max() <= rtol * np.abs(want[0]).max() + 1e-4, (batch, i)
                if fetch == "all":
                    for a, b in zip(out[1], want[1]):
                        assert np.abs(a - b).max() <= rtol * np.abs(b).max() + 1e-4, (batch, i)
                    np.testing.assert_array_equal(out[2], want[2])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,couts", _CHAIN_CASES)
    def test_estimator_chain(self, cuda_device, rng, dtype, shape, couts):
        """K7 forward and its residuals, at sizes that are no multiple of a tile."""
        from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_fused, estimator_chain_residuals
        from pwcnet_tpu_torch.ops.estimator_conv import estimator_chain_plain

        xin = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        kbs = [p.to(cuda_device, dtype) for p in _to_torch_params(_chain_params(rng, shape[-1], couts))]
        before = estimator_chain_fused.launches
        flow, feat = estimator_chain_fused(xin, *kbs)
        flow2, feat2, acts = estimator_chain_residuals(xin, *kbs)
        torch.cuda.synchronize()
        assert estimator_chain_fused.launches == before + 2
        want_flow, want_feat, want_acts = estimator_chain_plain(xin, *kbs, return_acts=True)
        assert torch.equal(flow, flow2) and torch.equal(feat, feat2)
        _assert_close(flow, want_flow, dtype)  # 2 ulps: a flipped activation does not grow along the chain
        _assert_close(feat, want_feat, dtype)
        for a, b in zip(acts, want_acts):
            _assert_close(a, b, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,couts", _CHAIN_CASES)
    def test_estimator_chain_bwd(self, cuda_device, rng, dtype, shape, couts):
        """K7 backward: every gz_i (so dk, db) and dxin, not only dxin."""
        from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_bwd
        from pwcnet_tpu_torch.ops.estimator_conv import estimator_chain_bwd_plain, estimator_chain_plain

        xin = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        kbs = [p.to(cuda_device, dtype) for p in _to_torch_params(_chain_params(rng, shape[-1], couts))]
        flow, feat, acts = estimator_chain_plain(xin, *kbs, return_acts=True)
        g_flow = torch.from_numpy(_normal(rng, tuple(flow.shape))).to(cuda_device, dtype)
        g_feat = torch.from_numpy(_normal(rng, tuple(feat.shape))).to(cuda_device, dtype)
        args = (kbs[0::2], [*acts, feat], g_flow, g_feat)
        before = estimator_chain_bwd.launches
        gzs, dxin = estimator_chain_bwd(*args)
        gzs_nodx, nodx = estimator_chain_bwd(*args, need_dx=False)
        torch.cuda.synchronize()
        assert estimator_chain_bwd.launches == before + 2 and nodx is None
        want_gzs, want_dxin = estimator_chain_bwd_plain(*args)
        for a, b, c in zip(gzs, want_gzs, gzs_nodx):
            _assert_close(a, b, dtype)
            assert torch.equal(a, c)
        _assert_close(dxin, want_dxin, dtype)

    @pytest.mark.parametrize("cin,cout", [(147, 128), (16, 32), (32, 32), (37, 24), (32, 2), (16, 16)])
    def test_device_packer_matches_pack_wgmma(self, cuda_device, rng, cin, cout):
        """The bf16 kernels pack their weights on the card: the very layout
        of ``_common.pack_wgmma``, zero padding included."""
        from pwcnet_tpu_torch.ops.cuda import _common
        from pwcnet_tpu_torch.ops.cuda._common import I, P

        k = torch.from_numpy(_normal(rng, (cout, cin, 3, 3))).to(cuda_device, torch.bfloat16)
        want = _common.pack_wgmma(k)
        dst = torch.full((_common.packed_numel(cin, cout),), float("nan"), dtype=torch.bfloat16, device=cuda_device)
        _common.launch("estimator_conv", "pwc_pack_wgmma", [P, P, I, I, P], cuda_device,
                       k.data_ptr(), dst.data_ptr(), cin, cout)
        torch.cuda.synchronize()
        assert torch.equal(dst.view(want.shape), want)

    @pytest.mark.parametrize("cout,cin,mirror,k7", [
        (32, 32, True, False), (16, 16, True, False), (32, 16, False, False), (16, 3, False, False),
        # K7b's conv^T: dxin in N tiles above 128 (147..280 channels), the flow conv's 2 and 3 channels
        (128, 152, True, True), (128, 147, True, True), (128, 184, True, True), (128, 280, True, True),
        (128, 273, True, True), (24, 37, True, True), (2, 32, True, True), (3, 40, True, True),
        (64, 96, True, True)])
    def test_device_packer_transposes_for_k6(self, cuda_device, rng, cout, cin, mirror, k7):
        """K6 and K7b pack their transposed kernels on the card: the very
        layout of ``_common.pack_wgmma_transposed``, and for K7b of
        ``_common.transposed_tiles`` (N tiles of ``wgmma_tiles(cin)``)."""
        from pwcnet_tpu_torch.ops.cuda import _common
        from pwcnet_tpu_torch.ops.cuda._common import I, P

        k = torch.from_numpy(_normal(rng, (cout, cin, 3, 3))).to(cuda_device, torch.bfloat16)
        want = _common.transposed_tiles(k) if k7 else _common.pack_wgmma_transposed(k, mirror)
        dst = torch.full((want.numel(),), float("nan"), dtype=torch.bfloat16, device=cuda_device)
        if k7:
            _common.launch("estimator_conv_bwd", "pwc_pack_wgmma_transposed_tiles", [P, P, I, I, P], cuda_device,
                           k.data_ptr(), dst.data_ptr(), cout, cin)
        else:
            _common.launch("pyramid_conv_bwd", "pwc_pack_wgmma_transposed", [P, P, I, I, I, P], cuda_device,
                           k.data_ptr(), dst.data_ptr(), cout, cin, int(mirror))
        torch.cuda.synchronize()
        assert torch.equal(dst.view(want.shape), want)

    @pytest.mark.parametrize("shape,c", _LEVEL_CASES)
    def test_pyramid_level_residuals_and_autograd_bf16(self, cuda_device, rng, shape, c):
        """The bf16 kernel's residuals s1, s2 against the plain version, and
        a bf16 gradient through the wrapper: K3 then K6 on those very
        residuals, the same as calling K6 on them."""
        from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_bwd, pyramid_level_residuals

        dtype = torch.bfloat16
        x = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        tp = [p.to(cuda_device, dtype) for p in _to_torch_params(_level_params(rng, shape[-1], c))]
        out, s1, s2 = pyramid_level_residuals(x, *tp)
        want = pyramid_level_plain(x, *tp, return_acts=True)
        _assert_close(out, want[0], dtype, ulps=4)
        _assert_close(s1, want[1], dtype)
        _assert_close(s2, want[2], dtype, ulps=4)
        xg = x.clone().requires_grad_()
        g = torch.from_numpy(_normal(rng, tuple(out.shape))).to(cuda_device, dtype)
        reset_launch_counts()
        (dx,) = torch.autograd.grad(pyramid_level_fused(xg, *tp), [xg], g)
        torch.cuda.synchronize()
        assert {k: v for k, v in launch_counts().items() if v} == {"K3": 1, "K6": 1}
        assert torch.equal(dx, pyramid_level_bwd(x, tp[0], tp[2], tp[4], out, s1, s2, g)[3])

    @pytest.mark.parametrize("shape,couts", _CHAIN_CASES)
    def test_estimator_chain_autograd_bf16(self, cuda_device, rng, shape, couts):
        """A bf16 gradient through K7 (the input padded to a multiple of 8
        on the way in where it is not one) equals K7b on the forward's own
        residuals; the input's gradient has the input's shape and k1's
        gradient k1's."""
        from pwcnet_tpu_torch.ops.cuda.estimator_conv import (
            estimator_chain_bwd, estimator_chain_fused, estimator_chain_residuals)

        dtype = torch.bfloat16
        xin = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype).requires_grad_()
        kbs = [p.to(cuda_device, dtype).requires_grad_() for p in _to_torch_params(_chain_params(rng, shape[-1], couts))]
        reset_launch_counts()
        flow, feat = estimator_chain_fused(xin, *kbs)
        gen = torch.Generator(cuda_device).manual_seed(0)
        gs = [torch.randn(t.shape, device=cuda_device, generator=gen).to(dtype) for t in (flow, feat)]
        dxin, dk1 = torch.autograd.grad([flow, feat], [xin, kbs[0]], gs)
        torch.cuda.synchronize()
        assert {k: v for k, v in launch_counts().items() if v} == {"K7": 1, "K7b": 1}
        assert dxin.shape == xin.shape and dk1.shape == kbs[0].shape
        with torch.no_grad():
            f2, feat2, acts = estimator_chain_residuals(xin, *kbs)
            assert torch.equal(f2, flow) and torch.equal(feat2, feat)
            _, want = estimator_chain_bwd([k.detach() for k in kbs[0::2]], [*acts, feat2], *gs)
        assert torch.equal(dxin, want)

    def test_estimator_chain_autograd(self, cuda_device, rng):
        """A gradient through K7 launches its backward and equals ordinary
        autograd through the plain chain: dxin and all 12 kernels and biases."""
        from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_fused
        from pwcnet_tpu_torch.ops.estimator_conv import estimator_chain_plain

        shape, couts = _CHAIN_CASES[1]
        xin = torch.from_numpy(_normal(rng, shape)).to(cuda_device).requires_grad_()
        kbs = [p.to(cuda_device).requires_grad_() for p in _to_torch_params(_chain_params(rng, shape[-1], couts))]
        reset_launch_counts()
        flow, feat = estimator_chain_fused(xin, *kbs)
        gen = torch.Generator(cuda_device).manual_seed(0)
        gs = [torch.randn(t.shape, device=cuda_device, generator=gen) for t in (flow, feat)]
        got = torch.autograd.grad([flow, feat], [xin, *kbs], gs)
        assert {k: v for k, v in launch_counts().items() if v} == {"K7": 1, "K7b": 1}
        want = torch.autograd.grad(list(estimator_chain_plain(xin, *kbs)), [xin, *kbs], gs)
        for a, b in zip(got, want):
            _assert_close(a, b, torch.float32)

    @pytest.mark.parametrize("g_feat_zero", [False, True])
    @pytest.mark.parametrize("shape", _F32_CHAIN_EDGE)
    def test_estimator_chain_f32_tiles(self, cuda_device, rng, shape, g_feat_zero):
        """The float32 implicit-GEMM core at the estimator's widths on frames
        that no tile divides: the forward (N tiles 128, 128, 96, 64, 32 and 8
        for the flow, narrow and wide), its residuals, and K7b (dxin's Cout of
        147-273 over two or three N tiles) with and without a features'
        cotangent, each against its plain version; two launches give the
        same bits."""
        from pwcnet_tpu_torch.ops.cuda.estimator_conv import (
            estimator_chain_bwd, estimator_chain_fused, estimator_chain_residuals)
        from pwcnet_tpu_torch.ops.estimator_conv import estimator_chain_bwd_plain, estimator_chain_plain

        dtype = torch.float32
        couts = (128, 128, 96, 64, 32, 2)
        xin = torch.from_numpy(_normal(rng, shape)).to(cuda_device)
        kbs = [p.to(cuda_device) for p in _to_torch_params(_chain_params(rng, shape[-1], couts))]
        flow, feat = estimator_chain_fused(xin, *kbs)
        flow2, feat2, acts = estimator_chain_residuals(xin, *kbs)
        want_flow, want_feat, want_acts = estimator_chain_plain(xin, *kbs, return_acts=True)
        assert torch.equal(flow, flow2) and torch.equal(feat, feat2)
        for a, b in zip([flow, feat, *acts], [want_flow, want_feat, *want_acts]):
            _assert_close(a, b, dtype)
        g_flow = torch.from_numpy(_normal(rng, tuple(flow.shape))).to(cuda_device)
        g_feat = torch.zeros_like(feat) if g_feat_zero else torch.from_numpy(_normal(rng, tuple(feat.shape))).to(cuda_device)
        args = (kbs[0::2], [*want_acts, want_feat], g_flow, g_feat)
        gzs, dxin = estimator_chain_bwd(*args)
        want_gzs, want_dxin = estimator_chain_bwd_plain(*args)
        for a, b in zip([*gzs, dxin], [*want_gzs, want_dxin]):
            _assert_close(a, b, dtype)
        again = estimator_chain_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip([*gzs, dxin], [*again[0], again[1]]))
        assert torch.equal(estimator_chain_fused(xin, *kbs)[0], flow)

    @pytest.mark.parametrize("residuals", [False, True])
    @pytest.mark.parametrize("shape,c", _F32_LEVEL_EDGE)
    def test_pyramid_level_f32_tiles(self, cuda_device, rng, shape, c, residuals):
        """The float32 fused level at sizes no 14 x 28 tile divides and at a
        frame smaller than one tile, with and without the residuals s1, s2,
        against the plain version; two launches give the same bits."""
        from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_residuals

        dtype = torch.float32
        x = torch.from_numpy(_normal(rng, shape)).to(cuda_device)
        tp = [p.to(cuda_device) for p in _to_torch_params(_level_params(rng, shape[-1], c))]
        run = (lambda: pyramid_level_residuals(x, *tp)) if residuals else (lambda: (pyramid_level_fused(x, *tp),))
        got = run()
        want = pyramid_level_plain(x, *tp, return_acts=True)[: len(got)]
        for a, b in zip(got, want):
            _assert_close(a, b, dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, run()))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,d", [((2, 8, 37, 40), 4), ((1, 3, 16, 192), 4), ((1, 5, 6, 3), 2)])
    def test_cost_volume_hpad(self, cuda_device, rng, dtype, shape, d):
        """K8 and K8b: a shard's rows against f1 with d halo rows each side
        (3 rows at d=4: the halo is wider than the shard), df1_ext with them."""
        from pwcnet_tpu_torch.ops.cost_volume import cost_volume_hpad, cost_volume_hpad_bwd_plain
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_hpad_bwd, cost_volume_hpad_cuda

        b, h, w, c = shape
        f0 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        f1e = torch.from_numpy(_normal(rng, (b, h + 2 * d, w, c))).to(cuda_device, dtype)
        before = (cost_volume_hpad_cuda.launches, cost_volume_hpad_bwd.launches)
        got = cost_volume_hpad_cuda(f0, f1e, d)
        want = cost_volume_hpad(f0, f1e, d)
        _assert_close(got, want, dtype)
        g = torch.from_numpy(_normal(rng, tuple(want.shape))).to(cuda_device, dtype)
        grads = cost_volume_hpad_bwd(f0, f1e, want, g, d)
        torch.cuda.synchronize()
        assert (cost_volume_hpad_cuda.launches, cost_volume_hpad_bwd.launches) == (before[0] + 1, before[1] + 1)
        for a, e in zip(grads, cost_volume_hpad_bwd_plain(f0, f1e, want, g, d)):
            _assert_close(a, e, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shard", [0, 1, 2])
    @pytest.mark.parametrize("shape,d,fscale", [((2, 14, 33, 32), 4, 3.0), ((1, 10, 12, 5), 3, 40.0)])
    def test_warped_cost_volume_global(self, cuda_device, rng, dtype, shard, shape, d, fscale):
        """K9 and K9b at the top, middle and bottom of three shards, flows
        that reach across shards and out of the frame."""
        from pwcnet_tpu_torch.ops.cuda.warped_cv import (
            warped_cost_volume_global, warped_cost_volume_global_bwd, warped_cost_volume_global_bwd_plain,
            warped_cost_volume_global_plain, warped_cost_volume_global_residual)
        from pwcnet_tpu_torch.ops.warp import masked_warp_rows

        b, h, w, c = shape
        off = shard * h
        vb = (-off, 3 * h - 1 - off)
        f0 = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        full = torch.from_numpy(_normal(rng, (b, 3 * h, w, c))).to(cuda_device, dtype)
        flow = torch.from_numpy(_normal(rng, (b, h + 2 * d, w, 2), fscale)).to(cuda_device)
        flow[..., 1] += off
        before = launch_counts()
        got = warped_cost_volume_global(f0, full, flow, vb, d)
        out, we = warped_cost_volume_global_residual(f0, full, flow, vb, d)
        want = warped_cost_volume_global_plain(f0, full, flow, vb, d)
        _assert_close(got, want, dtype)
        assert torch.equal(got, out)
        _assert_close(we, masked_warp_rows(full, flow, vb, d), dtype)
        g = torch.from_numpy(_normal(rng, tuple(want.shape))).to(cuda_device, dtype)
        args = (f0, full, flow, vb, want, masked_warp_rows(full, flow, vb, d), g, d)
        grads = warped_cost_volume_global_bwd(*args)
        torch.cuda.synchronize()
        after = launch_counts()
        assert {k: after[k] - before[k] for k in ("K9", "K8b", "K9b")} == {"K9": 2, "K8b": 1, "K9b": 1}
        for a, e in zip(grads, warped_cost_volume_global_bwd_plain(*args)):
            _assert_close(a, e, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("c", [32, 5])
    def test_warped_rows_bwd_masks_without_writing(self, cuda_device, rng, dtype, c):
        """K9b reads the cotangent of the rows outside ``vb`` as zero and
        leaves ``dwe`` as it is; the plain version zeroes those rows."""
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_rows_bwd, warped_rows_bwd_plain

        b, h, w, d = 2, 6, 11, 4
        vb = (-h, 2 * h - 1 - h)  # the second of two shards
        full = torch.from_numpy(_normal(rng, (b, 2 * h, w, c))).to(cuda_device, dtype)
        flow = torch.from_numpy(_normal(rng, (b, h + 2 * d, w, 2), 4.0)).to(cuda_device)
        flow[..., 1] += h
        dwe = torch.from_numpy(_normal(rng, (b, h + 2 * d, w, c))).to(cuda_device, dtype)
        kept = dwe.clone()
        got = warped_rows_bwd(full, flow, vb, dwe, d)
        torch.cuda.synchronize()
        assert torch.equal(dwe, kept)
        want = warped_rows_bwd_plain(full, flow, vb, dwe.clone(), d)
        for a, e in zip(got, want):
            _assert_close(a, e, dtype)
        assert not got[1][:, h + d:].any()  # rows past the frame: no dflow
        assert all(torch.equal(a, e) for a, e in zip(got, warped_rows_bwd(full, flow, vb, dwe, d)))

    def test_autograd_runs_the_shard_kernels(self, cuda_device, rng):
        """A gradient through K8 and K9 launches K8b and K9b and equals
        ordinary autograd through the plain versions."""
        from pwcnet_tpu_torch.ops.cost_volume import cost_volume_hpad
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_hpad_cuda
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume_global, warped_cost_volume_global_plain

        def leaf(shape, scale=1.0, shift=0.0):
            t = torch.from_numpy(_normal(rng, shape, scale)).to(cuda_device)
            t[..., -1] += shift
            return t.requires_grad_()

        f0 = leaf((2, 6, 14, 32))
        cases = [
            (cost_volume_hpad_cuda, cost_volume_hpad, (f0, leaf((2, 14, 14, 32)), 4), {"K8": 1, "K8b": 1}),
            (warped_cost_volume_global, warped_cost_volume_global_plain,
             (f0, leaf((2, 18, 14, 32)), leaf((2, 14, 14, 2), 2.0, 6.0), (-6, 11), 4),
             {"K9": 1, "K9b": 1, "K8b": 1}),
        ]
        for wrapper, plain, args, launches in cases:
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            reset_launch_counts()
            out = wrapper(*args)
            g = torch.randn(out.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
            got = torch.autograd.grad(out, tensors, g)
            assert {k: v for k, v in launch_counts().items() if v} == launches
            want = torch.autograd.grad(plain(*args), tensors, g)
            for a, b in zip(got, want):
                _assert_close(a, b, torch.float32)

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


@pytest.mark.cuda
@pytest.mark.parametrize("loss_name", ["multiscale", "robust"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_warmed_train_step_never_waits_on_the_card(cuda_device, dtype, loss_name):
    """PWCDCNet wired as the trainer wires it on the card (K1 and K2 through
    the hooks, K3 on the fused levels, K4-K6 in the backward): after one
    step, a step issues nothing that waits on the card, which capturing it
    in a CUDA graph needs, and copies no index table up: the loss looks up
    its two tables a level (five levels) and builds none."""
    from pwcnet_tpu_torch.models import PWCDCNet
    from pwcnet_tpu_torch.ops.resize import reset_table_counts, table_counts
    from pwcnet_tpu_torch.train_lib import create_train_state, make_train_step

    model = PWCDCNet(**kernel_hooks(True), compute_dtype=None if dtype == torch.float32 else dtype)
    state = create_train_state(model, device=cuda_device)
    step = make_train_step(model, loss_name=loss_name)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.rand((2, 2, 128, 192, 3), generator=g, device=cuda_device)
    flows = torch.randn((2, 128, 192, 2), generator=g, device=cuda_device) * 4.0
    state, _ = step(state, images, flows)
    torch.cuda.synchronize()
    reset_table_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, images, flows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert table_counts() == {"lookups": 10, "uploads": 0}
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.fixture
def two_gpus():
    """Two cards or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (NCCL between ranks)")


def _nccl_ranks(task, tmp_path, inputs, cfg):
    """Run ``task`` of tests/_torch_spatial_worker.py in two NCCL ranks, one
    GPU each; return each rank's outputs."""
    import json
    import os
    import socket
    import subprocess
    import sys

    io = tmp_path / task
    io.mkdir()
    np.savez(io / "inputs.npz", **inputs)
    (io / "config.json").write_text(json.dumps({**cfg, "device": "cuda:{rank}", "backend": "nccl"}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_spatial_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, task, str(r), "2", str(port), str(io)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(io / f"out_{r}.npz")) for r in range(2)]


@pytest.mark.cuda
@pytest.mark.multigpu
def test_nccl_sharded_model_matches_unsharded(two_gpus, tmp_path):
    """Two NCCL ranks, one GPU each: the H-sharded model through the
    kernels (K3 on stripes, K8 at level 0, K9, and K8b/K9b in its backward)
    against the unsharded model on one card, the final flow (1e-4 of its
    scale) and the parameter gradient of sum(flow * g) summed over the ranks;
    then the first sharded train step (data 1 x spatial 2) against the
    unsharded step: its gradient, decay included, and its loss and EPE.
    Each gradient tensor within 1e-3 of its largest entry: float32 through
    about 50 layers, as the kernel path is held to the plain path in
    chip_smoke.py."""
    import json

    from pwcnet_tpu_torch.models import PWCDCNet
    from pwcnet_tpu_torch.prng import PRNGKey
    from pwcnet_tpu_torch.train_lib import make_loss_fn

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    model = PWCDCNet(key=PRNGKey(3))
    sd = {f"sd/{k}": v.numpy() for k, v in model.state_dict().items()}
    images = rng.random((2, 2, 512, 128, 3)).astype(np.float32)  # level 0: 4 rows a shard (K8)
    g = rng.standard_normal((2, 512, 128, 2)).astype(np.float32)
    flows = (rng.standard_normal((2, 512, 128, 2)) * 2).astype(np.float32)
    outs = _nccl_ranks("model", tmp_path, dict(images=images, g_final=g, **sd), {"model": {}})
    for o in outs:
        launches = json.loads(str(o["launches"]))
        assert all(launches[k] > 0 for k in ("K3", "K8", "K8b", "K9", "K9b")), launches
    steps = _nccl_ranks("train", tmp_path, dict(images=images, flows=flows, **sd),
                        {"model": {}, "data": 1, "spatial": 2, "lr": 1e-4,
                         "steps": 1, "losses": ["multiscale"]})

    ref = PWCDCNet(**kernel_hooks(True))
    ref.load_state_dict(model.state_dict())
    ref = ref.cuda()
    named = dict(ref.named_parameters())
    t = torch.from_numpy(images).cuda()
    flow, _ = ref(t[:, 0], t[:, 1])
    grads = torch.autograd.grad((flow * torch.from_numpy(g).cuda()).sum(), list(named.values()))
    want = flow.detach().cpu().numpy()
    for o in outs:
        assert np.abs(o["flows_final"] - want).max() <= 1e-4 * np.abs(want).max()
    objective, metrics = make_loss_fn(ref, decoupled_wd=True)(t, torch.from_numpy(flows).cuda())
    step_grads = torch.autograd.grad(objective, list(named.values()))
    for prefix, got, ws in (("grad/", outs[0], grads), ("multiscale/grad/", steps[0], step_grads)):
        for k, w in zip(named, ws):
            w = (w + 4e-4 * named[k].detach() if prefix != "grad/" else w).cpu().numpy()
            assert np.abs(got[prefix + k] - w).max() <= 1e-3 * np.abs(w).max() + 1e-7, prefix + k
    for k in ("loss", "epe"):
        np.testing.assert_allclose(steps[0][f"multiscale/step0/{k}"], float(metrics[k]), rtol=1e-4)
    assert all(o["multiscale/checksum_spread"] == 0.0 for o in steps)


def _assert_close(got, want, dtype, ulps=2):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    scale = w.abs().max().item()
    tol = 1e-5 * (1 + scale) if dtype == torch.float32 else ulps * scale / 128
    assert (g - w).abs().max().item() <= tol
