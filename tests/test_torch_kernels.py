"""The CUDA kernel wrappers (pwcnet_tpu_torch.ops.cuda) and K3's plain version.

On the CPU each wrapper must hand a CPU tensor to its plain version, let
a gradient flow through it under ordinary autograd, and launch nothing;
K3's plain version is held against the JAX package's fused pyramid-level
kernel (interpret mode) and its XLA chain. The kernel-vs-plain tests (K1-K7,
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
        assert launch_counts() == {k: 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K7b")}

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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,d", [((2, 9, 37, 40), 4), ((1, 6, 7, 192), 4), ((1, 5, 6, 3), 2)])
    def test_cost_volume_bwd(self, cuda_device, rng, dtype, shape, d):
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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,fscale", [((2, 14, 33, 32), 3.0), ((1, 10, 12, 5), 40.0), ((1, 12, 14, 128), 0.4)])
    def test_warp_bwd(self, cuda_device, rng, dtype, shape, fscale):
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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,c", [((2, 20, 70, 3), 16), ((1, 18, 36, 16), 32)])
    def test_pyramid_level_bwd(self, cuda_device, rng, dtype, shape, c):
        from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_bwd, pyramid_level_bwd_plain

        x = torch.from_numpy(_normal(rng, shape)).to(cuda_device, dtype)
        k1, b1, k2, b2, k3, b3 = [p.to(cuda_device, dtype) for p in _to_torch_params(_level_params(rng, shape[-1], c))]
        out, s1, s2 = pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts=True)
        g = torch.from_numpy(_normal(rng, tuple(out.shape))).to(cuda_device, dtype)
        before = pyramid_level_bwd.launches
        got = pyramid_level_bwd(x, k1, k2, k3, out, s1, s2, g)
        torch.cuda.synchronize()
        assert pyramid_level_bwd.launches == before + 1
        for a, b in zip(got, pyramid_level_bwd_plain(x, k1, k2, k3, out, s1, s2, g)):
            _assert_close(a, b, dtype, ulps=4)  # each stage reads the rounded cotangent before it

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

    def test_profiling_helpers_time_the_card(self, cuda_device, tmp_path):
        from pwcnet_tpu_torch.utils import profiling

        x = torch.randn((8, 64, 64, 64), device=cuda_device)
        sec = profiling.device_timeit(lambda a: a @ a, x, iters=5)
        assert 0 < sec < 1
        rows = profiling.op_profile(lambda a: a @ a, x, iters=2)
        assert rows and rows[0]["ms_per_iter"] > 0 and rows[0]["count"] >= 2
        with profiling.trace(str(tmp_path / "trace")):
            (x @ x).sum().item()
        assert (tmp_path / "trace" / "trace.json").stat().st_size > 0

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


def _assert_close(got, want, dtype, ulps=2):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    scale = w.abs().max().item()
    tol = 1e-5 * (1 + scale) if dtype == torch.float32 else ulps * scale / 128
    assert (g - w).abs().max().item() <= tol
