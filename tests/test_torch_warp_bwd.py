"""The warp backward (K5, and K9b on the tall frame) on the CPU.

The kernel (``csrc/warp_bwd.cu``) needs an NVIDIA card
(tests/test_torch_kernels.py, ``cuda`` marker); what decides its coverage
and what it computes is Python or mirrors Python, and is held here:

- the plain versions ``warp_bwd_plain`` and ``warp_rows_bwd_plain`` (row0 =
  -d) against ``torch.ops.aten.grid_sampler_2d_backward`` (bilinear, border,
  ``align_corners=True``), the library call ``chip_smoke.py`` times beside
  the kernel, in float32;
- K9b's row mask: the rows the kernel leaves out (``warp_bwd_live_rows``,
  the mask it folds into its scatter) are exactly the rows
  ``warped_rows_bwd_plain`` zeroes, and that backward equals the JAX
  package's (``_wcv_global_bwd``'s mask, then ``warp_bwd_pallas`` in
  interpret mode);
- a model of the launch (``_scatter``, mirroring ``warp_bwd_coop_kernel``'s
  thread decomposition): the lanes a pixel, the scalar tail, the
  persistent grid's stride cover every (pixel, channel) exactly once and
  write every dflow once, at the four training shapes, K9b's tall shapes
  and small odd C, and two neighbouring lanes fill each 32-byte sector a
  vector atomic touches; the zeroing and rounding phases cover the
  accumulator once; the constants the model shares with the source.

Tolerances. The plain versions and grid_sample's backward compute the same
function in float32 with another rounding of the sample position (the
library maps x to [-1, 1] and back): df1 within 2e-6 and dflow within
1e-5 of their largest entries (scales of 1-30 here; 4e-7 and 1.1e-6 of
the scale in a scratch check). The JAX comparison is float32 over a few
channels: rtol=1e-5, atol=1e-5 (dflow atol=1e-4, as test_torch_backward's
K5 comparison).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.ops.pallas.warped_cv import warp_bwd_pallas
from pwcnet_tpu_torch.ops.cuda import _build, _common
from pwcnet_tpu_torch.ops.cuda.warped_cv import _mask_rows, warped_rows_bwd_plain
from pwcnet_tpu_torch.ops.warp import warp_bwd_plain, warp_rows_bwd_plain

torch.set_num_threads(1)

T = _common.WARP_BWD_THREADS
D = 4
# (B, H, W, C) of K5's four calls in the 384x448 training step, deep to fine
TRAIN = [(8, 12, 14, 128), (8, 24, 28, 96), (8, 48, 56, 64), (8, 96, 112, 32)]
# K9b on one rank of 2: (B, h + 2d, Hf, W, C)
TALL = [(b, h // 2 + 2 * D, h, w, c) for b, h, w, c in TRAIN]
# resident blocks: the H100's 132 SMs at 2 and 4 blocks an SM, and grids
# small enough that every thread loops
RESIDENT = [132 * 2, 132 * 4, 5, 1]


def _normal(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _flow(rng, b, h, w, scale):
    """Flows of a few pixels to tens of pixels: corners off every edge."""
    flow = _normal(rng, (b, h, w, 2), scale)
    flow[:, ::3, ::4] *= 6.0
    return flow


def _grid_sample_bwd(f1, flow, g, row0=0):
    """``(df1, dflow)`` by ``aten::grid_sampler_2d_backward`` on the NHWC
    tensors viewed as NCHW: bilinear, border, align_corners=True, the
    sample at ``(x + fx, y + row0 + fy)`` mapped to [-1, 1]."""
    b, hf, w, _ = f1.shape
    ho = flow.shape[1]
    x = torch.arange(w, dtype=torch.float32).view(1, 1, w) + flow[..., 0]
    y = torch.arange(ho, dtype=torch.float32).view(1, ho, 1) + row0 + flow[..., 1]
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (hf - 1) * 2 - 1], -1)
    gi, gg = torch.ops.aten.grid_sampler_2d_backward(
        g.permute(0, 3, 1, 2), f1.permute(0, 3, 1, 2), grid, 0, 1, True, [True, True])
    return gi.permute(0, 2, 3, 1), gg * torch.tensor([2.0 / (w - 1), 2.0 / (hf - 1)])


def _within(got, want, rel):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * scale, (err, scale)


class TestGridSampleYardstick:
    """The library call timed beside K5 and K9b computes their function."""

    @pytest.mark.parametrize("shape,scale", [((2, 12, 14, 8), 3.0), ((1, 24, 28, 5), 10.0), ((2, 9, 31, 16), 30.0)])
    def test_warp_bwd(self, rng, shape, scale):
        f1, g = _normal(rng, shape), _normal(rng, shape)
        flow = _flow(rng, *shape[:3], scale)
        got = warp_bwd_plain(f1, flow, g)
        want = _grid_sample_bwd(f1, flow, g)
        _within(got[0], want[0], 2e-6)
        _within(got[1], want[1], 1e-5)

    @pytest.mark.parametrize("b,hf,w,c", [(2, 12, 14, 8), (1, 24, 28, 5)])
    @pytest.mark.parametrize("shard", [0, 1])
    def test_warp_rows_bwd(self, rng, b, hf, w, c, shard):
        """K9b's tall frame: a shard's h + 2d rows at row0 = -d against the
        whole frame, the flow carrying the shard's offset."""
        h = hf // 2
        f1 = _normal(rng, (b, hf, w, c))
        g = _normal(rng, (b, h + 2 * D, w, c))
        flow = _flow(rng, b, h + 2 * D, w, 3.0)
        flow[..., 1] += shard * h
        got = warp_rows_bwd_plain(f1, flow, g, -D)
        want = _grid_sample_bwd(f1, flow, g, -D)
        _within(got[0], want[0], 2e-6)
        _within(got[1], want[1], 1e-5)


class TestRowMask:
    @pytest.mark.parametrize("h,shard,shards", [(6, 0, 2), (6, 1, 2), (5, 1, 3), (3, 0, 1), (2, 2, 3)])
    def test_the_kernel_skips_exactly_the_rows_the_plain_version_zeroes(self, h, shard, shards):
        vb = (-shard * h, shards * h - 1 - shard * h)
        dwe = torch.ones((1, h + 2 * D, 3, 2))
        zeroed = _mask_rows(dwe, vb, D)[0, :, 0, 0] == 0
        live = _common.warp_bwd_live_rows(h + 2 * D, -D, *vb)
        assert torch.equal(~live, zeroed)

    @pytest.mark.parametrize("shard", [0, 1, 2])
    def test_masked_scatter_matches_jax(self, rng, shard):
        """The kernel's arithmetic (the cotangent of rows outside ``vb``
        read as zero, ``dwe`` left as it is) against the plain version and
        the JAX package's K9 backward: its mask, then ``warp_bwd_pallas``."""
        b, h, w, c = 1, 4, 6, 3
        hf = 3 * h
        vb = (-shard * h, hf - 1 - shard * h)
        f1 = _normal(rng, (b, hf, w, c))
        flow = _flow(rng, b, h + 2 * D, w, 2.0)
        flow[..., 1] += shard * h
        dwe = _normal(rng, (b, h + 2 * D, w, c))
        live = _common.warp_bwd_live_rows(h + 2 * D, -D, *vb)[None, :, None, None]
        got = warp_rows_bwd_plain(f1, flow, dwe * live, -D)
        plain = warped_rows_bwd_plain(f1, flow, vb, dwe.clone(), D)
        gy = jnp.arange(-D, h + D, dtype=jnp.float32)
        mask = ((gy >= vb[0]) & (gy <= vb[1]))[None, :, None, None]
        jdwe = jnp.where(mask, jnp.asarray(dwe.numpy()), 0.0)
        jflow = jnp.asarray(flow.numpy()).at[..., 1].add(-float(D))
        want = warp_bwd_pallas(jnp.asarray(f1.numpy()), jflow, jdwe, interpret=True)
        for a, p, j, atol in zip(got, plain, want, (1e-5, 1e-4)):
            assert torch.equal(a, p)
            np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-5, atol=atol)


def _scatter(b, ho, w, c, resident):
    """The scatter phase as ``warp_bwd_coop_kernel`` splits its threads:
    how often each (pixel, channel) is loaded and reduced into the
    accumulator and each dflow written, whether the call takes 4-channel
    vectors, and whether every vector reduction instruction of a warp fills
    whole 32-byte sectors (two neighbouring lanes a sector)."""
    v, lanes = _common.WARP_BWD_CHANNELS, _common.warp_bwd_lanes(c)
    vec = _common.warp_bwd_vectorised(c, 0, 256)
    pixels, n_acc = b * ho * w, b * ho * w * c
    blocks = _common.warp_bwd_blocks(pixels, lanes, n_acc, resident)
    tid = np.arange(blocks * T)
    lane, warp = tid % 32, tid // 32
    sub, per_warp = lane % lanes, 32 // lanes
    step = blocks * T // 32 * per_warp
    cover = np.zeros((pixels, c), np.int32)
    dflow = np.zeros(pixels, np.int32)
    whole_sectors = True
    first = warp * per_warp
    while (first < pixels).any():
        pix = first + lane // lanes
        live = (first < pixels) & (pix < pixels)
        for c0 in range(0, c, lanes * v):
            start = c0 + sub * v
            for k in range(v):
                keep = live & (start + k < c)
                np.add.at(cover, (pix[keep], start[keep] + k), 1)
            if vec:  # one instruction: each active lane's 16 bytes of acc, by (pixel, sector)
                keep = live & (start < c)
                _, per_sector = np.unique(pix[keep] * c + start[keep] // 8 * 8, return_counts=True)
                whole_sectors &= bool((per_sector == 2).all())
        np.add.at(dflow, pix[live & (sub == 0)], 1)
        first = first + step
    return cover, dflow, vec, whole_sectors


class TestWarpBwdPlan:
    def test_constants_match_the_source(self):
        src = (_build.CSRC / "warp_bwd.cu").read_text()
        assert re.search(r"constexpr int kWarpBwdThreads = (\d+);", src).group(1) == str(T)
        assert re.search(r"constexpr int kChannels = (\d+);", src).group(1) == str(_common.WARP_BWD_CHANNELS)
        # the grid and the vector test the model mirrors
        assert "std::max((pixels * lanes + t - 1) / t, (n / 4 + t - 1) / t)" in src
        assert "int vec = C % kChannels == 0 && aligned16(f1) && aligned16(g);" in src

    def test_training_plans(self):
        """Lanes a pixel at K5's four calls (C = 128, 96, 64, 32): C / 4 (24
        rounded up to 32), at most a warp, at most 8 up to C = 64."""
        assert [_common.warp_bwd_lanes(c) for *_, c in TRAIN] == [32, 32, 8, 8]
        assert [_common.warp_bwd_lanes(c) for c in (1, 3, 5, 40, 68, 192, 300)] == [1, 1, 2, 8, 32, 32, 32]
        # the finest call: one pass of the zeroing needs 2688 blocks, more than the card holds
        assert _common.warp_bwd_blocks(8 * 96 * 112, 8, 8 * 96 * 112 * 32, 132 * 2) == 132 * 2
        assert _common.warp_bwd_blocks(8 * 96 * 112, 8, 8 * 96 * 112 * 32, 10**6) == 2688
        assert _common.warp_bwd_blocks(8 * 12 * 14, 32, 8 * 12 * 14 * 128, 10**6) == 168

    @pytest.mark.parametrize("b,h,w,c", TRAIN)
    @pytest.mark.parametrize("resident", RESIDENT[:2])
    def test_each_pixel_and_channel_once_at_the_training_shapes(self, b, h, w, c, resident):
        cover, dflow, vec, whole_sectors = _scatter(b, h, w, c, resident)
        assert (cover == 1).all() and (dflow == 1).all() and vec and whole_sectors

    @pytest.mark.parametrize("b,ho,hf,w,c", TALL)
    def test_each_pixel_and_channel_once_on_the_tall_frame(self, b, ho, hf, w, c):
        """K9b covers the shard's h + 2d rows (the mask only skips work)."""
        cover, dflow, vec, whole_sectors = _scatter(b, ho, w, c, RESIDENT[0])
        assert (cover == 1).all() and (dflow == 1).all() and vec and whole_sectors
        assert _common.warp_bwd_live_rows(ho, -D, 0, hf - 1).sum().item() == ho - D

    @pytest.mark.parametrize("c", [1, 3, 5, 8, 12, 13, 40, 68, 300, 304])
    @pytest.mark.parametrize("resident", RESIDENT)
    def test_each_pixel_and_channel_once_at_small_odd_c(self, c, resident):
        cover, dflow, vec, whole_sectors = _scatter(2, 5, 7, c, resident)
        assert (cover == 1).all() and (dflow == 1).all()
        assert vec == (c % 4 == 0) and whole_sectors == (c % 8 == 0 or not vec)

    def test_a_misaligned_tensor_takes_the_scalar_tail(self):
        assert _common.warp_bwd_vectorised(32, 0, 256)
        assert not _common.warp_bwd_vectorised(32, 0, 264)
        assert not _common.warp_bwd_vectorised(30, 0, 256)

    @pytest.mark.parametrize("n", [1, 7, 8, 13, 4096 + 5])
    @pytest.mark.parametrize("blocks", [1, 3])
    def test_zeroing_and_rounding_cover_the_accumulator_once(self, n, blocks):
        """Phase (a): a float4 a thread, then the scalar tail; phase (c): 8
        values a thread, then the scalar tail; both by the grid's stride."""
        tid, stride = np.arange(blocks * T), blocks * T
        for width in (4, 8):
            seen = np.zeros(n, np.int32)
            for i in range(0, n // width, stride):
                idx = i + tid[i + tid < n // width]
                np.add.at(seen, (idx[:, None] * width + np.arange(width)).ravel(), 1)
            for i in range(n // width * width, n, stride):
                np.add.at(seen, (i + tid)[i + tid < n], 1)
            assert (seen == 1).all()
