"""The host-side plans of the Hopper kernels redesigned for K6 and the
correlation core (K1, K2, K8, K9), on the CPU.

The kernels themselves need an NVIDIA card (tests/test_torch_kernels.py,
``cuda`` marker); what decides their arithmetic and their coverage is
Python or mirrors Python, and is held here:

- ``_common.pack_wgmma_transposed``: conv3^T and conv2^T computed the way
  K6's bf16 kernels compute them, one 16-deep K step of every tap at a time
  from the transposed, tap-mirrored packed weights, equal
  ``torch.nn.grad.conv2d_input``; conv1^T as four phase GEMMs (row and
  column parity of dx, 4 / 2 / 2 / 1 taps) from the packed weights equals
  ``conv2d_input`` under the forward's bottom/right SAME pad, at even and
  odd half sizes; the whole chain so computed equals K6's plain version
  (held against the JAX package in tests/test_torch_backward.py);
- ``_common.correlation_plan`` and a model of the kernel's blocks and of
  its ``save`` rule (``_blocks``, ``_saves``, mirroring
  ``csrc/correlation.cuh``): at every main-path shape and at edge shapes,
  the launch covers each output pixel once and each channel once per
  tile, and hands every staged value to the Loader's ``save`` in exactly
  one block, K8's halo rows and K9's valid rows included.

Tolerances: float32 with the sums taken in another order, rtol=1e-5 and
atol=1e-5 at O(1) values.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input

from pwcnet_tpu_torch.ops.activation import leaky_mask
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_bwd_plain, same_pad_stride2

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _gemm_tap(a, wpk, ks, tap):
    """One K step of one tap: (..., 16 channels) @ the packed [2][N][8] block."""
    n = wpk.shape[3]
    return a[..., 16 * ks : 16 * ks + 16] @ wpk[ks, tap].permute(0, 2, 1).reshape(16, n)


def _conv_t_packed(gz, wpk, cout):
    """NHWC conv^T of a 3x3 stride-1 SAME conv as K6's conv_t_wg_kernel
    computes it: source offset (dy - 1, dx - 1) at packed tap dy * 3 + dx,
    K step by K step."""
    b, h, w, c = gz.shape
    ksteps, n = wpk.shape[0], wpk.shape[3]
    gp = F.pad(F.pad(gz, (0, 16 * ksteps - c)), (0, 0, 1, 1, 1, 1))
    out = torch.zeros((b, h, w, n))
    for ks in range(ksteps):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            out += _gemm_tap(gp[:, dy : dy + h, dx : dx + w], wpk, ks, tap)
    return out[..., :cout]


def _conv1_t_phases(gz1, wpk, cin):
    """dx (B, 2 hh, 2 wh, cin) as K6's conv1_t_wg_kernel computes it: phase
    (py, px) of dx from the taps with ky & 1 = py, kx & 1 = px, which read
    gz1 at (a - [ky == 2], c - [kx == 2]) (zero above and left of the frame)."""
    b, hh, wh, c = gz1.shape
    ksteps = wpk.shape[0]
    gp = F.pad(F.pad(gz1, (0, 16 * ksteps - c)), (0, 0, 1, 0, 1, 0))
    dx = torch.zeros((b, 2 * hh, 2 * wh, wpk.shape[3]))
    taps = {}
    for py in range(2):
        for px in range(2):
            taps[py, px] = [(ky, kx) for ky in range(py, 3, 2) for kx in range(px, 3, 2)]
            for ks in range(ksteps):
                for ky, kx in taps[py, px]:
                    sy, sx = (0 if ky == 2 else 1), (0 if kx == 2 else 1)
                    dx[:, py::2, px::2] += _gemm_tap(gp[:, sy : sy + hh, sx : sx + wh], wpk, ks, ky * 3 + kx)
    assert [len(taps[p]) for p in ((0, 0), (0, 1), (1, 0), (1, 1))] == [4, 2, 2, 1]
    return dx[..., :cin]


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


class TestK6TransposedPacking:
    @pytest.mark.parametrize("c", [16, 32])
    def test_conv_t_from_packed_weights_equals_conv2d_input(self, rng, c):
        gz = _t(rng, (2, 7, 9, c))
        k = _t(rng, (c, c, 3, 3), 1.0 / np.sqrt(9.0 * c))
        wpk = _common.pack_wgmma_transposed(k)
        assert wpk.shape == (c // 16, 9, 2, c, 8) and wpk.is_contiguous()
        assert wpk.numel() == _common.packed_numel(c, c)
        want = conv2d_input((2, c, 7, 9), k, _nchw(gz), padding=1)
        torch.testing.assert_close(_conv_t_packed(gz, wpk, c), _nhwc(want), rtol=1e-5, atol=1e-5)

    def test_mirrored_taps_and_swapped_roles(self, rng):
        """Packed tap t of the transposed kernel is tap 8 - t of the forward,
        with K and N exchanged; without the mirror the taps stay."""
        k = _t(rng, (32, 16, 3, 3))
        full = _common.pack_wgmma_transposed(k).permute(1, 0, 2, 4, 3).reshape(9, 32, 16)
        torch.testing.assert_close(full, k.reshape(32, 16, 9).flip(2).permute(2, 0, 1), rtol=0, atol=0)
        full = _common.pack_wgmma_transposed(k, mirror=False).permute(1, 0, 2, 4, 3).reshape(9, 32, 16)
        torch.testing.assert_close(full, k.reshape(32, 16, 9).permute(2, 0, 1), rtol=0, atol=0)

    @pytest.mark.parametrize("hh,wh", [(6, 8), (7, 9), (5, 12), (8, 7)])
    def test_conv1_t_phases_equal_conv2d_input(self, rng, hh, wh):
        cin, c = 16, 32
        gz1 = _t(rng, (2, hh, wh, c))
        k1 = _t(rng, (c, cin, 3, 3), 1.0 / np.sqrt(9.0 * cin))
        wpk = _common.pack_wgmma_transposed(k1, mirror=False)
        assert wpk.numel() == _common.packed_numel(c, cin)
        h, w = 2 * hh, 2 * wh
        left, right, top, bottom = same_pad_stride2(h, w)
        assert (left, top) == (0, 0)  # the forward pads only bottom/right
        full = conv2d_input((2, cin, h + top + bottom, w + left + right), k1, _nchw(gz1), stride=2)
        want = _nhwc(full[:, :, :h, :w])
        torch.testing.assert_close(_conv1_t_phases(gz1, wpk, cin), want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("cin,c", [(3, 16), (16, 32)])
    def test_chain_from_packed_weights_equals_the_plain_backward(self, rng, cin, c):
        """gz3 = g mask(out), gz2 and gz1 from the packed conv^T, dx from
        the phases (level 1), each stage reading the one before as K6's
        bf16 kernels do, equal pyramid_level_bwd_plain in float32."""
        b, h, w = 1, 10, 14
        x = _t(rng, (b, h, w, cin))
        ks = [_t(rng, (c, ci, 3, 3), 1.0 / np.sqrt(9.0 * ci)) for ci in (cin, c, c)]
        out, s1, s2, g = (_t(rng, (b, h // 2, w // 2, c)) for _ in range(4))
        gz3 = g * leaky_mask(out)
        gz2 = _conv_t_packed(gz3, _common.pack_wgmma_transposed(ks[2]), c) * leaky_mask(s2)
        gz1 = _conv_t_packed(gz2, _common.pack_wgmma_transposed(ks[1]), c) * leaky_mask(s1)
        need_dx = cin == 16
        want = pyramid_level_bwd_plain(x, *ks, out, s1, s2, g, need_dx=need_dx)
        for got, exp in zip((gz1, gz2, gz3), want):
            torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)
        if need_dx:
            dx = _conv1_t_phases(gz1, _common.pack_wgmma_transposed(ks[0], mirror=False), cin)
            torch.testing.assert_close(dx, want[3], rtol=1e-5, atol=1e-5)


def _blocks(b: int, h: int, w: int, c: int, tw: int, split: int):
    """The blocks of a correlation launch as ``csrc/correlation.cuh``
    derives them from its grid ``(ceil(W / tw) * split, ceil(H / 8), B)``
    in clusters of ``split`` along x: yields ``(batch, y0, x0, rank,
    channels)``, the tile's origin, the block's rank in its cluster and the
    channels it stages and correlates."""
    th, cc = _common.CORR_TILE_H, _common.CORR_CHUNK
    chunks = -(-c // cc)
    per = -(-chunks // split)
    for z in range(b):
        for by in range(-(-h // th)):
            for bx in range(-(-w // tw) * split):
                rank = bx % split
                k0 = rank * per
                k1 = min(chunks, k0 + per)
                yield z, by * th, bx // split * tw, rank, range(k0 * cc, min(c, k1 * cc))


def _saves(y0: int, x0: int, tw: int, h: int, w: int, gy: int, gx: int) -> bool:
    """The kernel's rule: whether the block of the tile at ``(y0, x0)``
    hands the staged window value at ``(gy, gx)`` to the Loader's ``save``
    (for the channels it owns): the tile's own rows and columns, and the
    window rows above the frame (below it) in the first (last) row of
    tiles."""
    th = _common.CORR_TILE_H
    own_row = (y0 <= gy < y0 + th) or (gy < 0 and y0 == 0) or (gy >= h and y0 + th >= h)
    return own_row and x0 <= gx < min(x0 + tw, w)


# (B, H, W, C) at 448x1024 serving and 384x448 training, levels deep to fine,
# a 1024x1024 frame's level 0 per shard of 2 (K8), the sharded levels (K9)
_MAIN_PATH = [
    (8, 7, 16, 192), (8, 14, 32, 128), (8, 28, 64, 96), (8, 56, 128, 64), (8, 112, 256, 32),
    (8, 6, 7, 192), (8, 12, 14, 128), (8, 24, 28, 96), (8, 48, 56, 64), (8, 96, 112, 32),
    (1, 8, 16, 192), (8, 7, 32, 128), (8, 56, 256, 32), (1, 7, 16, 192),
]
_EDGE = [(1, 5, 6, 3), (2, 9, 37, 40), (1, 3, 16, 192), (1, 10, 12, 5), (2, 1, 1, 8), (1, 17, 33, 40)]


def _coverage(b, h, w, c, tw, split):
    """Per (batch, row, column): the tiles covering it; per tile: the
    channels of its blocks."""
    covered = np.zeros((b, h, w), np.int64)
    channels = {}
    for z, y0, x0, rank, chans in _blocks(b, h, w, c, tw, split):
        assert 0 <= rank < split
        if rank == 0:
            covered[z, y0 : y0 + _common.CORR_TILE_H, x0 : x0 + tw] += 1
        channels.setdefault((z, y0, x0), []).extend(chans)
    return covered, channels


def _save_counts(h, w, tw, d, rows):
    """How many blocks of one batch element save each staged window value
    (a tile's window is its rows and columns with a d-wide halo), over
    window rows ``rows`` (those the Loader accepts) and columns [0, W)."""
    lo = rows.start
    counts = np.zeros((len(rows), w), np.int64)
    for _, y0, x0, _, _ in _blocks(1, h, w, 1, tw, 1):
        for gy in range(y0 - d, y0 + _common.CORR_TILE_H + d):
            if gy not in rows:
                continue
            for gx in range(max(0, x0 - d), min(w, x0 + tw + d)):
                counts[gy - lo, gx] += _saves(y0, x0, tw, h, w, gy, gx)
    return counts


class TestCorrelationPlan:
    def test_main_path_plans(self):
        """The deep, wide levels split their channels over clusters; the
        two finest warped levels, whose grids hold a block an SM, do not."""
        plans = [_common.correlation_plan(w, c) for _, _, w, c in _MAIN_PATH[:5]]
        assert plans == [(16, 8), (32, 4), (32, 2), (32, 1), (32, 1)]
        assert _common.correlation_plan(7, 192) == (16, 8)

    @pytest.mark.parametrize("b,h,w,c", _MAIN_PATH + _EDGE)
    def test_every_split_block_keeps_three_chunks(self, b, h, w, c):
        """Every block of a split tile correlates at least three chunks of
        channels (fewer lost to the staging and the cluster's sum in the
        sweep that set the table); the grid is the tiles times the split."""
        tw, split = _common.correlation_plan(w, c)
        assert tw in (16, 32) and split in _common.CORR_SPLITS
        chunks = -(-c // _common.CORR_CHUNK)
        assert split == 1 or chunks >= 3 * split
        blocks = list(_blocks(b, h, w, c, tw, split))
        assert len(blocks) == b * -(-h // 8) * -(-w // tw) * split
        assert all(len(ch) >= 3 * _common.CORR_CHUNK for *_, ch in blocks if split > 1)

    @pytest.mark.parametrize("b,h,w,c", _MAIN_PATH + _EDGE)
    def test_each_output_pixel_and_channel_once(self, b, h, w, c):
        tw, split = _common.correlation_plan(w, c)
        covered, channels = _coverage(b, h, w, c, tw, split)
        assert (covered == 1).all()
        for chans in channels.values():
            assert sorted(chans) == list(range(c))

    @pytest.mark.parametrize("split", [2, 4, 8])
    def test_channel_split_with_more_blocks_than_chunks(self, split):
        """C = 5 is one chunk: the other blocks of the cluster own none."""
        _, channels = _coverage(1, 5, 6, 5, 16, split)
        assert all(sorted(ch) == list(range(5)) for ch in channels.values())

    @pytest.mark.parametrize("h,w", [(7, 16), (14, 32), (112, 256), (5, 6), (9, 37), (8, 16), (3, 16), (17, 33)])
    @pytest.mark.parametrize("d", [1, 4])
    def test_each_staged_value_saved_once(self, h, w, d):
        """K1 saves its own rows [0, H); K8 stages [-d, H + d), K9 the
        frame's rows [vlo, vhi] within them: every such row and column is
        saved by one block (per channel: one rank of the cluster)."""
        tw, _ = _common.correlation_plan(w, 8)
        assert (_save_counts(h, w, tw, d, range(0, h)) == 1).all()
        assert (_save_counts(h, w, tw, d, range(-d, h + d)) == 1).all()
        for vlo, vhi in ((-d, h - 1), (0, h + d - 1), (-1, h)):  # top, bottom and middle shard
            rows = range(max(vlo, -d), min(vhi, h + d - 1) + 1)
            assert (_save_counts(h, w, tw, d, rows) == 1).all()
