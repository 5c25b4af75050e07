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
- the fixed-point sum (``_fixed_point_df1``, a NumPy model of the
  kernel's df1: the scale ``warp_bwd_scale``, each float32 term
  ``rint(w * g * 2**s)``, an int64 sum, one conversion back, the non-finite
  classes) against the JAX ``_bilinear_warp_bwd`` and against
  ``warp_rows_bwd_plain`` on K9b's tall frame; bitwise the same under any
  order of the pixels; inside an int64 where every pixel of an image lands
  on one element, at max|g| 3e38, 1e-38 and 0; the class rule for NaN and
  +-Inf in g against the plain version; each image its own scale (an
  image's df1 the same bits alone as in its batch, an image whose g is
  1e-8, 1e-30 or 1e30 of the others' at K5's tolerance of its own scale);
  the scale rule, the device's ``frexp_exponent`` and the class constants
  against the source;
- a model of the launch (``_scatter``, mirroring ``warp_bwd_coop_kernel``'s
  thread decomposition): the lanes a pixel and the persistent grid's
  stride cover every (pixel, channel) exactly once and write every dflow
  once, at the four training shapes, K9b's tall shapes and small odd C,
  and the lanes of a pixel reduce into consecutive accumulators; phase 0
  reads each image's rows once; the zeroing and conversion phases cover
  the scratch once, each element converted with its image's scale; the
  constants the model shares with the source.

Tolerances. The plain versions and grid_sample's backward compute the same
function in float32 with another rounding of the sample position (the
library maps x to [-1, 1] and back): df1 within 2e-6 and dflow within
1e-5 of their largest entries (scales of 1-30 here; 4e-7 and 1.1e-6 of
the scale in a scratch check). The JAX comparison is float32 over a few
channels: rtol=1e-5, atol=1e-5 (dflow atol=1e-4, as test_torch_backward's
K5 comparison). The fixed-point model is held at K5's float32 tolerance on
the card, 1e-5 + 1e-5 x scale (its own error is below 1e-9 of max|g| here).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.ops.pallas.warped_cv import warp_bwd_pallas
from pwcnet_tpu.ops.warp import bilinear_warp as jax_bilinear_warp
from pwcnet_tpu_torch.ops.cuda import _build, _common
from pwcnet_tpu_torch.ops.cuda.warped_cv import _mask_rows, warped_rows_bwd_plain
from pwcnet_tpu_torch.ops.warp import _corners, warp_bwd_plain, warp_rows_bwd_plain

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


CLASS_CODES = {"+inf": _common.WARP_BWD_POS_INF, "-inf": _common.WARP_BWD_NEG_INF, "nan": _common.WARP_BWD_NAN}


def _fixed_point_df1(f1, flow, g, row0=0, vb=None, order=None, integer=True):
    """The kernel's df1 in NumPy (float32 arrays in, float32 out): each
    float32 term ``w * g`` of a live row, quantised to ``rint(w g 2**s)``
    (``s = warp_bwd_scale(largest finite |g| of its image's live rows, Ho,
    W)``) and summed into int64, then ``float32(sum) * 2**-s``; a term that
    is not finite sets its element's class bits instead (+Inf 1, -Inf 2,
    NaN 3). ``order`` permutes the pixels before the sum. Returns ``(df1,
    s, sums)``, ``s`` an image's; ``integer=False`` sums the float32 terms
    in that order instead (the float scatter the kernel replaced)."""
    b, hf, w, c = f1.shape
    ho = flow.shape[1]
    vb = vb or (row0, row0 + ho - 1)
    (y0, y1, x0, x1), (wy0, wy1, wx0, wx1) = _corners(torch.from_numpy(flow), hf, w, row0)
    live = _common.warp_bwd_live_rows(ho, row0, *vb).numpy()
    frame = np.arange(b)[:, None, None] * hf
    idx, terms = [], []
    for yi, xi, wy, wx in ((y0, x0, wy0, wx0), (y0, x1, wy0, wx1), (y1, x0, wy1, wx0), (y1, x1, wy1, wx1)):
        px = ((frame + yi.numpy()) * w + xi.numpy())[:, live]  # (b, live rows, w)
        idx.append(px[..., None] * c + np.arange(c))
        terms.append((wy * wx).numpy()[:, live] * g[:, live])  # float32, as the kernel forms them
    idx = np.stack(idx, 2).reshape(-1, 4 * c)  # a row per pixel: its four corners' channels
    terms = np.stack(terms, 2).reshape(-1, 4 * c)
    gl = np.abs(g[:, live]).reshape(b, -1)
    s = np.array([_common.warp_bwd_scale(float(a[np.isfinite(a)].max(initial=0.0)), ho, w) for a in gl])
    shift = np.repeat(s, len(idx) // b)[:, None]  # each pixel's image's s
    if order is not None:
        idx, terms, shift = idx[order], terms[order], shift[order]
    shift = np.broadcast_to(shift, idx.shape).ravel()
    idx, terms = idx.ravel(), terms.ravel()
    n = b * hf * w * c
    fin = np.isfinite(terms)
    if not integer:
        out = np.zeros(n, np.float32)
        np.add.at(out, idx, terms)
        return out.reshape(f1.shape), s, None
    sums = np.zeros(n, np.int64)
    np.add.at(sums, idx[fin], np.rint(np.ldexp(terms[fin].astype(np.float64), shift[fin])).astype(np.int64))
    cls = np.zeros(n, np.uint8)
    bad = terms[~fin]
    code = np.where(np.isnan(bad), 3, np.where(bad > 0, 1, 2)).astype(np.uint8)
    np.bitwise_or.at(cls, idx[~fin], code)
    with np.errstate(over="ignore"):
        out = np.ldexp(sums.astype(np.float32).astype(np.float64), -np.repeat(s, n // b)).astype(np.float32)
    out[cls == 1], out[cls == 2], out[cls == 3] = np.inf, -np.inf, np.nan
    return out.reshape(f1.shape), s, sums


def _np_normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np_flow(rng, b, h, w, scale):
    flow = _np_normal(rng, (b, h, w, 2), scale)
    flow[:, ::3, ::4] *= 6.0
    return flow


def _device_frexp_exponent(bits):
    """``frexp_exponent`` of ``csrc/warp_bwd.cu``, line by line."""
    if bits == 0:
        return 0
    biased = bits >> 23
    return biased - 126 if biased > 0 else bits.bit_length() - 149


def _f32_bits(x):
    return int(np.float32(x).view(np.uint32))


def _classes(a):
    return np.isnan(a), np.isposinf(a), np.isneginf(a)


class TestFixedPoint:
    @pytest.mark.parametrize("m", [0.0, 1.4e-45, 1e-40, 1e-38, 2.0**-126, 0.37, 1.0, 3.0, 2.0**60, 3e38,
                                   float(np.finfo(np.float32).max)])
    @pytest.mark.parametrize("ho,w", [(1, 1), (12, 14), (96, 112), (52, 112), (1000, 1000)])
    def test_the_scale_keeps_the_worst_sum_inside_an_int64(self, m, ho, w):
        """4 Ho W max|g| 2**s < 2**62, and within a factor 4 of it (no
        precision thrown away); s in the kernel's [-98, 208], where its two
        float32 factors are powers of two it can form exactly."""
        m = float(np.float32(m))
        s = _common.warp_bwd_scale(m, ho, w)
        assert -98 <= s <= 208
        worst = 4 * ho * w * m * 2.0**s
        assert worst < 2.0**62
        assert m == 0 or worst >= 2.0**60
        sa = min(max(s, -126), 127)
        assert -126 <= s - sa <= 127

    def test_the_device_frexp_is_math_frexp(self, rng):
        vals = [0.0, 1.4e-45, 2.8e-45, 1e-40, 2.0**-127, 2.0**-126, 1e-38, 0.5, 1.0, 3.0, 3e38,
                float(np.finfo(np.float32).max)]
        vals += list(np.abs(rng.standard_normal(200)).astype(np.float32) * 10.0 ** rng.integers(-44, 38, 200))
        for v in vals:
            v = float(np.float32(v))
            assert _device_frexp_exponent(_f32_bits(v)) == math.frexp(v)[1], v

    def test_scale_rule_and_classes_match_the_source(self):
        src = (_build.CSRC / "warp_bwd.cu").read_text()
        assert re.search(r"constexpr int kSumBits = (\d+);", src).group(1) == str(_common.WARP_BWD_SUM_BITS)
        assert re.search(r"constexpr int kMaxBlocks = (\d+);", src).group(1) == str(_common.WARP_BWD_MAX_BLOCKS)
        assert "const int k = 64 - __clzll(4LL * Ho * W - 1);" in src
        assert "__stcg(scales + b, kSumBits - k - frexp_exponent(m));" in src
        assert "return biased > 0 ? biased - 126 : (32 - __clz(bits)) - 149;" in src
        assert "__float2ll_rn(term * fa * fb)" in src
        assert "return n + (n + 31) / 32 + kMaxBlocks / 2 + B;" in src
        assert "const int per = max((int)gridDim.x / B, 1);" in src
        assert "for (int u = blockIdx.x; u < B * per; u += gridDim.x) {" in src
        assert "auto* scales = reinterpret_cast<int*>(part_max + kMaxBlocks + B);" in src
        assert "const bool one = e + 3 < (e / image + 1) * image;" in src
        consts = dict(re.findall(r"(kPosInf|kNegInf|kNaN) = (\d+)", src))
        assert {k: int(v) for k, v in consts.items()} == {
            "kPosInf": CLASS_CODES["+inf"], "kNegInf": CLASS_CODES["-inf"], "kNaN": CLASS_CODES["nan"]}

    @pytest.mark.parametrize("shape,scale", [((2, 12, 14, 8), 3.0), ((1, 24, 28, 5), 10.0), ((2, 9, 31, 16), 30.0)])
    def test_the_fixed_point_sum_matches_jax(self, rng, shape, scale):
        """Against the JAX package's ``_bilinear_warp_bwd`` (jax.vjp of
        ``bilinear_warp``) at K5's float32 tolerance."""
        f1, g = _np_normal(rng, shape), _np_normal(rng, shape)
        flow = _np_flow(rng, *shape[:3], scale)
        got, _, _ = _fixed_point_df1(f1, flow, g)
        _, vjp = jax.vjp(jax_bilinear_warp, jnp.asarray(f1), jnp.asarray(flow))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 + 1e-5 * np.abs(want).max())

    @pytest.mark.parametrize("b,hf,w,c", [(2, 12, 14, 8), (1, 24, 28, 5)])
    @pytest.mark.parametrize("shard", [0, 1])
    def test_the_fixed_point_sum_matches_the_plain_version_on_the_tall_frame(self, rng, b, hf, w, c, shard):
        """K9b: a shard's h + 2d rows at row0 = -d, the rows outside ``vb``
        scattering nothing, against ``warp_rows_bwd_plain`` of the masked
        cotangent."""
        h = hf // 2
        vb = (-shard * h, hf - 1 - shard * h)
        f1 = _np_normal(rng, (b, hf, w, c))
        g = _np_normal(rng, (b, h + 2 * D, w, c))
        g[:, -1] *= 100.0  # a large cotangent in a row that is dead on one shard: not in the scale there
        flow = _np_flow(rng, b, h + 2 * D, w, 3.0)
        flow[..., 1] += shard * h
        got, _, _ = _fixed_point_df1(f1, flow, g, -D, vb)
        live = _common.warp_bwd_live_rows(h + 2 * D, -D, *vb)[None, :, None, None]
        want = warp_rows_bwd_plain(torch.from_numpy(f1), torch.from_numpy(flow), torch.from_numpy(g) * live, -D)[0]
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5 + 1e-5 * want.abs().max().item())

    @pytest.mark.parametrize("shape", [(2, 12, 14, 8), (1, 9, 31, 5)])
    def test_any_order_of_the_pixels_gives_the_same_bits(self, rng, shape):
        """Three orders of the pixels: the fixed-point df1 bitwise the same;
        the float32 scatter it replaced is not."""
        f1, g = _np_normal(rng, shape), _np_normal(rng, shape)
        flow = _np_flow(rng, *shape[:3], 0.7)  # small flows: many pixels share a corner
        pixels = int(np.prod(shape[:3]))
        orders = [None, rng.permutation(pixels), np.arange(pixels)[::-1]]
        got = [_fixed_point_df1(f1, flow, g, order=o)[0] for o in orders]
        assert all(np.array_equal(got[0], a) for a in got[1:])
        floats = [_fixed_point_df1(f1, flow, g, order=o, integer=False)[0] for o in orders]
        assert not all(np.array_equal(floats[0], a) for a in floats[1:])

    @pytest.mark.parametrize("m", [3e38, 1e-38, 0.0])
    def test_every_pixel_on_one_element_stays_inside_an_int64(self, rng, m):
        """Every pixel's four corners clamped onto element (0, 0) of its
        image, |g| up to m: each sum, taken in Python integers, equals the
        int64 sum and stays below 2**62, and df1 is the exact sum rounded to
        float32 (Inf where that overflows float32, as the float sum does)."""
        b, h, w, c = 2, 12, 14, 4
        f1 = _np_normal(rng, (b, h, w, c))
        g = (rng.uniform(0.5, 1.0, (b, h, w, c)) * m).astype(np.float32)
        g[1] *= -1.0
        flow = np.full((b, h, w, 2), -1000.5, np.float32)  # weights 1/4, all corners clamp to (0, 0)
        got, s, sums = _fixed_point_df1(f1, flow, g)
        terms = (np.float32(0.25) * g).astype(np.float64)
        exact = [[sum(int(np.rint(np.ldexp(t, s[i]))) for t in terms[i, ..., ch].ravel()) * 4 for ch in range(c)]
                 for i in range(b)]
        for i in range(b):
            at = i * h * w * c
            assert [int(v) for v in sums[at : at + c]] == exact[i]
            assert all(abs(v) < 2**62 for v in exact[i])
        assert not np.any(np.delete(sums.reshape(b, -1), np.s_[:c], axis=1))
        want = (terms * 4).reshape(b, -1, c).sum(1)  # float64; beyond float32's range where m = 3e38
        with np.errstate(over="ignore"):
            want32 = want.astype(np.float32)
        if m == 3e38:
            assert np.isposinf(got[0, 0, 0]).all() and np.isneginf(got[1, 0, 0]).all()
            assert np.array_equal(got[:, 0, 0], want32)
        else:
            for i in range(b):
                err = np.abs(got[i, 0, 0].astype(np.float64) - want[i]).max()
                assert err <= 4 * h * w * 2.0 ** -(s[i] + 1) + np.abs(want[i]).max() * 2.0**-24
        assert not np.any(got.reshape(b, -1)[:, c:])

    @pytest.mark.parametrize("case", ["nan", "+inf", "-inf", "+inf and -inf"])
    def test_non_finite_g_gives_the_float_sums_class(self, rng, case):
        """NaN in g, or +Inf and -Inf whose corners meet, give NaN; +Inf or
        -Inf alone the infinity: element by element the class of the plain
        version's float32 sum, the finite elements at K5's tolerance."""
        b, h, w, c = 1, 8, 9, 3
        f1, g = _np_normal(rng, (b, h, w, c)), _np_normal(rng, (b, h, w, c))
        flow = (0.3 + 0.2 * rng.random((b, h, w, 2))).astype(np.float32)  # corners p, p+1, p+W, p+W+1
        if case == "+inf and -inf":
            g[0, 3, 4, 1], g[0, 3, 5, 1] = np.inf, -np.inf
        else:
            g[0, 3, 4, 1] = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}[case]
        got, _, _ = _fixed_point_df1(f1, flow, g)
        want = warp_bwd_plain(torch.from_numpy(f1), torch.from_numpy(flow), torch.from_numpy(g))[0].numpy()
        for a, e in zip(_classes(got), _classes(want)):
            assert np.array_equal(a, e)
        bad = ~np.isfinite(want)
        assert bad.sum() == (6 if case == "+inf and -inf" else 4)
        if case == "+inf and -inf":
            assert np.isnan(got).sum() == 2
        np.testing.assert_allclose(got[~bad], want[~bad], rtol=0, atol=1e-5 + 1e-5 * np.abs(want[~bad]).max())

    @pytest.mark.parametrize("spread", [1e-8, 1e-30, 1e30])
    def test_each_image_has_its_own_scale(self, rng, spread):
        """One image's g at ``spread`` times the others' at the training
        step's finest call (96x112, k = 16): each image's df1 has the bits
        it has alone in a call, and the scaled image's is within K5's
        relative tolerance of its own scale (1e-5 x its largest entry) of
        the plain version; one scale for the whole call would hold an image
        at 1e-8 of another's to only about 1e-5 of its scale."""
        b, h, w, c = 3, 96, 112, 2
        f1, g = _np_normal(rng, (b, h, w, c)), _np_normal(rng, (b, h, w, c))
        g[1] *= np.float32(spread)
        flow = _np_flow(rng, b, h, w, 3.0)
        got, s, _ = _fixed_point_df1(f1, flow, g)
        assert s[1] - s[0] == math.frexp(float(np.abs(g[0]).max()))[1] - math.frexp(float(np.abs(g[1]).max()))[1]
        for i in range(b):
            alone, _, _ = _fixed_point_df1(f1[i : i + 1], flow[i : i + 1], g[i : i + 1])
            assert np.array_equal(got[i : i + 1], alone)
        want = warp_bwd_plain(torch.from_numpy(f1), torch.from_numpy(flow), torch.from_numpy(g))[0].numpy()
        for i in range(b):
            np.testing.assert_allclose(got[i], want[i], rtol=0, atol=1e-5 * np.abs(want[i]).max())


def _scatter(b, ho, w, c, resident):
    """The scatter phase as ``warp_bwd_coop_kernel`` splits its threads:
    how often each (pixel, channel) is reduced into its accumulators and
    each dflow written, and whether every reduction instruction reaches,
    for each pixel, a run of consecutive channels (its lanes' channels
    ``c0 + l``)."""
    lanes = _common.warp_bwd_lanes(c)
    pixels, n_acc = b * ho * w, b * ho * w * c
    blocks = _common.warp_bwd_blocks(pixels, lanes, n_acc, resident)
    tid = np.arange(blocks * T)
    lane, warp = tid % 32, tid // 32
    sub, per_warp = lane % lanes, 32 // lanes
    step = blocks * T // 32 * per_warp
    cover = np.zeros((pixels, c), np.int32)
    dflow = np.zeros(pixels, np.int32)
    consecutive = True
    first = warp * per_warp
    while (first < pixels).any():
        pix = first + lane // lanes
        live = (first < pixels) & (pix < pixels)
        for c0 in range(0, c, lanes):
            ch = c0 + sub
            keep = live & (ch < c)
            pk, ck = pix[keep], ch[keep]
            np.add.at(cover, (pk, ck), 1)
            # one instruction: each pixel's channels are distinct and form one run from c0
            _, group, count = np.unique(pk, return_inverse=True, return_counts=True)
            lo, hi = np.full(len(count), c), np.full(len(count), -1)
            np.minimum.at(lo, group, ck)
            np.maximum.at(hi, group, ck)
            consecutive &= bool((lo == c0).all() and (hi - c0 + 1 == count).all()
                                and len(np.unique(pk * c + ck)) == len(pk))
        np.add.at(dflow, pix[live & (sub == 0)], 1)
        first = first + step
    return cover, dflow, consecutive


class TestWarpBwdPlan:
    def test_constants_match_the_source(self):
        src = (_build.CSRC / "warp_bwd.cu").read_text()
        assert re.search(r"constexpr int kWarpBwdThreads = (\d+);", src).group(1) == str(T)
        # the grid and the lanes' channels the model mirrors
        assert "std::max((pixels * lanes + t - 1) / t, (n / 4 + t - 1) / t)" in src
        assert "std::min(resident, kMaxBlocks)" in src
        assert "for (int c = sub; c < C; c += lanes) {" in src

    def test_training_plans(self):
        """Lanes a pixel: C rounded up to a power of two, at most a warp: a
        whole warp at K5's four calls (C = 128, 96, 64, 32)."""
        assert [_common.warp_bwd_lanes(c) for *_, c in TRAIN] == [32, 32, 32, 32]
        assert [_common.warp_bwd_lanes(c) for c in (1, 3, 5, 8, 40, 68, 192, 300)] == [1, 4, 8, 8, 32, 32, 32, 32]
        # the finest call: one pass of the scatter needs 10752 blocks, more than the card holds
        assert _common.warp_bwd_blocks(8 * 96 * 112, 32, 8 * 96 * 112 * 32, 132 * 2) == 132 * 2
        assert _common.warp_bwd_blocks(8 * 96 * 112, 32, 8 * 96 * 112 * 32, 10**6) == _common.WARP_BWD_MAX_BLOCKS
        assert _common.warp_bwd_blocks(8 * 12 * 14, 32, 8 * 12 * 14 * 128, 10**6) == 168

    @pytest.mark.parametrize("b,h,w,c", TRAIN)
    @pytest.mark.parametrize("resident", RESIDENT[:2])
    def test_each_pixel_and_channel_once_at_the_training_shapes(self, b, h, w, c, resident):
        cover, dflow, consecutive = _scatter(b, h, w, c, resident)
        assert (cover == 1).all() and (dflow == 1).all() and consecutive

    @pytest.mark.parametrize("b,ho,hf,w,c", TALL)
    def test_each_pixel_and_channel_once_on_the_tall_frame(self, b, ho, hf, w, c):
        """K9b covers the shard's h + 2d rows (the mask only skips work)."""
        cover, dflow, consecutive = _scatter(b, ho, w, c, RESIDENT[0])
        assert (cover == 1).all() and (dflow == 1).all() and consecutive
        assert _common.warp_bwd_live_rows(ho, -D, 0, hf - 1).sum().item() == ho - D

    @pytest.mark.parametrize("c", [1, 3, 5, 8, 12, 13, 40, 68, 300, 304])
    @pytest.mark.parametrize("resident", RESIDENT)
    def test_each_pixel_and_channel_once_at_small_odd_c(self, c, resident):
        cover, dflow, consecutive = _scatter(2, 5, 7, c, resident)
        assert (cover == 1).all() and (dflow == 1).all() and consecutive

    def test_the_scratch_holds_a_word_a_block(self):
        """The scratch: n accumulators, the class words of n elements (16
        an int32 word, two an int64), phase 0's int32 words (one a block
        and image: at most max(blocks, B), and the grid never exceeds
        WARP_BWD_MAX_BLOCKS) and an int32 scale an image."""
        for n, b in ((1, 1), (31, 1), (32, 2), (33, 3), (8 * 96 * 112 * 32, 8), (5000 * 4, 5000)):
            words = _common.warp_bwd_scratch(n, b)
            assert words == n + -(-n // 32) + _common.WARP_BWD_MAX_BLOCKS // 2 + b
            assert 2 * (words - n - -(-n // 32)) >= max(_common.WARP_BWD_MAX_BLOCKS, b) + b
        for resident in (1, 132 * 8, 10**7):
            assert _common.warp_bwd_blocks(10**7, 32, 10**8, resident) == min(resident, _common.WARP_BWD_MAX_BLOCKS)

    @pytest.mark.parametrize("b,blocks", [(8, 792), (8, 168), (8, 13), (1, 1), (3, 1), (13, 4), (5, 7)])
    def test_phase_0_reads_each_images_rows_once(self, b, blocks):
        """Phase 0: ``per = max(blocks // B, 1)`` blocks an image, a block
        the units ``blockIdx, blockIdx + blocks, ...`` below ``B per`` (unit
        u: image u // per, part u % per, its threads from part * 256 by
        per * 256): every 8-element group of each image's run once, and
        the units within the scratch's max(blocks, B) words."""
        run8 = 37 * T // 8 + 5
        per = max(blocks // b, 1)
        units = b * per
        assert units <= max(blocks, b)
        seen = np.zeros((b, run8), np.int32)
        for block in range(blocks):
            for u in range(block, units, blocks):
                for i in range(u % per * T, run8, per * T):
                    idx = i + np.arange(T)
                    np.add.at(seen[u // per], idx[idx < run8], 1)
        assert (seen == 1).all()

    @pytest.mark.parametrize("image", [1, 2, 3, 4, 5, 6, 7, 9, 13])
    def test_the_conversion_gives_each_element_its_images_scale(self, image):
        """Phase (c) converts elements 4i .. 4i + 3 together with the scale
        of element 4i's image where the kernel's ``one`` finds them in one
        image, else each with its own: every element its image's scale, at
        image sizes that are not a multiple of 4 and below 4."""
        b = 7
        for e in range(0, b * image // 4 * 4, 4):
            one = e + 3 < (e // image + 1) * image
            assert all((e // image if one else (e + q) // image) == (e + q) // image for q in range(4))

    @pytest.mark.parametrize("n", [1, 7, 8, 13, 4096 + 5])
    @pytest.mark.parametrize("blocks", [1, 3])
    def test_zeroing_and_rounding_cover_the_accumulator_once(self, n, blocks):
        """Phase (a): the accumulators and class words (n + ceil(n / 32)
        int64 words) two a thread, then the odd word; phase (c): 4 elements
        a thread, then the scalar tail; both by the grid's stride."""
        tid, stride = np.arange(blocks * T), blocks * T
        for total, width in ((n + -(-n // 32), 2), (n, 4)):
            seen = np.zeros(total, np.int32)
            for i in range(0, total // width, stride):
                idx = i + tid[i + tid < total // width]
                np.add.at(seen, (idx[:, None] * width + np.arange(width)).ravel(), 1)
            for i in range(total // width * width, total, stride):
                np.add.at(seen, (i + tid)[i + tid < total], 1)
            assert (seen == 1).all()
