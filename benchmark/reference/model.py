"""Plain float32 PyTorch references of PWCDCNet and the legacy PWCNet.

Written from the published description (Sun et al., "PWC-Net", CVPR 2018,
arXiv:1709.02371) as the reference implementation daigo0927/pwcnet
``model.py`` builds it, with no kernel, no cache and no batching trick.
This file imports nothing of the measured program: the benchmark hands
both sides the same weights and frames, and this side computes the
answer again from them.

Conventions, which the served model shares:

- tensors are NCHW inside; frames and flows are NHWC at the boundary;
- every conv is 3x3; a stride-2 conv pads TF's SAME way (only bottom and
  right on an even size), a stride-1 conv pads by its dilation;
- LeakyReLU is ``where(x >= 0, x, slope * x)``;
- the cost volume is ``leaky_relu(mean_c f0[y, x] * f1[y + v, x + u], 0.1)``
  over the 81 taps of a search range of 4, vertical offsets outer, with
  ``f1`` zero outside the frame;
- the bilinear warp clamps each of the four corners into the frame on its
  own and takes the weights from the unclamped fractional flow;
- resizes are TF1's ``resize_bilinear`` (no half-pixel centres): an
  integer upscale by ``f`` gives output ``f*k + p`` as
  ``x[k] + (x[min(k + 1, n - 1)] - x[k]) * p / f``, rows first.

``precision`` selects the arithmetic of the convolutions, forward and
backward: None is float32 (TF32 must be off, which the caller sets);
``'tf32'`` rounds every conv operand to TF32's 10-bit mantissa, ``'bf16'``
to bfloat16's 8-bit one; ``'fp8'`` scales every forward operand per tensor
into float8 e4m3 and every gradient into e5m2. ``'fp8'`` and ``'tf32'``
are the controls of the bfloat16 and float32 cells: the reference computed
one precision below the cell's. ``'bf16'`` gives a bfloat16 cell's check
the size of the rounding its own precision causes on the seed's weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["PWCDCNet", "PWCNet", "build", "cost_volume", "bilinear_warp", "upsample", "round_to"]

PYRAMID_FILTERS = (16, 32, 64, 96, 128, 192)
EST_FILTERS = (128, 128, 96, 64, 32)
CONTEXT_FILTERS = (128, 128, 128, 96, 64, 32, 2)
CONTEXT_DILATIONS = (1, 2, 4, 8, 16, 1, 1)
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_to(x: torch.Tensor, precision, grad: bool = False) -> torch.Tensor:
    """``x`` rounded to ``precision`` and returned in float32."""
    if precision is None:
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        # round to nearest, ties to even, on the 13 dropped mantissa bits
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "fp8":
        fmt = torch.float8_e5m2 if grad else torch.float8_e4m3fn
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = FP8_MAX[fmt] / amax
        return (x.float() * scale).to(fmt).float() / scale
    raise ValueError(f"precision must be None, 'tf32', 'bf16' or 'fp8': {precision!r}")


class _LowConv(torch.autograd.Function):
    """A conv whose operands, forward and backward, are rounded to a lower
    precision and whose products and sums run in float32."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, precision):
        xq, wq = round_to(x, precision), round_to(w, precision)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, dilation, precision)
        return F.conv2d(xq, wq, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, dilation, precision = ctx.conf
        gq = round_to(g, precision, grad=True)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding, dilation)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding, dilation)
        return gx, gw, g.sum((0, 2, 3)), None, None, None, None


def conv(module: nn.Conv2d, x: torch.Tensor, precision=None) -> torch.Tensor:
    s, p, d = module.stride, module.padding, module.dilation
    if precision is None:
        return F.conv2d(x, module.weight, module.bias, s, p, d)
    return _LowConv.apply(x, module.weight, module.bias, s, p, d, precision)


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def name(i: int) -> str:
    return "conv2d" if i == 0 else f"conv2d_{i}"


def same_pad_s2(x: torch.Tensor) -> torch.Tensor:
    """TF SAME padding of a 3x3 stride-2 conv: (total // 2, rest) a side."""

    def split(n):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        return total // 2, total - total // 2

    top, bottom = split(x.shape[2])
    left, right = split(x.shape[3])
    return F.pad(x, (left, right, top, bottom))


def cost_volume(f0: torch.Tensor, f1: torch.Tensor, d: int) -> torch.Tensor:
    """(B, C, H, W) twice -> (B, (2d+1)**2, H, W)."""
    h, w = f0.shape[2], f0.shape[3]
    f1p = F.pad(f1, (d, d, d, d))
    taps = [(f0 * f1p[:, :, v:v + h, u:u + w]).mean(1) for v in range(2 * d + 1) for u in range(2 * d + 1)]
    return leaky(torch.stack(taps, 1), 0.1)


def bilinear_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``x`` (B, C, H, W) sampled at ``p + flow(p)``; ``flow`` (B, 2, H, W),
    channel 0 horizontal. Each corner clamps into the frame on its own."""
    b, c, h, w = x.shape
    fx, fy = flow[:, 0], flow[:, 1]
    fx0, fy0 = torch.floor(fx), torch.floor(fy)
    gy = torch.arange(h, device=x.device, dtype=x.dtype)[None, :, None]
    gx = torch.arange(w, device=x.device, dtype=x.dtype)[None, None, :]
    ty, tx = gy + fy0, gx + fx0
    y0, y1 = ty.clamp(0, h - 1).long(), (ty + 1).clamp(0, h - 1).long()
    x0, x1 = tx.clamp(0, w - 1).long(), (tx + 1).clamp(0, w - 1).long()
    wy, wx = (fy - fy0)[:, None], (fx - fx0)[:, None]
    flat = x.reshape(b, c, h * w)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _upsample_axis(x: torch.Tensor, f: int, axis: int) -> torch.Tensor:
    if f == 1:
        return x
    n = x.shape[axis]
    xn = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    phases = [x] + [x + (xn - x) * (p / f) for p in range(1, f)]
    shape = list(x.shape)
    shape[axis] *= f
    return torch.stack(phases, axis + 1).reshape(shape)


def upsample(x: torch.Tensor, f: int) -> torch.Tensor:
    """TF1 bilinear upscale of (B, C, H, W) by the integer ``f``."""
    return _upsample_axis(_upsample_axis(x, f, 2), f, 3)


def _convs(module: nn.Module, specs) -> None:
    for i, (cin, cout, stride, dilation) in enumerate(specs):
        pad = 0 if stride == 2 else dilation
        module.add_module(name(i), nn.Conv2d(cin, cout, 3, stride=stride, padding=pad, dilation=dilation))


class Pyramid(nn.Module):
    def __init__(self, num_levels: int, per_level: int):
        super().__init__()
        self.num_levels, self.per_level = num_levels, per_level
        specs, cin = [], 3
        for level in range(num_levels):
            for i in range(per_level):
                specs.append((cin, PYRAMID_FILTERS[level], 2 if i == 0 else 1, 1))
                cin = PYRAMID_FILTERS[level]
        _convs(self, specs)

    def forward(self, x, precision=None):
        out = []
        for level in range(self.num_levels):
            x = same_pad_s2(x)
            for i in range(self.per_level):
                x = leaky(conv(getattr(self, name(self.per_level * level + i)), x, precision), 0.1)
            out.append(x)
        return out[::-1]


class Estimator(nn.Module):
    """Five hidden convs and a 2-channel flow conv."""

    def __init__(self, cin: int, slope: float):
        super().__init__()
        self.slope = slope
        chans = (cin,) + EST_FILTERS + (2,)
        _convs(self, [(a, b, 1, 1) for a, b in zip(chans, chans[1:])])

    def forward(self, x, precision=None):
        for i in range(len(EST_FILTERS)):
            x = leaky(conv(getattr(self, name(i)), x, precision), self.slope)
        return x, conv(getattr(self, name(len(EST_FILTERS))), x, precision)


class Context(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        chans = (cin,) + CONTEXT_FILTERS
        _convs(self, [(a, b, 1, d) for a, b, d in zip(chans, chans[1:], CONTEXT_DILATIONS)])

    def forward(self, flow, features, precision=None):
        x = torch.cat([flow, features], 1)
        for i in range(len(CONTEXT_FILTERS)):
            x = conv(getattr(self, name(i)), x, precision)
            if i < len(CONTEXT_FILTERS) - 1:
                x = leaky(x, 0.1)
        return flow + x


class PWCDCNet(nn.Module):
    """The reference's working model (``model.py:74-138``), ``use_dc=False``,
    bilinear warp. ``forward`` returns ``(final flow (B, H, W, 2) in
    pixels, [per-level flows (B, h, w, 2) deep to the output level, in
    pixels / 20 at full resolution])``."""

    def __init__(self, num_levels=6, search_range=4, output_level=4, **_):
        super().__init__()
        self.num_levels, self.d, self.output_level = num_levels, search_range, output_level
        self.fp_extractor = Pyramid(num_levels, 3)
        taps = (2 * search_range + 1) ** 2
        for l in range(output_level + 1):
            cin = taps + PYRAMID_FILTERS[num_levels - 1 - l] + (0 if l == 0 else 2 + EST_FILTERS[-1])
            self.add_module(f"optflow_{l}", Estimator(cin, 0.1))
        self.context = Context(2 + EST_FILTERS[-1])

    def forward(self, images_0, images_1, precision=None):
        p0 = self.fp_extractor(images_0.permute(0, 3, 1, 2), precision)
        p1 = self.fp_extractor(images_1.permute(0, 3, 1, 2), precision)
        flows_pyramid, flow_up, feat_up = [], None, None
        for l in range(self.output_level + 1):
            f0, f1 = p0[l], p1[l]
            if l == 0:
                cv = cost_volume(f0, f1, self.d)
                x = torch.cat([cv, f0], 1)
            else:
                scale = 20.0 / 2 ** (self.num_levels - l)
                cv = cost_volume(f0, bilinear_warp(f1, flow_up * scale), self.d)
                x = torch.cat([cv, f0, flow_up, feat_up], 1)
            features, flow = getattr(self, f"optflow_{l}")(x, precision)
            if flow_up is not None:
                flow = flow + flow_up
            if l < self.output_level:
                both = upsample(torch.cat([flow, features], 1), 2)
                flow_up, feat_up = both[:, :2], both[:, 2:]
                flows_pyramid.append(flow)
            else:
                flow = self.context(flow, features, precision)
                flows_pyramid.append(flow)
        final = upsample(flow, 2 ** (self.num_levels - self.output_level)) * 20.0
        return final.permute(0, 2, 3, 1), [f.permute(0, 2, 3, 1) for f in flows_pyramid]


class PWCNet(nn.Module):
    """The reference's original model (``model.py`` ``PWCNet``) with
    ``context='final'`` and no BatchNorm: a 2-conv pyramid, a zero flow at
    the deepest level and ``2 x`` the upscaled flow between levels, the warp
    by that flow, the cost volume, an estimator with LeakyReLU(0.2) whose
    flow is not residual, the context net at the output level, and a final
    upscale times its factor. ``forward`` returns the final flow (B, H, W, 2)."""

    def __init__(self, num_levels=6, search_range=4, output_level=4, **_):
        super().__init__()
        self.num_levels, self.d, self.output_level = num_levels, search_range, output_level
        self.fp_extractor = Pyramid(num_levels, 2)
        taps = (2 * search_range + 1) ** 2
        for l in range(output_level + 1):
            self.add_module(f"optflow_{l}", Estimator(taps + PYRAMID_FILTERS[num_levels - 1 - l] + 2, 0.2))
        self.context = Context(2 + EST_FILTERS[-1])

    def forward(self, images_0, images_1, precision=None):
        p0 = self.fp_extractor(images_0.permute(0, 3, 1, 2), precision)
        p1 = self.fp_extractor(images_1.permute(0, 3, 1, 2), precision)
        flow = None
        for l in range(self.output_level + 1):
            f0, f1 = p0[l], p1[l]
            b, _, h, w = f0.shape
            flow = f0.new_zeros((b, 2, h, w)) if l == 0 else upsample(flow, 2) * 2.0
            cv = cost_volume(f0, bilinear_warp(f1, flow), self.d)
            features, flow = getattr(self, f"optflow_{l}")(torch.cat([cv, f0, flow], 1), precision)
            if l == self.output_level:
                flow = self.context(flow, features, precision)
        up = 2 ** (self.num_levels - self.output_level)
        return (upsample(flow, up) * float(up)).permute(0, 2, 3, 1)


MODELS = {"PWCDCNet": PWCDCNet, "PWCNet": PWCNet}


def build(config: dict, device=None) -> nn.Module:
    """The reference model of a benchmark configuration, in float32."""
    return MODELS[config["model"]](**config).to(device=device, dtype=torch.float32)
