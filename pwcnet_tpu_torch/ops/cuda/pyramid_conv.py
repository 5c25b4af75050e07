"""K3 and K6: one fused feature-pyramid level and its backward as CUDA
kernels (``csrc/pyramid_conv.cu``, ``csrc/pyramid_conv_bwd.cu``).

Replace ``pwcnet_tpu/ops/pallas/pyramid_conv.py::pyramid_level_fused`` and
its backward ``_plevel_bwd_banded`` / ``_plevel_bwd_pallas``. One level is
conv3x3 stride 2 (TF SAME) -> +b, LeakyReLU(0.1) -> conv3x3 -> LeakyReLU ->
conv3x3 -> LeakyReLU, float32 accumulation, the activations rounded to the
model dtype between the convs.

Activations are NHWC as in the JAX package; the kernels ``k1..k3`` are
PyTorch's OIHW conv weights (the port's parameter layout), biases (C,).
The plain version of the forward, ``pyramid_level_plain``, is the same
chain as three ``F.conv2d`` calls in float32; the plain version of the
backward, ``pyramid_level_bwd_plain``, is the cotangent chain as
``conv2d_input`` calls.

On a CUDA tensor ``pyramid_level_fused`` is a ``torch.autograd.Function``:
K3 forward (which then also writes ``s1`` and ``s2``, the post-activation
outputs of conv1 and conv2), K6 backward for the pre-activation cotangents
``gz1..gz3`` and ``dx``, and the weight and bias gradients as plain conv
weight gradients on the saved activations, as the JAX package takes them
outside its kernel (``_dkdb_xla``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.activation import leaky_mask, leaky_relu
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P

__all__ = [
    "pyramid_level_fused", "pyramid_level_plain", "pyramid_level_residuals",
    "pyramid_level_bwd", "pyramid_level_bwd_plain", "same_pad_stride2", "SUPPORTED",
]

_ARGTYPES = [P] * 11 + [I] * 6 + [P]
_BWD_ARGTYPES = [P] * 12 + [I] * 6 + [P]
# (Cin, C) pairs the kernels are built for: the two finest PWCDCNet levels
SUPPORTED = ((3, 16), (16, 32))


def same_pad_stride2(h: int, w: int) -> tuple[int, int, int, int]:
    """TF SAME padding of a 3x3 stride-2 conv as F.pad's (left, right, top,
    bottom). An even size pads only bottom/right; ``padding=1`` would pad
    both sides and shift every sample by one pixel."""

    def split(n):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        return total // 2, total - total // 2

    top, bottom = split(h)
    left, right = split(w)
    return left, right, top, bottom


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts: bool = False):
    """The level in plain PyTorch: (B, H, W, Cin) NHWC -> (B, H/2, W/2, C).

    ``return_acts``: also return ``s1`` and ``s2`` (NHWC, model dtype)."""
    dt = x.dtype
    y = x.permute(0, 3, 1, 2).float()
    y = F.pad(y, same_pad_stride2(y.shape[2], y.shape[3]))
    s1 = leaky_relu(F.conv2d(y, k1.float(), b1.float(), stride=2), 0.1).to(dt)
    s2 = leaky_relu(F.conv2d(s1.float(), k2.float(), b2.float(), padding=1), 0.1).to(dt)
    out = _nhwc(leaky_relu(F.conv2d(s2.float(), k3.float(), b3.float(), padding=1), 0.1).to(dt))
    if return_acts:
        return out, _nhwc(s1), _nhwc(s2)
    return out


def pyramid_level_bwd_plain(x, k1, k2, k3, out, s1, s2, g, need_dx: bool = True):
    """``(gz1, gz2, gz3, dx)`` of the level for the cotangent ``g`` of its
    output: the plain version of K6.

    ``gz3 = g * mask(out)``, ``gz2 = conv3^T(gz3) * mask(s2)``,
    ``gz1 = conv2^T(gz2) * mask(s1)``, ``dx = conv1^T(gz1)``; ``mask`` is 1
    where the saved activation is ``>= 0``, else 0.1. float32 sums; each
    result is rounded to the model dtype and the next stage reads the
    rounded value. ``dx`` is None when ``need_dx`` is false."""
    dt = x.dtype
    b, h, w, cin = x.shape

    def nchw(t):
        return t.permute(0, 3, 1, 2).float()

    def conv_t(gz, k):
        return torch.nn.grad.conv2d_input(gz.shape, k.float(), gz, padding=1)

    gz3 = (nchw(g) * leaky_mask(nchw(out))).to(dt)
    gz2 = (conv_t(gz3.float(), k3) * leaky_mask(nchw(s2))).to(dt)
    gz1 = (conv_t(gz2.float(), k2) * leaky_mask(nchw(s1))).to(dt)
    dx = None
    if need_dx:
        left, right, top, bottom = same_pad_stride2(h, w)
        padded = (b, cin, h + top + bottom, w + left + right)
        dxp = torch.nn.grad.conv2d_input(padded, k1.float(), gz1.float(), stride=2)
        dx = _nhwc(dxp[:, :, top : top + h, left : left + w].to(dt))
    return _nhwc(gz1), _nhwc(gz2), _nhwc(gz3), dx


def _check_level(name, x, k1, b1, k2, b2, k3, b3):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    c = k1.shape[0]
    if (cin, c) not in SUPPORTED:
        raise ValueError(f"{name}: (Cin, C) = {(cin, c)} not in the built {SUPPORTED}")
    want = {
        "k1": (k1, (c, cin, 3, 3)), "k2": (k2, (c, c, 3, 3)), "k3": (k3, (c, c, 3, 3)),
        "b1": (b1, (c,)), "b2": (b2, (c,)), "b3": (b3, (c,)),
    }
    for key, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, want {shape}")
    if h % 2 or w % 2:
        raise ValueError(f"{name}: H and W must be even, got {h}x{w}")
    return b, h, w, cin, c


def _forward(x, k1, b1, k2, b2, k3, b3, save: bool):
    _common.check_tensors("pyramid_level_fused", x, k1, b1, k2, b2, k3, b3)
    b, h, w, cin, c = _check_level("pyramid_level_fused", x, k1, b1, k2, b2, k3, b3)
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    s1 = torch.empty_like(out) if save else None
    s2 = torch.empty_like(out) if save else None
    packed = None
    if x.dtype == torch.bfloat16:  # the kernels packed on the card: level 0's conv1 tap-major, the rest for wgmma
        n1 = 9 * cin * c if cin == 3 else _common.packed_numel(cin, c)
        packed = torch.empty(n1 + 2 * _common.packed_numel(c, c), dtype=x.dtype, device=x.device)
    _common.launch(
        "pyramid_conv", "pwc_pyramid_level", _ARGTYPES, x.device,
        x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(), b2.data_ptr(),
        k3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        s1.data_ptr() if save else None, s2.data_ptr() if save else None,
        None if packed is None else packed.data_ptr(), b, h, w, cin, c, _common.DTYPE_CODES[x.dtype],
    )
    pyramid_level_fused.launches += 1
    return out, s1, s2


def pyramid_level_residuals(x, k1, b1, k2, b2, k3, b3):
    """K3 with its residuals: ``(out, s1, s2)``, each (B, H/2, W/2, C)."""
    if x.device.type == "cpu":
        return pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts=True)
    return _forward(x, k1, b1, k2, b2, k3, b3, True)


def pyramid_level_bwd(x, k1, k2, k3, out, s1, s2, g, need_dx: bool = True):
    """K6: ``(gz1, gz2, gz3, dx)``, the cotangents of the three
    pre-activations (B, H/2, W/2, C) and of the input (B, H, W, Cin), or
    None for ``dx`` when ``need_dx`` is false.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel.
    """
    if x.device.type == "cpu":
        return pyramid_level_bwd_plain(x, k1, k2, k3, out, s1, s2, g, need_dx)
    _common.check_tensors("pyramid_level_bwd", x, k1, k2, k3, out, s1, s2, g)
    b, h, w, cin, c = _check_level("pyramid_level_bwd", x, k1, None, k2, None, k3, None)
    for key, t in (("out", out), ("s1", s1), ("s2", s2), ("g", g)):
        if tuple(t.shape) != (b, h // 2, w // 2, c):
            raise ValueError(f"pyramid_level_bwd: {key} is {tuple(t.shape)}, want {(b, h // 2, w // 2, c)}")
    gz1, gz2, gz3 = torch.empty_like(out), torch.empty_like(out), torch.empty_like(out)
    dx = torch.empty_like(x) if need_dx else None
    packed = None
    if x.dtype == torch.bfloat16:  # the transposed kernels, packed on the card for wgmma
        n = 2 * _common.packed_numel(c, c) + (_common.packed_numel(c, cin) if cin == 16 else 0)
        packed = torch.empty(n, dtype=x.dtype, device=x.device)
    _common.launch(
        "pyramid_conv_bwd", "pwc_pyramid_level_bwd", _BWD_ARGTYPES, x.device,
        g.data_ptr(), out.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        k1.data_ptr(), k2.data_ptr(), k3.data_ptr(),
        gz1.data_ptr(), gz2.data_ptr(), gz3.data_ptr(), dx.data_ptr() if need_dx else None,
        None if packed is None else packed.data_ptr(), b, h, w, cin, c, _common.DTYPE_CODES[x.dtype],
    )
    pyramid_level_bwd.launches += 1
    return gz1, gz2, gz3, dx


def _weight_grads(x, s1, s2, gz1, gz2, gz3, shapes):
    """dk1..dk3 and db1..db3 from the saved activations and the
    pre-activation cotangents (NHWC): plain conv weight gradients in the
    model dtype and float32 sums for the biases."""

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    xp = F.pad(nchw(x), same_pad_stride2(x.shape[1], x.shape[2]))
    dk1 = torch.nn.grad.conv2d_weight(xp, shapes[0], nchw(gz1), stride=2)
    dk2 = torch.nn.grad.conv2d_weight(nchw(s1), shapes[1], nchw(gz2), padding=1)
    dk3 = torch.nn.grad.conv2d_weight(nchw(s2), shapes[2], nchw(gz3), padding=1)
    db1, db2, db3 = (gz.sum((0, 1, 2), dtype=torch.float32).to(gz.dtype) for gz in (gz1, gz2, gz3))
    return dk1, db1, dk2, db2, dk3, db3


class _PyramidLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2, k3, b3):
        out, s1, s2 = _forward(x, k1, b1, k2, b2, k3, b3, True)
        ctx.save_for_backward(x, k1, k2, k3, out, s1, s2)
        return out

    @staticmethod
    def backward(ctx, g):
        x, k1, k2, k3, out, s1, s2 = ctx.saved_tensors
        gz1, gz2, gz3, dx = pyramid_level_bwd(
            x, k1, k2, k3, out, s1, s2, g.contiguous(), need_dx=ctx.needs_input_grad[0]
        )
        dk1, db1, dk2, db2, dk3, db3 = _weight_grads(
            x, s1, s2, gz1, gz2, gz3, (k1.shape, k2.shape, k3.shape)
        )
        return dx, dk1, db1, dk2, db2, dk3, db3


def pyramid_level_fused(x, k1, b1, k2, b2, k3, b3) -> torch.Tensor:
    """One fused level: x (B, H, W, Cin), H and W even -> (B, H/2, W/2, C).

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel,
    with K6 as its backward. The residuals ``s1`` and ``s2`` are written
    only when a gradient is wanted.
    """
    if x.device.type == "cpu":
        return pyramid_level_plain(x, k1, b1, k2, b2, k3, b3)
    return _on_card(x, k1, b1, k2, b2, k3, b3)


def _on_card(x, k1, b1, k2, b2, k3, b3):
    """The kernel's path: ``_PyramidLevel`` where a gradient is wanted (also
    in a checkpoint's recompute, which runs with grad enabled), else the
    forward alone."""
    if _common.wants_grad(x, k1, b1, k2, b2, k3, b3):
        return _PyramidLevel.apply(x, k1, b1, k2, b2, k3, b3)
    return _forward(x, k1, b1, k2, b2, k3, b3, False)[0]


pyramid_level_fused.launches = 0
pyramid_level_bwd.launches = 0
