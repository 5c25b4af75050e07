"""K3: one fused feature-pyramid level as a CUDA kernel (``csrc/pyramid_conv.cu``).

Replaces ``pwcnet_tpu/ops/pallas/pyramid_conv.py::pyramid_level_fused``
(forward only). One level is conv3x3 stride 2 (TF SAME) -> +b, LeakyReLU(0.1)
-> conv3x3 -> LeakyReLU -> conv3x3 -> LeakyReLU, float32 accumulation, the
activations rounded to the model dtype between the convs.

Activations are NHWC as in the JAX package; the kernels ``k1..k3`` are
PyTorch's OIHW conv weights (the port's parameter layout), biases (C,).
The plain version, ``pyramid_level_plain``, is the same chain as three
``F.conv2d`` calls in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P

__all__ = ["pyramid_level_fused", "pyramid_level_plain", "same_pad_stride2", "SUPPORTED"]

_ARGTYPES = [P] * 8 + [I] * 6 + [P]
# (Cin, C) pairs the kernel is built for: the two finest PWCDCNet levels
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


def pyramid_level_plain(x, k1, b1, k2, b2, k3, b3) -> torch.Tensor:
    """The level in plain PyTorch: (B, H, W, Cin) NHWC -> (B, H/2, W/2, C)."""
    dt = x.dtype
    y = x.permute(0, 3, 1, 2).float()
    y = F.pad(y, same_pad_stride2(y.shape[2], y.shape[3]))
    y = F.leaky_relu(F.conv2d(y, k1.float(), b1.float(), stride=2), 0.1).to(dt).float()
    y = F.leaky_relu(F.conv2d(y, k2.float(), b2.float(), padding=1), 0.1).to(dt).float()
    y = F.leaky_relu(F.conv2d(y, k3.float(), b3.float(), padding=1), 0.1).to(dt)
    return y.permute(0, 2, 3, 1).contiguous()


def pyramid_level_fused(x, k1, b1, k2, b2, k3, b3) -> torch.Tensor:
    """One fused level: x (B, H, W, Cin), H and W even -> (B, H/2, W/2, C).

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel.
    """
    if x.device.type == "cpu":
        return pyramid_level_plain(x, k1, b1, k2, b2, k3, b3)
    _common.check_tensors("pyramid_level_fused", x, k1, b1, k2, b2, k3, b3)
    if x.dim() != 4:
        raise ValueError(f"pyramid_level_fused: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    c = k1.shape[0]
    if (cin, c) not in SUPPORTED:
        raise ValueError(f"pyramid_level_fused: (Cin, C) = {(cin, c)} not in the built {SUPPORTED}")
    want = {
        "k1": (k1, (c, cin, 3, 3)), "k2": (k2, (c, c, 3, 3)), "k3": (k3, (c, c, 3, 3)),
        "b1": (b1, (c,)), "b2": (b2, (c,)), "b3": (b3, (c,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"pyramid_level_fused: {name} is {tuple(t.shape)}, want {shape}")
    if h % 2 or w % 2:
        raise ValueError(f"pyramid_level_fused: H and W must be even, got {h}x{w}")
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    _common.launch(
        "pyramid_conv", "pwc_pyramid_level", _ARGTYPES, x.device,
        x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(), b2.data_ptr(),
        k3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        b, h, w, cin, c, _common.DTYPE_CODES[x.dtype],
    )
    pyramid_level_fused.launches += 1
    return out


pyramid_level_fused.launches = 0
