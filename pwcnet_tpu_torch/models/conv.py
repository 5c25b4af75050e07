"""Conv naming and flax-style initialisation shared by the models.

Conv layers are named ``conv2d``, ``conv2d_1``, ... in TF auto-numbering
order, as in the JAX package and the reference checkpoints, so state-dict
keys read ``fp_extractor.conv2d_3.weight``. Weights are PyTorch's OIHW.

``Conv2d`` is ``nn.Conv2d`` with a ``compute_dtype``: when set, weight and
bias are cast to it at every use, as flax casts ``param_dtype`` parameters
to the module's ``dtype``. Float32 master parameters then get float32
gradients from a bfloat16 forward. (``torch.autocast`` would pick dtypes
per op from its own lists, not the JAX model's.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["Conv2d", "cast_params", "conv_name", "glorot_init_", "to_nchw", "to_nhwc"]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (None: the parameters' dtype)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, *cast_params(self))


def cast_params(conv: Conv2d) -> tuple[torch.Tensor, torch.Tensor]:
    """``conv``'s weight and bias in its compute dtype."""
    dt = conv.compute_dtype
    if dt is None or dt == conv.weight.dtype:
        return conv.weight, conv.bias
    return conv.weight.to(dt), conv.bias.to(dt)


def conv_name(idx: int) -> str:
    return "conv2d" if idx == 0 else f"conv2d_{idx}"


@torch.no_grad()
def glorot_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default init for every Conv2d below ``module``: glorot-uniform
    kernels (fan_in = kh*kw*cin, fan_out = kh*kw*cout) and zero biases,
    drawn from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            cout, cin, kh, kw = m.weight.shape
            limit = math.sqrt(6.0 / (kh * kw * (cin + cout)))
            u = torch.rand(m.weight.shape, generator=generator, dtype=torch.float32)
            m.weight.copy_(u * (2 * limit) - limit)
            if m.bias is not None:
                m.bias.zero_()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> contiguous (B, H, W, C); free for channels_last tensors."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) view, channels_last when ``x`` is contiguous."""
    return x.permute(0, 3, 1, 2)
