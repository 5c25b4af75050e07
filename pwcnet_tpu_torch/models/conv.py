"""Conv naming and flax-style initialisation shared by the models.

Conv layers are named ``conv2d``, ``conv2d_1``, ... in TF auto-numbering
order, as in the JAX package and the reference checkpoints, so state-dict
keys read ``fp_extractor.conv2d_3.weight``. Weights are PyTorch's OIHW.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["conv_name", "glorot_init_", "to_nchw", "to_nhwc"]


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
