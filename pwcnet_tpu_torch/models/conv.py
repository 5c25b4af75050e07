"""Conv naming shared by the models.

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

from typing import Optional

import torch
from torch import nn

__all__ = ["Conv2d", "cast_params", "conv_name", "to_nchw", "to_nhwc"]


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


def to_nhwc(x: torch.Tensor, multiple: int = 1) -> torch.Tensor:
    """(B, C, H, W) -> contiguous (B, H, W, C'); free for channels_last tensors.

    ``multiple``: C' is C rounded up to it, the tail zero, written in the same
    copy (the bf16 estimator kernel reads its input by TMA, which needs
    16-byte strides: ``multiple=8``)."""
    b, c, h, w = x.shape
    cp = -(-c // multiple) * multiple
    if cp == c:
        return x.permute(0, 2, 3, 1).contiguous()
    out = x.new_empty((b, h, w, cp))
    out[..., c:].zero_()
    out[..., :c].copy_(x.permute(0, 2, 3, 1))
    return out


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) view, channels_last when ``x`` is contiguous."""
    return x.permute(0, 3, 1, 2)
