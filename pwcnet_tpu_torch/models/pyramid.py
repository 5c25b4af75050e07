"""Feature pyramid extractor of PWCDCNet (reference FeaturePyramidExtractor_custom).

Per level: three 3x3 convs with strides (2, 1, 1), each followed by
LeakyReLU(0.1), filters 16/32/64/96/128/192. The pyramid is returned deep
-> shallow. TF SAME with stride 2 on an even size pads only the bottom and
right, so the stride-2 conv runs on ``F.pad(x, same_pad_stride2(...))``
with ``padding=0``.

``fused_levels``: compute the N finest levels with one fused kernel call
each (K3, ``ops.cuda.pyramid_conv.pyramid_level_fused``) on the same
parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pwcnet_tpu_torch.models.conv import conv_name, to_nchw, to_nhwc
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused, same_pad_stride2

__all__ = ["DEFAULT_FILTERS", "FeaturePyramidExtractor"]

DEFAULT_FILTERS = (16, 32, 64, 96, 128, 192)


class FeaturePyramidExtractor(nn.Module):
    def __init__(
        self,
        num_levels: int = 6,
        filters: Sequence[int] = DEFAULT_FILTERS,
        fused_levels: int = 0,
    ):
        super().__init__()
        self.num_levels = num_levels
        self.fused_levels = fused_levels
        cin = 3
        for level in range(num_levels):
            for i, stride in enumerate((2, 1, 1)):
                conv = nn.Conv2d(cin, filters[level], 3, stride=stride, padding=0 if stride == 2 else 1)
                self.add_module(conv_name(3 * level + i), conv)
                cin = filters[level]

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """``images`` (B, 3, H, W) -> per-level (B, C_l, H_l, W_l), deep first."""
        x = images
        pyramid = []
        for level in range(self.num_levels):
            convs = [getattr(self, conv_name(3 * level + i)) for i in range(3)]
            if level < self.fused_levels:
                params = [t for c in convs for t in (c.weight, c.bias)]
                x = to_nchw(pyramid_level_fused(to_nhwc(x), *params))
            else:
                x = F.pad(x, same_pad_stride2(x.shape[2], x.shape[3]))
                for conv in convs:
                    x = F.leaky_relu(conv(x), 0.1)
            pyramid.append(x)
        return pyramid[::-1]
