"""Feature pyramid extractor of PWCDCNet (reference FeaturePyramidExtractor_custom).

Per level: three 3x3 convs with strides (2, 1, 1), each followed by
LeakyReLU(0.1), filters 16/32/64/96/128/192. The pyramid is returned deep
-> shallow. TF SAME with stride 2 on an even size pads only the bottom and
right, so the stride-2 conv runs on ``F.pad(x, same_pad_stride2(...))``
with ``padding=0``.

``fused_levels``: compute the N finest levels with one fused kernel call
each (K3, ``ops.cuda.pyramid_conv.pyramid_level_fused``) on the same
parameters; ``level_fn`` replaces that call on row-sharded levels (the
JAX package's ``level_fn``, e.g. ``parallel.make_spatial_pyramid_level``).

Under H-sharding (``guard``, a ``parallel.SpatialGuard``) the images arrive
as row shards; a level stays sharded while its output holds at least 4
rows per shard (the JAX guard's ``guard(x, 8)`` on its input), and the
first level that does not gathers its input and runs replicated, as does
every coarser one. Sharded levels run ``level_fn`` or the convs with halos.

``FeaturePyramidExtractorLegacy`` is the legacy ``PWCNet``'s pyramid (the
reference's original variant): two convs a level, strides (2, 1), each
followed by LeakyReLU(0.1), ``conv2d`` .. ``conv2d_11`` for 6 levels; no
fused kernel and no sharding, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pwcnet_tpu_torch.models.conv import Conv2d, cast_params, conv_name, to_nchw, to_nhwc
from pwcnet_tpu_torch.ops.activation import leaky_relu
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused, same_pad_stride2

__all__ = ["DEFAULT_FILTERS", "FeaturePyramidExtractor", "FeaturePyramidExtractorLegacy"]

DEFAULT_FILTERS = (16, 32, 64, 96, 128, 192)


class FeaturePyramidExtractor(nn.Module):
    def __init__(
        self,
        num_levels: int = 6,
        filters: Sequence[int] = DEFAULT_FILTERS,
        fused_levels: int = 0,
        level_fn=None,
    ):
        super().__init__()
        self.num_levels = num_levels
        self.fused_levels = fused_levels
        self.level_fn = level_fn
        cin = 3
        for level in range(num_levels):
            for i, stride in enumerate((2, 1, 1)):
                conv = Conv2d(cin, filters[level], 3, stride=stride, padding=0 if stride == 2 else 1)
                self.add_module(conv_name(3 * level + i), conv)
                cin = filters[level]

    def forward(self, images: torch.Tensor, guard=None) -> list[torch.Tensor]:
        """``images`` (B, 3, H, W) -> per-level (B, C_l, H_l, W_l), deep first.
        With ``guard`` the images are this rank's row shard, and each level
        is a shard or the whole level as ``guard.keeps`` decides."""
        x = images
        pyramid = []
        sharded = guard is not None
        rows = x.shape[2] * (guard.size if sharded else 1)
        for level in range(self.num_levels):
            convs = [getattr(self, conv_name(3 * level + i)) for i in range(3)]
            rows //= 2
            if sharded and not guard.keeps(rows):
                x, sharded = guard.gather(x), False
            if sharded:
                x = self._sharded_level(x, convs, level, guard)
            elif level < self.fused_levels:
                params = [t for c in convs for t in cast_params(c)]
                x = to_nchw(pyramid_level_fused(to_nhwc(x), *params))
            else:
                x = F.pad(x, same_pad_stride2(x.shape[2], x.shape[3]))
                for conv in convs:
                    x = leaky_relu(conv(x), 0.1)
            pyramid.append(x)
        return pyramid[::-1]

    def _sharded_level(self, x, convs, level, guard):
        params = [t for c in convs for t in cast_params(c)]
        level_fn = self.level_fn if level < self.fused_levels and self.level_fn is not None else guard.level_chain
        return to_nchw(level_fn(to_nhwc(x), *params))


class FeaturePyramidExtractorLegacy(nn.Module):
    def __init__(self, num_levels: int = 6, filters: Sequence[int] = DEFAULT_FILTERS):
        super().__init__()
        self.num_levels = num_levels
        cin = 3
        for level in range(num_levels):
            for i, stride in enumerate((2, 1)):
                conv = Conv2d(cin, filters[level], 3, stride=stride, padding=0 if stride == 2 else 1)
                self.add_module(conv_name(2 * level + i), conv)
                cin = filters[level]

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """``images`` (B, 3, H, W) -> per-level (B, C_l, H_l, W_l), deep first."""
        x = images
        pyramid = []
        for level in range(self.num_levels):
            x = F.pad(x, same_pad_stride2(x.shape[2], x.shape[3]))
            for i in range(2):
                x = leaky_relu(getattr(self, conv_name(2 * level + i))(x), 0.1)
            pyramid.append(x)
        return pyramid[::-1]
