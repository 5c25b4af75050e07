"""Dilated-convolution context network (reference ContextNetwork).

concat(flows, features) -> seven 3x3 convs, filters [128, 128, 128, 96,
64, 32, 2], dilations [1, 2, 4, 8, 16, 1, 1], LeakyReLU(0.1) on all but
the last; the result is a residual added onto the input flow. SAME with
dilation d pads d on each side.
"""

from __future__ import annotations

import torch
from torch import nn

from pwcnet_tpu_torch.models.conv import Conv2d, conv_name
from pwcnet_tpu_torch.ops.activation import leaky_relu

__all__ = ["CONTEXT_DILATIONS", "CONTEXT_FILTERS", "ContextNetwork"]

CONTEXT_FILTERS = (128, 128, 128, 96, 64, 32, 2)
CONTEXT_DILATIONS = (1, 2, 4, 8, 16, 1, 1)


class ContextNetwork(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        cin = in_channels
        for idx, (f, d) in enumerate(zip(CONTEXT_FILTERS, CONTEXT_DILATIONS)):
            self.add_module(conv_name(idx), Conv2d(cin, f, 3, padding=d, dilation=d))
            cin = f

    def forward(self, flows: torch.Tensor, features: torch.Tensor, rows=None) -> torch.Tensor:
        """``rows``: a ``parallel.SpatialGuard`` when the level is row-sharded
        (each conv exchanges its dilation's worth of halo rows)."""
        x = torch.cat([flows, features], 1)
        n = len(CONTEXT_FILTERS)
        for idx in range(n):
            module = getattr(self, conv_name(idx))
            x = module(x) if rows is None else rows.conv(module, x)
            if idx < n - 1:
                x = leaky_relu(x, 0.1)
        return flows + x
