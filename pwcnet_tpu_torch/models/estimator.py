"""Per-level optical-flow estimator (reference OpticalFlowEstimator_custom).

concat(cv, features_0, flows_up_prev, features_up_prev), skipping absent
inputs, -> five 3x3 convs [128, 128, 96, 64, 32] with LeakyReLU(0.1) and
optional dense connections (each conv's output concatenated in FRONT of
the running stack) -> a 2-channel flow conv, plus the residual upsampled
flow. Convs are ``conv2d`` .. ``conv2d_5``. The 2x upsampling of flow and
features for the next level happens in PWCDCNet, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pwcnet_tpu_torch.models.conv import Conv2d, conv_name
from pwcnet_tpu_torch.ops.activation import leaky_relu

__all__ = ["DEFAULT_EST_FILTERS", "FlowEstimator"]

DEFAULT_EST_FILTERS = (128, 128, 96, 64, 32)


class FlowEstimator(nn.Module):
    def __init__(
        self,
        in_channels: int,
        use_dc: bool = False,
        filters: Sequence[int] = DEFAULT_EST_FILTERS,
    ):
        super().__init__()
        self.use_dc = use_dc
        self.n_hidden = len(filters)
        cin = in_channels
        for idx, f in enumerate(filters):
            self.add_module(conv_name(idx), Conv2d(cin, f, 3, padding=1))
            cin = f + cin if use_dc else f
        self.add_module(conv_name(len(filters)), Conv2d(cin, 2, 3, padding=1))
        self.out_channels = cin  # width of the returned features

    def forward(
        self,
        cv: torch.Tensor,
        features_0: Optional[torch.Tensor] = None,
        flows_up_prev: Optional[torch.Tensor] = None,
        features_up_prev: Optional[torch.Tensor] = None,
    ):
        """NCHW in; returns ``(flows, features)``."""
        parts = [t for t in (cv, features_0, flows_up_prev, features_up_prev) if t is not None]
        features = torch.cat(parts, 1)
        for idx in range(self.n_hidden):
            conv = leaky_relu(getattr(self, conv_name(idx))(features), 0.1)
            features = torch.cat([conv, features], 1) if self.use_dc else conv
        flows = getattr(self, conv_name(self.n_hidden))(features)
        if flows_up_prev is not None:
            flows = flows + flows_up_prev  # residual coarse-to-fine refinement
        return flows, features
