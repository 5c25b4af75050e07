"""Per-level optical-flow estimator (reference OpticalFlowEstimator_custom).

concat(cv, features_0, flows_up_prev, features_up_prev), skipping absent
inputs, -> five 3x3 convs [128, 128, 96, 64, 32] with LeakyReLU(0.1) and
optional dense connections (each conv's output concatenated in FRONT of
the running stack) -> a 2-channel flow conv, plus the residual upsampled
flow. Convs are ``conv2d`` .. ``conv2d_5``. The 2x upsampling of flow and
features for the next level happens in PWCDCNet, as in the JAX package.

``rows``: a ``parallel.SpatialGuard`` when the level is row-sharded; each
conv then exchanges its halo rows. The fused chain does not run there.

``fused``: run the six-conv chain through K7's wrapper
(``ops/cuda/estimator_conv.py``: the CUDA kernels on a CUDA tensor, the
plain chain on the CPU) in place of six library convs; same parameters,
same state-dict keys. Its input goes in with the channels zero-padded to a
multiple of 8, in the NHWC copy made anyway. Ignored with ``use_dc``, which the chain does not
implement.

``FlowEstimatorLegacy`` is the legacy ``PWCNet``'s estimator (reference
OpticalFlowEstimator): concat(cost, features, flow) -> the five convs, each
followed by an optional ``bn_{i}`` and LeakyReLU(0.2) -> ``conv2d_5``, a
2-channel flow that is not residual. It returns ``(features, flow)``.
``BatchNorm`` is flax's ``nn.BatchNorm`` (momentum 0.99, eps 1e-5):
statistics over (B, H, W) in float32 as E[x^2] - E[x]^2 clipped at 0, and
the running variance updated with that biased variance, where
``torch.nn.BatchNorm2d`` would take the unbiased one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pwcnet_tpu_torch.models.conv import Conv2d, cast_params, conv_name, to_nchw, to_nhwc
from pwcnet_tpu_torch.ops.activation import leaky_relu

__all__ = ["BatchNorm", "DEFAULT_EST_FILTERS", "FlowEstimator", "FlowEstimatorLegacy"]

DEFAULT_EST_FILTERS = (128, 128, 96, 64, 32)


class FlowEstimator(nn.Module):
    def __init__(
        self,
        in_channels: int,
        use_dc: bool = False,
        filters: Sequence[int] = DEFAULT_EST_FILTERS,
        fused: bool = False,
    ):
        super().__init__()
        self.use_dc = use_dc
        self.fused = fused and not use_dc
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
        rows=None,
    ):
        """NCHW in; returns ``(flows, features)``."""
        parts = [t for t in (cv, features_0, flows_up_prev, features_up_prev) if t is not None]
        features = torch.cat(parts, 1)
        if self.fused and rows is None:
            from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_fused

            kbs = []
            for idx in range(self.n_hidden + 1):
                kbs.extend(cast_params(getattr(self, conv_name(idx))))
            flows, features = estimator_chain_fused(to_nhwc(features, 8), *kbs)
            flows, features = to_nchw(flows), to_nchw(features)
            if flows_up_prev is not None:
                flows = flows + flows_up_prev
            return flows, features

        def conv(idx, x):
            module = getattr(self, conv_name(idx))
            return module(x) if rows is None else rows.conv(module, x)

        for idx in range(self.n_hidden):
            y = leaky_relu(conv(idx, features), 0.1)
            features = torch.cat([y, features], 1) if self.use_dc else y
        flows = conv(self.n_hidden, features)
        if flows_up_prev is not None:
            flows = flows + flows_up_prev  # residual coarse-to-fine refinement
        return flows, features


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over the channels of an NCHW tensor: parameters
    ``scale`` and ``bias``, running statistics ``mean`` and ``var`` (buffers,
    flax's ``batch_stats``). ``train=True`` normalises by the batch's
    statistics and updates the running ones; else it uses the running ones.
    Computes in float32 and returns the input's dtype."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean = x32.mean((0, 2, 3))
            var = ((x32 * x32).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean.float() + (1 - m) * mean)
                self.var.copy_(m * self.var.float() + (1 - m) * var)
        else:
            mean, var = self.mean.float(), self.var.float()
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class FlowEstimatorLegacy(nn.Module):
    def __init__(self, in_channels: int, batch_norm: bool = False, filters: Sequence[int] = DEFAULT_EST_FILTERS):
        super().__init__()
        self.n_hidden = len(filters)
        self.batch_norm = batch_norm
        cin = in_channels
        for idx, f in enumerate(filters):
            self.add_module(conv_name(idx), Conv2d(cin, f, 3, padding=1))
            if batch_norm:
                self.add_module(f"bn_{idx}", BatchNorm(f))
            cin = f
        self.add_module(conv_name(len(filters)), Conv2d(cin, 2, 3, padding=1))

    def forward(self, cost: torch.Tensor, x: torch.Tensor, flow: torch.Tensor, train: bool = False):
        """NCHW in; returns ``(features, flow)``."""
        h = torch.cat([cost, x, flow.to(cost.dtype)], 1)
        for idx in range(self.n_hidden):
            h = getattr(self, conv_name(idx))(h)
            if self.batch_norm:
                h = getattr(self, f"bn_{idx}")(h, train=train)
            h = leaky_relu(h, 0.2)
        return h, getattr(self, conv_name(self.n_hidden))(h)
