"""PWCDCNet, the reference's working model (model.py:74-138), in PyTorch.

- a shared 6-level feature pyramid over both frames (deep -> shallow);
- coarse to fine: at the deepest level a cost volume with no warp; at the
  finer levels frame-1 features are bilinear-warped by the upsampled flow
  scaled to pixels by ``20 / 2**(num_levels - l)``;
- per-level estimators threading the upsampled flow and features;
- at ``output_level``: the dilated context net, then a TF1 bilinear resize
  by ``2**(num_levels - output_level)`` and x20 to full-resolution pixels.

Inputs and outputs are NHWC as in the JAX package; inside, tensors are
NCHW in ``channels_last`` memory, so the NHWC views handed to the kernels
need no copy. The model computes in ``compute_dtype``; by default that is
the dtype of its parameters (``model.to(torch.bfloat16)`` is bf16 serving).
Training keeps float32 parameters and sets ``compute_dtype=torch.bfloat16``:
every conv casts its weight and bias at use, so the gradients arrive in
float32 (the JAX model's ``dtype`` with float32 ``param_dtype``).

Hooks, with the JAX package's meaning:

- ``cost_volume_fn(f0, f1, d)`` on NHWC tensors (K2 on the card);
- ``warp_cv_fn(f0, f1, flow_px, d)``, the fused bilinear warp + cost volume
  at the warped levels (K1); requires ``warp_type='bilinear'``;
- ``fused_pyramid_levels``: the N finest pyramid levels through K3's
  wrapper.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from pwcnet_tpu_torch.models.context import ContextNetwork
from pwcnet_tpu_torch.models.conv import Conv2d, glorot_init_, to_nchw, to_nhwc
from pwcnet_tpu_torch.models.estimator import FlowEstimator
from pwcnet_tpu_torch.models.pyramid import DEFAULT_FILTERS, FeaturePyramidExtractor
from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.resize import resize_bilinear, upsample2x_bilinear
from pwcnet_tpu_torch.ops.warp import warp

__all__ = ["PWCDCNet", "flow_scales"]


def flow_scales(num_levels: int) -> list:
    """Pixel-unit factor per level, ``20 / 2**(num_levels - l)`` (None at 0)."""
    return [None] + [20.0 / 2 ** (num_levels - l) for l in range(1, num_levels + 1)]


class PWCDCNet(nn.Module):
    """PWC-Net with dense-connectable estimators and the context network.

    Only ``optflow_0 .. optflow_{output_level}`` exist: deeper estimators
    would never run, and the reference checkpoints hold none.
    ``generator`` seeds the flax-style init (seed 0 when omitted).
    """

    def __init__(
        self,
        num_levels: int = 6,
        search_range: int = 4,
        warp_type: str = "bilinear",
        use_dc: bool = False,
        output_level: int = 4,
        cost_volume_fn: Optional[Callable] = None,
        warp_cv_fn: Optional[Callable] = None,
        fused_pyramid_levels: int = 0,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if output_level >= num_levels:
            raise ValueError("Should set output_level < num_levels")
        if warp_type not in ("bilinear", "nearest"):
            raise ValueError(f"warp_type must be 'nearest' or 'bilinear', got {warp_type!r}")
        if warp_cv_fn is not None and warp_type != "bilinear":
            raise ValueError(
                f"warp_cv_fn fuses the bilinear warp; use warp_type='bilinear', not {warp_type!r}"
            )
        self.num_levels = num_levels
        self.search_range = search_range
        self.warp_type = warp_type
        self.output_level = output_level
        self.cost_volume_fn = cost_volume_fn
        self.warp_cv_fn = warp_cv_fn

        self.fp_extractor = FeaturePyramidExtractor(num_levels, fused_levels=fused_pyramid_levels)
        taps = (2 * search_range + 1) ** 2
        feat = 0
        for l in range(output_level + 1):
            cin = taps + DEFAULT_FILTERS[num_levels - 1 - l] + (0 if l == 0 else 2 + feat)
            est = FlowEstimator(cin, use_dc=use_dc)
            self.add_module(f"optflow_{l}", est)
            feat = est.out_channels
        self.context = ContextNetwork(2 + feat)
        glorot_init_(self, generator or torch.Generator().manual_seed(0))
        self.compute_dtype = compute_dtype
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.compute_dtype = compute_dtype

    def forward(self, images_0: torch.Tensor, images_1: torch.Tensor):
        """``images_*`` (B, H, W, 3) in [0, 1], H and W multiples of
        ``2**num_levels``. Returns ``(flows_final (B, H, W, 2) pixels,
        flows_pyramid)``, the pyramid deep -> output level in internal
        units (pixels / 20 at full resolution), each (B, h, w, 2)."""
        dtype = self.compute_dtype or self.fp_extractor.conv2d.weight.dtype
        pyramid_0 = self.fp_extractor(to_nchw(images_0.to(dtype)))
        pyramid_1 = self.fp_extractor(to_nchw(images_1.to(dtype)))
        scales = flow_scales(self.num_levels)
        cv_fn = self.cost_volume_fn or cost_volume
        d = self.search_range

        flows_pyramid = []
        flows_up = features_up = None
        for l, (f0, f1) in enumerate(zip(pyramid_0, pyramid_1)):
            f0n, f1n = to_nhwc(f0), to_nhwc(f1)
            if l == 0:
                cv = cv_fn(f0n, f1n, d)
            else:
                flow_px = to_nhwc(flows_up * scales[l])
                if self.warp_cv_fn is not None:
                    cv = self.warp_cv_fn(f0n, f1n, flow_px, d)
                else:
                    cv = cv_fn(f0n, warp(f1n, flow_px, self.warp_type), d)
            flows, features = getattr(self, f"optflow_{l}")(
                to_nchw(cv), f0, flows_up, features_up
            )
            if l < self.output_level:
                # one joint 2+C-channel upsample: bilinear resize is
                # channelwise, so this equals two separate resizes
                fu = to_nchw(upsample2x_bilinear(to_nhwc(torch.cat([flows, features], 1))))
                flows_up, features_up = fu[:, :2], fu[:, 2:]
                flows_pyramid.append(flows)
            else:
                flows = self.context(flows, features)
                flows_pyramid.append(flows)
                up = 2 ** (self.num_levels - self.output_level)
                h, w = flows.shape[2], flows.shape[3]
                flows_final = resize_bilinear(to_nhwc(flows), (h * up, w * up)) * 20.0
                return flows_final, [to_nhwc(f) for f in flows_pyramid]
