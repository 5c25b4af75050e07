"""Optical-flow training losses and metrics (counterpart of ``pwcnet_tpu/losses.py``).

Conventions kept from the reference:

- ``l1_loss`` / ``l2_loss`` reduce per-pixel flow-vector norms by a *sum
  over pixels* and a mean over the batch, so the loss scales with the crop
  area;
- ``epe`` is the mean per-pixel L2 norm on unscaled full-resolution flow;
- the pyramid losses scale the ground truth by 1/20 and downsample it to
  each level with the TF1 nearest-neighbour resize, with no magnitude
  rescale;
- ``multirobust_loss`` is the per-level ``weight * (L1 + epsilon)**q``;
- ``weight_decay`` is ``sum_v ||v||^2 / 2`` over all parameters, biases
  included, in float32.

Flows are NHWC, (B, H, W, 2).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from pwcnet_tpu_torch.ops.resize import resize_nearest

__all__ = [
    "DEFAULT_WEIGHTS", "l1_loss", "l2_loss", "epe", "multiscale_loss", "multirobust_loss", "weight_decay",
]

DEFAULT_WEIGHTS = (0.32, 0.08, 0.02, 0.01, 0.005)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().sum(3).sum((1, 2)).mean()


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).sum(3).sqrt().sum((1, 2)).mean()


def epe(flows_gt: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """End-point error: mean per-pixel L2 distance (unscaled flows)."""
    return ((flows_gt - flows) ** 2).sum(3).sqrt().mean()


def multiscale_loss(
    flows_gt: torch.Tensor,
    flows_pyramid: Sequence[torch.Tensor],
    weights: Sequence[float] = DEFAULT_WEIGHTS,
) -> torch.Tensor:
    """Weighted multi-level L2 loss on 1/20-scaled ground truth."""
    gt_scaled = flows_gt / 20.0
    total = flows_gt.new_zeros(())
    for weight, flows in zip(weights, flows_pyramid):
        gt_down = resize_nearest(gt_scaled, flows.shape[1:3])
        total = total + weight * l2_loss(gt_down, flows)
    return total


def multirobust_loss(
    flows_gt: torch.Tensor,
    flows_pyramid: Sequence[torch.Tensor],
    weights: Sequence[float] = DEFAULT_WEIGHTS,
    epsilon: float = 0.01,
    q: float = 0.4,
) -> torch.Tensor:
    """Robust multi-level loss: sum_l weight_l * (L1_l + eps)**q."""
    gt_scaled = flows_gt / 20.0
    total = flows_gt.new_zeros(())
    for weight, flows in zip(weights, flows_pyramid):
        gt_down = resize_nearest(gt_scaled, flows.shape[1:3])
        total = total + weight * (l1_loss(gt_down, flows) + epsilon) ** q
    return total


def weight_decay(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """0.5 * the sum of squared parameter values, in float32."""
    return 0.5 * sum(p.float().square().sum() for p in params)
