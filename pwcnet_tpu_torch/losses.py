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

Under H-sharding each rank holds a stripe of the ground-truth rows and, per
level, a stripe of the prediction (a sharded level) or all of it (a
replicated one). ``scored_rows`` picks the prediction rows whose
nearest-resize source row lies in the rank's ground-truth stripe, so every
loss row is counted by exactly one rank; ``level_sums`` gives the per-level
sums over those rows, which the train step reduces over the ranks.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from pwcnet_tpu_torch.ops.resize import device_table, nearest_indices, nearest_tensor, resize_nearest

__all__ = [
    "DEFAULT_WEIGHTS", "l1_loss", "l2_loss", "epe", "level_sums", "multiscale_loss", "multirobust_loss",
    "scored_rows", "weight_decay",
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


def scored_rows(gt: torch.Tensor, pred: torch.Tensor, frame_rows: int, index: int, n: int, sharded: bool):
    """``(gt_down, pred)`` restricted to the rows this shard scores.

    ``gt`` (B, frame_rows / n, W, 2) is shard ``index``'s stripe of the
    ground truth; ``pred`` (B, h, w, 2) is the shard's stripe of a level of
    h * n rows (``sharded``) or the whole level of h rows. A level row is
    scored where its TF1 nearest-resize source row lies in the stripe. The
    source rows rise with the level row, so the scored rows are one run of
    ``pred``'s, taken by ``narrow`` (its backward writes each row once)."""
    hs, w_full = gt.shape[1], gt.shape[2]
    hp, wp = pred.shape[1], pred.shape[2]

    def build(device):
        g0, p0 = index * hs, (index * hp if sharded else 0)
        src = nearest_indices(frame_rows, hp * n if sharded else hp)[p0 : p0 + hp]
        keep = np.flatnonzero((src >= g0) & (src < g0 + hs))
        first = int(keep[0]) if keep.size else 0
        return torch.from_numpy(src[keep] - g0).to(device), first, int(keep.size)

    rows, first, count = device_table(("scored_rows", frame_rows, hs, hp, index, n, bool(sharded)), gt.device, build)
    gt_down = gt.index_select(1, rows).index_select(2, nearest_tensor(w_full, wp, gt.device))
    return gt_down, pred.narrow(1, first, count)


def level_sums(gt: torch.Tensor, preds, frame_rows: int, index: int, n: int, sharded, norm: str) -> torch.Tensor:
    """Per level, the sum over the local batch and this shard's scored rows
    of the per-pixel L2 (``norm='l2'``) or L1 flow distance: (L,)."""
    sums = []
    for pred, sh in zip(preds, sharded):
        g, p = scored_rows(gt, pred, frame_rows, index, n, sh)
        diff = g - p
        sums.append((diff * diff).sum(3).sqrt().sum() if norm == "l2" else diff.abs().sum())
    return torch.stack(sums)
