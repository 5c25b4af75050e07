"""Plain float32 training step of the reference: the multiscale loss, the
weight decay and Adam with TF's defaults, followed step by step.

- the loss is ``sum_l w_l * L2_l + gamma * sum_v ||v||^2 / 2``, where
  ``L2_l`` sums the per-pixel L2 distance between level ``l``'s flow and
  the ground truth / 20, taken at each level by TF1's nearest resize, over
  the pixels, and averages it over the batch (the reference's
  ``multiscale_loss``, weights 0.32, 0.08, 0.02, 0.01, 0.005, gamma 4e-4);
- Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction, learning rate 1e-4 (the reference's first 200 000 steps).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["WEIGHTS", "GAMMA", "LR", "nearest_down", "data_loss", "follow_steps"]

WEIGHTS = (0.32, 0.08, 0.02, 0.01, 0.005)
GAMMA = 4e-4
LR = 1e-4
B1, B2, EPS = 0.9, 0.999, 1e-8


def nearest_down(gt: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """TF1 ``resize_nearest_neighbor`` of (B, H, W, 2) to (h, w): source
    index ``min(floor(i * (in / out)), in - 1)`` in float32."""

    def index(n_in, n_out):
        src = np.arange(n_out, dtype=np.float32) * (np.float32(n_in) / np.float32(n_out))
        return torch.from_numpy(np.minimum(np.floor(src), n_in - 1).astype(np.int64)).to(gt.device)

    return gt.index_select(1, index(gt.shape[1], h)).index_select(2, index(gt.shape[2], w))


def data_loss(flows_pyramid, gt: torch.Tensor, batch: int) -> torch.Tensor:
    """The multiscale loss of these rows, as their share of a batch of ``batch``."""
    scaled = gt / 20.0
    total = gt.new_zeros(())
    for weight, flow in zip(WEIGHTS, flows_pyramid):
        diff = nearest_down(scaled, flow.shape[1], flow.shape[2]) - flow
        total = total + weight * (diff * diff).sum(3).sqrt().sum() / batch
    return total


def follow_steps(model, batches, precision=None, chunk: int = 8, rows: float = 1.0, moments=None,
                 count: int = 0) -> dict:
    """Run ``len(batches)`` Adam steps of ``model`` (updated in place) on
    ``batches`` of ``(images (B, 2, H, W, 3), flows_gt (B, H, W, 2))``.

    Each batch runs in chunks of ``chunk`` rows and the gradients add up, so
    the step is the whole batch's. ``rows`` < 1 keeps only that share of each
    batch, the loss averaged over it (a fault: half the batch left out).
    Adam starts from zero moments and step 0, or from ``moments`` (first and
    second, by parameter name; copied) after ``count`` steps.

    Returns ``{"losses": [each step's multiscale loss], "grad1": {name:
    first gradient with the decay, as Adam gets it}}``."""
    params = dict(model.named_parameters())
    if moments is None:
        mu = {k: torch.zeros_like(p) for k, p in params.items()}
        nu = {k: torch.zeros_like(p) for k, p in params.items()}
    else:
        mu, nu = ({k: m[k].clone() for k in params} for m in moments)
    out, first = {"losses": []}, {}
    for i, (images, gt) in enumerate(batches):
        t = count + i + 1
        n = max(1, int(round(images.shape[0] * rows)))
        images, gt = images[:n], gt[:n]
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss = 0.0
        for s in range(0, n, chunk):
            _, pyramid = model(images[s:s + chunk, 0], images[s:s + chunk, 1], precision)
            part = data_loss(pyramid, gt[s:s + chunk], n)
            for k, g in zip(params, torch.autograd.grad(part, list(params.values()))):
                grads[k] += g
            loss += float(part.detach())
        out["losses"].append(loss)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] + GAMMA * p
                if i == 0:
                    first[k] = g
                mu[k].mul_(B1).add_(g, alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                denom = (nu[k] / (1 - B2 ** t)).sqrt() + EPS
                p.addcdiv_(mu[k], denom, value=-LR / (1 - B1 ** t))
    out["grad1"] = first
    return out
