"""Local cost-volume correlation (max displacement d): the plain version of K2.

Semantics (the reference's pad/multiply/crop construction)::

    cv[b, y, x, (v+d)*(2d+1) + (u+d)] =
        leaky_relu( mean_c f0[b, y, x, c] * f1[b, y+v, x+u, c], 0.1 )

with ``f1`` zero outside its bounds, taps vertical-major, and the mean
over the true channel count. Tensors are NHWC. Products and sums run in
float32 whatever the input dtype (as the CUDA kernel accumulates); the
result is rounded to ``f0.dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cost_volume"]


def cost_volume(f0: torch.Tensor, f1: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """Correlation of ``f0`` against shifted ``f1`` -> (B, H, W, (2d+1)**2)."""
    b, h, w, c = f0.shape
    d = int(search_range)
    a = f0.float()
    f1p = F.pad(f1.float(), (0, 0, d, d, d, d))
    inv_c = 1.0 / c
    costs = [
        (a * f1p[:, v : v + h, u : u + w, :]).sum(-1) * inv_c
        for v in range(2 * d + 1)
        for u in range(2 * d + 1)
    ]
    return F.leaky_relu(torch.stack(costs, -1), 0.1).to(f0.dtype)
