"""Local cost-volume correlation (max displacement d): the plain version of
K2, and of its backward K4.

Semantics (the reference's pad/multiply/crop construction)::

    cv[b, y, x, (v+d)*(2d+1) + (u+d)] =
        leaky_relu( mean_c f0[b, y, x, c] * f1[b, y+v, x+u, c], 0.1 )

with ``f1`` zero outside its bounds, taps vertical-major, and the mean
over the true channel count. Tensors are NHWC. Products and sums run in
float32 whatever the input dtype (as the CUDA kernels accumulate); the
results are rounded to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.activation import leaky_mask, leaky_relu

__all__ = ["cost_volume", "cost_volume_bwd_plain"]


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
    return leaky_relu(torch.stack(costs, -1), 0.1).to(f0.dtype)


def cost_volume_bwd_plain(
    f0: torch.Tensor, f1: torch.Tensor, out: torch.Tensor, g: torch.Tensor, search_range: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(df0, df1)`` of ``cost_volume(f0, f1, d)`` for the cotangent ``g``.

    With ``gt = g * lrelu'(out) / C``, the sign read from the saved output
    ``out`` (1 where ``out >= 0``, else 0.1)::

        df0[p, c] = sum_t gt[p, t] * f1[p + off_t, c]
        df1[q, c] = sum_t gt[q - off_t, t] * f0[q - off_t, c]

    with zero outside the frame. float32 sums, rounded to the input dtype.
    """
    b, h, w, c = f0.shape
    d = int(search_range)
    n = 2 * d + 1
    gt = g.float() * leaky_mask(out) * (1.0 / c)
    a = f0.float()
    f1p = F.pad(f1.float(), (0, 0, d, d, d, d))
    df0 = torch.zeros_like(a)
    df1p = torch.zeros_like(f1p)
    for v in range(n):
        for u in range(n):
            gt_t = gt[..., v * n + u, None]
            df0 += gt_t * f1p[:, v : v + h, u : u + w, :]
            df1p[:, v : v + h, u : u + w, :] += gt_t * a
    return df0.to(f0.dtype), df1p[:, d : d + h, d : d + w, :].to(f1.dtype).contiguous()
