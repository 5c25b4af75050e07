"""RAFT's all-pairs correlation, its pyramid and its windowed lookup.

`corr_pyramid` and `lookup_plain` are plain PyTorch ops on either device;
`lookup` sends CPU tensors to `lookup_plain` and CUDA tensors to R1, the
hand kernel ``ops.cuda.corr_lookup.corr_lookup_cuda`` (one launch an
update, forward only), which computes the same taps with the same
roundings of their positions.

Contract (princeton-vl/RAFT ``core/corr.py`` ``CorrBlock``):

- `corr_pyramid`: ``corr[b, p, q] = <f1[b, :, p], f2[b, :, q]> / sqrt(C)``
  over every pair of pixels p of frame 1 and q of frame 2, in float32,
  as a (B * h * w, 1, h, w) map for each query pixel p; levels 1.. are
  ``avg_pool2d(2, 2)`` of the level above (odd sizes floor). A level with
  a side of 1 is stored with a zero row or column added (see below).
- `lookup` (`lookup_plain`): for coordinates (x, y) of each query pixel
  (B, h, w, 2), the ``(2r + 1)**2`` taps of level k at ``(x / 2**k + i -
  r, y / 2**k + j - r)``,
  channel ``k (2r + 1)**2 + (2r + 1) i + j`` (the x offset outer), sampled
  bilinearly on pixel centres with zeros outside the map; (B, L (2r + 1)**2,
  h, w) float32, in ``channels_last`` memory.

The samples are ``F.grid_sample(align_corners=True)`` on grids whose
coordinates are computed with RAFT's own roundings (``x / 2**k + i - r``,
then ``2 x / (w_k - 1) - 1``), so the lookup gives RAFT's bits on the same
map. RAFT's normalisation divides by ``w_k - 1``, which a side of 1 makes
zero: such a level is kept padded to a side of 2 with zeros, which a
bilinear tap with zeros outside the map reads the same.

The scale is applied to ``f1`` before the product: ``1 / sqrt(256)`` is a
power of two, so each product, and so each sum, is RAFT's divided result
bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.cuda.corr_lookup import corr_lookup_cuda

__all__ = ["corr_pyramid", "lookup", "lookup_plain"]


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int = 4) -> list:
    """Frame features (B, C, h, w), any memory format -> ``levels`` float32
    maps (B * h * w, 1, h_k, w_k), finest first."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.float().permute(0, 2, 3, 1).reshape(b, h * w, c) * (1.0 / math.sqrt(c))
    f2 = fmap2.float().permute(0, 2, 3, 1).reshape(b, h * w, c)
    corr = torch.bmm(f1, f2.transpose(1, 2)).view(b * h * w, 1, h, w)
    out = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        out.append(corr)
    return [F.pad(m, (0, int(m.shape[3] == 1), 0, int(m.shape[2] == 1))) if 1 in m.shape[2:] else m for m in out]


def lookup(pyramid: list, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """``pyramid`` from `corr_pyramid`, ``coords`` (B, h, w, 2) float32 (x,
    y) -> (B, len(pyramid) (2r + 1)**2, h, w) float32, ``channels_last``:
    `lookup_plain` on CPU tensors, R1 on CUDA tensors (which raises on what
    it does not take: four levels of radius 4, no grad)."""
    if coords.device.type == "cpu":
        return lookup_plain(pyramid, coords, radius)
    return corr_lookup_cuda(pyramid, coords, radius)


def lookup_plain(pyramid: list, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """`lookup` in plain PyTorch ops: each level's grid, ``grid_sample``, and
    the levels concatenated."""
    b, h, w, _ = coords.shape
    n, k = b * h * w, 2 * radius + 1
    offsets = torch.arange(-radius, radius + 1, device=coords.device, dtype=torch.float32)[:, None]
    flat = coords.reshape(n, 1, 2)
    taps = []
    for level, m in enumerate(pyramid):
        at = flat / 2**level + offsets  # (n, k, 2): x and y, each with every offset
        gx = 2 * at[..., 0] / (m.shape[3] - 1) - 1
        gy = 2 * at[..., 1] / (m.shape[2] - 1) - 1
        grid = torch.stack([gx[:, :, None].expand(n, k, k), gy[:, None, :].expand(n, k, k)], -1)
        taps.append(F.grid_sample(m, grid, align_corners=True).view(n, k * k))
    return torch.cat(taps, 1).view(b, h, w, -1).permute(0, 3, 1, 2)
