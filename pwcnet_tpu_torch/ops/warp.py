"""Flow-based feature warping (nearest and bilinear), NHWC.

Contract (the reference's WarpingLayer, border handling included):

- ``flow[..., 0]`` is the horizontal (x) displacement, ``flow[..., 1]``
  the vertical (y) one;
- nearest: displacements truncate toward zero (TF's float -> int32 cast),
  target coordinates clamp into the frame;
- bilinear: the four corners clamp into the frame *independently* while
  the weights come from the *unclamped* fractional flow (clamp-to-edge at
  the borders). ``F.grid_sample`` does neither.

The bilinear warp blends in float32 and rounds to ``x.dtype``, which is
what the fused warp + cost-volume kernel (K1) stores before correlating.
"""

from __future__ import annotations

import torch

__all__ = ["nearest_warp", "bilinear_warp", "warp"]


def _gather_2d(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C); in-frame integer yi/xi (B, H, W) -> (B, H, W, C)."""
    b, h, w, c = x.shape
    idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
    return torch.gather(x.reshape(b, h * w, c), 1, idx).reshape(b, h, w, c)


def _grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    gy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    gx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    return gy, gx


def nearest_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour warp of ``x`` by ``flow`` (NHWC / NHW2)."""
    b, h, w, _ = x.shape
    fi = flow.to(torch.int64)  # truncation toward zero, like tf.cast
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    yi = (gy + fi[..., 1]).clamp(0, h - 1)
    xi = (gx + fi[..., 0]).clamp(0, w - 1)
    return _gather_2d(x, yi, xi)


def bilinear_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp: ``out(p) = x(p + flow(p))`` with independent corner clamps."""
    b, h, w, _ = x.shape
    xf = x.float()
    fx = flow[..., 0].float()
    fy = flow[..., 1].float()
    fx0 = torch.floor(fx)
    fy0 = torch.floor(fy)
    gy, gx = _grid(h, w, x.device)
    ty = gy + fy0
    tx = gx + fx0
    y0 = ty.clamp(0, h - 1).long()
    y1 = (ty + 1).clamp(0, h - 1).long()
    x0 = tx.clamp(0, w - 1).long()
    x1 = (tx + 1).clamp(0, w - 1).long()
    wy1 = (fy - fy0)[..., None]
    wy0 = 1.0 - wy1
    wx1 = (fx - fx0)[..., None]
    wx0 = 1.0 - wx1
    top = _gather_2d(xf, y0, x0) * wx0 + _gather_2d(xf, y0, x1) * wx1
    bot = _gather_2d(xf, y1, x0) * wx0 + _gather_2d(xf, y1, x1) * wx1
    return (top * wy0 + bot * wy1).to(x.dtype)


def warp(x: torch.Tensor, flow: torch.Tensor, warp_type: str = "bilinear") -> torch.Tensor:
    """Dispatching warp (the reference's WarpingLayer)."""
    if warp_type == "nearest":
        return nearest_warp(x, flow)
    if warp_type == "bilinear":
        return bilinear_warp(x, flow)
    raise ValueError(f"warp_type must be 'nearest' or 'bilinear', got {warp_type!r}")
