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
``warp_bwd_plain`` is the plain version of the warp's backward kernel (K5).
"""

from __future__ import annotations

import torch

__all__ = ["nearest_warp", "bilinear_warp", "warp_bwd_plain", "warp"]


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


def _corners(flow: torch.Tensor, h: int, w: int):
    """Clamped corner indices (B, H, W) and float32 blend weights
    (B, H, W, 1) of the bilinear warp: the corners clamp independently, the
    weights come from the unclamped fraction."""
    fx = flow[..., 0].float()
    fy = flow[..., 1].float()
    fx0 = torch.floor(fx)
    fy0 = torch.floor(fy)
    gy, gx = _grid(h, w, flow.device)
    ty = gy + fy0
    tx = gx + fx0
    y0 = ty.clamp(0, h - 1).long()
    y1 = (ty + 1).clamp(0, h - 1).long()
    x0 = tx.clamp(0, w - 1).long()
    x1 = (tx + 1).clamp(0, w - 1).long()
    wy1 = (fy - fy0)[..., None]
    wx1 = (fx - fx0)[..., None]
    return (y0, y1, x0, x1), (1.0 - wy1, wy1, 1.0 - wx1, wx1)


def bilinear_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp: ``out(p) = x(p + flow(p))`` with independent corner clamps.

    Under autograd the gradient reaches ``flow`` through the weights only
    (the indices are integer casts) and ``x`` as a scatter-add over the
    clamped corners, which is the JAX package's ``_bilinear_warp_bwd``."""
    b, h, w, _ = x.shape
    xf = x.float()
    (y0, y1, x0, x1), (wy0, wy1, wx0, wx1) = _corners(flow, h, w)
    top = _gather_2d(xf, y0, x0) * wx0 + _gather_2d(xf, y0, x1) * wx1
    bot = _gather_2d(xf, y1, x0) * wx0 + _gather_2d(xf, y1, x1) * wx1
    return (top * wy0 + bot * wy1).to(x.dtype)


def warp_bwd_plain(
    f1: torch.Tensor, flow: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(df1, dflow)`` of ``bilinear_warp(f1, flow)`` for the cotangent
    ``g``: the plain version of K5.

    ``df1`` is the transpose of the four-corner gather: each pixel adds
    ``weight * g`` onto its four clamped corners, so corners that clamp
    onto one edge pixel both add there. It is summed in float32 and rounded
    once to ``f1.dtype``. ``dflow`` goes through the blend weights only: a
    sum over channels of ``g`` times the corner differences, in
    ``flow.dtype``."""
    b, h, w, c = f1.shape
    (y0, y1, x0, x1), (wy0, wy1, wx0, wx1) = _corners(flow, h, w)
    xf = f1.float()
    gf = g.float()
    p00, p01 = _gather_2d(xf, y0, x0), _gather_2d(xf, y0, x1)
    p10, p11 = _gather_2d(xf, y1, x0), _gather_2d(xf, y1, x1)
    dfx = (gf * (wy0 * (p01 - p00) + wy1 * (p11 - p10))).sum(-1)
    dfy = (gf * (wx0 * (p10 - p00) + wx1 * (p11 - p01))).sum(-1)
    dflow = torch.stack([dfx, dfy], -1).to(flow.dtype)

    acc = torch.zeros((b, h * w, c), dtype=torch.float32, device=f1.device)
    for yi, xi, wgt in ((y0, x0, wy0 * wx0), (y0, x1, wy0 * wx1), (y1, x0, wy1 * wx0), (y1, x1, wy1 * wx1)):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        acc.scatter_add_(1, idx, (wgt * gf).reshape(b, h * w, c))
    return acc.reshape(b, h, w, c).to(f1.dtype), dflow


def warp(x: torch.Tensor, flow: torch.Tensor, warp_type: str = "bilinear") -> torch.Tensor:
    """Dispatching warp (the reference's WarpingLayer)."""
    if warp_type == "nearest":
        return nearest_warp(x, flow)
    if warp_type == "bilinear":
        return bilinear_warp(x, flow)
    raise ValueError(f"warp_type must be 'nearest' or 'bilinear', got {warp_type!r}")
