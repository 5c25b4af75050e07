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

Under H-sharding a shard warps its rows against the whole frame:
``bilinear_warp_rows`` and ``nearest_warp_rows`` sample a frame of Hf rows
at Ho flow rows, flow row j sitting at frame row ``j + row0`` (``row0`` is
the shard's global row offset, or -d for the d halo rows above when the
offset is folded into flow y, as the fused path does); the nearest warp
truncates the flow before ``row0`` is added, as the unsharded warp
truncates it before adding its grid;
``masked_warp_rows`` zeroes the rows outside the global frame, the plain
half of K9, and ``warp_rows_bwd_plain`` is the plain version of K9b's warp
backward.
"""

from __future__ import annotations

import torch

__all__ = [
    "nearest_warp", "nearest_warp_rows", "bilinear_warp", "bilinear_warp_rows", "masked_warp_rows",
    "warp_bwd_plain", "warp_rows_bwd_plain", "warp", "warp_rows",
]


def _gather_2d(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """x (B, Hf, W, C); in-frame integer yi/xi (B, Ho, W) -> (B, Ho, W, C)."""
    b, hf, w, c = x.shape
    ho = yi.shape[1]
    idx = (yi * w + xi).reshape(b, ho * w, 1).expand(b, ho * w, c)
    return torch.gather(x.reshape(b, hf * w, c), 1, idx).reshape(b, ho, w, c)


def _grid(h: int, w: int, device, row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    gy = torch.arange(row0, row0 + h, device=device, dtype=torch.float32)[None, :, None]
    gx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    return gy, gx


def nearest_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour warp of ``x`` by ``flow`` (NHWC / NHW2)."""
    return nearest_warp_rows(x, flow, 0)


def nearest_warp_rows(x: torch.Tensor, flow: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """``nearest_warp`` of the frame ``x`` (B, Hf, W, C) at the rows of
    ``flow`` (B, Ho, W, 2), flow row j at frame row ``j + row0``: the flow
    truncates toward zero first (``trunc(row0 + fy)`` would differ from
    ``row0 + trunc(fy)`` for a negative fraction), then the target clamps
    into the Hf rows."""
    hf, w = x.shape[1], x.shape[2]
    fi = flow.to(torch.int64)  # truncation toward zero, like tf.cast
    gy = torch.arange(row0, row0 + flow.shape[1], device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    yi = (gy + fi[..., 1]).clamp(0, hf - 1)
    xi = (gx + fi[..., 0]).clamp(0, w - 1)
    return _gather_2d(x, yi, xi)


def _corners(flow: torch.Tensor, h: int, w: int, row0: int = 0):
    """Clamped corner indices (B, Ho, W) and float32 blend weights
    (B, Ho, W, 1) of the bilinear warp into a frame of ``h`` rows, flow row j
    at frame row ``j + row0``: the corners clamp independently, the weights
    come from the unclamped fraction."""
    fx = flow[..., 0].float()
    fy = flow[..., 1].float()
    fx0 = torch.floor(fx)
    fy0 = torch.floor(fy)
    gy, gx = _grid(flow.shape[1], w, flow.device, row0)
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
    return bilinear_warp_rows(x, flow, 0)


def bilinear_warp_rows(x: torch.Tensor, flow: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """``bilinear_warp`` of the frame ``x`` (B, Hf, W, C) at the rows of
    ``flow`` (B, Ho, W, 2), flow row j at frame row ``j + row0``; the
    corners clamp into the Hf rows."""
    b, hf, w, _ = x.shape
    xf = x.float()
    (y0, y1, x0, x1), (wy0, wy1, wx0, wx1) = _corners(flow, hf, w, row0)
    top = _gather_2d(xf, y0, x0) * wx0 + _gather_2d(xf, y0, x1) * wx1
    bot = _gather_2d(xf, y1, x0) * wx0 + _gather_2d(xf, y1, x1) * wx1
    return (top * wy0 + bot * wy1).to(x.dtype)


def masked_warp_rows(f1: torch.Tensor, flow_ext: torch.Tensor, vb, search_range: int = 4) -> torch.Tensor:
    """A shard's warped rows against the whole frame ``f1`` (B, Hf, W, C):
    ``flow_ext`` (B, h + 2d, W, 2) holds the shard's flow rows with d halo
    rows each side and the shard's global row offset added to y; row j is
    the shard's row ``j - d``. Rows outside ``vb = (vlo, vhi)``, the global
    frame's rows in the shard's coordinates, are zero (the cost volume's
    zero padding). The counterpart of ``_masked_warp_rows``."""
    d = int(search_range)
    we = bilinear_warp_rows(f1, flow_ext, -d)
    rows = torch.arange(-d, flow_ext.shape[1] - d, device=f1.device)
    keep = ((rows >= vb[0]) & (rows <= vb[1]))[None, :, None, None]
    return torch.where(keep, we, torch.zeros((), dtype=we.dtype, device=we.device))


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
    return warp_rows_bwd_plain(f1, flow, g, 0)


def warp_rows_bwd_plain(
    f1: torch.Tensor, flow: torch.Tensor, g: torch.Tensor, row0: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(df1, dflow)`` of ``bilinear_warp_rows(f1, flow, row0)``: df1 over
    the whole frame, dflow over the flow's rows (in ``flow.dtype``)."""
    b, hf, w, c = f1.shape
    ho = flow.shape[1]
    (y0, y1, x0, x1), (wy0, wy1, wx0, wx1) = _corners(flow, hf, w, row0)
    xf = f1.float()
    gf = g.float()
    p00, p01 = _gather_2d(xf, y0, x0), _gather_2d(xf, y0, x1)
    p10, p11 = _gather_2d(xf, y1, x0), _gather_2d(xf, y1, x1)
    dfx = (gf * (wy0 * (p01 - p00) + wy1 * (p11 - p10))).sum(-1)
    dfy = (gf * (wx0 * (p10 - p00) + wx1 * (p11 - p01))).sum(-1)
    dflow = torch.stack([dfx, dfy], -1).to(flow.dtype)

    acc = torch.zeros((b, hf * w, c), dtype=torch.float32, device=f1.device)
    for yi, xi, wgt in ((y0, x0, wy0 * wx0), (y0, x1, wy0 * wx1), (y1, x0, wy1 * wx0), (y1, x1, wy1 * wx1)):
        idx = (yi * w + xi).reshape(b, ho * w, 1).expand(b, ho * w, c)
        acc.scatter_add_(1, idx, (wgt * gf).reshape(b, ho * w, c))
    return acc.reshape(b, hf, w, c).to(f1.dtype), dflow


def warp(x: torch.Tensor, flow: torch.Tensor, warp_type: str = "bilinear") -> torch.Tensor:
    """Dispatching warp (the reference's WarpingLayer)."""
    return warp_rows(x, flow, 0, warp_type)


def warp_rows(x: torch.Tensor, flow: torch.Tensor, row0: int = 0, warp_type: str = "bilinear") -> torch.Tensor:
    """``warp`` of the frame ``x`` at the rows of ``flow``, flow row j at
    frame row ``j + row0`` (a row shard's warp against the whole frame)."""
    if warp_type == "nearest":
        return nearest_warp_rows(x, flow, row0)
    if warp_type == "bilinear":
        return bilinear_warp_rows(x, flow, row0)
    raise ValueError(f"warp_type must be 'nearest' or 'bilinear', got {warp_type!r}")
