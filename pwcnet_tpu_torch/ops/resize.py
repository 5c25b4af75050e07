"""TF1-compatible image resizing (align_corners=False, no half-pixel centres).

The reference model's numerics depend on TF 1.8's ``resize_bilinear``:

- the source coordinate of output index ``i`` is ``i * (in_size / out_size)``
  in float32, with no +0.5 offset;
- bilinear: top index ``floor(src)``, bottom index ``min(ceil(src), in - 1)``,
  lerp weight ``src - floor(src)``;
- nearest (``resize_nearest_neighbor``, the loss's ground-truth
  downsampling): index ``min(floor(src), in - 1)``.

``F.interpolate(align_corners=False)`` uses half-pixel centres and is a
different function. Tensors are NHWC (or HWC): the spatial axes are -3, -2.

Integer upscale factors (the model's 2x inter-level and 4x final
upsamplings) take the phase path: output ``f*k + p`` sources ``k + p/f``,
so each output is a fixed-weight lerp of ``x`` and its 1-shifted copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["nearest_indices", "resize_bilinear", "resize_nearest", "upsample2x_bilinear", "upsample_with_next"]


def _upsample_axis_int(x: torch.Tensor, f: int, axis: int) -> torch.Tensor:
    """TF1 bilinear upsampling by the integer factor ``f`` along ``axis``."""
    if f == 1:
        return x
    n = x.shape[axis]
    # neighbour with the edge clamped: min(k + 1, n - 1), TF1's ceil clamp
    xn = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    return upsample_with_next(x, xn, f, axis)


def upsample_with_next(x: torch.Tensor, xn: torch.Tensor, f: int, axis: int) -> torch.Tensor:
    """TF1 bilinear upsampling by ``f`` along ``axis`` given ``xn``, each
    sample's next neighbour along that axis (the edge clamped, or a row
    shard's next row from the shard below): output ``f*k + p`` is
    ``x[k] + (xn[k] - x[k]) * p / f``."""
    phases = [x] + [x + (xn - x) * (p / f) for p in range(1, f)]
    y = torch.stack(phases, axis + 1)
    shape = list(x.shape)
    shape[axis] *= f
    return y.reshape(shape)


@functools.lru_cache(maxsize=None)
def _bilinear_table(in_size: int, out_size: int):
    """(low, high, lerp) numpy tables for one axis, TF1 semantics."""
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.arange(out_size, dtype=np.float32) * scale
    low = np.floor(src)
    high = np.minimum(np.ceil(src), in_size - 1)
    return low.astype(np.int64), high.astype(np.int64), (src - low).astype(np.float32)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) ``x`` to ``size=(H, W)``, TF1 semantics."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (out_h, out_w) == (in_h, in_w):
        return x
    if out_h % in_h == 0 and out_w % in_w == 0:
        y = _upsample_axis_int(x, out_h // in_h, x.dim() - 3)
        return _upsample_axis_int(y, out_w // in_w, x.dim() - 2)

    y_lo, y_hi, y_lerp = _bilinear_table(in_h, out_h)
    x_lo, x_hi, x_lerp = _bilinear_table(in_w, out_w)

    def idx(a):
        return torch.from_numpy(a).to(x.device)

    top = x.index_select(-3, idx(y_lo))
    bot = x.index_select(-3, idx(y_hi))
    tl = top.index_select(-2, idx(x_lo))
    tr = top.index_select(-2, idx(x_hi))
    bl = bot.index_select(-2, idx(x_lo))
    br = bot.index_select(-2, idx(x_hi))
    wy = idx(y_lerp).to(x.dtype)[:, None, None]
    wx = idx(x_lerp).to(x.dtype)[:, None]
    t = tl + (tr - tl) * wx
    b = bl + (br - bl) * wx
    return t + (b - t) * wy


@functools.lru_cache(maxsize=None)
def _nearest_table(in_size: int, out_size: int):
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.arange(out_size, dtype=np.float32) * scale
    return np.minimum(np.floor(src), in_size - 1).astype(np.int64)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """The source index of each output index of the TF1 nearest resize."""
    return _nearest_table(int(in_size), int(out_size))


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC (or HWC) ``x`` to ``size=(H, W)``, TF1 semantics."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (out_h, out_w) == (in_h, in_w):
        return x
    y_idx = torch.from_numpy(_nearest_table(in_h, out_h)).to(x.device)
    x_idx = torch.from_numpy(_nearest_table(in_w, out_w)).to(x.device)
    return x.index_select(-3, y_idx).index_select(-2, x_idx)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling (the inter-pyramid-level upsampler)."""
    return resize_bilinear(x, (2 * x.shape[-3], 2 * x.shape[-2]))
