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

The other resizes gather by index tables. The numpy tables
(``_nearest_table``, ``_bilinear_table``) are the source of truth;
`device_table` keeps each one's tensor on the device it was first used on,
so a call copies nothing to the device: a copy from pageable host memory
drains the stream, and the pyramid losses resize at every level of every
step. `table_counts` gives the lookups and the uploads (tables built and
copied up) since `reset_table_counts`, always counted.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "device_table", "nearest_indices", "nearest_tensor", "reset_table_counts", "resize_bilinear", "resize_nearest",
    "table_counts", "upsample2x_bilinear", "upsample_with_next",
]

_tables: dict = {}  # (key, device) -> what the key's builder made on that device
_counts = {"lookups": 0, "uploads": 0}


def device_table(key: tuple, device: torch.device, build):
    """The value of ``build(device)`` for ``key`` on ``device``, built on the
    first lookup and kept for the life of the process. ``key`` names
    everything the value depends on besides the device. The build runs
    outside inference mode, so a table first used under
    ``torch.inference_mode`` can still be saved for a later backward."""
    _counts["lookups"] += 1
    value = _tables.get((key, device))
    if value is None:
        with torch.inference_mode(False):
            value = build(device)
        _tables[(key, device)] = value
        _counts["uploads"] += 1
    return value


def table_counts() -> dict:
    """``{"lookups", "uploads"}`` of `device_table` since the last reset."""
    return dict(_counts)


def reset_table_counts() -> None:
    """Zero the counters; the tables stay."""
    _counts.update(lookups=0, uploads=0)


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


def _bilinear_tensors(in_size: int, out_size: int, device: torch.device, dtype: torch.dtype):
    """`_bilinear_table` on ``device``, the lerp weights in ``dtype``."""

    def build(dev):
        low, high, lerp = (torch.from_numpy(a).to(dev) for a in _bilinear_table(in_size, out_size))
        return low, high, lerp.to(dtype)

    return device_table(("bilinear", in_size, out_size, dtype), device, build)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) ``x`` to ``size=(H, W)``, TF1 semantics."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (out_h, out_w) == (in_h, in_w):
        return x
    if out_h % in_h == 0 and out_w % in_w == 0:
        y = _upsample_axis_int(x, out_h // in_h, x.dim() - 3)
        return _upsample_axis_int(y, out_w // in_w, x.dim() - 2)

    y_lo, y_hi, y_lerp = _bilinear_tensors(in_h, out_h, x.device, x.dtype)
    x_lo, x_hi, x_lerp = _bilinear_tensors(in_w, out_w, x.device, x.dtype)
    top = x.index_select(-3, y_lo)
    bot = x.index_select(-3, y_hi)
    tl = top.index_select(-2, x_lo)
    tr = top.index_select(-2, x_hi)
    bl = bot.index_select(-2, x_lo)
    br = bot.index_select(-2, x_hi)
    wy = y_lerp[:, None, None]
    wx = x_lerp[:, None]
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


def nearest_tensor(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`nearest_indices` as an int64 tensor kept on ``device``."""
    in_size, out_size = int(in_size), int(out_size)
    return device_table(("nearest", in_size, out_size), device,
                        lambda dev: torch.from_numpy(_nearest_table(in_size, out_size)).to(dev))


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC (or HWC) ``x`` to ``size=(H, W)``, TF1 semantics."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (out_h, out_w) == (in_h, in_w):
        return x
    y_idx = nearest_tensor(in_h, out_h, x.device)
    x_idx = nearest_tensor(in_w, out_w, x.device)
    return x.index_select(-3, y_idx).index_select(-2, x_idx)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling (the inter-pyramid-level upsampler)."""
    return resize_bilinear(x, (2 * x.shape[-3], 2 * x.shape[-2]))
