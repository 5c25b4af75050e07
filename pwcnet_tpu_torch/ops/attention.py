"""Single-head attention for GMFlow: inside split windows, plain and
shifted, and over a whole frame with a float32 value.

- `window_attention(q, k, v, splits, mask)`: q, k, v (B, H, W, C) split
  into ``splits x splits`` windows (GMFlow's ``split_feature``), attention
  inside each window scaled by ``1 / sqrt(C)``, merged back. With ``mask``
  (`shift_window_mask`) the windows are shifted: q, k and v rolled by half
  a window up and left first, the mask added to the scores, the output
  rolled back (GMFlow's ``single_head_split_window_attention``). Output in
  q's dtype; scores and their softmax in float32.
- `global_attention(q, k, v)`: q, k (B, N, C) in the model's dtype, v (B,
  N, Cv) float32 -> float32 (B, N, Cv): ``softmax(q k^T / sqrt(C)) v``
  over all N keys, GMFlow's global matching (v the pixel grid) and its
  flow propagation (v the flow). The value and the output stay float32.

On CUDA tensors the windows run ``F.scaled_dot_product_attention``
restricted to the flash and memory-efficient backends, so no call falls
back to the math backend, which writes the scores out; a shape those
backends refuse raises. Windows are the heads of a (B, windows, L, C)
call; the shifted mask is one (1, windows, L, L) tensor in q's dtype,
which only the memory-efficient backend takes (-100 is exact in bf16).
The global product runs R4 (``ops.cuda.global_attention``, one
hand-written kernel a call, no fallback): bf16 q and k of 128 channels,
the scores summed in float32 on the tensor cores (a product of two bf16
values is exact in float32), a float32 online softmax, and the 2-column
value summed in float32 with probabilities never rounded; the output is
float32. (A bf16 output would miss the grid's coordinates of 64-127 by up
to 0.25 px.) So GMFlow on the card runs in bf16: R4 refuses float32 q and
k. On CPU tensors both are plain: the scores written out in float32, the
softmax, the product with v (the window's probabilities in q's dtype, as
the fused kernels round them).

`attention_counts()` counts the calls by path: ``window`` and ``global``
(the fused calls) and ``plain`` (either kind, on the plain path);
`reset_attention_counts()` sets them to zero.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.cuda.global_attention import global_attention_cuda

__all__ = ["window_attention", "global_attention", "shift_window_mask", "split_windows", "merge_windows",
           "attention_counts", "reset_attention_counts"]

_COUNTS = {"window": 0, "global": 0, "plain": 0}
MASKED = -100.0  # GMFlow's value between tokens of different regions of a shifted window (not -inf)


def attention_counts() -> dict:
    """Calls by path since the last reset: ``window``, ``global``, ``plain``."""
    return dict(_COUNTS)


def reset_attention_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _fused(x: torch.Tensor) -> bool:
    return x.is_cuda


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor], scale: float):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def split_windows(x: torch.Tensor, splits: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, splits**2, H/splits * W/splits, C): windows in
    row-major order, each window's pixels in row-major order."""
    b, h, w, c = x.shape
    x = x.view(b, splits, h // splits, splits, w // splits, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, splits * splits, (h // splits) * (w // splits), c)


def merge_windows(x: torch.Tensor, splits: int, h: int, w: int) -> torch.Tensor:
    """The inverse of `split_windows`: (B, splits**2, L, C) -> (B, H, W, C)."""
    b, _, _, c = x.shape
    x = x.view(b, splits, splits, h // splits, w // splits, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_window_mask(h: int, w: int, splits: int, device, dtype=torch.float32) -> torch.Tensor:
    """GMFlow's ``generate_shift_window_attn_mask`` for an (h, w) grid cut
    into ``splits x splits`` windows shifted by half a window: (splits**2,
    L, L), ``MASKED`` between two pixels of a window that came from
    different regions of the unshifted grid, 0 elsewhere."""
    wh, ww = h // splits, w // splits
    region = torch.zeros(h, w, device=device)
    for i, rows in enumerate((slice(0, -wh), slice(-wh, -(wh // 2)), slice(-(wh // 2), None))):
        for j, cols in enumerate((slice(0, -ww), slice(-ww, -(ww // 2)), slice(-(ww // 2), None))):
            region[rows, cols] = 3 * i + j
    windows = split_windows(region.view(1, h, w, 1), splits).view(splits * splits, wh * ww)
    differ = windows[:, None, :] != windows[:, :, None]
    return torch.zeros(differ.shape, device=device, dtype=dtype).masked_fill_(differ, MASKED)


def _plain(q, k, v, mask, scale, out_dtype):
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.float()
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(out_dtype)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, splits: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention inside each of ``splits x splits`` windows of (B, H, W, C)
    q, k, v; shifted by half a window when ``mask`` (`shift_window_mask`)
    is given. -> (B, H, W, C) in q's dtype."""
    b, h, w, c = q.shape
    if mask is not None:
        shift = (-(h // splits // 2), -(w // splits // 2))
        q, k, v = (torch.roll(t, shift, dims=(1, 2)) for t in (q, k, v))
    q, k, v = (split_windows(t, splits) for t in (q, k, v))
    scale = 1.0 / math.sqrt(c)
    if _fused(q):
        _COUNTS["window"] += 1
        out = _sdpa(q, k, v, None if mask is None else mask.to(q.dtype)[None], scale)
    else:
        _COUNTS["plain"] += 1
        out = _plain(q, k, v, mask, scale, q.dtype)
    out = merge_windows(out, splits, h, w)
    if mask is not None:
        out = torch.roll(out, (h // splits // 2, w // splits // 2), dims=(1, 2))
    return out


def global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(C)) v`` over all N keys: q, k (B, N, C), v
    (B, N, Cv) float32 -> (B, N, Cv) float32; on CUDA tensors R4 (C = 128,
    Cv = 2, bf16 q and k)."""
    if not _fused(q):
        _COUNTS["plain"] += 1
        return _plain(q, k, v.float(), None, 1.0 / math.sqrt(q.shape[-1]), torch.float32)
    _COUNTS["global"] += 1
    return global_attention_cuda(q, k, v)
