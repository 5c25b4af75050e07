"""Single-head attention for GMFlow and GMA: inside split windows, plain
and shifted, over a whole frame with a float32 value, and GMA's attention
written out once and read by every update.

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
- `global_softmax(q, k)`: q, k (B, N, C) -> (B, N, N) probabilities in q's
  dtype, ``softmax(q k^T / sqrt(C))`` over all N keys (GMA's ``Attention``),
  computed in blocks of rows so that no float32 (B, N, N) tensor is ever
  whole (at most ``SCORE_BLOCK_BYTES`` of float32 scores at a time). The
  scale is applied to the float32 scores, not to q.
- `aggregate(p, v)`: p (B, N, N), v (B, N, Cv) -> float32 (B, N, Cv), ``p
  v`` with float32 sums (GMA's ``Aggregate`` product, each update).

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
k. GMA's two operations on CUDA tensors take bf16 operands only (no
float32 GEMM, which would run at 67 TFLOP/s): each block of rows of scores
is one cuBLAS bf16 ``bmm`` with float32 output, then R5 (``ops.cuda.
global_attention.attention_softmax_cuda``), a float32 softmax over the row
rounded once to bf16 into the probabilities; the aggregation is one cuBLAS
bf16 ``bmm`` with float32 output. On CPU tensors all are plain: the scores
written out in float32 (GMA's in the same row blocks), the softmax, the
product with v (the window's and GMA's probabilities in q's dtype, as the
fused kernels round them).

`attention_counts()` counts the calls by path: ``window``, ``global``,
``scores`` (`global_softmax`) and ``aggregate`` (the fused calls) and
``plain`` (any kind, on the plain path); `reset_attention_counts()` sets
them to zero.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.cuda.global_attention import attention_softmax_cuda, global_attention_cuda

__all__ = ["window_attention", "global_attention", "global_softmax", "aggregate", "shift_window_mask",
           "split_windows", "merge_windows", "attention_counts", "reset_attention_counts", "score_rows",
           "SCORE_BLOCK_BYTES"]

_COUNTS = {"window": 0, "global": 0, "scores": 0, "aggregate": 0, "plain": 0}
SCORE_BLOCK_BYTES = 1 << 30  # float32 scores held at once by `global_softmax`
MASKED = -100.0  # GMFlow's value between tokens of different regions of a shifted window (not -inf)


def attention_counts() -> dict:
    """Calls by path since the last reset: ``window``, ``global``, ``scores``,
    ``aggregate``, ``plain``."""
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


def score_rows(b: int, n: int) -> int:
    """Rows of each batch element a block of `global_softmax` takes: as many
    as ``SCORE_BLOCK_BYTES`` of float32 scores hold, at least one."""
    return max(1, min(n, SCORE_BLOCK_BYTES // (4 * b * n)))


def _bf16_only(name: str, *tensors: torch.Tensor) -> None:
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{name} on CUDA tensors takes bfloat16 operands (its products run on the tensor cores), "
                        f"got {sorted({str(t.dtype) for t in tensors})}")


def _softmax_plain(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    b, n, _ = q.shape
    p = q.new_empty((b, n, n))
    rows = score_rows(b, n)
    kt = k.float().transpose(1, 2)
    for r0 in range(0, n, rows):
        scores = torch.matmul(q[:, r0:r0 + rows].float(), kt) * scale
        p[:, r0:r0 + rows] = torch.softmax(scores, dim=-1)
    return p


def global_softmax(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(C))`` over all N keys: q, k (B, N, C) -> (B,
    N, N) in q's dtype, the scores and the softmax in float32, each
    probability rounded once; on CUDA tensors cuBLAS and R5 (bf16 q and k)."""
    if q.dim() != 3 or k.shape != q.shape:
        raise ValueError(f"global_softmax: q and k must be (B, N, C) alike, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    if not _fused(q):
        _COUNTS["plain"] += 1
        return _softmax_plain(q, k, scale)
    _bf16_only("global_softmax", q, k)
    _COUNTS["scores"] += 1
    b, n, _ = q.shape
    p = q.new_empty((b, n, n))
    rows = score_rows(b, n)
    block = torch.empty(b * rows * n, dtype=torch.float32, device=q.device)
    kt = k.transpose(1, 2)
    for r0 in range(0, n, rows):
        r = min(rows, n - r0)
        scores = block[:b * r * n].view(b, r, n)
        torch.bmm(q[:, r0:r0 + r], kt, out_dtype=torch.float32, out=scores)
        attention_softmax_cuda(scores, scale, p[:, r0:r0 + r])
    return p


def aggregate(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``p v``: p (B, N, N), v (B, N, Cv) in one dtype -> float32 (B, N,
    Cv), summed in float32; on CUDA tensors one cuBLAS bf16 product."""
    if p.dim() != 3 or v.dim() != 3 or p.shape[2] != v.shape[1] or p.shape[0] != v.shape[0]:
        raise ValueError(f"aggregate: p must be (B, N, N) and v (B, N, Cv), got {tuple(p.shape)} and "
                         f"{tuple(v.shape)}")
    if not _fused(p):
        _COUNTS["plain"] += 1
        return torch.matmul(p.float(), v.float())
    _bf16_only("aggregate", p, v)
    _COUNTS["aggregate"] += 1
    return torch.bmm(p, v, out_dtype=torch.float32)
