"""K1: bilinear warp + cost volume as one CUDA kernel (``csrc/warped_cv.cu``).

Replaces ``pwcnet_tpu/ops/pallas/warped_cv.py::warped_cost_volume``
(forward only). The plain version, ``warped_cost_volume_plain``, composes
the plain warp and cost volume: the warp blends in float32 and rounds to
the model dtype, the correlation accumulates in float32 — the kernel's
arithmetic.
"""

from __future__ import annotations

import torch

from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P
from pwcnet_tpu_torch.ops.cuda.cost_volume import MAX_SEARCH_RANGE
from pwcnet_tpu_torch.ops.warp import bilinear_warp

__all__ = ["warped_cost_volume", "warped_cost_volume_plain"]

_ARGTYPES = [P, P, P, P, I, I, I, I, I, I, P]


def warped_cost_volume_plain(
    f0: torch.Tensor, f1: torch.Tensor, flow: torch.Tensor, search_range: int = 4
) -> torch.Tensor:
    """``cost_volume(f0, bilinear_warp(f1, flow), d)`` in plain PyTorch."""
    return cost_volume(f0, bilinear_warp(f1, flow), search_range)


def warped_cost_volume(
    f0: torch.Tensor, f1: torch.Tensor, flow: torch.Tensor, search_range: int = 4
) -> torch.Tensor:
    """Fused warp + cost volume: f0, f1 (B, H, W, C), flow (B, H, W, 2) in
    pixels at this level (x first) -> (B, H, W, (2d+1)**2).

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel.
    """
    if f0.device.type == "cpu":
        return warped_cost_volume_plain(f0, f1, flow, search_range)
    d = int(search_range)
    _common.check_tensors("warped_cost_volume", f0, f1, flow)
    if f0.dim() != 4 or f1.shape != f0.shape or flow.shape != f0.shape[:3] + (2,):
        raise ValueError(
            f"warped_cost_volume: f0 {tuple(f0.shape)}, f1 {tuple(f1.shape)}, "
            f"flow {tuple(flow.shape)} must be (B, H, W, C) x 2 and (B, H, W, 2)"
        )
    if not 1 <= d <= MAX_SEARCH_RANGE:
        raise ValueError(f"warped_cost_volume: search_range must be in 1..{MAX_SEARCH_RANGE}, got {d}")
    b, h, w, c = f0.shape
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=f0.dtype, device=f0.device)
    _common.launch(
        "warped_cv", "pwc_warped_cost_volume", _ARGTYPES, f0.device,
        f0.data_ptr(), f1.data_ptr(), flow.data_ptr(), out.data_ptr(),
        b, h, w, c, d, _common.DTYPE_CODES[f0.dtype],
    )
    warped_cost_volume.launches += 1
    return out


warped_cost_volume.launches = 0
