"""K2: the cost volume as a CUDA kernel (``csrc/cost_volume.cu``).

Replaces ``pwcnet_tpu/ops/pallas/cost_volume.py::cost_volume_pallas``.
The plain version is ``pwcnet_tpu_torch.ops.cost_volume.cost_volume``.
"""

from __future__ import annotations

import torch

from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P

__all__ = ["cost_volume_cuda", "cost_volume"]

_ARGTYPES = [P, P, P, I, I, I, I, I, I, P]
MAX_SEARCH_RANGE = 4


def cost_volume_cuda(f0: torch.Tensor, f1: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H, W, (2d+1)**2), LeakyReLU(0.1) included.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel.
    """
    if f0.device.type == "cpu":
        return cost_volume(f0, f1, search_range)
    d = int(search_range)
    _common.check_tensors("cost_volume_cuda", f0, f1)
    if f0.dim() != 4 or f1.shape != f0.shape:
        raise ValueError(f"cost_volume_cuda: f0 {tuple(f0.shape)} and f1 {tuple(f1.shape)} must be one (B, H, W, C)")
    if not 1 <= d <= MAX_SEARCH_RANGE:
        raise ValueError(f"cost_volume_cuda: search_range must be in 1..{MAX_SEARCH_RANGE}, got {d}")
    b, h, w, c = f0.shape
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=f0.dtype, device=f0.device)
    _common.launch(
        "cost_volume", "pwc_cost_volume", _ARGTYPES, f0.device,
        f0.data_ptr(), f1.data_ptr(), out.data_ptr(),
        b, h, w, c, d, _common.DTYPE_CODES[f0.dtype],
    )
    cost_volume_cuda.launches += 1
    return out


cost_volume_cuda.launches = 0
