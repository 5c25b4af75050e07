"""K2 and K4: the cost volume and its backward as CUDA kernels
(``csrc/cost_volume.cu``, ``csrc/cost_volume_bwd.cu``); K8 and K8b, the
same on a row shard with d halo rows (``cost_volume_hpad``).

Replace ``pwcnet_tpu/ops/pallas/cost_volume.py::cost_volume_pallas`` and
``::_cv_bwd``, and ``::cost_volume_pallas_hpad`` with its backward
``_cv_hpad_bwd``. The plain versions are
``pwcnet_tpu_torch.ops.cost_volume.cost_volume``, ``cost_volume_bwd_plain``,
``cost_volume_hpad`` and ``cost_volume_hpad_bwd_plain``. On a CUDA tensor
``cost_volume_cuda`` is a ``torch.autograd.Function``: K2 forward, K4
backward over the residuals ``(f0, f1, out)``; ``cost_volume_hpad_cuda``
likewise K8 forward, K8b backward, whose ``df1_ext`` keeps the halo rows.
"""

from __future__ import annotations

import torch

from pwcnet_tpu_torch.ops.cost_volume import (
    cost_volume, cost_volume_bwd_plain, cost_volume_hpad, cost_volume_hpad_bwd_plain)
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P

__all__ = [
    "cost_volume_cuda", "cost_volume_bwd", "cost_volume", "cost_volume_bwd_plain",
    "cost_volume_hpad_cuda", "cost_volume_hpad_bwd", "cost_volume_hpad", "cost_volume_hpad_bwd_plain",
]

_ARGTYPES = [P, P, P] + [I] * 8 + [P]
_BWD_ARGTYPES = [P] * 6 + [I] * 7 + [P]
MAX_SEARCH_RANGE = 4


def _check(name: str, f0: torch.Tensor, f1: torch.Tensor, d: int, halo: int = 0) -> None:
    b, h, w, c = f0.shape if f0.dim() == 4 else (None,) * 4
    if f0.dim() != 4 or f1.shape != (b, h + 2 * halo, w, c):
        raise ValueError(
            f"{name}: f0 {tuple(f0.shape)} and f1 {tuple(f1.shape)} must be (B, H, W, C) and "
            f"(B, H + {2 * halo}, W, C)"
        )
    if not 1 <= d <= MAX_SEARCH_RANGE:
        raise ValueError(f"{name}: search_range must be in 1..{MAX_SEARCH_RANGE}, got {d}")


def _forward(f0: torch.Tensor, f1: torch.Tensor, d: int) -> torch.Tensor:
    _common.check_tensors("cost_volume_cuda", f0, f1)
    _check("cost_volume_cuda", f0, f1, d)
    b, h, w, c = f0.shape
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=f0.dtype, device=f0.device)
    _common.launch(
        "cost_volume", "pwc_cost_volume", _ARGTYPES, f0.device,
        f0.data_ptr(), f1.data_ptr(), out.data_ptr(),
        b, h, w, c, d, *_common.correlation_plan(w, c), _common.DTYPE_CODES[f0.dtype],
    )
    cost_volume_cuda.launches += 1
    return out


def cost_volume_bwd(
    f0: torch.Tensor, f1: torch.Tensor, out: torch.Tensor, g: torch.Tensor, search_range: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(df0, df1)`` of the cost volume from its residuals ``f0``,
    ``f1`` (the saved warped map on the K1 path), its output ``out`` and
    the cotangent ``g``.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel.
    """
    if f0.device.type == "cpu":
        return cost_volume_bwd_plain(f0, f1, out, g, search_range)
    d = int(search_range)
    _common.check_tensors("cost_volume_bwd", f0, f1, out, g)
    _check("cost_volume_bwd", f0, f1, d)
    b, h, w, c = f0.shape
    if out.shape != (b, h, w, (2 * d + 1) ** 2) or g.shape != out.shape:
        raise ValueError(
            f"cost_volume_bwd: out {tuple(out.shape)} and g {tuple(g.shape)} must be "
            f"{(b, h, w, (2 * d + 1) ** 2)}"
        )
    df0 = torch.empty_like(f0)
    df1 = torch.empty_like(f1)
    _common.launch(
        "cost_volume_bwd", "pwc_cost_volume_bwd", _BWD_ARGTYPES, f0.device,
        f0.data_ptr(), f1.data_ptr(), out.data_ptr(), g.data_ptr(), df0.data_ptr(), df1.data_ptr(),
        b, h, w, c, d, _common.DTYPE_CODES[f0.dtype], _common.cv_bwd_plan(b, h, w, c),
    )
    cost_volume_bwd.launches += 1
    return df0, df1


class _CostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, d):
        out = _forward(f0, f1, d)
        ctx.save_for_backward(f0, f1, out)
        ctx.d = d
        return out

    @staticmethod
    def backward(ctx, g):
        f0, f1, out = ctx.saved_tensors
        df0, df1 = cost_volume_bwd(f0, f1, out, g.contiguous(), ctx.d)
        return df0, df1, None


def cost_volume_cuda(f0: torch.Tensor, f1: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H, W, (2d+1)**2), LeakyReLU(0.1) included.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel,
    with K4 as its backward.
    """
    if f0.device.type == "cpu":
        return cost_volume(f0, f1, search_range)
    if _common.wants_grad(f0, f1):
        return _CostVolume.apply(f0, f1, int(search_range))
    return _forward(f0, f1, int(search_range))


def _hpad_forward(f0: torch.Tensor, f1_ext: torch.Tensor, d: int) -> torch.Tensor:
    _common.check_tensors("cost_volume_hpad", f0, f1_ext)
    _check("cost_volume_hpad", f0, f1_ext, d, halo=d)
    b, h, w, c = f0.shape
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=f0.dtype, device=f0.device)
    _common.launch(
        "cost_volume", "pwc_cost_volume_hpad", _ARGTYPES, f0.device,
        f0.data_ptr(), f1_ext.data_ptr(), out.data_ptr(),
        b, h, w, c, d, *_common.correlation_plan(w, c), _common.DTYPE_CODES[f0.dtype],
    )
    cost_volume_hpad_cuda.launches += 1
    return out


def cost_volume_hpad_bwd(
    f0: torch.Tensor, f1_ext: torch.Tensor, out: torch.Tensor, g: torch.Tensor, search_range: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """K8b: ``(df0, df1_ext)`` of ``cost_volume_hpad``; ``df1_ext`` has the
    h + 2d rows of ``f1_ext``. On K9's path ``f1_ext`` is the warped rows K9
    saved. A CPU tensor goes to the plain version; a CUDA tensor to the
    kernel."""
    if f0.device.type == "cpu":
        return cost_volume_hpad_bwd_plain(f0, f1_ext, out, g, search_range)
    d = int(search_range)
    _common.check_tensors("cost_volume_hpad_bwd", f0, f1_ext, out, g)
    _check("cost_volume_hpad_bwd", f0, f1_ext, d, halo=d)
    b, h, w, c = f0.shape
    if out.shape != (b, h, w, (2 * d + 1) ** 2) or g.shape != out.shape:
        raise ValueError(
            f"cost_volume_hpad_bwd: out {tuple(out.shape)} and g {tuple(g.shape)} must be "
            f"{(b, h, w, (2 * d + 1) ** 2)}"
        )
    df0 = torch.empty_like(f0)
    df1_ext = torch.empty_like(f1_ext)
    _common.launch(
        "cost_volume_bwd", "pwc_cost_volume_hpad_bwd", _BWD_ARGTYPES, f0.device,
        f0.data_ptr(), f1_ext.data_ptr(), out.data_ptr(), g.data_ptr(), df0.data_ptr(), df1_ext.data_ptr(),
        b, h, w, c, d, _common.DTYPE_CODES[f0.dtype], _common.cv_bwd_plan(b, h, w, c, d),
    )
    cost_volume_hpad_bwd.launches += 1
    return df0, df1_ext


class _CostVolumeHpad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1_ext, d):
        out = _hpad_forward(f0, f1_ext, d)
        ctx.save_for_backward(f0, f1_ext, out)
        ctx.d = d
        return out

    @staticmethod
    def backward(ctx, g):
        f0, f1_ext, out = ctx.saved_tensors
        df0, df1_ext = cost_volume_hpad_bwd(f0, f1_ext, out, g.contiguous(), ctx.d)
        return df0, df1_ext, None


def cost_volume_hpad_cuda(f0: torch.Tensor, f1_ext: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """K8: a shard's cost volume, f0 (B, h, W, C) against f1_ext (B, h + 2d,
    W, C) that carries the d halo rows above and below -> (B, h, W,
    (2d+1)**2), LeakyReLU(0.1) included.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel,
    with K8b as its backward.
    """
    if f0.device.type == "cpu":
        return cost_volume_hpad(f0, f1_ext, search_range)
    if _common.wants_grad(f0, f1_ext):
        return _CostVolumeHpad.apply(f0, f1_ext, int(search_range))
    return _hpad_forward(f0, f1_ext, int(search_range))


cost_volume_cuda.launches = 0
cost_volume_bwd.launches = 0
cost_volume_hpad_cuda.launches = 0
cost_volume_hpad_bwd.launches = 0
