"""K1 and K5: bilinear warp + cost volume as one CUDA kernel
(``csrc/warped_cv.cu``) and the warp's backward (``csrc/warp_bwd.cu``).

Replace ``pwcnet_tpu/ops/pallas/warped_cv.py::warped_cost_volume`` and
``::warp_bwd_pallas``. The plain version of the forward,
``warped_cost_volume_plain``, composes the plain warp and cost volume: the
warp blends in float32 and rounds to the model dtype, the correlation
accumulates in float32, which is the kernel's arithmetic. The plain
version of K5 is ``pwcnet_tpu_torch.ops.warp.warp_bwd_plain``.

On a CUDA tensor ``warped_cost_volume`` is a ``torch.autograd.Function``
whose backward is the JAX package's ``_wcv_bwd``: K4 over
``(f0, f1w, out)`` with ``f1w`` the warped map the forward kernel saved,
then K5 over ``(f1, flow, df1w)``.
"""

from __future__ import annotations

import torch

from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P
from pwcnet_tpu_torch.ops.cuda.cost_volume import MAX_SEARCH_RANGE, cost_volume_bwd
from pwcnet_tpu_torch.ops.warp import bilinear_warp, warp_bwd_plain

__all__ = [
    "warped_cost_volume", "warped_cost_volume_plain", "warped_cost_volume_residual",
    "warp_bwd", "warp_bwd_plain",
]

_ARGTYPES = [P, P, P, P, P, I, I, I, I, I, I, P]
_BWD_ARGTYPES = [P] * 6 + [I] * 5 + [P]


def warped_cost_volume_plain(
    f0: torch.Tensor, f1: torch.Tensor, flow: torch.Tensor, search_range: int = 4
) -> torch.Tensor:
    """``cost_volume(f0, bilinear_warp(f1, flow), d)`` in plain PyTorch."""
    return cost_volume(f0, bilinear_warp(f1, flow), search_range)


def warped_cost_volume_residual(
    f0: torch.Tensor, f1: torch.Tensor, flow: torch.Tensor, search_range: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 with its residual: ``(cost volume, warped map f1w)``, the warped
    map (B, H, W, C) in the model dtype as the kernel correlated it."""
    if f0.device.type == "cpu":
        f1w = bilinear_warp(f1, flow)
        return cost_volume(f0, f1w, search_range), f1w
    return _forward(f0, f1, flow, int(search_range), True)


def _forward(f0, f1, flow, d: int, save: bool):
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
    f1w = torch.empty_like(f1) if save else None
    _common.launch(
        "warped_cv", "pwc_warped_cost_volume", _ARGTYPES, f0.device,
        f0.data_ptr(), f1.data_ptr(), flow.data_ptr(), out.data_ptr(),
        f1w.data_ptr() if save else None,
        b, h, w, c, d, _common.DTYPE_CODES[f0.dtype],
    )
    warped_cost_volume.launches += 1
    return out, f1w


def warp_bwd(f1: torch.Tensor, flow: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(df1, dflow)`` of ``bilinear_warp(f1, flow)`` for the cotangent
    ``g`` of the warped map.

    ``df1`` is summed with float32 atomics, so its last bits vary from run
    to run. A CPU tensor goes to the plain version; a CUDA tensor to the
    kernel.
    """
    if f1.device.type == "cpu":
        return warp_bwd_plain(f1, flow, g)
    _common.check_tensors("warp_bwd", f1, flow, g)
    if f1.dim() != 4 or g.shape != f1.shape or flow.shape != f1.shape[:3] + (2,):
        raise ValueError(
            f"warp_bwd: f1 {tuple(f1.shape)}, flow {tuple(flow.shape)}, g {tuple(g.shape)} "
            "must be (B, H, W, C), (B, H, W, 2) and (B, H, W, C)"
        )
    b, h, w, c = f1.shape
    acc = torch.zeros(f1.shape, dtype=torch.float32, device=f1.device)
    df1 = acc if f1.dtype == torch.float32 else torch.empty_like(f1)
    dflow = torch.empty_like(flow)
    _common.launch(
        "warp_bwd", "pwc_warp_bwd", _BWD_ARGTYPES, f1.device,
        f1.data_ptr(), flow.data_ptr(), g.data_ptr(), acc.data_ptr(), df1.data_ptr(), dflow.data_ptr(),
        b, h, w, c, _common.DTYPE_CODES[f1.dtype],
    )
    warp_bwd.launches += 1
    return df1, dflow


class _WarpedCostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, flow, d):
        out, f1w = _forward(f0, f1, flow, d, True)
        ctx.save_for_backward(f0, f1, flow, out, f1w)
        ctx.d = d
        return out

    @staticmethod
    def backward(ctx, g):
        f0, f1, flow, out, f1w = ctx.saved_tensors
        df0, df1w = cost_volume_bwd(f0, f1w, out, g.contiguous(), ctx.d)
        df1, dflow = warp_bwd(f1, flow, df1w)
        return df0, df1, dflow, None


def warped_cost_volume(
    f0: torch.Tensor, f1: torch.Tensor, flow: torch.Tensor, search_range: int = 4
) -> torch.Tensor:
    """Fused warp + cost volume: f0, f1 (B, H, W, C), flow (B, H, W, 2) in
    pixels at this level (x first) -> (B, H, W, (2d+1)**2).

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel,
    with K4 and K5 as its backward. The warped-map residual is written only
    when a gradient is wanted.
    """
    if f0.device.type == "cpu":
        return warped_cost_volume_plain(f0, f1, flow, search_range)
    if _common.wants_grad(f0, f1, flow):
        return _WarpedCostVolume.apply(f0, f1, flow, int(search_range))
    return _forward(f0, f1, flow, int(search_range), False)[0]


warped_cost_volume.launches = 0
warp_bwd.launches = 0
