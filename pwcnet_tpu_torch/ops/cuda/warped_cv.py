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

K9, ``warped_cost_volume_global``, is the per-shard variant under
H-sharding (``pwcnet_tpu/ops/pallas/warped_cv.py::warped_cost_volume_global``,
``_wcv_global_bwd``): a shard's h rows of f0
against the whole frame 1 (Hf rows), with ``flow_ext`` (B, h + 2d, W, 2)
float32 carrying d halo rows each side and the shard's global row offset in
y, and ``vb = (vlo, vhi)`` (two ints) the global frame's rows in the shard's
coordinates. Its backward, ``warped_cost_volume_global_bwd``, is K8b over
the h + 2d warped rows K9 saved, then K9b (``warped_rows_bwd``): the warp
backward on the tall frame (``csrc/warp_bwd.cu``'s ``pwc_warp_bwd_rows``),
the rows outside ``vb`` reading their cotangent as zero, df1 over the whole
frame, dflow over the h + 2d rows. The plain versions are
``warped_cost_volume_global_plain`` and ``warped_rows_bwd_plain``.

K5 and K9b are one cooperative kernel a call and no other device
operation: it zeroes its float32 accumulator (``df1`` itself in float32, a
scratch buffer in bf16), scatters, and in bf16 rounds into ``df1``.
"""

from __future__ import annotations

import torch

from pwcnet_tpu_torch.ops.cost_volume import cost_volume, cost_volume_hpad, cost_volume_hpad_bwd_plain
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P
from pwcnet_tpu_torch.ops.cuda.cost_volume import MAX_SEARCH_RANGE, cost_volume_bwd, cost_volume_hpad_bwd
from pwcnet_tpu_torch.ops.warp import bilinear_warp, masked_warp_rows, warp_bwd_plain, warp_rows_bwd_plain

__all__ = [
    "warped_cost_volume", "warped_cost_volume_plain", "warped_cost_volume_residual",
    "warp_bwd", "warp_bwd_plain", "warped_cost_volume_global", "warped_cost_volume_global_plain",
    "warped_cost_volume_global_residual", "warped_cost_volume_global_bwd",
    "warped_cost_volume_global_bwd_plain", "warped_rows_bwd", "warped_rows_bwd_plain",
]

_ARGTYPES = [P] * 5 + [I] * 8 + [P]
_BWD_ARGTYPES = [P] * 6 + [I] * 6 + [P]
_GLOBAL_ARGTYPES = [P] * 5 + [I] * 11 + [P]
_ROWS_BWD_ARGTYPES = [P] * 6 + [I] * 10 + [P]


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
        b, h, w, c, d, *_common.correlation_plan(w, c), _common.DTYPE_CODES[f0.dtype],
    )
    warped_cost_volume.launches += 1
    return out, f1w


def _bwd_outputs(name: str, f1: torch.Tensor, g: torch.Tensor):
    """``(df1, scratch)`` of a warp backward launch: in float32 the kernel
    accumulates into ``df1`` (no scratch), in bf16 into a float32 scratch
    buffer. The kernel zeroes either itself; nothing is zeroed here. Its
    offsets are 32-bit: ``f1`` and ``g`` hold at most 2**30 elements."""
    if max(f1.numel(), g.numel()) > 2**30:
        raise ValueError(f"{name}: f1 {tuple(f1.shape)} or g {tuple(g.shape)} holds more than 2**30 elements")
    df1 = torch.empty_like(f1)
    if f1.dtype == torch.float32:
        return df1, None
    return df1, torch.empty(f1.shape, dtype=torch.float32, device=f1.device)


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
    code = _common.DTYPE_CODES[f1.dtype]
    df1, acc = _bwd_outputs("warp_bwd", f1, g)
    dflow = torch.empty_like(flow)
    _common.launch(
        "warp_bwd", "pwc_warp_bwd", _BWD_ARGTYPES, f1.device,
        f1.data_ptr(), flow.data_ptr(), g.data_ptr(), acc if acc is None else acc.data_ptr(),
        df1.data_ptr(), dflow.data_ptr(),
        b, h, w, c, _common.warp_bwd_lanes(c), code,
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


def warped_cost_volume_global_plain(
    f0: torch.Tensor, f1_full: torch.Tensor, flow_ext: torch.Tensor, vb, search_range: int = 4
) -> torch.Tensor:
    """``cost_volume_hpad(f0, masked_warp_rows(f1_full, flow_ext, vb, d), d)``
    in plain PyTorch: the plain version of K9."""
    return cost_volume_hpad(f0, masked_warp_rows(f1_full, flow_ext, vb, search_range), search_range)


def _rows(vb) -> tuple[int, int]:
    vlo, vhi = (int(v) for v in vb)
    return vlo, vhi


def _global_forward(f0, f1_full, flow_ext, vb, d: int, save: bool):
    _common.check_tensors("warped_cost_volume_global", f0, f1_full)
    if flow_ext.dtype != torch.float32 or flow_ext.device != f0.device or not flow_ext.is_contiguous():
        raise ValueError("warped_cost_volume_global: flow_ext must be a contiguous float32 tensor on f0's device")
    b, h, w, c = f0.shape if f0.dim() == 4 else (None,) * 4
    if (f0.dim() != 4 or f1_full.dim() != 4 or f1_full.shape[0] != b or f1_full.shape[2:] != (w, c)
            or flow_ext.shape != (b, h + 2 * d, w, 2)):
        raise ValueError(
            f"warped_cost_volume_global: f0 {tuple(f0.shape)}, f1_full {tuple(f1_full.shape)}, "
            f"flow_ext {tuple(flow_ext.shape)} must be (B, h, W, C), (B, Hf, W, C) and (B, h + 2d, W, 2)"
        )
    if not 1 <= d <= MAX_SEARCH_RANGE:
        raise ValueError(f"warped_cost_volume_global: search_range must be in 1..{MAX_SEARCH_RANGE}, got {d}")
    vlo, vhi = _rows(vb)
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=f0.dtype, device=f0.device)
    f1w = torch.zeros((b, h + 2 * d, w, c), dtype=f0.dtype, device=f0.device) if save else None
    _common.launch(
        "warped_cv", "pwc_warped_cost_volume_global", _GLOBAL_ARGTYPES, f0.device,
        f0.data_ptr(), f1_full.data_ptr(), flow_ext.data_ptr(), out.data_ptr(),
        f1w.data_ptr() if save else None,
        b, h, f1_full.shape[1], w, c, d, vlo, vhi, *_common.correlation_plan(w, c),
        _common.DTYPE_CODES[f0.dtype],
    )
    warped_cost_volume_global.launches += 1
    return out, f1w


def warped_cost_volume_global_residual(f0, f1_full, flow_ext, vb, search_range: int = 4):
    """K9 with its residual: ``(cost volume, f1w_ext)``, the h + 2d warped
    rows (zero outside ``vb``) in the model dtype as the kernel correlated
    them."""
    if f0.device.type == "cpu":
        we = masked_warp_rows(f1_full, flow_ext, vb, search_range)
        return cost_volume_hpad(f0, we, search_range), we
    return _global_forward(f0, f1_full, flow_ext, vb, int(search_range), True)


def _mask_rows(dwe: torch.Tensor, vb, d: int) -> torch.Tensor:
    """Zero, in place, the extended rows outside ``vb``: nothing flows
    through rows the forward forced to zero."""
    vlo, vhi = _rows(vb)
    dwe[:, : max(0, vlo + d)] = 0
    dwe[:, max(0, vhi + d + 1) :] = 0
    return dwe


def warped_rows_bwd_plain(f1_full, flow_ext, vb, dwe, search_range: int = 4):
    """``(df1_full, dflow_ext)`` for the cotangent ``dwe`` of K9's h + 2d
    warped rows, in plain PyTorch: the plain version of K9b. Zeroes the rows
    of ``dwe`` outside ``vb`` in place."""
    d = int(search_range)
    return warp_rows_bwd_plain(f1_full, flow_ext, _mask_rows(dwe, vb, d), -d)


def warped_rows_bwd(f1_full, flow_ext, vb, dwe, search_range: int = 4):
    """K9b: ``(df1_full, dflow_ext)`` for the cotangent ``dwe`` of K9's
    h + 2d warped rows: the warp backward on the whole frame, the rows
    outside ``vb`` reading their cotangent as zero, its ``df1`` summed with
    float32 atomics (run-to-run variation in the last bits, as K5). A CPU
    tensor goes to the plain version, which zeroes those rows of ``dwe`` in
    place; a CUDA tensor to the kernel, which leaves ``dwe`` as it is."""
    if f1_full.device.type == "cpu":
        return warped_rows_bwd_plain(f1_full, flow_ext, vb, dwe, search_range)
    d = int(search_range)
    _common.check_tensors("warped_rows_bwd", f1_full, dwe)
    b, hf, w, c = f1_full.shape
    if flow_ext.dtype != torch.float32 or flow_ext.device != f1_full.device or not flow_ext.is_contiguous():
        raise ValueError("warped_rows_bwd: flow_ext must be a contiguous float32 tensor on f1_full's device")
    ho = flow_ext.shape[1] if flow_ext.dim() == 4 else None
    if flow_ext.shape != (b, ho, w, 2) or dwe.shape != (b, ho, w, c):
        raise ValueError(
            f"warped_rows_bwd: f1_full {tuple(f1_full.shape)}, flow_ext {tuple(flow_ext.shape)}, "
            f"dwe {tuple(dwe.shape)} must be (B, Hf, W, C), (B, h + 2d, W, 2) and (B, h + 2d, W, C)"
        )
    code = _common.DTYPE_CODES[f1_full.dtype]
    df1, acc = _bwd_outputs("warped_rows_bwd", f1_full, dwe)
    dflow = torch.empty_like(flow_ext)
    _common.launch(
        "warp_bwd", "pwc_warp_bwd_rows", _ROWS_BWD_ARGTYPES, f1_full.device,
        f1_full.data_ptr(), flow_ext.data_ptr(), dwe.data_ptr(), acc if acc is None else acc.data_ptr(),
        df1.data_ptr(), dflow.data_ptr(),
        b, ho, hf, w, c, -d, *_rows(vb), _common.warp_bwd_lanes(c), code,
    )
    warped_rows_bwd.launches += 1
    return df1, dflow


def warped_cost_volume_global_bwd_plain(f0, f1_full, flow_ext, vb, out, f1w_ext, g, search_range: int = 4):
    """``(df0, df1_full, dflow_ext)`` of K9 from its residuals in plain
    PyTorch (``_wcv_global_bwd``)."""
    df0, dwe = cost_volume_hpad_bwd_plain(f0, f1w_ext, out, g, search_range)
    return (df0, *warped_rows_bwd_plain(f1_full, flow_ext, vb, dwe, search_range))


def warped_cost_volume_global_bwd(f0, f1_full, flow_ext, vb, out, f1w_ext, g, search_range: int = 4):
    """``(df0, df1_full, dflow_ext)`` of K9 for the cotangent ``g``: K8b
    over ``(f0, f1w_ext, out)``, then K9b. A CPU tensor goes to the plain
    versions; a CUDA tensor to the kernels."""
    df0, dwe = cost_volume_hpad_bwd(f0, f1w_ext, out, g, search_range)
    return (df0, *warped_rows_bwd(f1_full, flow_ext, vb, dwe, search_range))


class _WarpedCostVolumeGlobal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1_full, flow_ext, vb, d):
        out, f1w = _global_forward(f0, f1_full, flow_ext, vb, d, True)
        ctx.save_for_backward(f0, f1_full, flow_ext, out, f1w)
        ctx.vb, ctx.d = vb, d
        return out

    @staticmethod
    def backward(ctx, g):
        f0, f1_full, flow_ext, out, f1w = ctx.saved_tensors
        df0, df1, dflow = warped_cost_volume_global_bwd(
            f0, f1_full, flow_ext, ctx.vb, out, f1w, g.contiguous(), ctx.d)
        return df0, df1, dflow, None, None


def warped_cost_volume_global(
    f0: torch.Tensor, f1_full: torch.Tensor, flow_ext: torch.Tensor, vb, search_range: int = 4
) -> torch.Tensor:
    """K9: a shard's fused warp + cost volume against the whole frame ->
    (B, h, W, (2d+1)**2). ``vb`` is ``(vlo, vhi)``, two ints.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel,
    with K9b as its backward. The warped rows are saved only when a
    gradient is wanted.
    """
    vb = _rows(vb)
    if f0.device.type == "cpu":
        return warped_cost_volume_global_plain(f0, f1_full, flow_ext, vb, search_range)
    if _common.wants_grad(f0, f1_full, flow_ext):
        return _WarpedCostVolumeGlobal.apply(f0, f1_full, flow_ext, vb, int(search_range))
    return _global_forward(f0, f1_full, flow_ext, vb, int(search_range), False)[0]


warped_cost_volume.launches = 0
warp_bwd.launches = 0
warped_cost_volume_global.launches = 0
warped_rows_bwd.launches = 0
