"""K7: the estimator's fused six-conv chain and its backward as CUDA
kernels (``csrc/estimator_conv.cu``, ``csrc/estimator_conv_bwd.cu``).

Replace ``pwcnet_tpu/ops/pallas/estimator_conv.py::estimator_chain_fused``
and its backward ``_est_bwd_pallas``. The function, its rounding and the
plain versions are in ``pwcnet_tpu_torch/ops/estimator_conv.py``.

Activations are NHWC; ``kbs`` is ``k1, b1, .., k6, b6`` with PyTorch's OIHW
kernels. Each call lays the kernels out for its implicit GEMMs. In bf16 both
directions pack them for wgmma on the card, all of a call in one small
kernel, into a scratch buffer: the forward as ``_common.pack_wgmma``, the
backward their transposes with the taps mirrored, in the N tiles of
``_common.wgmma_tiles`` (``_common.transposed_tiles``; dxin's 147..280
channels take two or three); the backward's TMA loads need 16-byte strides,
so it takes the 2-channel flow cotangent padded to 8 channels (one small
copy a call). In float32 both take them
tap-major, six small copies, ``[ky][kx][cin][cout]`` with ``cout``
zero-padded to a multiple of 8 (the backward reads that array transposed).
The five hidden widths must be multiples of 8 (128, 128, 96, 64, 32 in the
model), because the kernels copy their activations 16 bytes at a time.

The chain's input (147..273 channels in the model) may arrive with its
channels zero-padded up to a multiple of 8, as the model's NHWC copy writes
it (``models/conv.py::to_nhwc``): the bf16 forward reads it by TMA, which
needs 16-byte strides. ``k1`` then gets zero rows for the tail, so the
result is the unpadded chain's, and the tail's gradient is zero. An input
of no multiple of 8 is padded here, on a CUDA bf16 tensor, by one extra
copy.

On a CUDA tensor ``estimator_chain_fused`` is a ``torch.autograd.Function``:
the forward kernels (which hand the activations ``s1..s5`` over through
device memory and keep them as residuals when a gradient is wanted),
``estimator_chain_bwd`` for the pre-activation cotangents ``gz1..gz5`` and
``dxin``, and the weight and bias gradients as plain conv weight gradients
on the saved activations. A CPU tensor goes to the plain version; nothing
falls back from the kernel to it or to a library convolution.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P
from pwcnet_tpu_torch.ops.estimator_conv import (
    NCONV,
    chain_weight_grads,
    estimator_chain_bwd_plain,
    estimator_chain_plain,
)

__all__ = ["estimator_chain_fused", "estimator_chain_bwd"]

_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = [P, _PP, _PP, _PP, P, _IP] + [I] * 4 + [P]
_BWD_ARGTYPES = [P, P, _PP, _PP, _PP, P, P, _IP] + [I] * 4 + [P]


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _tap_major(k: torch.Tensor) -> torch.Tensor:
    """OIHW kernel -> ``[ky][kx][in][out]``, ``out`` zero-padded to a
    multiple of 8."""
    w = k.permute(2, 3, 1, 0)
    return F.pad(w, (0, -w.shape[3] % 8)) if w.shape[3] % 8 else w.contiguous()


def _check_chain(name, xin, ks, bs=None):
    """Shapes of the chain; returns ``(B, H, W, chans)`` with ``chans`` the
    channel counts ``[Cin, C1, .., C6]``."""
    if xin.dim() != 4:
        raise ValueError(f"{name}: xin must be (B, H, W, Cin), got {tuple(xin.shape)}")
    if len(ks) != NCONV:
        raise ValueError(f"{name}: want {NCONV} kernels, got {len(ks)}")
    b, h, w, cin = xin.shape
    chans = [cin]
    for i, k in enumerate(ks):
        if k.dim() != 4 or tuple(k.shape[1:]) != (chans[-1], 3, 3):
            raise ValueError(f"{name}: k{i + 1} is {tuple(k.shape)}, want (C, {chans[-1]}, 3, 3)")
        chans.append(k.shape[0])
        if i < NCONV - 1 and k.shape[0] % 8:
            raise ValueError(f"{name}: hidden width {k.shape[0]} of conv {i + 1} is no multiple of 8")
        if bs is not None and tuple(bs[i].shape) != (k.shape[0],):
            raise ValueError(f"{name}: b{i + 1} is {tuple(bs[i].shape)}, want ({k.shape[0]},)")
    return b, h, w, chans


def _pad_input(xin, kbs):
    """``(xin, kbs)`` with ``k1`` zero-padded to ``xin``'s channels where the
    input arrives padded to a multiple of 8, and a CUDA bf16 input of no
    multiple of 8 padded here (the TMA loads need 16-byte strides). Both pads
    are differentiable: the tail's gradient is dropped on the way back."""
    if len(kbs) != 2 * NCONV:
        raise ValueError(f"estimator_chain_fused: want {2 * NCONV} kernels and biases, got {len(kbs)}")
    cx, cin = xin.shape[-1], kbs[0].shape[1]
    if cx not in (cin, -(-cin // 8) * 8):
        raise ValueError(f"estimator_chain_fused: xin has {cx} channels, k1 takes {cin} (or that padded to 8)")
    if xin.device.type == "cuda" and xin.dtype == torch.bfloat16 and cx % 8:
        xin = F.pad(xin, (0, -cx % 8))
    if xin.shape[-1] == cin:
        return xin, kbs
    return xin, (F.pad(kbs[0], (0, 0, 0, 0, 0, xin.shape[-1] - cin)), *kbs[1:])


def _forward(xin, kbs):
    """Launch the forward; returns ``(flow, [s1, .., s5])``."""
    ks, bs = kbs[0::2], kbs[1::2]
    _common.check_tensors("estimator_chain_fused", xin, *kbs)
    b, h, w, chans = _check_chain("estimator_chain_fused", xin, ks, bs)
    if xin.dtype == torch.bfloat16:  # packed for wgmma on the card, into `packed`
        wts = ks
        packed = torch.empty(
            sum(_common.packed_numel(ci, co) for ci, co in zip(chans, chans[1:])), dtype=xin.dtype, device=xin.device
        )
    else:
        wts, packed = [_tap_major(k) for k in ks], None
    outs = [torch.empty((b, h, w, c), dtype=xin.dtype, device=xin.device) for c in chans[1:]]
    _common.launch(
        "estimator_conv", "pwc_estimator_chain", _ARGTYPES, xin.device,
        xin.data_ptr(), _ptrs(wts), _ptrs(bs), _ptrs(outs), None if packed is None else packed.data_ptr(),
        (ctypes.c_int * len(chans))(*chans), b, h, w, _common.DTYPE_CODES[xin.dtype],
    )
    estimator_chain_fused.launches += 1
    return outs[-1], outs[:-1]


def estimator_chain_residuals(xin, *kbs):
    """K7 with the residuals a training step keeps: ``(flow_raw, features,
    [s1, .., s4])``. For holding them against the plain version."""
    xin, kbs = _pad_input(xin, kbs)
    if xin.device.type == "cpu":
        return estimator_chain_plain(xin, *kbs, return_acts=True)
    flow, acts = _forward(xin, kbs)
    return flow, acts[-1], acts[:-1]


def estimator_chain_bwd(ks, acts, g_flow, g_feat, need_dx: bool = True):
    """K7's backward: ``([gz1, .., gz5], dxin)``, the cotangents of the five
    pre-activations and of the chain's input (None when ``need_dx`` is
    false). ``ks``: the six OIHW kernels; ``acts``: ``[s1, .., s5]``.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel."""
    if g_flow.device.type == "cpu":
        return estimator_chain_bwd_plain(ks, acts, g_flow, g_feat, need_dx)
    name = "estimator_chain_bwd"
    _common.check_tensors(name, *ks)
    if len(ks) != NCONV:
        raise ValueError(f"{name}: want {NCONV} kernels, got {len(ks)}")
    chans = [ks[0].shape[1]] + [k.shape[0] for k in ks]
    for i, k in enumerate(ks):
        if tuple(k.shape) != (chans[i + 1], chans[i], 3, 3):
            raise ValueError(f"{name}: k{i + 1} is {tuple(k.shape)}")
    return _backward(ks, chans, acts, g_flow, g_feat, need_dx)


def bwd_scratch_numel(chans, need_dx: bool) -> int:
    """Elements of the bf16 backward's scratch buffer: the transposed
    kernels of the stages it runs (conv_{i+1}^T: K = ``chans[i + 1]``, the
    N tiles of ``chans[i]``; conv1^T only with dxin)."""
    return sum(_common.packed_numel(chans[i + 1], chans[i]) for i in range(0 if need_dx else 1, NCONV))


def _backward(ks, chans, acts, g_flow, g_feat, need_dx):
    """Launch the backward on the OIHW kernels ``ks`` (bf16: packed on the
    card, ``g_flow`` padded to a multiple of 8 channels; float32: tap-major
    copies); ``chans`` are the channel counts ``[Cin, C1, .., C6]``."""
    name = "estimator_chain_bwd"
    _common.check_tensors(name, g_flow, g_feat, *acts, *ks)
    if len(acts) != NCONV - 1:
        raise ValueError(f"{name}: want {NCONV - 1} activations, got {len(acts)}")
    b, h, w, _ = g_flow.shape
    for key, t, c in [("g_flow", g_flow, chans[-1]), ("g_feat", g_feat, chans[-2])] + [
        (f"s{i + 1}", a, chans[i + 1]) for i, a in enumerate(acts)
    ]:
        if tuple(t.shape) != (b, h, w, c):
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, want {(b, h, w, c)}")
    if any(c % 8 for c in chans[1:-1]):
        raise ValueError(f"{name}: a hidden width of {chans[1:-1]} is no multiple of 8")
    gzs = [torch.empty_like(a) for a in acts]
    dxin = torch.empty((b, h, w, chans[0]), dtype=g_flow.dtype, device=g_flow.device) if need_dx else None
    if g_flow.dtype == torch.bfloat16:
        wts = ks
        scratch = torch.empty(bwd_scratch_numel(chans, need_dx), dtype=g_flow.dtype, device=g_flow.device)
        g_flow = F.pad(g_flow, (0, -chans[-1] % 8)) if chans[-1] % 8 else g_flow
    else:
        wts, scratch = [_tap_major(k) for k in ks], None
    _common.launch(
        "estimator_conv_bwd", "pwc_estimator_chain_bwd", _BWD_ARGTYPES, g_flow.device,
        g_flow.data_ptr(), g_feat.data_ptr(), _ptrs(acts), _ptrs(wts), _ptrs(gzs),
        dxin.data_ptr() if need_dx else None, None if scratch is None else scratch.data_ptr(),
        (ctypes.c_int * len(chans))(*chans), b, h, w, _common.DTYPE_CODES[g_flow.dtype],
    )
    estimator_chain_bwd.launches += 1
    return gzs, dxin


class _EstimatorChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xin, *kbs):
        flow, acts = _forward(xin, kbs)
        ctx.save_for_backward(xin, *kbs[0::2], *acts)
        return flow, acts[-1]

    @staticmethod
    def backward(ctx, g_flow, g_feat):
        xin, *rest = ctx.saved_tensors
        ks, acts = rest[:NCONV], rest[NCONV:]
        chans = [ks[0].shape[1]] + [k.shape[0] for k in ks]
        # autograd hands an unused output's cotangent over as zeros
        g_flow, g_feat = g_flow.contiguous(), g_feat.contiguous()
        gzs, dxin = _backward(ks, chans, acts, g_flow, g_feat, ctx.needs_input_grad[0])
        grads = chain_weight_grads(xin, acts, gzs, g_flow, [k.shape for k in ks])
        return (dxin, *grads)


def estimator_chain_fused(xin: torch.Tensor, *kbs: torch.Tensor):
    """The fused chain: ``xin`` (B, H, W, Cin), or with its channels
    zero-padded to a multiple of 8 -> ``(flow_raw (B, H, W, 2), features
    (B, H, W, C5))``.

    A CPU tensor goes to the plain version (ordinary autograd); a CUDA tensor
    to the kernels, with ``estimator_chain_bwd`` as the backward."""
    xin, kbs = _pad_input(xin, kbs)
    if xin.device.type == "cpu":
        return estimator_chain_plain(xin, *kbs)
    return _on_card(xin, kbs)


def _on_card(xin, kbs):
    """The kernels' path: ``_EstimatorChain`` where a gradient is wanted
    (also in a checkpoint's recompute, which runs with grad enabled), else
    the forward alone."""
    if _common.wants_grad(xin, *kbs):
        return _EstimatorChain.apply(xin, *kbs)
    flow, acts = _forward(xin, kbs)
    return flow, acts[-1]


estimator_chain_fused.launches = 0
estimator_chain_bwd.launches = 0
