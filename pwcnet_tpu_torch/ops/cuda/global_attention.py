"""R4: GMFlow's global matching and propagation as one CUDA kernel
(``csrc/global_attention.cu``): ``softmax(q k^T / sqrt(128)) v`` over every
key, bf16 scores on the tensor cores, a float32 online softmax and the
2-column float32 value on the CUDA cores.

Replaces no TPU kernel: the JAX package has no GMFlow. The plain version is
``pwcnet_tpu_torch.ops.attention._plain``; ``ops.attention.global_attention``
sends CPU tensors there and CUDA tensors here. The kernel computes the
forward only: under grad mode with an input that requires grad it raises
(GMFlow serves under ``torch.inference_mode``).

R5 (``attention_softmax_cuda``, same source, since GMA): a block of rows of
float32 scores (cuBLAS's, ``ops.attention.global_softmax``) to
``softmax(scale x)`` over each row, in float32, each probability rounded
once to bf16 into its row of the (B, N, N) probabilities; forward only, as
R4. Its plain version is ``ops.attention._softmax_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P

__all__ = ["attention_softmax_cuda", "global_attention_cuda"]

CHANNELS = 128  # q and k's channels and the value's columns, which the kernel is built for
VALUE_COLUMNS = 2
_ARGTYPES = [P, P, P, ctypes.c_longlong, P, I, I, P]


def global_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``q``, ``k`` (B, N, 128) bf16, contiguous; ``v`` (B, N, 2) float32
    (any batch stride, 0 included: ``grid.expand(B, N, 2)`` is not copied)
    -> (B, N, 2) float32, ``softmax(q k^T / sqrt(128)) v``. One launch a
    call; raises on what the kernel does not take."""
    name = "global_attention_cuda"
    if q.dim() != 3 or q.shape[2] != CHANNELS or k.shape != q.shape:
        raise ValueError(f"{name}: q and k must be (B, N, {CHANNELS}), got {tuple(q.shape)} and {tuple(k.shape)}")
    b, n, _ = q.shape
    if v.shape != (b, n, VALUE_COLUMNS):
        raise ValueError(f"{name}: v must be ({b}, {n}, {VALUE_COLUMNS}), got {tuple(v.shape)}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.float32:
        raise TypeError(f"{name}: q and k must be bfloat16 and v float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if _common.wants_grad(q, k, v):
        raise RuntimeError(f"{name}: the kernel has no backward; call it without grad (torch.no_grad or "
                           "torch.inference_mode) or on tensors that do not require grad")
    if not (q.is_contiguous() and k.is_contiguous()) or q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError(f"{name}: q and k must be contiguous and 16-byte aligned (the kernel reads them by TMA)")
    if v.stride(2) != 1 or v.stride(1) != VALUE_COLUMNS:
        v = v.contiguous()  # the kernel reads rows of 2 values at a batch stride of its own
    if v.data_ptr() % 8:
        raise ValueError(f"{name}: v must be 8-byte aligned (the kernel reads each row's 2 values at once)")
    if any(t.device != q.device or t.device.type != "cuda" for t in (q, k, v)):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    out = torch.empty((b, n, VALUE_COLUMNS), dtype=torch.float32, device=q.device)
    if out.numel():
        _common.launch("global_attention", "pwc_global_attention", _ARGTYPES, q.device, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), v.stride(0), out.data_ptr(), b, n)
        global_attention_cuda.launches += 1
    return out


global_attention_cuda.launches = 0


def attention_softmax_cuda(scores: torch.Tensor, scale: float, out: torch.Tensor) -> None:
    """R5: ``out = softmax(scale * scores, -1)`` rounded to bf16; ``scores``
    (B, R, N) float32, contiguous; ``out`` (B, R, N) bf16 with rows of N
    contiguous elements at any row and batch stride (rows ``r0:r0 + R`` of
    the (B, N, N) probabilities). One launch a call; raises on what the
    kernel does not take."""
    name = "attention_softmax_cuda"
    if scores.dim() != 3 or out.shape != scores.shape:
        raise ValueError(f"{name}: scores and out must be (B, R, N) alike, got {tuple(scores.shape)} and "
                         f"{tuple(out.shape)}")
    if scores.dtype != torch.float32 or out.dtype != torch.bfloat16:
        raise TypeError(f"{name}: scores must be float32 and out bfloat16, got {scores.dtype} and {out.dtype}")
    if _common.wants_grad(scores):
        raise RuntimeError(f"{name}: the kernel has no backward; call it without grad (torch.no_grad or "
                           "torch.inference_mode) or on tensors that do not require grad")
    b, r, n = scores.shape
    if not scores.is_contiguous() or out.stride(2) != 1:
        raise ValueError(f"{name}: scores must be contiguous and each row of out contiguous")
    if scores.device.type != "cuda" or out.device != scores.device:
        raise ValueError(f"{name}: both tensors must be on one CUDA device")
    if b * r > 2**31 - 1:
        raise ValueError(f"{name}: {b * r} rows exceed a launch's grid")
    if scores.numel():
        _common.launch("global_attention", "pwc_attention_softmax",
                       [P, P, I, I, I, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, P], scores.device,
                       scores.data_ptr(), out.data_ptr(), b * r, r, n, out.stride(0), out.stride(1), float(scale))
        attention_softmax_cuda.launches += 1


attention_softmax_cuda.launches = 0
