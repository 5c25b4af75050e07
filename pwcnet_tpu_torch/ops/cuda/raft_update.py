"""R2 and R3: RAFT's update block without its eager tail, as CUDA kernels
(``csrc/raft_update.cu``).

- R2, ``conv_epilogue_cuda``: ``act(conv + bias)`` into one or two channel
  slots; ``coords_update_cuda``, flow_head.conv2's epilogue: the rounded
  delta added to the float32 coordinates in place, and the flow into up to
  three slots.
- R3, ``gru_gate_zr_cuda``: ``z = sigmoid(z_pre + b_z)``, ``r h`` with ``r
  = sigmoid(r_pre + b_r)``; ``gru_gate_h_cuda``: ``h = (1 - z) h + z
  tanh(q_pre + b_q)`` in place.
- R6, ``aggregate_epilogue_cuda`` (GMA's update): ``mf + gamma agg`` into
  the global slots, ``agg`` the float32 aggregation.

Replaces no TPU kernel: the JAX package has no RAFT. The plain versions are
in ``pwcnet_tpu_torch.ops.raft_update``, which sends CPU tensors there and
CUDA tensors here. The kernels compute the forward only: under grad mode
with an input that requires grad they raise (RAFT serves under
``torch.inference_mode``).

A conv output is (B, C, h, w) in ``channels_last`` memory; a slot is a
(B, C, h, w) view of a ``channels_last`` buffer's channels (``buf[:, k:k +
C]``), or a whole ``channels_last`` tensor. Every tensor but the
coordinates is in the model's dtype, float32 or bfloat16, on one device.

Launch counts: R2's two entry points count in
``conv_epilogue_cuda.launches``, R3's two in ``gru_gate_zr_cuda.launches``,
R6 in ``aggregate_epilogue_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P

__all__ = ["ACTS", "aggregate_epilogue_cuda", "conv_epilogue_cuda", "coords_update_cuda", "gru_gate_h_cuda",
           "gru_gate_zr_cuda"]

ACTS = {"identity": 0, "relu": 1, "sigmoid": 2, "tanh": 3}  # csrc/raft_update.cu `Act`
L = ctypes.c_longlong
MAX_ITEMS = 2**31 - 1  # elements a launch: the kernels index their vectors in 32 bits
_LIB = "raft_update"


def _check(name: str, tensors, slots, grad_inputs) -> None:
    """Raise unless no input wants a gradient, every tensor and slot is in
    one dtype the kernels take and every slot is a channel slot of a
    channels_last buffer (the checks that need no device)."""
    if _common.wants_grad(*grad_inputs):
        raise RuntimeError(f"{name}: the kernel has no backward; call it without grad (torch.no_grad or "
                           "torch.inference_mode) or on tensors that do not require grad")
    dtypes = {t.dtype for t in (*tensors, *slots)}
    if len(dtypes) != 1 or not dtypes <= set(_common.DTYPE_CODES):
        raise TypeError(f"{name}: every tensor but the coordinates must be float32 or bfloat16, one dtype; got "
                        f"{sorted(map(str, dtypes))}")
    for s in slots:
        _slot_stride(name, s)


def _on_cuda(name: str, tensors, slots) -> None:
    """Raise unless every tensor is contiguous (a 4-D one in channels_last
    memory) and every tensor and slot is on one CUDA device."""
    _common.check_tensors(name, *[t if t.dim() == 1 else _nhwc(name, t) for t in tensors])
    if any(s.device != tensors[0].device for s in slots):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")


def _nhwc(name: str, t: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) in channels_last memory -> its contiguous (B, h, w, C) view."""
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (B, C, h, w), got {tuple(t.shape)}")
    return t.permute(0, 2, 3, 1)


def _slot_stride(name: str, s: torch.Tensor) -> int:
    """The pixel stride (the buffer's channels, ``s.stride(3)``) of a channel
    slot; raises on a view that is not one."""
    if s.dim() != 4:
        raise ValueError(f"{name}: a slot must be (B, C, h, w), got {tuple(s.shape)}")
    b, c, h, w = s.shape
    st = s.stride(3)
    if s.stride(1) != 1 or st < c or s.stride(2) != w * st or (b > 1 and s.stride(0) != h * w * st):
        raise ValueError(f"{name}: a slot must be a channel slot of a channels_last buffer, got shape "
                         f"{tuple(s.shape)} strides {s.stride()}")
    return st


def _slot_args(slots, count: int) -> list:
    """Each slot's pointer and pixel stride, then (null, 0) up to ``count``
    slots."""
    return [v for s in slots for v in (s.data_ptr(), s.stride(3))] + [None, 0] * (count - len(slots))


def _same_shape(name: str, want: tuple, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: expected shape {tuple(want)}, got {tuple(t.shape)}")


def _items(name: str, n: int, c: int) -> None:
    if n * c > MAX_ITEMS:
        raise ValueError(f"{name}: {n} pixels of {c} channels exceed the kernel's 2**31 - 1 elements a launch")


def conv_epilogue_cuda(x: torch.Tensor, bias: torch.Tensor, act: str, *outs: torch.Tensor) -> None:
    """R2: ``out = act(x + bias)`` for each of one or two slots ``outs``;
    ``x`` a conv's output (B, C, h, w) without its bias, ``bias`` (C,). One
    launch a call."""
    name = "conv_epilogue_cuda"
    if act not in ACTS:
        raise ValueError(f"{name}: act must be one of {sorted(ACTS)}, got {act!r}")
    if not 1 <= len(outs) <= 2:
        raise ValueError(f"{name}: one or two slots, got {len(outs)}")
    _check(name, (x, bias), outs, (x, bias))
    b, h, w, c = _nhwc(name, x).shape
    _same_shape(name, (c,), bias)
    _same_shape(name, x.shape, *outs)
    _on_cuda(name, (x, bias), outs)
    n = b * h * w
    _items(name, n, c)
    if n == 0:
        return
    _common.launch(
        _LIB, "pwc_raft_epilogue", [I, I, P, P, I, P, L, P, L, L, P], x.device,
        _common.DTYPE_CODES[x.dtype], ACTS[act], x.data_ptr(), bias.data_ptr(), c, *_slot_args(outs, 2), n,
    )
    conv_epilogue_cuda.launches += 1


def coords_update_cuda(delta: torch.Tensor, bias: torch.Tensor, coords: torch.Tensor, *flows: torch.Tensor) -> None:
    """R2, flow_head.conv2's epilogue: ``d = delta + bias`` rounded to the
    model's dtype; ``coords += d`` (``coords`` (B, h, w, 2) float32,
    contiguous, in place); ``flow = coords - (x, y)`` of each pixel, rounded,
    into each of up to three 2-channel slots ``flows``. One launch a call,
    counted in ``conv_epilogue_cuda.launches``."""
    name = "coords_update_cuda"
    if len(flows) > 3:
        raise ValueError(f"{name}: at most three flow slots, got {len(flows)}")
    _check(name, (delta, bias), flows, (delta, bias, coords))
    b, h, w, _ = _nhwc(name, delta).shape
    _same_shape(name, (2,), bias)
    _same_shape(name, (b, 2, h, w), delta, *flows)
    _same_shape(name, (b, h, w, 2), coords)
    if coords.dtype != torch.float32:
        raise TypeError(f"{name}: coords must be float32, got {coords.dtype}")
    _on_cuda(name, (delta, bias), flows)
    if coords.device != delta.device or not coords.is_contiguous():
        raise ValueError(f"{name}: coords must be contiguous on the delta's device")
    n = b * h * w
    _items(name, n, 1)
    if n == 0:
        return
    _common.launch(
        _LIB, "pwc_raft_coords", [I, P, P, P, I, I, P, L, P, L, P, L, L, P], delta.device,
        _common.DTYPE_CODES[delta.dtype], delta.data_ptr(), bias.data_ptr(), coords.data_ptr(), h, w,
        *_slot_args(flows, 3), n,
    )
    conv_epilogue_cuda.launches += 1


def gru_gate_zr_cuda(z_pre: torch.Tensor, r_pre: torch.Tensor, bz: torch.Tensor, br: torch.Tensor,
                     h: torch.Tensor, rh: torch.Tensor, z: torch.Tensor) -> None:
    """R3, gate 1: ``z = sigmoid(z_pre + bz)`` into ``z`` (channels_last,
    contiguous) and ``r h``, ``r = sigmoid(r_pre + br)``, into the slot
    ``rh``; ``h`` a slot. One launch a call."""
    name = "gru_gate_zr_cuda"
    _check(name, (z_pre, r_pre, bz, br, z), (h, rh), (z_pre, r_pre, bz, br, h))
    b, hh, w, c = _nhwc(name, z_pre).shape
    _same_shape(name, (c,), bz, br)
    _same_shape(name, z_pre.shape, r_pre, h, rh, z)
    _on_cuda(name, (z_pre, r_pre, bz, br, z), (h, rh))
    n = b * hh * w
    _items(name, n, c)
    if n == 0:
        return
    _common.launch(
        _LIB, "pwc_raft_gate_zr", [I, P, P, P, P, P, L, P, L, P, I, L, P], z_pre.device,
        _common.DTYPE_CODES[z_pre.dtype], z_pre.data_ptr(), r_pre.data_ptr(), bz.data_ptr(),
        br.data_ptr(), h.data_ptr(), h.stride(3), rh.data_ptr(), rh.stride(3),
        z.data_ptr(), c, n,
    )
    gru_gate_zr_cuda.launches += 1


def gru_gate_h_cuda(q_pre: torch.Tensor, bq: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                    net: torch.Tensor | None = None) -> None:
    """R3, gate 2: ``h = (1 - z) h + z tanh(q_pre + bq)`` in place in the
    slot ``h``, and into ``net`` (channels_last, contiguous) where given.
    One launch a call, counted in ``gru_gate_zr_cuda.launches``."""
    name = "gru_gate_h_cuda"
    extra = () if net is None else (net,)
    _check(name, (q_pre, bq, z, *extra), (h,), (q_pre, bq, z, h))
    b, hh, w, c = _nhwc(name, q_pre).shape
    _same_shape(name, (c,), bq)
    _same_shape(name, q_pre.shape, z, h, *extra)
    _on_cuda(name, (q_pre, bq, z, *extra), (h,))
    n = b * hh * w
    _items(name, n, c)
    if n == 0:
        return
    _common.launch(
        _LIB, "pwc_raft_gate_h", [I, P, P, P, P, L, P, I, L, P], q_pre.device,
        _common.DTYPE_CODES[q_pre.dtype], q_pre.data_ptr(), bq.data_ptr(), z.data_ptr(), h.data_ptr(),
        h.stride(3), None if net is None else net.data_ptr(), c, n,
    )
    gru_gate_zr_cuda.launches += 1


def aggregate_epilogue_cuda(mf: torch.Tensor, agg: torch.Tensor, gamma: torch.Tensor, *outs: torch.Tensor) -> None:
    """R6: ``out = mf + gamma agg`` for each of one or two slots ``outs``;
    ``mf`` a slot (B, C, h, w), ``agg`` (B, h w, C) float32, contiguous,
    ``gamma`` (1,) in the slots' dtype. The product and the sum each
    rounded in float32, the result once to the slots' dtype. One launch a
    call."""
    name = "aggregate_epilogue_cuda"
    if not 1 <= len(outs) <= 2:
        raise ValueError(f"{name}: one or two slots, got {len(outs)}")
    _check(name, (gamma,), (mf, *outs), (mf, agg, gamma))
    b, c, h, w = mf.shape
    _same_shape(name, (1,), gamma)
    _same_shape(name, (b, h * w, c), agg)
    _same_shape(name, mf.shape, *outs)
    if agg.dtype != torch.float32:
        raise TypeError(f"{name}: agg must be float32, got {agg.dtype}")
    _on_cuda(name, (gamma,), (mf, *outs))
    if agg.device != gamma.device or not agg.is_contiguous():
        raise ValueError(f"{name}: agg must be contiguous on the slots' device")
    n = b * h * w
    _items(name, n, c)
    if n == 0:
        return
    _common.launch(
        _LIB, "pwc_raft_aggregate", [I, P, L, P, P, I, P, L, P, L, L, P], mf.device,
        _common.DTYPE_CODES[mf.dtype], mf.data_ptr(), mf.stride(3), agg.data_ptr(), gamma.data_ptr(), c,
        *_slot_args(outs, 2), n,
    )
    aggregate_epilogue_cuda.launches += 1


conv_epilogue_cuda.launches = 0
gru_gate_zr_cuda.launches = 0
aggregate_epilogue_cuda.launches = 0
