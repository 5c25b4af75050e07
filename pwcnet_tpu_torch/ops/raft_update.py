"""RAFT's update block after its convs: each conv's bias and activation,
the GRU's gates and the coordinates' update, written into channel slots of
the buffers that the next conv reads (``models/raft.py``).

Each op sends CPU tensors to its plain PyTorch version here and CUDA tensors
to its kernel, R2 or R3 (``ops.cuda.raft_update``), which raises on what it
does not take (grad among it); nothing falls back. The plain versions run on
either device, compute in float32 and round once to the slot's dtype, as
the kernels do.

- `conv_epilogue`: ``out = act(x + bias)``, ``act`` one of ``ACTS``, into
  each of one or two slots.
- `coords_update`: ``d = x + bias``, rounded to the model's dtype;
  ``coords += d`` in float32, in place; ``flow = coords - (x, y)`` of each
  pixel, rounded, into each of up to three 2-channel slots.
- `gru_gate_zr`: ``z = sigmoid(z_pre + b_z)`` into ``z``, ``r h`` with ``r
  = sigmoid(r_pre + b_r)`` into the slot ``rh``.
- `gru_gate_h`: ``h = (1 - z) h + z tanh(q_pre + b_q)`` in place in the
  slot ``h``, and into ``net`` where given.
- `aggregate_epilogue` (GMA's update; on CUDA tensors R6): ``mf + gamma
  agg`` into each of one or two slots, ``mf`` the motion features' slot,
  ``agg`` the float32 aggregation (B, h w, C), ``gamma`` (1,); the product
  and the sum each rounded in float32, then once to the slots' dtype.

``x`` and the pre-activations are conv outputs (B, C, h, w) without their
bias; ``bias`` (C,); a slot is a (B, C, h, w) view of a ``channels_last``
buffer's channels (``buf[:, k:k + C]``) or a whole tensor; ``coords`` (B,
h, w, 2) float32, (x, y).
"""

from __future__ import annotations

import torch

from pwcnet_tpu_torch.ops.cuda.raft_update import (
    ACTS, aggregate_epilogue_cuda, conv_epilogue_cuda, coords_update_cuda, gru_gate_h_cuda, gru_gate_zr_cuda)

__all__ = [
    "ACTS", "aggregate_epilogue", "aggregate_epilogue_plain", "conv_epilogue", "conv_epilogue_plain", "coords_update",
    "coords_update_plain", "gru_gate_h", "gru_gate_h_plain", "gru_gate_zr", "gru_gate_zr_plain",
]

_FNS = {"identity": lambda v: v, "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}


def _plus(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return x.float() + bias.float()[:, None, None]


def conv_epilogue(x: torch.Tensor, bias: torch.Tensor, act: str, *outs: torch.Tensor) -> None:
    if x.device.type == "cpu":
        return conv_epilogue_plain(x, bias, act, *outs)
    return conv_epilogue_cuda(x, bias, act, *outs)


def conv_epilogue_plain(x: torch.Tensor, bias: torch.Tensor, act: str, *outs: torch.Tensor) -> None:
    if act not in ACTS:
        raise ValueError(f"conv_epilogue: act must be one of {sorted(ACTS)}, got {act!r}")
    y = _FNS[act](_plus(x, bias))
    for out in outs:
        out.copy_(y)


def coords_update(x: torch.Tensor, bias: torch.Tensor, coords: torch.Tensor, *flows: torch.Tensor) -> None:
    if x.device.type == "cpu":
        return coords_update_plain(x, bias, coords, *flows)
    return coords_update_cuda(x, bias, coords, *flows)


def coords_update_plain(x: torch.Tensor, bias: torch.Tensor, coords: torch.Tensor, *flows: torch.Tensor) -> None:
    b, _, h, w = x.shape
    coords += _plus(x, bias).to(x.dtype).float().permute(0, 2, 3, 1)
    ys, xs = torch.meshgrid(torch.arange(h, device=x.device), torch.arange(w, device=x.device), indexing="ij")
    flow = (coords - torch.stack([xs, ys], -1).float()).to(x.dtype).permute(0, 3, 1, 2)
    for out in flows:
        out.copy_(flow)


def gru_gate_zr(z_pre, r_pre, bz, br, h, rh, z) -> None:
    if z_pre.device.type == "cpu":
        return gru_gate_zr_plain(z_pre, r_pre, bz, br, h, rh, z)
    return gru_gate_zr_cuda(z_pre, r_pre, bz, br, h, rh, z)


def gru_gate_zr_plain(z_pre, r_pre, bz, br, h, rh, z) -> None:
    z.copy_(torch.sigmoid(_plus(z_pre, bz)))
    rh.copy_(torch.sigmoid(_plus(r_pre, br)) * h.float())


def gru_gate_h(q_pre, bq, z, h, net=None) -> None:
    if q_pre.device.type == "cpu":
        return gru_gate_h_plain(q_pre, bq, z, h, net)
    return gru_gate_h_cuda(q_pre, bq, z, h, net)


def gru_gate_h_plain(q_pre, bq, z, h, net=None) -> None:
    zf = z.float()
    new = (1 - zf) * h.float() + zf * torch.tanh(_plus(q_pre, bq))
    h.copy_(new)
    if net is not None:
        net.copy_(new)


def aggregate_epilogue(mf, agg, gamma, *outs) -> None:
    if mf.device.type == "cpu":
        return aggregate_epilogue_plain(mf, agg, gamma, *outs)
    return aggregate_epilogue_cuda(mf, agg, gamma, *outs)


def aggregate_epilogue_plain(mf, agg, gamma, *outs) -> None:
    b, c, h, w = mf.shape
    y = mf.float() + gamma.float() * agg.view(b, h, w, c).permute(0, 3, 1, 2)
    for out in outs:
        out.copy_(y)
