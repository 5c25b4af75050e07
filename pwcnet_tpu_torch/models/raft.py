"""RAFT (Teed & Deng, "Recurrent All-Pairs Field Transforms for Optical
Flow", ECCV 2020, arXiv:2003.12039) in PyTorch: the full model of
princeton-vl/RAFT ``core/raft.py``, ``extractor.py``, ``update.py`` and
``corr.py``, not ``--small``.

- ``fnet``, a residual encoder with instance norm, maps both frames (one
  2B batch) to 256-channel features at 1/8 resolution; ``cnet``, the same
  encoder with BatchNorm, maps frame 0 to ``net = tanh(:128)`` and ``inp =
  relu(128:)``.
- The all-pairs correlation of the features and its 4-level pyramid
  (``ops.corr_lookup``), once a forward.
- ``iters`` updates of the flow at 1/8 resolution, from zero: the lookup
  of a radius-4 window at ``coords1`` on every level, the motion encoder,
  the separable ConvGRU and the flow head, whose delta moves ``coords1``.
  Each conv of the update runs without its bias; an op of
  ``ops.raft_update`` (on CUDA tensors R2 or R3) adds it, applies the
  activation or the GRU's gates, and writes the result into its channel
  slot of the buffers the next conv reads (`UpdateBuffers`, made once a
  forward), so the update concatenates nothing.
- The convex upsample to full resolution: a softmax over the 9 neighbours
  of each of 64 sub-pixels, weighting ``unfold(8 flow)``. RAFT computes the
  mask and the upsample at every iteration and returns the last; here both
  run once, after the last iteration, which gives the same flow.

Module and parameter names are RAFT's (``fnet.layer1.0.conv1``,
``cnet.norm1.running_mean``, ``update_block.gru.convz1``,
``update_block.mask.0``, ...), so a published state dict loads without its
``module.`` prefix. ``cnet``'s BatchNorm always normalises by its running
statistics, as RAFT's ``freeze_bn`` leaves it (the model serves; it does
not train here).

Frames are NHWC in [0, 1], mapped by ``2 x - 1`` (RAFT's ``2 (x / 255) -
1`` of 8-bit frames); H and W must be multiples of 8 (padding is the
caller's, as RAFT's ``InputPadder`` is). ``forward`` returns ``(flow (B, H,
W, 2), flow_low (B, H/8, W/8, 2))``, in pixels of their own resolution.

Precision: the model computes in its parameters' dtype (``model.to(
torch.bfloat16)`` serves in bf16), as RAFT's mixed precision splits it:
every conv, ``net`` and ``inp`` in that dtype; the correlation, its
pyramid, the lookup's output, the coordinates, the flow and the upsample's
softmax and weighted sum in float32; the norms compute their statistics
and scale in float32; the update's bias, activation and gate arithmetic in
float32, rounded once to that dtype (RAFT rounds after the bias, after the
activation and after each product of the gates). Inside, tensors are NCHW
in ``channels_last`` memory, and so are the convs' weights.

Spans (``utils.profiling``): ``model.forward`` (B pairs) with
``model.encode`` (both encoders), ``model.corr`` (product and pyramid) and
``model.upsample`` once a forward, ``model.lookup`` and ``model.update``
(motion encoder, GRU, flow head, coordinates) once an iteration.

Initial weights are PyTorch's default init: RAFT's own draw is not
reproduced, and its published checkpoints are what a user serves.

GMFlow (``models/gmflow.py``) shares `BasicEncoder` and `ResidualBlock`
(with ``bias=False``), the instance norm and `convex_upsample`. GMA
(``models/gma.py``) is this model with an attention once a forward and an
aggregation in each update: it shares the encoders, the correlation and
its lookup, the motion encoder, `SepConvGRU` (at 512 input channels), the
flow and mask heads, the epilogues of ``ops.raft_update``, `UpdateBuffers`
(``a`` and ``q`` wider by the block's ``global_width``, 0 here), the
upsample and this forward (``buffers_type`` and `RAFT._attend` are its
hooks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pwcnet_tpu_torch.models.conv import Conv2d, cast_params, to_nchw
from pwcnet_tpu_torch.ops.corr_lookup import corr_pyramid, lookup
from pwcnet_tpu_torch.ops.raft_update import conv_epilogue, coords_update, gru_gate_h, gru_gate_zr
from pwcnet_tpu_torch.utils.profiling import span

__all__ = ["RAFT", "BasicEncoder", "BasicUpdateBlock", "UpdateBuffers", "convex_upsample"]


class InstanceNorm2d(nn.Module):
    """``nn.InstanceNorm2d(c)`` (no affine, no running statistics) in any
    memory format: statistics and scale in float32, the input's dtype out."""

    eps = 1e-5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x.float(), dim=(2, 3), keepdim=True, correction=0)
        inv = torch.rsqrt(var + self.eps)
        return torch.addcmul(-mean * inv, x, inv, out=torch.empty_like(x))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that normalises by its running statistics in either
    mode (RAFT's ``freeze_bn``); the scale in float32, the input's dtype out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight.float() / torch.sqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * inv
        return torch.addcmul(shift[:, None, None], x, inv[:, None, None], out=torch.empty_like(x))


def _norm(kind: str, c: int) -> nn.Module:
    return BatchNorm2d(c) if kind == "batch" else InstanceNorm2d()


class ResidualBlock(nn.Module):
    """Two 3x3 conv-norm-ReLU stages; at stride 2 a 1x1 strided conv and a
    norm on the shortcut (``norm3``, also ``downsample.1``); ``relu(x + y)``.
    ``bias=False`` leaves the 3x3 convs without a bias (GMFlow's); the
    shortcut's conv keeps its own."""

    def __init__(self, cin: int, c: int, norm: str, stride: int = 1, bias: bool = True):
        super().__init__()
        self.conv1 = Conv2d(cin, c, 3, padding=1, stride=stride, bias=bias)
        self.conv2 = Conv2d(c, c, 3, padding=1, bias=bias)
        self.norm1, self.norm2 = _norm(norm, c), _norm(norm, c)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, c)
            self.downsample = nn.Sequential(Conv2d(cin, c, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7 stride-2 conv 3 -> 64, norm, ReLU; two residual blocks each at
    64 (stride 1), 96 (stride 2), 128 (stride 2); a 1x1 conv to ``out``.
    ``bias=False`` is GMFlow's ``CNNEncoder``: the 7x7 conv and the blocks'
    3x3 convs without a bias, the shortcuts' and the output conv with one."""

    def __init__(self, out: int, norm: str, bias: bool = True):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=bias)
        self.norm1 = _norm(norm, 64)
        cin = 64
        for i, (c, stride) in enumerate(((64, 1), (96, 2), (128, 2))):
            self.add_module(f"layer{i + 1}", nn.Sequential(ResidualBlock(cin, c, norm, stride, bias),
                                                           ResidualBlock(c, c, norm, bias=bias)))
            cin = c
        self.conv2 = Conv2d(128, out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def _conv(conv: Conv2d, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``conv`` of ``x`` without its bias -> (the output, the bias), which an
    op of ``ops.raft_update`` adds."""
    weight, bias = cast_params(conv)
    return conv._conv_forward(x, weight, None), bias


def _conv_act(conv: Conv2d, x: torch.Tensor, act: str, *outs: torch.Tensor) -> torch.Tensor:
    """``act(conv(x))`` into each slot of ``outs``, or into a new tensor ->
    the first slot or that tensor."""
    y, bias = _conv(conv, x)
    outs = outs or (torch.empty_like(y),)
    conv_epilogue(y, bias, act, *outs)
    return outs[0]


class UpdateBuffers:
    """The update block's inputs, made once a forward, ``channels_last`` in
    the model's dtype; the convs read them whole, the ops write their slots:

    - ``a`` ``[h | inp | motion | flow]`` (128 + 128 + 126 + 2), which
      ``convz`` and ``convr`` read; ``q`` ``[r h | inp | motion | flow]``,
      ``convq``'s; ``inp`` written here, once a forward;
    - ``m`` ``[cor | flo]`` (192 + 64), the motion encoder's ``conv``'s;
    - ``flow`` (2 channels), ``convf1``'s; ``z`` (128), the GRU's update
      gate; ``net``, the hidden state after the second GRU pass, which the
      flow head and the mask head read.

    ``inp`` and ``mf`` are the ``inp`` and ``[motion | flow]`` slots of
    ``a``. ``a`` and ``q`` end in ``block.global_width`` more channels
    (none in RAFT's block). The flow slots start at zero (the first
    update's flow)."""

    def __init__(self, net: torch.Tensor, inp: torch.Tensor, block: "BasicUpdateBlock"):
        b, hidden, h, w = net.shape
        context, motion = inp.shape[1], block.encoder.conv.out_channels
        cor = block.encoder.convc2.out_channels

        def buffer(c: int) -> torch.Tensor:
            return to_nchw(net.new_zeros(b, h, w, c))

        at, mf = hidden + context, motion + 2
        self.a, self.q = buffer(at + mf + block.global_width), buffer(at + mf + block.global_width)
        self.m = buffer(cor + block.encoder.convf2.out_channels)
        self.flow, self.z, self.net = buffer(2), buffer(hidden), buffer(hidden)
        self.h, self.rh = self.a[:, :hidden], self.q[:, :hidden]
        self.cor, self.flo = self.m[:, :cor], self.m[:, cor:]
        self.motion = (self.a[:, at:at + motion], self.q[:, at:at + motion])
        self.flows = (self.a[:, at + motion:at + mf], self.q[:, at + motion:at + mf], self.flow)
        self.inp, self.mf = self.a[:, hidden:at], self.a[:, at:at + mf]
        self.net.copy_(net)
        self.h.copy_(net)
        self.a[:, hidden:at].copy_(inp)
        self.q[:, hidden:at].copy_(inp)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1)
        self.convc2 = Conv2d(256, 192, 3, padding=1)
        self.convf1 = Conv2d(2, 128, 7, padding=3)
        self.convf2 = Conv2d(128, 64, 3, padding=1)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, corr: torch.Tensor, s: UpdateBuffers) -> None:
        """RAFT's ``cat([relu(conv(cat([cor, flo]))), flow])``: the motion
        features into their slots of ``s.a`` and ``s.q`` (the flow is there)."""
        _conv_act(self.convc2, _conv_act(self.convc1, corr, "relu"), "relu", s.cor)
        _conv_act(self.convf2, _conv_act(self.convf1, s.flow, "relu"), "relu", s.flo)
        _conv_act(self.conv, s.m, "relu", *s.motion)


class SepConvGRU(nn.Module):
    """A ConvGRU pass of (1, 5) convs, then one of (5, 1) convs."""

    def __init__(self, hidden: int, cin: int):
        super().__init__()
        for i, (k, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0)))):
            for gate in "zrq":
                self.add_module(f"conv{gate}{i + 1}", Conv2d(hidden + cin, hidden, k, padding=pad))

    def forward(self, s: UpdateBuffers) -> None:
        """RAFT's ``z = sigmoid(convz(cat([h, x])))``, ``r`` likewise, ``q =
        tanh(convq(cat([r h, x])))``, ``h = (1 - z) h + z q``, twice: ``h`` in
        its slot of ``s.a``, and in ``s.net`` after the second pass."""
        for i in (1, 2):
            z_pre, bz = _conv(getattr(self, f"convz{i}"), s.a)
            r_pre, br = _conv(getattr(self, f"convr{i}"), s.a)
            gru_gate_zr(z_pre, r_pre, bz, br, s.h, s.rh, s.z)
            q_pre, bq = _conv(getattr(self, f"convq{i}"), s.q)
            gru_gate_h(q_pre, bq, s.z, s.h, s.net if i == 2 else None)


class FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.conv1 = Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = Conv2d(hidden, 2, 3, padding=1)

    def forward(self, s: UpdateBuffers, coords: torch.Tensor) -> None:
        """RAFT's ``delta = conv2(relu(conv1(net)))``, added to ``coords``
        in place; the new flow into ``s.flows``."""
        delta, bias = _conv(self.conv2, _conv_act(self.conv1, s.net, "relu"))
        coords_update(delta, bias, coords, *s.flows)


class BasicUpdateBlock(nn.Module):
    """The motion encoder, the GRU, the flow head and the upsampling mask
    head (``mask``, run by `RAFT` after the last update only).
    ``global_width``: the channels the GRU reads after ``[h | inp | motion
    | flow]``, none here."""

    global_width = 0

    def __init__(self, corr_planes: int, hidden: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(Conv2d(128, 256, 3, padding=1), nn.ReLU(), Conv2d(256, 64 * 9, 1))

    def forward(self, s: UpdateBuffers, corr: torch.Tensor, coords: torch.Tensor) -> None:
        """One update: ``s``'s hidden state, ``coords`` (B, h, w, 2) float32
        (in place) and ``s``'s flows move on by one step."""
        self.encoder(corr, s)
        self.gru(s)
        self.flow_head(s, coords)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``flow`` (B, h, w, 2) and ``mask`` (B, 576, h, w) -> (B, 8h, 8w, 2)
    in float32: output pixel ``(8 y + sy, 8 x + sx)`` is the sum over the 9
    taps t of ``8 flow`` at (y, x)'s 3x3 neighbours (row-major, zero outside
    the frame), weighted by the softmax over t of ``mask`` channel ``64 t +
    8 sy + sx`` (RAFT's ``mask.view(N, 1, 9, 8, 8, H, W)``)."""
    b, h, w, _ = flow.shape
    weights = torch.softmax(mask.float().permute(0, 2, 3, 1).reshape(b, h, w, 9, 64), dim=3)
    padded = F.pad(8 * flow, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([padded[:, i:i + h, j:j + w] for i in range(3) for j in range(3)], 3)
    up = torch.matmul(weights.transpose(3, 4), taps)  # (b, h, w, 64, 2)
    return up.view(b, h, w, 8, 8, 2).permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """RAFT at its published widths: hidden and context 128, features 256,
    4 correlation levels of radius 4, ``iters`` updates a forward (32, RAFT's
    Sintel evaluation setting; ``make_forward`` passes only the frames)."""

    hidden_dim = context_dim = 128
    corr_levels = corr_radius = 4
    update_block_type = BasicUpdateBlock
    buffers_type = UpdateBuffers

    def __init__(self, iters: int = 32):
        super().__init__()
        self.iters = iters
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, "batch")
        self.update_block = self.update_block_type(self.corr_levels * (2 * self.corr_radius + 1) ** 2,
                                                   self.hidden_dim)
        self.to(memory_format=torch.channels_last)  # weights in their inputs' memory format: no conv copies its weight

    def forward(self, images_0: torch.Tensor, images_1: torch.Tensor):
        """``images_*`` (B, H, W, 3) in [0, 1] -> ``(flow (B, H, W, 2),
        flow_low (B, H/8, W/8, 2))``, float32."""
        b, h, w, _ = images_0.shape
        if h % 8 or w % 8:
            raise ValueError(f"{type(self).__name__} needs H and W multiples of 8 (pad the frames first), got {h}x{w}")
        with span("model.forward", b):
            return self._forward(images_0, images_1)

    def _forward(self, images_0, images_1):
        dtype = self.fnet.conv1.weight.dtype
        with span("model.encode"):
            frames = to_nchw((2 * torch.cat([images_0, images_1]) - 1).to(dtype))
            fmap0, fmap1 = self.fnet(frames).float().chunk(2)
            net, inp = self.cnet(frames[:images_0.shape[0]]).split([self.hidden_dim, self.context_dim], 1)
            buffers = self.buffers_type(torch.tanh(net), torch.relu(inp), self.update_block)
        self._attend(buffers)
        with span("model.corr"):
            pyramid = corr_pyramid(fmap0, fmap1, self.corr_levels)
        b, _, h, w = fmap0.shape
        ys, xs = torch.meshgrid(torch.arange(h, device=fmap0.device), torch.arange(w, device=fmap0.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], -1).float().expand(b, h, w, 2)
        coords1 = coords0.contiguous()  # updated in place
        for _ in range(self.iters):
            with span("model.lookup"):
                corr = lookup(pyramid, coords1, self.corr_radius)
            with span("model.update"):
                self.update_block(buffers, corr.to(dtype), coords1)
        with span("model.upsample"):
            flow = coords1 - coords0
            return convex_upsample(flow, 0.25 * self.update_block.mask(buffers.net)), flow

    def _attend(self, s: UpdateBuffers) -> None:
        """What a model computes from the context features ``s.inp`` once a
        forward, before the updates, into ``s``: nothing in RAFT (GMA: the
        attention)."""
