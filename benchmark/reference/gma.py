"""A plain float32 PyTorch reference of GMA (Jiang, Campbell, Lu, Li,
Hartley, ICCV 2021, arXiv:2104.02409), written as zacjiang/GMA
``core/network.py`` (``RAFTGMA``), ``core/gma.py`` (``Attention``,
``Aggregate``, ``RelPosEmb``) and ``core/update.py`` (``GMAUpdateBlock``)
compute it, in its main setting: one head of 128 channels, attention by
content only. NCHW tensors, the whole (B, 1, N, N) score tensor by
``einsum``, ``softmax(dim=-1)``, the aggregation by ``einsum``, the GRU's
input by ``cat``. RAFT's parts (encoders, ``CorrBlock``, motion encoder,
GRU, flow head, upsample) are ``reference/raft.py``'s. It imports nothing
of the measured program; the benchmark gives both sides the same weights
and frames.

Departures, none of which changes the result: RAFT's (``reference/raft.py``:
NHWC frames in [0, 1], the mask head and the upsample once, after the last
update, ``(flow, flow_low)`` returned); ``RelPosEmb`` is built, as GMA
builds it, and not read (content only).

``precision`` (None, ``'bf16'``, ``'fp8'``, ``'tf32'``) rounds every
conv's operands as ``reference/model.py`` describes, and the operands of
both attention products: q and k (after ``to_qk``, before the scale), then
the probabilities (once a forward) and v (each update). The scores, the
softmax, the sums, ``mf + gamma out``, the correlation, the lookup and the
upsample stay float32, with TF32 off for the forward (the caller's
settings restored after). `attention_softmax` is the softmax over the
keys; the benchmark's fault readings replace it.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from benchmark.reference import raft
from benchmark.reference.model import conv, round_to

__all__ = ["RAFTGMA", "build", "attention_softmax"]


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the reference's float32 products and convs, the
    caller's settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def attention_softmax(sim: torch.Tensor) -> torch.Tensor:
    """GMA's ``sim.softmax(dim=-1)``: over the keys."""
    return sim.softmax(dim=-1)


class RelPosEmb(nn.Module):
    def __init__(self, max_pos_size, dim_head):
        super().__init__()
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)
        deltas = torch.arange(max_pos_size).view(1, -1) - torch.arange(max_pos_size).view(-1, 1)
        self.register_buffer("rel_ind", deltas + max_pos_size - 1)


class Attention(nn.Module):
    def __init__(self, dim, max_pos_size=100, heads=4, dim_head=128):
        super().__init__()
        self.heads, self.scale = heads, dim_head**-0.5
        self.to_qk = nn.Conv2d(dim, heads * dim_head * 2, 1, bias=False)
        self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def forward(self, fmap, precision=None):
        heads, (b, _, h, w) = self.heads, fmap.shape
        q, k = (round_to(t, precision) for t in conv(self.to_qk, fmap, precision).chunk(2, dim=1))
        q, k = (t.reshape(b, heads, -1, h, w).permute(0, 1, 3, 4, 2) for t in (q, k))  # b h x y d
        q = self.scale * q
        sim = torch.einsum("bhxyd,bhuvd->bhxyuv", q, k).reshape(b, heads, h * w, h * w)
        return attention_softmax(sim)


class Aggregate(nn.Module):
    def __init__(self, dim, heads=4, dim_head=128):
        super().__init__()
        self.heads = heads
        self.to_v = nn.Conv2d(dim, heads * dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = None if dim == heads * dim_head else nn.Conv2d(heads * dim_head, dim, 1, bias=False)

    def forward(self, attn, fmap, precision=None):
        heads, (b, _, h, w) = self.heads, fmap.shape
        v = round_to(conv(self.to_v, fmap, precision), precision)
        v = v.reshape(b, heads, -1, h * w).transpose(-1, -2)  # b h (x y) d
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        out = out.transpose(-1, -2).reshape(b, -1, h, w)
        if self.project is not None:
            out = conv(self.project, out, precision)
        return fmap + self.gamma * out


class GMAUpdateBlock(raft.BasicUpdateBlock):
    def __init__(self, cor_planes, hidden_dim=128, heads=1):
        super().__init__(cor_planes, hidden_dim)
        self.gru = raft.SepConvGRU(hidden_dim=hidden_dim, input_dim=128 + hidden_dim + hidden_dim)
        self.aggregator = Aggregate(dim=128, dim_head=128, heads=heads)

    def forward(self, net, inp, corr, flow, attention, precision=None):
        motion_features = self.encoder(flow, corr, precision)
        motion_features_global = self.aggregator(attention, motion_features, precision)
        inp_cat = torch.cat([inp, motion_features, motion_features_global], dim=1)
        net = self.gru(net, inp_cat, precision)
        return net, self.flow_head(net, precision)


class RAFTGMA(nn.Module):
    """GMA: RAFT's widths (hidden and context 128, features 256, 4 levels of
    radius 4), ``num_heads`` heads of ``context_dim`` channels, ``iters``
    updates."""

    def __init__(self, iters=32, hidden_dim=128, context_dim=128, feature_dim=256, corr_levels=4, corr_radius=4,
                 num_heads=1, max_pos_size=160, **_):
        super().__init__()
        self.iters, self.hidden_dim, self.context_dim = iters, hidden_dim, context_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = raft.BasicEncoder(output_dim=feature_dim, norm_fn="instance")
        self.cnet = raft.BasicEncoder(output_dim=hidden_dim + context_dim, norm_fn="batch")
        self.update_block = GMAUpdateBlock(corr_levels * (2 * corr_radius + 1) ** 2, hidden_dim, num_heads)
        self.att = Attention(dim=context_dim, heads=num_heads, max_pos_size=max_pos_size, dim_head=context_dim)

    def forward(self, images_0, images_1, precision=None):
        with _no_tf32():
            return self._forward(images_0, images_1, precision)

    def _forward(self, images_0, images_1, precision):
        image1 = 2 * images_0.permute(0, 3, 1, 2) - 1.0
        image2 = 2 * images_1.permute(0, 3, 1, 2) - 1.0
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2], dim=0), precision).split(image1.shape[0])
        corr_fn = raft.CorrBlock(fmap1.float(), fmap2.float(), self.corr_levels, self.corr_radius)
        net, inp = torch.split(self.cnet(image1, precision), [self.hidden_dim, self.context_dim], dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)
        attention = round_to(self.att(inp, precision), precision)
        n, _, h, w = image1.shape
        coords0 = raft.coords_grid(n, h // 8, w // 8, image1.device)
        coords1 = raft.coords_grid(n, h // 8, w // 8, image1.device)
        for _ in range(self.iters):
            corr = corr_fn(coords1)
            net, delta_flow = self.update_block(net, inp, corr, coords1 - coords0, attention, precision)
            coords1 = coords1 + delta_flow
        flow_up = raft.upsample_flow(coords1 - coords0, self.update_block.upsampling_mask(net, precision))
        return flow_up.permute(0, 2, 3, 1), (coords1 - coords0).permute(0, 2, 3, 1)


def build(config: dict, device=None) -> nn.Module:
    """The reference GMA of a benchmark configuration, float32, in eval mode."""
    keys = ("iters", "hidden_dim", "context_dim", "feature_dim", "corr_levels", "corr_radius", "num_heads",
            "max_pos_size")
    return RAFTGMA(**{k: config[k] for k in keys}).to(device=device, dtype=torch.float32).eval()
