"""GMA (Jiang, Campbell, Lu, Li, Hartley, "Learning to Estimate Hidden
Motions with Global Motion Aggregation", ICCV 2021, arXiv:2104.02409) in
PyTorch: the main model of zacjiang/GMA (``core/network.py`` ``RAFTGMA``,
``core/gma.py``, ``core/update.py``) as its published checkpoints run it:
one head of 128 channels, attention by content only (``position_only`` and
``position_and_content`` off).

GMA is `RAFT` with two additions, and shares the rest of it (encoders,
correlation pyramid and lookup, motion encoder, GRU, flow and mask heads,
the update's epilogues and buffers, the loop and the convex upsample):

- ``att``, once a forward: ``q, k = chunk(to_qk(inp), 2)`` (``to_qk`` a 1x1
  conv 128 -> 256 without a bias, q first) on the context features ``inp
  = relu(cnet[128:])``, and ``attention = softmax(q k^T / sqrt(128))`` over
  all N pixels of the 1/8 grid (`ops.attention.global_softmax`), (B, N, N).
- ``update_block.aggregator``, in each update after the motion encoder:
  ``mf_global = mf + gamma (attention to_v(mf))``, ``mf`` the motion
  features ``[motion | flow]`` (128), ``to_v`` a 1x1 conv 128 -> 128
  without a bias, ``gamma`` a (1,) parameter (`ops.attention.aggregate`,
  then `ops.raft_update.aggregate_epilogue` into the global slots of the
  update's buffers, `GMABuffers`). The GRU reads ``[h | inp | motion | flow
  | global]``, 512 channels a conv.

Module and parameter names are ``RAFTGMA``'s (``att.to_qk``, ``att.pos_emb.
rel_height``, ``update_block.aggregator.to_v``, ``update_block.aggregator.
gamma``, ``update_block.gru.convz1``, ...), so a published state dict
(``gma-sintel.pth``) loads without its ``module.`` prefix. ``att.pos_emb``
(``RelPosEmb(160, 128)``: two 319 x 128 tables and the index buffer) is
built as GMA builds it and read by nothing: the content-only model adds no
position term.

Frames, output and precision are `RAFT`'s; H and W must be multiples of 8.
In the model's dtype: ``to_qk``, ``to_v`` and their operands, and the
probabilities (each rounded once; GMA's own mixed precision rounds them to
fp16 before its einsum). In float32: the scores q k^T (bf16 products summed
in float32), their scale ``1 / sqrt(128)`` (applied to the float32 scores,
not to q, as GMA does: the two differ by float32 rounding), the softmax
over each row of N keys, the aggregation's sums, and ``mf + gamma out``
(rounded once into the global slots). The softmax is computed in blocks of
rows, so no float32 (B, N, N) tensor is ever whole. On the card GMA serves
in bf16: its two attention products take bf16 operands only.

Departures, none of which changes the result: GMA computes the mask head at
every update and upsamples each flow; here, as in `RAFT`, both run once
after the last update. ``to_v`` runs as a matrix product on the slot of
the buffer that holds ``mf`` (the same 1x1 conv).

Spans (``utils.profiling``): `RAFT`'s, with ``model.attend`` (``to_qk``,
the scores and the softmax) once a forward after ``model.encode``, and
``model.aggregate`` (``to_v``, the product and the epilogue) inside each
``model.update``.
"""

from __future__ import annotations

import torch
from torch import nn

from pwcnet_tpu_torch.models.conv import Conv2d, cast_params, to_nhwc
from pwcnet_tpu_torch.models.raft import RAFT, BasicUpdateBlock, SepConvGRU, UpdateBuffers
from pwcnet_tpu_torch.ops.attention import aggregate, global_softmax
from pwcnet_tpu_torch.ops.raft_update import aggregate_epilogue
from pwcnet_tpu_torch.utils.profiling import span

__all__ = ["GMA", "Attention", "Aggregate", "GMABuffers", "GMAUpdateBlock", "RelPosEmb"]


class RelPosEmb(nn.Module):
    """GMA's relative position tables: ``rel_height`` and ``rel_width``
    (``2 max_pos_size - 1`` x ``dim_head``) and ``rel_ind``, each position's
    offset into them. The content-only model reads none of them."""

    def __init__(self, max_pos_size: int, dim_head: int):
        super().__init__()
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)
        deltas = torch.arange(max_pos_size).view(1, -1) - torch.arange(max_pos_size).view(-1, 1)
        self.register_buffer("rel_ind", deltas + max_pos_size - 1)


class Attention(nn.Module):
    """``softmax(q k^T / sqrt(dim_head))`` of ``q, k = chunk(to_qk(x), 2)``
    over every pixel: one head."""

    def __init__(self, dim: int = 128, max_pos_size: int = 160, dim_head: int = 128):
        super().__init__()
        self.to_qk = Conv2d(dim, 2 * dim_head, 1, bias=False)
        self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (B, dim, h, w) -> (B, h w, h w) probabilities in the model's dtype."""
        b, _, h, w = x.shape
        qk = to_nhwc(self.to_qk(x.contiguous(memory_format=torch.channels_last))).view(b, h * w, -1)
        q, k = qk.chunk(2, dim=-1)
        return global_softmax(q.contiguous(), k.contiguous())


class GMABuffers(UpdateBuffers):
    """`UpdateBuffers` whose ``a`` and ``q`` end in the global slot
    (``[... | flow | global]``, the block's ``global_width``): ``globals``
    its two views, and ``attention``, the forward's attention, set by the
    model from ``inp``."""

    def __init__(self, net: torch.Tensor, inp: torch.Tensor, block: "GMAUpdateBlock"):
        super().__init__(net, inp, block)
        self.globals = (self.a[:, -block.global_width:], self.q[:, -block.global_width:])
        self.attention = None


class Aggregate(nn.Module):
    """``mf + gamma (attention to_v(mf))``: one head of ``dim`` channels, so
    no ``project`` (GMA builds one only where the heads' width differs)."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.to_v = Conv2d(dim, dim, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, s: GMABuffers) -> None:
        """The global motion features into ``s.globals`` from ``s.mf`` and
        ``s.attention``."""
        mf = s.mf
        b, c, h, w = mf.shape
        weight = cast_params(self.to_v)[0].reshape(c, c)
        v = torch.mm(mf.permute(0, 2, 3, 1).reshape(b * h * w, c), weight.t()).view(b, h * w, c)
        aggregate_epilogue(mf, aggregate(s.attention, v), self.gamma, *s.globals)


class GMAUpdateBlock(BasicUpdateBlock):
    """RAFT's block with the aggregator between the motion encoder and the
    GRU, whose input widens by the global motion features."""

    global_width = 128

    def __init__(self, corr_planes: int, hidden: int):
        super().__init__(corr_planes, hidden)
        self.gru = SepConvGRU(hidden, 128 + hidden + self.global_width)
        self.aggregator = Aggregate(self.global_width)

    def forward(self, s: GMABuffers, corr: torch.Tensor, coords: torch.Tensor) -> None:
        self.encoder(corr, s)
        with span("model.aggregate"):
            self.aggregator(s)
        self.gru(s)
        self.flow_head(s, coords)


class GMA(RAFT):
    """GMA at its published widths: RAFT's (hidden and context 128, features
    256, 4 levels of radius 4), one attention head of 128, ``iters`` updates
    a forward (32, as the RAFT cell; ``make_forward`` passes only the
    frames)."""

    update_block_type = GMAUpdateBlock
    buffers_type = GMABuffers
    max_pos_size = 160

    def __init__(self, iters: int = 32):
        super().__init__(iters)
        self.att = Attention(self.context_dim, self.max_pos_size, self.context_dim)
        self.att.to(memory_format=torch.channels_last)

    def _attend(self, s: GMABuffers) -> None:
        with span("model.attend"):
            s.attention = self.att(s.inp)
