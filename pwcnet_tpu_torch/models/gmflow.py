"""GMFlow (Xu, Zhang, Cai, Rezatofighi, Tao, "GMFlow: Learning Optical
Flow via Global Matching", CVPR 2022, arXiv:2111.13680) in PyTorch: the
base model of haofeixu/gmflow (``gmflow/gmflow.py``, ``backbone.py``,
``transformer.py``, ``matching.py``, ``position.py``, ``utils.py``) at its
Sintel setting, one scale, without refinement.

- Frames normalised by ImageNet's mean and std; both through the encoder
  as one 2B batch: RAFT's `BasicEncoder` with instance norm and output 128,
  its 7x7 and 3x3 convs without a bias (GMFlow's ``CNNEncoder``), to
  features at 1/8 resolution.
- Positions: DETR's normalised sine embedding of one of the ``attn_splits
  x attn_splits`` windows, added to every window of both frames.
- `FeatureTransformer`: 6 blocks of a self-attention layer and a
  cross-attention layer with a GELU FFN, on ``[f0; f1]`` against ``[f1;
  f0]``; single-head attention inside the windows (`ops.attention.
  window_attention`), every second block's windows shifted by half a
  window with GMFlow's -100 mask.
- Global matching: ``softmax(f0 f1^T / sqrt(128))`` over all of frame 1's
  pixels, the expected pixel grid less the grid (`ops.attention.
  global_attention`).
- Propagation (``FeatureFlowAttention``): ``softmax(q k^T / sqrt(128))
  flow`` over the whole frame, ``q = q_proj(f0)``, ``k = k_proj(q)`` (the
  key projects the projected query, as the published code does).
- The upsampler's mask (conv 130 -> 256, ReLU, conv 256 -> 576 on ``[flow,
  f0]``) and RAFT's convex upsample of ``8 flow`` (no 0.25 on the mask).

Module and parameter names are GMFlow's (``backbone.layer2.0.
downsample.0``, ``transformer.layers.3.cross_attn_ffn.mlp.0``,
``feature_flow_attn.k_proj``, ``upsampler.2``), so a published state dict
loads.

Frames are NHWC in [0, 1] (GMFlow: [0, 255], divided by 255 before the
normalisation); H and W must be multiples of 16 (GMFlow's padding factor;
padding is the caller's). ``forward`` returns ``(flow (B, H, W, 2),
flow_low (B, H/8, W/8, 2))``, float32, in pixels of their own resolution.

Precision: the model computes in its parameters' dtype (``model.to(
torch.bfloat16)`` serves in bf16): every conv, Linear and attention
operand in that dtype. Float32: the norms' statistics (instance norm and
LayerNorm), every softmax's scores and sums, the matching's coordinates
and the propagation's flow (value and output of `global_attention`, never
rounded), the flow and the upsample's softmax and weighted sum; and the
transformer's residual stream (the positions' sum, each LayerNorm's
output, each layer's ``source + message``), as ``torch.autocast`` keeps
it: each Linear rounds its input to the model's dtype, and the features
leave the transformer rounded once. On the card the global matching and
propagation run R4, which takes bf16 q and k only: GMFlow serves there in
bf16.

Departures, none of which changes the result: features are NHWC tokens
(GMFlow permutes NCHW to (B, HW, C) and back); the sine embedding of a
window is computed once and tiled, where GMFlow computes it on the split
features; the matching and the propagation never write their 7168 x 7168
scores out on CUDA tensors; the shifted mask is built once a forward, as
GMFlow's ``FeatureTransformer`` does.

Spans (``utils.profiling``): ``model.forward`` (B pairs) with
``model.encode`` (normalisation and encoder), ``model.transformer``
(positions and the 6 blocks), ``model.match``, ``model.propagate`` and
``model.upsample``, each once a forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pwcnet_tpu_torch.models.conv import Conv2d, to_nchw
from pwcnet_tpu_torch.models.raft import BasicEncoder, convex_upsample
from pwcnet_tpu_torch.ops.attention import global_attention, shift_window_mask, window_attention
from pwcnet_tpu_torch.utils.profiling import span

__all__ = ["GMFlow", "TransformerLayer", "FeatureFlowAttention", "sine_positions", "add_window_positions", "coords_grid"]

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BLOCKS = 6  # transformer blocks
FFN_EXPANSION = 4  # the FFN's hidden width over its input's (2C)


def sine_positions(h: int, w: int, channels: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding of an (h, w) grid, as GMFlow's
    ``PositionEmbeddingSine(channels // 2)`` computes it: (h, w, channels)
    float32, y's channels first, each ``sin, cos`` interleaved; rows and
    columns counted from 1 and divided by the last (plus 1e-6), times 2 pi;
    temperature 10000."""
    feats = channels // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + 1e-6) * (2 * math.pi)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + 1e-6) * (2 * math.pi)
    dim_t = 10000 ** (2 * (torch.arange(feats, dtype=torch.float32, device=device) // 2) / feats)

    def embed(v):  # (n,) -> (n, feats)
        p = v[:, None] / dim_t
        return torch.stack((p[:, 0::2].sin(), p[:, 1::2].cos()), dim=2).flatten(1)

    return torch.cat([embed(y)[:, None].expand(h, w, feats), embed(x)[None].expand(h, w, feats)], dim=2)


def add_window_positions(features: torch.Tensor, splits: int) -> torch.Tensor:
    """``features`` (B, H, W, C) plus `sine_positions` of one of its
    ``splits x splits`` windows in every window (GMFlow's
    ``feature_add_position``), in float32."""
    b, h, w, c = features.shape
    pos = sine_positions(h // splits, w // splits, c, features.device)
    windows = features.view(b, splits, h // splits, splits, w // splits, c)
    return (windows + pos[None, None, :, None]).view(b, h, w, c)


def coords_grid(h: int, w: int, device) -> torch.Tensor:
    """(h w, 2) float32: each pixel's (x, y), row-major."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys], -1).float().view(h * w, 2)


class TransformerLayer(nn.Module):
    """GMFlow's ``TransformerLayer``: bias-free q, k, v projections of the
    source, the target and the target; window attention (shifted with the
    mask); ``merge`` and ``norm1``; with ``ffn``, ``mlp`` (Linear 2C -> 8C,
    exact GELU, Linear 8C -> C, bias-free) on ``[source, message]`` and
    ``norm2``; ``source + message``. The source, the target, the norms'
    outputs and the sum are float32; each Linear's input is rounded to the
    weights' dtype."""

    def __init__(self, d_model: int, ffn: bool):
        super().__init__()
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model)
        self.mlp = None
        if ffn:
            wide = 2 * d_model * FFN_EXPANSION
            self.mlp = nn.Sequential(nn.Linear(2 * d_model, wide, bias=False), nn.GELU(),
                                     nn.Linear(wide, d_model, bias=False))
            self.norm2 = nn.LayerNorm(d_model)

    def forward(self, source: torch.Tensor, target: torch.Tensor, splits: int, mask) -> torch.Tensor:
        """``source``, ``target`` (B, H, W, C) float32 -> (B, H, W, C) float32."""
        dtype = self.q_proj.weight.dtype
        x = source.to(dtype)
        y = x if target is source else target.to(dtype)
        message = window_attention(self.q_proj(x), self.k_proj(y), self.v_proj(y), splits, mask)
        message = _layer_norm(self.norm1, self.merge(message))
        if self.mlp is not None:
            message = _layer_norm(self.norm2, self.mlp(torch.cat([source, message], dim=-1).to(dtype)))
        return source + message


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` of ``x`` in float32: statistics, scale and shift."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)


class TransformerBlock(nn.Module):
    """Self-attention (no FFN), then cross-attention with the FFN; every
    second block's windows shifted (``with_shift``)."""

    def __init__(self, d_model: int, with_shift: bool):
        super().__init__()
        self.with_shift = with_shift
        self.self_attn = TransformerLayer(d_model, ffn=False)
        self.cross_attn_ffn = TransformerLayer(d_model, ffn=True)

    def forward(self, source, target, splits, mask):
        mask = mask if self.with_shift else None
        return self.cross_attn_ffn(self.self_attn(source, source, splits, mask), target, splits, mask)


class FeatureTransformer(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.layers = nn.ModuleList([TransformerBlock(d_model, with_shift=i % 2 == 1) for i in range(BLOCKS)])

    def forward(self, features: torch.Tensor, splits: int) -> torch.Tensor:
        """``features`` (2B, H, W, C) float32, ``[f0; f1]`` -> the same
        after the blocks, each block's target ``[f1; f0]``."""
        _, h, w, _ = features.shape
        dtype = self.layers[0].self_attn.q_proj.weight.dtype
        mask = shift_window_mask(h, w, splits, features.device, dtype) if splits > 1 else None  # one window: no shift
        for layer in self.layers:
            features = layer(features, torch.cat(features.chunk(2)[::-1]), splits, mask)
        return features


class FeatureFlowAttention(nn.Module):
    """GMFlow's global propagation: ``softmax(q k^T / sqrt(C)) flow``, ``q
    = q_proj(f0)``, ``k = k_proj(q)``; both Linears with a bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.q_proj = nn.Linear(channels, channels)
        self.k_proj = nn.Linear(channels, channels)

    def forward(self, feature0: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """``feature0`` (B, N, C), ``flow`` (B, N, 2) float32 -> (B, N, 2) float32."""
        query = self.q_proj(feature0)
        return global_attention(query, self.k_proj(query), flow)


class GMFlow(nn.Module):
    """GMFlow's base model: 128 channels, 6 blocks of one head and an FFN
    expansion of 4, windows ``attn_splits x attn_splits`` (2, the Sintel
    setting), global matching and propagation, upsample factor 8."""

    feature_channels = 128
    upsample_factor = 8

    def __init__(self, attn_splits: int = 2):
        super().__init__()
        self.attn_splits = attn_splits
        c, f = self.feature_channels, self.upsample_factor
        self.backbone = BasicEncoder(c, "instance", bias=False)
        self.transformer = FeatureTransformer(c)
        self.feature_flow_attn = FeatureFlowAttention(c)
        self.upsampler = nn.Sequential(Conv2d(2 + c, 256, 3, padding=1), nn.ReLU(), Conv2d(256, f * f * 9, 1))
        self.to(memory_format=torch.channels_last)  # conv weights in their inputs' memory format
        self._normalisers: dict = {}  # device -> (mean, std), outside the state dict and the dtype casts

    def _mean_std(self, device) -> tuple:
        """ImageNet's mean and std on ``device``, float32, made once a
        device: a tensor made from host values is a copy that waits for the
        card's queue to drain."""
        if device not in self._normalisers:
            self._normalisers[device] = tuple(torch.tensor(v, device=device) for v in (MEAN, STD))
        return self._normalisers[device]

    def forward(self, images_0: torch.Tensor, images_1: torch.Tensor):
        """``images_*`` (B, H, W, 3) in [0, 1] -> ``(flow (B, H, W, 2),
        flow_low (B, H/8, W/8, 2))``, float32."""
        b, h, w, _ = images_0.shape
        if h % 16 or w % 16:
            raise ValueError(f"GMFlow needs H and W multiples of 16 (pad the frames first), got {h}x{w}")
        with span("model.forward", b):
            return self._forward(images_0, images_1)

    def _forward(self, images_0, images_1):
        dtype = self.backbone.conv1.weight.dtype
        b, splits = images_0.shape[0], self.attn_splits
        with span("model.encode"):
            frames = torch.cat([images_0, images_1])
            mean, std = self._mean_std(frames.device)
            features = self.backbone(to_nchw(((frames - mean) / std).to(dtype))).permute(0, 2, 3, 1)
        _, h, w, c = features.shape
        with span("model.transformer"):
            features = add_window_positions(features, splits)
            feature0, feature1 = self.transformer(features, splits).to(dtype).chunk(2)
        feature0 = feature0.reshape(b, h * w, c)
        with span("model.match"):
            grid = coords_grid(h, w, features.device)
            flow = global_attention(feature0, feature1.reshape(b, h * w, c), grid.expand(b, h * w, 2)) - grid
        with span("model.propagate"):
            flow = self.feature_flow_attn(feature0, flow).view(b, h, w, 2)
        with span("model.upsample"):
            mask = self.upsampler(to_nchw(torch.cat([flow.to(dtype), feature0.view(b, h, w, c)], dim=-1)))
            return convex_upsample(flow, mask), flow
