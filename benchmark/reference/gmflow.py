"""A plain float32 PyTorch reference of GMFlow (Xu et al., CVPR 2022,
arXiv:2111.13680), written as haofeixu/gmflow ``gmflow/gmflow.py``,
``backbone.py``, ``transformer.py``, ``matching.py``, ``position.py``,
``utils.py`` and ``geometry.py`` compute it: NCHW tensors,
``nn.InstanceNorm2d``, ``nn.LayerNorm``, ``torch.matmul`` with the whole
score tensors written out, ``split_feature`` / ``merge_splits``,
``torch.roll`` and the -100 mask of ``generate_shift_window_attn_mask``.
It imports nothing of the measured program; the benchmark gives both
sides the same weights (``harness.draw_weights`` on this module's names,
which the served model shares) and frames.

The base model at the Sintel setting: 128 channels, 6 blocks of one head
and an FFN expansion of 4, ``attn_splits`` 2, global matching and
propagation (radius -1), one scale, upsample factor 8.

Departures, none of which changes the result: frames come NHWC in [0, 1]
(GMFlow: [0, 255], divided by 255 before ImageNet's normalisation); the
forward returns ``(flow (B, H, W, 2), flow_low (B, H/8, W/8, 2))``, NHWC:
the final upsampled flow of GMFlow's ``flow_preds`` and the propagated
flow it was upsampled from.

``precision`` rounds as ``model.py`` describes (None, ``'bf16'``,
``'fp8'``, ``'tf32'``) every operand of a conv, a Linear and an attention:
each conv's and Linear's input and weight, the feature attention's q, k, v
and its probabilities, the global matching's and the propagation's q and
k; and every tensor a model served in that precision holds in it: each
conv's and Linear's output, each instance norm's output and each
residual sum of the encoder. The matching's coordinates, the
propagation's flow, the transformer's residual stream and LayerNorms,
every softmax and the upsample stay float32, as the served model keeps
them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.model import conv, round_to

__all__ = ["GMFlow", "build", "generate_shift_window_attn_mask", "split_feature", "merge_splits",
           "PositionEmbeddingSine", "feature_add_position"]


def linear(module: nn.Linear, x: torch.Tensor, precision=None) -> torch.Tensor:
    out = F.linear(round_to(x, precision), round_to(module.weight, precision), module.bias)
    return round_to(out, precision)


def held(module: nn.Module, x: torch.Tensor, precision=None) -> torch.Tensor:
    """``module`` of ``x``, a conv's operands and every output rounded to ``precision``."""
    if isinstance(module, nn.Conv2d):
        return round_to(conv(module, x, precision), precision)
    return round_to(module(x), precision)


# ------------------------------------------------------------------ backbone.py
class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, kernel_size=3, padding=1, stride=stride, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size=3, padding=1, bias=False)
        self.norm1, self.norm2 = nn.InstanceNorm2d(planes), nn.InstanceNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm3 = nn.InstanceNorm2d(planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, kernel_size=1, stride=stride), self.norm3)

    def forward(self, x, precision=None):
        y = F.relu(held(self.norm1, held(self.conv1, x, precision), precision))
        y = F.relu(held(self.norm2, held(self.conv2, y, precision), precision))
        if self.downsample is not None:
            x = held(self.norm3, held(self.downsample[0], x, precision), precision)
        return F.relu(round_to(x + y, precision))


class CNNEncoder(nn.Module):
    def __init__(self, output_dim=128):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, kernel_size=7, stride=2, padding=3, bias=False)
        self.norm1 = nn.InstanceNorm2d(64)
        planes = 64
        for i, (dim, stride) in enumerate(((64, 1), (96, 2), (128, 2))):
            self.add_module(f"layer{i + 1}", nn.Sequential(ResidualBlock(planes, dim, stride), ResidualBlock(dim, dim)))
            planes = dim
        self.conv2 = nn.Conv2d(128, output_dim, 1, 1, 0)

    def forward(self, x, precision=None):
        x = F.relu(held(self.norm1, held(self.conv1, x, precision), precision))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, precision)
        return held(self.conv2, x, precision)


# ------------------------------------------------------------------ utils.py, position.py
def split_feature(feature, num_splits=2, channel_last=False):
    if channel_last:  # [B, H, W, C]
        b, h, w, c = feature.size()
        feature = feature.view(b, num_splits, h // num_splits, num_splits, w // num_splits, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b * num_splits * num_splits, h // num_splits, w // num_splits, c)
    else:  # [B, C, H, W]
        b, c, h, w = feature.size()
        feature = feature.view(b, c, num_splits, h // num_splits, num_splits, w // num_splits).permute(
            0, 2, 4, 1, 3, 5).reshape(b * num_splits * num_splits, c, h // num_splits, w // num_splits)
    return feature


def merge_splits(splits, num_splits=2, channel_last=False):
    if channel_last:  # [B*K*K, H/K, W/K, C]
        b, h, w, c = splits.size()
        splits = splits.view(b // num_splits // num_splits, num_splits, num_splits, h, w, c)
        return splits.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, num_splits * h, num_splits * w, c)
    b, c, h, w = splits.size()
    splits = splits.view(b // num_splits // num_splits, num_splits, num_splits, c, h, w)
    return splits.permute(0, 3, 1, 4, 2, 5).contiguous().view(-1, c, num_splits * h, num_splits * w)


class PositionEmbeddingSine(nn.Module):
    def __init__(self, num_pos_feats=64, temperature=10000, normalize=True, scale=None):
        super().__init__()
        self.num_pos_feats, self.temperature, self.normalize = num_pos_feats, temperature, normalize
        self.scale = 2 * math.pi if scale is None else scale

    def forward(self, x):
        b, c, h, w = x.size()
        mask = torch.ones((b, h, w), device=x.device)
        y_embed = mask.cumsum(1, dtype=torch.float32)
        x_embed = mask.cumsum(2, dtype=torch.float32)
        if self.normalize:
            eps = 1e-6
            y_embed = y_embed / (y_embed[:, -1:, :] + eps) * self.scale
            x_embed = x_embed / (x_embed[:, :, -1:] + eps) * self.scale
        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32, device=x.device)
        dim_t = self.temperature ** (2 * (dim_t // 2) / self.num_pos_feats)
        pos_x = x_embed[:, :, :, None] / dim_t
        pos_y = y_embed[:, :, :, None] / dim_t
        pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
        pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(), pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
        return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def feature_add_position(feature0, feature1, attn_splits, feature_channels):
    pos_enc = PositionEmbeddingSine(num_pos_feats=feature_channels // 2)
    if attn_splits > 1:  # add position in splited window
        feature0_splits = split_feature(feature0, num_splits=attn_splits)
        feature1_splits = split_feature(feature1, num_splits=attn_splits)
        position = pos_enc(feature0_splits)
        feature0 = merge_splits(feature0_splits + position, num_splits=attn_splits)
        feature1 = merge_splits(feature1_splits + position, num_splits=attn_splits)
    else:
        position = pos_enc(feature0)
        feature0, feature1 = feature0 + position, feature1 + position
    return feature0, feature1


# ------------------------------------------------------------------ transformer.py
def single_head_full_attention(q, k, v):
    scores = torch.matmul(q, k.permute(0, 2, 1)) / (q.size(2) ** .5)
    return torch.matmul(torch.softmax(scores, dim=2), v)


def generate_shift_window_attn_mask(input_resolution, window_size_h, window_size_w, shift_size_h, shift_size_w,
                                    device=None):
    h, w = input_resolution
    img_mask = torch.zeros((1, h, w, 1), device=device)
    h_slices = (slice(0, -window_size_h), slice(-window_size_h, -shift_size_h), slice(-shift_size_h, None))
    w_slices = (slice(0, -window_size_w), slice(-window_size_w, -shift_size_w), slice(-shift_size_w, None))
    cnt = 0
    for hs in h_slices:
        for ws in w_slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask_windows = split_feature(img_mask, num_splits=input_resolution[-1] // window_size_w, channel_last=True)
    mask_windows = mask_windows.view(-1, window_size_h * window_size_w)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0, float(0.0))


def single_head_split_window_attention(q, k, v, num_splits=1, with_shift=False, h=None, w=None, attn_mask=None,
                                       precision=None):
    b, _, c = q.size()
    b_new = b * num_splits * num_splits
    window_size_h, window_size_w = h // num_splits, w // num_splits
    q, k, v = (round_to(t, precision).view(b, h, w, c) for t in (q, k, v))
    scale_factor = c ** 0.5
    if with_shift:
        shift_size_h, shift_size_w = window_size_h // 2, window_size_w // 2
        q = torch.roll(q, shifts=(-shift_size_h, -shift_size_w), dims=(1, 2))
        k = torch.roll(k, shifts=(-shift_size_h, -shift_size_w), dims=(1, 2))
        v = torch.roll(v, shifts=(-shift_size_h, -shift_size_w), dims=(1, 2))
    q = split_feature(q, num_splits=num_splits, channel_last=True)
    k = split_feature(k, num_splits=num_splits, channel_last=True)
    v = split_feature(v, num_splits=num_splits, channel_last=True)
    scores = torch.matmul(q.view(b_new, -1, c), k.view(b_new, -1, c).permute(0, 2, 1)) / scale_factor
    if with_shift:
        scores += attn_mask.repeat(b, 1, 1)
    attn = round_to(torch.softmax(scores, dim=-1), precision)
    out = torch.matmul(attn, v.view(b_new, -1, c))
    out = merge_splits(out.view(b_new, h // num_splits, w // num_splits, c), num_splits=num_splits, channel_last=True)
    if with_shift:
        out = torch.roll(out, shifts=(shift_size_h, shift_size_w), dims=(1, 2))
    return out.view(b, -1, c)


class TransformerLayer(nn.Module):
    def __init__(self, d_model=128, no_ffn=False, ffn_dim_expansion=4, with_shift=False):
        super().__init__()
        self.no_ffn, self.with_shift = no_ffn, with_shift
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model)
        if not no_ffn:
            in_channels = d_model * 2
            self.mlp = nn.Sequential(nn.Linear(in_channels, in_channels * ffn_dim_expansion, bias=False), nn.GELU(),
                                     nn.Linear(in_channels * ffn_dim_expansion, d_model, bias=False))
            self.norm2 = nn.LayerNorm(d_model)

    def forward(self, source, target, height, width, shifted_window_attn_mask, attn_num_splits, precision=None):
        query = linear(self.q_proj, source, precision)
        key = linear(self.k_proj, target, precision)
        value = linear(self.v_proj, target, precision)
        if attn_num_splits > 1:
            message = single_head_split_window_attention(query, key, value, num_splits=attn_num_splits,
                                                         with_shift=self.with_shift, h=height, w=width,
                                                         attn_mask=shifted_window_attn_mask, precision=precision)
        else:
            message = single_head_full_attention(*(round_to(t, precision) for t in (query, key, value)))
        message = self.norm1(linear(self.merge, message, precision))
        if not self.no_ffn:
            hidden = F.gelu(linear(self.mlp[0], torch.cat([source, message], dim=-1), precision))
            message = self.norm2(linear(self.mlp[2], hidden, precision))
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, d_model=128, ffn_dim_expansion=4, with_shift=False):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, no_ffn=True, ffn_dim_expansion=ffn_dim_expansion,
                                          with_shift=with_shift)
        self.cross_attn_ffn = TransformerLayer(d_model, ffn_dim_expansion=ffn_dim_expansion, with_shift=with_shift)

    def forward(self, source, target, height, width, shifted_window_attn_mask, attn_num_splits, precision=None):
        source = self.self_attn(source, source, height, width, shifted_window_attn_mask, attn_num_splits, precision)
        return self.cross_attn_ffn(source, target, height, width, shifted_window_attn_mask, attn_num_splits,
                                   precision)


class FeatureTransformer(nn.Module):
    def __init__(self, num_layers=6, d_model=128, ffn_dim_expansion=4):
        super().__init__()
        self.d_model = d_model
        self.layers = nn.ModuleList([TransformerBlock(d_model, ffn_dim_expansion, with_shift=i % 2 == 1)
                                     for i in range(num_layers)])

    def forward(self, feature0, feature1, attn_num_splits, precision=None):
        b, c, h, w = feature0.shape
        feature0 = feature0.flatten(-2).permute(0, 2, 1)
        feature1 = feature1.flatten(-2).permute(0, 2, 1)
        shifted_window_attn_mask = None
        if attn_num_splits > 1:
            window_size_h, window_size_w = h // attn_num_splits, w // attn_num_splits
            shifted_window_attn_mask = generate_shift_window_attn_mask(
                (h, w), window_size_h, window_size_w, window_size_h // 2, window_size_w // 2, feature0.device)
        concat0 = torch.cat((feature0, feature1), dim=0)
        concat1 = torch.cat((feature1, feature0), dim=0)
        for layer in self.layers:
            concat0 = layer(concat0, concat1, h, w, shifted_window_attn_mask, attn_num_splits, precision)
            concat1 = torch.cat(concat0.chunk(chunks=2, dim=0)[::-1], dim=0)
        feature0, feature1 = concat0.chunk(chunks=2, dim=0)
        feature0 = feature0.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        feature1 = feature1.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        return feature0, feature1


# ------------------------------------------------------------------ matching.py, geometry.py
def coords_grid(b, h, w, device=None):
    y, x = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    return torch.stack([x, y], dim=0).float()[None].repeat(b, 1, 1, 1)


def global_correlation_softmax(feature0, feature1, precision=None):
    b, c, h, w = feature0.shape
    feature0 = round_to(feature0, precision).view(b, c, -1).permute(0, 2, 1)
    feature1 = round_to(feature1, precision).view(b, c, -1)
    correlation = torch.matmul(feature0, feature1).view(b, h, w, h, w) / (c ** 0.5)
    init_grid = coords_grid(b, h, w, correlation.device)
    grid = init_grid.view(b, 2, -1).permute(0, 2, 1)
    prob = F.softmax(correlation.view(b, h * w, h * w), dim=-1)
    correspondence = torch.matmul(prob, grid).view(b, h, w, 2).permute(0, 3, 1, 2)
    return correspondence - init_grid, prob


class FeatureFlowAttention(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature0, flow, precision=None):
        b, c, h, w = feature0.size()
        query = feature0.view(b, c, h * w).permute(0, 2, 1)
        query = linear(self.q_proj, query, precision)
        key = linear(self.k_proj, query, precision)
        value = flow.view(b, flow.size(1), h * w).permute(0, 2, 1)
        scores = torch.matmul(round_to(query, precision), round_to(key, precision).permute(0, 2, 1)) / (c ** 0.5)
        out = torch.matmul(torch.softmax(scores, dim=-1), value)
        return out.view(b, h, w, value.size(-1)).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ gmflow.py
class GMFlow(nn.Module):
    def __init__(self, feature_channels=128, num_transformer_layers=6, ffn_dim_expansion=4, upsample_factor=8,
                 attn_splits=2, **_):
        super().__init__()
        self.feature_channels, self.upsample_factor, self.attn_splits = feature_channels, upsample_factor, attn_splits
        self.backbone = CNNEncoder(output_dim=feature_channels)
        self.transformer = FeatureTransformer(num_transformer_layers, feature_channels, ffn_dim_expansion)
        self.feature_flow_attn = FeatureFlowAttention(feature_channels)
        self.upsampler = nn.Sequential(nn.Conv2d(2 + feature_channels, 256, 3, 1, 1), nn.ReLU(inplace=True),
                                       nn.Conv2d(256, upsample_factor ** 2 * 9, 1, 1, 0))

    def upsample_flow(self, flow, feature, precision=None):
        concat = torch.cat((flow, feature), dim=1)
        mask = held(self.upsampler[2], F.relu(held(self.upsampler[0], concat, precision)), precision)
        b, flow_channel, h, w = flow.shape
        f = self.upsample_factor
        mask = torch.softmax(mask.view(b, 1, 9, f, f, h, w), dim=2)
        up_flow = F.unfold(f * flow, [3, 3], padding=1).view(b, flow_channel, 9, 1, 1, h, w)
        up_flow = torch.sum(mask * up_flow, dim=2).permute(0, 1, 4, 2, 5, 3)
        return up_flow.reshape(b, flow_channel, f * h, f * w)

    def forward(self, images_0, images_1, precision=None):
        mean = torch.tensor([0.485, 0.456, 0.406], device=images_0.device).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225], device=images_0.device).view(1, 3, 1, 1)
        img0 = (images_0.permute(0, 3, 1, 2) - mean) / std
        img1 = (images_1.permute(0, 3, 1, 2) - mean) / std
        feature0, feature1 = self.backbone(torch.cat((img0, img1), dim=0), precision).chunk(2, 0)
        feature0, feature1 = feature_add_position(feature0, feature1, self.attn_splits, self.feature_channels)
        feature0, feature1 = self.transformer(feature0, feature1, self.attn_splits, precision)
        flow = global_correlation_softmax(feature0, feature1, precision)[0]
        flow = self.feature_flow_attn(feature0, flow, precision)
        flow_up = self.upsample_flow(flow, feature0, precision)
        return flow_up.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1)


def build(config: dict, device=None) -> nn.Module:
    """The reference GMFlow of a benchmark configuration, float32, in eval
    mode; TF32 off, so that its float32 products are float32's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    keys = ("feature_channels", "num_transformer_layers", "ffn_dim_expansion", "upsample_factor", "attn_splits")
    return GMFlow(**{k: config[k] for k in keys}).to(device=device, dtype=torch.float32).eval()
