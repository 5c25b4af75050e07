"""A plain float32 PyTorch reference of RAFT (Teed & Deng, ECCV 2020,
arXiv:2003.12039), written as princeton-vl/RAFT ``core/raft.py``,
``extractor.py``, ``update.py`` and ``corr.py`` compute it: NCHW tensors,
``nn.InstanceNorm2d`` and ``nn.BatchNorm2d`` in eval mode, the all-pairs
``matmul`` divided by ``sqrt(C)``, ``avg_pool2d`` levels, the lookup by
``F.grid_sample(align_corners=True)`` on the (B h w, 1, h_k, w_k) maps as
RAFT's ``bilinear_sampler`` normalises it, and the convex upsample by
``F.unfold``. It imports nothing of the measured program; the benchmark
gives both sides the same weights (``harness.draw_weights`` on this
module's names, which the served model shares) and frames.

Departures, none of which changes the result: frames come NHWC in [0, 1]
and map by ``2 x - 1`` (RAFT: ``2 (x / 255) - 1`` of 8-bit frames); the
mask head and the upsample run once, after the last update (RAFT runs
them at every update and returns the last); the forward returns ``(flow
(B, H, W, 2), flow_low (B, H/8, W/8, 2))``, RAFT's ``test_mode`` pair,
NHWC. RAFT's sampler divides by ``w_k - 1``: a pyramid level with a side of
1 (frames under 128 pixels on a side) reads NaN, here as in RAFT.

``precision`` rounds every conv's operands as ``model.py`` describes
(None, ``'bf16'``, ``'fp8'``, ``'tf32'``); the correlation, the lookup and
the upsample stay float32, as the served model keeps them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.model import conv

__all__ = ["RAFT", "build"]


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, kernel_size=3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size=3, padding=1)
        norm = nn.BatchNorm2d if norm_fn == "batch" else nn.InstanceNorm2d
        self.norm1, self.norm2 = norm(planes), norm(planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = norm(planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, kernel_size=1, stride=stride), self.norm3)

    def forward(self, x, precision=None):
        y = F.relu(self.norm1(conv(self.conv1, x, precision)))
        y = F.relu(self.norm2(conv(self.conv2, y, precision)))
        if self.downsample is not None:
            x = self.norm3(conv(self.downsample[0], x, precision))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, norm_fn):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(64) if norm_fn == "batch" else nn.InstanceNorm2d(64)
        self.conv1 = nn.Conv2d(3, 64, kernel_size=7, stride=2, padding=3)
        planes = 64
        for i, (dim, stride) in enumerate(((64, 1), (96, 2), (128, 2))):
            layer = nn.Sequential(ResidualBlock(planes, dim, norm_fn, stride), ResidualBlock(dim, dim, norm_fn))
            self.add_module(f"layer{i + 1}", layer)
            planes = dim
        self.conv2 = nn.Conv2d(128, output_dim, kernel_size=1)

    def forward(self, x, precision=None):
        x = F.relu(self.norm1(conv(self.conv1, x, precision)))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, precision)
        return conv(self.conv2, x, precision)


class BasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1, padding=0)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr, precision=None):
        cor = F.relu(conv(self.convc1, corr, precision))
        cor = F.relu(conv(self.convc2, cor, precision))
        flo = F.relu(conv(self.convf1, flow, precision))
        flo = F.relu(conv(self.convf2, flo, precision))
        out = F.relu(conv(self.conv, torch.cat([cor, flo], dim=1), precision))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        self.convz1 = nn.Conv2d(hidden_dim + input_dim, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(hidden_dim + input_dim, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(hidden_dim + input_dim, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(hidden_dim + input_dim, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(hidden_dim + input_dim, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(hidden_dim + input_dim, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h, x, precision=None):
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1), (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(conv(convz, hx, precision))
            r = torch.sigmoid(conv(convr, hx, precision))
            q = torch.tanh(conv(convq, torch.cat([r * h, x], dim=1), precision))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x, precision=None):
        return conv(self.conv2, F.relu(conv(self.conv1, x, precision)), precision)


class BasicUpdateBlock(nn.Module):
    def __init__(self, cor_planes, hidden_dim=128):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden_dim=hidden_dim, input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1, padding=0))

    def forward(self, net, inp, corr, flow, precision=None):
        motion_features = self.encoder(flow, corr, precision)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1), precision)
        return net, self.flow_head(net, precision)

    def upsampling_mask(self, net, precision=None):
        return 0.25 * conv(self.mask[2], F.relu(conv(self.mask[0], net, precision)), precision)


def coords_grid(batch, ht, wd, device):
    coords = torch.meshgrid(torch.arange(ht, device=device), torch.arange(wd, device=device), indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


def bilinear_sampler(img, coords):
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    return F.grid_sample(img, torch.cat([xgrid, ygrid], dim=-1), align_corners=True)


class CorrBlock:
    def __init__(self, fmap1, fmap2, num_levels=4, radius=4):
        self.num_levels, self.radius = num_levels, radius
        batch, dim, ht, wd = fmap1.shape
        corr = torch.matmul(fmap1.view(batch, dim, ht * wd).transpose(1, 2), fmap2.view(batch, dim, ht * wd))
        corr = (corr / torch.sqrt(torch.tensor(dim).float())).reshape(batch * ht * wd, 1, ht, wd)
        self.corr_pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.corr_pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        out_pyramid = []
        for i in range(self.num_levels):
            dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1)
            centroid_lvl = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
            corr = bilinear_sampler(self.corr_pyramid[i], centroid_lvl + delta.view(1, 2 * r + 1, 2 * r + 1, 2))
            out_pyramid.append(corr.view(batch, h1, w1, -1))
        return torch.cat(out_pyramid, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def upsample_flow(flow, mask):
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up_flow = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up_flow = torch.sum(mask * up_flow, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up_flow.reshape(n, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """The full RAFT: hidden and context 128, features 256, 4 levels of
    radius 4, ``iters`` updates."""

    def __init__(self, iters=32, hidden_dim=128, context_dim=128, feature_dim=256, corr_levels=4, corr_radius=4, **_):
        super().__init__()
        self.iters, self.hidden_dim, self.context_dim = iters, hidden_dim, context_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = BasicEncoder(output_dim=feature_dim, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=hidden_dim + context_dim, norm_fn="batch")
        self.update_block = BasicUpdateBlock(corr_levels * (2 * corr_radius + 1) ** 2, hidden_dim)

    def forward(self, images_0, images_1, precision=None):
        image1 = 2 * images_0.permute(0, 3, 1, 2) - 1.0
        image2 = 2 * images_1.permute(0, 3, 1, 2) - 1.0
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2], dim=0), precision).split(image1.shape[0])
        corr_fn = CorrBlock(fmap1.float(), fmap2.float(), self.corr_levels, self.corr_radius)
        net, inp = torch.split(self.cnet(image1, precision), [self.hidden_dim, self.context_dim], dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)
        n, _, h, w = image1.shape
        coords0 = coords_grid(n, h // 8, w // 8, image1.device)
        coords1 = coords_grid(n, h // 8, w // 8, image1.device)
        for _ in range(self.iters):
            corr = corr_fn(coords1)
            net, delta_flow = self.update_block(net, inp, corr, coords1 - coords0, precision)
            coords1 = coords1 + delta_flow
        flow_up = upsample_flow(coords1 - coords0, self.update_block.upsampling_mask(net, precision))
        return flow_up.permute(0, 2, 3, 1), (coords1 - coords0).permute(0, 2, 3, 1)


def build(config: dict, device=None) -> nn.Module:
    """The reference RAFT of a benchmark configuration, float32, in eval mode."""
    keys = ("iters", "hidden_dim", "context_dim", "feature_dim", "corr_levels", "corr_radius")
    return RAFT(**{k: config[k] for k in keys}).to(device=device, dtype=torch.float32).eval()
