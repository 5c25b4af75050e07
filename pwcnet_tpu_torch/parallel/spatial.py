"""Spatial (H-axis) sharding of PWCDCNet over the ranks of a mesh row
(counterpart of ``pwcnet_tpu/parallel/spatial.py``).

Each shard holds H/n rows of a level. In the JAX package only the Pallas
kernels needed explicit ``shard_map`` code and GSPMD partitioned every other
op; PyTorch has no GSPMD, so this module also carries the row-sharded
counterparts of the ordinary ops:

- ``make_spatial_cost_volume``: d halo rows each way, then K8 (the cost
  volume against the halo-extended rows; zeros at the global edges are the
  frame's zero padding);
- ``make_spatial_warped_cv``: frame 1 all-gathered (the warp's reach
  depends on the flow), d flow halo rows each way kept in float32 with the
  shard's global row offset folded into y, then K9;
- ``SpatialGuard.warp``: the unfused warp (bilinear or nearest) of a
  shard's rows against the all-gathered frame 1, the shard's global row
  offset given to the warp's row grid (float32 in the bilinear warp, so the
  blend weights are those of the unsharded warp; an integer added after the
  nearest warp's truncation), then the spatial cost volume (K8) in the
  model;
- ``make_spatial_pyramid_level``: K3 on 6-row halo-extended stripes,
  cropped, with the first and last shard's 3 edge rows recomputed by the
  plain chain on a 12-row strip of the true frame edge (SAME padding of the
  intermediate convs applies there, not the halo recompute);
- ``make_spatial_guard``: which levels stay sharded (``keeps``: at least
  ``MIN_ROWS_PER_SHARD`` rows per shard, as the JAX guard), the transitions
  (``gather``, ``split``), and the GSPMD counterparts: a 3x3 conv with
  dilation δ exchanges δ rows each way and runs with no H padding; a
  pyramid level's stride-2 conv needs one row from below (TF SAME pads only
  the bottom); the TF1 bilinear upsamplings read one row from below and, at the
  global bottom, repeat the last row (the clamp) where the exchange brings
  zeros.

The kernels' wrappers take CPU tensors to their plain versions, so with
``use_kernels`` the same functions run on the CPU (the tests, over gloo).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.models.conv import cast_params
from pwcnet_tpu_torch.ops.activation import leaky_relu
from pwcnet_tpu_torch.ops.cost_volume import cost_volume, cost_volume_hpad
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import same_pad_stride2
from pwcnet_tpu_torch.ops.resize import upsample_with_next
from pwcnet_tpu_torch.ops.warp import warp_rows
from pwcnet_tpu_torch.parallel._comm import all_gather_rows, halo_exchange, split_rows

__all__ = [
    "MIN_ROWS_PER_SHARD",
    "SpatialGuard",
    "make_spatial_cost_volume",
    "make_spatial_guard",
    "make_spatial_pyramid_level",
    "make_spatial_warped_cv",
]

# fewer rows per shard than this and a level stays replicated (spatial.py:38)
MIN_ROWS_PER_SHARD = 4
# K3's halo: the chain's receptive field is 5 input rows, 6 keeps the stride-2 phase
PYRAMID_HALO = 6


def _unsharded_ops(use_kernels: bool):
    """The cost volume and warped cost volume of a replicated level."""
    if use_kernels:
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

        return cost_volume_cuda, warped_cost_volume
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume_plain

    return cost_volume, warped_cost_volume_plain


class SpatialGuard:
    """Row sharding of the model over one mesh row (``mesh.rows``).

    ``cost_volume_fn`` and ``warp_cv_fn`` are the unsharded ops that
    replicated levels run (K2 and K1 with ``use_kernels``; a model without
    a ``warp_cv_fn`` of its own warps apart from the cost volume there)."""

    def __init__(self, rows, use_kernels: bool = True):
        self.rows = rows
        self.size = rows.size
        self.cost_volume_fn, self.warp_cv_fn = _unsharded_ops(use_kernels)

    def keeps(self, rows: int, min_rows: int = MIN_ROWS_PER_SHARD) -> bool:
        """Whether a level of ``rows`` global rows stays sharded."""
        return rows % self.size == 0 and rows // self.size >= min_rows

    def _is_last(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.rows.index == self.size - 1, device=like.device)

    # -- transitions (rows along dim 2 of NCHW, 1 of NHWC)
    def gather(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        return all_gather_rows(x, self.rows, dim)

    def split(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        return split_rows(x, self.rows, dim)

    # -- the unfused warp of a sharded NHWC level
    def warp(self, f1: torch.Tensor, flow: torch.Tensor, warp_type: str = "bilinear") -> torch.Tensor:
        """This shard's rows of ``f1`` warped by its ``flow`` rows: the warp
        reaches across shards, so it samples the all-gathered frame, each
        flow row at its global row (the grid's ``row0``, never added to a
        bf16 flow); the rows equal the unsharded warp's."""
        return warp_rows(self.gather(f1, 1), flow, self.rows.index * f1.shape[1], warp_type)

    # -- the convs on a sharded NCHW tensor
    def conv(self, conv, x: torch.Tensor) -> torch.Tensor:
        """``conv(x)`` (3x3, stride 1, SAME with dilation δ) on a row shard:
        δ halo rows each way, no padding in H."""
        pad_h, pad_w = conv.padding
        x_ext = halo_exchange(x, pad_h, pad_h, self.rows, 2)
        w, b = cast_params(conv)
        return F.conv2d(x_ext, w, b, conv.stride, (0, pad_w), conv.dilation)

    # -- TF1 integer upsampling on a sharded NHWC tensor
    def upsample(self, x: torch.Tensor, f: int) -> torch.Tensor:
        """TF1 bilinear upsampling by the integer ``f`` of a row shard: the
        next row comes from the shard below; at the global bottom the last
        row repeats (TF1's clamp), not the exchanged zeros."""
        ext = halo_exchange(x, 0, 1, self.rows, 1)
        # the same ops on every rank (a where, not a branch): the backward
        # graphs must match for the ranks to enter the collectives in one order
        last_row = torch.where(self._is_last(x), x[:, -1:], ext[:, -1:])
        xn = torch.cat([ext[:, 1:-1], last_row], 1)
        y = upsample_with_next(x, xn, f, 1)
        xn_w = torch.cat([y[:, :, 1:], y[:, :, -1:]], 2)
        return upsample_with_next(y, xn_w, f, 2)

    def level_chain(self, x: torch.Tensor, k1, b1, k2, b2, k3, b3) -> torch.Tensor:
        """One pyramid level on a row shard of an even number of rows as
        three convs with halos (NHWC in and out; OIHW kernels): the stride-2
        conv (TF SAME pads bottom and right on even sizes) needs one row from
        below, the others one row each way."""
        y = x.permute(0, 3, 1, 2)
        y = F.pad(halo_exchange(y, 0, 1, self.rows, 2), same_pad_stride2(2, x.shape[2])[:2])
        y = leaky_relu(F.conv2d(y, k1, b1, 2), 0.1)
        for k, b in ((k2, b2), (k3, b3)):
            y = leaky_relu(F.conv2d(halo_exchange(y, 1, 1, self.rows, 2), k, b, padding=(0, 1)), 0.1)
        return y.permute(0, 2, 3, 1).contiguous()


def make_spatial_guard(mesh, use_kernels: bool = True) -> SpatialGuard:
    """The guard of ``mesh``'s row: which levels stay sharded, the
    transitions, the row-sharded convs, resizes and warp."""
    return SpatialGuard(mesh.rows, use_kernels)


def make_spatial_cost_volume(mesh, use_kernels: bool = True):
    """``cv_fn(f0, f1, d)`` on row shards (NHWC, h rows each): K8 after a
    d-row halo exchange (gathered when a shard holds fewer than d rows)."""
    rows = mesh.rows
    if use_kernels:
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_hpad_cuda as hpad
    else:
        hpad = cost_volume_hpad

    def cv_fn(f0, f1, search_range: int = 4):
        d = int(search_range)
        return hpad(f0, halo_exchange(f1, d, d, rows, 1).contiguous(), d)

    return cv_fn


def make_spatial_warped_cv(mesh, use_kernels: bool = True):
    """``wcv_fn(f0, f1, flow, d)`` on row shards (NHWC): K9 against the
    all-gathered frame 1, with d flow halo rows each way in float32 and the
    shard's global row offset added to flow y."""
    rows = mesh.rows
    if use_kernels:
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume_global as wcv_global
    else:
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume_global_plain as wcv_global

    def wcv_fn(f0, f1, flow, search_range: int = 4):
        d = int(search_range)
        h = f0.shape[1]
        off = rows.index * h
        f1_full = all_gather_rows(f1, rows, 1)
        # float32 whatever the model dtype: bf16 cannot hold offset + flow
        flow_ext = halo_exchange(flow.float(), d, d, rows, 1)
        shift = torch.tensor([0.0, float(off)], device=flow.device)
        flow_ext = (flow_ext + shift).contiguous()
        vb = (-off, f1_full.shape[1] - 1 - off)
        return wcv_global(f0, f1_full.contiguous(), flow_ext, vb, d)

    return wcv_fn


def make_spatial_pyramid_level(mesh, use_kernels: bool = True):
    """``plevel_fn(x, k1, b1, k2, b2, k3, b3)`` on a row shard (NHWC): K3 on
    the stripe with 6 halo rows each way, cropped to the shard's output rows;
    the first and last shard recompute their 3 edge rows with the plain
    chain on a 12-row strip of the frame's edge. Stripes of fewer than 12 or
    an odd number of rows, or an odd width, take the halo conv chain."""
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused, pyramid_level_plain

    guard = SpatialGuard(mesh.rows, use_kernels)
    rows = mesh.rows
    level = pyramid_level_fused if use_kernels else pyramid_level_plain
    halo = PYRAMID_HALO

    def plevel_fn(x, k1, b1, k2, b2, k3, b3):
        params = (k1, b1, k2, b2, k3, b3)
        hi, w = x.shape[1], x.shape[2]
        if hi % 2 or hi < 2 * halo or w % 2:
            return guard.level_chain(x, *params)
        ho = hi // 2
        edge = halo // 2
        y = level(halo_exchange(x, halo, halo, rows, 1).contiguous(), *params)[:, edge : edge + ho]
        # every rank computes both strips and selects with a where, as the
        # JAX package does: the backward graphs must match across ranks
        first = torch.tensor(rows.index == 0, device=x.device)
        last = torch.tensor(rows.index == rows.size - 1, device=x.device)
        top = pyramid_level_plain(x[:, : 2 * halo].contiguous(), *params)[:, :edge]
        bottom = pyramid_level_plain(x[:, -2 * halo :].contiguous(), *params)[:, -edge:]
        return torch.cat([
            torch.where(first, top, y[:, :edge]), y[:, edge:-edge], torch.where(last, bottom, y[:, -edge:])
        ], 1)

    return plevel_fn
