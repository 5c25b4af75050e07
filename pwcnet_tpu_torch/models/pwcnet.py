"""PWCDCNet, the reference's working model (model.py:74-138), in PyTorch.

- a shared 6-level feature pyramid over both frames (deep -> shallow);
- coarse to fine: at the deepest level a cost volume with no warp; at the
  finer levels frame-1 features are bilinear-warped by the upsampled flow
  scaled to pixels by ``20 / 2**(num_levels - l)``;
- per-level estimators threading the upsampled flow and features;
- at ``output_level``: the dilated context net, then a TF1 bilinear resize
  by ``2**(num_levels - output_level)`` and x20 to full-resolution pixels.

Inputs and outputs are NHWC as in the JAX package; inside, tensors are
NCHW in ``channels_last`` memory, so the NHWC views handed to the kernels
need no copy. The model computes in ``compute_dtype``; by default that is
the dtype of its parameters (``model.to(torch.bfloat16)`` is bf16 serving).
Training keeps float32 parameters and sets ``compute_dtype=torch.bfloat16``:
every conv casts its weight and bias at use, so the gradients arrive in
float32 (the JAX model's ``dtype`` with float32 ``param_dtype``).

Hooks, with the JAX package's meaning (``kernel_hooks`` picks them for
every builder of the port):

- ``cost_volume_fn(f0, f1, d)`` on NHWC tensors (K2 on the card);
- ``warp_cv_fn(f0, f1, flow_px, d)``, the fused bilinear warp + cost volume
  at the warped levels (K1); requires ``warp_type='bilinear'``;
- ``fused_pyramid_levels``: the N finest pyramid levels through K3's
  wrapper;
- ``fused_estimator_levels``: the N finest estimator levels (``l >
  output_level - N``) through K7's wrapper; same parameters;
- ``spatial_guard_fn`` (a ``parallel.SpatialGuard``): H-sharding over the
  ranks of a mesh row. The images are then this rank's row shard; a level
  stays sharded while it holds at least 4 rows per shard, as the JAX
  guard decides, and coarser levels run whole on every rank. Sharded levels
  use ``cost_volume_fn`` / ``warp_cv_fn`` (then the spatial ones, K8 and K9;
  without ``warp_cv_fn`` the guard's warp against the whole frame 1, nearest
  or bilinear, then ``cost_volume_fn``), ``pyramid_level_fn`` on the fused
  pyramid levels, and the guard's convs and resizes with halos; replicated
  levels use the guard's unsharded ``cost_volume_fn`` and, where the model
  has a ``warp_cv_fn``, the guard's (K2, K1; else the unfused warp). The
  first sharded level takes its rows of the upsampled flow and features
  (``split``).
  ``flows_final`` and each pyramid level come back as row shards where
  their level is sharded (``sharded_levels`` says which), else whole.

Options, with the JAX package's meaning:

- ``remat``: each ``fp_extractor`` call, each estimator and the context
  net run under ``torch.utils.checkpoint`` (non-reentrant), so the backward
  recomputes their activations instead of keeping them (the JAX model's
  ``nn.remat`` on the same three); the cost volumes and resizes stay
  outside. The recompute reruns K3 and K7 with their residuals, and under
  H-sharding the halo exchanges and gathers of those modules. Values and
  gradients are those of the model without it.
- ``batched_pyramid``: both frames through one extractor call at 2B, each
  level split at B; under H-sharding the frames are concatenated along the
  batch, so each rank's row shard stays whole.
- ``forward(..., with_features=True)`` also returns frame 0's pyramid.

Both forwards are spans (``utils.profiling``): ``model.forward`` with
``model.pyramid``, ``model.level<l>`` (warp, cost volume and estimator of
level l) and ``model.context`` inside it.

``PWCNet`` is the legacy variant (the JAX package's ``PWCNet``, the
reference's original model as it was meant to work): a 2-conv pyramid, a
zero flow at the deepest level and ``resize_bilinear(flow) * 2`` between
levels, warp by that flow, cost volume, ``FlowEstimatorLegacy`` (optional
BatchNorm), the context net at every level (``'all'``) or at the output
level (``'final'``), and a final resize by ``2**(num_levels -
output_level)`` times that factor. It is a serving model: its forward
always returns three values, so neither package trains it through
``make_train_step`` (``make_forward`` serves it).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pwcnet_tpu_torch.models.context import ContextNetwork
from pwcnet_tpu_torch.models.conv import Conv2d, to_nchw, to_nhwc
from pwcnet_tpu_torch.models.estimator import DEFAULT_EST_FILTERS, FlowEstimator, FlowEstimatorLegacy
from pwcnet_tpu_torch.models.pyramid import DEFAULT_FILTERS, FeaturePyramidExtractor, FeaturePyramidExtractorLegacy
from pwcnet_tpu_torch.ops.cost_volume import cost_volume
from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
from pwcnet_tpu_torch.ops.resize import resize_bilinear, upsample2x_bilinear
from pwcnet_tpu_torch.ops.warp import warp
from pwcnet_tpu_torch.prng import PRNGKey
from pwcnet_tpu_torch.utils.profiling import span
from pwcnet_tpu_torch.weights import init_params

__all__ = ["FUSED_PYRAMID_LEVELS", "PWCDCNet", "PWCNet", "flow_scales", "kernel_hooks"]

# finest pyramid levels through K3, as the JAX package's accelerator default
FUSED_PYRAMID_LEVELS = 2


def flow_scales(num_levels: int) -> list:
    """Pixel-unit factor per level, ``20 / 2**(num_levels - l)`` (None at 0)."""
    return [None] + [20.0 / 2 ** (num_levels - l) for l in range(1, num_levels + 1)]


def _init(model: nn.Module, key, init: bool) -> None:
    if init:
        init_params(model, PRNGKey(0) if key is None else key)


def _level_spans(output_level: int) -> tuple:
    """The span name of each level, made once so a disabled span allocates nothing."""
    return tuple(f"model.level{l}" for l in range(output_level + 1))


def _set_compute_dtype(model: nn.Module, compute_dtype: Optional[torch.dtype]) -> None:
    model.compute_dtype = compute_dtype
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = compute_dtype


class PWCDCNet(nn.Module):
    """PWC-Net with dense-connectable estimators and the context network.

    Only ``optflow_0 .. optflow_{output_level}`` exist: deeper estimators
    would never run, and the reference checkpoints hold none.
    The parameters are the JAX package's ``model.init(key, ...)``, bit for
    bit (``weights.init_params``; ``key`` a ``prng.PRNGKey``, ``PRNGKey(0)``
    when omitted). ``init=False`` draws none, for a caller that loads
    weights next: they are then PyTorch's own default init.
    """

    def __init__(
        self,
        num_levels: int = 6,
        search_range: int = 4,
        warp_type: str = "bilinear",
        use_dc: bool = False,
        output_level: int = 4,
        cost_volume_fn: Optional[Callable] = None,
        warp_cv_fn: Optional[Callable] = None,
        fused_pyramid_levels: int = 0,
        fused_estimator_levels: int = 0,
        key=None,
        init: bool = True,
        compute_dtype: Optional[torch.dtype] = None,
        spatial_guard_fn=None,
        pyramid_level_fn=None,
        remat: bool = False,
        batched_pyramid: bool = False,
    ):
        super().__init__()
        if output_level >= num_levels:
            raise ValueError("Should set output_level < num_levels")
        if warp_type not in ("bilinear", "nearest"):
            raise ValueError(f"warp_type must be 'nearest' or 'bilinear', got {warp_type!r}")
        if warp_cv_fn is not None and warp_type != "bilinear":
            raise ValueError(
                f"warp_cv_fn fuses the bilinear warp; use warp_type='bilinear', not {warp_type!r}"
            )
        self.num_levels = num_levels
        self.search_range = search_range
        self.warp_type = warp_type
        self.output_level = output_level
        self.cost_volume_fn = cost_volume_fn
        self.warp_cv_fn = warp_cv_fn
        self.spatial_guard_fn = spatial_guard_fn
        self.remat = remat
        self.batched_pyramid = batched_pyramid

        self.fp_extractor = FeaturePyramidExtractor(
            num_levels, fused_levels=fused_pyramid_levels, level_fn=pyramid_level_fn)
        taps = (2 * search_range + 1) ** 2
        feat = 0
        for l in range(output_level + 1):
            cin = taps + DEFAULT_FILTERS[num_levels - 1 - l] + (0 if l == 0 else 2 + feat)
            est = FlowEstimator(cin, use_dc=use_dc, fused=l > output_level - fused_estimator_levels)
            self.add_module(f"optflow_{l}", est)
            feat = est.out_channels
        self.context = ContextNetwork(2 + feat)
        self._level_spans = _level_spans(output_level)
        _init(self, key, init)
        _set_compute_dtype(self, compute_dtype)

    def sharded_levels(self, frame_rows: int) -> list:
        """Per level (deep first, to ``output_level``): whether it runs as row
        shards for a frame of ``frame_rows`` global rows."""
        g = self.spatial_guard_fn
        return [
            g is not None and g.keeps(frame_rows >> (self.num_levels - l))
            for l in range(self.output_level + 1)
        ]

    def _run(self, module, *args, **kwargs):
        """``module(*args, **kwargs)``; under ``remat`` its activations are
        recomputed in the backward instead of kept. The model draws no random
        numbers, so no RNG state is saved for the recompute."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)
        return module(*args, **kwargs)

    def forward(self, images_0: torch.Tensor, images_1: torch.Tensor, with_features: bool = False):
        """``images_*`` (B, H, W, 3) in [0, 1], H and W multiples of
        ``2**num_levels`` (row shards of such frames under H-sharding).
        Returns ``(flows_final (B, H, W, 2) pixels, flows_pyramid)``, the
        pyramid deep -> output level in internal units (pixels / 20 at full
        resolution), each (B, h, w, 2); ``with_features`` appends frame 0's
        feature pyramid, deep first, each (B, h, w, C) (row shards where
        the level is sharded)."""
        with span("model.forward", images_0.shape[0]):
            return self._forward(images_0, images_1, with_features)

    def _forward(self, images_0, images_1, with_features):
        g = self.spatial_guard_fn
        dtype = self.compute_dtype or self.fp_extractor.conv2d.weight.dtype
        with span("model.pyramid"):
            if self.batched_pyramid:
                b = images_0.shape[0]
                pyramid = self._run(self.fp_extractor, to_nchw(torch.cat([images_0, images_1]).to(dtype)), g)
                pyramid_0, pyramid_1 = [p[:b] for p in pyramid], [p[b:] for p in pyramid]
            else:
                pyramid_0 = self._run(self.fp_extractor, to_nchw(images_0.to(dtype)), g)
                pyramid_1 = self._run(self.fp_extractor, to_nchw(images_1.to(dtype)), g)
        scales = flow_scales(self.num_levels)
        sharded = self.sharded_levels(images_0.shape[1] * (g.size if g is not None else 1))
        d = self.search_range

        flows_pyramid = []
        flows_up = features_up = None
        for l, (f0, f1) in enumerate(zip(pyramid_0, pyramid_1)):
            sh = sharded[l]
            rows = g if sh else None
            with span(self._level_spans[l]):
                # a replicated level fuses the warp only where the model does
                cv_fn, wcv_fn = (self.cost_volume_fn, self.warp_cv_fn) if g is None or sh else (
                    g.cost_volume_fn, g.warp_cv_fn if self.warp_cv_fn is not None else None)
                if sh and flows_up is not None and not sharded[l - 1]:
                    flows_up, features_up = g.split(flows_up), g.split(features_up)
                f0n, f1n = to_nhwc(f0), to_nhwc(f1)
                if l == 0:
                    cv = (cv_fn or cost_volume)(f0n, f1n, d)
                else:
                    flow_px = to_nhwc(flows_up * scales[l])
                    if wcv_fn is not None:
                        cv = wcv_fn(f0n, f1n, flow_px, d)
                    else:
                        warped = g.warp(f1n, flow_px, self.warp_type) if sh else warp(f1n, flow_px, self.warp_type)
                        cv = (cv_fn or cost_volume)(f0n, warped, d)
                flows, features = self._run(
                    getattr(self, f"optflow_{l}"), to_nchw(cv), f0, flows_up, features_up, rows=rows
                )
                if l < self.output_level:
                    # one joint 2+C-channel upsample: bilinear resize is
                    # channelwise, so this equals two separate resizes
                    both = to_nhwc(torch.cat([flows, features], 1))
                    fu = to_nchw(g.upsample(both, 2) if sh else upsample2x_bilinear(both))
                    flows_up, features_up = fu[:, :2], fu[:, 2:]
                    flows_pyramid.append(flows)
                    continue
            with span("model.context"):
                flows = self._run(self.context, flows, features, rows=rows)
            flows_pyramid.append(flows)
            up = 2 ** (self.num_levels - self.output_level)
            h, w = flows.shape[2], flows.shape[3]
            fn = to_nhwc(flows)
            flows_final = (g.upsample(fn, up) if sh else resize_bilinear(fn, (h * up, w * up))) * 20.0
            out = flows_final, [to_nhwc(f) for f in flows_pyramid]
            return (*out, [to_nhwc(f) for f in pyramid_0]) if with_features else out


def kernel_hooks(use_kernels: bool, *, fused: Optional[bool] = None, fused_estimator: int = 0, mesh=None,
                 warp_type: str = "bilinear") -> dict:
    """``PWCDCNet``'s hook arguments: which implementation of each op it runs.
    Under H-sharding (``mesh.spatial > 1``) the guard, K8, K9 when ``fused``
    and K3 per shard with the kernels, no K7 (as the JAX package); else with
    the kernels K2, K1 when ``fused``, K3 on ``FUSED_PYRAMID_LEVELS`` and K7
    on ``fused_estimator`` levels; else none. ``fused=None`` is on with the
    kernels and the bilinear warp; ``fused=True`` with the nearest warp
    reaches the constructor, which refuses it."""
    if fused is None:
        fused = bool(use_kernels) and warp_type == "bilinear"
    if mesh is not None and mesh.spatial > 1:
        from pwcnet_tpu_torch.parallel import (
            make_spatial_cost_volume, make_spatial_guard, make_spatial_pyramid_level, make_spatial_warped_cv)

        return dict(
            spatial_guard_fn=make_spatial_guard(mesh, use_kernels),
            cost_volume_fn=make_spatial_cost_volume(mesh, use_kernels),
            warp_cv_fn=make_spatial_warped_cv(mesh, use_kernels) if fused else None,
            pyramid_level_fn=make_spatial_pyramid_level(mesh, use_kernels) if use_kernels else None,
            fused_pyramid_levels=FUSED_PYRAMID_LEVELS if use_kernels else 0,
            fused_estimator_levels=0,
        )
    if not use_kernels:
        return {}
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

    return dict(
        cost_volume_fn=cost_volume_cuda,
        # warp + correlation in one kernel forward, K4 and K5 backward
        warp_cv_fn=warped_cost_volume if fused else None,
        fused_pyramid_levels=FUSED_PYRAMID_LEVELS,
        fused_estimator_levels=fused_estimator,
    )


class PWCNet(nn.Module):
    """The legacy PWC-Net (``pwcnet_tpu/models/pwcnet.py`` ``PWCNet``).

    Only the estimators (and with ``context='all'`` the context nets) of
    levels ``0 .. output_level`` exist, as flax creates them. ``batch_norm``
    puts flax's BatchNorm after each hidden estimator conv. ``key``,
    ``init`` and ``compute_dtype`` as in ``PWCDCNet``: the parameters and
    ``batch_stats`` are the JAX model's init for ``key``.

    ``cost_volume_fn(f0, f1, d)`` on NHWC tensors defaults to K2's wrapper
    ``ops.cuda.cost_volume.cost_volume_cuda``: the plain version on a CPU
    tensor, K2 on a CUDA tensor, with K4 as its backward. ``PWCDCNet``'s
    default is None, wired by ``kernel_hooks``; the legacy model has no
    such entry point, so a bare ``PWCNet().to("cuda")`` runs the kernel.
    Pass ``ops.cost_volume.cost_volume`` for the plain version on the card.
    """

    def __init__(
        self,
        num_levels: int = 6,
        search_range: int = 4,
        warp_type: str = "bilinear",
        context: str = "final",
        batch_norm: bool = False,
        output_level: int = 4,
        cost_volume_fn: Callable = cost_volume_cuda,
        key=None,
        init: bool = True,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if output_level >= num_levels:
            raise ValueError("Should set output_level < num_levels")
        if context not in ("all", "final"):
            raise ValueError(f"context argument should be all/final, got {context!r}")
        if warp_type not in ("bilinear", "nearest"):
            raise ValueError(f"warp_type must be 'nearest' or 'bilinear', got {warp_type!r}")
        self.num_levels = num_levels
        self.search_range = search_range
        self.warp_type = warp_type
        self.context_mode = context
        self.output_level = output_level
        self.cost_volume_fn = cost_volume_fn

        self.fp_extractor = FeaturePyramidExtractorLegacy(num_levels)
        taps = (2 * search_range + 1) ** 2
        feat = DEFAULT_EST_FILTERS[-1]
        for l in range(output_level + 1):
            cin = taps + DEFAULT_FILTERS[num_levels - 1 - l] + 2
            self.add_module(f"optflow_{l}", FlowEstimatorLegacy(cin, batch_norm=batch_norm))
            if context == "all":
                self.add_module(f"context_{l}", ContextNetwork(2 + feat))
        if context == "final":
            self.context = ContextNetwork(2 + feat)
        self._level_spans = _level_spans(output_level)
        _init(self, key, init)
        _set_compute_dtype(self, compute_dtype)

    def forward(self, images_0: torch.Tensor, images_1: torch.Tensor, train: bool = False):
        """``images_*`` (B, H, W, 3) in [0, 1], H and W multiples of
        ``2**num_levels``. Returns ``(final_flow (B, H, W, 2), flows,
        pyramid_0)``: the per-level flows deep -> output level, each (B, h,
        w, 2), and frame 0's feature pyramid, deep first, each (B, h, w, C).

        ``train`` is the JAX model's flag, not ``self.training``: with it
        the BatchNorm layers normalise by the batch's statistics and update
        their running ones (flax's ``mutable=["batch_stats"]``); the default
        call leaves them as they are, whatever mode the module is in."""
        with span("model.forward", images_0.shape[0]):
            return self._forward(images_0, images_1, train)

    def _forward(self, images_0, images_1, train):
        dtype = self.compute_dtype or self.fp_extractor.conv2d.weight.dtype
        with span("model.pyramid"):
            pyramid_0 = self.fp_extractor(to_nchw(images_0.to(dtype)))
            pyramid_1 = self.fp_extractor(to_nchw(images_1.to(dtype)))
        flows = []
        flow = None
        for l, (f0, f1) in enumerate(zip(pyramid_0, pyramid_1)):
            b, _, h, w = f0.shape
            with span(self._level_spans[l]):
                if l == 0:
                    flow = f0.new_zeros((b, h, w, 2))
                else:
                    flow = resize_bilinear(flow, (h, w)) * 2.0
                warped = warp(to_nhwc(f1), flow, self.warp_type)
                cost = self.cost_volume_fn(to_nhwc(f0), warped, self.search_range)
                feature, flow = getattr(self, f"optflow_{l}")(to_nchw(cost), f0, to_nchw(flow), train=train)
            if self.context_mode == "all" or l == self.output_level:
                with span("model.context"):
                    context = getattr(self, f"context_{l}") if self.context_mode == "all" else self.context
                    flow = context(flow, feature)
            flow = to_nhwc(flow)
            flows.append(flow)
            if l == self.output_level:
                up = 2 ** (self.num_levels - self.output_level)
                final_flow = resize_bilinear(flow, (h * up, w * up)) * up
                return final_flow, flows, [to_nhwc(p) for p in pyramid_0]
