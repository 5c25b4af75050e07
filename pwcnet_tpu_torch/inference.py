"""Serving: PWCDCNet on uint8 frame pairs (counterpart of ``pwcnet_tpu/inference.py``).

Frames are cropped to a multiple of ``2**num_levels`` (``factor_crop``,
the reference's behaviour) or edge-padded up to one with the flow cropped
back (``size_handling='pad'``). uint8 frames go to the device as they are
and are divided by 255 there. The per-level flows come back in pixel
units, ``20 / 2**(num_levels - l)`` times the internal flow.

The predictor runs on CUDA unless the caller passes ``device='cpu'``; with
no device and no CUDA it raises. On CUDA it runs the hand-written kernels
(K1 warped cost volume, K2 cost volume, K3 fused pyramid level) unless
``use_kernels=False`` picks the plain PyTorch path; ``fused_estimator=N``
also sends the N finest estimator levels through K7 (off by default, as in
the JAX package).

``spatial=N`` / ``data=M`` (or a prebuilt ``mesh``) serve across N x M
processes, one per GPU, started by ``torchrun``: every rank passes the same
frames and gets the whole flow back. ``data`` splits the batch (when it
divides); ``spatial`` shards each frame's rows (K3 on halo-extended
stripes, K8 at level 0 when that level holds at least 4 rows per shard,
K9 at the warped levels, the unsharded kernels on the levels too small to
shard), and the rows are all-gathered at the end. With ``use_fused=False``
or ``warp_type='nearest'`` the sharded levels warp apart from the cost
volume, against the all-gathered frame 1, and run K8 on the warped rows,
as the JAX predictor keeps its spatial cost volume there. K7 stays off
under H-sharding, as in the JAX package.

``predict_sequence`` streams consecutive pairs of a frame sequence in
batches, with up to ``depth`` dispatches in flight on the card: frames go
up from pinned host memory and flows come back into pinned host buffers,
both without blocking the host, which waits on a CUDA event only when it
hands a batch out. On a mesh every dispatch goes through the sharded
forward and every rank yields every pair. A checkpoint is a flax msgpack
file, an orbax checkpoint directory (read through ``tensorstore``) or a TF
checkpoint (``.ckpt`` / ``.ckpt.index``), the last checked against the
model's parameter tree.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Optional

import numpy as np
import torch

from pwcnet_tpu_torch.models.pwcnet import PWCDCNet
from pwcnet_tpu_torch.utils.profiling import span
from pwcnet_tpu_torch.weights import from_jax_params, load_params, to_jax_params

__all__ = ["factor_crop", "load_image", "resolve_device", "spatial_hooks", "FlowPredictor"]

# finest pyramid levels through K3, as the JAX package's accelerator default
FUSED_PYRAMID_LEVELS = 2


def factor_crop(image: np.ndarray, factor: int = 64) -> np.ndarray:
    """Crop H and W down to multiples of ``factor`` (top-left anchored)."""
    if image.ndim != 3:
        raise ValueError(f"expected an (H, W, C) frame, got shape {image.shape}")
    h, w, _ = image.shape
    return image[: factor * (h // factor), : factor * (w // factor)]


def load_image(path: str | os.PathLike) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pwcnet_tpu_torch runs on the GPU by default; pass "
                "device='cpu' (--device cpu) to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def spatial_hooks(mesh, use_kernels: bool, use_fused: bool = True) -> dict:
    """PWCDCNet's hooks for H-sharding over ``mesh``'s rows: the spatial
    cost volume (K8), with ``use_fused`` the warped cost volume (K9, bilinear
    warp only; without it the guard warps, bilinear or nearest, and K8
    correlates the warped rows) and, with the kernels, K3 on the two finest
    pyramid levels per shard; no K7 (as the JAX package)."""
    from pwcnet_tpu_torch.parallel import (
        make_spatial_cost_volume, make_spatial_guard, make_spatial_pyramid_level, make_spatial_warped_cv)

    return dict(
        spatial_guard_fn=make_spatial_guard(mesh, use_kernels),
        cost_volume_fn=make_spatial_cost_volume(mesh, use_kernels),
        warp_cv_fn=make_spatial_warped_cv(mesh, use_kernels) if use_fused else None,
        pyramid_level_fn=make_spatial_pyramid_level(mesh, use_kernels) if use_kernels else None,
        fused_pyramid_levels=FUSED_PYRAMID_LEVELS if use_kernels else 0,
        fused_estimator_levels=0,
    )


class FlowPredictor:
    """PWCDCNet inference with checkpoint loading."""

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        num_levels: int = 6,
        search_range: int = 4,
        warp_type: str = "bilinear",
        use_dc: bool = False,
        output_level: int = 4,
        dtype: torch.dtype = torch.float32,
        use_kernels: str | bool = "auto",
        use_fused: str | bool = "auto",
        fused_pyramid: str | int = "auto",
        fused_estimator: str | int = "auto",
        batched_pyramid: str | bool = "auto",
        size_handling: str = "crop",
        device=None,
        spatial: int = 1,
        data: int = 1,
        mesh=None,
    ):
        """``use_kernels``: 'auto' runs the CUDA kernels on a CUDA device;
        on the CPU their wrappers run the plain versions anyway. Without a
        checkpoint the weights are the JAX predictor's: ``model.init`` under
        ``PRNGKey(0)``, bit for bit; with one, no init is drawn.
        Resolved as the JAX predictor resolves them:

        - ``use_fused``: K1 (K9 under H-sharding), the fused bilinear warp +
          cost volume; 'auto' is on with the kernels and the bilinear warp;
        - ``fused_pyramid``: the N finest pyramid levels through K3; 'auto'
          is ``FUSED_PYRAMID_LEVELS`` with the kernels, else 0;
        - ``fused_estimator``: the N finest estimator levels through K7;
          'auto' is 0 (opt-in), and it needs ``use_kernels``; 0 under
          H-sharding;
        - ``batched_pyramid``: both frames through one pyramid call at 2B;
          'auto' is False (an opt-in A/B).

        ``spatial`` / ``data`` / ``mesh``: serving across processes
        (``parallel.make_mesh``; the mesh's device is this rank's)."""
        if size_handling not in ("crop", "pad"):
            raise ValueError(f"size_handling must be crop|pad: {size_handling!r}")
        self.size_handling = size_handling
        if mesh is None and (spatial > 1 or data > 1):
            from pwcnet_tpu_torch.parallel import make_mesh

            mesh = make_mesh(data=data, spatial=spatial, device=device)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if use_kernels == "auto":
            use_kernels = self.device.type == "cuda"
        spatial_on = mesh is not None and mesh.spatial > 1
        if use_fused == "auto":
            use_fused = bool(use_kernels) and warp_type == "bilinear"
        fused_pyramid = (FUSED_PYRAMID_LEVELS if use_kernels else 0) if fused_pyramid == "auto" else int(fused_pyramid)
        fused_estimator = 0 if fused_estimator == "auto" else int(fused_estimator)
        batched_pyramid = False if batched_pyramid == "auto" else bool(batched_pyramid)
        hooks = {}
        if spatial_on:
            hooks = spatial_hooks(mesh, bool(use_kernels), bool(use_fused))
        elif use_kernels:
            from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
            from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

            hooks = dict(
                cost_volume_fn=cost_volume_cuda,
                warp_cv_fn=warped_cost_volume if use_fused else None,
                fused_estimator_levels=fused_estimator,
            )
        hooks["fused_pyramid_levels"] = fused_pyramid
        model = PWCDCNet(
            num_levels=num_levels,
            search_range=search_range,
            warp_type=warp_type,
            use_dc=use_dc,
            output_level=output_level,
            batched_pyramid=batched_pyramid,
            # the JAX predictor's PRNGKey(0) init, drawn only without a checkpoint
            init=checkpoint is None,
            **hooks,
        )
        if checkpoint is not None:
            if str(checkpoint).endswith((".ckpt", ".ckpt.index")):
                from pwcnet_tpu_torch.train_lib.tf_converter import load_tf_checkpoint_params

                tree = load_tf_checkpoint_params(checkpoint, to_jax_params(model.state_dict()))
            else:
                tree = load_params(checkpoint)
            model.load_state_dict(from_jax_params(tree))
        else:
            print("!!! Inference with randomly initialized model !!!")
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.num_levels = num_levels
        self.crop_factor = 2**num_levels

    def prepare(self, image: np.ndarray) -> np.ndarray:
        """Crop (or edge-pad) a frame to a multiple of ``2**num_levels``."""
        if self.size_handling == "pad":
            f = self.crop_factor
            h, w = image.shape[:2]
            pad = ((0, -(-h // f) * f - h), (0, -(-w // f) * f - w), (0, 0))
            return np.pad(image, pad, mode="edge")
        return factor_crop(image, self.crop_factor)

    def _to_device(self, images) -> torch.Tensor:
        """Frames to the device; integer frames are divided by 255 there.
        Floating frames are taken as already normalised to [0, 1]."""
        t = torch.as_tensor(images).to(self.device, non_blocking=True)
        if not t.is_floating_point():
            t = t.to(torch.float32) / 255.0
        return t

    def raw_forward(self, images):
        """Forward on a prepared (B, 2, H, W, 3) batch (numpy or tensor,
        uint8 or [0, 1] floats); returns the model's device tensors
        ``(flows_final (B, H, W, 2), flows_pyramid)``, whole on every rank
        of a mesh."""
        with torch.inference_mode():
            t = self._to_device(images)
            return self._forward(t[:, 0], t[:, 1])

    def _forward(self, images_0: torch.Tensor, images_1: torch.Tensor):
        """The model on whole device frames (B, H, W, 3) each. On a mesh
        each rank takes its data index's slice of the batch (when B divides
        over ``data``, else the whole batch) and its rows, and the flows are
        all-gathered: every rank gets them whole. Every rank must call it
        with the same frames, in the same order: it runs collectives."""
        if self.mesh is None:
            return self.model(images_0, images_1)
        from pwcnet_tpu_torch.parallel import shard_batch
        from pwcnet_tpu_torch.parallel._comm import all_gather_rows

        mesh = self.mesh
        flows_final, pyramid = self.model(shard_batch(images_0, mesh, 1), shard_batch(images_1, mesh, 1))
        split = mesh.data > 1 and images_0.shape[0] % mesh.data == 0

        def whole(x, sharded):
            if sharded:
                x = all_gather_rows(x, mesh.rows, 1)
            return all_gather_rows(x, mesh.column, 0) if split else x

        sharded = self.model.sharded_levels(images_0.shape[1])
        return whole(flows_final, sharded[-1]), [whole(f, sh) for f, sh in zip(pyramid, sharded)]

    def __call__(self, image_0: np.ndarray, image_1: np.ndarray):
        """Run on a raw frame pair (uint8, or floats on the same 0..255 scale).

        Returns (flow_final (H', W', 2) float32 pixels, the pyramid list in
        pixel units, the prepared frames normalised (2, H', W', 3) float32).
        """
        orig_h, orig_w = image_0.shape[:2]
        stacked = np.stack([self.prepare(image_0), self.prepare(image_1)])
        images = stacked.astype(np.float32) / 255.0
        # uint8 travels as it is and is normalised on the device
        flow_final, pyramid = self.raw_forward((stacked if stacked.dtype == np.uint8 else images)[None])
        pyramid_px = [
            f[0].float().cpu().numpy() * (20.0 / 2 ** (self.num_levels - l))
            for l, f in enumerate(pyramid)
        ]
        flow_out = flow_final[0].float().cpu().numpy()
        if self.size_handling == "pad":
            flow_out = flow_out[:orig_h, :orig_w]
        return flow_out, pyramid_px, images

    # -- pipelined sequence inference -------------------------------------
    def _preprocess(self, image: np.ndarray) -> np.ndarray:
        """A sequence frame prepared once: uint8 stays uint8 (divided by
        255 on the device); other dtypes are taken on the 0..255 scale and
        normalised to float32 here, as ``__call__`` does."""
        image = self.prepare(np.asarray(image))
        return image if image.dtype == np.uint8 else image.astype(np.float32) / 255.0

    def predict_sequence(self, frames, depth: int = 2, batch: int = 1, fetch: str = "all"):
        """Batched, pipelined inference over consecutive frame pairs.

        - **batching**: each dispatch runs ``batch`` consecutive pairs:
          frames [i..i+B] give images_0 = [i..i+B) and images_1 = [i+1..i+B];
        - **pipelining**: up to ``depth`` dispatches stay in flight. A
          dispatch's frames are written into a pinned uint8 (or float32)
          staging tensor and copied up with ``non_blocking=True``; its
          flows (and pyramids for ``fetch='all'``) are copied into pinned
          host tensors with ``non_blocking=True`` and a CUDA event is
          recorded after them. The host waits on that event only when it
          hands the batch out, and each dispatch keeps its staging and
          output tensors until then, so no buffer is reused or read while a
          copy is pending. All of it runs on the device's current stream.
          On the CPU the same code runs without pinning or events.

        Each frame is preprocessed once and reused as the next batch's
        frame 0. The tail batch is padded with the last frame and the
        padding pairs are dropped, so every dispatch holds ``batch`` pairs.
        ``size_handling='pad'`` crops each flow back to its frame.

        Its phases are spans (``utils.profiling``): ``serve.load`` (a frame
        read and prepared), ``serve.stage`` (the staging tensor filled),
        ``serve.enqueue`` (copy up, forward, copies back, event) and
        ``serve.wait`` (the wait on a dispatch's event); none spans a yield.

        On a serving mesh every rank passes the same frames and yields every
        pair, whole: each dispatch runs the sharded forward of ``raw_forward``
        (the batch split over ``data`` when ``batch`` divides, else run whole
        by each data index; the rows over ``spatial``). The ranks issue the
        same collectives in the same order because they dispatch the same
        batches. The halo exchanges and gathers inside the forward hold the
        host until their data has arrived: over NCCL they are queued on the
        device and ``depth`` keeps dispatches in flight as without a mesh;
        over gloo (CPU ranks, or ranks sharing one card) each collective
        waits for the device, so a dispatch returns when its forward is
        nearly done and ``depth`` overlaps little beyond the flows' copy
        back.

        Args:
          frames: iterable of file paths or uint8 HxWx3 arrays (other
            dtypes on the 0..255 scale); consecutive elements form pairs.
          depth: dispatches in flight.
          batch: consecutive pairs per dispatch.
          fetch: 'all' yields ``(flow_px, pyramid_px, images)`` per pair as
            ``__call__`` returns them; 'flow' yields only ``flow_px``.

        Yields per consecutive pair, in order.
        """
        if fetch not in ("all", "flow"):
            raise ValueError(f"fetch must be all|flow: {fetch!r}")
        if batch < 1 or depth < 1:
            raise ValueError(f"batch ({batch}) and depth ({depth}) must be at least 1")
        pin = self.device.type == "cuda"

        def load(src):
            img = load_image(src) if isinstance(src, (str, os.PathLike)) else np.asarray(src)
            return img.shape[:2], self._preprocess(img)

        def dispatch(buf, n_valid):
            """buf: batch + 1 (orig_hw, frame) tuples; returns what finalize needs."""
            with span("serve.stage", n_valid):
                uint8 = all(f.dtype == np.uint8 for _, f in buf)
                staged = torch.empty((len(buf), *buf[0][1].shape), dtype=torch.uint8 if uint8 else torch.float32,
                                     pin_memory=pin)
                host = staged.numpy()
                for k, (_, f) in enumerate(buf):
                    host[k] = f if f.dtype == host.dtype else f.astype(np.float32) / 255.0
            with span("serve.enqueue", n_valid), torch.inference_mode():
                t = self._to_device(staged)
                flow_final, pyramid = self._forward(t[:-1], t[1:])
                outs = [flow_final, *pyramid] if fetch == "all" else [flow_final]
                fetched = [torch.empty(o.shape, dtype=torch.float32, pin_memory=pin) for o in outs]
                for dst, o in zip(fetched, outs):
                    dst.copy_(o, non_blocking=True)
                done = None
                if pin:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
            return staged, fetched, done, [hw for hw, _ in buf[:-1]], n_valid

        def finalize(item):
            staged, fetched, done, orig_hws, n_valid = item
            with span("serve.wait", n_valid):
                if done is not None:
                    done.synchronize()
            flows, *pyramid = [f.numpy() for f in fetched]
            imgs = staged.numpy()
            for i in range(n_valid):
                flow_out = flows[i]
                if self.size_handling == "pad":
                    orig_h, orig_w = orig_hws[i]
                    flow_out = flow_out[:orig_h, :orig_w]
                if fetch == "flow":
                    yield flow_out
                    continue
                pyramid_px = [f[i] * (20.0 / 2 ** (self.num_levels - l)) for l, f in enumerate(pyramid)]
                pair = imgs[i : i + 2]
                # normalised float32 frames of this pair only, not the whole stack
                yield flow_out, pyramid_px, pair.astype(np.float32) / 255.0 if pair.dtype == np.uint8 else pair

        pending: deque = deque()
        buf: list = []
        for src in frames:
            with span("serve.load"):
                buf.append(load(src))
            if len(buf) == batch + 1:
                pending.append(dispatch(buf, batch))
                buf = buf[-1:]  # the last frame starts the next batch
                if len(pending) >= depth:
                    yield from finalize(pending.popleft())
        if len(buf) >= 2:  # tail: pad with the last frame
            n_valid = len(buf) - 1
            pending.append(dispatch(buf + [buf[-1]] * (batch + 1 - len(buf)), n_valid))
        while pending:
            yield from finalize(pending.popleft())
