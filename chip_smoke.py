#!/usr/bin/env python3
"""Smoke run of pwcnet_tpu_torch on one NVIDIA GPU (H100), from the repo root.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   convolutions and matmuls, so float32 comparisons are true float32;
2. build: compile every CUDA kernel from ``pwcnet_tpu_torch/csrc`` with
   nvcc (one process per source, all at once); log each kernel's registers
   and spills, the wgmma and correlation kernels' dynamic shared memory,
   the float32 K3, K6 and K7 kernels' and K4's shared memory, threads and
   resident blocks an SM, the bf16 K7 and K7b wgmma kernel's registers,
   shared memory and blocks an SM at each width and K7b's dxin N tiles
   (K6's float32 kernels, K4, K5 and the K7 / K7b wgmma kernel must not
   spill), K7's float32 tile at each main-path shape, the correlation's tile and cluster
   size, K4's and K8b's tile rows and blocks, and K5's and K9b's lanes a
   pixel and cooperative grid at each main-path shape;
3. kernels: K1 (warped cost volume), K2 (cost volume) and K3 (fused
   pyramid level) at every shape the 448x1024 serving forward gives them
   (K2 also at the four finer levels, where the legacy PWCNet runs it, and
   K4 there too),
   at batch 1 and 8, in float32 and bfloat16, against their plain PyTorch
   versions on the card; then, at every shape of the 384x448 training
   step, the residuals K1 and K3 write for the backward (the warped map;
   s1 and s2) and the backward kernels K4 (cost volume), K5 (bilinear
   warp) and K6 (pyramid level) against their plain versions; K7 (the
   estimator's six-conv chain) forward, with and without residuals, and
   backward (every cotangent, the weight and bias gradients taken from
   them, and dxin) at the five estimator levels of both sizes; K3 and K7
   also at edge shapes that no tile of theirs divides; one K5 call and one
   K9b call must each be one device kernel, in float32 and bf16, and one
   bf16 K7b call the weight packer, the flow cotangent's padding and six
   wgmma stages, no weight copy (torch.profiler); K5 and K9b with a NaN,
   a +Inf, a -Inf and a +Inf beside a -Inf in g must give each element the
   class of the plain version's float sum; K5 and K9b with one image's g at
   1e-8 of the others' must give each image the bits of a call on it
   alone, that image within tolerance of its own scale; then every kernel
   (K5 and K9b sum df1 in fixed point, the rest use no atomics) must give
   the same bits in two launches on the same inputs, K5 and K9b also in a third after
   another kernel has filled the L2 and the SMs, and K5's run-to-run
   difference in check_training_kernels must be 0; last R1 (RAFT's
   correlation lookup) against ``lookup_plain`` at the RAFT cell's 1/8 grid
   of 448x1024 frames, B=1 and 16, one launch a call, exact zeros where
   every window misses its map; R2 and R3 (RAFT's update epilogues and GRU
   gates) against their plain versions at the same grid, B=1 and 16, bf16
   and float32, the coordinates' update bit for bit; and R1 32, R2 224, R3
   128 launches and no other hand kernel in a RAFT(iters=32) bf16 forward
   at 448x1024, B=1; R4 (GMFlow's global matching and propagation)
   against the float64 product at the GMFlow cell's 7168 keys (B=2, the
   grid and a flow as the value) and a ragged 54x126 grid (B=1), within
   4e-6 of the output's largest magnitude, at 7168 keys within twice the
   float32 memory-efficient attention's error, one launch a call; R5 (GMA's
   softmax over a block of float32 scores into bf16 probabilities) at the
   GMA cell's B=4 and 32640 keys, a block of ``score_rows`` rows of real
   bf16 scores written into the strided rows of a (B, N, N) tensor, against
   the plain softmax within one bf16 rounding, no other row touched; R6
   (GMA's aggregation epilogue) against its plain version bit for bit at the
   cell's 136x240 grid, B=4, into the global slots of 512-channel buffers,
   bf16 and float32; and R1 32, R2 224, R3 128, R5 1 and R6 32 launches
   and no other hand kernel in a GMA(iters=32) bf16 forward at 448x1024,
   B=1;
4. serving: FlowPredictor with seeded random weights answers 448x1024
   requests and a 1024x436 (Sintel-sized) request edge-padded to 448x1024,
   then batched raw_forward at B=8 in bf16 and f32; the launch counters
   must show K1 4x, K2 1x and K3 4x per forward; flows must match the same
   predictor on the plain path (use_kernels=False) and, on a small pair,
   the float32 CPU path; ``FlowPredictor(batched_pyramid=True)`` at B=8 in
   bf16 and f32 (K3 on both frames in one call: K1 4x, K2 1x, K3 2x per
   forward) within those bounds of the default predictor, and its pairs/s
   against the default's in turns (reported). Then ``[legacy]``: the
   legacy ``PWCNet`` (6 levels, 'final', no BatchNorm, seeded weights)
   through ``make_forward`` at 448x1024 B=8 in bf16 and f32, K2 exactly 5
   a forward and nothing else, flows against the plain cost volume at the
   bounds above, 'all' with BatchNorm statistics moved by ``train=True``
   calls likewise, one float32 backward (K4 exactly 5) with every gradient
   of a seeded positive cotangent within 1e-3 of its tensor's largest
   entry, and its pairs/s on both paths (reported). Then ``[sequence]``: ``predict_sequence`` on 17
   drifting 448x1024 frames through the bf16 kernel predictor (B=8 at
   depth 2 with flows only, and B=3 with pyramids and frames, which leaves
   a ragged tail), K1 4x, K2 1x and K3 4x per dispatch, every pair against
   ``__call__`` (bf16 within 5% of the flow's scale, float32 on 3 pairs
   within 1e-4), its pairs/s at B=8 with depth 2 and depth 1 beside
   raw_forward's, and ``python -m pwcnet_tpu_torch.test_continuous --time``
   on the frames written as PNGs; ``[ckpt]``: the seeded weights written
   as a TF bundle load through ``FlowPredictor(checkpoint=<prefix>.ckpt)``
   and give the msgpack weights' flow bit for bit, and a CUDA
   ``TrainState`` goes through ``save_checkpoint_orbax`` /
   ``restore_checkpoint_orbax`` bitwise where ``tensorstore`` imports (one
   line saying so where it does not, after checking the refusal names it);
   ``[bf16px]``:
   ``scripts/torch_bf16_parity.py`` at 448x1024 B=4, EPE(bf16 vs f32) at
   most 0.05 px on the kernel and the plain path;
5. training: the train step at 384x448 with seeded random weights and a
   seeded smooth batch, float32 parameters, bfloat16 and float32 compute:
   every parameter's gradient on the kernel path against the plain path
   (ordinary autograd), five steps at B=8 with a finite falling loss, the
   launch counters (K1 4x, K2 1x, K3 4x, K4 5x, K5 4x, K6 4x per step),
   pairs/s of the step on both paths and the peak memory. Then ``[remat]``:
   the step with ``PWCDCNet(remat=True)`` (the pyramid, estimators and
   context net under ``torch.utils.checkpoint``, so the backward reruns K3
   and K7): at B=4 its loss (rtol 1e-6) and every gradient against the step
   without remat on the same weights, one step each through
   ``make_train_step`` with the gradients read by hooks (float32 within
   1e-4 of each tensor's largest entry, bf16 at [train]'s gates, and both
   bitwise), with and without K7 on 2
   levels; five steps at B=8 with a falling loss and K1 4x, K2 1x, K3 8x,
   K4 5x, K5 4x, K6 4x per step (with K7 on 2 levels also K7 4x, K7b 2x);
   ms per step and peak memory with and without remat at B=8 (in turns)
   and B=32 (one turn a side) in both dtypes, and the remat step's profile
   (reported); the largest
   gradient difference of remat against no remat is printed. Then
   ``[determinism]``: two
   float32 and two bf16 train steps at 384x448 B=8 through
   ``make_train_step``, each from a fresh state of one seed on one batch,
   with no flag set here, on six paths (the kernels, the plain path,
   ``use_fused=False``, the nearest warp, ``--remat``, the legacy
   ``PWCNet`` with BatchNorm under ``train=True``): every parameter, first
   moment and buffer must be bitwise the same and ``cudnn.deterministic``
   the caller's after the step; the kernel path once more under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the ops it
   warns about listed, reported). Then
   ``[converge]``: the SyntheticFlow convergence proof
   (``pwcnet_tpu_torch/train_lib/convergence.py``: 3 levels, 32x32, B=8)
   with the kernels from the JAX proof's own init, ``PRNGKey(CONVERGE_KEY)``
   drawn without JAX (``convergence.jax_init``), its parameters' SHA-1
   gated against ``CONVERGE_INIT_SHA1`` (computed from the JAX package's
   init by a CPU test): multiscale float32 and remat
   400 steps, robust 150 and bf16 120 after a 300-step warm start, each
   gated below 0.5 px full-set EPE, every step launching exactly
   ``CONVERGE_PER_STEP`` (K3 8 under remat); one line per case with its
   steps, EPE, seconds and whether it ended on the 1.862 px constant flow
   (where a failing case from an init that did not escape it ends), each
   EPE also in full precision (repr); the multiscale case again, its EPE's
   repr and every parameter bitwise the first run's; and the multiscale
   case on the plain path as a witness (reported, not gated);
6. trainer: a FlyingChairs-layout dataset (P6 .ppm pairs and .flo files,
   384x512, a seeded texture shifted by a known flow) is written under a
   temporary directory with numpy alone, and ``pwcnet_tpu_torch.train.main``
   trains on it for two epochs (B=8, random crop 384x448, bfloat16,
   ``--fused-estimator 2``): the loader must take the native path, every
   kernel must be launched its number of times per step (K7 2 forward and
   2 backward), the logged loss must be finite and falling, checkpoints and
   metrics must exist, a run resumed from ``model_1.msgpack`` must see the
   bytes of the first run's first batch of epoch 2, and
   ``pwcnet_tpu_torch.evaluate.main`` must give the same EPE with the
   kernels on and off; one epoch with ``--remat`` must launch its kernels
   as above per step, log finite losses and write a ``model_1.msgpack``
   that ``FlowPredictor`` serves; two one-epoch float32 runs from one seed
   report whether their ``model_1.msgpack`` are byte-identical (and their
   first batches' SHA-1s); then the loader alone and one more epoch
   with ``--fused-estimator 0`` are timed;
7. spatial: H-sharding on the one card. In ``[kernels]`` K8 and K8b (the
   cost volume of a row shard against halo-extended rows, and its
   backward) and K9 and K9b (a shard's warped cost volume against the whole
   frame, and the warp backward that follows K8b in its backward) are held
   against their plain versions at the shard shapes of 448x1024, 384x448
   and a 1024x1024 frame over 2 shards, and the stripes of one frame,
   stitched, against the unsharded K2/K1 and (gradients summed over the
   stripes) K4/K5. The ``[spatial]`` phase then
   spawns 2 ranks on the card, joined by a gloo group that stages every
   halo and gather through the host: ``FlowPredictor`` H-sharded at
   448x1024 B=8 and at one 1024x1024 pair (level 0 sharded: K8), bf16 and
   f32; ``FlowPredictor(spatial=2, use_fused=False)`` and ``(...,
   warp_type='nearest')`` at 448x1024 B=8 in bf16 and f32 against the
   unsharded predictor with the same option (per rank and forward exactly
   K2 1, K3 4, K8 4, no K9); ``predict_sequence`` on the (1 x 2) mesh over
   ``[sequence]``'s 17 frames (bf16, B=8, depth 2, flows only) and over 5
   of them in float32 (B=3: a padded tail), every pair against the
   unsharded stream, and the bf16 streams' pairs/s (reported); the
   sharded train step at 384x448 B=8 (the first step's gradients
   against the unsharded step in f32 and bf16, 5 bf16 steps), and
   ``train.main --spatial 2`` on the written dataset (one epoch, one
   resume, ``evaluate --spatial 2`` against the unsharded EPE); each rank
   reports its launch counts. NCCL across GPUs needs two cards and is not
   run on a one-card machine;
8. timing: each kernel, its plain version and its library call (K3, K6,
   K7: the cuDNN conv chain; K5, K9b: grid_sample's backward) timed with
   CUDA events at the main-path shapes (B=8, bf16; K3 also
   at the training step's levels), then every kernel again in float32
   beside cuDNN's float32 chains (TF32 off); R1 in float32 at the RAFT
   cell's shape (B=16, one update) beside its bound
   (``benchmark/raft_work.py`` ``lookup_work``) and ``lookup_plain``; R2
   and R3 in bf16 at each call of one update at that shape beside their
   bounds (bytes at 3.35 TB/s) and their plain versions; R4 at the GMFlow
   cell's shape (B=16, 7168 keys) beside its bound (the bf16 product or
   the exponentials), its plain version and the float32 memory-efficient
   attention it replaced; R5 on one block of rows and R6 on one update at
   the GMA cell's shape (B=4, 1088x1920) beside their bounds (bytes at 3.35
   TB/s), their plain versions and, for R5, ``torch.softmax`` alone;
   pairs/s of the whole forward
   at 448x1024 B=8; device time by kernel and the device's busy share for
   the forward and for the train step, in bf16 and in float32
   (torch.profiler).

The line before the last is ``{"kernels": [...]}`` (bf16 times, and
``ms_float32``, ``bound_ms_float32``, ``library_ms_float32`` beside them);
the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

# shapes at 448x1024 (per sample): level -> (H, W, C)
K1_SHAPES = ((14, 32, 128), (28, 64, 96), (56, 128, 64), (112, 256, 32))
# K2: level 0 of PWCDCNet's forward, then the four finer levels, which the
# legacy PWCNet's forward also gives it (every level's cost volume is K2's)
K2_SHAPES = ((7, 16, 192),) + K1_SHAPES
K3_SHAPES = ((448, 1024, 3, 16), (224, 512, 16, 32))  # (H, W, Cin, C)
# levels whose half height and half width are no multiple of the bf16 kernel's 8 x 64 tile
K3_EDGE = ((34, 150, 3, 16), (26, 140, 16, 32))
SEARCH_RANGE = 4
TAPS = (2 * SEARCH_RANGE + 1) ** 2
PER_FORWARD = {"K1": 4, "K2": 1, "K3": 4}
# shapes of the 384x448 training step (per sample)
TRAIN_HW = (384, 448)
K1_TRAIN = ((12, 14, 128), (24, 28, 96), (48, 56, 64), (96, 112, 32))
K2_TRAIN = ((6, 7, 192),)
K3_TRAIN = ((384, 448, 3, 16), (192, 224, 16, 32))
PER_STEP = {"K1": 4, "K2": 1, "K3": 4, "K4": 5, "K5": 4, "K6": 4}
# the estimator chain: output widths, and (H, W, Cin) per level, deep to fine
EST_COUTS = (128, 128, 96, 64, 32, 2)
K7_TRAIN = ((6, 7, 273), (12, 14, 243), (24, 28, 211), (48, 56, 179), (96, 112, 147))
K7_SERVE = ((7, 16, 273), (14, 32, 243), (28, 64, 211), (56, 128, 179), (112, 256, 147))
# the chain at its narrowest and widest inputs on frames that no 8 x 30 tile divides
K7_EDGE = ((6, 7, 147), (9, 61, 273))
FUSED_ESTIMATOR = 2  # the trainer run's --fused-estimator: levels 3 and 4
# per trainer step with --fused-estimator 2; a validation batch is one forward
TRAINER_PER_STEP = {**PER_STEP, "K7": FUSED_ESTIMATOR, "K7b": FUSED_ESTIMATOR}
TRAINER_PER_FORWARD = {**PER_FORWARD, "K7": FUSED_ESTIMATOR}
# a remat step: the backward recomputes the pyramid (K3 again), the
# estimators (K7 again) and the context net; K1 and K2 stay outside
REMAT_PER_STEP = {"K1": 4, "K2": 1, "K3": 8, "K4": 5, "K5": 4, "K6": 4}
TRAINER_REMAT_PER_STEP = {**REMAT_PER_STEP, "K7": 2 * FUSED_ESTIMATOR, "K7b": FUSED_ESTIMATOR}
# a forward with batched_pyramid: K3 on both frames in one call a level
BATCHED_PER_FORWARD = {"K1": 4, "K2": 1, "K3": 2}
# the legacy PWCNet: K2 at all five levels of a forward, K4 at all five of a backward
LEGACY_PER_FORWARD = {"K2": 5}
LEGACY_PER_BACKWARD = {"K4": 5}
# the [converge] phase: the SyntheticFlow proof of pwcnet_tpu_torch/train_lib/convergence.py
# from the JAX proof's own init, PRNGKey(CONVERGE_KEY) (tests/test_convergence.py), drawn by the
# port's prng; the SHA-1 of those parameters (convergence.params_sha1), which
# tests/test_torch_init.py computes from the JAX package's init
CONVERGE_KEY = 0
CONVERGE_INIT_SHA1 = "9142294aa9ef8f8fabda8c4f543b921365c304b1"
# a step of its 3-level model with 2 fused pyramid levels: K2 at level 0, K1 at level 1, K3 on
# both frames' two finest levels; backward K4 behind K2 and K1, K5 behind K1, K6 behind each K3
CONVERGE_PER_STEP = {"K1": 1, "K2": 1, "K3": 4, "K4": 2, "K5": 1, "K6": 4}
CONVERGE_REMAT_PER_STEP = {**CONVERGE_PER_STEP, "K3": 8}  # the backward reruns K3
REMAT_BATCHES = (8, 32)  # the [remat] phase's timed batches
CHAIRS_SAMPLES = 200  # 180 train (22 batches of 8) and 20 val (2 batches) by the 1-in-10 split
CHAIRS_HW = (384, 512)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores
KERNEL_INFO = {
    "K1": ("warped_cost_volume", "pwcnet_tpu_torch/csrc/warped_cv.cu",
           "pwcnet_tpu/ops/pallas/warped_cv.py:728"),
    "K2": ("cost_volume", "pwcnet_tpu_torch/csrc/cost_volume.cu",
           "pwcnet_tpu/ops/pallas/cost_volume.py:312"),
    "K3": ("pyramid_level_fused", "pwcnet_tpu_torch/csrc/pyramid_conv.cu",
           "pwcnet_tpu/ops/pallas/pyramid_conv.py:938"),
    "K4": ("cost_volume_bwd", "pwcnet_tpu_torch/csrc/cost_volume_bwd.cu",
           "pwcnet_tpu/ops/pallas/cost_volume.py:829"),
    "K5": ("warp_bwd", "pwcnet_tpu_torch/csrc/warp_bwd.cu",
           "pwcnet_tpu/ops/pallas/warped_cv.py:594"),
    "K6": ("pyramid_level_bwd", "pwcnet_tpu_torch/csrc/pyramid_conv_bwd.cu",
           "pwcnet_tpu/ops/pallas/pyramid_conv.py:783"),
    "K7": ("estimator_chain_fused", "pwcnet_tpu_torch/csrc/estimator_conv.cu",
           "pwcnet_tpu/ops/pallas/estimator_conv.py:740"),
    "K7b": ("estimator_chain_bwd", "pwcnet_tpu_torch/csrc/estimator_conv_bwd.cu",
            "pwcnet_tpu/ops/pallas/estimator_conv.py:614"),
    "K8": ("cost_volume_hpad", "pwcnet_tpu_torch/csrc/cost_volume.cu",
           "pwcnet_tpu/ops/pallas/cost_volume.py:922"),
    "K8b": ("cost_volume_hpad_bwd", "pwcnet_tpu_torch/csrc/cost_volume_bwd.cu",
            "pwcnet_tpu/ops/pallas/cost_volume.py:955"),
    "K9": ("warped_cost_volume_global", "pwcnet_tpu_torch/csrc/warped_cv.cu",
           "pwcnet_tpu/ops/pallas/warped_cv.py:813"),
    "K9b": ("warped_rows_bwd", "pwcnet_tpu_torch/csrc/warp_bwd.cu",
            "pwcnet_tpu/ops/pallas/warped_cv.py:888"),
}
SHARD_KERNELS = ("K8", "K8b", "K9", "K9b")
# R1, RAFT's correlation lookup (no TPU kernel: the JAX package has no RAFT), checked and timed at the
# RAFT cell's 1/8 grid of 448x1024 frames; 32 launches a RAFT(iters=32) forward
RAFT_GRID = (56, 128)
# R2 and R3, RAFT's update epilogues and GRU gates (no TPU kernel either): R2 after each conv of an update,
# (conv, its channels, the channels of the buffer it writes, the slot's first channel, the slots written;
# a buffer as wide as the slot is a standalone tensor), then flow_head.conv2's coordinate update; R3 twice a
# GRU pass. 7 R2 and 4 R3 launches an update
RAFT_EPILOGUES = (("convc1", 256, 256, 0, 1), ("convc2", 192, 256, 0, 1), ("convf1", 128, 128, 0, 1),
                  ("convf2", 64, 256, 192, 1), ("conv", 126, 384, 256, 2), ("flow_head.conv1", 256, 256, 0, 1))
RAFT_PER_FORWARD = {"R1": 32, "R2": 7 * 32, "R3": 4 * 32}
SHARDS = 2
# per rank and forward at 448x1024 over 2 shards with use_fused=False or the nearest warp:
# level 0 (7 rows) whole through K2, levels 1-4 warped by the guard and correlated by K8,
# K3 on both frames' two finest levels per shard; no K1, no K9
SPATIAL_UNFUSED_PER_FORWARD = {"K2": 1, "K3": 4, "K8": 4}
# per rank and dispatch of the sharded predict_sequence (fused, bilinear): K9 at levels 1-4
SPATIAL_SEQ_PER_DISPATCH = {"K2": 1, "K3": 4, "K9": 4}
SPATIAL_OPTIONS = {"unfused": {"use_fused": False}, "nearest": {"warp_type": "nearest"}}
# (frame H, W) of the sharded paths: serving, training, and the frame whose
# level 0 holds 8 rows a shard (K8)
SPATIAL_SERVE_HW = (448, 1024)
SPATIAL_K8_HW = (1024, 1024)
# per frame: the whole level (H, W, C) of each sharded warped level (K9) and of level 0 (K8)
K9_SERVE = K1_SHAPES
K9_TRAIN = K1_TRAIN
K8_FRAME = ((16, 16, 192),)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ inputs
def k1_inputs(torch, b, h, w, c, dtype, device, gen):
    f0 = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    f1 = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    # flows of a few pixels, some far out of the frame: every clamp is hit
    flow = torch.randn((b, h, w, 2), generator=gen, device=device) * 3.0
    flow[:, ::7, ::5] *= 20.0
    return f0, f1, flow.to(dtype)


def k2_inputs(torch, b, h, w, c, dtype, device, gen):
    f0 = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    f1 = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    return f0, f1


def k3_inputs(torch, b, h, w, cin, c, dtype, device, gen):
    x = torch.rand((b, h, w, cin), generator=gen, device=device).to(dtype)

    def conv(ci):
        k = torch.randn((c, ci, 3, 3), generator=gen, device=device) / (9.0 * ci) ** 0.5
        return k.to(dtype), (0.1 * torch.randn((c,), generator=gen, device=device)).to(dtype)

    (k1, b1), (k2, b2), (k3, b3) = conv(cin), conv(c), conv(c)
    return x, k1, b1, k2, b2, k3, b3


def k7_inputs(torch, b, h, w, cin, dtype, device, gen):
    """xin and the chain's k1, b1, .., k6, b6 (OIHW, scaled by fan-in so
    that every activation stays O(1))."""
    xin = torch.randn((b, h, w, cin), generator=gen, device=device).to(dtype)
    kbs = []
    for c in EST_COUTS:
        kbs.append((torch.randn((c, cin, 3, 3), generator=gen, device=device) / (9.0 * cin) ** 0.5).to(dtype))
        kbs.append((0.1 * torch.randn((c,), generator=gen, device=device)).to(dtype))
        cin = c
    return xin, kbs


# ------------------------------------------------------------ bounds
def bound(dtype_name, n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_work(b, h, w, c, s):
    px = b * h * w
    return px * (2 * c + 2 + TAPS) * s, px * (2 * c * TAPS + 9 * c + 2 * TAPS)


def k2_work(b, h, w, c, s):
    px = b * h * w
    return px * (2 * c + TAPS) * s, px * (2 * c * TAPS + 2 * TAPS)


def k3_work(b, h, w, cin, c, s):
    out_px = b * (h // 2) * (w // 2)
    n_bytes = (b * h * w * cin + out_px * c + 9 * c * (cin + 2 * c) + 3 * c) * s
    return n_bytes, out_px * c * (2 * 9 * (cin + 2 * c) + 3 * 3)


def k4_work(b, h, w, c, s):
    # reads g, out (81 taps) and f0, f1; writes df0, df1
    px = b * h * w
    return px * (2 * TAPS + 4 * c) * s, px * (4 * c * TAPS + 3 * TAPS)


def k5_work(b, h, w, c, s):
    # reads g and f1 once, reads the flow; writes df1 and dflow
    px = b * h * w
    return px * (3 * c + 4) * s, px * c * 14


def warp_bwd_design_bytes(work, g_elems, df1_elems, s):
    """K5's and K9b's traffic beyond the function's bytes (``work``'s), which
    their fixed-point design adds: phase 0's second read of g, and the int64
    scratch written, reduced into and read back, 16 bytes an element of df1.
    Reported beside ``bound_ms`` as ``design_bound_ms``; not in the bound."""
    return work[0] + g_elems * s + df1_elems * 16


def k6_work(b, h, w, cin, c, s, need_dx):
    # reads g, out, s1, s2 and the kernels; writes gz1..gz3 and dx
    out_px = b * (h // 2) * (w // 2)
    n_bytes = (7 * out_px * c + 9 * c * (cin + 2 * c) + (b * h * w * cin if need_dx else 0)) * s
    return n_bytes, out_px * c * (2 * 2 * 9 * c + (2 * 9 * cin if need_dx else 0) + 3)


def k7_work(b, h, w, cin, s, backward):
    """The chain: 2 x 9 x sum(Cin_i x Cout_i) operations per pixel either way.
    Forward (training): reads xin, writes s1..s5 and the flow. Backward:
    reads both cotangents and s1..s5, writes gz1..gz5 and dxin."""
    px = b * h * w
    chans = (cin,) + EST_COUTS
    macs = sum(ci * co for ci, co in zip(chans, chans[1:]))
    acts = sum(EST_COUTS[:5])
    per_px = (2 + EST_COUTS[4] + 2 * acts + cin) if backward else (cin + acts + 2)
    return (px * per_px + 9 * macs) * s, px * 2 * 9 * macs


# ------------------------------------------------------------ timing
def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cudnn_level(torch, F, x_nchw, k1, b1, k2, b2, k3, b3):
    """K3's library yardstick: the cuDNN 3-conv chain in the model dtype."""
    y = F.pad(x_nchw, (0, 1, 0, 1))
    y = F.leaky_relu(F.conv2d(y, k1, b1, stride=2), 0.1)
    y = F.leaky_relu(F.conv2d(y, k2, b2, padding=1), 0.1)
    return F.leaky_relu(F.conv2d(y, k3, b3, padding=1), 0.1)


def grid_sample_bwd(torch, f1, flow, g, row0=0):
    """K5's and K9b's library yardstick: a call of
    ``aten::grid_sampler_2d_backward`` (bilinear, border, align_corners=True)
    on the NHWC tensors viewed as NCHW, the sample ``(x + fx, y + row0 + fy)``
    mapped to [-1, 1] once, outside the call. It computes the plain
    versions' function (tests/test_torch_warp_bwd.py, float32); in bf16 it
    sums ``grad_input`` with bf16 atomics, so it is a yardstick of time, not
    of accuracy."""
    b, hf, w, _ = f1.shape
    ho = flow.shape[1]
    fl = flow.float()
    x = torch.arange(w, device=f1.device).view(1, 1, w) + fl[..., 0]
    y = torch.arange(ho, device=f1.device).view(1, ho, 1) + row0 + fl[..., 1]
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (hf - 1) * 2 - 1], -1).to(f1.dtype)
    gi, fi = g.permute(0, 3, 1, 2), f1.permute(0, 3, 1, 2)
    return lambda: torch.ops.aten.grid_sampler_2d_backward(gi, fi, grid, 0, 1, True, [True, True])


def library_ms(torch, fn, what):
    """``cuda_ms`` of a library yardstick, or None (logged) where the
    library does not take the dtype."""
    try:
        return cuda_ms(torch, fn)
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  {what}: library call none ({str(exc).splitlines()[0][:120]})")
        return None


def device_ops(torch, fn, n=3, tries=3):
    """The device operations (kernels, memsets, copies) one call of ``fn``
    makes, by torch.profiler over ``n`` calls: ``(per call, {name: launches
    a call})``; a trace that caught no device event, or lost one (a count
    that is no multiple of ``n``: the first trace of a process once read a
    one-kernel call at 2 of 3), is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names and len(names) % n == 0:
            break
    counts = {}
    for nm in sorted(nm.split("(")[0] for nm in names):
        counts[nm] = counts.get(nm, 0) + 1
    return len(names) / n, {nm: c / n for nm, c in counts.items()}


# ------------------------------------------------------------ phases
def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def make_compare(torch, errs):
    """compare(kid, label, got, want, dtype, ulps): fail unless the kernel's
    result is finite, of the plain version's shape and within tolerance.

    Tolerances: float32 (TF32 off) differs only in summation order (K5's
    fixed point adds under 1e-9 of its scale): 1e-5 + 1e-5 * scale.
    bfloat16 results are rounded from float32 sums, so the two can land one
    bf16 ulp apart, and more where a stage reads a rounded intermediate
    that itself flipped: ``ulps`` bf16 ulps of the result's scale
    (scale * ulps / 128), where scale = max |plain result|. ``f32_rel``
    widens the float32 bound for a quantity derived from a kernel's result
    by a long sum.
    """

    def compare(kid, label, got, want, dtype, ulps=2, f32_rel=1e-5):
        want32 = want.float()
        scale = want32.abs().max().item()
        err = (got.float() - want32).abs().max().item()
        tol = 1e-5 + f32_rel * scale if dtype == torch.float32 else scale * ulps / 128.0
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and torch.isfinite(got.float()).all().item() and err <= tol)
        log(f"  {kid} {label}: max_abs_err {err:.3e} (tol {tol:.3e}, scale {scale:.3e})")
        require(ok, f"{kid} {label} disagrees with its plain version")
        key = dtype_name(dtype)
        errs[kid][key] = max(errs[kid].get(key, 0.0), err)

    return compare


def check_kernels(torch, device, compare, batches=(1, 8), dtypes=None):
    """K1-K3 vs their plain versions at every serving shape.

    bfloat16: K1 may also round one warped value differently (FMA
    contraction), K3 each of its two intermediate activations: 2 ulps of
    the output's scale for K1/K2, 4 for K3.
    """
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume, cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused, pyramid_level_plain
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume, warped_cost_volume_plain

    dtypes = dtypes or (torch.float32, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        for dtype in dtypes:
            for b in batches:
                for h, w, c in K1_SHAPES:
                    args = k1_inputs(torch, b, h, w, c, dtype, device, gen)
                    got = warped_cost_volume(*args, SEARCH_RANGE)
                    want = warped_cost_volume_plain(*args, SEARCH_RANGE)
                    compare("K1", f"{dtype} B={b} {h}x{w}x{c}", got, want, dtype)
                for h, w, c in K2_SHAPES:
                    args = k2_inputs(torch, b, h, w, c, dtype, device, gen)
                    compare("K2", f"{dtype} B={b} {h}x{w}x{c}",
                            cost_volume_cuda(*args, SEARCH_RANGE), cost_volume(*args, SEARCH_RANGE), dtype)
                for h, w, cin, c in K3_SHAPES + K3_EDGE:
                    args = k3_inputs(torch, b, h, w, cin, c, dtype, device, gen)
                    compare("K3", f"{dtype} B={b} {h}x{w}x{cin}->{c}",
                            pyramid_level_fused(*args), pyramid_level_plain(*args), dtype, ulps=4)
                torch.cuda.synchronize()


def check_training_kernels(torch, device, compare, batches=(1, 8), dtypes=None):
    """At every shape of the 384x448 training step: K1, K2 and K3 and the
    residuals K1 and K3 write (warped map; s1, s2) against the plain
    forward, and K4, K5, K6 against their plain versions on the same
    residuals and cotangents; K4 also at the four finer 448x1024 levels,
    where the legacy PWCNet's backward runs it.

    bfloat16 tolerances: 2 ulps of the result's scale for K4, K5 and the
    residuals (one rounding of a float32 sum on each side); 4 for K6, whose
    stages read the rounded cotangent the previous stage stored.
    K5 runs twice on the same inputs: its df1 (summed in fixed point)
    must not differ (gated at exactly 0). Returns, by dtype, that largest
    run-to-run difference relative to df1's scale.
    """
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume, cost_volume_bwd_plain
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_bwd, cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import (
        pyramid_level_bwd, pyramid_level_bwd_plain, pyramid_level_plain, pyramid_level_residuals)
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd, warped_cost_volume_residual
    from pwcnet_tpu_torch.ops.warp import bilinear_warp, warp_bwd_plain

    dtypes = dtypes or (torch.float32, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(2)
    rerun = {}

    def cotangent(like):
        return torch.randn(like.shape, generator=gen, device=device).to(like.dtype)

    with torch.inference_mode():
        for dtype in dtypes:
            for b in batches:
                for h, w, c in K1_TRAIN:
                    f0, f1, flow = k1_inputs(torch, b, h, w, c, dtype, device, gen)
                    label = f"{dtype} B={b} {h}x{w}x{c}"
                    out, f1w = warped_cost_volume_residual(f0, f1, flow, SEARCH_RANGE)
                    want_f1w = bilinear_warp(f1, flow)
                    want_out = cost_volume(f0, want_f1w, SEARCH_RANGE)
                    compare("K1", f"out {label}", out, want_out, dtype)
                    compare("K1", f"f1w {label}", f1w, want_f1w, dtype)
                    g = cotangent(want_out)
                    df0, df1w = cost_volume_bwd(f0, want_f1w, want_out, g, SEARCH_RANGE)
                    want_df0, want_df1w = cost_volume_bwd_plain(f0, want_f1w, want_out, g, SEARCH_RANGE)
                    compare("K4", f"df0 {label}", df0, want_df0, dtype)
                    compare("K4", f"df1 {label}", df1w, want_df1w, dtype)
                    df1, dflow = warp_bwd(f1, flow, want_df1w)
                    want_df1, want_dflow = warp_bwd_plain(f1, flow, want_df1w)
                    compare("K5", f"df1 {label}", df1, want_df1, dtype)
                    compare("K5", f"dflow {label}", dflow, want_dflow, dtype)
                    again = warp_bwd(f1, flow, want_df1w)[0]
                    diff = (again.float() - df1.float()).abs().max().item() / want_df1.float().abs().max().item()
                    require(diff == 0.0 and torch.equal(again, df1), f"K5 {label}: df1 differs from run to run")
                    rerun[dtype_name(dtype)] = max(rerun.get(dtype_name(dtype), 0.0), diff)
                for h, w, c in K2_TRAIN:
                    f0, f1 = k2_inputs(torch, b, h, w, c, dtype, device, gen)
                    out = cost_volume(f0, f1, SEARCH_RANGE)
                    compare("K2", f"{dtype} B={b} {h}x{w}x{c}", cost_volume_cuda(f0, f1, SEARCH_RANGE), out, dtype)
                    g = cotangent(out)
                    df0, df1 = cost_volume_bwd(f0, f1, out, g, SEARCH_RANGE)
                    want_df0, want_df1 = cost_volume_bwd_plain(f0, f1, out, g, SEARCH_RANGE)
                    compare("K4", f"df0 {dtype} B={b} {h}x{w}x{c}", df0, want_df0, dtype)
                    compare("K4", f"df1 {dtype} B={b} {h}x{w}x{c}", df1, want_df1, dtype)
                for h, w, c in K2_SHAPES[1:]:  # the legacy PWCNet's backward at 448x1024
                    f0, f1 = k2_inputs(torch, b, h, w, c, dtype, device, gen)
                    out = cost_volume(f0, f1, SEARCH_RANGE)
                    g = cotangent(out)
                    df0, df1 = cost_volume_bwd(f0, f1, out, g, SEARCH_RANGE)
                    want_df0, want_df1 = cost_volume_bwd_plain(f0, f1, out, g, SEARCH_RANGE)
                    compare("K4", f"df0 {dtype} B={b} {h}x{w}x{c} (legacy)", df0, want_df0, dtype)
                    compare("K4", f"df1 {dtype} B={b} {h}x{w}x{c} (legacy)", df1, want_df1, dtype)
                for h, w, cin, c in K3_TRAIN + K3_EDGE:
                    args = k3_inputs(torch, b, h, w, cin, c, dtype, device, gen)
                    label = f"{dtype} B={b} {h}x{w}x{cin}->{c}"
                    out, s1, s2 = pyramid_level_residuals(*args)
                    want_out, want_s1, want_s2 = pyramid_level_plain(*args, return_acts=True)
                    compare("K3", f"out {label}", out, want_out, dtype, ulps=4)
                    compare("K3", f"s1 {label}", s1, want_s1, dtype)
                    compare("K3", f"s2 {label}", s2, want_s2, dtype, ulps=4)
                    g = cotangent(want_out)
                    x, k1, _, k2, _, k3, _ = args
                    res = (x, k1, k2, k3, want_out, want_s1, want_s2, g)
                    # the training path asks for no dx at level 0 (the image) and for dx at level 1
                    for need_dx in (False, True):
                        got = pyramid_level_bwd(*res, need_dx=need_dx)
                        want = pyramid_level_bwd_plain(*res, need_dx=need_dx)
                        for name, a, e in zip(("gz1", "gz2", "gz3", "dx"), got, want):
                            if e is None:
                                require(a is None, f"K6 returned a dx nobody asked for at {label}")
                            else:
                                compare("K6", f"{name} {label} dx={need_dx}", a, e, dtype, ulps=4)
                torch.cuda.synchronize()
    log(f"  K5 df1 run to run (fixed point, gated at 0): max |diff| / max |df1| = {rerun}")
    return rerun


def time_kernels(torch, F, device, b=8, dtype=None):
    """Kernel, plain and library times at the main-path shapes, summed per
    forward; K3 also at the training step's two levels (``times`` 0)."""
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume, cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused, pyramid_level_plain
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume, warped_cost_volume_plain

    dtype = dtype or torch.bfloat16
    dname = dtype_name(dtype)
    s = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=device).manual_seed(1)
    rows = {"K1": [], "K2": [], "K3": []}
    with torch.inference_mode():
        for h, w, c in K1_SHAPES:
            a = k1_inputs(torch, b, h, w, c, dtype, device, gen)
            rows["K1"].append(dict(
                shape=f"{b}x{h}x{w}x{c}", times=1,
                ms=cuda_ms(torch, lambda: warped_cost_volume(*a, SEARCH_RANGE)),
                plain_ms=cuda_ms(torch, lambda: warped_cost_volume_plain(*a, SEARCH_RANGE)),
                library_ms=None, work=k1_work(b, h, w, c, s)))
        for i, (h, w, c) in enumerate(K2_SHAPES):  # PWCDCNet's level 0 summed; the legacy levels listed
            a = k2_inputs(torch, b, h, w, c, dtype, device, gen)
            rows["K2"].append(dict(
                shape=f"{b}x{h}x{w}x{c}" + (" (legacy)" if i else ""), times=int(i == 0),
                ms=cuda_ms(torch, lambda: cost_volume_cuda(*a, SEARCH_RANGE)),
                plain_ms=cuda_ms(torch, lambda: cost_volume(*a, SEARCH_RANGE)),
                library_ms=None, work=k2_work(b, h, w, c, s)))
        for h, w, cin, c in K3_SHAPES:
            a = k3_inputs(torch, b, h, w, cin, c, dtype, device, gen)
            x_nchw = a[0].permute(0, 3, 1, 2)  # channels_last view, as in the model
            rows["K3"].append(dict(
                shape=f"{b}x{h}x{w}x{cin}->{c}", times=2,  # both frames
                ms=cuda_ms(torch, lambda: pyramid_level_fused(*a)),
                plain_ms=cuda_ms(torch, lambda: pyramid_level_plain(*a)),
                library_ms=cuda_ms(torch, lambda: cudnn_level(torch, F, x_nchw, *a[1:])),
                work=k3_work(b, h, w, cin, c, s)))
        for h, w, cin, c in K3_TRAIN:  # the training step's levels: listed, not summed per forward
            a = k3_inputs(torch, b, h, w, cin, c, dtype, device, gen)
            x_nchw = a[0].permute(0, 3, 1, 2)
            rows["K3"].append(dict(
                shape=f"{b}x{h}x{w}x{cin}->{c} (train)", times=0,
                ms=cuda_ms(torch, lambda: pyramid_level_fused(*a)),
                plain_ms=cuda_ms(torch, lambda: pyramid_level_plain(*a)),
                library_ms=cuda_ms(torch, lambda: cudnn_level(torch, F, x_nchw, *a[1:])),
                work=k3_work(b, h, w, cin, c, s)))
    finish_rows(rows, dname)
    return rows, dname


def raft_lookup_inputs(torch, b, h, w, device, seed=0):
    """R1's inputs at RAFT's 1/8 grid (h, w): the pyramid of the product of
    seeded (B, 256, h, w) features, and coordinates of each pixel moved by a
    flow of a few pixels, every third by up to 1.5 h and w, every fifth on
    integer points, every seventh far outside every level's map."""
    from pwcnet_tpu_torch.ops.corr_lookup import corr_pyramid

    g = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn(b, 256, h, w, generator=g, device=device)
    f2 = torch.randn(b, 256, h, w, generator=g, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    coords = torch.stack([xs, ys], -1).float() + 3 * torch.randn(b, h, w, 2, generator=g, device=device)
    flat = coords.view(-1, 2)
    size = torch.tensor([w, h], device=device)
    flat[::3] += (torch.rand(flat[::3].shape, generator=g, device=device) * 3 - 1.5) * size
    flat[::5] = flat[::5].round()
    flat[::7] = torch.tensor([-9.0 * w, 9.0 * h], device=device)
    return corr_pyramid(f1, f2, 4), coords


def check_raft_lookup(torch, device):
    """R1 against ``lookup_plain`` on the card at the RAFT cell's 1/8 grid
    (448x1024 frames: 56x128), B=1 and 16: float32, 1e-5 + 1e-5 of the
    maps' scale (the plain path samples through cuDNN's grid sampler, which
    rounds positions and the blend its own way); one launch a call; exact
    zeros where every window misses its map. Returns the largest error."""
    from pwcnet_tpu_torch.ops.corr_lookup import lookup, lookup_plain
    from pwcnet_tpu_torch.ops.cuda.corr_lookup import corr_lookup_cuda

    worst = 0.0
    for b in (1, 16):
        pyramid, coords = raft_lookup_inputs(torch, b, RAFT_GRID[0], RAFT_GRID[1], device, seed=b)
        before = corr_lookup_cuda.launches
        with torch.inference_mode():
            got, want = lookup(pyramid, coords), lookup_plain(pyramid, coords)
        torch.cuda.synchronize()
        scale = max(float(m.abs().max()) for m in pyramid)
        err = float((got - want).abs().max())
        far = got.permute(0, 2, 3, 1).reshape(-1, got.shape[1])[::7]
        log(f"  R1 corr_lookup B={b} 56x128: max_abs_err {err:.3e} (tol {1e-5 + 1e-5 * scale:.3e}, maps' scale "
            f"{scale:.3e}); {100 * float((want == 0).float().mean()):.1f}% of the plain taps zero")
        require(corr_lookup_cuda.launches == before + 1, "R1 is one launch a lookup")
        require(got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last),
                "R1's output is the plain version's shape, channels_last")
        require(err <= 1e-5 + 1e-5 * scale, f"R1 at B={b} disagrees with lookup_plain")
        require(bool((far == 0).all()), "R1 reads exact zeros where every window misses its map")
        worst = max(worst, err)
    # the plain version on the CPU rounds the taps' positions as R1 does: the first frame within 1e-6 of the scale
    hw = RAFT_GRID[0] * RAFT_GRID[1]
    cpu = lookup_plain([m[:hw].cpu() for m in pyramid], coords[:1].cpu())
    err = float((got[:1].cpu() - cpu).abs().max())
    log(f"  R1 corr_lookup 56x128, the first frame against lookup_plain on the CPU: max_abs_err {err:.3e} "
        f"(tol {1e-6 * scale:.3e}), {100 * float((got[:1].cpu() == cpu).float().mean()):.2f}% of the taps equal")
    require(err <= 1e-6 * scale, "R1 disagrees with lookup_plain on the CPU")
    return worst


def raft_update_inputs(torch, b, c, width, at, dtype, device, seed):
    """A conv's output (B, c, 56, 128) of a few units and its bias, and a
    zeroed channels_last buffer of ``width`` channels whose slot
    ``[at, at + c)`` the epilogue writes."""
    from pwcnet_tpu_torch.models.conv import to_nchw

    h, w = RAFT_GRID
    g = torch.Generator(device=device).manual_seed(seed)
    x = to_nchw(3 * torch.randn(b, h, w, c, generator=g, device=device)).to(dtype)
    bias = torch.randn(c, generator=g, device=device).to(dtype)
    return x, bias, to_nchw(torch.zeros(b, h, w, width, dtype=dtype, device=device))


def raft_gate_inputs(torch, b, dtype, device, seed):
    """The GRU's three pre-activations (B, 128, 56, 128), their biases, the
    buffers A and Q (384 channels) with ``h`` in A's first 128, and ``z``."""
    from pwcnet_tpu_torch.models.conv import to_nchw

    h, w = RAFT_GRID
    g = torch.Generator(device=device).manual_seed(seed)
    pre = [to_nchw(3 * torch.randn(b, h, w, 128, generator=g, device=device)).to(dtype) for _ in range(3)]
    biases = [torch.randn(128, generator=g, device=device).to(dtype) for _ in range(3)]
    a, q = (to_nchw(torch.zeros(b, h, w, 384, dtype=dtype, device=device)) for _ in range(2))
    a[:, :128].copy_(torch.tanh(torch.randn(b, 128, h, w, generator=g, device=device)))
    z = to_nchw(torch.empty(b, h, w, 128, dtype=dtype, device=device))
    return pre, biases, a, q, z


def check_raft_update(torch, device):
    """R2 and R3 against their plain versions on the card at the RAFT cell's
    1/8 grid (448x1024 frames: 56x128), B=1 and 16, bf16 and float32: R2
    with ReLU at each epilogue of an update (the motion features into A's
    and Q's slots in one launch) and with each activation into a
    128-channel slot of a 384-channel buffer, no other channel touched; the
    coordinates' update bit for bit; R3's two gates (gate 2 with the
    contiguous ``net``); one launch a call. Tolerances as ``make_compare``'s.
    Returns the largest errors by kernel and dtype."""
    from pwcnet_tpu_torch.ops import raft_update as ops
    from pwcnet_tpu_torch.ops.cuda.raft_update import conv_epilogue_cuda, gru_gate_zr_cuda

    errs = {"R2": {}, "R3": {}}
    compare = make_compare(torch, errs)
    h, w = RAFT_GRID
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for b in (1, 16):
                cases = [(name, c, width, at, slots, "relu") for name, c, width, at, slots in RAFT_EPILOGUES]
                cases += [(f"into A's h slot, {act}", 128, 384, 128, 1, act) for act in ops.ACTS if act != "relu"]
                for k, (name, c, width, at, slots, act) in enumerate(cases):
                    x, bias, buf = raft_update_inputs(torch, b, c, width, at, dtype, device, seed=k)
                    bufs = [buf] + [buf.clone(memory_format=torch.channels_last) for _ in range(slots - 1)]
                    want = torch.empty_like(x)
                    ops.conv_epilogue_plain(x, bias, act, want)
                    before = conv_epilogue_cuda.launches
                    ops.conv_epilogue(x, bias, act, *[t[:, at:at + c] for t in bufs])
                    torch.cuda.synchronize()
                    require(conv_epilogue_cuda.launches == before + 1, "R2 is one launch a call")
                    for t in bufs:
                        compare("R2", f"{name} B={b} {dtype_name(dtype)}", t[:, at:at + c], want, dtype)
                        require(not t[:, :at].any() and not t[:, at + c:].any(), "R2 writes its slot alone")
                delta, bias, a = raft_update_inputs(torch, b, 2, 384, 382, dtype, device, seed=99)
                coords = torch.rand(b, h, w, 2, device=device) * torch.tensor([w, h], device=device)
                plain, flow = coords.clone(), torch.empty_like(delta)
                ops.coords_update(delta, bias, coords, a[:, 382:])
                ops.coords_update_plain(delta, bias, plain, flow)
                torch.cuda.synchronize()
                require(torch.equal(coords, plain) and torch.equal(a[:, 382:], flow),
                        "R2's coordinate update is not the plain version's bits")
                pre, (bz, br, bq), a, q, z = raft_gate_inputs(torch, b, dtype, device, seed=b)
                a2, q2 = a.clone(memory_format=torch.channels_last), q.clone(memory_format=torch.channels_last)
                z2, net = torch.empty_like(z), torch.empty_like(z)
                before = gru_gate_zr_cuda.launches
                ops.gru_gate_zr(pre[0], pre[1], bz, br, a[:, :128], q[:, :128], z)
                ops.gru_gate_zr_plain(pre[0], pre[1], bz, br, a2[:, :128], q2[:, :128], z2)
                label = f"B={b} {dtype_name(dtype)}"
                compare("R3", f"gate z, r: z {label}", z, z2, dtype)
                compare("R3", f"gate z, r: r h {label}", q[:, :128], q2[:, :128], dtype)
                ops.gru_gate_h(pre[2], bq, z2, a[:, :128], net)
                ops.gru_gate_h_plain(pre[2], bq, z2, a2[:, :128])
                torch.cuda.synchronize()
                require(gru_gate_zr_cuda.launches == before + 2, "R3 is one launch a gate")
                compare("R3", f"gate h {label}", a[:, :128], a2[:, :128], dtype)
                require(torch.equal(net, a[:, :128]), "R3's second gate writes net as h")
                require(torch.equal(a[:, 128:], a2[:, 128:]) and not q[:, 128:].any(), "R3 writes its slots alone")
    log(f"  R2 coordinate update bit for bit at B=1, 16 in bf16 and float32; R2 / R3 largest errors: {errs}")
    return errs


def check_raft_forward_launches(torch, device, b=1):
    """One seeded ``RAFT(iters=32)`` forward in bf16 on 448x1024 frames with
    the launch counters reset just before it: R1 launches once an update, R2
    seven times (after each conv but the GRU's six), R3 four times (two
    gates a GRU pass): ``RAFT_PER_FORWARD``, and no other hand kernel runs.
    Returns the counts."""
    from pwcnet_tpu_torch.models.raft import RAFT
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.train_lib.step import make_forward

    torch.manual_seed(0)
    model = RAFT(iters=32).to(device, torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(0)
    x0 = torch.rand(b, 8 * RAFT_GRID[0], 8 * RAFT_GRID[1], 3, generator=g, device=device)
    reset_launch_counts()
    flow, _ = make_forward(model)(x0, x0.roll(3, 2))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  R1-R3 in one RAFT(iters=32) bf16 forward, B={b} 448x1024: "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    require({k: v for k, v in counts.items() if v} == RAFT_PER_FORWARD,
            f"RAFT(iters=32) launches R1-R3 {RAFT_PER_FORWARD} a forward and no other hand kernel")
    require(bool(flow.isfinite().all()), "RAFT's flow is finite")
    del model, flow
    return {k: counts[k] for k in RAFT_PER_FORWARD}


def time_raft_update(torch, device, b=16):
    """R2 and R3 at the RAFT cell's shape (448x1024 frames, B=16), bf16, each
    call of one update: ms a call (CUDA events) against its bound (the
    bytes each element read once and each result written once, at 3.35
    TB/s) and the plain version's ms; one update's sum; each kernel's
    registers, local memory and resident blocks an SM."""
    import ctypes

    from pwcnet_tpu_torch.ops import raft_update as ops
    from pwcnet_tpu_torch.ops.cuda import _build

    info = _build.load("raft_update").pwc_raft_update_info
    info.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    attrs = []
    for which, label in enumerate(("epilogue ReLU x8", "gate z, r x8", "gate h x8", "coordinates")):
        vals = [ctypes.c_int(0) for _ in range(3)]
        require(info(which, *[ctypes.byref(v) for v in vals]) == 0, "query of R2's / R3's attributes")
        attrs.append(f"{label}: {vals[0].value} registers, {vals[1].value} B local, {vals[2].value} blocks an SM")
    log("  R2 / R3 bf16: " + "; ".join(attrs))
    h, w = RAFT_GRID
    px, s = b * h * w, 2
    dtype = torch.bfloat16
    rows = {}

    def row(name, n_bytes, kernel, plain, times=1):
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain, iters=5)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "times": times}
        log(f"  {name} bf16 {b}x{h}x{w}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({n_bytes / 1e6:.1f} MB; {100 * bound_ms / ms:.1f}% of it)")

    with torch.inference_mode():
        for k, (name, c, width, at, slots) in enumerate(RAFT_EPILOGUES):
            x, bias, buf = raft_update_inputs(torch, b, c, width, at, dtype, device, seed=k)
            outs = [buf[:, at:at + c]] + [buf.clone(memory_format=torch.channels_last)[:, at:at + c]
                                          for _ in range(slots - 1)]
            row(f"R2 {name}", px * c * (1 + slots) * s, lambda: ops.conv_epilogue(x, bias, "relu", *outs),
                lambda: ops.conv_epilogue_plain(x, bias, "relu", *outs))
        delta, bias, a = raft_update_inputs(torch, b, 2, 384, 382, dtype, device, seed=99)
        q, flow = a.clone(memory_format=torch.channels_last), torch.empty_like(delta)
        coords = torch.zeros(b, h, w, 2, device=device)
        flows = (a[:, 382:], q[:, 382:], flow)
        row("R2 flow_head.conv2 (coordinates)", px * (2 * s + 16 + 3 * 2 * s),
            lambda: ops.coords_update(delta, bias, coords, *flows),
            lambda: ops.coords_update_plain(delta, bias, coords, *flows))
        pre, (bz, br, bq), a, q, z = raft_gate_inputs(torch, b, dtype, device, seed=b)
        net = torch.empty_like(z)
        zr = (pre[0], pre[1], bz, br, a[:, :128], q[:, :128], z)
        row("R3 gate z, r", px * 128 * 5 * s, lambda: ops.gru_gate_zr(*zr), lambda: ops.gru_gate_zr_plain(*zr),
            times=2)
        row("R3 gate h", px * 128 * 4 * s, lambda: ops.gru_gate_h(pre[2], bq, z, a[:, :128]),
            lambda: ops.gru_gate_h_plain(pre[2], bq, z, a[:, :128]))
        row("R3 gate h with net", px * 128 * 5 * s, lambda: ops.gru_gate_h(pre[2], bq, z, a[:, :128], net),
            lambda: ops.gru_gate_h_plain(pre[2], bq, z, a[:, :128], net))
    total = {k: sum(r[k] * r["times"] for r in rows.values()) for k in ("ms", "plain_ms", "bound_ms")}
    log(f"  R2 + R3, one update at B={b}: kernels {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({100 * total['bound_ms'] / total['ms']:.1f}% of it)")
    return {"calls": rows, "update": total, "shape": f"{b}x{h}x{w}", "attributes": attrs}


def time_raft_lookup(torch, device, b=16):
    """R1 at the RAFT cell's shape (448x1024 frames, B=16, one update's
    lookup): ms a call (CUDA events), its bound (``benchmark.raft_work.
    lookup_work``: each level's 10x10 float32 window read and 81 outputs
    written once, at 3.35 TB/s), the plain version's ms; and the kernel's
    registers, shared memory and resident blocks an SM."""
    import ctypes
    import json as _json

    from benchmark import raft_work
    from pwcnet_tpu_torch.ops.corr_lookup import lookup, lookup_plain
    from pwcnet_tpu_torch.ops.cuda import _build

    cfg = _json.loads(open(os.path.join("benchmark", "configs", "raft.json")).read())
    n_bytes, n_ops = raft_work.lookup_work(cfg, 8 * RAFT_GRID[0], 8 * RAFT_GRID[1])
    bound_ms, bound_by = bound("float32", b * n_bytes, b * n_ops)
    info = _build.load("corr_lookup").pwc_corr_lookup_info
    vals = [ctypes.c_int(0) for _ in range(4)]
    info.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    require(info(*[ctypes.byref(v) for v in vals]) == 0, "query of R1's attributes")
    regs, local, smem, blocks = (v.value for v in vals)
    pyramid, coords = raft_lookup_inputs(torch, b, RAFT_GRID[0], RAFT_GRID[1], device)
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: lookup(pyramid, coords))
        plain_ms = cuda_ms(torch, lambda: lookup_plain(pyramid, coords), iters=5)
    log(f"  R1 corr_lookup float32 {b}x56x128 (448x1024 frames): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f}% of it); {regs} registers, {local} B "
        f"local, {smem} B shared a block, {blocks} blocks of 256 an SM")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "registers": regs,
            "local_bytes": local, "blocks_per_sm": blocks, "shape": f"{b}x56x128"}


GMFLOW_GRID = (56, 128)  # the GMFlow cell's 1/8 grid of 448x1024 frames: 7168 keys


def global_attention_inputs(torch, b, h, w, device, seed=0, flow=False, spread=1.0):
    """R4's inputs: bf16 q, k (b, h w, 128) with scores of standard
    deviation ``spread``, and the pixel grid expanded over the batch (batch
    stride 0) or a smooth signed flow of up to about 40 px, float32."""
    from pwcnet_tpu_torch.models.gmflow import coords_grid

    gen = torch.Generator(device=device).manual_seed(seed)
    n = h * w
    q = (spread * torch.randn((b, n, 128), generator=gen, device=device)).to(torch.bfloat16)
    k = torch.randn((b, n, 128), generator=gen, device=device).to(torch.bfloat16)
    grid = coords_grid(h, w, device)
    if not flow:
        return q, k, grid.expand(b, n, 2)
    phase = torch.rand((b, 1, 2), generator=gen, device=device) * 2 * math.pi
    waves = torch.sin(2 * math.pi * grid / torch.tensor([w, h], device=device) + phase)
    v = torch.tensor([12.0, -7.0], device=device) + torch.tensor([25.0, 20.0], device=device) * waves
    return q, k, v + torch.randn((b, n, 2), generator=gen, device=device)


def global_attention_f64(torch, q, k, v):
    """float64 ``softmax(q k^T / sqrt(128)) v``, a batch row at a time."""
    return torch.stack([torch.softmax(qi @ ki.T / math.sqrt(128), -1) @ vi
                        for qi, ki, vi in zip(q.double(), k.double(), v.double())])


def global_attention_library(torch, q, k, v):
    """The float32 memory-efficient attention that R4 replaced (q, k widened,
    v padded to 8 columns): the yardstick, never on the port's path."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(q.float()[:, None], k.float()[:, None], F.pad(v.float(), (0, 6))[:, None],
                                             scale=1 / math.sqrt(128))
    return out[:, 0, :, :2]


def check_global_attention(torch, device):
    """R4 against the float64 product on the card at the GMFlow cell's 7168
    keys, B=2 (the grid and a flow as the value, scores of standard
    deviation 1 and 4) and at a ragged 54x126 grid, B=1: within 4e-6 of max
    |ref|, and at 7168 keys no worse than twice the float32 memory-efficient
    call. One launch a call. Returns the largest error over max |ref|."""
    from pwcnet_tpu_torch.ops.attention import global_attention
    from pwcnet_tpu_torch.ops.cuda.global_attention import global_attention_cuda

    worst = 0.0
    for (b, h, w), flow, spread in [((2, *GMFLOW_GRID), False, 1.0), ((2, *GMFLOW_GRID), True, 1.0),
                                    ((2, *GMFLOW_GRID), False, 4.0), ((2, *GMFLOW_GRID), True, 4.0),
                                    ((1, 54, 126), False, 2.0), ((1, 54, 126), True, 2.0)]:
        q, k, v = global_attention_inputs(torch, b, h, w, device, seed=h + int(spread), flow=flow, spread=spread)
        before = global_attention_cuda.launches
        with torch.inference_mode():
            got = global_attention(q, k, v)
            lib = global_attention_library(torch, q, k, v)
        torch.cuda.synchronize()
        require(global_attention_cuda.launches == before + 1, "R4 is one launch a call")
        ref = global_attention_f64(torch, q, k, v)
        scale = float(ref.abs().max())
        err, lib_err = float((got - ref).abs().max()), float((lib - ref).abs().max())
        log(f"  R4 global_attention B={b} {h}x{w} value {'flow' if flow else 'grid'} score std {spread}: max_abs_err "
            f"{err:.3e} ({err / scale:.2e} of max |ref| {scale:.2f}; memory-efficient float32 {lib_err:.3e})")
        require(err <= 4e-6 * scale, f"R4 at B={b} {h}x{w} is not within 4e-6 of the float64 product")
        if h * w == GMFLOW_GRID[0] * GMFLOW_GRID[1]:
            require(err <= 2 * lib_err, "R4 is more than twice as far from the float64 product as the library")
        worst = max(worst, err / scale)
    return worst


def time_global_attention(torch, device, b=16):
    """R4 at the GMFlow cell's shape (448x1024 frames, B=16, 7168 keys; the
    grid as the value): ms a call (CUDA events), its bound (the bf16
    product's 2 B N^2 128 operations at 989 TFLOP/s, or B N^2 exponentials
    at 16 a clock an SM at the card's largest SM clock, whichever is
    longer), the plain version's ms (the scores written out in float32)
    and the float32 memory-efficient call's; the kernel's registers, shared
    memory and resident blocks an SM."""
    import ctypes

    from pwcnet_tpu_torch.ops.attention import _plain, global_attention
    from pwcnet_tpu_torch.ops.cuda import _build

    n = GMFLOW_GRID[0] * GMFLOW_GRID[1]
    info = _build.load("global_attention").pwc_global_attention_info
    vals = [ctypes.c_int(0) for _ in range(4)]
    info.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    require(info(*[ctypes.byref(v) for v in vals]) == 0, "query of R4's attributes")
    regs, local, smem, blocks = (v.value for v in vals)
    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tensor_ms = 2 * b * n * n * 128 / PEAK_OPS["bfloat16"] * 1e3
    exp_ms = b * n * n / (16 * sms * clock_mhz * 1e6) * 1e3
    q, k, v = global_attention_inputs(torch, b, *GMFLOW_GRID, device)
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: global_attention(q, k, v))
        plain_ms = cuda_ms(torch, lambda: _plain(q, k, v, None, 1 / math.sqrt(128), torch.float32), iters=3, warmup=1)
        library_ms = cuda_ms(torch, lambda: global_attention_library(torch, q, k, v), iters=5, warmup=1)
    bound_ms = max(tensor_ms, exp_ms)
    log(f"  R4 global_attention {b}x{n} keys (448x1024 frames): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"memory-efficient float32 {library_ms:.4f} ms; bound {bound_ms:.4f} ms (bf16 product {tensor_ms:.4f} ms, "
        f"exponentials {exp_ms:.4f} ms at {clock_mhz:.0f} MHz on {sms} SMs; {100 * bound_ms / ms:.1f}% of it); "
        f"{regs} registers, {local} B local, {smem} B shared a block, {blocks} blocks of 288 an SM")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "tensor_bound_ms": tensor_ms, "exp_bound_ms": exp_ms, "registers": regs, "local_bytes": local,
            "blocks_per_sm": blocks, "shape": f"{b}x{n}"}


GMA_GRID = (136, 240)  # the GMA cell's 1/8 grid of 1088x1920 frames: 32640 keys
GMA_BATCH = 4
GMA_PER_FORWARD = {**RAFT_PER_FORWARD, "R5": 1, "R6": 32}  # at 448x1024, B=1: one block of score rows


def attention_softmax_inputs(torch, device, spread, seed):
    """R5's inputs at the GMA cell's shape: the float32 scores of the second
    block of rows (``score_rows(4, 32640)`` rows a batch element) from bf16
    q, k of 128 channels (cuBLAS, as ``global_softmax`` makes them), scores
    of standard deviation about ``spread``; the block's first row and rows."""
    from pwcnet_tpu_torch.ops.attention import score_rows

    b, n = GMA_BATCH, GMA_GRID[0] * GMA_GRID[1]
    rows = score_rows(b, n)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = (spread * torch.randn((b, rows, 128), generator=gen, device=device)).to(torch.bfloat16)
    k = torch.randn((b, n, 128), generator=gen, device=device).to(torch.bfloat16)
    r0 = rows  # the second block
    return torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32), r0, rows


def check_attention_softmax(torch, device):
    """R5 against the plain softmax (``torch.softmax`` of the scaled float32
    scores) on the card at the GMA cell's B=4 and 32640 keys: one block of
    ``score_rows`` rows written into the strided rows of a (B, N, N) bf16
    tensor at its second block, scores of standard deviation 1 and 8: each
    probability within one bf16 rounding of the plain one (1e-7 more), every
    other row untouched, one launch a call. Returns the largest error less
    that rounding."""
    from pwcnet_tpu_torch.ops.cuda.global_attention import attention_softmax_cuda

    b, n = GMA_BATCH, GMA_GRID[0] * GMA_GRID[1]
    scale = 1 / math.sqrt(128)
    p = torch.zeros((b, n, n), dtype=torch.bfloat16, device=device)
    worst = -math.inf
    for spread in (1.0, 8.0):
        scores, r0, rows = attention_softmax_inputs(torch, device, spread, seed=int(spread))
        before = attention_softmax_cuda.launches
        attention_softmax_cuda(scores, scale, p[:, r0:r0 + rows])
        torch.cuda.synchronize()
        require(attention_softmax_cuda.launches == before + 1, "R5 is one launch a call")
        want = torch.softmax(scores * scale, dim=-1)
        err = float(((p[:, r0:r0 + rows].float() - want).abs() - want * 2**-8).max())
        top = float(want.amax(-1).median())
        log(f"  R5 attention_softmax B={b} {rows} rows x {n} keys, score std {spread}: largest error less one bf16 "
            f"rounding {err:.3e} (median row's largest probability {top:.3g})")
        require(err <= 1e-7, f"R5 at score std {spread} is not within one bf16 rounding of the plain softmax")
        require(not p[:, :r0].any() and not p[:, r0 + rows:].any(), "R5 writes its rows alone")
        worst = max(worst, err)
        del scores, want
    del p
    torch.cuda.empty_cache()
    return worst


def check_aggregate_epilogue(torch, device):
    """R6 against ``aggregate_epilogue_plain`` bit for bit on the card at
    the GMA cell's 136x240 grid, B=4 (and a ragged 5x7, B=1), bf16 and
    float32: ``mf + gamma agg`` from the ``[motion | flow]`` slot of a
    512-channel buffer into the global slots of it and of a second one,
    every other channel untouched, one launch a call."""
    from pwcnet_tpu_torch.models.conv import to_nchw
    from pwcnet_tpu_torch.ops.cuda.raft_update import aggregate_epilogue_cuda
    from pwcnet_tpu_torch.ops.raft_update import aggregate_epilogue, aggregate_epilogue_plain

    for dtype in (torch.bfloat16, torch.float32):
        for b, (h, w) in ((GMA_BATCH, GMA_GRID), (1, (5, 7))):
            gen = torch.Generator(device=device).manual_seed(h)
            a = to_nchw(torch.randn(b, h, w, 512, generator=gen, device=device).to(dtype))
            a2 = a.clone(memory_format=torch.channels_last)
            q, q2 = (to_nchw(torch.zeros(b, h, w, 512, dtype=dtype, device=device)) for _ in range(2))
            agg = 4 * torch.randn(b, h * w, 128, generator=gen, device=device)
            gamma = torch.tensor([0.5], device=device).to(dtype)
            before = aggregate_epilogue_cuda.launches
            with torch.inference_mode():
                aggregate_epilogue(a[:, 256:384], agg, gamma, a[:, 384:], q[:, 384:])
                aggregate_epilogue_plain(a2[:, 256:384], agg, gamma, a2[:, 384:], q2[:, 384:])
            torch.cuda.synchronize()
            require(aggregate_epilogue_cuda.launches == before + 1, "R6 is one launch a call")
            require(torch.equal(a, a2) and torch.equal(q, q2),
                    f"R6 at B={b} {h}x{w} {dtype_name(dtype)} is not the plain epilogue's bits")
    log("  R6 aggregate_epilogue bit for bit at B=4 136x240 and B=1 5x7, bf16 and float32")


def check_gma_forward_launches(torch, device, b=1):
    """One seeded ``GMA(iters=32)`` forward in bf16 on 448x1024 frames with
    the launch counters reset just before it: RAFT's R1-R3, R5 once (one
    block of score rows at 7168 keys) and R6 once an update:
    ``GMA_PER_FORWARD``, and no other hand kernel. Returns the counts."""
    from pwcnet_tpu_torch.models.gma import GMA
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.train_lib.step import make_forward

    torch.manual_seed(0)
    model = GMA(iters=32).to(device, torch.bfloat16)
    with torch.no_grad():
        model.update_block.aggregator.gamma.fill_(0.5)
    g = torch.Generator(device=device).manual_seed(0)
    x0 = torch.rand(b, 8 * RAFT_GRID[0], 8 * RAFT_GRID[1], 3, generator=g, device=device)
    reset_launch_counts()
    flow, _ = make_forward(model)(x0, x0.roll(3, 2))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  R1-R6 in one GMA(iters=32) bf16 forward, B={b} 448x1024: "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    require({k: v for k, v in counts.items() if v} == GMA_PER_FORWARD,
            f"GMA(iters=32) launches {GMA_PER_FORWARD} a forward and no other hand kernel")
    require(bool(flow.isfinite().all()), "GMA's flow is finite")
    del model, flow
    return {k: counts[k] for k in ("R5", "R6")}


def time_attention_softmax(torch, device):
    """R5 on one block of rows at the GMA cell's shape (B=4, 32640 keys,
    ``score_rows`` rows, score std 4): ms a call (CUDA events) against its
    bound (each float32 score read once and each bf16 probability written
    once, at 3.35 TB/s), the plain version's ms (``_softmax_plain``'s block:
    the scale, ``torch.softmax`` and the copy into the strided rows) and
    ``torch.softmax`` alone on the float32 block (the library's kernel,
    float32 out); the blocks a forward."""
    from pwcnet_tpu_torch.ops.cuda.global_attention import attention_softmax_cuda

    b, n = GMA_BATCH, GMA_GRID[0] * GMA_GRID[1]
    scale = 1 / math.sqrt(128)
    scores, r0, rows = attention_softmax_inputs(torch, device, 4.0, seed=4)
    p = torch.empty((b, n, n), dtype=torch.bfloat16, device=device)
    out = p[:, r0:r0 + rows]

    def plain():
        out.copy_(torch.softmax(scores * scale, dim=-1))

    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: attention_softmax_cuda(scores, scale, out))
        plain_ms = cuda_ms(torch, plain, iters=5)
        library_ms = cuda_ms(torch, lambda: torch.softmax(scores, dim=-1), iters=5)
    n_bytes = scores.numel() * (4 + 2)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    blocks = -(-n // rows)
    log(f"  R5 attention_softmax {b}x{rows} rows x {n} keys: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.softmax alone {library_ms:.4f} ms; bound {bound_ms:.4f} ms ({n_bytes / 1e9:.3f} GB; "
        f"{100 * bound_ms / ms:.1f}% of it); {blocks} blocks a forward")
    del p, scores
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "times": blocks,
            "shape": f"{b}x{rows}x{n}"}


def time_aggregate_epilogue(torch, device):
    """R6 on one update at the GMA cell's shape (B=4, 136x240), bf16: ms a
    call (CUDA events) against its bound (``mf`` and ``agg`` read once, both
    slots written once, at 3.35 TB/s) and the plain version's ms; 32 calls
    a forward."""
    from pwcnet_tpu_torch.models.conv import to_nchw
    from pwcnet_tpu_torch.ops.raft_update import aggregate_epilogue, aggregate_epilogue_plain

    b, (h, w) = GMA_BATCH, GMA_GRID
    gen = torch.Generator(device=device).manual_seed(6)
    a = to_nchw(torch.randn(b, h, w, 512, generator=gen, device=device).to(torch.bfloat16))
    q = to_nchw(torch.zeros(b, h, w, 512, dtype=torch.bfloat16, device=device))
    agg = torch.randn(b, h * w, 128, generator=gen, device=device)
    gamma = torch.tensor([0.5], device=device).to(torch.bfloat16)
    args = (a[:, 256:384], agg, gamma, a[:, 384:], q[:, 384:])
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: aggregate_epilogue(*args))
        plain_ms = cuda_ms(torch, lambda: aggregate_epilogue_plain(*args), iters=5)
    n_bytes = b * h * w * 128 * (2 + 4 + 2 * 2)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  R6 aggregate_epilogue bf16 {b}x{h}x{w}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB; {100 * bound_ms / ms:.1f}% of it); 32 calls a forward")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "times": 32, "shape": f"{b}x{h}x{w}"}


def cudnn_level_bwd(torch, g, out, s1, s2, k1, k2, k3, x_shape):
    """K6's library yardstick: the cuDNN conv2d_input chain in the model dtype (NCHW views)."""
    from torch.nn.grad import conv2d_input

    def mask(a):
        return torch.where(a >= 0, 1.0, 0.1).to(a.dtype)

    gz3 = g * mask(out)
    gz2 = conv2d_input(gz3.shape, k3, gz3, padding=1) * mask(s2)
    gz1 = conv2d_input(gz2.shape, k2, gz2, padding=1) * mask(s1)
    if x_shape is None:
        return gz1, gz2, gz3
    return gz1, gz2, gz3, conv2d_input(x_shape, k1, gz1, stride=2)


def time_training_kernels(torch, device, b=8, dtype=None):
    """K4, K5, K6: kernel, plain and library times at the training-step
    shapes; K4 also at the four finer 448x1024 levels of the legacy
    PWCNet's backward (listed, ``times`` 0)."""
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume, cost_volume_bwd_plain
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_bwd
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import (
        pyramid_level_bwd, pyramid_level_bwd_plain, pyramid_level_plain)
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd
    from pwcnet_tpu_torch.ops.warp import bilinear_warp, warp_bwd_plain

    dtype = dtype or torch.bfloat16
    dname = dtype_name(dtype)
    s = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=device).manual_seed(3)
    rows = {"K4": [], "K5": [], "K6": []}

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    with torch.inference_mode():
        for h, w, c in K2_TRAIN + K1_TRAIN:
            f0, f1, flow = k1_inputs(torch, b, h, w, c, dtype, device, gen)
            warped = (h, w, c) in K1_TRAIN
            f1w = bilinear_warp(f1, flow) if warped else f1
            out = cost_volume(f0, f1w, SEARCH_RANGE)
            g = torch.randn(out.shape, generator=gen, device=device).to(dtype)
            a4 = (f0, f1w, out, g, SEARCH_RANGE)
            rows["K4"].append(dict(
                shape=f"{b}x{h}x{w}x{c}", times=1,
                ms=cuda_ms(torch, lambda: cost_volume_bwd(*a4)),
                plain_ms=cuda_ms(torch, lambda: cost_volume_bwd_plain(*a4), iters=5, warmup=1),
                library_ms=None, work=k4_work(b, h, w, c, s)))
            if warped:
                gw = torch.randn(f1.shape, generator=gen, device=device).to(dtype)
                a5 = (f1, flow, gw)
                rows["K5"].append(dict(
                    shape=f"{b}x{h}x{w}x{c}", times=1,
                    ms=cuda_ms(torch, lambda: warp_bwd(*a5)),
                    plain_ms=cuda_ms(torch, lambda: warp_bwd_plain(*a5)),
                    library_ms=library_ms(torch, grid_sample_bwd(torch, *a5), f"K5 {dname} {h}x{w}x{c}"),
                    work=k5_work(b, h, w, c, s),
                    design_bytes=warp_bwd_design_bytes(k5_work(b, h, w, c, s), b * h * w * c, b * h * w * c, s)))
        for h, w, c in K2_SHAPES[1:]:
            f0, f1 = k2_inputs(torch, b, h, w, c, dtype, device, gen)
            out = cost_volume(f0, f1, SEARCH_RANGE)
            a4 = (f0, f1, out, torch.randn(out.shape, generator=gen, device=device).to(dtype), SEARCH_RANGE)
            rows["K4"].append(dict(
                shape=f"{b}x{h}x{w}x{c} (legacy)", times=0,
                ms=cuda_ms(torch, lambda: cost_volume_bwd(*a4)),
                plain_ms=cuda_ms(torch, lambda: cost_volume_bwd_plain(*a4), iters=5, warmup=1),
                library_ms=None, work=k4_work(b, h, w, c, s)))
        for level, (h, w, cin, c) in enumerate(K3_TRAIN):
            x, k1, b1, k2, b2, k3, b3 = k3_inputs(torch, b, h, w, cin, c, dtype, device, gen)
            out, s1, s2 = pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts=True)
            g = torch.randn(out.shape, generator=gen, device=device).to(dtype)
            need_dx = level > 0
            a6 = (x, k1, k2, k3, out, s1, s2, g)
            xs = (b, cin, h + 1, w + 1) if need_dx else None  # the forward's bottom/right pad
            lib = (nchw(g), nchw(out), nchw(s1), nchw(s2), k1, k2, k3, xs)
            rows["K6"].append(dict(
                shape=f"{b}x{h}x{w}x{cin}->{c} dx={need_dx}", times=2,  # both frames
                ms=cuda_ms(torch, lambda: pyramid_level_bwd(*a6, need_dx=need_dx)),
                plain_ms=cuda_ms(torch, lambda: pyramid_level_bwd_plain(*a6, need_dx=need_dx)),
                library_ms=cuda_ms(torch, lambda: cudnn_level_bwd(torch, *lib)),
                work=k6_work(b, h, w, cin, c, s, need_dx)))
    finish_rows(rows, dname)
    return rows


def check_estimator_kernels(torch, device, compare, batches=(1, 8), dtypes=None):
    """K7 at the five estimator levels of the 384x448 training step and of
    the 448x1024 serving forward: the forward with and without residuals
    (flow, features, s1..s4) and the backward (gz1..gz5, dxin, and the
    weight and bias gradients taken from the kernel's gz against those taken
    from the plain gz; gz1..gz5 and dxin again with k1 padded to the input's
    8-channel multiple, as the model hands it over, whose padded dxin
    channels must be 0), all against the plain versions.

    bfloat16 tolerance: 2 ulps of the result's scale, as for a one-stage
    kernel. The tensor-core body is another body than the float32 one, so it
    is held as tightly as its readings allow: over all these shapes the
    worst reading is 0.95 ulp (an H100 run of this script), because a
    one-ulp flip of one rounded activation is weighted by one small tap in
    the next stage and does not grow along the chain. A dropped bias
    (up to 0.3 here, against a bound of about 0.08) fails.
    float32: the weight and bias gradients are cuDNN sums over every pixel
    of the batch (up to 229 376 terms) of cotangents that already differ in
    their last bits, so they get 1e-4 of their scale, not 1e-5.
    """
    from pwcnet_tpu_torch.ops.cuda.estimator_conv import (
        estimator_chain_bwd, estimator_chain_fused, estimator_chain_residuals)
    from pwcnet_tpu_torch.ops.estimator_conv import (
        chain_weight_grads, estimator_chain_bwd_plain, estimator_chain_plain)

    dtypes = dtypes or (torch.float32, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(4)
    with torch.inference_mode():
        for dtype in dtypes:
            for b in batches:
                for h, w, cin in K7_TRAIN + K7_SERVE + K7_EDGE:
                    label = f"{dtype} B={b} {h}x{w}x{cin}"
                    xin, kbs = k7_inputs(torch, b, h, w, cin, dtype, device, gen)
                    ks = kbs[0::2]
                    want_flow, want_feat, want_acts = estimator_chain_plain(xin, *kbs, return_acts=True)
                    flow, feat = estimator_chain_fused(xin, *kbs)
                    compare("K7", f"flow {label}", flow, want_flow, dtype)
                    compare("K7", f"features {label}", feat, want_feat, dtype)
                    flow, feat, acts = estimator_chain_residuals(xin, *kbs)
                    compare("K7", f"flow (residuals) {label}", flow, want_flow, dtype)
                    for i, (a, e) in enumerate(zip([*acts, feat], [*want_acts, want_feat])):
                        compare("K7", f"s{i + 1} {label}", a, e, dtype)
                    g_flow = torch.randn(flow.shape, generator=gen, device=device).to(dtype)
                    g_feat = torch.randn(feat.shape, generator=gen, device=device).to(dtype)
                    saved = [*want_acts, want_feat]
                    gzs, dxin = estimator_chain_bwd(ks, saved, g_flow, g_feat)
                    want_gzs, want_dxin = estimator_chain_bwd_plain(ks, saved, g_flow, g_feat)
                    for i, (a, e) in enumerate(zip(gzs, want_gzs)):
                        compare("K7b", f"gz{i + 1} {label}", a, e, dtype)
                    compare("K7b", f"dxin {label}", dxin, want_dxin, dtype)
                    shapes = [k.shape for k in ks]
                    got_w = chain_weight_grads(xin, saved, gzs, g_flow, shapes)
                    want_w = chain_weight_grads(xin, saved, want_gzs, g_flow, shapes)
                    for i, (a, e) in enumerate(zip(got_w, want_w)):
                        name = f"{'dk' if i % 2 == 0 else 'db'}{i // 2 + 1}"
                        compare("K7b", f"{name} {label}", a, e, dtype, f32_rel=1e-4)
                    nodx = estimator_chain_bwd(ks, saved, g_flow, g_feat, need_dx=False)[1]
                    require(nodx is None, f"K7b returned a dxin nobody asked for at {label}")
                    # k1 padded to the input's 8-channel multiple, as the model hands it over: dxin's
                    # 16-byte stores and its second and third N tiles
                    kpad = [torch.nn.functional.pad(ks[0], (0, 0, 0, 0, 0, -cin % 8)), *ks[1:]]
                    gzs, dxpad = estimator_chain_bwd(kpad, saved, g_flow, g_feat)
                    for i, (a, e) in enumerate(zip(gzs, want_gzs)):
                        compare("K7b", f"gz{i + 1} (padded k1) {label}", a, e, dtype)
                    compare("K7b", f"dxin (padded k1) {label}", dxpad[..., :cin], want_dxin, dtype)
                    require(not dxpad[..., cin:].any().item(), f"K7b's padded dxin channels are not 0 at {label}")
                    # the input as the model hands it over: channels zero-padded to a multiple of 8
                    xpad = torch.nn.functional.pad(xin, (0, -cin % 8))
                    flow, feat = estimator_chain_fused(xpad, *kbs)
                    compare("K7", f"flow (padded input) {label}", flow, want_flow, dtype)
                    compare("K7", f"features (padded input) {label}", feat, want_feat, dtype)
                torch.cuda.synchronize()


def shard_inputs(torch, F, f1, flow, s, h, d):
    """Stripe ``s`` (of ``h`` rows) of one frame on the one card, as the
    exchanges build it: f1 with d halo rows (zeros beyond the frame), the
    float32 flow with d halo rows and the stripe's row offset in y, and the
    frame's rows in the stripe's coordinates."""
    f1_ext = F.pad(f1, (0, 0, 0, 0, d, d))[:, s * h : s * h + h + 2 * d].contiguous()
    flow_ext = F.pad(flow.float(), (0, 0, 0, 0, d, d))[:, s * h : s * h + h + 2 * d].clone()
    flow_ext[..., 1] += s * h
    return f1_ext, flow_ext, (-s * h, f1.shape[1] - 1 - s * h)


def check_shard_kernels(torch, F, device, compare, batches=(1, 8), dtypes=None):
    """K8, K8b, K9, K9b against their plain versions on the stripes of one
    frame held on the one card (2 stripes; halo rows sliced, frame 1 whole),
    at the shard shapes of 448x1024 and 384x448 (K9, K9b, K8b) and of a
    1024x1024 frame's level 0 (K8, K8b); then the stripes stitched against
    the unsharded kernels: outputs against K1 / K2, gradients summed over
    the stripes against K4 + K5 / K4. Tolerances as K1, K2, K4, K5."""
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_hpad, cost_volume_hpad_bwd_plain
    from pwcnet_tpu_torch.ops.cuda.cost_volume import (
        cost_volume_bwd, cost_volume_cuda, cost_volume_hpad_bwd, cost_volume_hpad_cuda)
    from pwcnet_tpu_torch.ops.cuda.warped_cv import (
        warp_bwd, warped_cost_volume_global_bwd, warped_cost_volume_global_bwd_plain,
        warped_cost_volume_global_plain, warped_cost_volume_global_residual, warped_cost_volume_residual)
    from pwcnet_tpu_torch.ops.warp import masked_warp_rows

    dtypes = dtypes or (torch.float32, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(6)
    d = SEARCH_RANGE

    def cot(like):
        return torch.randn(like.shape, generator=gen, device=device).to(like.dtype)

    with torch.inference_mode():
        for dtype in dtypes:
            for b in batches:
                for H, W, C in K9_SERVE + K9_TRAIN:
                    h = H // SHARDS
                    label = f"{dtype} B={b} {h}x{W}x{C} of {H}"
                    f0, f1, flow = k1_inputs(torch, b, H, W, C, dtype, device, gen)
                    out_u, f1w_u = warped_cost_volume_residual(f0, f1, flow, d)
                    g = cot(out_u)
                    outs, df0s = [], []
                    df1_sum = torch.zeros(f1.shape, dtype=torch.float32, device=device)
                    dflow_pad = torch.zeros((b, H + 2 * d, W, 2), dtype=torch.float32, device=device)
                    for s in range(SHARDS):
                        f0_s = f0[:, s * h : (s + 1) * h].contiguous()
                        _, flow_ext, vb = shard_inputs(torch, F, f1, flow, s, h, d)
                        out, we = warped_cost_volume_global_residual(f0_s, f1, flow_ext, vb, d)
                        want_out = warped_cost_volume_global_plain(f0_s, f1, flow_ext, vb, d)
                        want_we = masked_warp_rows(f1, flow_ext, vb, d)
                        compare("K9", f"out stripe {s} {label}", out, want_out, dtype)
                        compare("K9", f"warped rows stripe {s} {label}", we, want_we, dtype)
                        g_s = g[:, s * h : (s + 1) * h].contiguous()
                        a8 = (f0_s, want_we, out, g_s, d)
                        for name, a, e in zip(("df0", "df1_ext"), cost_volume_hpad_bwd(*a8), cost_volume_hpad_bwd_plain(*a8)):
                            compare("K8b", f"{name} stripe {s} {label}", a, e, dtype)
                        a9 = (f0_s, f1, flow_ext, vb, out, want_we, g_s, d)
                        got = warped_cost_volume_global_bwd(*a9)
                        for name, a, e in zip(("df0", "df1", "dflow_ext"), got, warped_cost_volume_global_bwd_plain(*a9)):
                            compare("K9b", f"{name} stripe {s} {label}", a, e, dtype)
                        outs.append(out)
                        df0s.append(got[0])
                        df1_sum += got[1].float()
                        dflow_pad[:, s * h : s * h + h + 2 * d] += got[2]
                    out_s = torch.cat(outs, 1)
                    compare("K9", f"stitched vs K1 {label}", out_s, out_u, dtype)
                    # the unsharded backward takes LeakyReLU's slope from the
                    # stitched output, as the stripes did: where a tap lies
                    # within rounding of zero, the two forwards may pick
                    # different slopes
                    df0_u, df1w_u = cost_volume_bwd(f0, f1w_u, out_s, g, d)
                    df1_u, dflow_u = warp_bwd(f1, flow, df1w_u)
                    compare("K9b", f"stitched df0 vs K4 {label}", torch.cat(df0s, 1), df0_u, dtype)
                    compare("K9b", f"summed df1 vs K5 {label}", df1_sum.to(dtype), df1_u, dtype)
                    compare("K9b", f"summed dflow vs K5 {label}", dflow_pad[:, d : d + H].to(dtype), dflow_u, dtype)
                for H, W, C in K8_FRAME:
                    h = H // SHARDS
                    label = f"{dtype} B={b} {h}x{W}x{C} of {H}"
                    f0, f1 = k2_inputs(torch, b, H, W, C, dtype, device, gen)
                    out_u = cost_volume_cuda(f0, f1, d)
                    g = cot(out_u)
                    outs, df0s = [], []
                    df1_pad = torch.zeros((b, H + 2 * d, W, C), dtype=torch.float32, device=device)
                    for s in range(SHARDS):
                        f0_s = f0[:, s * h : (s + 1) * h].contiguous()
                        f1_ext = shard_inputs(torch, F, f1, f1[..., :2], s, h, d)[0]
                        out = cost_volume_hpad_cuda(f0_s, f1_ext, d)
                        want = cost_volume_hpad(f0_s, f1_ext, d)
                        compare("K8", f"stripe {s} {label}", out, want, dtype)
                        a8 = (f0_s, f1_ext, out, g[:, s * h : (s + 1) * h].contiguous(), d)
                        got = cost_volume_hpad_bwd(*a8)
                        for name, a, e in zip(("df0", "df1_ext"), got, cost_volume_hpad_bwd_plain(*a8)):
                            compare("K8b", f"{name} stripe {s} {label}", a, e, dtype)
                        outs.append(out)
                        df0s.append(got[0])
                        df1_pad[:, s * h : s * h + h + 2 * d] += got[1].float()
                    out_s = torch.cat(outs, 1)
                    compare("K8", f"stitched vs K2 {label}", out_s, out_u, dtype)
                    df0_u, df1_u = cost_volume_bwd(f0, f1, out_s, g, d)
                    compare("K8b", f"stitched df0 vs K4 {label}", torch.cat(df0s, 1), df0_u, dtype)
                    compare("K8b", f"summed df1 vs K4 {label}", df1_pad[:, d : d + H].to(dtype), df1_u, dtype)
                torch.cuda.synchronize()


def check_one_kernel_a_call(torch, F, device):
    """One K5 call and one K9b call are one device operation each, the
    cooperative ``warp_bwd_coop_kernel`` (no fill, no rounding kernel), in
    float32 and bf16, at the finest training call and at its shard; one
    bf16 K7b call at the trainer's finest estimator level (k1 padded to 152
    input channels, as the model hands it over) is one launch of the weight
    packer, six wgmma stages and the flow cotangent's padding (the device
    operations of the same ``F.pad`` alone), with no weight copy through
    aten (torch.profiler). Returns the log line's parts."""
    from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_bwd
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd, warped_rows_bwd

    gen = torch.Generator(device=device).manual_seed(9)
    d = SEARCH_RANGE
    H, W, C = K1_TRAIN[-1]
    h = H // SHARDS
    found = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            _, f1, flow = k1_inputs(torch, 8, H, W, C, dtype, device, gen)
            g = torch.randn(f1.shape, generator=gen, device=device).to(dtype)
            _, flow_ext, vb = shard_inputs(torch, F, f1, flow, 1, h, d)
            dwe = torch.randn((8, h + 2 * d, W, C), generator=gen, device=device).to(dtype)
            calls = (("K5", lambda: warp_bwd(f1, flow, g)), ("K9b", lambda: warped_rows_bwd(f1, flow_ext, vb, dwe, d)))
            for kid, fn in calls:
                per_call, names = device_ops(torch, fn)
                label = f"{kid} {dtype_name(dtype)}: {per_call:g} ({', '.join(names)})"
                require(per_call == 1 and all("warp_bwd_coop_kernel" in nm for nm in names),
                        f"{label}: one call is not one device kernel")
                found.append(label)
        h, w, cin = K7_TRAIN[-1]
        xin, kbs = k7_inputs(torch, 8, h, w, -(-cin // 8) * 8, torch.bfloat16, device, gen)
        ks = kbs[0::2]
        acts = [torch.randn((8, h, w, c), generator=gen, device=device).to(torch.bfloat16) for c in EST_COUTS[:-1]]
        g = [torch.randn((8, h, w, c), generator=gen, device=device).to(torch.bfloat16) for c in EST_COUTS[:-3:-1]]
        per_call, counts = device_ops(torch, lambda: estimator_chain_bwd(ks, acts, *g))
        _, pad = device_ops(torch, lambda: F.pad(g[0], (0, -EST_COUTS[-1] % 8)))
        label = f"K7b bfloat16: {per_call:g} ({', '.join(f'{nm} x{c:g}' for nm, c in counts.items())})"
        rest = dict(counts)
        packs = sum(rest.pop(nm) for nm in list(rest) if "pack_weights_kernel" in nm)
        stages = sum(rest.pop(nm) for nm in list(rest) if "conv3x3_wgmma_kernel" in nm)
        require(packs == 1 and stages == len(EST_COUTS) and rest == pad,
                f"{label}: not one packer launch, {len(EST_COUTS)} wgmma stages and the flow's padding "
                f"({', '.join(f'{nm} x{c:g}' for nm, c in pad.items())})")
        found.append(label)
    log("  device operations a call (torch.profiler): " + "; ".join(found))
    return found


NON_FINITE_CASES = ("nan", "+inf", "-inf", "+inf and -inf")


def same_bits(torch, a, b):
    """Bitwise equality (NaN included, which torch.equal never finds equal)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype != b.dtype or a.dtype not in ints:
        return torch.equal(a, b)
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def check_non_finite(torch, F, device):
    """K5 at the finest training call and K9b on its second stripe, B=8,
    float32 and bf16, with g holding a NaN, a +Inf, a -Inf, or a +Inf and a
    -Inf in neighbouring pixels whose corners meet (flows of 0.3-0.5 px
    there): element by element df1 has the class of the plain version's
    float sum (NaN, +Inf, -Inf or finite), the finite elements within
    tolerance, the same bits in a second launch. Returns the cases run."""
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd, warped_rows_bwd, warped_rows_bwd_plain
    from pwcnet_tpu_torch.ops.warp import warp_bwd_plain

    gen = torch.Generator(device=device).manual_seed(10)
    d = SEARCH_RANGE
    H, W, C = K1_TRAIN[-1]
    h = H // SHARDS
    ran = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            _, f1, flow = k1_inputs(torch, 8, H, W, C, dtype, device, gen)
            _, flow_ext, vb = shard_inputs(torch, F, f1, flow, 1, h, d)
            for kid in ("K5", "K9b"):
                ho = H if kid == "K5" else h + 2 * d
                for case in NON_FINITE_CASES:
                    fl = (flow if kid == "K5" else flow_ext).clone()
                    g = torch.randn((8, ho, W, C), generator=gen, device=device).to(dtype)
                    row = 20 + (d if kid == "K9b" else 0)  # a live row of either
                    fl[3, row, 40:42] = torch.tensor([0.3, 0.4], device=device).to(fl.dtype)
                    if case == "+inf and -inf":
                        g[3, row, 40, 5], g[3, row, 41, 5] = float("inf"), float("-inf")
                    else:
                        g[3, row, 40, 5] = {"nan": float("nan"), "+inf": float("inf"), "-inf": float("-inf")}[case]
                    if kid == "K5":
                        got, again, want = warp_bwd(f1, fl, g), warp_bwd(f1, fl, g), warp_bwd_plain(f1, fl, g)
                    else:
                        got, again = warped_rows_bwd(f1, fl, vb, g, d), warped_rows_bwd(f1, fl, vb, g, d)
                        want = warped_rows_bwd_plain(f1, fl, vb, g.clone(), d)
                    label = f"{kid} {dtype_name(dtype)} g with {case}"
                    require(all(same_bits(torch, a, b) for a, b in zip(got, again)), f"{label}: two launches differ")
                    df1, want_df1 = got[0].float(), want[0].float()
                    for test in (torch.isnan, torch.isposinf, torch.isneginf):
                        require(torch.equal(test(df1), test(want_df1)), f"{label}: {test.__name__} differs")
                    bad = ~torch.isfinite(want_df1)
                    require(bad.sum().item() == (6 if case == "+inf and -inf" else 4), f"{label}: {bad.sum().item()} "
                            "non-finite elements, not those of the pixels' corners")
                    scale = want_df1[~bad].abs().max().item()
                    err = (df1[~bad] - want_df1[~bad]).abs().max().item()
                    tol = 1e-5 + 1e-5 * scale if dtype == torch.float32 else 2 * scale / 128
                    require(err <= tol, f"{label}: finite elements off by {err:.3e} (tol {tol:.3e})")
                    ran.append(f"{label}: NaN {int(torch.isnan(df1).sum())}, +Inf {int(torch.isposinf(df1).sum())}, "
                               f"-Inf {int(torch.isneginf(df1).sum())}, finite within {err:.1e}")
        torch.cuda.synchronize()
    log("  non-finite g (the class of the float sum, element by element): " + "; ".join(ran))
    return ran


def check_image_scales(torch, F, device):
    """K5 at the finest training call and K9b on its second stripe, B=8,
    float32 and bf16, with image 3's g at 1e-8 of the others': each image's
    df1 and dflow have the bits of a call on that image alone (each image
    sums in fixed point at its own scale), and image 3's df1 is within
    tolerance of its own scale (float32 1e-5 of its largest entry, bf16 2
    ulps) of the plain version. Returns the largest relative errors."""
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd, warped_rows_bwd, warped_rows_bwd_plain
    from pwcnet_tpu_torch.ops.warp import warp_bwd_plain

    gen = torch.Generator(device=device).manual_seed(11)
    d = SEARCH_RANGE
    H, W, C = K1_TRAIN[-1]
    h = H // SHARDS
    errs = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            _, f1, flow = k1_inputs(torch, 8, H, W, C, dtype, device, gen)
            _, flow_ext, vb = shard_inputs(torch, F, f1, flow, 1, h, d)
            for kid in ("K5", "K9b"):
                ho = H if kid == "K5" else h + 2 * d
                g = torch.randn((8, ho, W, C), generator=gen, device=device).to(dtype)
                g[3] *= 1e-8
                if kid == "K5":
                    run = lambda i: warp_bwd(f1[i], flow[i], g[i])  # noqa: E731
                    want = warp_bwd_plain(f1, flow, g)[0][3].float()
                else:
                    run = lambda i: warped_rows_bwd(f1[i], flow_ext[i], vb, g[i], d)  # noqa: E731
                    want = warped_rows_bwd_plain(f1, flow_ext, vb, g.clone(), d)[0][3].float()
                got = run(slice(None))
                label = f"{kid} {dtype_name(dtype)}"
                for i in range(8):
                    require(all(torch.equal(a[i : i + 1], e) for a, e in zip(got, run(slice(i, i + 1)))),
                            f"{label}: image {i}'s df1 or dflow differs from a call on it alone")
                scale = want.abs().max().item()
                err = (got[0][3].float() - want).abs().max().item() / scale
                tol = 1e-5 if dtype == torch.float32 else 2 / 128
                require(err <= tol, f"{label}: the image at 1e-8 is off by {err:.3e} of its scale (tol {tol:.1e})")
                errs[label] = err
        torch.cuda.synchronize()
    log("  each image its own scale (image 3's g at 1e-8 of the others'; every image bitwise as alone): "
        "image 3's df1 off by " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " of its scale")
    return errs


def check_determinism(torch, F, device, dtypes=None):
    """Every kernel gives the same bits in two launches on the same inputs:
    K5 at the four 384x448 training calls and K9b on the second stripe of
    each (df1 summed in fixed point; also in a third launch after K3 at
    448x1024 B=8 has filled the L2 and every SM), K2 and K1 (with its warped map) at
    every serving level, K8, K9 (with its warped rows) at the deepest and
    finest sharded level, K3 (with s1 and s2) at its serving and training
    levels, K7 (flow, features) and K7b (gz1..gz5, dxin, with k1 as given
    and padded to the input's 8-channel multiple as the model hands it
    over) at the trainer's two estimator levels, K6 at both training levels
    (dx at level 1), B=8.
    Returns the number of results compared."""
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda, cost_volume_hpad_cuda
    from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_bwd, estimator_chain_residuals
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_bwd, pyramid_level_plain, pyramid_level_residuals
    from pwcnet_tpu_torch.ops.cuda.warped_cv import (
        warp_bwd, warped_cost_volume_global_residual, warped_cost_volume_residual, warped_rows_bwd)

    dtypes = dtypes or (torch.float32, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(8)
    d, n = SEARCH_RANGE, 0
    filler = k3_inputs(torch, 8, *K3_SHAPES[0], torch.bfloat16, device, gen)  # 448x1024: every SM, over 50 MB

    def same(kid, label, fn, third=False):
        nonlocal n
        runs = [fn(), fn()]
        if third:
            pyramid_level_residuals(*filler)
            runs.append(fn())
        for outs in runs[1:]:
            for a, b in zip(runs[0], outs):
                require(torch.equal(a, b), f"{kid} {label}: launches on the same inputs differ")
                n += 1

    with torch.inference_mode():
        for dtype in dtypes:
            for h, w, c in K1_TRAIN:
                _, f1, flow = k1_inputs(torch, 8, h, w, c, dtype, device, gen)
                g = torch.randn(f1.shape, generator=gen, device=device).to(dtype)
                same("K5", f"{dtype} {h}x{w}x{c}", lambda: warp_bwd(f1, flow, g), third=True)
                _, flow_ext, vb = shard_inputs(torch, F, f1, flow, 1, h // SHARDS, d)
                dwe = torch.randn((8, h // SHARDS + 2 * d, w, c), generator=gen, device=device).to(dtype)
                same("K9b", f"{dtype} {h // SHARDS + 2 * d}x{w}x{c} of {h}",
                     lambda: warped_rows_bwd(f1, flow_ext, vb, dwe, d), third=True)
            for h, w, c in K2_SHAPES:
                a = k2_inputs(torch, 8, h, w, c, dtype, device, gen)
                same("K2", f"{dtype} {h}x{w}x{c}", lambda: (cost_volume_cuda(*a, d),))
            for h, w, c in K1_SHAPES:
                a = k1_inputs(torch, 8, h, w, c, dtype, device, gen)
                same("K1", f"{dtype} {h}x{w}x{c}", lambda: warped_cost_volume_residual(*a, d))
            for h, w, c in K8_FRAME:
                f0, f1 = k2_inputs(torch, 1, h, w, c, dtype, device, gen)
                a = (f0[:, h // SHARDS:].contiguous(), shard_inputs(torch, F, f1, f1[..., :2], 1, h // SHARDS, d)[0], d)
                same("K8", f"{dtype} {h}x{w}x{c}", lambda: (cost_volume_hpad_cuda(*a),))
            for h, w, c in (K9_SERVE[0], K9_SERVE[-1]):
                f0, f1, flow = k1_inputs(torch, 8, h, w, c, dtype, device, gen)
                _, flow_ext, vb = shard_inputs(torch, F, f1, flow, 1, h // SHARDS, d)
                a = (f0[:, h // SHARDS:].contiguous(), f1, flow_ext, vb, d)
                same("K9", f"{dtype} {h}x{w}x{c}", lambda: warped_cost_volume_global_residual(*a))
            for h, w, cin, c in K3_SHAPES + K3_TRAIN:
                a = k3_inputs(torch, 8, h, w, cin, c, dtype, device, gen)
                same("K3", f"{dtype} {h}x{w}x{cin}->{c}", lambda: pyramid_level_residuals(*a))
            for h, w, cin in K7_TRAIN[-FUSED_ESTIMATOR:]:
                xin, kbs = k7_inputs(torch, 8, h, w, cin, dtype, device, gen)
                flow, feat, acts = estimator_chain_residuals(xin, *kbs)
                same("K7", f"{dtype} {h}x{w}x{cin}", lambda: (*estimator_chain_residuals(xin, *kbs)[:2],))
                g = [torch.randn(t.shape, generator=gen, device=device).to(dtype) for t in (flow, feat)]
                kpad = [F.pad(kbs[0], (0, 0, 0, 0, 0, -cin % 8)), *kbs[2::2]]

                def k7b():
                    gz, dx = estimator_chain_bwd(kbs[0::2], [*acts, feat], *g)
                    gzp, dxp = estimator_chain_bwd(kpad, [*acts, feat], *g)
                    return [*gz, dx, *gzp, dxp]

                same("K7b", f"{dtype} {h}x{w}x{cin}", k7b)
            for level, (h, w, cin, c) in enumerate(K3_TRAIN):
                x, k1, b1, k2, b2, k3, b3 = k3_inputs(torch, 8, h, w, cin, c, dtype, device, gen)
                out, s1, s2 = pyramid_level_plain(x, k1, b1, k2, b2, k3, b3, return_acts=True)
                g = torch.randn(out.shape, generator=gen, device=device).to(dtype)
                a = (x, k1, k2, k3, out, s1, s2, g)
                same("K6", f"{dtype} {h}x{w}x{cin}->{c}",
                     lambda: [t for t in pyramid_level_bwd(*a, need_dx=level > 0) if t is not None])
        torch.cuda.synchronize()
    log(f"  K1-K6, K7, K7b, K8, K9, K9b: {n} results bitwise equal to the first launch's (K5 and K9b also "
        "after K3 filled the card)")
    return n


def k8_work(b, h, w, c, s):
    px, ext = b * h * w, b * (h + 2 * SEARCH_RANGE) * w
    return (px * (c + TAPS) + ext * c) * s, px * (2 * c * TAPS + 2 * TAPS)


def k9_work(b, h, hf, w, c, s):
    # f0, the whole frame 1 and the output; the float32 flow with its halo rows
    px, ext = b * h * w, b * (h + 2 * SEARCH_RANGE) * w
    return (px * (c + TAPS) + b * hf * w * c) * s + ext * 2 * 4, px * (2 * c * TAPS + 2 * TAPS) + ext * 9 * c


def k8b_work(b, h, w, c, s):
    # reads g, out, f0, f1_ext; writes df0, df1_ext
    px, ext = b * h * w, b * (h + 2 * SEARCH_RANGE) * w
    return (px * (2 * TAPS + 2 * c) + 2 * ext * c) * s, px * (4 * c * TAPS + 3 * TAPS)


def k9b_work(b, h, hf, w, c, s):
    # the tall warp backward after K8b: reads the warped rows' cotangent,
    # the whole frame and the float32 flow; writes df1 (the frame) and dflow
    ext = b * (h + 2 * SEARCH_RANGE) * w
    return (ext * c + 2 * b * hf * w * c) * s + ext * 2 * 4 * 2, ext * c * 14


def time_shard_kernels(torch, F, device, dtype=None):
    """K8, K8b, K9, K9b: kernel and plain times at a shard's shapes on the
    sharded paths (one rank of 2): K9 at 448x1024 B=8 levels 1-4 per
    forward, K8 at the 1024x1024 pair's level 0 per forward, K8b and K9b at
    384x448 B=8 levels 1-4 per train step. K9b is timed alone, on the
    warped rows' cotangent K8b gives it."""
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_hpad, cost_volume_hpad_bwd_plain
    from pwcnet_tpu_torch.ops.cuda import _common
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_hpad_bwd, cost_volume_hpad_cuda
    from pwcnet_tpu_torch.ops.cuda.warped_cv import (
        warped_cost_volume_global, warped_cost_volume_global_plain, warped_rows_bwd, warped_rows_bwd_plain)
    from pwcnet_tpu_torch.ops.warp import masked_warp_rows

    dtype = dtype or torch.bfloat16
    dname = dtype_name(dtype)
    sz = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=device).manual_seed(7)
    d = SEARCH_RANGE
    rows = {k: [] for k in SHARD_KERNELS}
    with torch.inference_mode():
        for H, W, C in K9_SERVE:
            h = H // SHARDS
            f0, f1, flow = k1_inputs(torch, 8, H, W, C, dtype, device, gen)
            _, flow_ext, vb = shard_inputs(torch, F, f1, flow, 1, h, d)
            a = (f0[:, h:].contiguous(), f1, flow_ext, vb, d)
            rows["K9"].append(dict(
                shape=f"8x{h}x{W}x{C} of {H}", times=1,
                ms=cuda_ms(torch, lambda: warped_cost_volume_global(*a)),
                plain_ms=cuda_ms(torch, lambda: warped_cost_volume_global_plain(*a)),
                library_ms=None, work=k9_work(8, h, H, W, C, sz)))
        for H, W, C in K8_FRAME:
            h = H // SHARDS
            f0, f1 = k2_inputs(torch, 1, H, W, C, dtype, device, gen)
            a = (f0[:, h:].contiguous(), shard_inputs(torch, F, f1, f1[..., :2], 1, h, d)[0], d)
            rows["K8"].append(dict(
                shape=f"1x{h}x{W}x{C} of {H}", times=1,
                ms=cuda_ms(torch, lambda: cost_volume_hpad_cuda(*a)),
                plain_ms=cuda_ms(torch, lambda: cost_volume_hpad(*a)),
                library_ms=None, work=k8_work(1, h, W, C, sz)))
        for H, W, C in K9_TRAIN:
            h = H // SHARDS
            f0, f1, flow = k1_inputs(torch, 8, H, W, C, dtype, device, gen)
            _, flow_ext, vb = shard_inputs(torch, F, f1, flow, 1, h, d)
            f0_s = f0[:, h:].contiguous()
            out = warped_cost_volume_global_plain(f0_s, f1, flow_ext, vb, d)
            we = masked_warp_rows(f1, flow_ext, vb, d)
            g = torch.randn(out.shape, generator=gen, device=device).to(dtype)
            a8 = (f0_s, we, out, g, d)
            a9 = (f1, flow_ext, vb, cost_volume_hpad_bwd_plain(*a8)[1], d)
            shape = f"8x{h}x{W}x{C} of {H}"
            rows["K8b"].append(dict(
                shape=shape, times=1,
                ms=cuda_ms(torch, lambda: cost_volume_hpad_bwd(*a8)),
                plain_ms=cuda_ms(torch, lambda: cost_volume_hpad_bwd_plain(*a8), iters=5, warmup=1),
                library_ms=None, work=k8b_work(8, h, W, C, sz)))
            live = _common.warp_bwd_live_rows(h + 2 * d, -d, *vb).to(device)[None, :, None, None]
            lib9 = grid_sample_bwd(torch, f1, flow_ext, a9[3] * live.to(dtype), -d)
            rows["K9b"].append(dict(
                shape=shape, times=1,
                ms=cuda_ms(torch, lambda: warped_rows_bwd(*a9)),
                plain_ms=cuda_ms(torch, lambda: warped_rows_bwd_plain(*a9), iters=5, warmup=1),
                library_ms=library_ms(torch, lib9, f"K9b {dname} {shape}"),
                work=k9b_work(8, h, H, W, C, sz),
                design_bytes=warp_bwd_design_bytes(k9b_work(8, h, H, W, C, sz), 8 * (h + 2 * d) * W * C,
                                                   8 * H * W * C, sz)))
    finish_rows(rows, dname)
    return rows


def cudnn_chain(F, x_nchw, kbs):
    """K7's library yardstick: the cuDNN six-conv chain in the model dtype."""
    y = x_nchw
    for i in range(6):
        y = F.conv2d(y, kbs[2 * i], kbs[2 * i + 1], padding=1)
        if i < 5:
            y = F.leaky_relu(y, 0.1)
    return y


def cudnn_chain_bwd(torch, ks, acts, g_flow, g_feat, cin):
    """K7b's library yardstick: the cuDNN conv2d_input chain in the model dtype (NCHW views)."""
    from torch.nn.grad import conv2d_input

    b, _, h, w = g_flow.shape
    gz = g_flow
    for i in range(5, 0, -1):
        ds = conv2d_input((b, ks[i].shape[1], h, w), ks[i], gz, padding=1)
        if i == 5:
            ds = ds + g_feat
        gz = ds * torch.where(acts[i - 1] >= 0, 1.0, 0.1).to(ds.dtype)
    return conv2d_input((b, cin, h, w), ks[0], gz, padding=1)


def time_estimator_kernels(torch, F, device, b=8, dtype=None):
    """K7 forward (with residuals, as the trainer runs it) and backward (k1
    padded to the input's 8-channel multiple, as the trainer runs it):
    kernel, plain and library times at levels 3 and 4 of both sizes. The
    rows of the 384x448 levels are the trainer's launches per step
    (``times`` 1); the 448x1024 rows are listed and not summed."""
    from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_bwd, estimator_chain_residuals
    from pwcnet_tpu_torch.ops.estimator_conv import estimator_chain_bwd_plain, estimator_chain_plain

    dtype = dtype or torch.bfloat16
    dname = dtype_name(dtype)
    s = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=device).manual_seed(5)
    rows = {"K7": [], "K7b": []}

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    with torch.inference_mode():
        for times, shapes in ((1, K7_TRAIN[-FUSED_ESTIMATOR:]), (0, K7_SERVE[-FUSED_ESTIMATOR:])):
            for h, w, cin in shapes:
                xin, kbs = k7_inputs(torch, b, h, w, cin, dtype, device, gen)
                ks = kbs[0::2]
                flow, feat, acts = estimator_chain_plain(xin, *kbs, return_acts=True)
                saved = [*acts, feat]
                g_flow = torch.randn(flow.shape, generator=gen, device=device).to(dtype)
                g_feat = torch.randn(feat.shape, generator=gen, device=device).to(dtype)
                x_nchw = nchw(xin)
                xpad = F.pad(xin, (0, -cin % 8))  # as the model's NHWC copy hands it over
                kpad = [F.pad(ks[0], (0, 0, 0, 0, 0, -cin % 8))] + ks[1:]  # and k1 with it: dxin as the step takes it
                lib_bwd = (ks, [nchw(a) for a in saved], nchw(g_flow), nchw(g_feat), cin)
                shape = f"{b}x{h}x{w}x{cin}"
                rows["K7"].append(dict(
                    shape=shape, times=times,
                    ms=cuda_ms(torch, lambda: estimator_chain_residuals(xpad, *kbs), iters=10),
                    plain_ms=cuda_ms(torch, lambda: estimator_chain_plain(xin, *kbs), iters=5, warmup=1),
                    library_ms=cuda_ms(torch, lambda: cudnn_chain(F, x_nchw, kbs), iters=10),
                    work=k7_work(b, h, w, cin, s, False)))
                rows["K7b"].append(dict(
                    shape=shape, times=times,
                    ms=cuda_ms(torch, lambda: estimator_chain_bwd(kpad, saved, g_flow, g_feat), iters=10),
                    plain_ms=cuda_ms(torch, lambda: estimator_chain_bwd_plain(ks, saved, g_flow, g_feat),
                                     iters=5, warmup=1),
                    library_ms=cuda_ms(torch, lambda: cudnn_chain_bwd(torch, *lib_bwd), iters=10),
                    work=k7_work(b, h, w, cin, s, True)))
    finish_rows(rows, dname)
    return rows


def summed(rs, suffix=""):
    """A kernel's rows of one dtype summed over its main-path launches, as
    the JSON line's ``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``,
    ``library_ms`` and ``shapes`` (bf16), or with ``suffix`` (float32)."""
    lib = [r["library_ms"] for r in rs]
    out = {"ms": sum(r["ms"] * r["times"] for r in rs),
           "plain_ms": sum(r["plain_ms"] * r["times"] for r in rs),
           "bound_ms": sum(r["bound_ms"] * r["times"] for r in rs),
           "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
           "library_ms": None if None in lib else sum(v * r["times"] for v, r in zip(lib, rs)),
           "shapes": rs}
    return {k + suffix: v for k, v in out.items()}


def finish_rows(rows, dname):
    for kid, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = bound(dname, *r.pop("work"))
            design = ""
            if "design_bytes" in r:
                r["design_bound_ms"] = r.pop("design_bytes") / HBM_BYTES_PER_S * 1e3
                design = f", the design's bytes {r['design_bound_ms']:.4f} ms"
            log(f"  {kid} {dname} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){design}")


def smooth_pair(np, h, w, seed, shift=(3, 5)):
    """A smooth random frame and a copy shifted by ``shift`` pixels (uint8)."""
    rng = np.random.default_rng(seed)
    base = rng.random((h // 16 + 2, w // 16 + 2, 3))
    img = np.kron(base, np.ones((16, 16, 1)))
    img = np.roll(img, (7, 11), (0, 1))  # off the block grid
    a = img[:h, :w]
    b = np.roll(img, shift, (0, 1))[:h, :w]
    return (a * 255).astype(np.uint8), (b * 255).astype(np.uint8)


def flow_close(kind, got, want, rtol):
    """max |got - want| <= rtol * max |want| (+ a floor for all-small flows)."""
    got = got.float() if hasattr(got, "float") else got
    want = want.float() if hasattr(want, "float") else want
    err = float(abs(got - want).max())
    scale = float(abs(want).max())
    tol = rtol * scale + 1e-4
    log(f"  {kind}: max |diff| {err:.3e} px (tol {tol:.3e}, max |flow| {scale:.3e})")
    require(err <= tol, f"{kind}: kernel path and reference disagree")
    return err


def serve(torch, np, device):
    """The main path: requests and batched forwards through the kernels."""
    from pwcnet_tpu_torch.inference import FlowPredictor
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    preds = {
        (dt, k): FlowPredictor(dtype=dt, use_kernels=k, device=device)
        for dt in (torch.bfloat16, torch.float32) for k in (True, False)
    }
    pad_preds = {
        k: FlowPredictor(dtype=torch.bfloat16, use_kernels=k, device=device, size_handling="pad")
        for k in (True, False)
    }
    req = [smooth_pair(np, 448, 1024, seed) for seed in (1, 2)]
    sintel = smooth_pair(np, 436, 1024, 3)
    batch = np.stack([np.stack(smooth_pair(np, 448, 1024, 10 + i)) for i in range(8)])
    batch_dev = torch.as_tensor(batch).to(device)

    # -- the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out_req = [preds[(torch.bfloat16, True)](a, b) for a, b in req]
    out_pad = pad_preds[True](*sintel)
    out_b16 = preds[(torch.bfloat16, True)].raw_forward(batch_dev)
    out_f32 = preds[(torch.float32, True)].raw_forward(batch_dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_fwd = len(req) + 1 + 2
    log(f"  main path: {n_fwd} forwards in {time.perf_counter() - t0:.2f} s, launches {counts}")
    for kid, per in PER_FORWARD.items():
        require(counts[kid] == per * n_fwd, f"{kid} launched {counts[kid]}x, want {per}x per forward x {n_fwd}")

    # -- outputs: shapes, finiteness, agreement with the plain path
    for flow, pyr, imgs in out_req:
        require(flow.shape == (448, 1024, 2) and bool(np.isfinite(flow).all()), f"request flow {flow.shape}")
        require(len(pyr) == 5 and imgs.shape == (2, 448, 1024, 3), "request pyramid and frames")
    require(out_pad[0].shape == (436, 1024, 2) and bool(np.isfinite(out_pad[0]).all()), "padded flow")
    require(out_pad[2].shape == (2, 448, 1024, 3), "padded frames")
    with torch.inference_mode():
        ref_b16 = preds[(torch.bfloat16, False)].raw_forward(batch_dev)
        ref_f32 = preds[(torch.float32, False)].raw_forward(batch_dev)
    # f32: summation order only, through 5 levels: 1e-4 of the flow's scale.
    # bf16: the two paths round intermediate features at different places
    # (kernel vs plain); a 1-ulp flip (2^-8) feeds the next level's warp and
    # estimator, so allow 5% of the flow's scale.
    flow_close("f32 B=8 kernels vs plain", out_f32[0], ref_f32[0], 1e-4)
    flow_close("bf16 B=8 kernels vs plain", out_b16[0], ref_b16[0], 5e-2)
    ref_req = preds[(torch.bfloat16, False)](*req[0])
    flow_close("bf16 request kernels vs plain", out_req[0][0], ref_req[0], 5e-2)
    ref_pad = pad_preds[False](*sintel)
    flow_close("bf16 padded 436x1024 kernels vs plain", out_pad[0], ref_pad[0], 5e-2)

    # -- small pair against the float32 CPU path (plain ops, CPU convs)
    small = smooth_pair(np, 64, 128, 4)
    cpu_pred = FlowPredictor(dtype=torch.float32, device="cpu")
    flow_close("f32 64x128 card kernels vs CPU plain", preds[(torch.float32, True)](*small)[0],
               cpu_pred(*small)[0], 1e-4)

    # -- batched_pyramid: both frames through K3 in one call a level, counted
    batched = {dt: FlowPredictor(dtype=dt, use_kernels=True, device=device, batched_pyramid=True)
               for dt in (torch.bfloat16, torch.float32)}
    torch.cuda.synchronize()
    reset_launch_counts()
    out_batched = {dt: p.raw_forward(batch_dev) for dt, p in batched.items()}
    torch.cuda.synchronize()
    batched_counts = launch_counts()
    log(f"  batched_pyramid: 2 forwards, launches {batched_counts}")
    want = {k: 2 * BATCHED_PER_FORWARD.get(k, 0) for k in batched_counts}
    require(batched_counts == want, f"batched_pyramid launches {batched_counts}, want {want}")
    flow_close("f32 B=8 batched_pyramid vs default, kernels", out_batched[torch.float32][0], out_f32[0], 1e-4)
    flow_close("bf16 B=8 batched_pyramid vs default, kernels", out_batched[torch.bfloat16][0], out_b16[0], 5e-2)

    # -- throughput; the batched pyramid in turns with the default (reported, not gated)
    pairs = {}
    for (dt, k), p in preds.items():
        ms = cuda_ms(torch, lambda: p.raw_forward(batch_dev), iters=10, warmup=3)
        name = f"{str(dt).replace('torch.', '')} {'kernels' if k else 'plain'}"
        pairs[name] = 8e3 / ms
        log(f"  448x1024 B=8 {name}: {ms:.3f} ms per batch, {8e3 / ms:.1f} pairs/s")
    ab = {}
    for dt, p in batched.items():
        for name, pred in (("default", preds[(dt, True)]), ("batched_pyramid", p), ("batched_pyramid", p),
                           ("default", preds[(dt, True)])):
            ab.setdefault(f"{dtype_name(dt)} kernels {name}", []).append(
                8e3 / cuda_ms(torch, lambda: pred.raw_forward(batch_dev), iters=10, warmup=2))
    for name, v in ab.items():
        log(f"  448x1024 B=8 A/B {name}: {' / '.join(f'{x:.1f}' for x in v)} pairs/s")
    preds_kernels = {dtype_name(dt): preds[(dt, True)] for dt in (torch.bfloat16, torch.float32)}
    return counts, pairs, preds_kernels, batch_dev, {"launches": batched_counts, "pairs_per_s": ab}


# ------------------------------------------------------------ the legacy PWCNet
def legacy_phase(torch, device, batch_dev):
    """The legacy PWCNet at full width and depth (6 levels, search range 4,
    output level 4, bilinear warp, context 'final', no BatchNorm) through
    ``make_forward`` on [serve]'s 448x1024 B=8 batch, bf16 and float32: its
    default cost volume is K2's wrapper, so each forward launches K2 at all
    five levels and no other kernel. Flows against the same weights with
    the plain cost volume (``cost_volume_fn=cost_volume``) at [serve]'s
    bounds; then 'all' with BatchNorm, its running statistics moved by three
    ``train=True`` calls, in float32 at the same bound; one float32 backward
    against a seeded positive cotangent (K4 at all five levels) with every
    parameter gradient within 1e-3 of its largest entry of the plain
    witness's ([train]'s float32 gate); pairs/s on both paths (reported).
    The plain witness's weights are moved last (the noise floor)."""
    from pwcnet_tpu_torch.models.pwcnet import PWCNet
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.prng import PRNGKey
    from pwcnet_tpu_torch.train_lib.step import make_forward

    x0 = batch_dev[:, 0].float() / 255.0
    x1 = batch_dev[:, 1].float() / 255.0

    def pair(dtype, **kw):
        """The model on K2 and its plain witness, on the same seeded weights."""
        models = []
        for cv in ({}, {"cost_volume_fn": cost_volume}):
            m = PWCNet(key=PRNGKey(0), **kw, **cv)
            models.append(m.to(device=device, dtype=dtype).eval())
        return models

    models = {dt: pair(dt) for dt in (torch.bfloat16, torch.float32)}
    forwards = {dt: [make_forward(m) for m in ms] for dt, ms in models.items()}

    # -- the main path, counted: one forward a dtype
    torch.cuda.synchronize()
    reset_launch_counts()
    out = {dt: fw[0](x0, x1) for dt, fw in forwards.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  make_forward(PWCNet()) at 448x1024 B=8, bf16 and f32: launches {counts}")
    want = {k: 2 * LEGACY_PER_FORWARD.get(k, 0) for k in counts}
    require(counts == want, f"legacy launches {counts}, want {want}")
    for dt, (flow, flows, pyr) in out.items():
        require(flow.shape == (8, 448, 1024, 2) and len(flows) == 5 and len(pyr) == 6
                and bool(torch.isfinite(flow.float()).all()), f"legacy {dtype_name(dt)} outputs")
    refs = {dt: fw[1](x0, x1) for dt, fw in forwards.items()}
    errs = {"float32": flow_close("legacy f32 B=8 K2 vs plain", out[torch.float32][0], refs[torch.float32][0], 1e-4),
            "bfloat16": flow_close("legacy bf16 B=8 K2 vs plain", out[torch.bfloat16][0], refs[torch.bfloat16][0],
                                   5e-2)}

    # -- 'all' with BatchNorm: running statistics moved by train=True calls
    bn = pair(torch.float32, context="all", batch_norm=True)
    with torch.no_grad():
        for i in range(3):
            bn[0](x0[2 * i:2 * i + 4], x1[2 * i:2 * i + 4], train=True)
    moved = max((bn[0].optflow_4.bn_0.var - 1).abs().max().item(), bn[0].optflow_4.bn_0.mean.abs().max().item())
    require(moved > 1e-3, "legacy BatchNorm statistics did not move")
    bn[1].load_state_dict(bn[0].state_dict())
    reset_launch_counts()
    got = make_forward(bn[0])(x0, x1)
    torch.cuda.synchronize()
    bn_counts = launch_counts()
    require(bn_counts == {k: LEGACY_PER_FORWARD.get(k, 0) for k in counts}, f"legacy 'all' + BN launches {bn_counts}")
    errs["float32 all+bn"] = flow_close("legacy f32 B=8 'all' + BN K2 vs plain", got[0],
                                        make_forward(bn[1])(x0, x1)[0], 1e-4)
    del bn, got

    # -- one backward of the float32 forward: K2 5 and K4 5 counted. The
    # cotangent is seeded and positive (uniform in [0.5, 1.5]): under a
    # zero-mean one every parameter gradient is a random-walk sum over the
    # pixels in which one LeakyReLU slope flipped by rounding weighs
    # 1/sqrt(N) of it, and the plain path against itself with its weights
    # moved by 1e-7 of themselves differed by 4.0e-3 of a tensor's largest
    # entry on an H100 (PERF.md). The same check on this cotangent is
    # logged as the gate's noise floor.
    per_step = {k: LEGACY_PER_FORWARD.get(k, 0) + LEGACY_PER_BACKWARD.get(k, 0) for k in counts}
    gen = torch.Generator(device=device)

    def grads(model):
        flow, flows, _ = model(x0, x1)
        outs = [flow, *flows]
        cots = [0.5 + torch.rand(o.shape, generator=gen.manual_seed(30 + i), device=device)
                for i, o in enumerate(outs)]
        total = sum((o * c).sum() for o, c in zip(outs, cots))
        params = dict(model.named_parameters())
        return dict(zip(params, torch.autograd.grad(total, list(params.values()))))

    grads_of = {}
    for name, model in zip(("kernels", "plain"), models[torch.float32]):
        torch.cuda.synchronize()
        reset_launch_counts()
        grads_of[name] = grads(model)
        torch.cuda.synchronize()
        step_counts = launch_counts()
        want = per_step if name == "kernels" else {k: 0 for k in counts}
        require(step_counts == want, f"legacy {name} forward + backward launches {step_counts}, want {want}")
    counts = {k: counts[k] + bn_counts[k] + per_step[k] for k in counts}
    worst, worst_name, rel_l2, cos = grad_agreement(torch, grads_of["kernels"], grads_of["plain"])
    moved = models[torch.float32][1]
    with torch.no_grad():
        noise = torch.Generator(device=device).manual_seed(31)
        for p in moved.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=noise, device=device))
    floor = grad_agreement(torch, grads(moved), grads_of["plain"])[0]
    log(f"  legacy f32 backward, K4 vs plain, {len(grads_of['plain'])} tensors: worst max|diff|/max|g| {worst:.3e} "
        f"({worst_name}), |diff|/|g| {rel_l2:.3e}, cosine {cos:.6f}; forward + backward launches {per_step}; "
        f"the plain path against itself with weights moved by 1e-7: {floor:.3e} (reported)")
    require(worst <= 1e-3, "legacy float32 gradients: K2/K4 path and plain path disagree")
    del grads_of

    # -- pairs/s (reported, not claimed)
    pairs = {}
    for dt, (kern, plain) in forwards.items():
        for name, fw in (("K2", kern), ("plain", plain)):
            ms = cuda_ms(torch, lambda: fw(x0, x1), iters=10, warmup=3)
            pairs[f"{dtype_name(dt)} {name}"] = 8e3 / ms
            log(f"  legacy 448x1024 B=8 {dtype_name(dt)} {name}: {ms:.3f} ms per batch, {8e3 / ms:.1f} pairs/s")
    return counts, {"pairs_per_s": pairs, "flow_err": errs, "grad_worst_rel": worst, "grad_cosine": cos,
                    "grad_noise_floor": floor}


# ------------------------------------------------------------ sequence serving, TF checkpoints, bf16 in pixels
SEQ_FRAMES = 17  # 16 pairs: two dispatches at B=8
SEQ_TIMED_FRAMES = 65  # 64 pairs, the 17 frames over again: eight dispatches at B=8
BF16_PX_BUDGET = 0.05  # EPE(bf16 vs f32) in px, BASELINE.md's budget for bf16 serving


def smooth_frames(np, h, w, n, seed, shift=(3, 5)):
    """n uint8 frames of ``smooth_pair``'s texture, each shifted by ``shift``
    pixels from the one before."""
    rng = np.random.default_rng(seed)
    base = rng.random((h // 16 + 2, w // 16 + 2, 3))
    img = np.roll(np.kron(base, np.ones((16, 16, 1))), (7, 11), (0, 1))
    return [(np.roll(img, (k * shift[0], k * shift[1]), (0, 1))[:h, :w] * 255).astype(np.uint8) for k in range(n)]


def pairs_close(np, kind, got, want, rtol):
    """Each (flow, pyramid or None) of ``got`` within rtol of the scale of
    ``want``'s, + a floor for all-small flows; logs the worst pair."""
    require(len(got) == len(want), f"{kind}: {len(got)} pairs, want {len(want)}")
    rows = []  # (share of the tolerance, max |diff|, pair, scale)
    for i, ((gf, gp), (wf, wp)) in enumerate(zip(got, want)):
        require(gf.shape == wf.shape and bool(np.isfinite(gf).all()), f"{kind}: pair {i} flow {gf.shape}")
        for a, b in [(gf, wf)] + list(zip(gp or [], wp or [])):
            err, scale = float(abs(a - b).max()), float(abs(b).max())
            require(err <= rtol * scale + 1e-4, f"{kind}: pair {i} differs by {err:.3e} px (scale {scale:.3e})")
            rows.append((err / (rtol * scale + 1e-4), err, i, scale))
    _, err, i, scale = max(rows, key=lambda r: r[0])
    log(f"  {kind}: {len(got)} pairs, worst pair {i} max |diff| {err:.3e} px "
        f"(tol {rtol * scale + 1e-4:.3e}, max |flow| {scale:.3e})")


def sequence_phase(torch, np, card, device, batch_dev, tmp_root):
    """``predict_sequence`` on 17 frames of 448x1024 through a bf16 kernel
    predictor with variance-scaled weights (flows of several px, where the
    default init gives tenths), every pair against ``__call__``; pairs/s
    at depth 2 and 1 beside raw_forward's; the test_continuous CLI's
    --time on PNGs."""
    import io

    import pwcnet_tpu_torch.test_continuous as test_continuous
    from pwcnet_tpu_torch.inference import FlowPredictor
    from pwcnet_tpu_torch.models import PWCDCNet
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.weights import from_jax_params, to_jax_params

    state = from_jax_params(load_script("torch_bf16_parity").scaled_params(
        to_jax_params(PWCDCNet(init=False).state_dict())))
    pred, pred32 = (FlowPredictor(dtype=dt, device=device) for dt in (torch.bfloat16, torch.float32))
    pred.model.load_state_dict(state)
    pred32.model.load_state_dict(state)
    frames = smooth_frames(np, 448, 1024, SEQ_FRAMES, seed=30)

    # -- the main path, counted: B=8 depth 2 (2 dispatches), B=3 'all' (5 + a ragged tail of 1 pair)
    torch.cuda.synchronize()
    reset_launch_counts()
    seq8 = list(pred.predict_sequence(frames, depth=2, batch=8, fetch="flow"))
    seq3 = list(pred.predict_sequence(frames, batch=3, fetch="all"))
    torch.cuda.synchronize()
    counts = launch_counts()
    n_dispatch = 2 + 6
    log(f"  main path: {n_dispatch} dispatches, launches {counts}")
    for kid, per in PER_FORWARD.items():
        require(counts[kid] == per * n_dispatch,
                f"{kid} launched {counts[kid]}x, want {per}x per dispatch x {n_dispatch}")

    # -- every pair against __call__ on the same pair
    calls = [pred(frames[i], frames[i + 1]) for i in range(SEQ_FRAMES - 1)]
    pairs_close(np, "bf16 B=8 depth 2 'flow' vs __call__", [(f, None) for f in seq8], [(c[0], None) for c in calls],
                5e-2)
    pairs_close(np, "bf16 B=3 'all' vs __call__", [(f, p) for f, p, _ in seq3], [(c[0], c[1]) for c in calls], 5e-2)
    for i, (_, _, imgs) in enumerate(seq3):
        require(imgs.dtype == np.float32 and np.array_equal(imgs, calls[i][2]), f"pair {i}'s frames")
    seq32 = list(pred32.predict_sequence(frames[:4], batch=3, fetch="all"))
    calls32 = [pred32(frames[i], frames[i + 1]) for i in range(3)]
    pairs_close(np, "f32 B=3 'all' vs __call__", [(f, p) for f, p, _ in seq32], [(c[0], c[1]) for c in calls32], 1e-4)

    # -- throughput: host clock around whole sequences (the generator ends on the last event)
    timed = [frames[k % SEQ_FRAMES] for k in range(SEQ_TIMED_FRAMES)]

    def seq_pairs_per_s(depth):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in pred.predict_sequence(timed, depth=depth, batch=8, fetch="flow"))
        return n / (time.perf_counter() - t0)

    rounds = {2: [], 1: []}
    seq_pairs_per_s(2)  # warm
    for depth in (2, 1, 1, 2, 2, 1):
        rounds[depth].append(seq_pairs_per_s(depth))
    raw = 8e3 / cuda_ms(torch, lambda: pred.raw_forward(batch_dev), iters=10, warmup=3)
    stats = {f"depth {d}": sorted(r)[1] for d, r in rounds.items()}
    stats["raw_forward"] = raw
    log(f"  448x1024 bf16 kernels, {SEQ_TIMED_FRAMES - 1} pairs at B=8: depth 2 "
        + ", ".join(f"{v:.1f}" for v in rounds[2]) + " pairs/s; depth 1 " + ", ".join(f"{v:.1f}" for v in rounds[1])
        + f" pairs/s; raw_forward B=8 {raw:.1f} pairs/s (CUDA events) on {card}")
    n_pairs = SEQ_TIMED_FRAMES - 1
    stats["profile depth 2"] = profile_steps(
        torch, lambda: sum(1 for _ in pred.predict_sequence(timed, depth=2, batch=8, fetch="flow")), 1,
        f"sequence runs of {n_pairs} pairs at B=8, depth 2", n_pairs * 1e3 / stats["depth 2"])

    # -- the CLI on the frames written as PNGs
    from PIL import Image

    png_dir = os.path.join(tmp_root, "sequence")
    os.makedirs(png_dir)
    for k, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(png_dir, f"frame_{k + 1:04d}.png"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        test_continuous.main(["-i", os.path.join(png_dir, "frame_*.png"), "--time", "--batch", "8",
                              "--dtype", "bfloat16"])
    line = [x for x in out.getvalue().splitlines() if x.startswith("sequence throughput")]
    require(len(line) == 1 and f"{SEQ_FRAMES - 1} pairs" in line[0], "test_continuous --time printed no throughput")
    log(f"  python -m pwcnet_tpu_torch.test_continuous -i 'frame_*.png' --time --batch 8 --dtype bfloat16: "
        f"{line[0]} on {card}")
    stats["cli"] = line[0]
    return counts, {**stats, "rounds": rounds}


def write_tf_bundle(np, prefix, tensors):
    """A TF bundle checkpoint (``<prefix>.index`` + one ``.data`` shard,
    uncompressed) of float32 ``tensors`` by name: the LevelDB table of
    ``BundleEntryProto``s that ``tf.train.Saver`` writes."""

    def varint(n):
        out = b""
        while True:
            b, n = n & 0x7F, n >> 7
            if not n:
                return out + bytes([b])
            out += bytes([b | 0x80])

    def block(pairs):  # no prefix sharing, one restart point
        body = b"".join(varint(0) + varint(len(k)) + varint(len(v)) + k + v for k, v in pairs)
        return body + (0).to_bytes(4, "little") + (1).to_bytes(4, "little")

    def entry(shape, offset, size):  # dtype DT_FLOAT, shape, shard 0, offset, size
        dims = b"".join(b"\x12" + varint(len(d)) + d for d in (b"\x08" + varint(n) for n in shape))
        return (b"\x08\x01" + b"\x12" + varint(len(dims)) + dims + b"\x18\x00" + b"\x20" + varint(offset)
                + b"\x28" + varint(size))

    data, entries = b"", [(b"", b"")]  # the empty key holds the BundleHeaderProto
    for name in sorted(tensors):
        arr = np.asarray(tensors[name], dtype=np.float32)
        entries.append((name.encode(), entry(arr.shape, len(data), arr.nbytes)))
        data += arr.tobytes()
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        f.write(data)
    trailer = b"\x00" * 5  # type byte (uncompressed) and a CRC the reader does not check
    data_block, meta_block = block(entries), block([])
    index_block = block([(entries[-1][0] + b"\xff", varint(0) + varint(len(data_block)))])
    meta_off = len(data_block) + 5
    index_off = meta_off + len(meta_block) + 5
    footer = varint(meta_off) + varint(len(meta_block)) + varint(index_off) + varint(len(index_block))
    footer += b"\x00" * (40 - len(footer)) + (0xDB4775248B80FB57).to_bytes(8, "little")
    with open(f"{prefix}.index", "wb") as f:
        f.write(data_block + trailer + meta_block + trailer + index_block + trailer + footer)


def ckpt_phase(torch, np, device, preds, tmp_root):
    """The seeded predictor's weights written as a TF bundle and as msgpack:
    FlowPredictor(checkpoint=<prefix>.ckpt) on the card gives the msgpack
    weights' flow bit for bit, in bf16 and float32."""
    from pwcnet_tpu_torch.inference import FlowPredictor
    from pwcnet_tpu_torch.weights import save_tree, to_jax_params

    tree = to_jax_params(preds["float32"].model.state_dict())
    tensors = {}

    def collect(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                collect(val, path + [key])
            else:
                tensors["/".join(["pwcdcnet", *path, key])] = val

    collect(tree, [])
    tensors.update({"pwcdcnet/context/conv2d/bias/Adam": np.ones(128, np.float32), "beta1_power": np.float32(0.9),
                    "global_step": np.float32(600.0)})  # skipped, as in the reference bundles
    prefix = os.path.join(tmp_root, "model_600.ckpt")
    write_tf_bundle(np, prefix, tensors)
    msgpack = save_tree(os.path.join(tmp_root, "model_600.msgpack"), tree)
    log(f"  wrote a TF bundle of {len(tensors)} tensors ({len(tensors) - 3} model) and the msgpack of the same tree")
    pair = smooth_pair(np, 448, 1024, 40)
    for dtype in (torch.bfloat16, torch.float32):
        flows = {}
        for kind, path in (("tf", prefix), ("tf .index", prefix + ".index"), ("msgpack", msgpack)):
            flows[kind] = FlowPredictor(checkpoint=path, dtype=dtype, device=device)(*pair)[0]
        for kind in ("tf", "tf .index"):
            require(np.array_equal(flows[kind], flows["msgpack"]),
                    f"{dtype_name(dtype)} flow from the {kind} checkpoint differs from the msgpack one")
        log(f"  {dtype_name(dtype)} 448x1024: the flow from <prefix>.ckpt and .ckpt.index is bitwise the msgpack "
            f"weights' (max |flow| {float(abs(flows['msgpack']).max()):.3e})")
    orbax_round_trip(torch, device, tmp_root)


def orbax_round_trip(torch, device, tmp_root):
    """A CUDA model's TrainState through save_checkpoint_orbax /
    restore_checkpoint_orbax, bitwise, where tensorstore imports; where it
    does not, the save must refuse by naming it (one line)."""
    from pwcnet_tpu_torch.train_lib.checkpoint import restore_checkpoint_orbax, save_checkpoint_orbax
    from pwcnet_tpu_torch.train_lib.step import create_train_state

    directory = os.path.join(tmp_root, "orbax_state")
    state = create_train_state(train_model(torch, torch.float32, True, seed=3), device=device)
    try:
        import tensorstore  # noqa: F401
    except ImportError:
        try:
            save_checkpoint_orbax(directory, state)
        except ModuleNotFoundError as exc:
            require("tensorstore" in str(exc), f"the refusal does not name tensorstore: {exc}")
        else:
            require(False, "save_checkpoint_orbax wrote a directory without tensorstore")
        log("  orbax: tensorstore does not import on this machine; save_checkpoint_orbax refuses by naming it "
            "(round trip not run)")
        return
    gen = torch.Generator(device=device).manual_seed(4)
    for t in [*state.mu.values(), *state.nu.values()]:
        t.copy_(torch.randn(t.shape, generator=gen, device=device))
    state.step = 11
    save_checkpoint_orbax(directory, state)
    fresh = restore_checkpoint_orbax(directory, create_train_state(train_model(torch, torch.float32, True, seed=5),
                                                                   device=device))
    require(fresh.step == 11, "orbax round trip: step")
    pairs = [(state.model.state_dict(), fresh.model.state_dict()), (state.mu, fresh.mu), (state.nu, fresh.nu)]
    for a, b in pairs:
        for k in a:
            require(b[k].device.type == "cuda" and torch.equal(a[k], b[k]), f"orbax round trip: {k}")
    log(f"  orbax: a CUDA TrainState ({len(state.mu)} parameters, Adam moments, step) through "
        "save_checkpoint_orbax / restore_checkpoint_orbax, bitwise")


def converge_phase(torch, card, device):
    """The SyntheticFlow convergence proof on the card with the kernels:
    its four cases from the JAX proof's init ``PRNGKey(CONVERGE_KEY)``, its
    SHA-1 gated against ``CONVERGE_INIT_SHA1``, each case gated at 0.5 px,
    the launches of every step counted against the 3-level model's; the
    multiscale case again, gated bitwise (its EPE's repr and every final
    parameter); the multiscale case on the plain path from the same init as
    a witness (reported, not gated)."""
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.train_lib import convergence as conv

    params = conv.jax_init(CONVERGE_KEY)
    sha1 = conv.params_sha1(params)
    log(f"  init: PRNGKey({CONVERGE_KEY}), the JAX proof's, drawn without JAX: {len(params)} tensors, "
        f"SHA-1 {sha1} (want {CONVERGE_INIT_SHA1})")
    require(sha1 == CONVERGE_INIT_SHA1, f"[converge] the init's SHA-1 {sha1} is not the JAX init's")
    counts = {}
    curves = {}

    def on_start(name):
        torch.cuda.synchronize()
        reset_launch_counts()

    def on_step(name, i, metrics):
        per = CONVERGE_REMAT_PER_STEP if name == "remat" else CONVERGE_PER_STEP
        got = launch_counts()
        want = {k: (i + 1) * per.get(k, 0) for k in got}
        require(got == want, f"[converge] {name} step {i + 1}: launches {got}, want {want}")
        if (i + 1) % 50 == 0:
            curves.setdefault(name, []).append(round(float(metrics["epe"]), 4))
        if i + 1 == conv.STEPS[name]:
            counts[name] = got

    res = conv.run_cases(params, device, use_kernels=True, on_step=on_step, on_start=on_start)
    # a case that fails on the constant flow did not escape it from this init (which inits
    # escape depends on the float order, PERF.md); one that fails elsewhere points at the path
    dset = conv.dataset()
    for name in ("warm", *conv.CASES):
        r = res[name]
        r["constant_flow"] = conv.on_constant_flow(r["epe"], dset)
        log(f"  {name}: {r['steps']} steps, full-set EPE {r['epe']:.4f} px ({float(r['epe'])!r}), "
            f"{r['seconds']:.1f} s with the kernels, "
            f"{'on' if r['constant_flow'] else 'off'} the {conv.constant_flow_epe(dset):.4f} px constant flow "
            f"(training batch EPE every 50 steps: {curves[name]}) on {card}")
        res[name]["batch_epe_every_50"] = curves[name]
    # the multiscale case again: the same EPE bits and every parameter bitwise the first run's
    first = res["multiscale"]
    again = conv.run_cases(params, device, use_kernels=True, cases=("multiscale",))["multiscale"]
    same = sum(torch.equal(v, again["params"][k]) for k, v in first["params"].items())
    rerun = {"epe": again["epe"], "seconds": again["seconds"], "identical_params": same,
             "params": len(first["params"])}
    log(f"  multiscale rerun with the kernels: full-set EPE {float(again['epe'])!r} px (first run "
        f"{float(first['epe'])!r}), {same}/{len(first['params'])} parameters bitwise the first run's, "
        f"{again['seconds']:.1f} s")
    require(repr(float(again["epe"])) == repr(float(first["epe"])) and same == len(first["params"]),
            "[converge] the multiscale rerun differs from the first run")
    for r in (*res.values(), again):
        del r["params"]
    on_start("witness")
    witness = conv.run_cases(params, device, use_kernels=False, cases=("multiscale",))["multiscale"]
    del witness["params"]
    require(not any(launch_counts().values()), "the plain witness launched a kernel")
    log(f"  witness, plain path: multiscale {witness['steps']} steps, full-set EPE {witness['epe']:.4f} px, "
        f"{witness['seconds']:.1f} s (reported, not gated) on {card}")
    for name in conv.CASES:
        require(res[name]["epe"] < conv.EPE_TARGET,
                f"[converge] {name}: full-set EPE {res[name]['epe']:.4f} px, not below {conv.EPE_TARGET} ("
                + ("the constant-flow state: the init did not escape it" if res[name]["constant_flow"]
                   else "not the constant-flow state") + ")")
    total = {k: sum(c.get(k, 0) for c in counts.values()) for k in KERNEL_INFO}
    return total, {"key": CONVERGE_KEY, "init_sha1": sha1, "kernels": res, "plain_multiscale": witness,
                   "rerun": rerun, "rerun_bitwise": rerun["identical_params"] == rerun["params"]}


def load_script(name):
    """A script of ``scripts/`` as a module (the directory is no package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16px_phase(device):
    """scripts/torch_bf16_parity.py at 448x1024 B=4 on both paths, held to the budget."""
    parity = load_script("torch_bf16_parity")
    out = {}
    for path, use_kernels in (("kernels", True), ("plain", False)):
        res = parity.measure(path, 448, 1024, 4, use_kernels, device)
        log(f"  {path}: EPE(bf16 vs f32) {res['epe_bf16_vs_f32']:.4f} px, mean |delta| {res['delta_px_mean']:.4f}, "
            f"p99 {res['delta_px_p99']:.4f}, max {res['delta_px_max']:.4f} px (f32 flow mean |f| "
            f"{res['f32_flow_px_mean_mag']:.3f}, max {res['f32_flow_px_max_mag']:.3f} px) on {res['card']}")
        require(res["epe_bf16_vs_f32"] <= BF16_PX_BUDGET,
                f"{path} path: EPE(bf16 vs f32) {res['epe_bf16_vs_f32']:.4f} px above the {BF16_PX_BUDGET} px budget")
        out[path] = res
    return out


def train_batch(torch, np, device, b, seed=20):
    """A seeded smooth batch at 384x448: frame pairs shifted by a few
    pixels and a smooth ground-truth flow of the same size."""
    h, w = TRAIN_HW
    shifts = [((i % 5) - 2, (i % 7) - 3) for i in range(b)]
    pairs = [np.stack(smooth_pair(np, h, w, seed + i, shift=sh)) for i, sh in enumerate(shifts)]
    images = torch.as_tensor(np.stack(pairs)).to(device).float() / 255.0
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((b, h // 32 + 1, w // 32 + 1, 2)).astype(np.float32)
    wobble = np.kron(coarse, np.ones((1, 32, 32, 1), np.float32))[:, :h, :w]
    base = np.array([[-sx, -sy] for sy, sx in shifts], np.float32)[:, None, None, :]
    return images, torch.as_tensor(base + 0.5 * wobble).to(device)


def train_model(torch, compute_dtype, use_kernels, seed=0, fused_estimator=0, remat=False, fused=True,
                warp_type="bilinear"):
    """The default PWCDCNet as the trainer builds it with --pallas
    (``kernel_hooks``): K2 at level 0, K1 at levels 1-4, K3 on the
    ``FUSED_PYRAMID_LEVELS`` finest pyramid levels, and K7 on the
    ``fused_estimator`` finest estimator levels; ``remat`` as --remat.
    ``fused=False`` (the trainer's ``use_fused`` off, and always with
    ``warp_type='nearest'``): the plain warp and K2 at every level. The
    weights are the JAX package's init under ``PRNGKey(seed)``."""
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet, kernel_hooks
    from pwcnet_tpu_torch.prng import PRNGKey

    hooks = kernel_hooks(use_kernels, fused=fused, fused_estimator=fused_estimator, warp_type=warp_type)
    return PWCDCNet(compute_dtype=compute_dtype, key=PRNGKey(seed), remat=remat,
                    warp_type=warp_type, **hooks)


def legacy_train_model(torch, compute_dtype, seed=0):
    """The legacy PWCNet (6 levels, 'final', BatchNorm, K2's wrapper as its
    cost volume) as ``make_train_step`` calls a model: with ``train=True``
    (BatchNorm on the batch's statistics, the running ones updated), giving
    (final flow, per-level flows)."""
    from pwcnet_tpu_torch.models.pwcnet import PWCNet
    from pwcnet_tpu_torch.prng import PRNGKey

    class Trained(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = PWCNet(batch_norm=True, compute_dtype=compute_dtype, key=PRNGKey(seed))

        def forward(self, images_0, images_1):
            final, flows, _ = self.net(images_0, images_1, train=True)
            return final, flows

    return Trained()


def train(torch, np, device):
    """The training step at 384x448: gradients against the plain path, five
    steps, launch counts, pairs/s and peak memory."""
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.train_lib.step import create_train_state, make_loss_fn, make_train_step

    dtypes = (torch.bfloat16, torch.float32)

    # -- (a) every parameter's gradient, kernel path vs plain path (B=4)
    # float32: the two paths differ in summation order
    # through about 50 layers: each tensor's gradient within 1e-3 of its
    # largest entry. bfloat16: the two paths round activations and
    # cotangents at different places (K3 sums in float32 and rounds, cuDNN
    # rounds elsewhere), and a 1-ulp flip (2^-8) feeds every layer below it.
    # The whole gradient read |diff| / |g| 0.65% and cosine 0.99998 on an
    # H100, the worst tensor (a deep level's bias) 6.7% of its largest
    # entry: the gates are |diff| <= 0.03 |g|, cosine >= 0.999 and 20% for
    # the worst tensor, a few times the readings and far below what a wrong
    # kernel gives.
    images, flows_gt = train_batch(torch, np, device, 4)
    grad_err = {}
    for dt in dtypes:
        grads = {}
        for use_kernels in (True, False):
            state = create_train_state(train_model(torch, dt, use_kernels), device=device)
            total, _ = make_loss_fn(state.model, decoupled_wd=True)(images, flows_gt)
            params = dict(state.model.named_parameters())
            grads[use_kernels] = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        worst, worst_name = 0.0, ""
        for name, want in grads[False].items():
            got = grads[True][name]
            require(got.dtype == torch.float32 and bool(torch.isfinite(got).all()), f"gradient of {name}")
            rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
            if rel > worst:
                worst, worst_name = rel, name
        flat = {k: torch.cat([g.flatten() for g in grads[k].values()]) for k in grads}
        cos = torch.nn.functional.cosine_similarity(flat[True], flat[False], dim=0).item()
        rel_l2 = ((flat[True] - flat[False]).norm() / flat[False].norm()).item()
        name = dtype_name(dt)
        log(f"  gradient {name} B=4, kernels vs plain, {len(grads[True])} tensors: worst max|diff|/max|g| "
            f"{worst:.3e} ({worst_name}), |diff|/|g| {rel_l2:.3e}, cosine {cos:.6f}")
        if dt == torch.float32:
            require(worst <= 1e-3 and cos >= 0.99999, "float32 gradients: kernel path and plain path disagree")
        else:
            require(rel_l2 <= 0.03 and cos >= 0.999 and worst <= 0.2,
                    "bfloat16 gradients: kernel path and plain path disagree")
        grad_err[name] = {"worst_rel": worst, "rel_l2": rel_l2, "cosine": cos}
    del grads, flat, state

    # -- (b), (c), (d): five counted steps at B=8, then the timed steps
    images, flows_gt = train_batch(torch, np, device, 8)
    counts, stats = {}, {}
    for dt in dtypes:
        for use_kernels in (True, False):
            name = f"{dtype_name(dt)} {'kernels' if use_kernels else 'plain'}"
            model = train_model(torch, dt, use_kernels)
            state = create_train_state(model, device=device)
            step = make_train_step(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            losses = []
            for _ in range(5):
                state, metrics = step(state, images, flows_gt)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            got = launch_counts()
            losses = [float(v) for v in losses]
            peak = torch.cuda.max_memory_allocated() / 2**20
            log(f"  {name} B=8: loss {' '.join(f'{v:.3f}' for v in losses)}; step {state.step}; "
                f"launches {got}; peak memory {peak:.0f} MiB")
            require(all(np.isfinite(losses)) and losses[-1] < losses[0], f"{name}: loss not finite and falling")
            require(state.step == 5, f"{name}: step counter {state.step}")
            for p in model.parameters():
                require(p.dtype == torch.float32 and bool(torch.isfinite(p).all()), f"{name}: parameters")
            want = {k: (5 * PER_STEP.get(k, 0) if use_kernels else 0) for k in got}
            require(got == want, f"{name}: launches {got}, want {want}")
            if use_kernels:
                counts[dtype_name(dt)] = got
            ms = cuda_ms(torch, lambda: step(state, images, flows_gt), iters=5, warmup=0)
            stats[name] = {"ms": ms, "pairs_per_s": 8e3 / ms, "peak_mib": peak, "losses": losses}
            log(f"  384x448 B=8 {name}: {ms:.2f} ms per step, {8e3 / ms:.1f} pairs/s")
            if use_kernels:
                stats[name]["profile"] = profile_steps(
                    torch, lambda: step(state, images, flows_gt), 2, f"train steps at 384x448 B=8 {dtype_name(dt)}",
                    ms)
    # the bare step as the trainer phase runs it (K7 on the two finest
    # estimator levels), for the trainer's pairs/s to stand beside
    model = train_model(torch, torch.bfloat16, True, fused_estimator=FUSED_ESTIMATOR)
    state = create_train_state(model, device=device)
    step = make_train_step(model)
    ms = cuda_ms(torch, lambda: step(state, images, flows_gt), iters=10, warmup=3)
    stats["bfloat16 kernels + K7"] = {"ms": ms, "pairs_per_s": 8e3 / ms}
    log(f"  384x448 B=8 bfloat16 kernels + K7 on {FUSED_ESTIMATOR} levels: {ms:.2f} ms per step, {8e3 / ms:.1f} pairs/s")
    stats["bfloat16 kernels + K7"]["profile"] = profile_steps(
        torch, lambda: step(state, images, flows_gt), 2, "train steps at 384x448 B=8 bf16 with K7", ms)
    total_counts = {k: sum(c[k] for c in counts.values()) for k in PER_STEP}
    return total_counts, stats, grad_err


def remat_phase(torch, np, device):
    """--remat's step at 384x448 with the kernels: (a) loss and gradients
    against the step without remat on the same weights, (b) five counted
    steps, (c) step time and peak memory with and without it (reported)."""
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.train_lib.step import create_train_state, make_train_step

    dtypes = (torch.bfloat16, torch.float32)
    stats = {"agreement": {}, "steps": {}, "timing": {}, "profile": {}}

    # -- (a) B=4, one seed, so the same weights, one step through
    # make_train_step each: the forward runs the same kernels with and
    # without remat, so the loss should be bitwise the same (gated at rtol
    # 1e-6). The backwards run the same kernels, all of which give the same
    # bits on the same inputs (K5 sums in fixed point), and cuDNN, which the
    # step runs on its deterministic algorithms: every gradient, read by a
    # hook on its parameter as autograd hands it to the step, must be
    # bitwise the same in both dtypes (PR 18, before the step asked for
    # them, read float32 differences up to 7.6e-6); the float32 gradients
    # are also held within 1e-4 of each tensor's largest entry, bf16 at
    # [train]'s gates
    images, flows_gt = train_batch(torch, np, device, 4)

    def grads(dt, fe, remat):
        model = train_model(torch, dt, True, fused_estimator=fe, remat=remat)
        state = create_train_state(model, device=device)
        got = {}
        hooks = [p.register_hook(lambda g, k=k: got.__setitem__(k, g.detach().clone()))
                 for k, p in model.named_parameters()]
        _, metrics = make_train_step(model)(state, images, flows_gt)
        for h in hooks:
            h.remove()
        require(len(got) == len(hooks), f"{len(got)} of {len(hooks)} gradients read")
        return metrics["loss"], got

    def largest_diff(got, want):
        return max((((got[k] - w).abs().max().item(), k) for k, w in want.items()), default=(0.0, ""))

    for dt in dtypes:
        for fe in (0, FUSED_ESTIMATOR):
            out = {remat: grads(dt, fe, remat) for remat in (False, True)}
            loss_rel = abs(float(out[True][0]) - float(out[False][0])) / abs(float(out[False][0]))
            worst, worst_name, rel_l2, cos = grad_agreement(torch, out[True][1], out[False][1])
            diff, diff_name = largest_diff(out[True][1], out[False][1])
            name = f"{dtype_name(dt)}{f' + K7 on {fe} levels' if fe else ''}"
            log(f"  {name} B=4, remat vs not: loss {float(out[True][0]):.6f} / {float(out[False][0]):.6f} "
                f"(rel {loss_rel:.3e}, bitwise {bool(torch.equal(out[True][0], out[False][0]))}); gradients of "
                f"{len(out[True][1])} tensors: worst max|diff|/max|g| {worst:.3e} ({worst_name}), |diff|/|g| "
                f"{rel_l2:.3e}, cosine {cos:.7f}; largest |diff| {diff!r} ({diff_name if diff else 'none'}), "
                f"{sum(torch.equal(out[True][1][k], w) for k, w in out[False][1].items())} tensors bitwise equal")
            require(loss_rel <= 1e-6, f"{name}: the remat loss differs from the loss without it")
            stats["agreement"][name] = {"loss_rel": loss_rel, "worst_rel": worst, "rel_l2": rel_l2, "cosine": cos,
                                        "max_abs_diff": diff, "max_abs_diff_tensor": diff_name if diff else None}
            if dt == torch.float32:
                require(worst <= 1e-4, f"{name}: remat and no-remat float32 gradients disagree")
            else:
                require(rel_l2 <= 0.03 and cos >= 0.999 and worst <= 0.2,
                        f"{name}: remat and no-remat bfloat16 gradients disagree")
            require(diff == 0.0, f"{name}: remat and no-remat gradients differ by {diff!r} ({diff_name})")
    del out

    # -- (b) five counted remat steps at B=8
    images, flows_gt = train_batch(torch, np, device, 8)
    counts = {}
    for dt, fe in ((torch.bfloat16, 0), (torch.float32, 0), (torch.bfloat16, FUSED_ESTIMATOR)):
        name = f"{dtype_name(dt)}{f' + K7 on {fe} levels' if fe else ''}"
        model = train_model(torch, dt, True, fused_estimator=fe, remat=True)
        state = create_train_state(model, device=device)
        step = make_train_step(model)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = []
        for _ in range(5):
            state, metrics = step(state, images, flows_gt)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        got = launch_counts()
        losses = [float(v) for v in losses]
        per = REMAT_PER_STEP if not fe else TRAINER_REMAT_PER_STEP
        log(f"  {name} remat B=8: loss {' '.join(f'{v:.3f}' for v in losses)}; launches {got}")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0], f"{name} remat: loss not finite and falling")
        want = {k: 5 * per.get(k, 0) for k in got}
        require(got == want, f"{name} remat: launches {got}, want {want}")
        counts[name] = got
        stats["steps"][name] = losses

    # -- (c) ms per step and peak memory, remat against not, in turns
    for b in REMAT_BATCHES:
        images, flows_gt = (images, flows_gt) if b == 8 else train_batch(torch, np, device, b)
        for dt in dtypes:
            # in turns at B=8; one turn a side at B=32, to keep the whole run inside its time
            for remat in (False, True, True, False) if b == 8 else (False, True):
                name = f"{dtype_name(dt)} B={b} {'remat' if remat else 'no remat'}"
                model = train_model(torch, dt, True, remat=remat)
                state = create_train_state(model, device=device)
                step = make_train_step(model)
                step(state, images, flows_gt)  # warm-up: Adam's moments exist from here on
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step(state, images, flows_gt)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                ms = cuda_ms(torch, lambda: step(state, images, flows_gt), iters=5, warmup=1)
                row = stats["timing"].setdefault(name, {"ms": [], "peak_mib": peak / 2**20,
                                                        "step_mib": (peak - before) / 2**20})
                row["ms"].append(ms)
                log(f"  384x448 {name}: {ms:.2f} ms per step, {b * 1e3 / ms:.1f} pairs/s; peak memory "
                    f"{peak / 2**20:.0f} MiB ({(peak - before) / 2**20:.0f} MiB above the step's start)")
                if remat and b == 8 and name not in stats["profile"]:
                    stats["profile"][name] = profile_steps(
                        torch, lambda: step(state, images, flows_gt), 2, f"train steps at 384x448 {name}", ms)
                del model, state, step
        if b != 8:
            del images, flows_gt
        torch.cuda.empty_cache()
    for dt in dtypes:
        for b in REMAT_BATCHES:
            off, on = (stats["timing"][f"{dtype_name(dt)} B={b} {k}"] for k in ("no remat", "remat"))
            log(f"  remat at 384x448 {dtype_name(dt)} B={b}: {sum(on['ms']) / len(on['ms']):.2f} ms per step against "
                f"{sum(off['ms']) / len(off['ms']):.2f} ({100 * (sum(on['ms']) / sum(off['ms']) - 1):+.1f}%), peak memory "
                f"{on['peak_mib']:.0f} MiB against {off['peak_mib']:.0f} ({100 * (on['peak_mib'] / off['peak_mib'] - 1):+.1f}%)")
    return {k: sum(c[k] for c in counts.values()) for k in got}, stats


DETERMINISM_PATHS = ("kernels", "plain", "unfused", "nearest", "remat", "legacy")


def determinism_model(torch, path, compute_dtype):
    """The model of one of ``DETERMINISM_PATHS``: the default kernel path,
    the plain path (no kernel), ``use_fused=False`` (the plain warp, K2 at
    every level), the nearest warp (likewise), ``--remat`` with the kernels,
    and the legacy PWCNet with BatchNorm under ``train=True``."""
    if path == "legacy":
        return legacy_train_model(torch, compute_dtype)
    return train_model(torch, compute_dtype, path != "plain", remat=path == "remat",
                       fused=path not in ("unfused", "nearest"),
                       warp_type="nearest" if path == "nearest" else "bilinear")


def determinism_phase(torch, np, device):
    """Two train steps at 384x448 B=8 through ``make_train_step``, each from
    a fresh state of one seed on one batch, in float32 and bf16, on each of
    ``DETERMINISM_PATHS``, with no flag set here: every parameter, Adam first
    moment and buffer (the legacy model's BatchNorm statistics) must come
    out bitwise the same, and the step must leave ``cudnn.deterministic``
    at the caller's value. Then the default path once more under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
    warnings name the ops it has no deterministic version of (reported)."""
    import warnings

    from pwcnet_tpu_torch.train_lib.step import create_train_state, make_train_step

    images, flows_gt = train_batch(torch, np, device, 8)
    stats = {}

    def two_steps(path, dt):
        states = []
        for _ in range(2):
            model = determinism_model(torch, path, dt)
            state = create_train_state(model, device=device)
            caller = torch.backends.cudnn.deterministic
            state, _ = make_train_step(model)(state, images, flows_gt)
            torch.cuda.synchronize()
            require(torch.backends.cudnn.deterministic == caller,
                    f"[determinism] {path}: the step left cudnn.deterministic at "
                    f"{torch.backends.cudnn.deterministic}, the caller's was {caller}")
            # the first moment is (1 - b1) g: one Adam step from zero moments moves each weight by about
            # lr sign(g), which hides a difference in g's last bits, so the moments are compared too
            states.append({**{f"param {k}": v for k, v in model.named_parameters()},
                           **{f"mu {k}": v for k, v in state.mu.items()},
                           **{f"buffer {k}": v for k, v in model.named_buffers()}})
            del model, state
        return states

    def compare(name, a, b):
        equal = {part: sum(torch.equal(a[k], b[k]) for k in a if k.startswith(part))
                 for part in ("param", "mu", "buffer")}
        count = {part: sum(k.startswith(part) for k in a) for part in equal}
        diff, where = max(((a[k].float() - b[k].float()).abs().max().item(), k) for k in a)
        log(f"  {name}: after one step, {equal['param']}/{count['param']} parameters, {equal['mu']}/{count['mu']} "
            f"first moments (0.1 g) and {equal['buffer']}/{count['buffer']} buffers identical, largest |diff| "
            f"{diff!r} ({where if diff else 'none'})")
        stats[name] = {"identical": equal, "tensors": count, "max_abs_diff": diff,
                       "max_abs_diff_tensor": where if diff else None}
        return equal == count

    for path in DETERMINISM_PATHS:
        for dt in (torch.float32, torch.bfloat16):
            name = f"{path} {dtype_name(dt)}"
            require(compare(name, *two_steps(path, dt)), f"[determinism] {name}: two steps from one state differ")
        torch.cuda.empty_cache()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for dt in (torch.float32, torch.bfloat16):
                compare(f"use_deterministic_algorithms kernels {dtype_name(dt)}", *two_steps("kernels", dt))
        finally:
            torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split(" does not have")[0] for w in caught if "deterministic" in str(w.message)})
    if named:
        log("  use_deterministic_algorithms: PyTorch warned of " + "; ".join(named))
    stats["use_deterministic_algorithms warnings"] = named
    torch.cuda.empty_cache()
    return stats


def write_chairs(np, root, n=CHAIRS_SAMPLES, seed=100):
    """A FlyingChairs-layout dataset written with numpy alone:
    ``<root>/data/NNNNN_img1.ppm``, ``_img2.ppm`` (P6) and ``_flow.flo``.
    Frame 2 is frame 1's texture moved by a whole-pixel flow near (3, -2),
    so the flow is exact and its mean is something to learn."""
    h, w = CHAIRS_HW
    data = os.path.join(root, "data")
    os.makedirs(data)
    rng = np.random.default_rng(seed)
    m = 16  # margin around the frame, more than any shift
    header = f"P6\n{w} {h}\n255\n".encode()
    for i in range(n):
        coarse = rng.random(((h + 2 * m) // 8 + 1, (w + 2 * m) // 8 + 1, 3))
        big = (np.kron(coarse, np.ones((8, 8, 1))) * 255).astype(np.uint8)
        dx = 3 + int(rng.integers(-1, 2))
        dy = -2 + int(rng.integers(-1, 2))
        img1 = big[m : m + h, m : m + w]
        img2 = big[m - dy : m - dy + h, m - dx : m - dx + w]  # img2(p + flow) = img1(p)
        flow = np.empty((h, w, 2), np.float32)
        flow[..., 0], flow[..., 1] = dx, dy
        stem = os.path.join(data, f"{i + 1:05d}")
        for name, img in (("img1", img1), ("img2", img2)):
            with open(f"{stem}_{name}.ppm", "wb") as f:
                f.write(header + np.ascontiguousarray(img).tobytes())
        with open(f"{stem}_flow.flo", "wb") as f:
            f.write(np.float32(202021.25).tobytes() + np.int32(w).tobytes() + np.int32(h).tobytes())
            f.write(flow.tobytes())


@contextlib.contextmanager
def working_directory(path):
    """The trainer writes ./model, ./logs and config.json where it runs."""
    before = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(before)


@contextlib.contextmanager
def first_batches_recorded(record):
    """While active, every shuffling DataLoader notes the SHA-1 of the first
    batch of each epoch it yields in ``record[epoch]`` (the bytes of images
    and flows as the loader hands them to the trainer)."""
    from pwcnet_tpu_torch.data.pipeline import DataLoader

    original = DataLoader.__iter__

    def recording(self):
        epoch = self.epoch
        for i, batch in enumerate(original(self)):
            if i == 0 and self.shuffle:
                digest = hashlib.sha1()
                for leaf in batch:
                    digest.update(leaf.tobytes())
                record[epoch] = digest.hexdigest()
            yield batch

    DataLoader.__iter__ = recording
    try:
        yield
    finally:
        DataLoader.__iter__ = original


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def trainer_phase(torch, np, card, tmp_root):
    """pwcnet_tpu_torch.train.main and .evaluate.main on a dataset written
    under ``tmp_root/chairs`` (which the [spatial] phase reads again)."""
    from pwcnet_tpu_torch import evaluate as evaluate_cli, train as train_cli
    from pwcnet_tpu_torch.data import DataLoader, get_dataset
    from pwcnet_tpu_torch.inference import FlowPredictor
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    stats = {}
    root = os.path.join(tmp_root, "chairs")
    t0 = time.perf_counter()
    write_chairs(np, root)
    log(f"  wrote {CHAIRS_SAMPLES} samples of {CHAIRS_HW[0]}x{CHAIRS_HW[1]} in {time.perf_counter() - t0:.1f} s")
    base = ["-d", "FlyingChairs", "-dd", root, "-b", "8", "-e", "2", "--crop_type", "random",
            "--crop_shape", "384", "448", "--dtype", "bfloat16", "--no-visualize",
            "--log_interval", "11", "-nw", "4"]
    fused = ["--fused-estimator", str(FUSED_ESTIMATOR)]

    # -- the main path, counted: two epochs through the CLI
    first = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    with working_directory(os.path.join(tmp_root, "run")), first_batches_recorded(first):
        trainer = train_cli.main(base + fused)
        logdir = os.path.abspath(trainer.logdir)
    torch.cuda.synchronize()
    counts = launch_counts()
    steps, vals = 2 * len(trainer.tloader), 2 * len(trainer.vloader)
    log(f"  trainer: {steps} steps and {vals} validation batches, launches {counts}")
    require(trainer.tloader.path == "native",
            "the trainer's loader did not take the native path")
    require(steps == 44 and vals == 4, f"{steps} steps and {vals} validation batches, want 44 and 4")
    want = {k: TRAINER_PER_STEP.get(k, 0) * steps + TRAINER_PER_FORWARD.get(k, 0) * vals for k in counts}
    require(counts == want, f"trainer launches {counts}, want {want}")
    require(trainer.state.step == steps, f"step counter {trainer.state.step}")
    ckpts = [os.path.join(logdir, "model", f"model_{e}.msgpack") for e in (1, 2)]
    for path in ckpts + [os.path.join(logdir, d, "metrics.jsonl") for d in ("train", "val")]:
        require(os.path.isfile(path) and os.path.getsize(path) > 0, f"{path} is missing")
    logged = read_jsonl(os.path.join(logdir, "train", "metrics.jsonl"))
    losses = [r["loss/pwc"] for r in logged]
    val = [r["loss/pwc"] for r in read_jsonl(os.path.join(logdir, "val", "metrics.jsonl"))]
    log(f"  logged train loss at steps {[r['step'] for r in logged]}: {' '.join(f'{v:.3f}' for v in losses)}; "
        f"validation loss per epoch: {' '.join(f'{v:.3f}' for v in val)}")
    require(len(losses) == 4 and all(np.isfinite(losses + val)), "the logged losses")
    require(losses[-1] < losses[0], "the loss at the end of epoch 2 is not below the first logged loss")
    stats["trainer_epochs"] = trainer.epoch_stats
    stats["losses"] = losses
    stats["val_losses"] = val

    # -- resume from the first epoch's checkpoint: same first batch, same bytes
    resumed = {}
    for name, extra in (("resumed", fused), ("resumed_cudnn_estimator", ["--fused-estimator", "0"])):
        seen = {}
        with working_directory(os.path.join(tmp_root, name)), first_batches_recorded(seen):
            again = train_cli.main(base + extra + ["-r", ckpts[0]])
        require(again._resume_epoch == 1 and again.state.step == steps,
                f"{name}: resumed at epoch {again._resume_epoch}, ended at step {again.state.step}")
        require(list(seen) == [1] and seen[1] == first[1],
                f"{name}: the first batch after --resume differs from the first run's first batch of epoch 2")
        resumed[name] = again.epoch_stats[-1]
    log(f"  --resume model_1.msgpack: first batch of epoch 2 has the bytes of the first run's (sha1 {first[1][:12]})")
    stats["resumed_epochs"] = resumed

    # -- two one-epoch float32 runs from one seed (the CLI's default dtype, K7 off): byte-identical
    # model_1.msgpack? Reported; the first batches' SHA-1s tell the loader from the step
    f32 = [a if a != "bfloat16" else "float32" for a in base] + ["-e", "1"]
    runs = []
    for i in range(2):
        seen = {}
        with working_directory(os.path.join(tmp_root, f"float32_{i}")), first_batches_recorded(seen):
            run = train_cli.main(f32)
            path = os.path.join(os.path.abspath(run.logdir), "model", "model_1.msgpack")
        with open(path, "rb") as f:
            runs.append({"model_1_sha1": hashlib.sha1(f.read()).hexdigest(), "first_batch_sha1": seen.get(0),
                         "steps": run.state.step})
    identical = runs[0]["model_1_sha1"] == runs[1]["model_1_sha1"]
    log(f"  two one-epoch float32 runs from one seed ({runs[0]['steps']} steps each): model_1.msgpack "
        f"{'byte-identical' if identical else 'differs'} (sha1 {runs[0]['model_1_sha1'][:12]} / "
        f"{runs[1]['model_1_sha1'][:12]}); first batch sha1 {runs[0]['first_batch_sha1'][:12]} / "
        f"{runs[1]['first_batch_sha1'][:12]} (reported)")
    stats["float32_epochs"] = {"identical": identical, "runs": runs}

    # -- --remat: one epoch, counted; its checkpoint serves
    torch.cuda.synchronize()
    reset_launch_counts()
    with working_directory(os.path.join(tmp_root, "remat")):
        remat = train_cli.main(base + fused + ["--remat", "-e", "1"])
        remat_dir = os.path.abspath(remat.logdir)
    torch.cuda.synchronize()
    got = launch_counts()
    r_steps, r_vals = len(remat.tloader), len(remat.vloader)
    want = {k: TRAINER_REMAT_PER_STEP.get(k, 0) * r_steps + TRAINER_PER_FORWARD.get(k, 0) * r_vals for k in got}
    log(f"  --remat: {r_steps} steps and {r_vals} validation batches, launches {got}")
    require(remat.model.remat and remat.state.step == r_steps == steps // 2, f"--remat: step {remat.state.step}")
    require(got == want, f"--remat trainer launches {got}, want {want}")
    remat_losses = [r["loss/pwc"] for r in read_jsonl(os.path.join(remat_dir, "train", "metrics.jsonl"))]
    remat_val = [r["loss/pwc"] for r in read_jsonl(os.path.join(remat_dir, "val", "metrics.jsonl"))]
    log(f"  --remat logged train loss {' '.join(f'{v:.3f}' for v in remat_losses)}, validation "
        f"{' '.join(f'{v:.3f}' for v in remat_val)} (the first run's epoch 1: {' '.join(f'{v:.3f}' for v in losses[:2])}, "
        f"{val[0]:.3f})")
    require(len(remat_losses) == 2 and all(np.isfinite(remat_losses + remat_val)), "--remat: the logged losses")
    pred = FlowPredictor(checkpoint=os.path.join(remat_dir, "model", "model_1.msgpack"), dtype=torch.bfloat16)
    flow = pred(*smooth_pair(np, 384, 448, 5))[0]
    require(flow.shape == (384, 448, 2) and bool(np.isfinite(flow).all()), "--remat: model_1.msgpack does not serve")
    stats["remat"] = {"counts": got, "losses": remat_losses, "val_losses": remat_val, "epoch": remat.epoch_stats[-1]}

    # -- evaluate the trained checkpoint, kernels on and off
    epe = {}
    for flag in ("--pallas", "--no-pallas"):
        reset_launch_counts()
        epe[flag] = evaluate_cli.main(["-d", "FlyingChairs", "-dd", root, "--split", "val", "-b", "8",
                                       "-r", ckpts[1], "--dtype", "bfloat16", flag])
        got = launch_counts()
        per = PER_FORWARD if flag == "--pallas" else {}
        require(all(got[k] == per.get(k, 0) * 3 for k in got), f"evaluate {flag}: launches {got}")
    # the serving tolerance: the two paths round at different places
    log(f"  evaluate on 20 val frames: EPE {epe['--pallas']:.4f} px with the kernels, "
        f"{epe['--no-pallas']:.4f} px on the plain path")
    require(all(np.isfinite(list(epe.values()))), "evaluate: EPE")
    require(abs(epe["--pallas"] - epe["--no-pallas"]) <= 5e-2 * epe["--no-pallas"] + 1e-4,
            "evaluate: kernel path and plain path disagree")
    stats["epe"] = epe

    # -- the loader alone: one epoch of host batches, no model
    dset = get_dataset("FlyingChairs")(train_or_val="train", dataset_dir=root, crop_type="random",
                                       crop_shape=(384, 448))
    loader = DataLoader(dset, batch_size=8, shuffle=True, num_workers=4)
    require(loader.path == "native", "the timed loader did not take the native path")
    t0 = time.perf_counter()
    n = sum(images.shape[0] for images, _ in loader)
    stats["loader_pairs_per_s"] = n / (time.perf_counter() - t0)

    def rate(e):
        return e["steps"] * 8 / e["train_seconds"]

    stats["pairs_per_s"] = {
        "trainer epoch 1 (K7 on 2 levels)": rate(stats["trainer_epochs"][0]),
        "trainer epoch 2 (K7 on 2 levels)": rate(stats["trainer_epochs"][1]),
        "resumed epoch 2 (K7 on 2 levels)": rate(resumed["resumed"]),
        "resumed epoch 2 (cuDNN estimators)": rate(resumed["resumed_cudnn_estimator"]),
        "remat epoch 1 (K7 on 2 levels)": rate(stats["remat"]["epoch"]),
        "loader alone": stats["loader_pairs_per_s"],
    }
    for k, v in stats["pairs_per_s"].items():
        log(f"  {k}: {v:.1f} pairs/s on {card}")
    return counts, stats


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def grad_agreement(torch, got: dict, want: dict):
    """(worst max|diff|/max|g| over tensors and its name, |diff|/|g|, cosine)."""
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        g = got[name]
        require(g.dtype == torch.float32 and bool(torch.isfinite(g).all()), f"gradient of {name}")
        rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    a = torch.cat([got[k].flatten() for k in want])
    b = torch.cat([want[k].flatten() for k in want])
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    return worst, worst_name, ((a - b).norm() / b.norm()).item(), cos


def spatial_rank(rank, port, out_dir, chairs_root):
    """One of the SHARDS ranks of the [spatial] phase, spawned on the one
    card: every sub-phase runs with the launch counts set to 0 just before
    it and read just after; rank 0 also runs the unsharded references. The
    report goes to ``out_dir/rank<r>.json``; a failure raises (the process
    exits non-zero)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pwcnet_tpu_torch import evaluate as evaluate_cli, train as train_cli
    from pwcnet_tpu_torch.inference import FlowPredictor
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet, kernel_hooks
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.parallel import global_sum, make_mesh, shard_batch
    from pwcnet_tpu_torch.prng import PRNGKey
    from pwcnet_tpu_torch.train_lib.step import create_train_state, make_loss_fn, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    mesh = make_mesh(spatial=SHARDS, device=device, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                     world_size=SHARDS, backend="gloo")
    main = rank == 0
    report = {"rank": rank, "launches": {}, "seconds": {}}

    def counted(name, fn):
        torch.cuda.synchronize()
        dist.barrier()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        report["seconds"][name] = time.perf_counter() - t0
        report["launches"][name] = launch_counts()
        return result

    # -- serving, 448x1024 B=8, bf16 and f32
    h, w = SPATIAL_SERVE_HW
    batch = np.stack([np.stack(smooth_pair(np, h, w, 10 + i)) for i in range(8)])
    batch_dev = torch.as_tensor(batch).to(device)
    preds = {dt: FlowPredictor(dtype=dt, mesh=mesh) for dt in (torch.bfloat16, torch.float32)}
    flows = counted("serve", lambda: {dt: p.raw_forward(batch_dev)[0] for dt, p in preds.items()})
    ms = cuda_ms(torch, lambda: preds[torch.bfloat16].raw_forward(batch_dev), iters=5, warmup=1)
    report["serve_pairs_per_s"] = 8e3 / ms
    pair = smooth_pair(np, *SPATIAL_K8_HW, 30)
    big = counted("serve_1024", lambda: {dt: p(*pair)[0] for dt, p in preds.items()})
    if main:
        for dt, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            name = dtype_name(dt)
            unsharded = FlowPredictor(dtype=dt, device=device)
            report[f"serve_err_{name}"] = flow_close(
                f"sharded vs unsharded {name} 448x1024 B=8", flows[dt], unsharded.raw_forward(batch_dev)[0], rtol)
            report[f"serve_err_1024_{name}"] = flow_close(
                f"sharded vs unsharded {name} 1024x1024 (level 0 sharded)", big[dt], unsharded(*pair)[0], rtol)
    del preds, flows, big

    # -- the unfused and the nearest warp (448x1024 B=8, bf16 and f32): the
    # guard warps each shard's rows against the gathered frame 1, K8
    # correlates them; held as the default predictor is. [sequence]'s
    # variance-scaled weights give flows of several px (the default init's
    # tenths would truncate to no displacement in the nearest warp)
    from pwcnet_tpu_torch.weights import from_jax_params, to_jax_params

    scaled = from_jax_params(load_script("torch_bf16_parity").scaled_params(
        to_jax_params(PWCDCNet(init=False).state_dict())))
    for opt, kw in SPATIAL_OPTIONS.items():
        preds = {dt: FlowPredictor(dtype=dt, mesh=mesh, **kw) for dt in (torch.bfloat16, torch.float32)}
        for p in preds.values():
            p.model.load_state_dict(scaled)
        flows = counted(f"serve_{opt}", lambda: {dt: p.raw_forward(batch_dev)[0] for dt, p in preds.items()})
        if main:
            for dt, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
                name = dtype_name(dt)
                unsharded = FlowPredictor(dtype=dt, device=device, **kw)
                unsharded.model.load_state_dict(scaled)
                report[f"serve_err_{opt}_{name}"] = flow_close(
                    f"sharded vs unsharded {opt} {name} 448x1024 B=8", flows[dt], unsharded.raw_forward(batch_dev)[0],
                    rtol)
        del preds, flows

    # -- predict_sequence on the (1 x 2) mesh: [sequence]'s 17 frames and
    # weights, bf16, B=8 depth 2, flows only; every pair against the
    # unsharded stream (rank 0), pairs/s of both on the host clock
    frames = smooth_frames(np, *SPATIAL_SERVE_HW, SEQ_FRAMES, seed=30)
    timed_frames = [frames[k % SEQ_FRAMES] for k in range(SEQ_TIMED_FRAMES)]
    pred = FlowPredictor(dtype=torch.bfloat16, mesh=mesh)
    pred.model.load_state_dict(scaled)
    seq = counted("sequence", lambda: list(pred.predict_sequence(frames, depth=2, batch=8, fetch="flow")))

    def pairs_per_s(p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in p.predict_sequence(timed_frames, depth=2, batch=8, fetch="flow"))
        return n / (time.perf_counter() - t0)

    pairs_per_s(pred)  # warm
    dist.barrier()
    report["sequence_pairs_per_s"] = pairs_per_s(pred)
    if main:
        unsharded = FlowPredictor(dtype=torch.bfloat16, device=device)
        unsharded.model.load_state_dict(scaled)
        want = list(unsharded.predict_sequence(frames, depth=2, batch=8, fetch="flow"))
        pairs_close(np, "sharded vs unsharded predict_sequence bf16 B=8 depth 2 'flow'", [(f, None) for f in seq],
                    [(f, None) for f in want], 5e-2)
        pairs_per_s(unsharded)  # warm
        report["sequence_unsharded_pairs_per_s"] = pairs_per_s(unsharded)
        del unsharded
    dist.barrier()
    del pred
    # the same weights in float32 on 5 frames at B=3 (a dispatch of 3 pairs and a padded one of 1),
    # every pair held at [serve]'s float32 bound
    pred = FlowPredictor(dtype=torch.float32, mesh=mesh)
    pred.model.load_state_dict(scaled)
    seq = counted("sequence_f32", lambda: list(pred.predict_sequence(frames[:5], depth=2, batch=3, fetch="flow")))
    if main:
        unsharded = FlowPredictor(dtype=torch.float32, device=device)
        unsharded.model.load_state_dict(scaled)
        want = list(unsharded.predict_sequence(frames[:5], depth=2, batch=3, fetch="flow"))
        pairs_close(np, "sharded vs unsharded predict_sequence float32 B=3 depth 2 'flow'", [(f, None) for f in seq],
                    [(f, None) for f in want], 1e-4)
        del unsharded
    dist.barrier()
    del pred

    # -- the train step, 384x448 B=8, data 1 x spatial 2: the first step's
    # gradients against the unsharded step in float32 and bf16 compute, then
    # five bf16 steps. Bounds as the [train] phase's kernel-vs-plain check:
    # float32 differs in summation order only (each tensor within 1e-3 of
    # its largest entry, cosine >= 0.99999); bf16 rounds at other places
    # (|diff| <= 0.03 |g|, cosine >= 0.999, worst tensor 20%). On rank 0 the
    # unsharded kernel path is also held against the unsharded plain path
    # in bf16 on the same batch: the gap that rounding alone opens.
    images, flows_gt = train_batch(torch, np, device, 8)
    loc_images = shard_batch(images, mesh, 2, split_batch=False)
    loc_flows = shard_batch(flows_gt, mesh, 1, split_batch=False)

    def first_grads(model, sharded):
        create_train_state(model, device=device)
        if sharded:
            objective, _ = make_loss_fn(model, mesh=mesh, decoupled_wd=True)(loc_images, loc_flows)
        else:
            objective, _ = make_loss_fn(model, decoupled_wd=True)(images, flows_gt)
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(objective, list(named.values()))))
        return {k: global_sum(g) for k, g in grads.items()} if sharded else grads

    report["gradient"] = {}
    for dt in (torch.float32, torch.bfloat16):
        name = dtype_name(dt)
        model = PWCDCNet(compute_dtype=dt, key=PRNGKey(0), **kernel_hooks(True, mesh=mesh))
        grads = first_grads(model, True)
        if main:
            want = first_grads(train_model(torch, dt, True), False)
            worst, worst_name, rel_l2, cos = grad_agreement(torch, grads, want)
            log(f"  [rank 0] first-step gradient {name} B=8, sharded vs unsharded: worst max|diff|/max|g| "
                f"{worst:.3e} ({worst_name}), |diff|/|g| {rel_l2:.3e}, cosine {cos:.6f}")
            report["gradient"][name] = {"worst_rel": worst, "worst_tensor": worst_name, "rel_l2": rel_l2,
                                        "cosine": cos}
            if dt == torch.float32:
                require(worst <= 1e-3 and cos >= 0.99999, "float32 sharded gradients disagree with the unsharded step")
            else:
                require(rel_l2 <= 0.03 and cos >= 0.999 and worst <= 0.2,
                        "bf16 sharded gradients disagree with the unsharded step")
                base = grad_agreement(torch, want, first_grads(train_model(torch, dt, False), False))
                log(f"  [rank 0] the same bf16 batch unsharded, kernels vs plain: worst {base[0]:.3e} ({base[1]}), "
                    f"|diff|/|g| {base[2]:.3e}, cosine {base[3]:.6f}")
                report["gradient"]["bfloat16 unsharded kernels vs plain"] = dict(zip(
                    ("worst_rel", "worst_tensor", "rel_l2", "cosine"), base))
            del want
        del grads
    # the bf16 model of the last round goes on to the steps
    state = create_train_state(model, device=device)
    step = make_train_step(model, mesh=mesh)

    def five_steps():
        nonlocal state
        out = []
        for _ in range(5):
            state, metrics = step(state, loc_images, loc_flows)
            out.append(metrics["loss"])
        return [float(v) for v in out]

    losses = counted("train", five_steps)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], f"sharded steps: losses {losses}")
    report["train_losses"] = losses
    ms = cuda_ms(torch, lambda: step(state, loc_images, loc_flows), iters=3, warmup=1)
    report["train_pairs_per_s"] = 8e3 / ms
    checksum = torch.stack([p.detach().double().sum() for p in model.parameters()]).sum()
    require(float((global_sum(checksum) / SHARDS - checksum).abs()) == 0.0, "the ranks' parameters differ")
    del model, state, step

    # -- train.main --spatial 2: one epoch, one resumed, evaluate --spatial 2
    run = os.path.join(out_dir, f"rank{rank}")
    os.makedirs(run, exist_ok=True)
    os.chdir(run)
    base = ["-d", "FlyingChairs", "-dd", chairs_root, "-b", "8", "--crop_type", "random", "--crop_shape", "384",
            "448", "--dtype", "bfloat16", "--no-visualize", "--log_interval", "11", "-nw", "4", "--spatial",
            str(SHARDS), "--device", "cuda:0"]
    trainer = counted("trainer", lambda: train_cli.main(base + ["-e", "1"]))
    paths = [os.path.abspath(trainer.logdir) if main else None]
    dist.broadcast_object_list(paths, src=0)
    ckpt1 = os.path.join(paths[0], "model", "model_1.msgpack")
    report["trainer_epochs"] = trainer.epoch_stats
    # the resumed run in a directory of its own: within the same minute its
    # log directory would take the first run's name
    resumed_run = os.path.join(out_dir, f"rank{rank}_resumed")
    os.makedirs(resumed_run, exist_ok=True)
    os.chdir(resumed_run)
    resumed = counted("trainer_resumed", lambda: train_cli.main(base + ["-e", "2", "-r", ckpt1]))
    require(resumed._resume_epoch == 1 and resumed.state.step == 2 * trainer.state.step,
            f"resumed at epoch {resumed._resume_epoch}, ended at step {resumed.state.step}")
    paths = [os.path.abspath(resumed.logdir) if main else None]
    dist.broadcast_object_list(paths, src=0)
    ckpt2 = os.path.join(paths[0], "model", "model_2.msgpack")
    report["resumed_epochs"] = resumed.epoch_stats
    report["epe"] = counted("evaluate", lambda: evaluate_cli.main(
        ["-d", "FlyingChairs", "-dd", chairs_root, "--split", "val", "-b", "8", "-r", ckpt2, "--dtype", "bfloat16",
         "--spatial", str(SHARDS), "--device", "cuda:0"]))
    report["ckpt2"] = ckpt2
    if not main:
        require(not os.listdir(run) and not os.listdir(resumed_run), "a rank other than 0 wrote files")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def spatial_phase(torch, card, chairs_root):
    """Spawn the 2 ranks of the [spatial] phase and check their reports."""
    import torch.multiprocessing as mp

    from pwcnet_tpu_torch import evaluate as evaluate_cli

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pwc_spatial_") as out_dir:
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=spatial_rank, args=(r, port, out_dir, chairs_root)) for r in range(SHARDS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 600
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        require(not alive, "a rank of the [spatial] phase timed out")
        require(all(p.exitcode == 0 for p in procs), f"[spatial] ranks exited {[p.exitcode for p in procs]}")
        reports = []
        for r in range(SHARDS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        ckpt2 = reports[0]["ckpt2"]
        epe = evaluate_cli.main(["-d", "FlyingChairs", "-dd", chairs_root, "--split", "val", "-b", "8", "-r", ckpt2,
                                 "--dtype", "bfloat16"])
    r0 = reports[0]
    sharded_epe = r0["epe"]
    log(f"  evaluate: EPE {sharded_epe:.4f} px over 2 shards, {epe:.4f} px unsharded")
    require(math.isfinite(sharded_epe) and abs(sharded_epe - epe) <= 5e-2 * epe + 1e-4,
            "evaluate --spatial 2 disagrees with the unsharded EPE")
    for name in r0["launches"]:
        log(f"  launches of {name} per rank: " + "; ".join(
            str({k: v for k, v in rep["launches"][name].items() if v}) for rep in reports))
    for rep in reports:
        got = rep["launches"]
        require(all(got[ph]["K9"] > 0 and got[ph]["K3"] > 0 for ph in ("serve", "train", "trainer")),
                f"rank {rep['rank']}: K9 / K3 not launched on the sharded paths")
        require(got["serve_1024"]["K8"] > 0, f"rank {rep['rank']}: K8 not launched at the 1024-row frame")
        require(all(got[ph]["K8b"] > 0 and got[ph]["K9b"] > 0 for ph in ("train", "trainer", "trainer_resumed")),
                f"rank {rep['rank']}: K8b / K9b not launched in the sharded steps")
        require(all(got[ph]["K7"] == 0 for ph in got), "K7 ran under H-sharding")
        for ph, per, n in [(f"serve_{opt}", SPATIAL_UNFUSED_PER_FORWARD, 2) for opt in SPATIAL_OPTIONS] + [
                ("sequence", SPATIAL_SEQ_PER_DISPATCH, 2), ("sequence_f32", SPATIAL_SEQ_PER_DISPATCH, 2)]:
            want = {k: n * per.get(k, 0) for k in got[ph]}
            require(got[ph] == want, f"rank {rep['rank']} {ph}: launches {got[ph]}, want {want}")
    counts = {k: sum(rep["launches"][ph][k] for rep in reports for ph in rep["launches"]) for k in KERNEL_INFO}
    log(f"  2 ranks sharing one card, halos and gathers staged through the host: these pairs/s measure "
        f"correctness, not scaling: serving 448x1024 B=8 bf16 {r0['serve_pairs_per_s']:.1f}, train step 384x448 "
        f"B=8 bf16 {r0['train_pairs_per_s']:.1f}, trainer epoch 1 "
        f"{r0['trainer_epochs'][0]['steps'] * 8 / r0['trainer_epochs'][0]['train_seconds']:.1f} pairs/s on {card}")
    log(f"  predict_sequence 448x1024 bf16 B=8 depth 2 (reported, not gated; host clock, {SEQ_TIMED_FRAMES - 1} "
        f"pairs): sharded over 2 ranks sharing the card {r0['sequence_pairs_per_s']:.1f} pairs/s, unsharded "
        f"{r0['sequence_unsharded_pairs_per_s']:.1f} pairs/s on {card}")
    log(f"  NCCL across GPUs: not run here (torch.cuda.device_count() = {torch.cuda.device_count()}); "
        "tests/test_torch_kernels.py's multigpu test runs it on a machine with two or more cards")
    stats = {k: r0[k] for k in ("serve_pairs_per_s", "train_pairs_per_s", "train_losses", "gradient", "epe",
                                "serve_err_float32", "serve_err_bfloat16", "serve_err_1024_float32",
                                "serve_err_1024_bfloat16", "seconds", "sequence_pairs_per_s",
                                "sequence_unsharded_pairs_per_s")}
    stats.update({k: v for k, v in r0.items() if k.startswith(tuple(f"serve_err_{o}_" for o in SPATIAL_OPTIONS))})
    stats["unsharded_epe"] = epe
    return counts, stats


# device kernels by name: the port's own, the library's convolutions, PyTorch's elementwise tail
PROFILE_GROUPS = (
    ("K1 warped_cost_volume", ("WarpLoader",)),
    ("K2 cost_volume", ("PlainLoader",)),
    ("K3 pyramid_level", ("pyramid_level",)),
    ("K4 cost_volume_bwd", ("cv_bwd_kernel",)),
    ("K5 warp_bwd", ("warp_bwd_coop_kernel",)),
    ("K6 pyramid_level_bwd", ("conv_t_col", "conv1_t_col", "conv_t_s2", "conv_t_wg", "conv1_t_wg")),
    ("K7 estimator chain, forward and backward", ("conv3x3_",)),
    ("K3, K6 and K7 weight packing (bf16)", ("pack_weights",)),
    ("cuDNN wgrad", ("wgrad",)),
    ("cuDNN dgrad", ("dgrad",)),
    ("cuDNN forward convs and layout kernels", ("xmma", "cutlass", "cudnn", "implicit_gemm", "nhwc", "nchw")),
    ("reductions (bias gradients, sums)", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("host <-> device copies", ("Memcpy",)),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("foreach (Adam, decay)", ("multi_tensor",)),
    ("elementwise (bias add, LeakyReLU, resize, loss)", ("elementwise",)),
)


def profile_steps(torch, fn, n, what, unprofiled_ms):
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler).
    ``unprofiled_ms``: the time of one call measured without the profiler,
    against which the device's busy share is taken (tracing slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU ops that launched them report the
    # same time again as their own device time
    kern = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    total = sum(t for _, t, _ in kern) / 1e3
    count = sum(c for *_, c in kern)
    require(total > 0, f"the profile of {what} shows no device time")
    log(f"  profile of {n} {what}: kernel time {total / n:.2f} ms and {count // n} kernels per call; "
        f"one call takes {unprofiled_ms:.2f} ms unprofiled, so the device is busy "
        f"{100.0 * total / n / unprofiled_ms:.1f}% of the time ({wall / n:.2f} ms per call under the profiler)")
    groups = {}
    for key, t, c in kern:
        name = next((g for g, pats in PROFILE_GROUPS if any(p in key for p in pats)), "other")
        gt, gc = groups.get(name, (0.0, 0))
        groups[name] = (gt + t / 1e3 / n, gc + c / n)
    for name, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {t:8.3f} ms {c:7.1f}x per call  {name}")
    log("  the 12 longest kernels:")
    for key, t, c in kern[:12]:
        log(f"    {t / 1e3 / n:8.3f} ms {c / n:7.1f}x per call  {key[:100]}")
    return {"kernel_ms": total / n, "kernels": count // n, "busy_share": total / n / unprofiled_ms}


def kernel_label(mangled: str) -> str:
    """A readable label for a mangled kernel name: the last name of its
    nested name, then its integer template arguments, its element type and
    its Loader (``correlation_kernel<bf16,4,32,HpadLoader>``); boolean
    arguments read true or false (``conv_t_col_kernel<32,true>``)."""
    import re

    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[pos:])) is not None:
        n = int(m.group())
        name = mangled[pos + len(m.group()):pos + len(m.group()) + n]
        pos += len(m.group()) + n
    rest = mangled[pos:]
    args = (["bf16"] if rest.startswith("I13__nv_bfloat16") else ["f32"] if rest.startswith("If") else [])
    args += [v if t == "i" else ("true" if v == "1" else "false") for t, v in re.findall(r"L([ib])(\d+)E", rest)]
    args += re.findall(r"\d+([A-Z][A-Za-z]*Loader)", rest)
    return f"{name}<{','.join(args)}>" if args else name


def log_build(report):
    """Registers and spills of every kernel (ptxas), by kernel and template
    arguments; the dynamic shared memory of the wgmma kernels (K3, K6, K7)
    and of the correlation kernel (K1, K2, K8, K9), and the tile width,
    threads and cluster size the correlation plan gives each main-path
    shape."""
    import ctypes
    import re

    from pwcnet_tpu_torch.ops.cuda import _build, _common

    spills = {}
    for name, r in report.items():
        entry = "?"
        for line in r["ptxas"].splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
            if m:
                entry = kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")
                spills.setdefault(entry, set()).update(re.findall(r"(\d+) bytes spill", line))
    for entry, counts in spills.items():
        if entry.startswith(("conv_t_col_kernel", "conv1_t_col_kernel")):
            require(counts <= {"0"}, f"ptxas spills registers in K6's float32 {entry}")
        if entry.startswith("conv3x3_wgmma_kernel"):
            require(counts <= {"0"}, f"ptxas spills registers in K7's bf16 {entry}")
        if entry.startswith("cv_bwd_kernel"):
            require(counts <= {"0"}, f"ptxas spills registers in K4's {entry}")
        if entry.startswith("warp_bwd_coop_kernel"):
            require(counts <= {"0"}, f"ptxas spills registers in K5's {entry}")
        if entry.startswith(("raft_epilogue", "raft_gate")):
            require(counts <= {"0"}, f"ptxas spills registers in R2's / R3's {entry}")
        if entry.startswith("global_attention_kernel"):
            require(counts <= {"0"}, f"ptxas spills registers in R4's {entry}")
        if entry.startswith("attention_softmax_kernel"):
            require(counts <= {"0"}, f"ptxas spills registers in R5's {entry}")
        if entry.startswith("raft_aggregate_kernel"):
            require(counts <= {"0"}, f"ptxas spills registers in R6's {entry}")
    if report.get("cost_volume_bwd", {}).get("ptxas"):  # built in this run, not cached
        require(any(e.startswith("cv_bwd_kernel") for e in spills), "no ptxas report of K4's cv_bwd_kernel")
    if report.get("warp_bwd", {}).get("ptxas"):
        require(any(e.startswith("warp_bwd_coop_kernel") for e in spills), "no ptxas report of K5's kernel")
    if report.get("estimator_conv_bwd", {}).get("ptxas"):
        require(any(e.startswith("conv3x3_wgmma_kernel") for e in spills), "no ptxas report of K7b's bf16 kernel")
    if report.get("global_attention", {}).get("ptxas"):
        require(any(e.startswith("attention_softmax_kernel") for e in spills), "no ptxas report of R5's kernel")
    if report.get("raft_update", {}).get("ptxas"):
        require(any(e.startswith("raft_aggregate_kernel") for e in spills), "no ptxas report of R6's kernel")
    k3 = _build.load("pyramid_conv").pwc_pyramid_level_smem_bytes
    k3.argtypes = [ctypes.c_int] * 2
    k6 = _build.load("pyramid_conv_bwd").pwc_pyramid_level_bwd_smem_bytes
    corr = _build.load("cost_volume").pwc_correlation_smem_bytes
    k6.argtypes = corr.argtypes = [ctypes.c_int] * 2
    log("  dynamic shared memory per block: " + ", ".join(
        [f"pyramid_level_wg_kernel<{cin},{c}> {k3(cin, c)} B" for cin, c in ((3, 16), (16, 32))]
        + [f"conv_t_wg_kernel<{c}> {k6(c, 0)} B" for c in (16, 32)] + [f"conv1_t_wg_kernel<32> {k6(32, 1)} B"]
        + [f"correlation_kernel<{SEARCH_RANGE},{tw}> {corr(SEARCH_RANGE, tw)} B" for tw in (16, 32)]))
    f7 = _build.load("estimator_conv")
    f7b = _build.load("estimator_conv_bwd")
    f3 = _build.load("pyramid_conv").pwc_pyramid_level_f32_info
    ip = ctypes.POINTER(ctypes.c_int)
    f7.pwc_estimator_conv_info.argtypes = f7b.pwc_estimator_conv_bwd_info.argtypes = [ctypes.c_int] + [ip] * 3
    f7b.pwc_wgmma_tiles.argtypes = [ctypes.c_int] + [ip] * 2
    f7.pwc_conv3x3_f32_tile.argtypes = [ctypes.c_int] * 4 + [ip] * 2
    f7.pwc_conv3x3_f32_info.argtypes = [ctypes.c_int] * 2 + [ip] * 3
    f3.argtypes = [ctypes.c_int] * 2 + [ip] * 3

    def ints(fn, what, *args, n=3):
        vals = [ctypes.c_int(0) for _ in range(n)]
        require(fn(*args, *[ctypes.byref(v) for v in vals]) == 0, f"query of {what}")
        return [v.value for v in vals]

    wg_info = []
    for fn, bwd in ((f7.pwc_estimator_conv_info, "false"), (f7b.pwc_estimator_conv_bwd_info, "true")):
        for n in _common.WGMMA_WIDTHS:
            label = f"conv3x3_wgmma_kernel<{n},{bwd}>"
            smem, regs, blocks = ints(fn, label, n)
            require(blocks > 0, f"{label} does not fit an SM")
            wg_info.append(f"{label} {smem} B, {regs} registers, {blocks} blocks an SM")
    log("  K7 / K7b bf16 (dynamic shared memory, registers, resident blocks an SM; 288 threads): "
        + "; ".join(wg_info))
    dx_plans = []
    for cin in sorted({c for *_, c in K7_TRAIN + K7_SERVE + K7_EDGE} | {-(-c // 8) * 8 for *_, c in K7_TRAIN}):
        tiles, n = ints(f7b.pwc_wgmma_tiles, "the N tiles", cin, n=2)
        require((tiles, n) == _common.wgmma_tiles(cin), f"K7b's dxin plan for {cin} channels differs from Python's")
        dx_plans.append(f"{cin}: {tiles} x N={n}")
    log("  K7b's dxin N tiles (channels: tiles x width): " + "; ".join(dx_plans))
    tiles, used, f32_info = [], set(), []
    for label, b, shapes in (("train", 8, K7_TRAIN[-FUSED_ESTIMATOR:]), ("serve", 8, K7_SERVE[-FUSED_ESTIMATOR:])):
        for h, w, cin in shapes:
            # the forward's six convs, then K7b's dxin (Cout = the chain's input width)
            tw = [tuple(ints(f7.pwc_conv3x3_f32_tile, "the K7 tile", c, b, h, w, n=2)) for c in EST_COUTS + (cin,)]
            tiles.append(f"{label} {b}x{h}x{w}: " + " ".join(f"{n}x{t}" for n, t in tw))
            used.update(tw)
    for n, t in sorted(used):
        smem, threads, blocks = ints(f7.pwc_conv3x3_f32_info, f"conv3x3_fma_kernel<{n},{t}>", n, t)
        require(blocks > 0, f"conv3x3_fma_kernel<{n},{t}> does not fit an SM")
        f32_info.append(f"conv3x3_fma_kernel<{n},{t}> {smem} B, {threads} threads, {blocks} blocks an SM")
    for cin, c in ((3, 16), (16, 32)):
        smem, threads, blocks = ints(f3, f"pyramid_level_kernel<{cin},{c}>", cin, c)
        require(blocks > 0, f"pyramid_level_kernel<{cin},{c}> does not fit an SM")
        f32_info.append(f"pyramid_level_kernel<{cin},{c}> {smem} B, {threads} threads, {blocks} blocks an SM")
    f6 = _build.load("pyramid_conv_bwd").pwc_pyramid_level_bwd_f32_info
    f6.argtypes = [ctypes.c_int] * 2 + [ip] * 3
    for c, which, label in ((16, 0, "conv_t_col_kernel<16,true>"), (16, 1, "conv_t_col_kernel<16,false>"),
                            (32, 0, "conv_t_col_kernel<32,true>"), (32, 1, "conv_t_col_kernel<32,false>"),
                            (32, 2, "conv1_t_col_kernel")):
        smem, threads, blocks = ints(f6, label, c, which)
        require(blocks > 0, f"{label} does not fit an SM")
        f32_info.append(f"{label} {smem} B, {threads} threads, {blocks} blocks an SM")
    log("  float32 kernels (dynamic shared memory, threads, resident blocks an SM): "
        + "; ".join(f32_info))
    f4 = _build.load("cost_volume_bwd").pwc_cost_volume_bwd_info
    f4.argtypes = [ctypes.c_int] * 3 + [ip] * 3
    k4_info = []
    for dcode, dname in ((0, "f32"), (1, "bf16")):
        for th in _common.CV_BWD_TILE_ROWS:
            label = f"cv_bwd_kernel<{dname},{SEARCH_RANGE},{th}>"
            smem, threads, blocks = ints(f4, label, SEARCH_RANGE, dcode, th)
            require(blocks > 0, f"{label} does not fit an SM")
            k4_info.append(f"{label} {smem} B, {threads} threads, {blocks} blocks an SM")
    log("  K4 / K8b (dynamic shared memory, threads, resident blocks an SM): " + "; ".join(k4_info))
    f5 = _build.load("warp_bwd").pwc_warp_bwd_info
    f5.argtypes = [ctypes.c_int] * 2 + [ip] * 3
    resident, k5_info = {}, []
    for dcode, dname in ((0, "f32"), (1, "bf16")):
        for rows, kid in ((0, "K5"), (1, "K9b")):
            label = f"warp_bwd_coop_kernel<{dname},{'f32' if rows or not dcode else 'bf16'}> ({kid})"
            threads, per_sm, sms = ints(f5, label, dcode, rows)
            require(per_sm > 0, f"{label} does not fit an SM")
            resident[dcode, rows] = per_sm * sms
            k5_info.append(f"{label} {threads} threads, {per_sm} blocks an SM x {sms} SMs")
    log("  K5 / K9b (no shared memory; resident blocks, the cooperative grid's cap): " + "; ".join(k5_info))
    words = _build.load("warp_bwd").pwc_warp_bwd_scratch_words
    words.argtypes, words.restype = [ctypes.c_longlong, ctypes.c_longlong], ctypes.c_longlong
    for n, b in ((1, 1), (33, 3), (8 * 96 * 112 * 32, 8), (8 * 384 * 448 * 32, 8), (5000 * 12 * 14, 5000)):
        require(words(n, b) == _common.warp_bwd_scratch(n, b), f"K5's scratch for {n} elements in {b} images: "
                "the source and _common.warp_bwd_scratch differ")
    k5_plans = []
    for kid, shapes, rows in (("K5", K1_TRAIN, 0), ("K9b", K9_TRAIN, 1)):
        for h, w, c in shapes:
            ho, hf = (h // SHARDS + 2 * SEARCH_RANGE, h) if rows else (h, h)
            for dcode, dname in ((0, "f32"), (1, "bf16")):
                lanes = _common.warp_bwd_lanes(c)
                blocks = _common.warp_bwd_blocks(8 * ho * w, lanes, 8 * hf * w * c, resident[dcode, rows])
                k5_plans.append(f"{kid} {dname} 8x{ho}x{w}x{c}: {lanes} lanes a pixel, {blocks} blocks, scratch "
                                f"{_common.warp_bwd_scratch(8 * hf * w * c, 8) * 8 / 2**20:.1f} MiB")
    log("  K5 / K9b launch plans (one cooperative kernel a call): " + "; ".join(k5_plans))
    k4_plans = []
    for kid, shapes, pad in (("K4", K2_TRAIN + K1_TRAIN, 0), ("K8b", K9_TRAIN, SEARCH_RANGE)):
        for h, w, c in shapes:
            h = h // SHARDS if pad else h
            th = _common.cv_bwd_plan(8, h, w, c, pad)
            k4_plans.append(f"{kid} 8x{h}x{w}x{c}: tile {th}x{_common.CV_BWD_TILE_W}, "
                            f"{_common.cv_bwd_blocks(8, h, w, c, pad, th)} blocks")
    log("  K4 / K8b launch plans (one launch, both halves): " + "; ".join(k4_plans))
    log("  float32 K7 tiles (N x columns) of the six convs and of K7b's dxin: " + "; ".join(tiles))
    plans = []
    for kid, shapes, b in (("K2", K2_SHAPES, 8), ("K1", K1_SHAPES, 8), ("K2", K2_TRAIN, 8), ("K1", K1_TRAIN, 8),
                           ("K8", K8_FRAME, 1), ("K9", K9_SERVE, 8)):
        for h, w, c in shapes:
            h = h // SHARDS if kid in SHARD_KERNELS else h
            tw, split = _common.correlation_plan(w, c)
            blocks = b * -(-h // _common.CORR_TILE_H) * -(-w // tw) * split
            plans.append(f"{kid} {b}x{h}x{w}x{c}: tile 8x{tw}, {tw * (2 * SEARCH_RANGE + 1)} threads, "
                         f"cluster {split}, {blocks} blocks")
    log("  correlation launch plans: " + "; ".join(plans))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a CUDA GPU",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    try:
        from pwcnet_tpu_torch.ops.cuda import _build
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[device] TF32 off for cuDNN convolutions and matmuls (float32 comparisons are true float32)")
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    report = _build.build()
    log(f"[build] {', '.join(report)} in {time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    log_build(report)

    t0 = time.perf_counter()
    log("[kernels] kernel vs plain at the serving shapes (448x1024) and the training shapes (384x448)")
    errs = {k: {} for k in KERNEL_INFO}
    compare = make_compare(torch, errs)
    check_kernels(torch, device, compare)
    atomics_rerun = check_training_kernels(torch, device, compare)
    check_estimator_kernels(torch, device, compare)
    log(f"  K8, K8b, K9, K9b on the {SHARDS} stripes of one frame on the card, and stitched against K1/K2, K4/K5")
    check_shard_kernels(torch, F, device, compare)
    check_one_kernel_a_call(torch, F, device)
    check_non_finite(torch, F, device)
    check_image_scales(torch, F, device)
    deterministic = check_determinism(torch, F, device)
    r1_err = check_raft_lookup(torch, device)
    r23_errs = check_raft_update(torch, device)
    raft_launches = check_raft_forward_launches(torch, device)
    r4_err = check_global_attention(torch, device)
    r5_err = check_attention_softmax(torch, device)
    check_aggregate_epilogue(torch, device)
    gma_launches = check_gma_forward_launches(torch, device)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[serve] FlowPredictor, seeded random weights")
    serve_counts, pairs, preds, batch_dev, batched = serve(torch, np, device)
    log(f"[serve] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[legacy] the legacy PWCNet (6 levels, 'final', no BN) through make_forward at 448x1024 B=8: K2 at every "
        "level, K4 in its backward, against the plain cost volume")
    legacy_counts, legacy_stats = legacy_phase(torch, device, batch_dev)
    log(f"[legacy] done in {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="pwc_smoke_") as tmp_root:
        t0 = time.perf_counter()
        log(f"[sequence] FlowPredictor.predict_sequence on {SEQ_FRAMES} frames of 448x1024 (bf16, kernels), "
            "and the test_continuous CLI")
        seq_counts, seq_stats = sequence_phase(torch, np, card, device, batch_dev, tmp_root)
        log(f"[sequence] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        log("[ckpt] a TF checkpoint of the seeded weights through FlowPredictor(checkpoint=<prefix>.ckpt)")
        ckpt_phase(torch, np, device, preds, tmp_root)
        log(f"[ckpt] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[bf16px] scripts/torch_bf16_parity.py: bf16 against float32 flow in px at 448x1024 B=4, "
        "variance-scaled random weights (seed 0)")
    bf16px = bf16px_phase(device)
    log(f"[bf16px] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train] the train step at 384x448, seeded random weights, float32 parameters")
    train_counts, train_stats, grad_err = train(torch, np, device)
    log(f"[train] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[remat] the train step with --remat at 384x448 (the pyramid, estimators and context net recomputed in "
        "the backward), float32 parameters")
    remat_counts, remat_stats = remat_phase(torch, np, device)
    log(f"[remat] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[determinism] two train steps at 384x448 B=8 with the kernels from one state and batch, float32 and bf16")
    determinism_stats = determinism_phase(torch, np, device)
    log(f"[determinism] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[converge] the SyntheticFlow convergence proof with the kernels (3 levels, 32x32, B=8) from the JAX "
        f"proof's PRNGKey({CONVERGE_KEY}): multiscale and remat 400 steps, robust 150 and bf16 120 after a "
        "300-step warm start")
    converge_counts, converge_stats = converge_phase(torch, card, device)
    log(f"[converge] done in {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="pwc_smoke_") as tmp_root:
        t0 = time.perf_counter()
        log("[trainer] pwcnet_tpu_torch.train and .evaluate on a written FlyingChairs-layout dataset")
        trainer_counts, trainer_stats = trainer_phase(torch, np, card, tmp_root)
        log(f"[trainer] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        log(f"[spatial] {SHARDS} ranks on the one card (gloo, host-staged): H-sharded serving, train step, "
            "train.main and evaluate --spatial 2")
        spatial_counts, spatial_stats = spatial_phase(torch, card, os.path.join(tmp_root, "chairs"))
        log(f"[spatial] done in {time.perf_counter() - t0:.1f} s")

    log("[time] kernels at B=8 bf16 (per forward: K1 4 levels, K2 1, K3 2 levels x 2 frames; "
        "per train step: K4 5 shapes, K5 4, K6 2 levels x 2 frames, K7 and K7b levels 3 and 4; "
        "per rank of 2 shards: K9 4 levels per forward at 448x1024, K8 level 0 of a 1024x1024 pair (B=1), "
        "K8b and K9b 4 levels per train step at 384x448)")
    rows, dname = time_kernels(torch, F, device)
    rows.update(time_training_kernels(torch, device))
    rows.update(time_estimator_kernels(torch, F, device))
    rows.update(time_shard_kernels(torch, F, device))
    # float32 (TF32 off): the kernels' float32 bodies beside cuDNN's float32 chains
    log("[time] float32 at the same shapes (TF32 off for cuDNN)")
    rows32, _ = time_kernels(torch, F, device, dtype=torch.float32)
    rows32.update(time_training_kernels(torch, device, dtype=torch.float32))
    rows32.update(time_estimator_kernels(torch, F, device, dtype=torch.float32))
    rows32.update(time_shard_kernels(torch, F, device, dtype=torch.float32))
    log("[time] R1, RAFT's correlation lookup, at the RAFT cell's shape (float32, as RAFT runs it)")
    r1_time = time_raft_lookup(torch, device)
    log("[time] R2 and R3, RAFT's update epilogues and gates, at the RAFT cell's shape (bf16)")
    r23_time = time_raft_update(torch, device)
    log("[time] R4, GMFlow's global matching and propagation, at the GMFlow cell's shape")
    r4_time = time_global_attention(torch, device)
    log("[time] R5 and R6, GMA's softmax over a block of scores and its aggregation epilogue, at the GMA cell's shape")
    r5_time = time_attention_softmax(torch, device)
    r6_time = time_aggregate_epilogue(torch, device)
    for kid in ("K1", "K2", "K6", "K8", "K9"):
        log(f"  {kid} bf16 per " + ("train step" if kid == "K6" else "forward") + ": "
            f"{sum(r['ms'] * r['times'] for r in rows[kid]):.4f} ms over "
            + ", ".join(f"{r['shape']} {r['ms']:.4f}" for r in rows[kid]))
    serve_profiles = {
        name: profile_steps(torch, lambda: pred.raw_forward(batch_dev), 3, f"forwards at 448x1024 B=8 {name}",
                            8e3 / pairs[f"{name} kernels"])
        for name, pred in preds.items()}

    kernels = []
    for kid, (name, source, replaces) in KERNEL_INFO.items():
        rs = rows[kid]
        on_serve = serve_counts.get(kid, 0)
        on_step = train_counts.get(kid, 0)
        on_trainer = trainer_counts[kid]
        on_spatial = spatial_counts[kid]
        on_sequence = seq_counts.get(kid, 0)
        on_remat = remat_counts.get(kid, 0)
        on_converge = converge_counts.get(kid, 0)
        on_legacy = legacy_counts.get(kid, 0)
        if kid in SHARD_KERNELS:
            require(on_spatial > 0, f"{kid} was not launched on the sharded paths")
        else:
            require(on_trainer > 0 and (on_step > 0 or kid not in PER_STEP) and (on_remat > 0 or kid not in REMAT_PER_STEP)
                    and (on_converge > 0 or kid not in CONVERGE_PER_STEP)
                    and (on_serve > 0 and on_sequence > 0 or kid not in PER_FORWARD)
                    and (on_legacy > 0 or kid not in {**LEGACY_PER_FORWARD, **LEGACY_PER_BACKWARD}),
                    f"{kid} was not launched on a path that runs it")
        if kid in SHARD_KERNELS:
            timed_at = ("one rank of 2 shards, bf16, summed over "
                        + {"K8": "a 1024x1024 pair's forward (B=1)", "K9": "one forward at 448x1024 B=8"}.get(
                            kid, "one train step at 384x448 B=8"))
        else:
            timed_at = f"B=8 {dname}, summed over one " + (
                "forward's launches at 448x1024" if kid in PER_FORWARD
                else "train step's launches at 384x448"
                + (f" with --fused-estimator {FUSED_ESTIMATOR}" if kid.startswith("K7") else ""))
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": on_serve + on_sequence + on_step + on_remat + on_converge + on_trainer + on_spatial + on_legacy,
            "launches_serving": on_serve,
            "launches_sequence": on_sequence,
            "launches_training": on_step,
            "launches_remat": on_remat,
            "launches_converge": on_converge,
            "launches_legacy": on_legacy,
            "launches_trainer": on_trainer,
            "launches_spatial": on_spatial,
            "max_abs_err": max(errs[kid].values()),
            "max_abs_err_by_dtype": errs[kid],
            **summed(rs),
            "timed_at": timed_at,
            **summed(rows32[kid], "_float32"),
        })
    kernels.append({"name": "R1 corr_lookup", "route": "cuda", "source": "pwcnet_tpu_torch/csrc/corr_lookup.cu",
                    "replaces": None, "launches_per_raft_forward": raft_launches["R1"], "max_abs_err": r1_err,
                    "timed_at": "one update's lookup at 448x1024 B=16, float32", **r1_time})
    for kid, name in (("R2", "R2 raft_epilogue"), ("R3", "R3 raft_gate")):
        kernels.append({"name": name, "route": "cuda", "source": "pwcnet_tpu_torch/csrc/raft_update.cu",
                        "replaces": None, "launches_per_raft_forward": raft_launches[kid],
                        "max_abs_err_by_dtype": r23_errs[kid], "timed_at": "one update at 448x1024 B=16, bf16",
                        "calls": {k: v for k, v in r23_time["calls"].items() if k.startswith(kid)}})
    kernels.append({"name": "R4 global_attention", "route": "cuda", "source": "pwcnet_tpu_torch/csrc/global_attention.cu",
                    "replaces": None, "max_abs_err_of_max_ref": r4_err,
                    "timed_at": "one product at 448x1024 B=16 (7168 keys), bf16 q and k, float32 value", **r4_time})
    kernels.append({"name": "R5 attention_softmax", "route": "cuda",
                    "source": "pwcnet_tpu_torch/csrc/global_attention.cu", "replaces": None,
                    "launches_per_gma_forward_448x1024": gma_launches["R5"], "max_err_less_bf16_rounding": r5_err,
                    "timed_at": "one block of rows at 1088x1920 B=4 (32640 keys), float32 scores", **r5_time})
    kernels.append({"name": "R6 aggregate_epilogue", "route": "cuda",
                    "source": "pwcnet_tpu_torch/csrc/raft_update.cu", "replaces": None,
                    "launches_per_gma_forward_448x1024": gma_launches["R6"], "max_abs_err": 0.0,
                    "timed_at": "one update at 1088x1920 B=4, bf16", **r6_time})
    log(f"[e2e] 448x1024 B=8 serving pairs/s: " + ", ".join(f"{k} {v:.1f}" for k, v in pairs.items())
        + f" on {card}")
    log(f"[e2e] sequence serving 448x1024 bf16 kernels (reported, not claimed): predict_sequence B=8 "
        f"{seq_stats['depth 2']:.1f} pairs/s at depth 2, {seq_stats['depth 1']:.1f} at depth 1 (host clock, "
        f"{SEQ_TIMED_FRAMES - 1} pairs, median of 3), raw_forward B=8 {seq_stats['raw_forward']:.1f} (CUDA events); "
        f"device busy {100 * seq_stats['profile depth 2']['busy_share']:.1f}% at depth 2 on {card}")
    log(f"[e2e] legacy PWCNet serving 448x1024 B=8 (reported, not claimed): " + ", ".join(
        f"{k} {v:.1f}" for k, v in legacy_stats["pairs_per_s"].items()) + f" pairs/s on {card}")
    log(f"[e2e] bf16 serving accuracy (reported, not claimed): EPE(bf16 vs f32) at 448x1024 B=4 "
        + ", ".join(f"{k} path {v['epe_bf16_vs_f32']:.4f} px" for k, v in bf16px.items())
        + f" (budget {BF16_PX_BUDGET}) on {card}")
    log(f"[e2e] 384x448 B=8 training pairs/s: "
        + ", ".join(f"{k} {v['pairs_per_s']:.1f}" for k, v in train_stats.items()) + f" on {card}")
    bare = train_stats["bfloat16 kernels + K7"]["pairs_per_s"]
    tp = trainer_stats["pairs_per_s"]
    f32_serve, f32_step = serve_profiles["float32"], train_stats["float32 kernels"]
    log(f"[e2e] float32 (reported, not claimed): serving 448x1024 B=8 {pairs['float32 kernels']:.1f} pairs/s "
        f"with the kernels, {pairs['float32 plain']:.1f} plain, device busy {100 * f32_serve['busy_share']:.1f}% "
        f"({f32_serve['kernel_ms']:.2f} ms of kernel time a forward); train step 384x448 B=8 "
        f"{f32_step['pairs_per_s']:.1f} pairs/s with the kernels, {train_stats['float32 plain']['pairs_per_s']:.1f} "
        f"plain, device busy {100 * f32_step['profile']['busy_share']:.1f}% "
        f"({f32_step['profile']['kernel_ms']:.2f} ms of kernel time a step) on {card}")
    log(f"[e2e] trainer, 384x448 B=8 bf16, --fused-estimator {FUSED_ESTIMATOR}: "
        f"{tp['trainer epoch 2 (K7 on 2 levels)']:.1f} pairs/s over the steps of epoch 2 (wall clock), the bare step "
        f"{bare:.1f}, the loader alone {tp['loader alone']:.1f}; one epoch resumed from model_1: "
        f"{tp['resumed epoch 2 (K7 on 2 levels)']:.1f} with K7, {tp['resumed epoch 2 (cuDNN estimators)']:.1f} "
        f"with --fused-estimator 0 (cuDNN) on {card}")
    ab = batched["pairs_per_s"]
    log(f"[e2e] batched_pyramid A/B at 448x1024 B=8 with the kernels (reported, not claimed; in turns, default / "
        f"batched / batched / default): " + "; ".join(
            f"{d} " + " / ".join(f"{v:.1f}" for v in (ab[f'{d} kernels default'][0], *ab[f'{d} kernels batched_pyramid'],
                                                     ab[f'{d} kernels default'][1])) for d in ("bfloat16", "float32"))
        + f" pairs/s on {card}")
    log(f"[e2e] --remat at 384x448 (reported, not claimed): " + "; ".join(
        f"{k} {sum(v['ms']) / len(v['ms']):.2f} ms, peak {v['peak_mib']:.0f} MiB" for k, v in remat_stats["timing"].items())
        + f"; the trainer's --remat epoch {trainer_stats['pairs_per_s']['remat epoch 1 (K7 on 2 levels)']:.1f} pairs/s "
        f"on {card}")
    log(f"[e2e] H-sharded over 2 ranks sharing the card (correctness, not scaling): serving 448x1024 B=8 bf16 "
        f"{spatial_stats['serve_pairs_per_s']:.1f} pairs/s, train step 384x448 B=8 bf16 "
        f"{spatial_stats['train_pairs_per_s']:.1f} pairs/s, predict_sequence B=8 depth 2 "
        f"{spatial_stats['sequence_pairs_per_s']:.1f} pairs/s on {card}")
    log(f"[e2e] convergence proof with the kernels from the JAX PRNGKey({CONVERGE_KEY}), full-set EPE (gate "
        f"0.5 px): " + ", ".join(f"{k} {float(converge_stats['kernels'][k]['epe'])!r} px" for k in
                                 ("multiscale", "remat", "robust", "bf16"))
        + f"; the plain witness {converge_stats['plain_multiscale']['epe']:.4f} px on {card}")
    log(f"[e2e] reproducibility of a train step at 384x448 B=8 (gated, no flag set by this script): " + "; ".join(
        f"{k} {v['identical']['param']}/{v['tensors']['param']} parameters, {v['identical']['mu']}/"
        f"{v['tensors']['mu']} first moments identical" for k, v in determinism_stats.items() if "warnings" not in k)
        + f"; [converge] multiscale rerun bitwise {converge_stats['rerun_bitwise']}; [trainer] two float32 "
        f"epochs' model_1.msgpack byte-identical {trainer_stats['float32_epochs']['identical']} on {card}")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"card": card, "train": train_stats, "gradient_kernels_vs_plain": grad_err,
                      "k5_df1_run_to_run": atomics_rerun, "bitwise_equal_reruns": deterministic, "trainer": trainer_stats, "spatial": spatial_stats,
                      "sequence": seq_stats, "bf16px": bf16px, "remat": remat_stats, "batched_pyramid": batched,
                      "converge": converge_stats, "legacy": legacy_stats, "determinism": determinism_stats}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
