#!/usr/bin/env python3
"""Smoke run of pwcnet_tpu_torch on one NVIDIA GPU (H100), from the repo root.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   convolutions and matmuls, so float32 comparisons are true float32;
2. build: compile every CUDA kernel from ``pwcnet_tpu_torch/csrc`` with
   nvcc (one process per source, all at once);
3. kernels: K1 (warped cost volume), K2 (cost volume) and K3 (fused
   pyramid level) at every shape the 448x1024 serving forward gives them,
   at batch 1 and 8, in float32 and bfloat16, against their plain PyTorch
   versions on the card; then, at every shape of the 384x448 training
   step, the residuals K1 and K3 write for the backward (the warped map;
   s1 and s2) and the backward kernels K4 (cost volume), K5 (bilinear
   warp) and K6 (pyramid level) against their plain versions; K7 (the
   estimator's six-conv chain) forward, with and without residuals, and
   backward (every cotangent, the weight and bias gradients taken from
   them, and dxin) at the five estimator levels of both sizes;
4. serving: FlowPredictor with seeded random weights answers 448x1024
   requests and a 1024x436 (Sintel-sized) request edge-padded to 448x1024,
   then batched raw_forward at B=8 in bf16 and f32; the launch counters
   must show K1 4x, K2 1x and K3 4x per forward; flows must match the same
   predictor on the plain path (use_kernels=False) and, on a small pair,
   the float32 CPU path;
5. training: the train step at 384x448 with seeded random weights and a
   seeded smooth batch, float32 parameters, bfloat16 and float32 compute:
   every parameter's gradient on the kernel path against the plain path
   (ordinary autograd), five steps at B=8 with a finite falling loss, the
   launch counters (K1 4x, K2 1x, K3 4x, K4 5x, K5 4x, K6 4x per step),
   pairs/s of the step on both paths and the peak memory;
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
   kernels on and off; then the loader alone and one more epoch with
   ``--fused-estimator 0`` are timed;
7. timing: each kernel, its plain version and (K3, K6, K7) the cuDNN conv
   chain timed with CUDA events at the main-path shapes (B=8, bf16);
   pairs/s of the whole forward at 448x1024 B=8 bf16; device time by
   kernel for the forward and for the train step (torch.profiler).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

# shapes at 448x1024 (per sample): level -> (H, W, C)
K1_SHAPES = ((14, 32, 128), (28, 64, 96), (56, 128, 64), (112, 256, 32))
K2_SHAPES = ((7, 16, 192),)
K3_SHAPES = ((448, 1024, 3, 16), (224, 512, 16, 32))  # (H, W, Cin, C)
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
FUSED_ESTIMATOR = 2  # the trainer run's --fused-estimator: levels 3 and 4
# per trainer step with --fused-estimator 2; a validation batch is one forward
TRAINER_PER_STEP = {**PER_STEP, "K7": FUSED_ESTIMATOR, "K7b": FUSED_ESTIMATOR}
TRAINER_PER_FORWARD = {**PER_FORWARD, "K7": FUSED_ESTIMATOR}
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
}


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


# ------------------------------------------------------------ phases
def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def make_compare(torch, errs):
    """compare(kid, label, got, want, dtype, ulps): fail unless the kernel's
    result is finite, of the plain version's shape and within tolerance.

    Tolerances: float32 (TF32 off) differs only in summation order (and,
    for K5, in the order of its float32 atomics): 1e-5 + 1e-5 * scale.
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
                for h, w, cin, c in K3_SHAPES:
                    args = k3_inputs(torch, b, h, w, cin, c, dtype, device, gen)
                    compare("K3", f"{dtype} B={b} {h}x{w}x{cin}->{c}",
                            pyramid_level_fused(*args), pyramid_level_plain(*args), dtype, ulps=4)
                torch.cuda.synchronize()


def check_training_kernels(torch, device, compare, batches=(1, 8), dtypes=None):
    """At every shape of the 384x448 training step: K1, K2 and K3 and the
    residuals K1 and K3 write (warped map; s1, s2) against the plain
    forward, and K4, K5, K6 against their plain versions on the same
    residuals and cotangents.

    bfloat16 tolerances: 2 ulps of the result's scale for K4, K5 and the
    residuals (one rounding of a float32 sum on each side); 4 for K6, whose
    stages read the rounded cotangent the previous stage stored.
    Returns, by dtype, the largest run-to-run difference of K5's df1
    (float32 atomics) relative to its scale.
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
                for level, (h, w, cin, c) in enumerate(K3_TRAIN):
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
                    # level 0 reads the image: the training path asks for no dx there
                    for need_dx in ((False, True) if level == 0 else (True,)):
                        got = pyramid_level_bwd(*res, need_dx=need_dx)
                        want = pyramid_level_bwd_plain(*res, need_dx=need_dx)
                        for name, a, e in zip(("gz1", "gz2", "gz3", "dx"), got, want):
                            if e is None:
                                require(a is None, f"K6 returned a dx nobody asked for at {label}")
                            else:
                                compare("K6", f"{name} {label} dx={need_dx}", a, e, dtype, ulps=4)
                torch.cuda.synchronize()
    log(f"  K5 df1 run to run (float32 atomics): max |diff| / max |df1| = {rerun}")
    return rerun


def time_kernels(torch, F, device, b=8, dtype=None):
    """Kernel, plain and library times at the main-path shapes, summed per forward."""
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
        for h, w, c in K2_SHAPES:
            a = k2_inputs(torch, b, h, w, c, dtype, device, gen)
            rows["K2"].append(dict(
                shape=f"{b}x{h}x{w}x{c}", times=1,
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
    finish_rows(rows, dname)
    return rows, dname


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
    """K4, K5, K6: kernel, plain and library times at the training-step shapes."""
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
                    library_ms=None, work=k5_work(b, h, w, c, s)))
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
    from the plain gz), all against the plain versions.

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
                for h, w, cin in K7_TRAIN + K7_SERVE:
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
                torch.cuda.synchronize()


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
    """K7 forward (with residuals, as the trainer runs it) and backward:
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
                lib_bwd = (ks, [nchw(a) for a in saved], nchw(g_flow), nchw(g_feat), cin)
                shape = f"{b}x{h}x{w}x{cin}"
                rows["K7"].append(dict(
                    shape=shape, times=times,
                    ms=cuda_ms(torch, lambda: estimator_chain_residuals(xin, *kbs), iters=10),
                    plain_ms=cuda_ms(torch, lambda: estimator_chain_plain(xin, *kbs), iters=5, warmup=1),
                    library_ms=cuda_ms(torch, lambda: cudnn_chain(F, x_nchw, kbs), iters=10),
                    work=k7_work(b, h, w, cin, s, False)))
                rows["K7b"].append(dict(
                    shape=shape, times=times,
                    ms=cuda_ms(torch, lambda: estimator_chain_bwd(ks, saved, g_flow, g_feat), iters=10),
                    plain_ms=cuda_ms(torch, lambda: estimator_chain_bwd_plain(ks, saved, g_flow, g_feat),
                                     iters=5, warmup=1),
                    library_ms=cuda_ms(torch, lambda: cudnn_chain_bwd(torch, *lib_bwd), iters=10),
                    work=k7_work(b, h, w, cin, s, True)))
    finish_rows(rows, dname)
    return rows


def finish_rows(rows, dname):
    for kid, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = bound(dname, *r.pop("work"))
            log(f"  {kid} {dname} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


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

    # -- throughput
    pairs = {}
    for (dt, k), p in preds.items():
        ms = cuda_ms(torch, lambda: p.raw_forward(batch_dev), iters=10, warmup=3)
        name = f"{str(dt).replace('torch.', '')} {'kernels' if k else 'plain'}"
        pairs[name] = 8e3 / ms
        log(f"  448x1024 B=8 {name}: {ms:.3f} ms per batch, {8e3 / ms:.1f} pairs/s")
    return counts, pairs, preds[(torch.bfloat16, True)], batch_dev


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


def train_model(torch, compute_dtype, use_kernels, seed=0, fused_estimator=0):
    """The default PWCDCNet as the JAX trainer builds it with --pallas: K2 at
    level 0, K1 at levels 1-4, K3 on the two finest pyramid levels, and K7 on
    the ``fused_estimator`` finest estimator levels."""
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

    hooks = {}
    if use_kernels:
        hooks = dict(cost_volume_fn=cost_volume_cuda, warp_cv_fn=warped_cost_volume, fused_pyramid_levels=2,
                     fused_estimator_levels=fused_estimator)
    return PWCDCNet(compute_dtype=compute_dtype, generator=torch.Generator().manual_seed(seed), **hooks)


def train(torch, np, device):
    """The training step at 384x448: gradients against the plain path, five
    steps, launch counts, pairs/s and peak memory."""
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from pwcnet_tpu_torch.train_lib.step import create_train_state, make_loss_fn, make_train_step

    dtypes = (torch.bfloat16, torch.float32)

    # -- (a) every parameter's gradient, kernel path vs plain path (B=4)
    # float32: the two paths differ in summation order (and K5's atomics)
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
            if use_kernels and dt == torch.bfloat16:
                stats[name]["profile"] = profile_steps(
                    torch, lambda: step(state, images, flows_gt), 2, "train steps at 384x448 B=8 bf16", ms)
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


def trainer_phase(torch, np, card):
    """pwcnet_tpu_torch.train.main and .evaluate.main on a written dataset."""
    from pwcnet_tpu_torch import evaluate as evaluate_cli, train as train_cli
    from pwcnet_tpu_torch.data import DataLoader, get_dataset
    from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    stats = {}
    with tempfile.TemporaryDirectory(prefix="pwc_smoke_") as tmp:
        root = os.path.join(tmp, "chairs")
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
        with working_directory(os.path.join(tmp, "run")), first_batches_recorded(first):
            trainer = train_cli.main(base + fused)
            logdir = os.path.abspath(trainer.logdir)
        torch.cuda.synchronize()
        counts = launch_counts()
        steps, vals = 2 * len(trainer.tloader), 2 * len(trainer.vloader)
        log(f"  trainer: {steps} steps and {vals} validation batches, launches {counts}")
        require(trainer.tloader.path == "native",
                "the trainer's loader did not take the native path")
        require(steps == 44 and vals == 4, f"{steps} steps and {vals} validation batches, want 44 and 4")
        want = {k: n * steps + TRAINER_PER_FORWARD.get(k, 0) * vals for k, n in TRAINER_PER_STEP.items()}
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
            with working_directory(os.path.join(tmp, name)), first_batches_recorded(seen):
                again = train_cli.main(base + extra + ["-r", ckpts[0]])
            require(again._resume_epoch == 1 and again.state.step == steps,
                    f"{name}: resumed at epoch {again._resume_epoch}, ended at step {again.state.step}")
            require(list(seen) == [1] and seen[1] == first[1],
                    f"{name}: the first batch after --resume differs from the first run's first batch of epoch 2")
            resumed[name] = again.epoch_stats[-1]
        log(f"  --resume model_1.msgpack: first batch of epoch 2 has the bytes of the first run's (sha1 {first[1][:12]})")
        stats["resumed_epochs"] = resumed

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
        "loader alone": stats["loader_pairs_per_s"],
    }
    for k, v in stats["pairs_per_s"].items():
        log(f"  {k}: {v:.1f} pairs/s on {card}")
    return counts, stats


# device kernels by name: the port's own, the library's convolutions, PyTorch's elementwise tail
PROFILE_GROUPS = (
    ("K1 warped_cost_volume", ("WarpLoader",)),
    ("K2 cost_volume", ("PlainLoader",)),
    ("K3 pyramid_level", ("pyramid_level",)),
    ("K4 cost_volume_bwd", ("cv_bwd_kernel",)),
    ("K5 warp_bwd", ("warp_bwd_kernel", "round_kernel")),
    ("K6 pyramid_level_bwd", ("gz3_kernel", "conv_t_s")),
    ("K7 estimator chain, forward and backward", ("conv3x3_",)),
    ("cuDNN wgrad", ("wgrad",)),
    ("cuDNN dgrad", ("dgrad",)),
    ("cuDNN forward convs and layout kernels", ("xmma", "cutlass", "cudnn", "implicit_gemm", "nhwc", "nchw")),
    ("reductions (bias gradients, sums)", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
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
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    log("[kernels] kernel vs plain at the serving shapes (448x1024) and the training shapes (384x448)")
    errs = {k: {} for k in KERNEL_INFO}
    compare = make_compare(torch, errs)
    check_kernels(torch, device, compare)
    atomics_rerun = check_training_kernels(torch, device, compare)
    check_estimator_kernels(torch, device, compare)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[serve] FlowPredictor, seeded random weights")
    serve_counts, pairs, pred, batch_dev = serve(torch, np, device)
    log(f"[serve] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train] the train step at 384x448, seeded random weights, float32 parameters")
    train_counts, train_stats, grad_err = train(torch, np, device)
    log(f"[train] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[trainer] pwcnet_tpu_torch.train and .evaluate on a written FlyingChairs-layout dataset")
    trainer_counts, trainer_stats = trainer_phase(torch, np, card)
    log(f"[trainer] done in {time.perf_counter() - t0:.1f} s")

    log("[time] kernels at B=8 bf16 (per forward: K1 4 levels, K2 1, K3 2 levels x 2 frames; "
        "per train step: K4 5 shapes, K5 4, K6 2 levels x 2 frames, K7 and K7b levels 3 and 4)")
    rows, dname = time_kernels(torch, F, device)
    rows.update(time_training_kernels(torch, device))
    rows.update(time_estimator_kernels(torch, F, device))
    time_estimator_kernels(torch, F, device, dtype=torch.float32)  # the FMA path: logged, not summed
    profile_steps(torch, lambda: pred.raw_forward(batch_dev), 3, "forwards at 448x1024 B=8 bf16",
                  8e3 / pairs["bfloat16 kernels"])

    kernels = []
    for kid, (name, source, replaces) in KERNEL_INFO.items():
        rs = rows[kid]
        lib = [r["library_ms"] for r in rs]
        on_serve = serve_counts.get(kid, 0)
        on_step = train_counts.get(kid, 0)
        on_trainer = trainer_counts[kid]
        require(on_trainer > 0 and (on_step > 0 or kid not in PER_STEP)
                and (on_serve > 0 or kid not in PER_FORWARD),
                f"{kid} was not launched on a path that runs it")
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": on_serve + on_step + on_trainer,
            "launches_serving": on_serve,
            "launches_training": on_step,
            "launches_trainer": on_trainer,
            "max_abs_err": max(errs[kid].values()),
            "max_abs_err_by_dtype": errs[kid],
            "ms": sum(r["ms"] * r["times"] for r in rs),
            "plain_ms": sum(r["plain_ms"] * r["times"] for r in rs),
            "bound_ms": sum(r["bound_ms"] * r["times"] for r in rs),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(v * r["times"] for v, r in zip(lib, rs)),
            "timed_at": f"B=8 {dname}, summed over one "
                        + ("forward's launches at 448x1024" if kid in PER_FORWARD
                           else "train step's launches at 384x448"
                           + (f" with --fused-estimator {FUSED_ESTIMATOR}" if kid.startswith("K7") else "")),
            "shapes": rs,
        })
    log(f"[e2e] 448x1024 B=8 serving pairs/s: " + ", ".join(f"{k} {v:.1f}" for k, v in pairs.items())
        + f" on {card}")
    log(f"[e2e] 384x448 B=8 training pairs/s: "
        + ", ".join(f"{k} {v['pairs_per_s']:.1f}" for k, v in train_stats.items()) + f" on {card}")
    bare = train_stats["bfloat16 kernels + K7"]["pairs_per_s"]
    tp = trainer_stats["pairs_per_s"]
    log(f"[e2e] trainer, 384x448 B=8 bf16, --fused-estimator {FUSED_ESTIMATOR}: "
        f"{tp['trainer epoch 2 (K7 on 2 levels)']:.1f} pairs/s over the steps of epoch 2 (wall clock), the bare step "
        f"{bare:.1f}, the loader alone {tp['loader alone']:.1f}; one epoch resumed from model_1: "
        f"{tp['resumed epoch 2 (K7 on 2 levels)']:.1f} with K7, {tp['resumed epoch 2 (cuDNN estimators)']:.1f} "
        f"with --fused-estimator 0 (cuDNN) on {card}")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"card": card, "train": train_stats, "gradient_kernels_vs_plain": grad_err,
                      "k5_df1_run_to_run": atomics_rerun, "trainer": trainer_stats}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
