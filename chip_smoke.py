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
   warp) and K6 (pyramid level) against their plain versions;
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
6. timing: each kernel, its plain version and (K3, K6) the cuDNN conv
   chain timed with CUDA events at the main-path shapes (B=8, bf16);
   pairs/s of the whole forward at 448x1024 B=8 bf16; device time by
   kernel for the forward and for the train step (torch.profiler).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    (scale * ulps / 128), where scale = max |plain result|.
    """

    def compare(kid, label, got, want, dtype, ulps=2):
        want32 = want.float()
        scale = want32.abs().max().item()
        err = (got.float() - want32).abs().max().item()
        tol = 1e-5 + 1e-5 * scale if dtype == torch.float32 else scale * ulps / 128.0
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


def train_model(torch, compute_dtype, use_kernels, seed=0):
    """The default PWCDCNet as the JAX trainer builds it with --pallas: K2 at
    level 0, K1 at levels 1-4, K3 on the two finest pyramid levels."""
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

    hooks = {}
    if use_kernels:
        hooks = dict(cost_volume_fn=cost_volume_cuda, warp_cv_fn=warped_cost_volume, fused_pyramid_levels=2)
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
            want = {k: (5 * n if use_kernels else 0) for k, n in PER_STEP.items()}
            require(got == want, f"{name}: launches {got}, want {want}")
            if use_kernels:
                counts[dtype_name(dt)] = got
            ms = cuda_ms(torch, lambda: step(state, images, flows_gt), iters=5, warmup=0)
            stats[name] = {"ms": ms, "pairs_per_s": 8e3 / ms, "peak_mib": peak, "losses": losses}
            log(f"  384x448 B=8 {name}: {ms:.2f} ms per step, {8e3 / ms:.1f} pairs/s")
            if use_kernels and dt == torch.bfloat16:
                stats[name]["profile"] = profile_steps(
                    torch, lambda: step(state, images, flows_gt), 2, "train steps at 384x448 B=8 bf16", ms)
    total_counts = {k: sum(c[k] for c in counts.values()) for k in PER_STEP}
    return total_counts, stats, grad_err


# device kernels by name: the port's own, the library's convolutions, PyTorch's elementwise tail
PROFILE_GROUPS = (
    ("K1 warped_cost_volume", ("WarpLoader",)),
    ("K2 cost_volume", ("PlainLoader",)),
    ("K3 pyramid_level", ("pyramid_level",)),
    ("K4 cost_volume_bwd", ("cv_bwd_kernel",)),
    ("K5 warp_bwd", ("warp_bwd_kernel", "round_kernel")),
    ("K6 pyramid_level_bwd", ("gz3_kernel", "conv_t_s")),
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
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[serve] FlowPredictor, seeded random weights")
    serve_counts, pairs, pred, batch_dev = serve(torch, np, device)
    log(f"[serve] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train] the train step at 384x448, seeded random weights, float32 parameters")
    train_counts, train_stats, grad_err = train(torch, np, device)
    log(f"[train] done in {time.perf_counter() - t0:.1f} s")

    log("[time] kernels at B=8 bf16 (per forward: K1 4 levels, K2 1, K3 2 levels x 2 frames; "
        "per train step: K4 5 shapes, K5 4, K6 2 levels x 2 frames)")
    rows, dname = time_kernels(torch, F, device)
    rows.update(time_training_kernels(torch, device))
    profile_steps(torch, lambda: pred.raw_forward(batch_dev), 3, "forwards at 448x1024 B=8 bf16",
                  8e3 / pairs["bfloat16 kernels"])

    kernels = []
    for kid, (name, source, replaces) in KERNEL_INFO.items():
        rs = rows[kid]
        lib = [r["library_ms"] for r in rs]
        on_serve = serve_counts.get(kid, 0)
        require(train_counts[kid] > 0 and (on_serve > 0 or kid not in PER_FORWARD),
                f"{kid} was not launched on a path that runs it")
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": on_serve + train_counts[kid],
            "launches_serving": on_serve,
            "launches_training": train_counts[kid],
            "max_abs_err": max(errs[kid].values()),
            "max_abs_err_by_dtype": errs[kid],
            "ms": sum(r["ms"] * r["times"] for r in rs),
            "plain_ms": sum(r["plain_ms"] * r["times"] for r in rs),
            "bound_ms": sum(r["bound_ms"] * r["times"] for r in rs),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(v * r["times"] for v, r in zip(lib, rs)),
            "timed_at": f"B=8 {dname}, summed over one "
                        + ("forward's launches at 448x1024" if kid in PER_FORWARD
                           else "train step's launches at 384x448"),
            "shapes": rs,
        })
    log(f"[e2e] 448x1024 B=8 serving pairs/s: " + ", ".join(f"{k} {v:.1f}" for k, v in pairs.items())
        + f" on {card}")
    log(f"[e2e] 384x448 B=8 training pairs/s: "
        + ", ".join(f"{k} {v['pairs_per_s']:.1f}" for k, v in train_stats.items()) + f" on {card}")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"train": train_stats, "gradient_kernels_vs_plain": grad_err,
                      "k5_df1_run_to_run": atomics_rerun}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
