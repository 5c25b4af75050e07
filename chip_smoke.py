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
   versions on the card;
4. serving: FlowPredictor with seeded random weights answers 448x1024
   requests and a 1024x436 (Sintel-sized) request edge-padded to 448x1024,
   then batched raw_forward at B=8 in bf16 and f32; the launch counters
   must show K1 4x, K2 1x and K3 4x per forward; flows must match the same
   predictor on the plain path (use_kernels=False) and, on a small pair,
   the float32 CPU path;
5. timing: each kernel, its plain version and (K3) the cuDNN 3-conv chain
   timed with CUDA events at the main-path shapes (B=8, bf16); pairs/s of
   the whole forward at 448x1024 B=8 bf16.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores
KERNEL_INFO = {
    "K1": ("warped_cost_volume", "pwcnet_tpu_torch/csrc/warped_cv.cu",
           "pwcnet_tpu/ops/pallas/warped_cv.py:728"),
    "K2": ("cost_volume", "pwcnet_tpu_torch/csrc/cost_volume.cu",
           "pwcnet_tpu/ops/pallas/cost_volume.py:312"),
    "K3": ("pyramid_level_fused", "pwcnet_tpu_torch/csrc/pyramid_conv.cu",
           "pwcnet_tpu/ops/pallas/pyramid_conv.py:938"),
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
def check_kernels(torch, device, batches=(1, 8), dtypes=None):
    """Every kernel vs its plain version at every main-path shape.

    Tolerances: float32 (TF32 off) differs only in summation order:
    1e-5 + 1e-5 * scale. bfloat16 outputs are rounded from float32 sums,
    so the two can land one bf16 ulp apart; K1 may also round one warped
    value differently (FMA contraction), K3 each of its two intermediate
    activations: 2 ulps of the output's scale for K1/K2 (scale / 64), 4 for
    K3 (scale / 32), where scale = max |plain output|.
    """
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume, cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused, pyramid_level_plain
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume, warped_cost_volume_plain

    dtypes = dtypes or (torch.float32, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    errs = {k: {} for k in KERNEL_INFO}

    def compare(kid, label, got, want, dtype):
        want32 = want.float()
        scale = want32.abs().max().item()
        err = (got.float() - want32).abs().max().item()
        if dtype == torch.float32:
            tol = 1e-5 + 1e-5 * scale
        else:
            tol = scale / (32.0 if kid == "K3" else 64.0)
        ok = got.shape == want.shape and torch.isfinite(got.float()).all().item() and err <= tol
        log(f"  {kid} {label}: max_abs_err {err:.3e} (tol {tol:.3e}, scale {scale:.3e})")
        require(ok, f"{kid} {label} disagrees with its plain version")
        key = str(dtype).replace("torch.", "")
        errs[kid][key] = max(errs[kid].get(key, 0.0), err)

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
                            pyramid_level_fused(*args), pyramid_level_plain(*args), dtype)
                torch.cuda.synchronize()
    return errs


def time_kernels(torch, F, device, b=8, dtype=None):
    """Kernel, plain and library times at the main-path shapes, summed per forward."""
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume, cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused, pyramid_level_plain
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume, warped_cost_volume_plain

    dtype = dtype or torch.bfloat16
    dname = str(dtype).replace("torch.", "")
    s = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=device).manual_seed(1)
    rows = {k: [] for k in KERNEL_INFO}
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
    for kid, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = bound(dname, *r.pop("work"))
            log(f"  {kid} {dname} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows, dname


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


def profile(torch, pred, batch_dev):
    """Device time by kernel over 3 forwards at B=8 bf16 (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            pred.raw_forward(batch_dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # device-side events only: the CPU ops that launched them report the
    # same time again as their own device time
    kern = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    total = sum(t for _, t, _ in kern)
    log(f"  profile: wall {wall:.2f} ms for 3 forwards, kernel time {total / 1e3:.2f} ms "
        f"({100.0 * total / 1e3 / wall:.1f}% of the wall time), {sum(n for *_, n in kern)} kernels")
    for key, t, n in kern[:15]:
        log(f"    {t / 1e3:9.3f} ms  {n:5d}x  {key[:100]}")


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
    log("[kernels] kernel vs plain at the main-path shapes")
    errs = check_kernels(torch, device)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[serve] FlowPredictor, seeded random weights")
    counts, pairs, pred, batch_dev = serve(torch, np, device)
    log(f"[serve] done in {time.perf_counter() - t0:.1f} s")

    log("[time] kernels at B=8 (per forward: K1 4 levels, K2 1, K3 2 levels x 2 frames)")
    rows, dname = time_kernels(torch, F, device)
    profile(torch, pred, batch_dev)

    kernels = []
    for kid, (name, source, replaces) in KERNEL_INFO.items():
        rs = rows[kid]
        lib = [r["library_ms"] for r in rs]
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": counts[kid],
            "max_abs_err": max(errs[kid].values()),
            "max_abs_err_by_dtype": errs[kid],
            "ms": sum(r["ms"] * r["times"] for r in rs),
            "plain_ms": sum(r["plain_ms"] * r["times"] for r in rs),
            "bound_ms": sum(r["bound_ms"] * r["times"] for r in rs),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(v * r["times"] for v, r in zip(lib, rs)),
            "timed_at": f"B=8 {dname}, summed over one forward's launches",
            "shapes": rs,
        })
    log(f"[e2e] 448x1024 B=8 pairs/s: " + ", ".join(f"{k} {v:.1f}" for k, v in pairs.items())
        + f" on {card}")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
