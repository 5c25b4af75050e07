#!/usr/bin/env python3
"""The float32 conv kernels on the card, an earlier version against the
current one against cuDNN: K3 (the fused pyramid level), K6 (its
backward) and K7's implicit-GEMM core (the estimator chain forward, and
K7b's transposed stages), B=8, float32, TF32 off; K4, the cost
volume's backward (with K8b, its row-shard form), and K5, the warp's
backward (with K9b, its tall-frame form), old against current in float32
and bf16.

    python3 scripts/torch_f32_conv_time.py [--old <dir holding an older csrc/>] [--rounds 2]
                                           [--kernels K3 K6 K7 K4 K5]

``--old`` is the ``pwcnet_tpu_torch/csrc`` directory of an earlier commit
(for example unpacked by ``git archive``); its sources of the chosen
kernels (``pyramid_conv.cu``, ``pyramid_conv_bwd.cu``, ``estimator_conv.cu``,
``estimator_conv_bwd.cu``, ``cost_volume_bwd.cu`` and ``warp_bwd.cu``) are compiled with nvcc
into a temporary directory and called through the same C entries as the
current package's (an old K4 entry takes no tile plan). Shapes: K3 at
levels 0 and 1 of the 448x1024 serving forward and of the 384x448
training step; K6 at the training step's two levels (dx at level 1 only,
as the step asks), its old-vs-current check also with dx at both levels
and at edge frames no tile divides; K7 and K7b at levels 3 and 4 of both;
K4 (``pwc_cost_volume_bwd``) at the training step's five calls and K8b
(``pwc_cost_volume_hpad_bwd``) at its four sharded levels per rank of 2,
both also checked at two edge frames, in float32 and bf16 (K4 has no
cuDNN yardstick; its old body is two kernels, df0 then df1, the current
one kernel, each given in device time by torch.profiler too); K5 at the
training step's four warped calls and K9b on the second of two shards of
the same frames, with two edge frames checked only, in float32 and bf16,
beside grid_sample's backward (``aten::grid_sampler_2d_backward``); the
old K5 / K9b call is what the old wrapper launched (the accumulator's
zeros, K9b's row fills, the kernel, in bf16 the rounding kernel), the
current one also by a bare ctypes call, and each call's device
operations are given in device time and by "queued" events (the calls
queued behind a sleeping kernel, so the host is out of the way and the
gaps between a call's kernels count). The old
kernels' largest differences from the
current ones come first. Each round times old, current and cuDNN in turn
with CUDA events, every second round in reverse order (inputs reused, so
they sit in L2 as in the model); the
current (and old) K7 forward and K7b and K6 are split into their kernels
with torch.profiler. ``--rounds 0`` runs the checks alone. Prints one JSON
object per measurement, then the card's name and power limit. Needs an
NVIDIA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import grid_sample_bwd  # noqa: E402  (K5's and K9b's library yardstick)
from pwcnet_tpu_torch.ops.cuda import _build  # noqa: E402
from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_bwd, cost_volume_hpad_bwd  # noqa: E402
from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_bwd, estimator_chain_residuals  # noqa: E402
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import (  # noqa: E402
    pyramid_level_bwd, pyramid_level_fused, pyramid_level_residuals)

B = 8
K3_SHAPES = (("serve L0", 448, 1024, 3, 16), ("serve L1", 224, 512, 16, 32),
             ("train L0", 384, 448, 3, 16), ("train L1", 192, 224, 16, 32))
# K6: (label, H, W, Cin, C, dx) at the training step, then edge frames
# (checked only) whose half sizes no float32 tile (16 x 28, 12 x 28) divides
# and frames under one tile
K6_SHAPES = (("train L0", 384, 448, 3, 16, False), ("train L1", 192, 224, 16, 32, True))
K6_EDGE = ((2, 34, 150, 3, 16), (2, 26, 130, 16, 32), (1, 2, 2, 16, 32), (1, 6, 10, 3, 16))
# its kernels by name in the profile: the old body's gz3 pass and one-position
# kernels, the new body's columns
K6_KERNELS = ("gz3_kernel", "conv_t_", "conv1_t_")
K7_SHAPES = (("train L3", 48, 56, 179), ("train L4", 96, 112, 147),
             ("serve L3", 56, 128, 179), ("serve L4", 112, 256, 147))
COUTS = (128, 128, 96, 64, 32, 2)
# K4: (label, B, H, W, C, d) at the training step's five calls, deep to
# fine; K8b at its four sharded levels (one rank of 2 at 384x448); edge
# frames (checked only) no tile divides, one with C off the 16-byte vector
K4_SHAPES = (("train K2", 8, 6, 7, 192, 4), ("train L1", 8, 12, 14, 128, 4), ("train L2", 8, 24, 28, 96, 4),
             ("train L3", 8, 48, 56, 64, 4), ("train L4", 8, 96, 112, 32, 4))
K8B_SHAPES = (("shard L1", 8, 6, 14, 128, 4), ("shard L2", 8, 12, 28, 96, 4), ("shard L3", 8, 24, 56, 64, 4),
              ("shard L4", 8, 48, 112, 32, 4))
K4_EDGE = (("edge", 2, 9, 37, 40, 4), ("edge", 1, 9, 13, 5, 1))
# K5: (label, B, H, W, C) at the training step's four warped calls; K9b on
# the second of two shards of the same frames (h + 2d rows against H);
# edge frames (checked only), one with C off the 4-channel vector
K5_SHAPES = (("train L1", 8, 12, 14, 128), ("train L2", 8, 24, 28, 96), ("train L3", 8, 48, 56, 64),
             ("train L4", 8, 96, 112, 32))
K9B_SHAPES = tuple((lab.replace("train", "shard"), *rest) for lab, *rest in K5_SHAPES)
K5_EDGE = (("edge", 2, 10, 37, 40), ("edge", 1, 10, 13, 5))
KERNELS = ("K3", "K6", "K7", "K4", "K5")
P, I = ctypes.c_void_p, ctypes.c_int
PP, IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)


def ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


SOURCES = {"K3": ("pyramid_conv",), "K6": ("pyramid_conv_bwd",), "K7": ("estimator_conv", "estimator_conv_bwd"),
           "K4": ("cost_volume_bwd",), "K5": ("warp_bwd",)}


def build_old(old: Path, tmp: Path, kernels) -> dict:
    """Compile the old sources of ``kernels`` into ``tmp``; returns source name -> CDLL."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name in [src for kid in kernels for src in SOURCES[kid]]:
        out = tmp / f"lib{name}_old.so"
        cmd = [_build._nvcc(), *flags, "-I", str(old), "-o", str(out), str(old / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the old {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    argtypes = {
        ("pyramid_conv", "pwc_pyramid_level"): [P] * 11 + [I] * 6 + [P],
        ("pyramid_conv_bwd", "pwc_pyramid_level_bwd"): [P] * 12 + [I] * 6 + [P],
        ("estimator_conv", "pwc_estimator_chain"): [P, PP, PP, PP, P, IP] + [I] * 4 + [P],
        ("estimator_conv_bwd", "pwc_estimator_chain_bwd"): [P, P, PP, PP, PP, P, IP] + [I] * 4 + [P],
        ("cost_volume_bwd", "pwc_cost_volume_bwd"): [P] * 6 + [I] * 6 + [P],
        ("cost_volume_bwd", "pwc_cost_volume_hpad_bwd"): [P] * 6 + [I] * 6 + [P],
        ("warp_bwd", "pwc_warp_bwd"): [P] * 6 + [I] * 5 + [P],
        ("warp_bwd", "pwc_warp_bwd_rows"): [P] * 6 + [I] * 7 + [P],
    }
    for (name, fn), types in argtypes.items():
        if name in libs:
            getattr(libs[name], fn).argtypes = types
    return libs


def emit(**kw):
    print(json.dumps(kw), flush=True)


def conv_split(fn, names=("conv3x3",), n=3, tries=3):
    """``[kernel, device ms]`` of each kernel of one call of ``fn`` whose
    name holds one of ``names``, in launch order (torch.profiler; a trace
    that caught no device event is taken again, up to ``tries`` times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in names)]
        if evs:
            break
    per = len(evs) // n
    return [[evs[i].name.split("(")[0].removeprefix("void ").removeprefix("pwc::"),
             round(sum(evs[i + k * per].device_time_total for k in range(n)) / n / 1e3, 4)] for i in range(per)]


def queued_ms(fn, iters=20, sleep_cycles=20_000_000):
    """ms per call by CUDA events with the host out of the way: the calls
    are queued behind a sleeping kernel (about 10 ms), so the card runs
    them back to back and the time includes the gaps between a call's
    kernels but not the host's launch time."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def tap_major(k):
    t = k.permute(2, 3, 1, 0)
    return F.pad(t, (0, -t.shape[3] % 8)).contiguous()


def time_turns(kernel, shape, turns, rnd, iters=20):
    """One round: each variant in turn, ms per call by CUDA events; odd
    rounds take the turns in reverse (old, current, current, old)."""
    for variant, fn in (reversed if rnd % 2 else list)(list(turns.items())):
        emit(kernel=kernel, variant=variant, shape=shape, round=rnd, ms=ms(fn, iters=iters))


def run_k3(libs, gen, dev, stream, rounds):
    for label, h, w, cin, c in K3_SHAPES:
        x = torch.rand((B, h, w, cin), generator=gen, device=dev)
        kb = []
        for ci in (cin, c, c):
            kb += [torch.randn((c, ci, 3, 3), generator=gen, device=dev) / (9 * ci) ** 0.5,
                   0.1 * torch.randn((c,), generator=gen, device=dev)]
        out = torch.empty((B, h // 2, w // 2, c), device=dev)
        turns = {"current": lambda: pyramid_level_fused(x, *kb)}
        if libs:
            fn = libs["pyramid_conv"].pwc_pyramid_level

            def old():
                if fn(x.data_ptr(), *[t.data_ptr() for t in kb], out.data_ptr(), None, None, None,
                      B, h, w, cin, c, 0, stream()):
                    raise SystemExit("the old K3 failed to launch")
            old()
            torch.cuda.synchronize()
            emit(kernel="K3", check="old vs current", shape=label,
                 max_abs_diff=(out - pyramid_level_fused(x, *kb)).abs().max().item())
            turns = {"old": old, **turns}
        xn = x.permute(0, 3, 1, 2)

        def cudnn():
            y = F.leaky_relu(F.conv2d(F.pad(xn, (0, 1, 0, 1)), kb[0], kb[1], stride=2), 0.1)
            y = F.leaky_relu(F.conv2d(y, kb[2], kb[3], padding=1), 0.1)
            return F.leaky_relu(F.conv2d(y, kb[4], kb[5], padding=1), 0.1)

        turns["cuDNN chain"] = cudnn
        for rnd in range(rounds):
            time_turns("K3", f"{label} {B}x{h}x{w}x{cin}->{c}", turns, rnd)


def cudnn_level_bwd(g, out, s1, s2, k1, k2, k3, x_shape):
    """K6's yardstick: the cuDNN conv2d_input chain (NCHW views), as chip_smoke.py times it."""
    from torch.nn.grad import conv2d_input

    def mask(a):
        return torch.where(a >= 0, 1.0, 0.1)

    gz3 = g * mask(out)
    gz2 = conv2d_input(gz3.shape, k3, gz3, padding=1) * mask(s2)
    gz1 = conv2d_input(gz2.shape, k2, gz2, padding=1) * mask(s1)
    if x_shape is None:
        return gz1, gz2, gz3
    return gz1, gz2, gz3, conv2d_input(x_shape, k1, gz1, stride=2)


def run_k6(libs, gen, dev, stream, rounds):
    """K6 at the training levels (timed) and the edge frames (checked)."""
    cases = [(label, B, h, w, cin, c, dx) for label, h, w, cin, c, dx in K6_SHAPES]
    cases += [(f"edge {b}x{h}x{w}x{cin}", b, h, w, cin, c, None) for b, h, w, cin, c in K6_EDGE]
    for label, b, h, w, cin, c, need_dx in cases:
        x = torch.rand((b, h, w, cin), generator=gen, device=dev)
        kb = []
        for ci in (cin, c, c):
            kb += [torch.randn((c, ci, 3, 3), generator=gen, device=dev) / (9 * ci) ** 0.5,
                   0.1 * torch.randn((c,), generator=gen, device=dev)]
        out, s1, s2 = pyramid_level_residuals(x, *kb)
        g = torch.randn(out.shape, generator=gen, device=dev)
        a6 = (x, kb[0], kb[2], kb[4], out, s1, s2, g)
        shape = f"{label} {b}x{h}x{w}x{cin}->{c}"
        if libs:
            fn = libs["pyramid_conv_bwd"].pwc_pyramid_level_bwd
            gzs = [torch.empty_like(out) for _ in range(3)]
            dxo = torch.empty_like(x)

            def old(dx=True):
                if fn(g.data_ptr(), out.data_ptr(), s1.data_ptr(), s2.data_ptr(), kb[0].data_ptr(),
                      kb[2].data_ptr(), kb[4].data_ptr(), *[t.data_ptr() for t in gzs],
                      dxo.data_ptr() if dx else None, None, b, h, w, cin, c, 0, stream()):
                    raise SystemExit("the old K6 failed to launch")
            old()
            new = pyramid_level_bwd(*a6, need_dx=True)
            torch.cuda.synchronize()
            emit(kernel="K6", check="old vs current", shape=shape, dx=True,
                 max_abs_diff={k: (o - n).abs().max().item() for k, o, n in zip(("gz1", "gz2", "gz3", "dx"),
                                                                                 [*gzs, dxo], new)})
        if need_dx is None:
            continue
        turns = {"current": lambda: pyramid_level_bwd(*a6, need_dx=need_dx)}
        if libs:
            turns = {"old": lambda: old(need_dx), **turns}
        nchw = [t.permute(0, 3, 1, 2) for t in (g, out, s1, s2)]
        lib = (*nchw, kb[0], kb[2], kb[4], (b, cin, h + 1, w + 1) if need_dx else None)  # the bottom/right pad
        turns["cuDNN conv2d_input chain"] = lambda: cudnn_level_bwd(*lib)
        shape += f" dx={need_dx}"
        for rnd in range(rounds):
            time_turns("K6", shape, turns, rnd)
        if rounds:
            for variant in ("old", "current"):
                if variant in turns:
                    emit(kernel="K6", variant=variant, shape=shape, per_kernel=conv_split(turns[variant], K6_KERNELS))


def run_k7(libs, gen, dev, stream, rounds):
    for label, h, w, cin in K7_SHAPES:
        xin = torch.randn((B, h, w, cin), generator=gen, device=dev)
        kbs, ci = [], cin
        for c in COUTS:
            kbs += [torch.randn((c, ci, 3, 3), generator=gen, device=dev) / (9 * ci) ** 0.5,
                    0.1 * torch.randn((c,), generator=gen, device=dev)]
            ci = c
        ks = kbs[0::2]
        xpad = F.pad(xin, (0, -cin % 8))  # as the model's NHWC copy hands it over
        flow, feat, acts = estimator_chain_residuals(xpad, *kbs)
        saved = [*acts, feat]
        shape = f"{label} {B}x{h}x{w}x{cin}"
        torch.cuda.synchronize()
        g_flow = torch.randn(flow.shape, generator=gen, device=dev)
        g_feat = torch.randn(feat.shape, generator=gen, device=dev)
        estimator_chain_bwd(ks, saved, g_flow, g_feat)
        torch.cuda.synchronize()
        fwd = {"current": lambda: estimator_chain_residuals(xpad, *kbs)}
        bwd = {"current": lambda: estimator_chain_bwd(ks, saved, g_flow, g_feat)}
        if libs:
            f_old = libs["estimator_conv"].pwc_estimator_chain
            b_old = libs["estimator_conv_bwd"].pwc_estimator_chain_bwd
            kpad = [F.pad(ks[0], (0, 0, 0, 0, 0, xpad.shape[-1] - cin))] + ks[1:]
            wts = [tap_major(k) for k in kpad]
            wts_b = [tap_major(k) for k in ks]
            outs = [torch.empty((B, h, w, c), device=dev) for c in COUTS]
            gzs = [torch.empty_like(a) for a in saved]
            dxin = torch.empty((B, h, w, cin), device=dev)
            chans = (ctypes.c_int * 7)(xpad.shape[-1], *COUTS)
            chans_b = (ctypes.c_int * 7)(cin, *COUTS)
            wp, bp, op = ptrs(wts), ptrs(kbs[1::2]), ptrs(outs)
            ap_, wbp, gp = ptrs(saved[:5]), ptrs(wts_b), ptrs(gzs)

            def fwd_old():
                if f_old(xpad.data_ptr(), wp, bp, op, None, chans, B, h, w, 0, stream()):
                    raise SystemExit("the old K7 failed to launch")

            def bwd_old():
                if b_old(g_flow.data_ptr(), g_feat.data_ptr(), ap_, wbp, gp, dxin.data_ptr(), chans_b,
                         B, h, w, 0, stream()):
                    raise SystemExit("the old K7b failed to launch")
            for what, fn_ in (("old K7", fwd_old), ("old K7b", bwd_old)):
                fn_()
                try:
                    torch.cuda.synchronize()
                except RuntimeError as exc:
                    raise SystemExit(f"{what} at {shape}: {exc}")
            new_gz, new_dx = estimator_chain_bwd(ks, saved, g_flow, g_feat)
            emit(kernel="K7", check="old vs current", shape=shape,
                 max_abs_diff=max((a - b).abs().max().item() for a, b in zip(outs, [*acts, feat, flow])),
                 max_abs_diff_bwd=max((a - b).abs().max().item() for a, b in zip([*gzs, dxin], [*new_gz, new_dx])))
            fwd = {"old": fwd_old, **fwd}
            bwd = {"old": bwd_old, **bwd}
        xn = xin.permute(0, 3, 1, 2)
        sn = [a.permute(0, 3, 1, 2) for a in saved]
        gfn, gftn = g_flow.permute(0, 3, 1, 2), g_feat.permute(0, 3, 1, 2)

        def cudnn7():
            y = xn
            for i in range(6):
                y = F.conv2d(y, kbs[2 * i], kbs[2 * i + 1], padding=1)
                y = F.leaky_relu(y, 0.1) if i < 5 else y
            return y

        def cudnn7b():
            from torch.nn.grad import conv2d_input

            gz = gfn
            for i in range(5, 0, -1):
                ds = conv2d_input((B, ks[i].shape[1], h, w), ks[i], gz, padding=1)
                if i == 5:
                    ds = ds + gftn
                gz = ds * torch.where(sn[i - 1] >= 0, 1.0, 0.1)
            return conv2d_input((B, cin, h, w), ks[0], gz, padding=1)

        fwd["cuDNN chain"] = cudnn7
        bwd["cuDNN conv2d_input chain"] = cudnn7b
        for rnd in range(rounds):
            time_turns("K7", shape, fwd, rnd, iters=10)
            time_turns("K7b", shape, bwd, rnd, iters=10)
        if rounds:
            for variant in ("old", "current"):
                if variant in fwd:
                    emit(kernel="K7", variant=variant, shape=shape, per_conv=conv_split(fwd[variant]))
                    emit(kernel="K7b", variant=variant, shape=shape, per_conv=conv_split(bwd[variant]))


def run_k4(libs, gen, dev, stream, rounds):
    """K4 and K8b, old against current, float32 and bf16: the largest
    difference of each call first (0.0: the same bits), then the times."""
    dtypes = {"float32": (torch.float32, 0), "bfloat16": (torch.bfloat16, 1)}
    cases = [("K4", *s) for s in K4_SHAPES + K4_EDGE] + [("K8b", *s) for s in K8B_SHAPES + K4_EDGE]
    for dname, (dtype, code) in dtypes.items():
        for kid, label, b, h, w, c, d in cases:
            halo = d if kid == "K8b" else 0
            f0 = torch.randn((b, h, w, c), generator=gen, device=dev).to(dtype)
            f1 = torch.randn((b, h + 2 * halo, w, c), generator=gen, device=dev).to(dtype)
            out = torch.randn((b, h, w, (2 * d + 1) ** 2), generator=gen, device=dev).to(dtype)
            g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
            wrapper = cost_volume_hpad_bwd if kid == "K8b" else cost_volume_bwd
            turns = {"current": lambda: wrapper(f0, f1, out, g, d)}
            shape = f"{label} {dname} {b}x{h}x{w}x{c} d={d}"
            if libs:
                fn = getattr(libs["cost_volume_bwd"], "pwc_cost_volume_hpad_bwd" if halo else "pwc_cost_volume_bwd")
                df0, df1 = torch.empty_like(f0), torch.empty_like(f1)

                def old():
                    if fn(f0.data_ptr(), f1.data_ptr(), out.data_ptr(), g.data_ptr(), df0.data_ptr(),
                          df1.data_ptr(), b, h, w, c, d, code, stream()):
                        raise SystemExit(f"the old {kid} failed to launch")
                old()
                new = turns["current"]()
                torch.cuda.synchronize()
                emit(kernel=kid, check="old vs current", shape=shape,
                     max_abs_diff={k: (o.float() - n.float()).abs().max().item()
                                   for k, o, n in zip(("df0", "df1"), (df0, df1), new)},
                     bitwise=all(torch.equal(o, n) for o, n in zip((df0, df1), new)))
                turns = {"old": old, **turns}
            if label == "edge":
                continue
            for rnd in range(rounds):
                time_turns(kid, shape, turns, rnd)
            if rounds:  # device time: the coarse calls are shorter than their host time
                for variant, call in turns.items():
                    emit(kernel=kid, variant=variant, shape=shape, per_kernel=conv_split(call, ("cv_bwd_kernel",)))


def run_k5(libs, gen, dev, stream, rounds):
    """K5 and K9b, old against current, float32 and bf16. The old call is
    what the old wrapper launched: the float32 accumulator's zeros (and for
    K9b the two row fills), the kernel, in bf16 the rounding kernel. Each
    call's largest difference first (float32 atomics: the last bits vary
    from run to run), then old, current and grid_sample's backward by
    events in alternating rounds, then each call's device operations by
    device time (torch.profiler)."""
    from pwcnet_tpu_torch.ops.cuda import _common
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warp_bwd, warped_rows_bwd

    d = 4
    cases = [("K5", *s) for s in K5_SHAPES + K5_EDGE] + [("K9b", *s) for s in K9B_SHAPES + K5_EDGE]
    for dname, (dtype, code) in {"float32": (torch.float32, 0), "bfloat16": (torch.bfloat16, 1)}.items():
        for kid, label, b, hf, w, c in cases:
            tall = kid == "K9b"
            h = hf // 2 if tall else hf
            ho = h + 2 * d if tall else hf
            f1 = torch.randn((b, hf, w, c), generator=gen, device=dev).to(dtype)
            flow = torch.randn((b, ho, w, 2), generator=gen, device=dev) * 3.0
            flow[:, ::7, ::5] *= 20.0
            g = torch.randn((b, ho, w, c), generator=gen, device=dev).to(dtype)
            if tall:  # the second of two shards: its rows of the frame, its offset in the flow
                vb, row0 = (-h, hf - 1 - h), -d
                flow[..., 1] += h
                live = _common.warp_bwd_live_rows(ho, row0, *vb).to(dev)[None, :, None, None]
                g = g * live.to(dtype)  # the rows the old wrapper zeroed, so both read the same g
                turns = {"current": lambda: warped_rows_bwd(f1, flow, vb, g, d)}
            else:
                flow, row0 = flow.to(dtype), 0
                turns = {"current": lambda: warp_bwd(f1, flow, g)}
            shape = f"{label} {dname} {b}x{ho}x{w}x{c}" + (f" of {hf}" if tall else "")
            if libs:
                lib = libs["warp_bwd"]
                df1, dflow = torch.empty_like(f1), torch.empty_like(flow)

                def old():
                    acc = torch.zeros(f1.shape, dtype=torch.float32, device=dev)
                    out = acc if code == 0 else df1
                    if tall:
                        g[:, : max(0, vb[0] + d)] = 0
                        g[:, max(0, vb[1] + d + 1):] = 0
                        err = lib.pwc_warp_bwd_rows(f1.data_ptr(), flow.data_ptr(), g.data_ptr(), acc.data_ptr(),
                                                    out.data_ptr(), dflow.data_ptr(), b, ho, hf, w, c, row0, code,
                                                    stream())
                    else:
                        err = lib.pwc_warp_bwd(f1.data_ptr(), flow.data_ptr(), g.data_ptr(), acc.data_ptr(),
                                               out.data_ptr(), dflow.data_ptr(), b, hf, w, c, code, stream())
                    if err:
                        raise SystemExit(f"the old {kid} failed to launch")
                    return out, dflow

                cur = _common.kernel("warp_bwd", "pwc_warp_bwd_rows" if tall else "pwc_warp_bwd",
                                     [P] * 6 + [I] * (10 if tall else 6) + [P])[0]
                df1_b, dflow_b = torch.empty_like(f1), torch.empty_like(flow)
                acc_b = torch.empty(f1.shape, dtype=torch.float32, device=dev) if code else None
                lanes = _common.warp_bwd_lanes(c)
                ptrs_b = (f1.data_ptr(), flow.data_ptr(), g.data_ptr(), acc_b.data_ptr() if code else None,
                          df1_b.data_ptr(), dflow_b.data_ptr())

                def bare():  # the current kernel by a bare ctypes call, as the old one is called
                    dims = (b, ho, hf, w, c, row0, *vb) if tall else (b, hf, w, c)
                    if cur(*ptrs_b, *dims, lanes, code, stream()):
                        raise SystemExit(f"the current {kid} failed to launch")

                got_old = old()
                new = turns["current"]()
                torch.cuda.synchronize()
                emit(kernel=kid, check="old vs current", shape=shape,
                     max_abs_diff={k: (o.float() - n.float()).abs().max().item()
                                   for k, o, n in zip(("df1", "dflow"), got_old, new)},
                     scale={k: n.float().abs().max().item() for k, n in zip(("df1", "dflow"), new)})
                turns = {"old": old, **turns, "current bare": bare}
            if label == "edge":
                continue
            turns["grid_sample"] = grid_sample_bwd(torch, f1, flow, g, row0)
            try:
                turns["grid_sample"]()
            except (RuntimeError, NotImplementedError) as exc:
                emit(kernel=kid, variant="grid_sample", shape=shape, unsupported=str(exc).splitlines()[0][:120])
                del turns["grid_sample"]
            for rnd in range(rounds):
                time_turns(kid, shape, turns, rnd)
            if rounds:  # device time: the coarse calls are shorter than their host time
                for variant, call in turns.items():
                    emit(kernel=kid, variant=variant, shape=shape, per_kernel=conv_split(call, ("",)),
                         queued_ms=queued_ms(call))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="csrc/ directory of the earlier commit")
    ap.add_argument("--rounds", type=int, default=2, help="times each (old, current, cuDNN) turn is taken")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS,
                    help="which kernels (K7 includes K7b, K4 K8b, K5 K9b)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    runs = {"K3": run_k3, "K6": run_k6, "K7": run_k7, "K4": run_k4, "K5": run_k5}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(args.old.resolve(), Path(tmp), args.kernels) if args.old else {}
        with torch.inference_mode():
            for kid in KERNELS:
                if kid in args.kernels:
                    runs[kid](libs, gen, dev, stream, args.rounds)
    print(card)


if __name__ == "__main__":
    main()
