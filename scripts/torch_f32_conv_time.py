#!/usr/bin/env python3
"""The float32 conv kernels on the card, an earlier version against the
current one against cuDNN: K3 (the fused pyramid level) and K7's
implicit-GEMM core (the estimator chain forward, and K7b's transposed
stages), B=8, float32, TF32 off.

    python3 scripts/torch_f32_conv_time.py [--old <dir holding an older csrc/>] [--rounds 2]

``--old`` is the ``pwcnet_tpu_torch/csrc`` directory of an earlier commit
(for example unpacked by ``git archive``); its ``pyramid_conv.cu``,
``estimator_conv.cu`` and ``estimator_conv_bwd.cu`` are compiled with nvcc
into a temporary directory and called through the same C entries as the
current package's. Shapes: K3 at levels 0 and 1 of the 448x1024 serving
forward and of the 384x448 training step; K7 and K7b at levels 3 and 4 of
both. Each round times old, current and cuDNN in turn with CUDA events
(inputs reused, so they sit in L2 as in the model), and the current K7
forward is split into its six convs with torch.profiler. Prints one JSON
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

from pwcnet_tpu_torch.ops.cuda import _build  # noqa: E402
from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_bwd, estimator_chain_residuals  # noqa: E402
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused  # noqa: E402

B = 8
K3_SHAPES = (("serve L0", 448, 1024, 3, 16), ("serve L1", 224, 512, 16, 32),
             ("train L0", 384, 448, 3, 16), ("train L1", 192, 224, 16, 32))
K7_SHAPES = (("train L3", 48, 56, 179), ("train L4", 96, 112, 147),
             ("serve L3", 56, 128, 179), ("serve L4", 112, 256, 147))
COUTS = (128, 128, 96, 64, 32, 2)
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


def build_old(old: Path, tmp: Path) -> dict:
    """Compile the old sources into ``tmp``; returns source name -> CDLL."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name in ("pyramid_conv", "estimator_conv", "estimator_conv_bwd"):
        out = tmp / f"lib{name}_old.so"
        cmd = [_build._nvcc(), *flags, "-I", str(old), "-o", str(out), str(old / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the old {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    libs["pyramid_conv"].pwc_pyramid_level.argtypes = [P] * 11 + [I] * 6 + [P]
    libs["estimator_conv"].pwc_estimator_chain.argtypes = [P, PP, PP, PP, P, IP] + [I] * 4 + [P]
    libs["estimator_conv_bwd"].pwc_estimator_chain_bwd.argtypes = [P, P, PP, PP, PP, P, IP] + [I] * 4 + [P]
    return libs


def emit(**kw):
    print(json.dumps(kw), flush=True)


def conv_split(fn, n=3):
    """Device ms of each conv kernel of one call of ``fn``, in launch order (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "conv3x3" in e.name]
    per = len(evs) // n
    return [round(sum(evs[i + k * per].device_time_total for k in range(n)) / n / 1e3, 4) for i in range(per)]


def ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def tap_major(k):
    t = k.permute(2, 3, 1, 0)
    return F.pad(t, (0, -t.shape[3] % 8)).contiguous()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="csrc/ directory of the earlier commit")
    ap.add_argument("--rounds", type=int, default=2, help="times each (old, current, cuDNN) turn is taken")
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
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(args.old.resolve(), Path(tmp)) if args.old else {}
        with torch.inference_mode():
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
                for rnd in range(args.rounds):
                    for variant, fn_ in turns.items():
                        emit(kernel="K3", variant=variant, shape=f"{label} {B}x{h}x{w}x{cin}->{c}", round=rnd,
                             ms=ms(fn_))
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
                for rnd in range(args.rounds):
                    for variant, fn_ in fwd.items():
                        emit(kernel="K7", variant=variant, shape=shape, round=rnd, ms=ms(fn_, iters=10))
                    for variant, fn_ in bwd.items():
                        emit(kernel="K7b", variant=variant, shape=shape, round=rnd, ms=ms(fn_, iters=10))
                emit(kernel="K7", variant="current", shape=shape, per_conv=conv_split(fwd["current"]))
                emit(kernel="K7b", variant="current", shape=shape, per_conv=conv_split(bwd["current"]))
                if "old" in fwd:
                    emit(kernel="K7", variant="old", shape=shape, per_conv=conv_split(fwd["old"]))
                    emit(kernel="K7b", variant="old", shape=shape, per_conv=conv_split(bwd["old"]))
    print(card)


if __name__ == "__main__":
    main()
