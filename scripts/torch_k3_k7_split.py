#!/usr/bin/env python3
"""Where K3 (fused pyramid level) and K7 (estimator chain forward) spend
their time on the card, old kernels against new, bf16, B=8.

    python3 scripts/torch_k3_k7_split.py --old <dir holding an older csrc/>

``--old`` is the ``pwcnet_tpu_torch/csrc`` directory of an earlier commit
(for example unpacked by ``git archive``), whose bf16 K3 and K7 used WMMA.
The script compiles from it, with nvcc into a temporary directory and
loaded with ctypes: K3 as it is and with one phase removed (conv1 on the
CUDA cores; conv2 and conv3 on the tensor cores) and K7 as it is. It times
them with CUDA events beside the current package's kernels and the cuDNN
chains at the 448x1024 serving shapes (K3 levels 0 and 1, K7 levels 3 and
4) and the 384x448 training shapes (K7 levels 3 and 4), and splits each K7
forward into its six convs with torch.profiler. Prints one JSON object per
measurement and the card's name and power limit. Needs an NVIDIA card.
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
from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_fused  # noqa: E402
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused  # noqa: E402

B = 8
K3_SHAPES = ((448, 1024, 3, 16), (224, 512, 16, 32))
K7_SHAPES = (("train L3", 48, 56, 179), ("train L4", 96, 112, 147),
             ("serve L3", 56, 128, 179), ("serve L4", 112, 256, 147))
COUTS = (128, 128, 96, 64, 32, 2)
# old K3 with one phase removed: (name, text replaced, replacement)
K3_ABLATIONS = (
    ("full", None, None),
    ("no conv1", "if (inside) conv1_at<bf16, CIN, C>(acc, xb, H, W, gy, gx, w1);",
     "for (int co = 0; co < C; ++co) acc[co] = 0.f;"),
    ("no conv2/conv3 MMAs", "conv_tile_tc<C>(s1, wt, scratch, r, cj);\n", "\n"),
)


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
    """Compile the old K3 variants and K7 into ``tmp``; returns name -> CDLL."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {}
    src3 = (old / "pyramid_conv.cu").read_text()
    for name, a, b in K3_ABLATIONS:
        text = src3 if a is None else src3.replace(a, b)
        if a is not None and text == src3:
            raise SystemExit(f"ablation {name!r}: text not found in the old pyramid_conv.cu")
        if name == "no conv2/conv3 MMAs":
            text = text.replace("conv_tile_tc<C>(s2, wt, scratch, r, cj);\n", "\n")
        path = tmp / f"k3_{len(jobs)}.cu"
        path.write_text(text)
        jobs[f"K3 old {name}"] = path
    jobs["K7 old"] = old / "estimator_conv.cu"
    procs = {}
    for key, src in jobs.items():
        out = tmp / f"lib{abs(hash(key))}.so"
        cmd = [_build._nvcc(), *flags, "-I", str(old), "-o", str(out), str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(out))
    return libs


def emit(**kw):
    print(json.dumps(kw), flush=True)


def conv_split(fn, n=3):
    """Device ms of each kernel launch of one call of ``fn``, in launch order (torch.profiler)."""
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="csrc/ directory of the earlier commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(args.old.resolve(), Path(tmp))
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        with torch.inference_mode():
            for h, w, cin, c in K3_SHAPES:
                x = torch.rand((B, h, w, cin), generator=gen, device=dev).to(dt)
                kb = []
                for ci in (cin, c, c):
                    kb += [(torch.randn((c, ci, 3, 3), generator=gen, device=dev) / (9 * ci) ** 0.5).to(dt),
                           (0.1 * torch.randn((c,), generator=gen, device=dev)).to(dt)]
                out = torch.empty((B, h // 2, w // 2, c), device=dev, dtype=dt)
                shape = f"{B}x{h}x{w}x{cin}->{c}"
                for key, lib in libs.items():
                    if not key.startswith("K3"):
                        continue
                    fn = lib.pwc_pyramid_level
                    fn.argtypes, fn.restype = [P] * 10 + [I] * 6 + [P], I
                    call = lambda: fn(x.data_ptr(), *[t.data_ptr() for t in kb], out.data_ptr(), None, None,  # noqa: E731
                                      B, h, w, cin, c, 1, stream())
                    if call() != 0:
                        raise SystemExit(f"{key} failed to launch")
                    emit(kernel="K3", variant=key, shape=shape, ms=ms(call))
                emit(kernel="K3", variant="new", shape=shape, ms=ms(lambda: pyramid_level_fused(x, *kb)))
                xn = x.permute(0, 3, 1, 2)

                def cudnn():
                    y = F.leaky_relu(F.conv2d(F.pad(xn, (0, 1, 0, 1)), kb[0], kb[1], stride=2), 0.1)
                    y = F.leaky_relu(F.conv2d(y, kb[2], kb[3], padding=1), 0.1)
                    return F.leaky_relu(F.conv2d(y, kb[4], kb[5], padding=1), 0.1)

                emit(kernel="K3", variant="cuDNN chain", shape=shape, ms=ms(cudnn))
            for label, h, w, cin in K7_SHAPES:
                xin = torch.randn((B, h, w, cin), generator=gen, device=dev).to(dt)
                kbs, ci = [], cin
                for c in COUTS:
                    kbs += [(torch.randn((c, ci, 3, 3), generator=gen, device=dev) / (9 * ci) ** 0.5).to(dt),
                            (0.1 * torch.randn((c,), generator=gen, device=dev)).to(dt)]
                    ci = c
                shape = f"{label} {B}x{h}x{w}x{cin}"
                lib = libs["K7 old"]
                fn = lib.pwc_estimator_chain
                pp, ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
                fn.argtypes, fn.restype = [P, pp, pp, pp, ip] + [I] * 4 + [P], I
                wts = []
                for k in kbs[0::2]:
                    t = k.permute(2, 3, 1, 0)
                    wts.append(F.pad(t, (0, -t.shape[3] % 8)).contiguous())
                outs = [torch.empty((B, h, w, c), device=dev, dtype=dt) for c in COUTS]
                chans = (ctypes.c_int * 7)(cin, *COUTS)
                ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])  # noqa: E731
                wp, bp, op = ptrs(wts), ptrs(kbs[1::2]), ptrs(outs)
                old_call = lambda: fn(xin.data_ptr(), wp, bp, op, chans, B, h, w, 1, stream())  # noqa: E731
                if old_call() != 0:
                    raise SystemExit("old K7 failed to launch")
                emit(kernel="K7", variant="old", shape=shape, ms=ms(old_call, iters=10), per_conv=conv_split(old_call))
                xpad = F.pad(xin, (0, -cin % 8))  # as the model's NHWC copy hands it over
                new_call = lambda: estimator_chain_fused(xpad, *kbs)  # noqa: E731
                emit(kernel="K7", variant="new", shape=shape, ms=ms(new_call, iters=10), per_conv=conv_split(new_call))
                xn = xin.permute(0, 3, 1, 2)

                def cudnn7():
                    y = xn
                    for i in range(6):
                        y = F.conv2d(y, kbs[2 * i], kbs[2 * i + 1], padding=1)
                        y = F.leaky_relu(y, 0.1) if i < 5 else y
                    return y

                emit(kernel="K7", variant="cuDNN chain", shape=shape, ms=ms(cudnn7, iters=10))
    print(card)


if __name__ == "__main__":
    main()
