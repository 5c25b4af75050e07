"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<digest>.so csrc/<name>.cu

``<digest>`` hashes the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused. Libraries go to
``pwcnet_tpu_torch/build/`` (listed in ``.gitignore``). ``build()`` starts
one nvcc per source, all at once, and waits for them together. nvcc is
``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the one on
``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "load", "library_path"]

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = (
    "cost_volume", "warped_cv", "pyramid_conv",  # K2, K1, K3
    "cost_volume_bwd", "warp_bwd", "pyramid_conv_bwd",  # K4, K5, K6
    "estimator_conv", "estimator_conv_bwd",  # K7 forward and backward
    "corr_lookup",  # R1, RAFT's correlation lookup
    "raft_update",  # R2 and R3, RAFT's conv epilogues and GRU gates
    "global_attention",  # R4, GMFlow's global matching and propagation
)
HEADERS = ("common.cuh", "correlation.cuh", "conv_fma.cuh", "conv3x3_gemm.cuh", "conv3x3_wgmma.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            "kernels are built from source at first use and need the toolkit"
        )
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in [CSRC / f"{name}.cu"] + [CSRC / hd for hd in HEADERS]:
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, in parallel.

    Returns ``{name: {"seconds": s or 0.0 if cached, "ptxas": text}}``;
    raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.is_file():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.is_file():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
