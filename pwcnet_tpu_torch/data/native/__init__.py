"""ctypes bindings for the native data-loading core (``pwcdata.cc``).

Counterpart of ``pwcnet_tpu/data/native/__init__.py`` with the port's own
copy of the source. The shared library is built with g++ at first use into
``pwcnet_tpu_torch/build/`` (listed in ``.gitignore``), under a name that
hashes the source, so an edited source rebuilds. It accelerates the image
and .flo hot path, PPM (FlyingChairs) and 8-bit non-interlaced PNG (Sintel)
decode, with a threaded C++ batch assembler; every function has a pure
Python counterpart in ``pwcnet_tpu_torch.data.datasets``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "pwcdata.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libpwcdata-{digest}.so"


def _build(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread",
            str(_SRC), "-o", str(tmp)]
    # PNG IDAT inflate: libdeflate where its headers are installed, else zlib
    attempts = [base + ["-DUSE_LIBDEFLATE", "-ldeflate"], base + ["-lz"]]
    errors = []
    for cmd in attempts:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeUnavailable(f"g++ not found: {e}") from None
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            return
        errors.append(proc.stderr[-1000:])
    tmp.unlink(missing_ok=True)
    raise NativeUnavailable("g++ build failed:\n" + "\n---\n".join(errors))


def load_library():
    """Build (if needed) and load the native library; raises
    NativeUnavailable when no toolchain is present."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            # built on another machine against a library this one lacks
            # (libdeflate): build again with what is installed here
            path.unlink()
            _build(path)
            lib = ctypes.CDLL(str(path))
        lib.pwc_image_size.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.pwc_image_size.restype = ctypes.c_int
        lib.pwc_read_flo.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.pwc_read_flo.restype = ctypes.c_int
        lib.pwc_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.pwc_load_batch.restype = ctypes.c_int
        lib.pwc_assemble_cached.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte),   # frames base
            ctypes.POINTER(ctypes.c_float),   # flows base
            ctypes.c_int,                     # n_frames
            ctypes.c_int,                     # n_flows
            ctypes.c_int,                     # frame_h
            ctypes.c_int,                     # frame_w
            ctypes.c_int,                     # batch
            ctypes.c_int,                     # crop_h
            ctypes.c_int,                     # crop_w
            ctypes.POINTER(ctypes.c_int),     # img0_idx
            ctypes.POINTER(ctypes.c_int),     # img1_idx
            ctypes.POINTER(ctypes.c_int),     # flow_idx
            ctypes.POINTER(ctypes.c_int),     # y0s
            ctypes.POINTER(ctypes.c_int),     # x0s
            ctypes.POINTER(ctypes.c_ubyte),   # flip_bits
            ctypes.POINTER(ctypes.c_float),   # images_out
            ctypes.POINTER(ctypes.c_float),   # flows_out
            ctypes.c_int,                     # num_threads
        ]
        lib.pwc_assemble_cached.restype = ctypes.c_int
        lib.pwc_assemble_cached_u8.argtypes = (
            lib.pwc_assemble_cached.argtypes[:15]
            + [
                ctypes.POINTER(ctypes.c_ubyte),  # images_out (uint8)
                ctypes.POINTER(ctypes.c_float),  # flows_out
                ctypes.c_int,                    # num_threads
            ]
        )
        lib.pwc_assemble_cached_u8.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    try:
        load_library()
        return True
    except NativeUnavailable:
        return False


def image_size(path: str) -> tuple[int, int]:
    """(H, W) of a PPM/PNG frame via the native decoder; raises IOError
    for formats it cannot decode (the loader's decodability probe)."""
    lib = load_library()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.pwc_image_size(
        str(path).encode(), ctypes.byref(h), ctypes.byref(w)
    )
    if rc != 0:
        raise IOError(f"pwc_image_size({path}) failed with code {rc}")
    return (h.value, w.value)


def read_flo(path: str, max_hw: tuple[int, int] = (4096, 4096)) -> np.ndarray:
    """Read a .flo via the native core -> (H, W, 2) float32."""
    lib = load_library()
    buf = np.empty(max_hw[0] * max_hw[1] * 2, np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.pwc_read_flo(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size,
        ctypes.byref(h),
        ctypes.byref(w),
    )
    if rc != 0:
        raise IOError(f"pwc_read_flo({path}) failed with code {rc}")
    return buf[: h.value * w.value * 2].reshape(h.value, w.value, 2).copy()


def load_batch(
    samples,
    crop_hw: tuple[int, int],
    y0s,
    x0s,
    flips,
    num_threads: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """Assemble a normalized batch from (img0, img1, flo) PPM/flo triples.

    Returns (images (B,2,ch,cw,3) f32 in [0,1], flows (B,ch,cw,2) f32).
    ``flips`` bits: 1 = horizontal, 2 = vertical.
    """
    lib = load_library()
    batch = len(samples)
    ch, cw = crop_hw
    images = np.empty((batch, 2, ch, cw, 3), np.float32)
    flows = np.empty((batch, ch, cw, 2), np.float32)

    def _paths(i):
        return (ctypes.c_char_p * batch)(
            *[str(s[i]).encode() for s in samples]
        )

    y0_arr = (ctypes.c_int * batch)(*[int(v) for v in y0s])
    x0_arr = (ctypes.c_int * batch)(*[int(v) for v in x0s])
    flip_arr = (ctypes.c_ubyte * batch)(*[int(v) for v in flips])
    rc = lib.pwc_load_batch(
        _paths(0),
        _paths(1),
        _paths(2),
        batch,
        ch,
        cw,
        y0_arr,
        x0_arr,
        flip_arr,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    if rc != 0:
        raise IOError(f"pwc_load_batch failed with code {rc}")
    return images, flows


def assemble_cached(
    frames: np.ndarray,
    flows: np.ndarray,
    img0_idx,
    img1_idx,
    flow_idx,
    crop_hw: tuple[int, int],
    y0s,
    x0s,
    flips,
    num_threads: int = 4,
    image_dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Assemble a batch from pre-decoded raw arrays.

    ``frames``: (n_frames, H, W, 3) uint8 C-contiguous (a np.memmap of the
    cache's frames file works directly); ``flows``: (n_flows, H, W, 2)
    float32. Crop/flip/normalize semantics match `load_batch` exactly.
    ``image_dtype=np.float32``: images normalized to [0,1] on the host;
    ``np.uint8``: raw bytes (device-normalize pipeline — 4x fewer host and
    PCIe image bytes; the consumer divides by 255 on-device).
    Returns (images (B,2,ch,cw,3), flows (B,ch,cw,2) f32).
    """
    lib = load_library()
    assert frames.dtype == np.uint8 and frames.ndim == 4
    assert flows.dtype == np.float32 and flows.ndim == 4
    image_dtype = np.dtype(image_dtype)
    assert image_dtype in (np.float32, np.uint8)
    n_frames, fh, fw, _ = frames.shape
    n_flows = flows.shape[0]
    batch = len(img0_idx)
    ch, cw = crop_hw
    images_out = np.empty((batch, 2, ch, cw, 3), image_dtype)
    flows_out = np.empty((batch, ch, cw, 2), np.float32)

    def _ints(v):
        return (ctypes.c_int * batch)(*[int(x) for x in v])

    if image_dtype == np.uint8:
        fn = lib.pwc_assemble_cached_u8
        img_ptr = images_out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    else:
        fn = lib.pwc_assemble_cached
        img_ptr = images_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = fn(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        flows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_frames,
        n_flows,
        fh,
        fw,
        batch,
        ch,
        cw,
        _ints(img0_idx),
        _ints(img1_idx),
        _ints(flow_idx),
        _ints(y0s),
        _ints(x0s),
        (ctypes.c_ubyte * batch)(*[int(v) for v in flips]),
        img_ptr,
        flows_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    if rc != 0:
        raise IOError(f"pwc_assemble_cached failed with code {rc}")
    return images_out, flows_out
