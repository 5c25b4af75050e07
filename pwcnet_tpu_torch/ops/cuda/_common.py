"""Checks and the ctypes call shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from pwcnet_tpu_torch.ops.cuda import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

P = ctypes.c_void_p
I = ctypes.c_int


def check_tensors(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one dtype
    the kernels take (float32 or bfloat16) on one device."""
    first = tensors[0]
    if first.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got {first.dtype}")
    for t in tensors:
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: mixed dtypes {first.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous (NHWC)")


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd will ask for a gradient of any of ``tensors``: the
    forward kernels write their residuals only then."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def kernel(lib_name: str, fn_name: str, argtypes: list):
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu``, typed."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.pwc_error_string.argtypes = [ctypes.c_int]
    lib.pwc_error_string.restype = ctypes.c_char_p
    return fn, lib


def launch(lib_name: str, fn_name: str, argtypes: list, device: torch.device, *args) -> None:
    """Call the entry point on ``device``'s current stream; raise on a CUDA error."""
    fn, lib = kernel(lib_name, fn_name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        msg = lib.pwc_error_string(code).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {code} ({msg})")
