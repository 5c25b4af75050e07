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


WGMMA_WIDTHS = (8, 16, 32, 64, 96, 128)


def wgmma_n(cout: int) -> int:
    """The wgmma width N a conv of ``cout`` output channels runs at in the
    bf16 kernels (``csrc/hopper.cuh``): the smallest built width that holds
    it."""
    for n in WGMMA_WIDTHS:
        if cout <= n:
            return n
    raise ValueError(f"{cout} output channels: the wgmma kernels are built for at most {WGMMA_WIDTHS[-1]}")


def packed_numel(cin: int, cout: int) -> int:
    """Elements of one 3x3 kernel packed for wgmma (``pack_wgmma``)."""
    return -(-cin // 16) * 9 * 2 * wgmma_n(cout) * 8


def pack_wgmma(k: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3 kernel -> the wgmma B layout of the bf16 kernels,
    ``[K/16][tap][2][N][8]``: input channels zero-padded to K, a multiple of
    16, and split into two 8-channel halves per K step; output channels
    zero-padded to ``N = wgmma_n(Cout)``; tap = ky * 3 + kx. One K step of
    all nine taps is one contiguous block, a bulk copy. The kernels' own
    packer (``csrc/hopper.cuh``, on the card) writes the same layout; this is
    its reference."""
    cout, cin = k.shape[:2]
    kp, n = -(-cin // 16) * 16, wgmma_n(cout)
    w = torch.nn.functional.pad(k.permute(2, 3, 1, 0).reshape(9, cin, cout), (0, n - cout, 0, kp - cin))
    return w.reshape(9, kp // 16, 2, 8, n).permute(1, 0, 2, 4, 3).contiguous()


def pack_wgmma_transposed(k: torch.Tensor, mirror: bool = True) -> torch.Tensor:
    """The transpose of a forward OIHW kernel ``(cout, cin, 3, 3)`` in the
    wgmma B layout, as K6's backward GEMMs take it: K = the forward's
    output channels, N = its input channels, the taps mirrored (the
    transpose of a stride-1 conv is a conv with tap 8 - t) or, for the
    phases of the stride-2 conv1^T, as they are. The on-card packer
    (``csrc/hopper.cuh``, ``transposed`` 1 or 2) writes the same layout."""
    kt = k.transpose(0, 1)
    return pack_wgmma(kt.flip(2, 3) if mirror else kt)


# The correlation kernel's tiling (csrc/correlation.cuh): tiles of 8 output
# rows, channels staged 8 at a time, up to 8 blocks a tile in one cluster
CORR_TILE_H = 8
CORR_CHUNK = 8
CORR_SPLITS = (1, 2, 4, 8)
# (least C, split): the split at which each level of the B=8 serving forward
# ran fastest on the H100 (device time, ``scripts/torch_corr_k6_time.py
# --sweep``): 8 at C = 192 (K2), 4 at 128, 2 at 96, none at 64 and 32,
# where the grid already holds a block an SM and a split adds staging and
# the cluster's sum
CORR_SPLIT_MIN_C = ((192, 8), (128, 4), (96, 2))


def correlation_plan(w: int, c: int) -> tuple[int, int]:
    """``(tw, split)`` of the correlation kernel for a call on (B, H, W, C):
    the tile width (16 where the level is at most 16 wide, else 32) and the
    blocks a tile's channel chunks are split across (a thread-block cluster
    of 1, 2, 4 or 8), from ``CORR_SPLIT_MIN_C``. The split depends on C
    alone: a row shard (K8, K9) sums each output in the same order as the
    whole frame (K2, K1), so the two agree to the bit."""
    tw = 16 if w <= 16 else 32
    return tw, next((s for c_min, s in CORR_SPLIT_MIN_C if c >= c_min), 1)


# The cost-volume backward's tiling (csrc/cost_volume_bwd.cu): tiles of 8
# columns and 8, 4 or 2 rows, 32 channels a block; df1's tiles (over the
# h + 2 pad rows) and df0's in one grid
CV_BWD_TILE_W = 8
CV_BWD_CHUNK = 32
CV_BWD_TILE_ROWS = (8, 4, 2)
CV_BWD_MIN_BLOCKS = 264  # two blocks an SM of the H100's 132


def cv_bwd_blocks(b: int, h: int, w: int, c: int, pad: int, tile_rows: int) -> int:
    """Blocks of one cost-volume backward launch: df1's tiles over the
    ``h + 2 pad`` rows, then df0's over ``h``, each times the column tiles,
    the 32-channel chunks and the batch."""
    per_row = b * -(-w // CV_BWD_TILE_W) * -(-c // CV_BWD_CHUNK)
    return per_row * (-(-(h + 2 * pad) // tile_rows) + -(-h // tile_rows))


def cv_bwd_plan(b: int, h: int, w: int, c: int, pad: int = 0) -> int:
    """Tile rows of the cost-volume backward (K4, K8b with ``pad = d``) on
    (B, H, W, C): the tallest tile (8, 4, 2) whose grid holds
    ``CV_BWD_MIN_BLOCKS``, else the shortest. Channels and tiles are
    independent and every output keeps its summation order, so the plan
    changes no bit."""
    for th in CV_BWD_TILE_ROWS:
        if cv_bwd_blocks(b, h, w, c, pad, th) >= CV_BWD_MIN_BLOCKS:
            return th
    return CV_BWD_TILE_ROWS[-1]


# The warp backward's launch (csrc/warp_bwd.cu): 256 threads a block, a
# lane 4 channels of a pixel at a time (one 16-byte float32 or 8-byte bf16
# vector, one 4-float atomic a corner), a persistent cooperative grid
WARP_BWD_THREADS = 256
WARP_BWD_CHANNELS = 4


WARP_BWD_NARROW_C, WARP_BWD_NARROW_LANES = 64, 8


def warp_bwd_lanes(c: int) -> int:
    """Lanes that serve one pixel in the warp backward (K5, K9b): its
    4-channel vectors, ``ceil(C / 4)``, rounded up to a power of two, at
    most a warp, and at most 8 up to ``C = 64`` (a lane then loops over
    its vectors). On the H100 8 lanes of two vectors beat 16 of one at the
    training step's C = 64 call, and a whole warp beat 8 lanes at C = 128."""
    vectors = -(-c // WARP_BWD_CHANNELS)
    cap = WARP_BWD_NARROW_LANES if c <= WARP_BWD_NARROW_C else 32
    lanes = 1
    while lanes < min(vectors, cap):
        lanes *= 2
    return lanes


def warp_bwd_vectorised(c: int, *ptrs: int) -> bool:
    """Whether a warp backward call loads and adds 4 channels at once (the
    source decides the same way): C a multiple of 4 and f1 and g 16-byte
    aligned; else the same lanes take their channels one by one (the scalar
    tail)."""
    return c % WARP_BWD_CHANNELS == 0 and all(p % 16 == 0 for p in ptrs)


def warp_bwd_blocks(pixels: int, lanes: int, n_acc: int, resident: int) -> int:
    """Blocks of the warp backward's persistent grid: enough for one pass of
    the scatter (``lanes`` threads a pixel) or of the zeroing (4 of the
    ``n_acc`` accumulator values a thread), at most the ``resident`` blocks
    the card holds at once (SMs x blocks an SM)."""
    t = WARP_BWD_THREADS
    return max(1, min(resident, max(-(-pixels * lanes // t), -(-(n_acc // 4) // t))))


def warp_bwd_live_rows(ho: int, row0: int, vlo: int, vhi: int) -> torch.Tensor:
    """The flow rows the warp backward scatters from (bool, ``ho``): row j
    where its frame row ``j + row0`` lies in ``[vlo, vhi]``. K9b's other
    rows read their cotangent as zero; K5 passes the whole frame."""
    rows = torch.arange(ho) + row0
    return (rows >= vlo) & (rows <= vhi)


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
