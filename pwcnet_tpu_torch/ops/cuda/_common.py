"""Checks and the ctypes call shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
import math

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


def wgmma_tiles(cout: int) -> tuple[int, int]:
    """``(tiles, n)``: the N tiles a bf16 wgmma conv of ``cout`` output
    channels runs in (``csrc/hopper.cuh``): ``ceil(cout / 128)`` tiles of
    the narrowest built width that holds an equal share; tile ``j`` takes
    channels ``[j n, min((j + 1) n, cout))``. One tile up to 128 channels;
    K7b's dxin (147..280) takes two or three."""
    tiles = max(1, -(-cout // WGMMA_WIDTHS[-1]))
    return tiles, wgmma_n(-(-cout // tiles))


def packed_numel(cin: int, cout: int) -> int:
    """Elements of one 3x3 kernel packed for wgmma, in the N tiles of
    ``wgmma_tiles(cout)`` (one tile: ``pack_wgmma``)."""
    tiles, n = wgmma_tiles(cout)
    return tiles * -(-cin // 16) * 9 * 2 * n * 8


def pack_wgmma(k: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """OIHW 3x3 kernel -> the wgmma B layout of the bf16 kernels,
    ``[K/16][tap][2][N][8]``: input channels zero-padded to K, a multiple of
    16, and split into two 8-channel halves per K step; output channels
    zero-padded to ``N = n`` or ``wgmma_n(Cout)``; tap = ky * 3 + kx. One K
    step of all nine taps is one contiguous block, a bulk copy. The kernels'
    own packer (``csrc/hopper.cuh``, on the card) writes the same layout;
    this is its reference."""
    cout, cin = k.shape[:2]
    kp, n = -(-cin // 16) * 16, n or wgmma_n(cout)
    w = torch.nn.functional.pad(k.permute(2, 3, 1, 0).reshape(9, cin, cout), (0, n - cout, 0, kp - cin))
    return w.reshape(9, kp // 16, 2, 8, n).permute(1, 0, 2, 4, 3).contiguous()


def pack_wgmma_transposed(k: torch.Tensor, mirror: bool = True) -> torch.Tensor:
    """The transpose of a forward OIHW kernel ``(cout, cin, 3, 3)`` in the
    wgmma B layout, as K6's backward GEMMs take it: K = the forward's
    output channels, N = its input channels, the taps mirrored (the
    transpose of a stride-1 conv is a conv with tap 8 - t) or, for the
    phases of the stride-2 conv1^T, as they are. The on-card packer
    (``csrc/hopper.cuh``, ``transposed`` 1 or 2) writes the same layout;
    K7b packs the mirrored transpose in N tiles (``transposed_tiles``)."""
    kt = k.transpose(0, 1)
    return pack_wgmma(kt.flip(2, 3) if mirror else kt)


def transposed_tiles(k: torch.Tensor) -> torch.Tensor:
    """The mirrored transpose of a forward OIHW kernel ``(cout, cin, 3, 3)``
    cut into the N tiles of ``wgmma_tiles(cin)``, each packed by
    ``pack_wgmma`` at the tile's width, one after another as K7b's packer
    lays out conv^T: ``(tiles, ceil(cout / 16), 9, 2, n, 8)``."""
    kt = k.transpose(0, 1).flip(2, 3)
    tiles, n = wgmma_tiles(kt.shape[0])
    return torch.stack([pack_wgmma(kt[j * n : (j + 1) * n], n) for j in range(tiles)])


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
# persistent cooperative grid of at most WARP_BWD_MAX_BLOCKS blocks, one
# channel a lane at a time, df1 summed in 64-bit fixed point
WARP_BWD_THREADS = 256
WARP_BWD_MAX_BLOCKS = 4096
# every element's fixed-point sum stays below 2**WARP_BWD_SUM_BITS in magnitude
WARP_BWD_SUM_BITS = 62
# an element's class where a term is not finite (0: all finite), two bits each, 16 elements a 32-bit word
WARP_BWD_POS_INF, WARP_BWD_NEG_INF, WARP_BWD_NAN = 1, 2, 3


def warp_bwd_lanes(c: int) -> int:
    """Lanes that serve one pixel in the warp backward (K5, K9b): ``C``
    rounded up to a power of two, at most a warp; lane ``l`` takes the
    channels ``l, l + lanes, ...``, so that one 64-bit reduction
    instruction of the lanes of a pixel covers consecutive accumulators."""
    lanes = 1
    while lanes < min(c, 32):
        lanes *= 2
    return lanes


def warp_bwd_blocks(pixels: int, lanes: int, n_acc: int, resident: int) -> int:
    """Blocks of the warp backward's persistent grid: enough for one pass of
    the scatter (``lanes`` threads a pixel) or of the conversion (4 of the
    ``n_acc`` accumulators a thread), at most the ``resident`` blocks the
    card holds at once (SMs x blocks an SM) and ``WARP_BWD_MAX_BLOCKS``."""
    t = WARP_BWD_THREADS
    need = max(-(-pixels * lanes // t), -(-(n_acc // 4) // t))
    return max(1, min(resident, WARP_BWD_MAX_BLOCKS, need))


def warp_bwd_scratch(n_acc: int, b: int) -> int:
    """int64 elements of the warp backward's scratch for ``n_acc`` values of
    df1 in ``b`` images: the fixed-point accumulators, the non-finite
    classes (2 bits an element), phase 0's largest |g| (a 32-bit word a
    block and image, at most ``WARP_BWD_MAX_BLOCKS + b``) and each image's
    scale (a 32-bit word)."""
    return n_acc + -(-n_acc // 32) + WARP_BWD_MAX_BLOCKS // 2 + b


def warp_bwd_scale(max_abs_g: float, ho: int, w: int) -> int:
    """The exponent ``s`` of an image's fixed point in the warp backward:
    each term ``w * g`` of its df1 becomes the integer ``rint(w * g *
    2**s)``. With ``max_abs_g = m * 2**e`` (``math.frexp``, m in [0.5, 1))
    and ``4 Ho W <= 2**k``, ``s = 62 - k - e``, so that ``4 Ho W max|g|
    2**s < 2**62``: the sum stays inside an int64 even where every pixel of
    the image puts all four corners on one element. ``max_abs_g`` is the
    image's largest finite |g| over the rows that scatter (0 gives ``e =
    0``; every term is 0)."""
    k = (4 * ho * w - 1).bit_length()
    return WARP_BWD_SUM_BITS - k - math.frexp(max_abs_g)[1]


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
