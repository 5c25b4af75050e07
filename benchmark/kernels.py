"""Frozen arithmetic of the port's hand-written kernels (K1-K6).

Copied from ``chip_smoke.py`` as it stood when the benchmark was written,
so that no change to the program can move the yardstick:

- ``k1_work`` ... ``k6_work``: the bytes and operations of one kernel call,
  computed from its shapes (each input byte read once, each output byte
  written once); K5's is the function's traffic, without the int64 scratch
  its fixed-point design adds;
- ``bound``: the least time of a call, ``max(bytes / 3.35 TB/s, operations
  / peak)`` against NVIDIA's published H100 SXM peaks;
- ``PROFILE_GROUPS`` and ``kernel_label``: the device kernels by name
  (cuDNN's FFT and ``convolve_common_engine`` kernels, which the step's
  deterministic convs run, added to its groups).

``calls`` lists the calls one forward or one train step makes of each
kernel at a cell's shapes, for the configurations the benchmark runs.
"""

from __future__ import annotations

import re

__all__ = [
    "HBM_BYTES_PER_S", "PEAK_OPS", "PROFILE_GROUPS", "HAND_GROUPS", "CUDNN_GROUPS", "bound", "calls",
    "group_of", "kernel_label",
]

SEARCH_RANGE = 4
TAPS = (2 * SEARCH_RANGE + 1) ** 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores (TF32 off)
BYTES = {"bfloat16": 2, "float32": 4}
PYRAMID_FILTERS = (16, 32, 64, 96, 128, 192)


def bound(dtype_name: str, n_bytes: float, n_ops: float) -> float:
    """Seconds: the larger of the bytes' and the operations' time at peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype_name])


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


def calls(config: dict, train: bool, b: int, h: int, w: int, dtype_name: str, pyramid_levels: int = 0) -> dict:
    """Kernel id -> [bound seconds of each call] of one forward (or, with
    ``train``, one train step) of ``config`` on (b, h, w) frames.

    PWCDCNet: K3 on both frames' ``pyramid_levels`` finest pyramid levels
    (the count the built model runs through K3), K2 at the deepest estimator level, K1 at the warped levels; a
    step adds K4 behind each K1 and K2, K5 behind each K1 and K6 behind
    each K3 (the images need no gradient). PWCNet: K2 at every level (K4
    behind each in a step)."""
    s, n = BYTES[dtype_name], config["num_levels"]

    def level(l):  # estimator level l (0 deepest): (h, w, channels)
        k = n - l
        return h >> k, w >> k, PYRAMID_FILTERS[k - 1]

    out = {}

    def add(kid, work):
        out.setdefault(kid, []).append(bound(dtype_name, *work))

    levels = range(config["output_level"] + 1)
    if config["model"] == "PWCNet":
        for l in levels:
            add("K2", k2_work(b, *level(l), s))
            if train:
                add("K4", k4_work(b, *level(l), s))
        return out
    add("K2", k2_work(b, *level(0), s))
    if train:
        add("K4", k4_work(b, *level(0), s))
    for l in levels[1:]:
        add("K1", k1_work(b, *level(l), s))
        if train:
            add("K4", k4_work(b, *level(l), s))
            add("K5", k5_work(b, *level(l), s))
    cin, hh, ww = 3, h, w
    for i in range(pyramid_levels):
        c = PYRAMID_FILTERS[i]
        for _frame in range(2):
            add("K3", k3_work(b, hh, ww, cin, c, s))
            if train:
                add("K6", k6_work(b, hh, ww, cin, c, s, need_dx=i > 0))
        cin, hh, ww = c, hh // 2, ww // 2
    return out


# device kernels by name: the port's own, the library's convolutions, PyTorch's elementwise tail
PROFILE_GROUPS = (
    ("K1 warped_cost_volume", ("WarpLoader",)),
    ("K2 cost_volume", ("PlainLoader",)),
    ("K3 pyramid_level", ("pyramid_level",)),
    ("K4 cost_volume_bwd", ("cv_bwd_kernel",)),
    ("K5 warp_bwd", ("warp_bwd_coop_kernel",)),
    ("K6 pyramid_level_bwd", ("conv_t_col", "conv1_t_col", "conv_t_s2", "conv_t_wg", "conv1_t_wg")),
    ("K7 estimator chain, forward and backward", ("conv3x3_",)),
    ("K3, K6 and K7 weight packing (bf16)", ("pack_weights",)),
    ("cuDNN wgrad", ("wgrad",)),
    ("cuDNN dgrad", ("dgrad",)),
    ("cuDNN forward convs and layout kernels", ("xmma", "cutlass", "cudnn", "implicit_gemm", "nhwc", "nchw",
                                                "convolve_common_engine")),
    ("cuDNN FFT convs", ("fft", "pointwise_mult_and_sum_complex", "flip_filter")),
    ("reductions (bias gradients, sums)", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("host <-> device copies", ("Memcpy",)),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("foreach (Adam, decay)", ("multi_tensor",)),
    ("elementwise (bias add, LeakyReLU, resize, loss)", ("elementwise",)),
)
HAND_GROUPS = tuple(g for g, _ in PROFILE_GROUPS[:8])
CUDNN_GROUPS = tuple(g for g, _ in PROFILE_GROUPS[8:12])


def group_of(name: str) -> str:
    """The group of a device operation's name; one of no group is named
    ``other: <its short name>``."""
    group = next((g for g, pats in PROFILE_GROUPS if any(p in name for p in pats)), None)
    return group or f"other: {short_name(name)}"


def short_name(name: str) -> str:
    """A kernel's name without its arguments: the label of a mangled name,
    the last component before the template arguments of a demangled one."""
    if name.startswith("_Z"):
        return kernel_label(name)
    head = name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return (head.rsplit("::", 1)[-1] or head).strip()[:60]


def kernel_label(mangled: str) -> str:
    """A readable label for a mangled kernel name: the last name of its
    nested name, then its integer template arguments, its element type and
    its Loader (``correlation_kernel<bf16,4,32,HpadLoader>``); boolean
    arguments read true or false (``conv_t_col_kernel<32,true>``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[pos:])) is not None:
        n = int(m.group())
        name = mangled[pos + len(m.group()):pos + len(m.group()) + n]
        pos += len(m.group()) + n
    rest = mangled[pos:]
    args = (["bf16"] if rest.startswith("I13__nv_bfloat16") else ["f32"] if rest.startswith("If") else [])
    args += [v if t == "i" else ("true" if v == "1" else "false") for t, v in re.findall(r"L([ib])(\d+)E", rest)]
    args += re.findall(r"\d+([A-Z][A-Za-z]*Loader)", rest)
    return f"{name}<{','.join(args)}>" if args else name
