"""What every cell of the benchmark shares: the cell's files found by name,
the card check, the weights and inputs drawn from the seed, the sample of
answers kept for the check, the comparison with the plain reference, and
the result line.

A cell ``<config>.<traffic>`` is read from ``BENCHMARK.json``:
``configs/<config>.json`` holds the configuration's sizes,
``traffic/<traffic>.json`` the traffic's parameters, the loop that runs
them (``loops/<loop>.py``) and the end-to-end metric its rate is reported
as (``rate_metric``), ``workloads/<cell>.json`` the limits
of the numbers its check compares, and ``metrics/<metric>.py`` reads each
per-layer metric (the part of its name before the first dot).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "BENCH", "REPO", "FORBIDDEN", "Ctx", "Outcome", "load_cell", "load_module", "forbidden_modules",
    "draw_weights", "texture", "stream_frames", "train_pool", "Reservoir", "flow_gaps", "train_gaps", "window_gaps",
    "judge", "sync", "peak_bytes", "reset_peak", "DTYPES", "CONTROL", "ROUNDED",
]

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pwcnet_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the control of a cell's precision: the reference one precision below it
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
# the rounding of a cell's own precision, against which a bf16 cell's gaps are read (float32 rounds nothing)
ROUNDED = {"bfloat16": "bf16"}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec: Optional[dict] = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``) with its
    files: ``{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"}``, the last two the metric entries this cell reports."""
    spec = spec if spec is not None else _json(REPO / "BENCHMARK.json")
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {
        "workload": work,
        "config": _json(REPO / conf["file"]),
        "traffic": _json(BENCH / "traffic" / f"{work['traffic']}.json"),
        "limits": _json(BENCH / "workloads" / f"{name}.json")["limits"],
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Ctx:
    """One run: the cell, the seed, the window and where it runs.
    ``readings`` (calibration only) names the extra readings to take on the
    same answers: ``control`` (the reference one precision below the cell's
    in the program's place), ``half`` (the reference with half of each
    batch left out) and ``jitter`` (the reference with its weights moved by
    1e-7 of themselves: how far rounding alone moves each number)."""

    name: str
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    readings: tuple = ()
    marks: list = dataclasses.field(default_factory=list)

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    def mark(self, label: str) -> None:
        """Note the seconds since the start at the end of a set-up phase."""
        self.marks.append((label, time.perf_counter() - self.t_start))

    def gen(self, stream: int) -> torch.Generator:
        """An independent generator on the device for each input stream."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) % 2**63)
        return g


@dataclasses.dataclass
class Outcome:
    metrics: dict  # name -> value
    attempted: int
    failed: int
    numbers: dict  # compared number -> value
    memory_peak_bytes: int = 0
    device_trace: Optional[dict] = None  # the traced stretch, as tracing.traced reads it
    readings: dict = dataclasses.field(default_factory=dict)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


# ----------------------------------------------------------------- inputs
def draw_weights(model: torch.nn.Module, gen: torch.Generator, device, dtype=torch.float32) -> dict:
    """Variance-scaled weights for every parameter of ``model`` (the
    reference's, whose names the port shares), drawn on the device in one
    call: kernels normal with variance 2 / fan-in (He's, which keeps the
    LeakyReLU activations near 1 through the depth), biases normal with
    standard deviation 0.1. Rounded to ``dtype``, the type they are served in."""
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    out, off = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        std = math.sqrt(2.0 / math.prod(shape[1:])) if k.endswith("weight") else 0.1
        out[k] = (flat[off:off + n].view(shape) * std).to(dtype)
        off += n
    return out


def texture(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """``n`` smooth colour textures (n, 3, h, w) in [0, 1]: noise at three
    scales, each upscaled bilinearly and summed."""
    img = torch.zeros((n, 3, h, w), device=device)
    for cell, amp in ((64, 0.45), (16, 0.35), (4, 0.2)):
        noise = torch.rand((n, 3, h // cell + 2, w // cell + 2), generator=gen, device=device)
        img += amp * F.interpolate(noise, size=(h, w), mode="bilinear", align_corners=True)
    return img


def stream_frames(gen: torch.Generator, n: int, h: int, w: int, drift, device) -> torch.Tensor:
    """``n`` uint8 frames (n, h, w, 3) of one texture drifting ``drift``
    = (dx, dy) pixels a frame."""
    dx, dy = drift
    tex = texture(gen, 1, h + (n - 1) * dy, w + (n - 1) * dx, device)[0]
    frames = torch.stack([tex[:, k * dy:k * dy + h, k * dx:k * dx + w] for k in range(n)])
    return (frames * 255.0).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def train_pool(gen: torch.Generator, batches: int, b: int, h: int, w: int, max_flow: float, device) -> list:
    """``batches`` training batches ``(images (b, 2, h, w, 3), flows (b, h,
    w, 2))``, every row its own texture and smooth flow: frame 0 is frame 1
    sampled at ``p + flow(p)``. Row i's flow reaches ``max_flow * (i + 1) /
    b`` pixels, so a batch holds small and large motions alike, as a
    training set does, and no part of a batch stands for the whole."""
    n = batches * b
    frame1 = texture(gen, n, h, w, device)
    coarse = torch.rand((n, 2, h // 64 + 2, w // 64 + 2), generator=gen, device=device) * 2 - 1
    reach = max_flow * (torch.arange(n, device=device) % b + 1).float() / b
    flow = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True) * reach[:, None, None, None]
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    grid = torch.stack([(xs + flow[:, 0]) * (2.0 / (w - 1)) - 1, (ys + flow[:, 1]) * (2.0 / (h - 1)) - 1], -1)
    frame0 = F.grid_sample(frame1, grid, mode="bilinear", padding_mode="border", align_corners=True)
    images = torch.stack([frame0, frame1], 1).permute(0, 1, 3, 4, 2)
    flows = flow.permute(0, 2, 3, 1)
    return [(images[i * b:(i + 1) * b].contiguous(), flows[i * b:(i + 1) * b].contiguous()) for i in range(batches)]


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from the seed
    (reservoir sampling): ``offer`` returns the slot the answer takes, or None."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen = k, 0
        self.keys: list = []
        self.rng = np.random.default_rng(seed)

    def offer(self, key) -> Optional[int]:
        self.seen += 1
        if len(self.keys) < self.k:
            self.keys.append(key)
            return len(self.keys) - 1
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.keys[j] = key
            return j
        return None


# ------------------------------------------------------------ comparisons
def _pair_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    got, want = got.double(), want.double()
    return (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)


def flow_gaps(got: torch.Tensor, want: torch.Tensor, rounded: Optional[torch.Tensor] = None) -> dict:
    """The serving cells' numbers over (B, H, W, 2) flows: ``flow_gap``, the
    worst pair's ``||got - want|| / ||want||``, and with ``rounded`` (the
    reference with its convs' operands rounded to a bf16 cell's own
    precision) ``flow_gap_ratio``, the worst pair's gap over that gap: how
    many times the rounding of the stated precision the answer is off, on
    this seed's weights, whose sensitivity to rounding varies from seed to
    seed."""
    gap = _pair_gaps(got, want)
    out = {"flow_gap": float(gap.max())}
    if rounded is not None:
        out["flow_gap_ratio"] = float((gap / _pair_gaps(rounded, want)).max())
    return out


def _norm_gaps(got: dict, want: dict, names) -> dict:
    """Each leaf's gap of norms, ``| ||got|| - ||want|| |``."""
    return {k: abs(float(got[k].double().norm()) - float(want[k].double().norm())) for k in names}


def _leaf_numbers(name: str, got: dict, want: dict, names, rounded=None) -> dict:
    """A train cell's numbers of one set of leaves: each leaf's gap of norms
    against the larger of that leaf's reference norm and the median leaf's,
    by the worst and the median leaf; with ``rounded`` (the reference with
    its convs' operands rounded to the cell's own precision) also the median
    leaf's gap over that leaf's gap of ``rounded``, which the seed's own
    sensitivity to rounding divides out."""
    norms = {k: float(want[k].double().norm()) for k in names}
    med = statistics.median(norms.values())
    gaps = _norm_gaps(got, want, names)
    rel = [gaps[k] / max(norms[k], med) for k in names]
    out = {f"{name}_gap": max(rel), f"{name}_gap_median": statistics.median(rel)}
    if rounded is not None:
        base = _norm_gaps(rounded, want, names)
        out[f"{name}_ratio_median"] = statistics.median(gaps[k] / max(base[k], 1e-30) for k in names)
    return out


def train_gaps(got: dict, want: dict, rounded: Optional[dict] = None) -> dict:
    """The train cells' numbers, from ``{"losses", "grad1", "change"}`` of
    the program (or a stand-in), the reference and, for a bfloat16 cell,
    the reference rounded to bfloat16: the first step's multiscale-loss gap
    and the worst of the first three steps'; the first gradient's leaves;
    the parameters' change over three steps, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in want["grad1"].items()}
    med = statistics.median(norms.values())
    moved = [k for k, v in norms.items() if v >= 1e-3 * med]
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    return {
        "loss1_gap": loss[0], "loss_gap": max(loss),
        **_leaf_numbers("grad", got["grad1"], want["grad1"], list(norms), rounded and rounded["grad1"]),
        **_leaf_numbers("change", got["change"], want["change"], moved, rounded and rounded["change"]),
    }


def window_gaps(got: dict, want: dict, rounded: Optional[dict] = None) -> dict:
    """The train cells' numbers of the window's last steps, from
    ``{"losses", "change"}`` of the program (or a stand-in) and
    ``{"losses", "grad1", "change"}`` of the reference followed from the
    same state (and, for a bfloat16 cell, of the reference rounded to
    bfloat16): the worst step's multiscale-loss gap and the parameters'
    change over the steps, leaving out leaves whose reference gradient is
    under a thousandth of the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in want["grad1"].items()}
    med = statistics.median(norms.values())
    moved = [k for k, v in norms.items() if v >= 1e-3 * med]
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    return {"window_loss_gap": max(loss),
            **_leaf_numbers("window_change", got["change"], want["change"], moved, rounded and rounded["change"])}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every limited number finite and within its limit."""
    checks = {k: (numbers.get(k, float("nan")), lim) for k, lim in limits.items()}
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values()), checks
