"""Middlebury-style optical-flow color coding and pyramid visualization.

Re-implements the reference's flow_utils.py:32-197 semantics, vectorized:

- 55-entry color wheel (RY=15, YG=6, GC=4, CB=11, BM=13, MR=6);
- hue from atan2(-v, -u), saturation ramps with normalized radius, colors
  0.75-dimmed outside the unit radius;
- `vis_flow` normalizes by the max flow magnitude (zeroing "unknown" flow
  components > 1e9) and returns an RGB uint8 image;
- `vis_flow_pyramid` renders [frame0 | per-level flows | gt | frame1] to an
  image file via matplotlib (Agg).
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["make_colorwheel", "flow_to_color", "vis_flow", "vis_flow_pyramid"]

UNKNOWN_FLOW_THRESH = 1e9


def make_colorwheel() -> np.ndarray:
    """(55, 3) RGB color wheel."""
    transitions = [
        ("R", "Y", 15),
        ("Y", "G", 6),
        ("G", "C", 4),
        ("C", "B", 11),
        ("B", "M", 13),
        ("M", "R", 6),
    ]
    anchors = {
        "R": (255, 0, 0),
        "Y": (255, 255, 0),
        "G": (0, 255, 0),
        "C": (0, 255, 255),
        "B": (0, 0, 255),
        "M": (255, 0, 255),
    }
    rows = []
    for src, dst, n in transitions:
        a = np.array(anchors[src], np.float64)
        b = np.array(anchors[dst], np.float64)
        ramp = np.floor(255 * np.arange(n, dtype=np.float64) / n)
        seg = np.tile(a, (n, 1))
        for c in range(3):
            if b[c] > a[c]:  # ramp up: floor(255*i/n)
                seg[:, c] = ramp
            elif b[c] < a[c]:  # ramp down: 255 - floor(255*i/n)
                seg[:, c] = 255 - ramp
        rows.append(seg)
    return np.concatenate(rows, axis=0)


def flow_to_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Color-code *normalized* flow components -> RGB uint8 (H, W, 3)."""
    u = np.where(np.isnan(u) | np.isnan(v), 0.0, u)
    v = np.where(np.isnan(v) | np.isnan(u), 0.0, v)

    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    radius = np.sqrt(u**2 + v**2)
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = fk.astype(np.int32)
    k1 = (k0 + 1) % ncols
    frac = fk - k0

    img = np.empty((*u.shape, 3), np.uint8)
    in_range = radius <= 1
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - frac) * col0 + frac * col1
        col = np.where(in_range, 1 - radius * (1 - col), col * 0.75)
        img[..., c] = np.floor(255 * col).astype(np.uint8)
    return img


def vis_flow(flow: np.ndarray) -> np.ndarray:
    """Normalize a pixel-unit flow field and color-code it (RGB uint8)."""
    eps = sys.float_info.epsilon
    u = np.array(flow[..., 0], np.float64, copy=True)
    v = np.array(flow[..., 1], np.float64, copy=True)
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0.0
    v[unknown] = 0.0
    maxrad = max(np.sqrt(u**2 + v**2).max(), 0.0)
    return flow_to_color(u / (maxrad + eps), v / (maxrad + eps))


def vis_flow_pyramid(
    flow_pyramid,
    flow_gt: np.ndarray | None = None,
    images: np.ndarray | None = None,
    filename: str = "./flow.png",
) -> None:
    """Render [frame0 | level flows | gt | frame1] side by side to a file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    num_contents = (
        len(flow_pyramid)
        + int(flow_gt is not None)
        + int(images is not None) * 2
    )
    fig, axes = plt.subplots(
        1, num_contents, figsize=(4 * num_contents, 4), squeeze=False
    )
    axes = axes[0]
    col = 0

    def _show(ax, img):
        ax.imshow(np.clip(img, 0, None))
        ax.set_axis_off()

    if images is not None:
        _show(axes[0], images[0])
        col = 1
    for flow in flow_pyramid:
        _show(axes[col], vis_flow(np.asarray(flow)))
        col += 1
    if flow_gt is not None:
        _show(axes[col], vis_flow(np.asarray(flow_gt)))
        col += 1
    if images is not None:
        _show(axes[-1], images[1])

    fig.tight_layout()
    fig.savefig(filename, bbox_inches="tight", pad_inches=0.1)
    plt.close(fig)
