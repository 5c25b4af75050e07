"""Middlebury .flo flow-file I/O (reference flow_utils.py:13-29).

Binary layout: float32 magic 202021.25, int32 width, int32 height, then
h*w*2 float32 (x-displacement first) in row-major order, little-endian.
"""

from __future__ import annotations

import os

import numpy as np

FLO_MAGIC = 202021.25

__all__ = ["load_flow", "save_flow", "FLO_MAGIC"]


def load_flow(path: str | os.PathLike) -> np.ndarray | None:
    """Read a .flo file -> (H, W, 2) float32, or None on bad magic."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or float(magic[0]) != FLO_MAGIC:
            return None
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=h * w * 2)
        if data.size != h * w * 2:
            raise ValueError(
                f"{path}: truncated .flo (expected {h * w * 2} floats, "
                f"got {data.size})"
            )
        return data.reshape(h, w, 2)


def save_flow(path: str | os.PathLike, flow: np.ndarray) -> None:
    """Write an (H, W, 2) array as a .flo file."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.tofile(f)
