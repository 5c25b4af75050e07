"""Pre-decoded raw dataset cache: one-time transcode, memcpy-rate loading.

Counterpart of ``pwcnet_tpu/data/cache.py`` (same files on disk, so a cache
built by either package opens in the other). PNG inflate bounds the decode
paths per core, and decoding the same PNGs every epoch is wasted work: a
flow dataset is read-only and fits on disk raw (Sintel clean training:
~1.4 GB of frames + ~3.7 GB of flows). This module transcodes a dataset
ONCE into packed raw shards and serves batches from them as pure memory
traffic — crop + flip + u8->f32 normalize, no decompression.

On-disk layout (``<dataset_dir>/.pwcnet_cache/<ClassName>_<split>/``):

- ``frames.u8``  — (n_frames, H, W, 3) uint8, C-order, np.memmap-able;
  each unique image file appears exactly once (consecutive Sintel pairs
  share frames).
- ``flows.f32``  — (n_flows, H, W, 2) float32, one record per sample.
- ``index.json`` — written LAST (its presence marks a complete cache):
  version, frame shape, per-sample (img0, img1, flow) record indices, and
  the sample triple paths (relative to the dataset dir) the cache was
  built from. A loader validates its dataset's current sample list against
  these paths and refuses a stale cache.

Batch assembly goes through the native ``pwc_assemble_cached`` (threaded
C++ crop/flip/normalize straight out of the memmaps — semantics identical
to the decode path's ``LoadSample``) with a NumPy fallback used for
verification and toolchain-less hosts.

The reference has no analogue (its torch DataLoader re-decodes every
epoch, train.py:36-41); this is the "keep the accelerator fed" role of
that loader. Eligibility mirrors the native decode path:
no resize/origin_size augmentation (those change pixels, not just
geometry), uniform frame size.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

__all__ = ["CACHE_VERSION", "default_cache_dir", "build_cache", "open_cache",
           "RawCache"]

CACHE_VERSION = 1


def _relative_samples(dataset) -> list:
    """Sample path triples relative to the dataset dir (stable identity
    across hosts/mount points)."""
    root = Path(dataset.dataset_dir).resolve()

    def rel(p):
        p = Path(p).resolve()
        try:
            return str(p.relative_to(root))
        except ValueError:
            return str(p)

    return [[rel(a), rel(b), rel(c)] for a, b, c in dataset.samples]


def default_cache_dir(dataset) -> Path:
    """Default cache location for a dataset instance."""
    return (
        Path(dataset.dataset_dir)
        / ".pwcnet_cache"
        / f"{type(dataset).__name__}_{dataset.train_or_val}"
    )


def _eligible(dataset) -> bool:
    """A cache stores raw frames: pixel-changing augmentation (resize /
    origin_size) must be off, and samples must be path triples."""
    samples = getattr(dataset, "samples", None)
    return bool(
        samples
        and isinstance(samples[0], (tuple, list))
        and len(samples[0]) == 3
        and getattr(dataset, "origin_size", None) is None
        and getattr(dataset, "resize_shape", None) is None
        and getattr(dataset, "resize_scale", None) is None
    )


def build_cache(
    dataset,
    cache_dir: str | os.PathLike | None = None,
    progress: bool = False,
) -> Path:
    """One-time transcode of ``dataset`` into a raw cache directory.

    Decodes every unique frame once (PIL — PNG/PPM are lossless, so the
    cached bytes are exactly what the decode path would produce) and
    copies every .flo record; returns the cache dir. Idempotent: an
    existing valid cache for the same sample list is kept.
    """
    from pwcnet_tpu_torch.data.datasets import _read_image
    from pwcnet_tpu_torch.utils.flo_io import load_flow

    if not _eligible(dataset):
        raise ValueError(
            "dataset not cacheable: needs (img0, img1, flo) path samples "
            "and no resize/origin_size augmentation"
        )
    cache_dir = Path(cache_dir) if cache_dir else default_cache_dir(dataset)
    rel = _relative_samples(dataset)
    existing = open_cache(dataset, cache_dir)
    if existing is not None:
        return cache_dir
    cache_dir.mkdir(parents=True, exist_ok=True)

    # unique frames (consecutive Sintel pairs share their middle frame)
    frame_paths: list = []
    frame_idx: dict = {}
    for p0, p1, _ in dataset.samples:
        for p in (str(p0), str(p1)):
            if p not in frame_idx:
                frame_idx[p] = len(frame_paths)
                frame_paths.append(p)

    h, w = dataset._native_size()
    n_frames, n_flows = len(frame_paths), len(dataset.samples)

    frames_path = cache_dir / "frames.u8"
    flows_path = cache_dir / "flows.f32"
    frames = np.memmap(
        frames_path, np.uint8, mode="w+", shape=(n_frames, h, w, 3)
    )
    flows = np.memmap(
        flows_path, np.float32, mode="w+", shape=(n_flows, h, w, 2)
    )
    for i, p in enumerate(frame_paths):
        img = _read_image(p)
        if img.shape[:2] != (h, w):
            raise ValueError(
                f"frame size mismatch: {p} is {img.shape[:2]}, "
                f"dataset native size is {(h, w)}"
            )
        frames[i] = img
        if progress and (i + 1) % 50 == 0:
            print(f"  frames {i + 1}/{n_frames}", flush=True)
    samples_rec = []
    for i, (p0, p1, pf) in enumerate(dataset.samples):
        fl = load_flow(pf)
        if fl is None or fl.shape[:2] != (h, w):
            raise ValueError(f"bad or mismatched .flo: {pf}")
        flows[i] = fl
        samples_rec.append([frame_idx[str(p0)], frame_idx[str(p1)], i])
        if progress and (i + 1) % 50 == 0:
            print(f"  flows {i + 1}/{n_flows}", flush=True)
    frames.flush()
    flows.flush()

    index = {
        "version": CACHE_VERSION,
        "frame_hw": [int(h), int(w)],
        "n_frames": n_frames,
        "n_flows": n_flows,
        "records": samples_rec,
        "sample_paths": rel,
    }
    # index.json written last = completeness marker (a transcode killed
    # mid-write leaves no index and the cache reads as absent)
    tmp = cache_dir / "index.json.tmp"
    tmp.write_text(json.dumps(index))
    tmp.replace(cache_dir / "index.json")
    return cache_dir


class RawCache:
    """Memmap-backed view of a built cache with batch assembly."""

    def __init__(self, cache_dir: Path, index: dict):
        self.cache_dir = Path(cache_dir)
        h, w = index["frame_hw"]
        self.frame_hw = (h, w)
        self.records = np.asarray(index["records"], np.int32)
        self.frames = np.memmap(
            self.cache_dir / "frames.u8",
            np.uint8,
            mode="r",
            shape=(index["n_frames"], h, w, 3),
        )
        self.flows = np.memmap(
            self.cache_dir / "flows.f32",
            np.float32,
            mode="r",
            shape=(index["n_flows"], h, w, 2),
        )
        self._native = None
        try:
            from pwcnet_tpu_torch.data import native

            native.load_library()
            self._native = native
        except Exception:
            self._native = None  # NumPy fallback below

    def assemble(
        self,
        sample_indices,
        crop_hw,
        y0s,
        x0s,
        flips,
        num_threads: int = 4,
        image_dtype=np.float32,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(images (B,2,ch,cw,3), flows (B,ch,cw,2) f32) — crop/flip/
        normalize semantics identical to the decode paths.
        ``image_dtype=np.uint8`` skips the host-side /255 (the
        device-normalize pipeline: 4x fewer host + PCIe image bytes; the
        consumer divides by 255 on-device — see pipeline.device_prefetch).
        """
        rec = self.records[np.asarray(sample_indices, np.int64)]
        if self._native is not None:
            return self._native.assemble_cached(
                self.frames,
                self.flows,
                rec[:, 0],
                rec[:, 1],
                rec[:, 2],
                tuple(crop_hw),
                y0s,
                x0s,
                flips,
                num_threads=num_threads,
                image_dtype=image_dtype,
            )
        return self._assemble_numpy(
            rec, crop_hw, y0s, x0s, flips, image_dtype
        )

    def _assemble_numpy(
        self, rec, crop_hw, y0s, x0s, flips, image_dtype=np.float32
    ):
        ch, cw = crop_hw
        b = len(rec)
        image_dtype = np.dtype(image_dtype)
        images = np.empty((b, 2, ch, cw, 3), image_dtype)
        flows = np.empty((b, ch, cw, 2), np.float32)
        for i in range(b):
            y0, x0 = int(y0s[i]), int(x0s[i])
            hflip, vflip = bool(flips[i] & 1), bool(flips[i] & 2)
            for fi in (0, 1):
                crop = self.frames[rec[i, fi], y0 : y0 + ch, x0 : x0 + cw]
                if hflip:
                    crop = crop[:, ::-1]
                if vflip:
                    crop = crop[::-1]
                images[i, fi] = (
                    crop
                    if image_dtype == np.uint8
                    else crop.astype(np.float32) / 255.0
                )
            fl = self.flows[rec[i, 2], y0 : y0 + ch, x0 : x0 + cw]
            sign = np.ones(2, np.float32)
            if hflip:
                fl = fl[:, ::-1]
                sign[0] = -1.0
            if vflip:
                fl = fl[::-1]
                sign[1] = -1.0
            flows[i] = fl * sign
        return images, flows


def open_cache(
    dataset, cache_dir: str | os.PathLike | None = None
) -> RawCache | None:
    """Open a cache for ``dataset`` if one exists AND matches its current
    sample list; returns None otherwise (callers fall back to decoding)."""
    if not _eligible(dataset):
        return None
    cache_dir = Path(cache_dir) if cache_dir else default_cache_dir(dataset)
    index_path = cache_dir / "index.json"
    if not index_path.is_file():
        return None
    try:
        index = json.loads(index_path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if index.get("version") != CACHE_VERSION:
        return None
    if index.get("sample_paths") != _relative_samples(dataset):
        return None  # dataset content changed since the transcode
    h, w = index["frame_hw"]
    if (h, w) != tuple(dataset._native_size()):
        return None
    frames_path = cache_dir / "frames.u8"
    flows_path = cache_dir / "flows.f32"
    if (
        not frames_path.is_file()
        or not flows_path.is_file()
        or frames_path.stat().st_size != index["n_frames"] * h * w * 3
        or flows_path.stat().st_size != index["n_flows"] * h * w * 2 * 4
    ):
        return None
    return RawCache(cache_dir, index)
