"""Flow datasets: Sintel (clean/final), FlyingChairs, and synthetic.

Re-creates the contract of the reference's absent `datahandler` submodule,
inferred from its call sites (the reference's train.py:27-41,121-123), as
``pwcnet_tpu/data/datasets.py`` does, with the same constructor arguments
and the same draws from the same numpy generators:

- ``get_dataset(name)`` returns a dataset class;
- constructor kwargs: ``train_or_val`` in {'train','val'}, ``dataset_dir``,
  ``origin_size``, ``crop_type`` ('random'|'center'|'none'),
  ``crop_shape``, ``resize_shape``, ``resize_scale``;
- instance attrs ``image_size`` (post-pipeline H, W) and ``samples``;
- ``__getitem__`` -> ``(images, flow)`` with images (2, H, W, 3) uint8 and
  flow (H, W, 2) float32 in pixels.

Augmentation: optional raw-size normalization (``origin_size``), optional
resize (by shape or scale; flow magnitudes are rescaled accordingly),
crop, optional random horizontal/vertical flip (flow components negated
on the flipped axis).

On-disk layouts:
- Sintel:   <dir>/training/{clean|final}/<scene>/frame_XXXX.png and
            <dir>/training/flow/<scene>/frame_XXXX.flo (pairs t -> t+1).
- FlyingChairs: <dir>[/data]/XXXXX_img1.ppm, XXXXX_img2.ppm,
            XXXXX_flow.flo; the official FlyingChairs_train_val.txt split
            file is honored when present (1=train, 2=val), else a
            deterministic 1-in-10 split.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from pwcnet_tpu_torch.utils.flo_io import load_flow

__all__ = [
    "get_dataset",
    "FlowDataset",
    "SintelClean",
    "SintelFinal",
    "FlyingChairs",
    "SyntheticFlow",
]

VAL_STRIDE = 10  # deterministic fallback split: every 10th sample -> val


def _read_image(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _resize_pair(images: np.ndarray, flow: np.ndarray, out_hw):
    """Resize both frames and the flow field; rescale flow magnitudes."""
    from PIL import Image

    in_h, in_w = images.shape[1:3]
    out_h, out_w = out_hw
    frames = []
    for i in range(2):
        frames.append(
            np.asarray(
                Image.fromarray(images[i]).resize(
                    (out_w, out_h), Image.BILINEAR
                ),
                dtype=np.uint8,
            )
        )
    fx = flow[..., 0] * (out_w / in_w)
    fy = flow[..., 1] * (out_h / in_h)
    f = np.stack(
        [
            np.asarray(
                Image.fromarray(c).resize((out_w, out_h), Image.BILINEAR)
            )
            for c in (fx, fy)
        ],
        axis=-1,
    ).astype(np.float32)
    return np.stack(frames), f


class FlowDataset:
    """Base class: pairs of frames + ground-truth flow with augmentation."""

    def __init__(
        self,
        train_or_val: str = "train",
        dataset_dir: str = ".",
        origin_size=None,
        crop_type: str = "random",
        crop_shape=(384, 448),
        resize_shape=None,
        resize_scale=None,
        random_flip: bool = False,
        seed: int = 0,
    ):
        assert train_or_val in ("train", "val"), train_or_val
        self.train_or_val = train_or_val
        self.dataset_dir = Path(dataset_dir)
        # origin_size: normalize raw frames to (H, W) before any other
        # augmentation (resize/crop/flip); flow magnitudes are rescaled
        # with the frames. The reference always passes None
        # (train.py:29) — the kwarg's semantics live in the absent
        # datahandler submodule, re-created here as raw-size
        # normalization (the only reading that makes `origin_` coherent
        # alongside the separate resize_shape/resize_scale kwargs).
        self.origin_size = (
            tuple(origin_size) if origin_size is not None else None
        )
        self.crop_type = crop_type
        self.crop_shape = tuple(crop_shape) if crop_shape is not None else None
        self.resize_shape = (
            tuple(resize_shape) if resize_shape is not None else None
        )
        self.resize_scale = resize_scale
        self.random_flip = random_flip and train_or_val == "train"
        self._rng = np.random.default_rng(seed)
        # samples: list of (img0_path, img1_path, flow_path)
        self.samples = self._collect_samples()
        if not self.samples:
            raise FileNotFoundError(
                f"No samples for {type(self).__name__} under {dataset_dir}"
            )
        self.image_size = self._output_size()

    # -- to be provided by subclasses ------------------------------------
    def _collect_samples(self):
        raise NotImplementedError

    def _native_size(self):
        """(H, W) of raw frames (read one sample if unknown)."""
        img = _read_image(self.samples[0][0])
        return img.shape[:2]

    # -- pipeline ---------------------------------------------------------
    def _output_size(self):
        if self.crop_type != "none" and self.crop_shape is not None:
            return tuple(self.crop_shape)
        if self.resize_shape is not None:
            return tuple(self.resize_shape)
        h, w = self.origin_size or self._native_size()
        if self.resize_scale is not None:
            return (int(h * self.resize_scale), int(w * self.resize_scale))
        return (h, w)

    def __len__(self):
        return len(self.samples)

    def _load_raw(self, idx: int):
        p0, p1, pf = self.samples[idx]
        images = np.stack([_read_image(p0), _read_image(p1)])
        flow = load_flow(pf)
        if flow is None:
            raise ValueError(f"bad .flo file: {pf}")
        return images, flow.astype(np.float32)

    def __getitem__(self, idx: int, rng=None):
        """``rng``: optional Generator for the crop/flip draws. The
        DataLoader passes a per-(epoch, sample) generator so augmentation
        is deterministic regardless of worker-thread scheduling and of
        mid-epoch preemption resume; plain ``ds[i]`` indexing draws from
        the dataset's own seed-constructed stream."""
        if rng is None:
            rng = self._rng
        images, flow = self._load_raw(idx)

        if self.origin_size is not None:
            images, flow = _resize_pair(images, flow, self.origin_size)

        if self.resize_shape is not None:
            images, flow = _resize_pair(images, flow, self.resize_shape)
        elif self.resize_scale is not None:
            h, w = images.shape[1:3]
            out = (int(h * self.resize_scale), int(w * self.resize_scale))
            images, flow = _resize_pair(images, flow, out)

        if self.crop_type != "none" and self.crop_shape is not None:
            ch, cw = self.crop_shape
            h, w = images.shape[1:3]
            if h < ch or w < cw:
                raise ValueError(
                    f"crop {self.crop_shape} larger than image {(h, w)}"
                )
            if self.crop_type == "random":
                y0 = int(rng.integers(0, h - ch + 1))
                x0 = int(rng.integers(0, w - cw + 1))
            elif self.crop_type == "center":
                y0, x0 = (h - ch) // 2, (w - cw) // 2
            else:
                raise ValueError(f"unknown crop_type {self.crop_type!r}")
            images = images[:, y0 : y0 + ch, x0 : x0 + cw]
            flow = flow[y0 : y0 + ch, x0 : x0 + cw]

        if self.random_flip:
            if rng.random() < 0.5:  # horizontal
                images = images[:, :, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            if rng.random() < 0.5:  # vertical
                images = images[:, ::-1]
                flow = flow[::-1] * np.array([1.0, -1.0], np.float32)

        return np.ascontiguousarray(images), np.ascontiguousarray(flow)

    # -- split helper -----------------------------------------------------
    def _apply_fallback_split(self, samples):
        if self.train_or_val == "val":
            return samples[VAL_STRIDE - 1 :: VAL_STRIDE]
        return [
            s
            for i, s in enumerate(samples)
            if (i + 1) % VAL_STRIDE != 0
        ]


class _Sintel(FlowDataset):
    PASS: str = "clean"

    def _collect_samples(self):
        root = self.dataset_dir
        img_root = root / "training" / self.PASS
        flow_root = root / "training" / "flow"
        samples = []
        if not img_root.is_dir():
            return []
        for scene in sorted(os.listdir(img_root)):
            frames = sorted((img_root / scene).glob("frame_*.png"))
            for f0, f1 in zip(frames[:-1], frames[1:]):
                flo = flow_root / scene / (f0.stem + ".flo")
                if flo.exists():
                    samples.append((str(f0), str(f1), str(flo)))
        return self._apply_fallback_split(samples)


class SintelClean(_Sintel):
    PASS = "clean"


class SintelFinal(_Sintel):
    PASS = "final"


class FlyingChairs(FlowDataset):
    def _collect_samples(self):
        root = self.dataset_dir
        data_dir = root / "data" if (root / "data").is_dir() else root
        flows = sorted(data_dir.glob("*_flow.flo"))
        all_samples = []
        for flo in flows:
            stem = flo.name[: -len("_flow.flo")]
            img0 = data_dir / f"{stem}_img1.ppm"
            img1 = data_dir / f"{stem}_img2.ppm"
            if img0.exists() and img1.exists():
                all_samples.append((str(img0), str(img1), str(flo)))

        split_file = root / "FlyingChairs_train_val.txt"
        if split_file.exists():
            labels = [int(x) for x in split_file.read_text().split()]
            want = 1 if self.train_or_val == "train" else 2
            return [
                s for s, lab in zip(all_samples, labels) if lab == want
            ]
        return self._apply_fallback_split(all_samples)


class SyntheticFlow(FlowDataset):
    """Procedural image pairs with exactly-known integer flow.

    Frame 1 is frame 0 rolled by a per-sample integer displacement; the
    ground-truth flow is constant. Used by integration tests and smoke
    training runs — no files on disk required.
    """

    def __init__(
        self,
        train_or_val: str = "train",
        dataset_dir: str = ".",
        num_samples: int = 32,
        image_shape=(64, 64),
        max_disp: int = 4,
        **kwargs,
    ):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.max_disp = max_disp
        kwargs.setdefault("crop_type", "none")
        kwargs.setdefault("crop_shape", None)
        super().__init__(
            train_or_val=train_or_val, dataset_dir=dataset_dir, **kwargs
        )

    def _collect_samples(self):
        base = 0 if self.train_or_val == "train" else 1_000_000
        return list(range(base, base + self.num_samples))

    def _native_size(self):
        return self.image_shape

    def _load_raw(self, idx: int):
        seed = self.samples[idx]
        rng = np.random.default_rng(seed)
        h, w = self.image_shape
        # smooth random texture so flow is recoverable (ceil-divide so
        # non-multiple-of-4 frame shapes still get full coverage)
        img = rng.random((-(-h // 4), -(-w // 4), 3)).astype(np.float32)
        img = np.kron(img, np.ones((4, 4, 1), np.float32))[:h, :w]
        dx = int(rng.integers(-self.max_disp, self.max_disp + 1))
        dy = int(rng.integers(-self.max_disp, self.max_disp + 1))
        # roll by +(dy, dx): img1[p] = img0[p - (dy, dx)], i.e. content
        # MOVES by +(dy, dx), so the stored forward flow (+dx, +dy)
        # satisfies the model's warp convention img1(p + flow) = img0(p)
        # (ops/warp.py; a -(dy, dx) roll here would make the labels
        # backward flow and the coarse-to-fine warp counterproductive)
        img1 = np.roll(img, shift=(dy, dx), axis=(0, 1))
        images = np.stack(
            [(img * 255).astype(np.uint8), (img1 * 255).astype(np.uint8)]
        )
        flow = np.empty((h, w, 2), np.float32)
        flow[..., 0] = dx
        flow[..., 1] = dy
        return images, flow


_REGISTRY = {
    "SintelClean": SintelClean,
    "SintelFinal": SintelFinal,
    "FlyingChairs": FlyingChairs,
    "Synthetic": SyntheticFlow,
}


def get_dataset(name: str):
    """Dataset class by name (reference datahandler.flow.get_dataset)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown dataset {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
