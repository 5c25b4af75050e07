"""Host input pipeline with device prefetch (counterpart of
``pwcnet_tpu/data/pipeline.py``; for the same (seed, epoch, sample) the two
loaders yield the same bytes).

Replaces the reference's torch DataLoader + per-step feed_dict copy
(train.py:36-41,125-127) with:

- `DataLoader`: threaded sample decoding (PIL/np release the GIL) with
  batch-ahead prefetching, shuffling, and drop_last; three batch paths,
  fastest eligible wins: raw pre-decoded cache (data/cache.py — pure
  memory traffic, one-time transcode via ``cache.build_cache``),
  native C++ decode (data/native), PIL. All three draw augmentation from
  the same per-(seed, epoch, sample) streams, so batches are
  path-identical (tested);
- `device_prefetch`: keeps N batches in flight on the device: pinned host
  buffers, non-blocking copies on a side stream, uint8 images divided by
  255 on the GPU.

The loader yields ``(images, flows)`` host batches:
``images`` (B, 2, H, W, 3) float32 in [0, 1] (the /255 normalization is
folded in here instead of the training loop), ``flows`` (B, H, W, 2)
float32 pixels.
"""

from __future__ import annotations

import collections
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np

__all__ = ["DataLoader", "device_prefetch"]


class DataLoader:
    """Iterates mini-batches of a FlowDataset with background decoding."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 2,
        drop_last: bool = True,
        seed: int = 0,
        prefetch_batches: int = 2,
        normalize: bool | str = True,
        use_native: str | bool = "auto",
        use_cache: str | bool = "auto",
        cache_dir=None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``batch_size`` is per-process; in multi-host training each
        process takes a disjoint, deterministic 1/process_count slice of
        every (identically shuffled) epoch order."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = max(1, int(num_workers))
        self.drop_last = drop_last
        self.prefetch_batches = max(1, int(prefetch_batches))
        # normalize: True -> host /255 (f32 images, the reference
        # contract); 'device' -> images stay uint8 and the /255 happens
        # on the device (device_prefetch converts) — 4x fewer host + PCIe
        # image bytes; False -> raw uint8, no conversion
        # anywhere (caller's responsibility).
        if normalize not in (True, False, "device"):
            raise ValueError(f"normalize must be True/False/'device': "
                             f"{normalize!r}")
        self.normalize = normalize
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} not in [0, {process_count})"
            )
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.seed = int(seed)
        # Epoch-deterministic ordering (sample-exact preemption resume):
        # the shuffle order of epoch e is a pure function of (seed, e),
        # so a resumed run can recreate any epoch's order and skip the
        # batches the preempted run already trained on. `epoch` advances
        # when an iteration RUNS TO COMPLETION (a preempted mid-epoch
        # break leaves it on the current epoch); `start_batch` is a
        # one-shot skip count consumed by the next iteration.
        self.epoch = 0
        self.start_batch = 0
        # fastest first: raw pre-decoded cache (pure memory traffic,
        # data/cache.py) > native C++ decode > PIL
        self._cache = self._cache_setup(use_cache, cache_dir)
        self._native = None if self._cache else self._native_setup(use_native)

    def _sample_rng(self, epoch: int, idx: int) -> np.random.Generator:
        """Augmentation generator for sample ``idx`` of ``epoch``: a pure
        function of (seed, epoch, sample index), so crop/flip draws are
        identical regardless of worker-thread scheduling, of the native
        vs PIL path's batching, and of how much of the epoch a preempted
        run consumed before resume (each sample index appears exactly
        once per epoch)."""
        return np.random.default_rng((self.seed, epoch, 1, int(idx)))

    def _aug_geometry(self) -> dict:
        """Crop/flip geometry shared by the fast batch-assembly paths
        (native decode and raw cache); the draws themselves come from
        `_sample_rng` so every path produces identical augmentation."""
        ds = self.dataset
        native_hw = ds._native_size()
        crop = (
            ds.crop_shape
            if ds.crop_type != "none" and ds.crop_shape is not None
            else native_hw
        )
        return {
            "hw": native_hw,
            "crop": tuple(crop),
            "crop_type": ds.crop_type,
            # drawn exactly when the PIL path draws (datasets.__getitem__)
            # so the per-(epoch, sample) streams stay path-identical
            "draw_crop": ds.crop_type == "random"
            and ds.crop_shape is not None,
            "flip": getattr(ds, "random_flip", False),
        }

    def _draw_aug(self, idxs, epoch: int, cfg: dict):
        """Identical draw sequence to datasets.__getitem__ (y0, x0, then
        one uniform per flip axis) for every sample of a batch."""
        import numpy as _np

        h, w = cfg["hw"]
        ch, cw = cfg["crop"]
        n = len(idxs)
        rngs = [self._sample_rng(epoch, i) for i in idxs]
        if cfg["draw_crop"]:
            y0s = _np.array([int(r.integers(0, h - ch + 1)) for r in rngs])
            x0s = _np.array([int(r.integers(0, w - cw + 1)) for r in rngs])
        elif cfg["crop_type"] == "center":
            y0s = _np.full(n, (h - ch) // 2)
            x0s = _np.full(n, (w - cw) // 2)
        else:
            y0s = _np.zeros(n, int)
            x0s = _np.zeros(n, int)
        if cfg["flip"]:
            flips = _np.array(
                [
                    (r.random() < 0.5) | ((r.random() < 0.5) << 1)
                    for r in rngs
                ],
                _np.uint8,
            )
        else:
            flips = _np.zeros(n, _np.uint8)
        return y0s, x0s, flips

    def _cache_setup(self, use_cache, cache_dir):
        """Enable the raw pre-decoded cache path (data/cache.py) when a
        valid cache exists for this dataset: batches assemble straight
        from the memmapped frames/flows — crop + flip + normalize, no
        decode. ``use_cache=True`` requires one; 'auto' silently falls
        back to the decode paths."""
        if not use_cache or self.normalize is False:
            if use_cache is True and self.normalize is False:
                raise ValueError(
                    "use_cache=True requires normalize=True or 'device'"
                )
            return None
        try:
            from pwcnet_tpu_torch.data.cache import open_cache

            cache = open_cache(self.dataset, cache_dir)
        except Exception:
            if use_cache is True:
                raise
            cache = None
        if cache is None:
            if use_cache is True:
                raise ValueError(
                    "use_cache=True but no valid cache for this dataset "
                    "(build one with pwcnet_tpu_torch.data.cache.build_cache)"
                )
            return None
        return {"cache": cache, **self._aug_geometry()}

    def _cache_assemble(self, idxs, epoch: int):
        cfg = self._cache
        y0s, x0s, flips = self._draw_aug(idxs, epoch, cfg)
        return cfg["cache"].assemble(
            [int(i) for i in idxs],
            cfg["crop"],
            y0s,
            x0s,
            flips,
            num_threads=self.num_workers,
            image_dtype=(
                np.uint8 if self.normalize == "device" else np.float32
            ),
        )

    def _native_setup(self, use_native):
        """Enable the C++ batch assembler when the dataset qualifies:
        PPM- or PNG-backed /.flo sample triples, no resize, uniform frame
        size. The first frame is probe-decoded natively so PNG variants
        the from-scratch reader does not support (16-bit, palette,
        interlaced) fall back to the PIL path up front instead of failing
        mid-epoch."""
        if not use_native or self.normalize is not True:
            # the native decode path emits host-normalized f32 only
            if use_native is True and self.normalize == "device":
                raise ValueError(
                    "use_native=True is incompatible with "
                    "normalize='device' (use the cache path)"
                )
            return None
        ds = self.dataset
        samples = getattr(ds, "samples", None)
        if (
            not samples
            or not isinstance(samples[0], tuple)
            or len(samples[0]) != 3
            or not str(samples[0][0]).lower().endswith((".ppm", ".png"))
            or not str(samples[0][2]).endswith(".flo")
            or getattr(ds, "origin_size", None) is not None
            or getattr(ds, "resize_shape", None) is not None
            or getattr(ds, "resize_scale", None) is not None
        ):
            if use_native is True:
                raise ValueError(
                    "use_native=True but dataset is not PPM/PNG +.flo-"
                    "backed or uses resize"
                )
            return None
        from pwcnet_tpu_torch.data import native

        try:
            native.load_library()
        except Exception as e:
            if use_native is True:
                raise
            # the dataset qualifies but the library does not build or load
            # here: go on with the PIL path, and say so
            warnings.warn(
                f"native data loader unavailable ({e}); decoding with PIL instead",
                RuntimeWarning,
                stacklevel=3,
            )
            return None
        try:
            native.image_size(samples[0][0])  # decodability probe
        except IOError:
            if use_native is True:
                raise
            return None
        return {"native": native, **self._aug_geometry()}

    @property
    def path(self) -> str:
        """Which batch path this loader takes: 'cache', 'native' or 'pil'."""
        if self._cache is not None:
            return "cache"
        return "native" if self._native is not None else "pil"

    def _native_assemble(self, idxs, epoch: int):
        cfg = self._native
        ds = self.dataset
        # identical draw sequence to datasets.__getitem__, so native and
        # PIL runs produce the same augmentations per (seed, epoch, sample)
        y0s, x0s, flips = self._draw_aug(idxs, epoch, cfg)
        samples = [ds.samples[int(i)] for i in idxs]
        return cfg["native"].load_batch(
            samples,
            cfg["crop"],
            y0s,
            x0s,
            flips,
            num_threads=self.num_workers,
        )

    def _local_count(self) -> int:
        n = len(self.dataset)
        return len(range(self.process_index, n, self.process_count))

    def __len__(self) -> int:
        n = self._local_count()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_order(self, epoch: int) -> np.ndarray:
        """This process's deterministic sample order for ``epoch``."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        if self.process_count > 1:
            order = order[self.process_index :: self.process_count]
        return order

    def _batch_indices(self, skip: int = 0):
        order = self.epoch_order(self.epoch)
        bs = self.batch_size
        end = len(order) - (len(order) % bs) if self.drop_last else len(order)
        for i in range(skip * bs, end, bs):
            chunk = order[i : i + bs]
            if chunk.size:
                yield chunk

    def _assemble(self, futures):
        items = [f.result() for f in futures]
        images = np.stack([it[0] for it in items])  # (B, 2, H, W, 3) uint8
        flows = np.stack([it[1] for it in items])  # (B, H, W, 2) f32
        if self.normalize is True:  # 'device' keeps uint8 (/255 on the device)
            images = images.astype(np.float32) / 255.0
        return images, flows

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        # crop/flip draws come from per-(epoch, sample) generators
        # (`_sample_rng`), so the augmentation stream is independent of
        # how much of any previous epoch ran
        epoch = self.epoch
        skip, self.start_batch = self.start_batch, 0
        if self._cache is not None:
            yield from self._iter_prefetched(
                self._cache_assemble, epoch, skip
            )
            self.epoch += 1
            return
        if self._native is not None:
            yield from self._iter_prefetched(
                self._native_assemble, epoch, skip
            )
            self.epoch += 1
            return

        def submit(pool, i):
            return pool.submit(
                self.dataset.__getitem__, int(i), self._sample_rng(epoch, i)
            )

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()
            batches = self._batch_indices(skip)
            # keep `prefetch_batches` batches of sample-futures in flight
            for _ in range(self.prefetch_batches):
                idxs = next(batches, None)
                if idxs is None:
                    break
                pending.append([submit(pool, i) for i in idxs])
            while pending:
                futures = pending.popleft()
                idxs = next(batches, None)
                if idxs is not None:
                    pending.append([submit(pool, i) for i in idxs])
                yield self._assemble(futures)
        self.epoch += 1

    def _iter_prefetched(self, assemble, epoch: int, skip: int = 0):
        """Fast-path iteration (native decode or raw cache): one thread
        assembles batch k+1 while batch k is consumed (the C++ core
        itself fans the per-sample work out over threads)."""
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = collections.deque()
            batches = self._batch_indices(skip)
            for _ in range(self.prefetch_batches):
                idxs = next(batches, None)
                if idxs is None:
                    break
                pending.append(pool.submit(assemble, idxs, epoch))
            while pending:
                fut = pending.popleft()
                idxs = next(batches, None)
                if idxs is not None:
                    pending.append(pool.submit(assemble, idxs, epoch))
                yield fut.result()


def device_prefetch(
    iterator: Iterable,
    size: int = 2,
    device=None,
    device_normalize: bool = True,
) -> Iterator:
    """Keep ``size`` batches resident on ``device`` ahead of consumption.

    A background thread takes host batches (tuples of numpy arrays) from
    ``iterator``. For a CUDA device it copies each leaf into a pinned
    buffer, issues a non-blocking host-to-device copy on a side stream, and
    hands the batch over with an event; the consumer's stream waits on the
    event before the batch is yielded, so decode, transfer and compute
    overlap and the consumer never synchronises with the host. ``device``
    None means CUDA, which must exist, as for every entry point of the
    package; with ``device='cpu'`` it yields CPU tensors with the same values.

    ``device_normalize``: uint8 leaves (the DataLoader's
    ``normalize='device'`` feed) are divided by 255 into float32 on the
    device after the transfer, so the uint8 bytes cross PCIe (4x fewer).

    An error of the loader or of a copy is re-raised on the consumer side:
    it must not look like a clean end of the epoch.
    """
    import torch

    from pwcnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_cuda else None

    def _norm(x):
        if device_normalize and x.dtype == torch.uint8:
            return x.to(torch.float32) / 255.0
        return x

    def _put(batch):
        leaves = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
        if not on_cuda:
            return tuple(_norm(t) for t in leaves), None
        with torch.cuda.stream(side):
            out = tuple(_norm(t.pin_memory().to(device, non_blocking=True)) for t in leaves)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    q: queue.Queue = queue.Queue(maxsize=size)
    _SENTINEL = object()
    err: list = []

    def _producer():
        try:
            for batch in iterator:
                q.put(_put(batch))
        except BaseException as e:  # noqa: BLE001 — transported, not hidden
            err.append(e)
        finally:
            q.put(_SENTINEL)

    thread = threading.Thread(target=_producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            break
        tensors, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for t in tensors:  # allocated on the side stream, used on this one
                t.record_stream(current)
        yield tensors
