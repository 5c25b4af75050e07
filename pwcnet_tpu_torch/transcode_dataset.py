"""One-time dataset transcode into the raw pre-decoded cache (the
counterpart of ``scripts/transcode_dataset.py``).

Decodes every frame once and packs frames and flows into memmap-able
files (``data/cache.py``'s layout: ``frames.u8``, ``flows.f32`` and
``index.json``, which either package's loader opens); the DataLoader's
cache path then serves batches with no decode. Prints one JSON line per
split: dataset, split, cache_dir, samples, frames_bytes, flows_bytes and
transcode_sec.

Example:
    python -m pwcnet_tpu_torch.transcode_dataset -d SintelClean -dd /data/sintel
    python -m pwcnet_tpu_torch.transcode_dataset -d SintelClean -dd /data/sintel --split val --out /fast/sintel_cache

An existing cache for the same sample list is kept; a changed sample list
is rebuilt.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", default="SintelClean",
                        help="Dataset name (get_dataset registry)")
    parser.add_argument("-dd", "--dataset_dir", required=True)
    parser.add_argument("--split", nargs="+", default=["train", "val"], choices=["train", "val"],
                        help="Which splits to transcode [both]")
    parser.add_argument("--out", default=None,
                        help="Cache dir override (default: <dataset_dir>/.pwcnet_cache/<Class>_<split>; "
                        "with --out, '_<split>' is appended)")
    return parser


def main(argv=None) -> list:
    """Transcode each split; returns the printed records."""
    args = build_parser().parse_args(argv)

    from pwcnet_tpu_torch.data.cache import build_cache, default_cache_dir
    from pwcnet_tpu_torch.data.datasets import get_dataset

    cls = get_dataset(args.dataset)
    records = []
    for split in args.split:
        ds = cls(split, args.dataset_dir, crop_type="none", crop_shape=None)
        out = f"{args.out}_{split}" if args.out else default_cache_dir(ds)
        start = time.perf_counter()
        cache_dir = build_cache(ds, out, progress=True)
        record = {
            "dataset": args.dataset,
            "split": split,
            "cache_dir": str(cache_dir),
            "samples": len(ds.samples),
            "frames_bytes": os.path.getsize(os.path.join(cache_dir, "frames.u8")),
            "flows_bytes": os.path.getsize(os.path.join(cache_dir, "flows.f32")),
            "transcode_sec": round(time.perf_counter() - start, 1),
        }
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
