"""Sequence inference CLI (the root test_continuous.py's counterpart).

Runs PWCDCNet over the consecutive frame pairs of an image sequence
(``FlowPredictor.predict_sequence``) and writes a flow-pyramid figure per
pair to ./test_figure/<dir>/<frame>.png. Every ``-i`` argument is globbed
and sorted. ``--time`` measures the sequence throughput instead: the
frames are decoded first, one warm pass of ``batch + 1`` frames runs, and
the pairs/s of the whole sequence are printed (decode excluded).

Example:
    python -m pwcnet_tpu_torch.test_continuous -i 'frames/*.png' -r model/model_100.msgpack
    python -m pwcnet_tpu_torch.test_continuous -i 'frames/*.png' --time --dtype bfloat16
"""

from __future__ import annotations

import argparse
import os
import re
import time
from glob import glob


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input_images", type=str, nargs="+", required=True,
                        help="Target images (required)")
    parser.add_argument("-r", "--resume", type=str, default=None,
                        help="Learned parameter checkpoint (flax msgpack, orbax directory, or TF .ckpt) [None]")
    parser.add_argument("--num_levels", type=int, default=6,
                        help="# of levels for feature extraction [6]")
    parser.add_argument("--search_range", type=int, default=4,
                        help="Search range for cost-volume calculation [4]")
    parser.add_argument("--warp_type", choices=["bilinear", "nearest"], default="bilinear",
                        help="Warping layer (must match training)")
    parser.add_argument("--use-dc", dest="use_dc", action="store_true")
    parser.add_argument("--no-dc", dest="use_dc", action="store_false")
    parser.set_defaults(use_dc=False)
    parser.add_argument("--output_level", type=int, default=4,
                        help="Final output level for estimated flow [4]")
    parser.add_argument("--size_handling", choices=["crop", "pad"], default="crop",
                        help="Non-multiple-of-64 frames: 'crop' (reference "
                        "behavior) or 'pad' (keep all pixels) [crop]")
    parser.add_argument("-t", "--time", dest="time", action="store_true",
                        help="Measure sequence throughput (pairs/s) instead of writing figures")
    parser.add_argument("--batch", type=int, default=None,
                        help="Consecutive pairs per dispatch [1; 8 with --time]")
    parser.add_argument("--depth", type=int, default=2,
                        help="In-flight dispatched batches [2]")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cuda or cpu [cuda]")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                        help="Model compute dtype [float32]")
    return parser


def expand_wildcards(paths):
    out = []
    for p in paths:
        if any(ch in p for ch in "*?["):
            out.extend(sorted(glob(p)))
        else:
            out.append(p)
    return out


def figure_path(image_path: str) -> tuple[str, str]:
    """(directory, file name) under ./test_figure for a pair's first frame."""
    parts = re.split("[/.]", image_path)[-3:-1]
    return tuple(parts) if len(parts) == 2 else ("seq", parts[-1])


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.input_images = expand_wildcards(args.input_images)
    if len(args.input_images) < 2:
        raise ValueError("# of input images must be >= 2")

    print(args.resume)
    for i, image in enumerate(args.input_images):
        print(image)
        if i == 5:
            print(f"... and more ({len(args.input_images)} images)")
            break

    import torch

    from pwcnet_tpu_torch.inference import FlowPredictor, load_image

    predictor = FlowPredictor(
        checkpoint=args.resume,
        num_levels=args.num_levels,
        search_range=args.search_range,
        warp_type=args.warp_type,
        use_dc=args.use_dc,
        output_level=args.output_level,
        size_handling=args.size_handling,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        device=args.device,
    )
    if args.time:
        # pre-decoded frames: the number is the streaming pipeline's
        # (staging, dispatch, compute, copies back), not the PNG decoder's
        frames = [load_image(p) for p in args.input_images]
        batch = args.batch or 8
        for _ in predictor.predict_sequence(frames[: batch + 1], depth=args.depth, batch=batch, fetch="flow"):
            pass
        n_pairs = len(frames) - 1
        start = time.perf_counter()
        for _ in predictor.predict_sequence(frames, depth=args.depth, batch=batch, fetch="flow"):
            pass
        elapsed = time.perf_counter() - start
        print(f"sequence throughput: {n_pairs} pairs in {elapsed:.3f} s = {n_pairs / elapsed:.1f} pairs/s "
              f"(batch={batch}, depth={args.depth}, decode excluded)")
        return

    from pwcnet_tpu_torch.utils import vis_flow_pyramid

    os.makedirs("./test_figure", exist_ok=True)
    results = predictor.predict_sequence(args.input_images, depth=args.depth, batch=args.batch or 1)
    for img1_path, (_, pyramid_px, images) in zip(args.input_images[:-1], results):
        dname, fname = figure_path(img1_path)
        os.makedirs(f"./test_figure/{dname}", exist_ok=True)
        vis_flow_pyramid(pyramid_px, images=images, filename=f"./test_figure/{dname}/{fname}.png")
    print("Figure saved")


if __name__ == "__main__":
    main()
