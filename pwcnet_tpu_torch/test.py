"""Single-pair inference CLI with a latency measurement (the root test.py's counterpart).

Runs PWCDCNet on one image pair, writes the flow pyramid beside the frames
to ./test_figure/test_<name>.pdf (as the root CLI does; matplotlib is
imported only there), optionally writes the final flow as a .flo file, and
with --time reports the mean forward latency: on CUDA timed with CUDA
events after warm-up, on the CPU with the host clock.

``--spatial N`` shards the frame's rows over N processes, one per GPU,
started by torchrun; every rank computes the whole flow and rank 0 prints
and writes it.

Example:
    python -m pwcnet_tpu_torch.test --input_images a.png b.png -r model.msgpack
    python -m pwcnet_tpu_torch.test --input_images a.png b.png -t --dtype bfloat16
    torchrun --nproc_per_node 2 -m pwcnet_tpu_torch.test --input_images a.png b.png --spatial 2
"""

from __future__ import annotations

import argparse
import os
import re
import time


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_images", type=str, nargs=2, required=True,
                        help="Target images (required)")
    parser.add_argument("-r", "--resume", type=str, default=None,
                        help="Learned parameter checkpoint file (flax msgpack, orbax directory, or TF .ckpt) [None]")
    parser.add_argument("--time", "-t", action="store_true",
                        help="Measure inference speed")
    parser.add_argument("--iters", type=int, default=1000,
                        help="# of timing iterations [1000]")
    parser.add_argument("--save_flow", type=str, default=None,
                        help="Also write the final flow as a .flo file")
    parser.add_argument("--num_levels", type=int, default=6,
                        help="# of levels for feature extraction [6]")
    parser.add_argument("--search_range", type=int, default=4,
                        help="Search range for cost-volume calculation [4]")
    parser.add_argument("--warp_type", choices=["bilinear", "nearest"],
                        default="bilinear",
                        help="Warping layer (must match training)")
    parser.add_argument("--use-dc", dest="use_dc", action="store_true")
    parser.add_argument("--no-dc", dest="use_dc", action="store_false")
    parser.set_defaults(use_dc=False)
    parser.add_argument("--output_level", type=int, default=4,
                        help="Final output level for estimated flow [4]")
    parser.add_argument("--size_handling", choices=["crop", "pad"],
                        default="crop",
                        help="Non-multiple-of-64 frames: 'crop' (reference "
                        "behavior) or 'pad' (keep all pixels) [crop]")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Model compute dtype [float32]")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cuda or cpu [cuda]")
    parser.add_argument("--spatial", type=int, default=1,
                        help="Shard the frame's H axis over N processes, "
                        "one per GPU (torchrun) [1]")
    return parser


def figure_path(image_path: str) -> str:
    """./test_figure/test_<name>.pdf, <name> from the first frame's path."""
    return f"./test_figure/test_{'_'.join(re.split('[/.]', image_path)[-3:-1])}.pdf"


def time_forward(predictor, batch, iters: int, warmup: int = 10) -> float:
    """Mean seconds per forward of ``batch`` (B, 2, H, W, 3)."""
    import torch

    dev = predictor.device
    batch = torch.as_tensor(batch).to(dev)
    for _ in range(warmup):
        predictor.raw_forward(batch)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            predictor.raw_forward(batch)
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        predictor.raw_forward(batch)
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    args = build_parser().parse_args(argv)
    for key, item in vars(args).items():
        print(f"{key} : {item}")

    import numpy as np
    import torch

    from pwcnet_tpu_torch.inference import FlowPredictor, load_image
    from pwcnet_tpu_torch.parallel import mesh_from_args
    from pwcnet_tpu_torch.utils import save_flow

    mesh = mesh_from_args(args, args.device)
    is_main = mesh is None or mesh.rank == 0
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
        mesh=mesh,
    )
    img0 = load_image(args.input_images[0])
    img1 = load_image(args.input_images[1])
    flow_final, pyramid_px, images = predictor(img0, img1)

    if args.time:
        batch = np.stack([predictor.prepare(img0), predictor.prepare(img1)])[None]
        sec = time_forward(predictor, batch, args.iters)
        clock = "CUDA events" if predictor.device.type == "cuda" else "host clock"
        if is_main:
            print(f"Inference time: {sec} sec (averaged over {args.iters} iterations, "
                  f"{clock}, {predictor.device})")
    if not is_main:
        return
    from pwcnet_tpu_torch.utils import vis_flow_pyramid

    os.makedirs("./test_figure", exist_ok=True)
    vis_flow_pyramid(pyramid_px, images=images, filename=figure_path(args.input_images[0]))
    if args.save_flow:
        save_flow(args.save_flow, flow_final)
        print(f"Flow saved to {args.save_flow}")
    print("Figure saved")


if __name__ == "__main__":
    main()
