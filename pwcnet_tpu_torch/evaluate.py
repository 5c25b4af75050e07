"""Dataset evaluation CLI of the PyTorch port: average EPE over a dataset
split (flag-compatible with the root ``evaluate.py``, the JAX package's, with
``--platform`` replaced by ``--device``).

- ``--size_handling pad`` (default): frames are edge-padded up to the next
  multiple of 2**num_levels, the network runs on the padded frames, and the
  predicted flow is cropped back: EPE is computed over EVERY pixel of the
  original frames (the literature's Sintel definition, e.g. 436x1024
  full-frame EPE).
- ``--size_handling crop``: center-crop to --crop_shape first (faster, but
  not comparable to published full-frame numbers).

Aggregation is pixel-weighted; a per-scene breakdown is printed for datasets
whose samples carry scene directories (Sintel). Runs on CUDA unless
``--device cpu``; ``--pallas`` / ``--no-pallas`` choose the CUDA kernels
against the plain PyTorch path (auto: on for CUDA). ``--spatial N`` shards
each frame's rows over N processes started by torchrun (every rank reads
every frame; rank 0 prints).

Example:
    python -m pwcnet_tpu_torch.evaluate -d SintelClean -dd datasets/Sintel \\
        --split val -r model/model_100.msgpack
"""

import argparse
from pathlib import Path


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="SintelClean")
    parser.add_argument("-dd", "--dataset_dir", type=str, required=True)
    parser.add_argument("--split", choices=["train", "val"], default="val")
    parser.add_argument("-b", "--batch_size", type=int, default=4)
    parser.add_argument("-r", "--resume", type=str, default=None,
                        help="Checkpoint (flax msgpack, orbax directory, or TF .ckpt) [None]")
    parser.add_argument("--size_handling", choices=["pad", "crop"],
                        default="pad",
                        help="Full-frame eval via edge padding (standard "
                        "protocol) or center cropping [pad]")
    parser.add_argument("--crop_type", type=str, default="center",
                        help="Crop type when --size_handling crop "
                        "(center/none) [center]")
    parser.add_argument("--crop_shape", nargs=2, type=int,
                        default=[384, 448],
                        help="Crop shape when --size_handling crop")
    parser.add_argument("--num_levels", type=int, default=6)
    parser.add_argument("--search_range", type=int, default=4)
    parser.add_argument("--warp_type", choices=["bilinear", "nearest"],
                        default="bilinear",
                        help="Warping layer (must match training)")
    parser.add_argument("--use-dc", dest="use_dc", action="store_true")
    parser.add_argument("--no-dc", dest="use_dc", action="store_false")
    parser.set_defaults(use_dc=False)
    parser.add_argument("--output_level", type=int, default=4)
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cuda or cpu [cuda; raises "
                        "when there is no GPU]")
    parser.add_argument("--pallas", dest="pallas", action="store_true")
    parser.add_argument("--no-pallas", dest="pallas", action="store_false")
    parser.set_defaults(pallas=None)  # auto: on for CUDA, off for the CPU
    parser.add_argument("--spatial", type=int, default=1,
                        help="Shard the frame's H axis over N processes, "
                        "one per GPU (torchrun) [1]")
    return parser


def sample_scene(sample) -> str:
    """Scene label for a dataset sample (Sintel: flow's parent directory)."""
    if isinstance(sample, (tuple, list)) and len(sample) == 3:
        return Path(sample[2]).parent.name
    return "all"


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from pwcnet_tpu_torch.data import DataLoader, get_dataset
    from pwcnet_tpu_torch.inference import FlowPredictor, resolve_device
    from pwcnet_tpu_torch.parallel import mesh_from_args
    from pwcnet_tpu_torch.utils.config import show_progress

    mesh = mesh_from_args(args, args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    is_main = mesh is None or mesh.rank == 0

    pad_mode = args.size_handling == "pad"
    dset = get_dataset(args.dataset)(
        train_or_val=args.split,
        dataset_dir=args.dataset_dir,
        crop_type="none" if pad_mode else args.crop_type,
        crop_shape=None if pad_mode else args.crop_shape,
    )
    loader = DataLoader(
        dset, batch_size=args.batch_size, shuffle=False, drop_last=False
    )
    use_kernels = args.pallas
    if use_kernels is None:
        use_kernels = device.type == "cuda"
    predictor = FlowPredictor(
        checkpoint=args.resume,
        num_levels=args.num_levels,
        search_range=args.search_range,
        warp_type=args.warp_type,
        use_dc=args.use_dc,
        output_level=args.output_level,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        use_kernels=use_kernels,
        size_handling=args.size_handling,
        device=device,
        mesh=mesh,
    )
    factor = 2**args.num_levels

    # per-scene pixel-weighted sums; loader order == dataset order
    scene_sum: dict = {}
    scene_px: dict = {}
    scene_frames: dict = {}
    cursor = 0
    total = len(dset.samples)
    for images, flows_gt in loader:
        b = images.shape[0]
        h, w = images.shape[2], images.shape[3]
        if pad_mode:
            ph = -(-h // factor) * factor
            pw = -(-w // factor) * factor
            batch = np.pad(
                images,
                ((0, 0), (0, 0), (0, ph - h), (0, pw - w), (0, 0)),
                mode="edge",
            )
        else:
            # crop protocol: frames must still be multiples of the
            # pyramid factor — crop down (top-left anchored, like
            # FlowPredictor) and score only the evaluated region (e.g.
            # --crop_type none on 436-row Sintel frames)
            h = factor * (h // factor)
            w = factor * (w // factor)
            batch = images[:, :, :h, :w]
            flows_gt = flows_gt[:, :h, :w]
        flow_final, _ = predictor.raw_forward(np.ascontiguousarray(batch))
        pred = flow_final.float().cpu().numpy()[:, :h, :w]
        err = np.linalg.norm(pred - np.asarray(flows_gt, np.float32), axis=-1)
        for i in range(b):
            scene = sample_scene(dset.samples[cursor + i])
            scene_sum[scene] = scene_sum.get(scene, 0.0) + float(
                err[i].sum()
            )
            scene_px[scene] = scene_px.get(scene, 0) + err[i].size
            scene_frames[scene] = scene_frames.get(scene, 0) + 1
        cursor += b
        if is_main:
            show_progress(1, cursor, total)
    if not is_main:
        return sum(scene_sum.values()) / max(sum(scene_px.values()), 1)
    print()

    # Per-scene breakdown: EPE is the pixel-weighted mean over the
    # scene's frames (sum of per-pixel endpoint errors / pixel count).
    if len(scene_sum) > 1:
        print(f"{'scene':<24} {'EPE':>8} {'frames':>8}")
        for scene in sorted(scene_sum):
            print(
                f"{scene:<24} {scene_sum[scene] / scene_px[scene]:>8.4f} "
                f"{scene_frames[scene]:>8d}"
            )
    grand = sum(scene_sum.values()) / max(sum(scene_px.values()), 1)
    if pad_mode:
        protocol = "full-frame"
    elif args.crop_type == "none":
        protocol = "factor-crop (no dataset crop)"
    else:
        protocol = f"{args.crop_type}-crop {args.crop_shape}"
    print(
        f"{args.dataset}/{args.split} ({protocol}): mean EPE over "
        f"{cursor} frames = {grand:.4f} px"
    )
    return grand


if __name__ == "__main__":
    main()
