"""Training CLI of the PyTorch port, flag-compatible with the root ``train.py``
(the JAX package's), with ``--platform`` replaced by ``--device``.

Runs on CUDA unless ``--device cpu``; without a GPU and without that flag it
raises. Checkpoints are full-state msgpack files (parameters, Adam state,
step) that either package resumes from. ``--pallas`` / ``--no-pallas`` keep
their names and choose the hand-written CUDA kernels against the plain
PyTorch path (auto: on for CUDA, off for the CPU). Not supported yet,
refused by name: ``--ckpt_backend orbax``.

Across GPUs, one process each: ``torchrun --nproc_per_node N -m
pwcnet_tpu_torch.train --spatial S ...`` runs a (N / S data) x (S spatial)
mesh on one host (rank r on ``cuda:LOCAL_RANK``); across hosts,
``--coordinator host:port --num_processes P --process_id I`` on each
(``torch.distributed`` over ``tcp://host:port``, as the JAX package's
``jax.distributed.initialize``). ``-b`` is the batch of each data index.

Example:
    python -m pwcnet_tpu_torch.train -d SintelClean -dd datasets/Sintel
    python -m pwcnet_tpu_torch.train -d Synthetic -dd . -e 2 -b 4 --crop_type none --device cpu
    torchrun --nproc_per_node 8 -m pwcnet_tpu_torch.train -d SintelClean -dd datasets/Sintel --spatial 2
"""

import argparse
import os


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="SintelClean",
                        help="Target dataset [SintelClean]")
    parser.add_argument("-dd", "--dataset_dir", type=str, required=True,
                        help="Directory containing target dataset")
    parser.add_argument("-e", "--num_epochs", type=int, default=100,
                        help="# of epochs [100]")
    parser.add_argument("-b", "--batch_size", type=int, default=4,
                        help="Batch size [4]")
    parser.add_argument("-nw", "--num_workers", type=int, default=2,
                        help="# of workers for data loading [2]")

    parser.add_argument("--crop_type", type=str, default="random",
                        help="Crop type for raw data [random]")
    parser.add_argument("--crop_shape", nargs=2, type=int,
                        default=[384, 448],
                        help="Crop shape for raw data [384, 448]")
    parser.add_argument("--resize_shape", nargs=2, type=int, default=None,
                        help="Resize shape for raw data [None]")
    parser.add_argument("--resize_scale", type=float, default=None,
                        help="Resize scale for raw data [None]")
    parser.add_argument("--flip", dest="random_flip", action="store_true",
                        help="Enable random flip augmentation [disabled]")
    parser.set_defaults(random_flip=False)

    parser.add_argument("--num_levels", type=int, default=6,
                        help="# of levels for feature extraction [6]")
    parser.add_argument("--search_range", type=int, default=4,
                        help="Search range for cost-volume calculation [4]")
    parser.add_argument("--warp_type", default="bilinear",
                        choices=["bilinear", "nearest"],
                        help="Warping protocol, [bilinear] or nearest")
    parser.add_argument("--use-dc", dest="use_dc", action="store_true",
                        help="Enable dense connection in optical flow "
                        "estimator, [disabled] as default")
    parser.add_argument("--no-dc", dest="use_dc", action="store_false",
                        help="Disable dense connection in optical flow "
                        "estimator, [disabled] as default")
    parser.set_defaults(use_dc=False)
    parser.add_argument("--output_level", type=int, default=4,
                        help="Final output level for estimated flow [4]")

    parser.add_argument("--loss", default="multiscale",
                        choices=["multiscale", "robust"],
                        help="Loss function choice in [multiscale/robust]")
    parser.add_argument("--lr", type=float, default=1e-4,
                        help="Learning rate [1e-4]")
    parser.add_argument("--lr_scheduling", dest="lr_scheduling",
                        action="store_true",
                        help="Enable learning rate scheduling [enabled]")
    parser.add_argument("--no-lr_scheduling", dest="lr_scheduling",
                        action="store_false",
                        help="Disable learning rate scheduling [enabled]")
    parser.set_defaults(lr_scheduling=True)
    parser.add_argument("--weights", nargs="+", type=float,
                        default=[0.32, 0.08, 0.02, 0.01, 0.005],
                        help="Weights for each pyramid loss")
    parser.add_argument("--gamma", type=float, default=0.0004,
                        help="Coefficient for weight decay [4e-4]")
    parser.add_argument("--epsilon", type=float, default=0.02,
                        help="Small constant for robust loss [0.02]")
    parser.add_argument("--q", type=float, default=0.4,
                        help="Tolerance constant for outlier flow [0.4]")

    parser.add_argument("-v", "--visualize", dest="visualize",
                        action="store_true",
                        help="Enable estimated flow visualization [enabled]")
    parser.add_argument("--no-visualize", dest="visualize",
                        action="store_false",
                        help="Disable estimated flow visualization [enabled]")
    parser.set_defaults(visualize=True)
    parser.add_argument("-r", "--resume", type=str, default=None,
                        help="Learned parameter checkpoint file [None]")
    parser.add_argument("--ckpt_backend", choices=["msgpack", "orbax"],
                        default="msgpack",
                        help="Checkpoint format: single-file msgpack; "
                        "orbax is not supported by this package yet "
                        "[msgpack]")

    parser.add_argument("--seed", type=int, default=0, help="PRNG seed [0]")
    parser.add_argument("--log_interval", type=int, default=1000,
                        help="Train-metric logging interval in steps [1000]")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cuda or cpu [cuda; raises "
                        "when there is no GPU]")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="Multi-process training: coordinator "
                        "address host:port [None = single process, or "
                        "torchrun's environment]")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Multi-host: total process count "
                        "(with --coordinator host:port)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="Multi-host: this process's index "
                        "(with --coordinator host:port)")
    parser.add_argument("--spatial", type=int, default=1,
                        help="Mesh size of the spatial (H) axis: each frame's "
                        "rows are sharded over this many processes [1]")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Compute dtype (params stay float32) "
                        "[float32]")
    parser.add_argument("--remat", action="store_true",
                        help="Rematerialize activations in the backward "
                        "(bigger crops/batches per GPU) [disabled]")
    parser.add_argument("--pallas", dest="pallas", action="store_true",
                        help="Use the hand-written CUDA kernels (CUDA only; "
                        "the flag keeps the JAX package's name)")
    parser.add_argument("--no-pallas", dest="pallas", action="store_false")
    parser.set_defaults(pallas=None)  # auto: on for CUDA, off for the CPU
    parser.add_argument("--no-fused", dest="fused", action="store_false",
                        help="Disable the fused warp+cost-volume kernel "
                        "(on by default with --pallas and bilinear warp)")
    parser.set_defaults(fused=True)
    parser.add_argument("--fused-estimator", dest="fused_estimator",
                        type=int, default=0,
                        help="Run the N finest estimator levels through "
                        "the fused 6-conv chain kernels (K7) [0: off, "
                        "opt-in as in the JAX package]")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    # rank 0 prints, as it writes: the rank torchrun or --process_id gives
    rank = args.process_id if args.coordinator else int(os.environ.get("RANK", "0"))
    if not rank:
        for key, item in vars(args).items():
            print(f"{key} : {item}")

    from pwcnet_tpu_torch.train_lib.trainer import Trainer, check_supported

    check_supported(args)
    trainer = Trainer(args)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
