"""Convert a reference TF checkpoint to a flax-msgpack params file (the root
convert_checkpoint.py's counterpart).

Reads the TF bundle format directly (no TensorFlow), checks every tensor
against the PWCDCNet parameter tree, and writes a params-only msgpack that
both packages' ``load_params`` and every CLI's ``-r`` read.

Example:
    python -m pwcnet_tpu_torch.convert_checkpoint model_1000epochs/model_600.ckpt out.msgpack
    python -m pwcnet_tpu_torch.convert_checkpoint model_1000epochs/model_600.ckpt out.msgpack --check-only
"""

from __future__ import annotations

import argparse


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("tf_checkpoint", help="TF checkpoint prefix (or .index path)")
    parser.add_argument("output", help="Output .msgpack path")
    parser.add_argument("--num_levels", type=int, default=6)
    parser.add_argument("--search_range", type=int, default=4)
    parser.add_argument("--use-dc", dest="use_dc", action="store_true")
    parser.set_defaults(use_dc=False)
    parser.add_argument("--output_level", type=int, default=4)
    parser.add_argument("--check-only", action="store_true",
                        help="Only list the name/shape tree from the .index (works without the .data shards)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from pwcnet_tpu_torch.train_lib.tf_converter import (
        load_tf_checkpoint_params,
        read_index_entries,
        tf_name_to_path,
    )

    if args.check_only:
        index = args.tf_checkpoint
        if not index.endswith(".index"):
            index += ".index"
        entries = read_index_entries(index)
        model_vars = {n: e for n, e in entries.items() if tf_name_to_path(n)}
        print(f"{len(entries)} entries, {len(model_vars)} model tensors:")
        for name in sorted(model_vars):
            print(f"  {name}  {model_vars[name].shape}")
        return

    from pwcnet_tpu_torch.models import PWCDCNet
    from pwcnet_tpu_torch.weights import save_tree, to_jax_params

    model = PWCDCNet(num_levels=args.num_levels, search_range=args.search_range, use_dc=args.use_dc,
                     output_level=args.output_level, init=False)  # a template of the tree only
    params = load_tf_checkpoint_params(args.tf_checkpoint, to_jax_params(model.state_dict()))
    save_tree(args.output, params)
    print(f"Converted {len(model.state_dict())} tensors -> {args.output}")


if __name__ == "__main__":
    main()
