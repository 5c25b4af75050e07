"""Checkpoints of the whole training state: parameters, Adam moments, step
(counterpart of the msgpack part of ``pwcnet_tpu/train_lib/checkpoint.py``).

The file is flax's msgpack serialization of the JAX package's
``TrainState`` (layout in ``pwcnet_tpu_torch/weights.py``), so a
checkpoint written by either package restores in the other and a resumed
run continues the learning-rate schedule exactly. ``save_params`` /
``load_params`` handle parameter-only files for inference and distribution.
Orbax directories are not read or written yet: ``restore_checkpoint_auto``
raises ``NotImplementedError`` for one.
"""

from __future__ import annotations

import os
from pathlib import Path

from pwcnet_tpu_torch import weights
from pwcnet_tpu_torch.train_lib.step import TrainState
from pwcnet_tpu_torch.weights import from_jax_state, load_tree, save_tree, to_jax_state

__all__ = [
    "save_checkpoint", "restore_checkpoint", "restore_checkpoint_auto",
    "save_params", "load_params", "latest_checkpoint",
]


def save_checkpoint(path: str | os.PathLike, state: TrainState) -> str:
    """Write ``state`` to ``path`` (atomically, through ``path + '.tmp'``)."""
    tree = to_jax_state(
        state.model.state_dict(), state.mu, state.nu, state.step, callable(state.learning_rate)
    )
    return save_tree(path, tree)


def restore_checkpoint(path: str | os.PathLike, state: TrainState) -> TrainState:
    """Restore into ``state`` (e.g. a fresh one), in place; its model must
    have the checkpoint's structure. The learning rate stays ``state``'s."""
    params, mu, nu, step = from_jax_state(load_tree(path))
    state.model.load_state_dict(params)
    for name, have, got in (("mu", state.mu, mu), ("nu", state.nu, nu)):
        if have.keys() != got.keys():
            raise KeyError(f"{path}: Adam {name} holds {sorted(got)}, the model has {sorted(have)}")
        for key, t in have.items():
            t.copy_(got[key])
    state.step = step
    return state


def restore_checkpoint_auto(path: str | os.PathLike, state: TrainState) -> TrainState:
    """Restore a TrainState by path type: a file is msgpack; a directory is
    an orbax checkpoint, which this package does not read yet."""
    if Path(path).is_dir():
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories are not supported by pwcnet_tpu_torch yet; "
            "resume from a .msgpack file"
        )
    return restore_checkpoint(path, state)


def save_params(path: str | os.PathLike, state_dict: dict) -> str:
    """Write a parameter-only checkpoint (the JAX package's parameter tree)."""
    return save_tree(path, weights.to_jax_params(state_dict))


def load_params(path: str | os.PathLike) -> dict:
    """The port's state dict from a parameter-only or whole-state msgpack
    file, or from a TF checkpoint (``.ckpt`` / ``.ckpt.index``)."""
    return weights.from_jax_params(weights.load_params(path))


def latest_checkpoint(directory: str | os.PathLike, prefix: str = "model_"):
    """Highest-numbered ``<prefix><n>.msgpack`` in a directory, or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    best, best_n = None, -1
    for p in directory.glob(f"{prefix}*.msgpack"):
        try:
            n = int(p.stem[len(prefix):])
        except ValueError:
            continue
        if n > best_n:
            best, best_n = p, n
    return str(best) if best else None
