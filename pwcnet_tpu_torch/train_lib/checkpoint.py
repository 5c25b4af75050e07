"""Checkpoints of the whole training state: parameters, Adam moments, step
(counterpart of ``pwcnet_tpu/train_lib/checkpoint.py``).

Two backends, each the JAX package's, so a checkpoint written by either
package restores in the other and a resumed run continues the
learning-rate schedule exactly:

- a file: flax's msgpack serialization of the JAX package's ``TrainState``
  (layout in ``pwcnet_tpu_torch/weights.py``);
- a directory: orbax's ``StandardCheckpointer`` layout of the same tree,
  read and written through ``tensorstore`` (``pwcnet_tpu_torch/orbax_format.py``);
  ``save_checkpoint_orbax(..., wait=False)`` writes on a background thread,
  ``wait_for_orbax_saves`` flushes it.

``restore_checkpoint_auto`` and ``load_params`` tell them apart by path
type. ``save_params`` / ``load_params`` handle parameter-only files for
inference and distribution.
"""

from __future__ import annotations

import os
from pathlib import Path

from pwcnet_tpu_torch import orbax_format, weights
from pwcnet_tpu_torch.train_lib.step import TrainState
from pwcnet_tpu_torch.weights import from_jax_state, load_tree, save_tree, to_jax_state

__all__ = [
    "save_checkpoint", "save_checkpoint_orbax", "restore_checkpoint", "restore_checkpoint_orbax",
    "restore_checkpoint_auto", "wait_for_orbax_saves", "save_params", "load_params", "latest_checkpoint",
]


def _state_tree(state: TrainState) -> dict:
    return to_jax_state(state.model.state_dict(), state.mu, state.nu, state.step, callable(state.learning_rate))


def save_checkpoint(path: str | os.PathLike, state: TrainState) -> str:
    """Write ``state`` to ``path`` (atomically, through ``path + '.tmp'``)."""
    return save_tree(path, _state_tree(state))


def save_checkpoint_orbax(directory: str | os.PathLike, state: TrainState, wait: bool = True) -> str:
    """Write ``state`` as an orbax checkpoint directory, replacing one
    already there. ``wait=False``: the host copy is made here and the write
    runs on a background thread (a save still in flight is awaited first);
    call ``wait_for_orbax_saves`` before exit or before reading it back."""
    return orbax_format.save_tree(directory, _state_tree(state), wait=wait)


def wait_for_orbax_saves() -> None:
    """Block until an asynchronous orbax save has landed."""
    orbax_format.wait_for_saves()


def restore_checkpoint(path: str | os.PathLike, state: TrainState) -> TrainState:
    """Restore into ``state`` (e.g. a fresh one), in place; its model must
    have the checkpoint's structure. The learning rate stays ``state``'s."""
    return _restore(path, load_tree(path), state)


def restore_checkpoint_orbax(directory: str | os.PathLike, state: TrainState) -> TrainState:
    """``restore_checkpoint`` from an orbax checkpoint directory."""
    return _restore(directory, orbax_format.load_tree(directory), state)


def _restore(path, tree: dict, state: TrainState) -> TrainState:
    params, mu, nu, step = from_jax_state(tree)
    state.model.load_state_dict(params)
    for name, have, got in (("mu", state.mu, mu), ("nu", state.nu, nu)):
        if have.keys() != got.keys():
            raise KeyError(f"{path}: Adam {name} holds {sorted(got)}, the model has {sorted(have)}")
        for key, t in have.items():
            t.copy_(got[key])
    state.step = step
    return state


def restore_checkpoint_auto(path: str | os.PathLike, state: TrainState) -> TrainState:
    """Restore a TrainState by path type: a directory is an orbax
    checkpoint, a file is msgpack."""
    if Path(path).is_dir():
        return restore_checkpoint_orbax(path, state)
    return restore_checkpoint(path, state)


def save_params(path: str | os.PathLike, state_dict: dict) -> str:
    """Write a parameter-only checkpoint (the JAX package's parameter tree)."""
    return save_tree(path, weights.to_jax_params(state_dict))


def load_params(path: str | os.PathLike) -> dict:
    """The port's state dict from a parameter-only or whole-state msgpack
    file or orbax directory, or from a TF checkpoint (``.ckpt`` /
    ``.ckpt.index``)."""
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
