"""Checkpoints of the whole training state: parameters, Adam moments, step
(counterpart of the msgpack part of ``pwcnet_tpu/train_lib/checkpoint.py``).

The file is flax's msgpack serialization of the JAX package's
``TrainState`` (layout in ``pwcnet_tpu_torch/weights.py``), so a
checkpoint written by either package restores in the other and a resumed
run continues the learning-rate schedule exactly. Orbax directories are
not read or written yet.
"""

from __future__ import annotations

import os

from pwcnet_tpu_torch.train_lib.step import TrainState
from pwcnet_tpu_torch.weights import from_jax_state, load_tree, save_tree, to_jax_state

__all__ = ["save_checkpoint", "restore_checkpoint"]


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
