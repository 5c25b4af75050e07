"""Parameters carried across from the JAX package.

The JAX parameter tree is nested dicts of arrays, conv kernels HWIO::

    fp_extractor/conv2d .. conv2d_17     (18 convs)
    optflow_0 .. optflow_4/conv2d .. conv2d_5
    context/conv2d .. conv2d_6

each ``{"kernel", "bias"}``: 110 tensors for the 6-level model. The port's
state dict keeps the names as module keys (``fp_extractor.conv2d.weight``)
with OIHW weights. Both directions are transposes, so a round trip is
bit-exact.

``load_params`` reads a flax msgpack file (params only, or a whole
TrainState) with ``msgpack`` and numpy alone; ``save_tree`` writes that
encoding, so a file written by either package restores in the other.
``to_jax_state`` / ``from_jax_state`` carry a whole training state
(parameters, Adam moments, counts) across as numpy arrays in the layout
flax gives ``TrainState`` with ``optax.adam``::

    {"step", "params": tree,
     "opt_state": {"0": {"count", "mu": tree, "nu": tree},
                   "1": {"count"} under a schedule, {} at a constant rate}}

Orbax directories and TF ``.ckpt`` conversion are not read yet.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "from_jax_params", "to_jax_params", "from_jax_state", "to_jax_state",
    "load_params", "load_tree", "save_tree",
]


def _leaves(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


def from_jax_params(tree: dict) -> dict:
    """JAX tree (HWIO kernels) -> port state dict (OIHW weights), float32."""
    state = {}
    for path, arr in _leaves(tree):
        *mods, leaf = path
        arr = np.asarray(arr)
        if leaf == "kernel":
            key, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "bias":
            key = "bias"
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
        state[".".join([*mods, key])] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return state


def to_jax_params(state_dict: dict) -> dict:
    """Port state dict (OIHW) -> JAX tree (HWIO) of float32 numpy arrays."""
    tree: dict = {}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            key, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "bias":
            key = "bias"
        else:
            raise KeyError(f"unexpected parameter {name}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[key] = np.ascontiguousarray(arr)
    return tree


def _array_from_bytes(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack((shape, dtype name, raw C bytes))."""
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=True)
    if name == b"bfloat16":  # no ml_dtypes needed: widen the bits to float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == 1:  # ndarray
        return _array_from_bytes(data)
    if code == 2:  # native complex
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == 3:  # numpy scalar
        return _array_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Rejoin arrays flax split into chunks (leaves over 1 GiB)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_tree(path: str | os.PathLike) -> dict:
    """A flax msgpack file as nested dicts of numpy arrays and scalars."""
    import msgpack

    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(f"{path}: orbax checkpoint directories are not read yet")
    if str(path).endswith((".ckpt", ".ckpt.index")):
        raise NotImplementedError(f"{path}: TF checkpoints must be converted first")
    raw = msgpack.unpackb(path.read_bytes(), ext_hook=_ext_hook, raw=False, strict_map_key=False)
    return _unchunk(raw)


def load_params(path: str | os.PathLike) -> dict:
    """The parameter tree of a flax msgpack checkpoint.

    A whole TrainState keeps the parameters under ``params`` next to
    ``opt_state`` or ``step``; it is unwrapped.
    """
    raw = load_tree(path)
    if isinstance(raw, dict) and "params" in raw and ("opt_state" in raw or "step" in raw):
        raw = raw["params"]
    return raw


def _array_to_bytes(arr: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(1, _array_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(3, _array_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def save_tree(path: str | os.PathLike, tree: dict) -> str:
    """Write nested dicts of numpy arrays in flax's msgpack encoding,
    through a ``.tmp`` file and an atomic rename (no torn checkpoints)."""
    import msgpack

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = msgpack.packb(tree, default=_ext_pack, strict_types=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(data)
    tmp.replace(path)
    return str(path)


def to_jax_state(params: dict, mu: dict, nu: dict, step: int, scheduled: bool) -> dict:
    """Port state dicts (parameters and Adam moments by name, OIHW) and the
    step count -> the tree flax serializes for the JAX package's TrainState.
    ``scheduled``: the learning rate is a schedule, which keeps a count of
    its own in ``opt_state``."""
    count = np.asarray(step, np.int32)
    return {
        "step": int(step),
        "params": to_jax_params(params),
        "opt_state": {
            "0": {"count": count, "mu": to_jax_params(mu), "nu": to_jax_params(nu)},
            "1": {"count": count} if scheduled else {},
        },
    }


def from_jax_state(tree: dict) -> tuple[dict, dict, dict, int]:
    """The JAX package's serialized TrainState -> ``(params, mu, nu, step)``,
    the three as port state dicts (float32 tensors, OIHW)."""
    adam = tree["opt_state"]["0"]
    step = int(np.asarray(tree["step"]))
    if int(np.asarray(adam["count"])) != step:
        raise ValueError(f"Adam count {int(np.asarray(adam['count']))} and step {step} disagree")
    return from_jax_params(tree["params"]), from_jax_params(adam["mu"]), from_jax_params(adam["nu"]), step
