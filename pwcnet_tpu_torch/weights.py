"""Parameters carried across from the JAX package.

The JAX parameter tree is nested dicts of arrays, conv kernels HWIO::

    fp_extractor/conv2d .. conv2d_17     (18 convs)
    optflow_0 .. optflow_4/conv2d .. conv2d_5
    context/conv2d .. conv2d_6

each ``{"kernel", "bias"}``: 110 tensors for the 6-level model. The port's
state dict keeps the names as module keys (``fp_extractor.conv2d.weight``)
with OIHW weights. The legacy ``PWCNet`` with BatchNorm adds
``optflow_l/bn_i/{scale, bias}`` to the parameters and flax's
``batch_stats`` collection ``optflow_l/bn_i/{mean, var}``, which the port
keeps as buffers of the same names; ``to_jax_variables`` /
``from_jax_variables`` carry both collections (``{"params",
"batch_stats"}``). Both directions are transposes, so a round trip is
bit-exact.

``init_params(model, key)`` draws a model's parameters as the JAX
package's ``model.init(key, ...)`` does, bit for bit (``prng``): each
kernel flax's glorot-uniform over its HWIO shape from
``fold_in_static(key, (*scope path, 1))`` (a kernel is its scope's first
parameter), biases zero, BatchNorm scales one, means 0 and variances 1.

``load_params`` reads a flax msgpack file (params only, or a whole
TrainState) with ``msgpack`` and numpy alone, an orbax checkpoint directory
through ``tensorstore`` (``orbax_format``), and a TF checkpoint
(``.ckpt`` / ``.ckpt.index``) through ``train_lib.tf_converter``;
``save_tree`` writes the msgpack encoding, so a file written by either
package restores in the other.
``to_jax_state`` / ``from_jax_state`` carry a whole training state
(parameters, Adam moments, counts) across as numpy arrays in the layout
flax gives ``TrainState`` with ``optax.adam``::

    {"step", "params": tree,
     "opt_state": {"0": {"count", "mu": tree, "nu": tree},
                   "1": {"count"} under a schedule, {} at a constant rate}}
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "from_jax_params", "to_jax_params", "from_jax_variables", "to_jax_variables", "from_jax_state",
    "to_jax_state", "init_params", "load_params", "load_tree", "save_tree",
]

BATCH_STATS = ("mean", "var")


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
        elif leaf in ("bias", "scale"):
            key = leaf
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
        elif leaf in ("bias", "scale"):
            key = leaf
        elif leaf in BATCH_STATS:
            raise KeyError(f"{name} is a batch statistic, not a parameter: use to_jax_variables")
        else:
            raise KeyError(f"unexpected parameter {name}")
        _put(tree, mods, key, arr)
    return tree


def _put(tree: dict, mods, key, arr) -> None:
    node = tree
    for m in mods:
        node = node.setdefault(m, {})
    node[key] = np.ascontiguousarray(arr)


def to_jax_variables(state_dict: dict) -> dict:
    """Port state dict -> ``{"params": tree}``, plus ``"batch_stats"`` (the
    BatchNorm buffers ``mean`` / ``var``) where the model has any."""
    params = {k: v for k, v in state_dict.items() if k.rsplit(".", 1)[-1] not in BATCH_STATS}
    out = {"params": to_jax_params(params)}
    stats: dict = {}
    for name, t in state_dict.items():
        if name not in params:
            *mods, leaf = name.split(".")
            _put(stats, mods, leaf, t.detach().to("cpu", torch.float32).numpy())
    if stats:
        out["batch_stats"] = stats
    return out


def from_jax_variables(variables: dict) -> dict:
    """``{"params": tree[, "batch_stats": tree]}`` -> port state dict
    (parameters and BatchNorm buffers), float32."""
    state = from_jax_params(variables["params"])
    for path, arr in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in BATCH_STATS:
            raise KeyError(f"unexpected batch statistic {'/'.join(path)}")
        state[".".join(path)] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return state


_FILL = {"bias": 0.0, "scale": 1.0, "mean": 0.0, "var": 1.0}


@torch.no_grad()
def init_params(model: torch.nn.Module, key) -> None:
    """Draw ``model``'s parameters (and BatchNorm statistics) in place from
    ``key`` (``prng.PRNGKey(seed)``) as flax's ``model.init(key, ...)`` does,
    float32, through the JAX-layout tree and ``from_jax_variables``."""
    from pwcnet_tpu_torch import prng

    def draw(tree, path=()):
        return {
            name: draw(val, path + (name,)) if isinstance(val, dict)
            else prng.glorot_uniform(prng.fold_in_static(key, path + (1,)), val.shape) if name == "kernel"
            else np.full(val.shape, _FILL[name], np.float32)
            for name, val in tree.items()
        }

    variables = {col: draw(tree) for col, tree in to_jax_variables(model.state_dict()).items()}
    model.load_state_dict(from_jax_variables(variables))


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
    """A flax msgpack file, or an orbax checkpoint directory, as nested
    dicts of numpy arrays and scalars."""
    import msgpack

    path = Path(path)
    if path.is_dir():
        from pwcnet_tpu_torch import orbax_format

        return orbax_format.load_tree(path)
    if str(path).endswith((".ckpt", ".ckpt.index")):
        raise NotImplementedError(f"{path}: a TF checkpoint holds parameters only; read it with load_params")
    raw = msgpack.unpackb(path.read_bytes(), ext_hook=_ext_hook, raw=False, strict_map_key=False)
    return _unchunk(raw)


def load_params(path: str | os.PathLike) -> dict:
    """The parameter tree of a flax msgpack checkpoint, an orbax checkpoint
    directory or a TF checkpoint.

    A whole TrainState keeps the parameters under ``params`` next to
    ``opt_state`` or ``step``; it is unwrapped. A path ending in ``.ckpt``
    or ``.ckpt.index`` is a TF bundle, converted by name without a check
    of the tree (``FlowPredictor`` checks it against its model).
    """
    if str(path).endswith((".ckpt", ".ckpt.index")):
        from pwcnet_tpu_torch.train_lib.tf_converter import convert_tf_checkpoint

        return convert_tf_checkpoint(path)
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
