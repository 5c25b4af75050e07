"""Orbax checkpoint directories, read and written through ``tensorstore``.

The JAX package saves a TrainState with orbax's ``StandardCheckpointer``
(``pwcnet_tpu/train_lib/checkpoint.py``). orbax imports JAX; the layout it
writes is plain tensorstore, which does not, so this module reads and
writes it without orbax:

- an OCDBT key-value store at the directory (``manifest.ocdbt`` and its
  data files; orbax adds an ``ocdbt.process_<i>/`` store a process, which
  the root manifest reaches);
- one zarr v2 array a leaf, keyed by its dotted path (``params.a.b.kernel``,
  ``opt_state.0.mu...``, ``step``), zstd-compressed, one chunk;
- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's path to its
  keys (``key_type`` 1 for a tuple index, such as ``opt_state``'s, 2 for a
  dict key) and its value type: ``np.ndarray``, ``scalar`` (a Python
  number, such as ``step``), or ``None`` for an empty node (optax's
  ``EmptyState``, the schedule state at a constant learning rate), which
  reads back as ``{}``; orbax's restore needs this file;
- ``_CHECKPOINT_METADATA``: the save's timestamps, as orbax writes them.

Trees are nested dicts of numpy arrays and Python numbers, the layout of
``weights.to_jax_state``. A save writes a temporary sibling and renames it
into place, replacing a directory already there (orbax's ``force=True``).
``save_tree(..., wait=False)`` copies the tree on the calling thread and
writes it on one background thread, at most one save in flight;
``wait_for_saves`` blocks until it has landed, and ``load_tree`` waits
first, so a reader never sees a half-written save of this process.

``tensorstore`` is imported when a directory is read or written; where it
is missing, the call raises ``ModuleNotFoundError`` naming it.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["load_tree", "require_tensorstore", "save_tree", "wait_for_saves"]

_ZARR = {"compressor": {"id": "zstd", "level": 1}, "fill_value": None, "order": "C", "filters": None,
         "dimension_separator": "."}
# orbax's OCDBT write options: small values (.zarray) inline, one root node
_OCDBT_CONFIG = {"max_inline_value_bytes": 1024, "max_decoded_node_bytes": 100000000, "manifest_kind": "single",
                 "compression": {"id": "zstd"}}
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"

_executor: Optional[ThreadPoolExecutor] = None
_pending: Optional[Future] = None


def require_tensorstore():
    """The ``tensorstore`` module, or ``ModuleNotFoundError`` naming it."""
    try:
        import tensorstore
    except ImportError as exc:
        raise ModuleNotFoundError(
            "orbax checkpoint directories are read and written through the tensorstore package, which is "
            "not installed; install tensorstore or use msgpack files (--ckpt_backend msgpack)",
            name="tensorstore",
        ) from exc
    return tensorstore


def _kvstore(directory: Path, write: bool = False) -> dict:
    spec = {"driver": "ocdbt", "base": f"file://{directory}/"}
    if write:
        spec.update(config=_OCDBT_CONFIG, assume_config=True)
    return spec


def _leaves(tree: dict, path=()):
    for key, val in tree.items():
        if isinstance(val, dict) and val:
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


def _host_copy(tree: dict) -> dict:
    """The tree with every array copied, so that the caller may go on
    changing the tensors it came from while a save is in flight."""
    return {k: _host_copy(v) if isinstance(v, dict) else (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in tree.items()}


def _write(directory: Path, tree: dict) -> None:
    ts = require_tensorstore()
    tmp = directory.with_name(directory.name + ".orbax-tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    start = time.time_ns()
    kvstore = _kvstore(tmp, write=True)
    txn = ts.Transaction()
    writes, meta = [], {}
    for keys, val in _leaves(tree):
        key_metadata = [{"key": k, "key_type": 1 if k.isdigit() else 2} for k in keys]
        if isinstance(val, dict):  # an empty node
            value = {"value_type": "None", "skip_deserialize": True}
        else:
            value = {"value_type": "np.ndarray" if isinstance(val, np.ndarray) else "scalar",
                     "skip_deserialize": False}
            arr = np.asarray(val)
            store = ts.open(
                {"driver": "zarr", "kvstore": {**kvstore, "path": ".".join(keys)},
                 "metadata": {"shape": list(arr.shape), "chunks": list(arr.shape), "dtype": arr.dtype.str, **_ZARR}},
                create=True, open=False, transaction=txn).result()
            writes.append(store.write(arr))
        meta[str(keys)] = {"key_metadata": key_metadata, "value_metadata": value}
    for w in writes:
        w.result()
    txn.commit_async().result()
    (tmp / "_METADATA").write_text(json.dumps({
        "tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": start,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}))
    if directory.exists():
        old = directory.with_name(directory.name + ".orbax-old")
        if old.exists():
            shutil.rmtree(old)
        directory.rename(old)
        tmp.rename(directory)
        shutil.rmtree(old)
    else:
        tmp.rename(directory)


def save_tree(directory: str | os.PathLike, tree: dict, wait: bool = True) -> str:
    """Write ``tree`` as an orbax checkpoint directory. With ``wait=False``
    the arrays are copied here and written on a background thread; a save
    still in flight is awaited first."""
    require_tensorstore()
    global _pending
    wait_for_saves()
    directory = Path(directory).absolute()
    tree = _host_copy(tree)
    if wait:
        _write(directory, tree)
    else:
        global _executor
        if _executor is None:
            _executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="orbax-save")
        _pending = _executor.submit(_write, directory, tree)
    return str(directory)


def wait_for_saves() -> None:
    """Block until a save started with ``wait=False`` has landed (and raise
    what it raised)."""
    global _pending
    pending, _pending = _pending, None
    if pending is not None:
        pending.result()


def load_tree(directory: str | os.PathLike) -> dict:
    """An orbax checkpoint directory as nested dicts of numpy arrays (bf16
    widened to float32), Python numbers for scalars and ``{}`` for empty
    nodes."""
    ts = require_tensorstore()
    wait_for_saves()
    directory = Path(directory).absolute()
    meta_path = directory / "_METADATA"
    if not meta_path.is_file():
        raise FileNotFoundError(f"{directory}: no _METADATA, not an orbax checkpoint directory")
    meta = json.loads(meta_path.read_text())["tree_metadata"]
    kvstore = _kvstore(directory)
    reads = {}
    for entry in meta.values():
        keys = tuple(k["key"] for k in entry["key_metadata"])
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            reads[keys] = None
        else:
            store = ts.open({"driver": "zarr", "kvstore": {**kvstore, "path": ".".join(keys)}}, open=True).result()
            reads[keys] = (store.read(), value["value_type"])
    tree: dict = {}
    for keys, item in reads.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if item is None:
            node[keys[-1]] = {}
            continue
        arr = np.asarray(item[0].result())
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        node[keys[-1]] = arr[()].item() if item[1] == "scalar" else arr
    return tree
