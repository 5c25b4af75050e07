"""TF checkpoint -> parameter tree, with numpy and struct alone (the port's
copy of ``pwcnet_tpu/train_lib/tf_converter.py``).

The reference ships TF1 ``tf.train.Saver`` checkpoints whose variables are
named ``pwcdcnet/{fp_extractor,optflow_l,context}/conv2d[_k]/{kernel,bias}``.
This module reads the TF "bundle" format directly:

- ``<prefix>.index`` is an immutable sorted string table (the LevelDB
  block format: prefix-compressed key/value blocks, an index block, and a
  48-byte footer with magic 0xdb4775248b80fb57);
- its values are serialized ``BundleEntryProto`` messages (dtype, shape,
  shard id, byte offset and size in ``<prefix>.data-XXXXX-of-YYYYY``);
- tensor bytes are raw little-endian arrays at those offsets.

Index blocks must be uncompressed (TF writes them so by default). Kernels
are stored HWIO, the layout of the JAX parameter tree, so conversion is a
pure renaming; ``weights.from_jax_params`` then carries the tree into a
state dict.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = [
    "read_index_entries",
    "read_tf_checkpoint",
    "tf_name_to_path",
    "load_tf_checkpoint_params",
    "convert_tf_checkpoint",
]

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (the subset these checkpoints hold)
_TF_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    6: np.int8,
    7: object,  # string (not read as a tensor)
    9: np.int64,
    10: np.bool_,
    14: np.dtype("bfloat16") if hasattr(np, "bfloat16") else np.uint16,
    19: np.float16,
}


# ----------------------------------------------------------- varint / proto
def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) from a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1;}."""
    dims = []
    for field, _, val in _parse_proto_fields(buf):
        if field == 2:
            for f2, _, v2 in _parse_proto_fields(val):
                if f2 == 1:
                    dims.append(v2)
    return tuple(dims)


class BundleEntry:
    __slots__ = ("dtype", "shape", "shard_id", "offset", "size")

    def __init__(self, dtype, shape, shard_id, offset, size):
        self.dtype = dtype
        self.shape = shape
        self.shard_id = shard_id
        self.offset = offset
        self.size = size

    def __repr__(self):
        return (
            f"BundleEntry(dtype={self.dtype}, shape={self.shape}, "
            f"shard={self.shard_id}, offset={self.offset}, size={self.size})"
        )


def _parse_bundle_entry(buf: bytes) -> BundleEntry:
    dtype = np.float32
    shape: tuple[int, ...] = ()
    shard_id = offset = size = 0
    for field, _, val in _parse_proto_fields(buf):
        if field == 1:
            dtype = _TF_DTYPES.get(val, None)
        elif field == 2:
            shape = _parse_shape(val)
        elif field == 3:
            shard_id = val
        elif field == 4:
            offset = val
        elif field == 5:
            size = val
    return BundleEntry(dtype, shape, shard_id, offset, size)


# -------------------------------------------------------- sstable reading
def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """One table block; its trailing type byte must say uncompressed."""
    if data[offset + size] == 1:
        raise NotImplementedError("snappy-compressed checkpoint index blocks are not supported")
    return data[offset : offset + size]


def _iter_block_entries(block: bytes):
    """Yield (key, value) from a prefix-compressed LevelDB-format block."""
    if len(block) < 4:
        return
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + unshared]
        pos += unshared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def read_index_entries(index_path: str | Path) -> dict[str, BundleEntry]:
    """Parse ``<prefix>.index`` -> {tensor_name: BundleEntry}."""
    data = Path(index_path).read_bytes()
    if len(data) < 48:
        raise ValueError(f"{index_path}: too small to be a TF bundle index")
    footer = data[-48:]
    magic = struct.unpack_from("<Q", footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{index_path}: bad table magic {magic:#x}")
    # footer = metaindex handle + index handle (varint64 pairs) + padding
    pos = 0
    _, pos = _read_varint(footer, pos)  # metaindex offset
    _, pos = _read_varint(footer, pos)  # metaindex size
    index_offset, pos = _read_varint(footer, pos)
    index_size, pos = _read_varint(footer, pos)

    entries: dict[str, BundleEntry] = {}
    for _, handle in _iter_block_entries(_read_block(data, index_offset, index_size)):
        blk_offset, h_pos = _read_varint(handle, 0)
        blk_size, _ = _read_varint(handle, h_pos)
        for key, value in _iter_block_entries(_read_block(data, blk_offset, blk_size)):
            name = key.decode("utf-8", errors="replace")
            if name == "":  # BundleHeaderProto
                continue
            entries[name] = _parse_bundle_entry(value)
    return entries


def read_tf_checkpoint(prefix: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of the TF bundle ``prefix`` (the prefix, the ``.ckpt``
    path or the ``.index`` path). Needs the ``.data-*`` shard files."""
    prefix = str(prefix)
    if prefix.endswith(".index"):
        prefix = prefix[: -len(".index")]
    index_path = Path(prefix + ".index")
    if not index_path.exists():
        raise FileNotFoundError(index_path)
    entries = read_index_entries(index_path)

    shard_files = sorted(Path(prefix).parent.glob(Path(prefix).name + ".data-*"))
    if not shard_files:
        raise FileNotFoundError(f"{prefix}.data-*: checkpoint data shards missing (the index alone names "
                                "the tensors; --check-only lists them)")
    shards = [f.read_bytes() for f in shard_files]

    tensors = {}
    for name, e in entries.items():
        if e.dtype is None or e.dtype is object:
            continue
        raw = shards[e.shard_id][e.offset : e.offset + e.size]
        tensors[name] = np.frombuffer(raw, dtype=e.dtype).reshape(e.shape)
    return tensors


# ----------------------------------------------------------- name mapping
_SKIP_SUFFIXES = ("/Adam", "/Adam_1")
_SKIP_NAMES = ("beta1_power", "beta2_power", "Variable", "global_step")


def tf_name_to_path(name: str) -> tuple[str, ...] | None:
    """A TF variable name as a parameter-tree path, or None to skip.

    ``pwcdcnet/fp_extractor/conv2d_3/kernel`` ->
    ``('fp_extractor', 'conv2d_3', 'kernel')``. Optimizer slots, beta
    powers and the global step are skipped (weights only).
    """
    if name in _SKIP_NAMES or name.split("/")[-1] in _SKIP_NAMES:
        return None
    if any(name.endswith(s) for s in _SKIP_SUFFIXES):
        return None
    parts = name.split("/")
    if parts and parts[0] in ("pwcdcnet", "pwcnet"):
        parts = parts[1:]
    if len(parts) < 2 or parts[-1] not in ("kernel", "bias"):
        return None
    return tuple(parts)


def convert_tf_checkpoint(prefix: str | Path) -> dict:
    """TF checkpoint -> nested parameter dict (names mapped, HWIO kept)."""
    params: dict = {}
    for name, arr in read_tf_checkpoint(prefix).items():
        path = tf_name_to_path(name)
        if path is None:
            continue
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    if not params:
        raise ValueError(f"no model variables found in {prefix}")
    return params


def _sorted_leaves(tree: dict, path=()):
    """(path, leaf) in sorted key order, the order jax flattens a dict in."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _sorted_leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def _get(tree: dict, path):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def load_tf_checkpoint_params(prefix: str | Path, template: dict) -> dict:
    """A TF checkpoint's parameters, checked against ``template`` (nested
    dicts of arrays, e.g. ``weights.to_jax_params(model.state_dict())``).

    Every leaf of the template must be present with the same shape; the
    result has the template's structure and leaf dtypes. Anything else
    raises a ``ValueError`` naming the first five missing and mismatched
    leaves and their totals.
    """
    converted = convert_tf_checkpoint(prefix)
    out: dict = {}
    missing, mismatched = [], []
    for path, leaf in _sorted_leaves(template):
        src = _get(converted, path)
        name = "/".join(path)
        shape = np.shape(leaf)
        if src is None:
            missing.append(name)
        elif tuple(src.shape) != tuple(shape):
            mismatched.append(f"{name}: {src.shape} vs {shape}")
        else:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = np.asarray(src, dtype=np.asarray(leaf).dtype)
    if missing or mismatched:
        raise ValueError(
            f"TF checkpoint incompatible: missing={missing[:5]} "
            f"mismatched={mismatched[:5]} "
            f"({len(missing)} missing, {len(mismatched)} mismatched total)"
        )
    return out
