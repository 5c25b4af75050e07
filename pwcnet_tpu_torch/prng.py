"""The JAX package's random keys and flax's parameter init, in numpy.

One seed gives both packages the same model: ``weights.init_params`` draws
every kernel as flax's ``Module.init(jax.random.PRNGKey(seed), ...)`` does,
bit for bit, without JAX. The functions mirror these sources (jax 0.9,
``jax/_src/``; flax 0.12, ``flax/core/scope.py``):

=====================  ==============================================
``PRNGKey(seed)``      ``prng.py`` ``threefry_seed``, 32-bit mode
``threefry_2x32``      ``prng.py`` ``threefry_2x32`` and
                       ``_threefry2x32_lowering`` (20 rounds)
``fold_in``            ``prng.py`` ``_threefry_fold_in``
``random_bits``        ``prng.py`` ``_threefry_random_bits_partitionable``
                       (32 bits)
``uniform``            ``random.py`` ``_uniform`` (float32)
``glorot_uniform``     ``nn/initializers.py`` ``variance_scaling(1.0,
                       "fan_avg", "uniform")`` (float32)
``fold_in_static``     flax's ``_fold_in_static``
=====================  ==============================================

The behaviour pinned is that of those versions' defaults:
``jax_threefry_partitionable`` on (bits from the (hi, lo) words of each
element's flat index), ``jax_enable_x64`` off (a seed is taken modulo
2**32), ``flax_fix_rng_separator`` off (no separator byte between the
names hashed) and an int hashed big-endian in ``(bit_length + 7) // 8``
bytes (so 0 adds no bytes). A key is a uint32 array of shape (2,).
uint32 arithmetic wraps, as in XLA: array sums wrap silently in numpy, and
scalar sums are taken on Python ints and masked.
"""

from __future__ import annotations

import hashlib
import math
from typing import Iterable, Sequence, Union

import numpy as np

__all__ = ["PRNGKey", "threefry_2x32", "fold_in", "random_bits", "uniform", "glorot_uniform",
           "fold_in_static"]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]`` of
    the seed as a 32-bit int, so ``[0, seed mod 2**32]``."""
    return np.array([0, int(seed) & MASK32], np.uint32)


def _as_key(key) -> tuple[int, int]:
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise TypeError(f"a key is a uint32 array of shape (2,), got {key.dtype} {key.shape}")
    return int(key[0]), int(key[1])


def _threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block on two uint32 word arrays (copies, updated in
    place): five groups of four rounds, a key injection after each."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x0 + np.uint32(ks[0])
    x1 = x1 + np.uint32(ks[1])
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.right_shift(x1, np.uint32(32 - r), out=t)  # x1 rotated left by r
            x1 <<= np.uint32(r)
            x1 |= t
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & MASK32)
    return x0, x1


def threefry_2x32(key, count: np.ndarray) -> np.ndarray:
    """``threefry_2x32(keypair, count)``: the flat count split in halves
    (an odd one padded with a 0 word), hashed, joined, unpadded."""
    k1, k2 = _as_key(key)
    flat = np.asarray(count, np.uint32).ravel()
    odd = flat.size % 2
    if odd:
        flat = np.concatenate([flat, np.zeros(1, np.uint32)])
    half = flat.size // 2
    y0, y1 = _threefry2x32(k1, k2, flat[:half], flat[half:])
    out = np.concatenate([y0, y1])
    return (out[:-1] if odd else out).reshape(np.shape(count))


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the key hashed with the count
    ``threefry_seed(uint32(data))`` = ``[0, data]``."""
    return threefry_2x32(key, PRNGKey(int(data) & MASK32))


def _iota_2x32(shape: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    """``iota_2x32_shape``: the (hi, lo) words of each element's flat index."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32): the block hash of each
    element's (hi, lo) index words, its two outputs XORed."""
    shape = tuple(shape)
    y0, y1 = _threefry2x32(*_as_key(key), *_iota_2x32(shape))
    return y0 ^ y1


def _fma32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding, as XLA's CPU compile fuses
    ``_uniform``'s multiply and add. The float64 product is exact; the sum
    is rounded to odd (the error-free sum's residue decides the last bit),
    so the one rounding to float32 that follows is the correct one."""
    p = a.astype(np.float64) * np.float64(b)
    c = np.float64(c)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    fix = (err != 0) & ((s.view(np.uint64) & np.uint64(1)) == 0)
    s[fix] = np.nextafter(s[fix], np.copysign(np.inf, err[fix]))
    return s.astype(np.float32)


def uniform(key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, times ``maxval -
    minval`` plus ``minval`` (one fused rounding), clamped below at
    ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


def glorot_uniform(key, shape: Sequence[int]) -> np.ndarray:
    """flax's ``nn.initializers.glorot_uniform()`` over a kernel of ``shape``
    (in axis -2, out axis -1, the rest its receptive field), float32:
    ``uniform(-1, 1) * sqrt(3 * float32(2 / (fan_in + fan_out)))``."""
    rf = math.prod(shape) / shape[-2] / shape[-1]
    fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    return uniform(key, shape, -1.0) * np.sqrt(np.float32(3) * variance)


def fold_in_static(key, data: Iterable[Union[str, int]]) -> np.ndarray:
    """flax's ``_fold_in_static``: ``fold_in`` of the first 4 bytes
    (big-endian) of the SHA-1 of ``data``'s names (UTF-8) and ints
    (big-endian, ``(bit_length + 7) // 8`` bytes). Empty ``data``: ``key``."""
    data = tuple(data)
    if not data:
        return np.asarray(key)
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))
