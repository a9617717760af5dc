# Frozen copy of mppiisaac_tpu_torch/mppi/prng.py, part of the benchmark's yardstick.
"""The JAX package's random numbers, in numpy: its threefry-2x32 key, the key
split and the uniform and normal draws of `jax.random` (the default
partitionable layout), bit for bit. The planner's noise comes from here, so
the port and the JAX package draw the same noise for the same `seed_val`.

A key is a uint32 array of 2 words, as `jax.random.PRNGKey` makes it.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for 0 ≤ seed < 2³²."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under key."""
    ks = (key[0:1], key[1:2], key[0:1] ^ key[1:2] ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _bits(key: np.ndarray, n: int):
    """Both output words for the counters 0 .. n−1 (high word 0)."""
    return threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` → (num, 2) keys."""
    b0, b1 = _bits(key, num)
    return np.stack([b0, b1], axis=-1)


def _unit_floats(key: np.ndarray, n: int) -> np.ndarray:
    """n float32 in [0, 1): the 23 high bits of each 32-bit draw as a mantissa."""
    b0, b1 = _bits(key, n)
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def uniform(key: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _unit_floats(key, int(np.prod(shape, dtype=np.int64)))
    return np.maximum(lo, f * (hi - lo) + lo).reshape(shape)


def normal_uniforms(key: np.ndarray, shape) -> np.ndarray:
    """The uniforms in (−1, 1) whose √2·erfinv is `jax.random.normal(key,
    shape)` (the caller applies erfinv, in torch)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return uniform(key, shape, lo, 1.0)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for 0 ≤ data < 2³²: the key hashed
    with the 32-bit seed words (0, data)."""
    x0, x1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & 0xFFFFFFFF], np.uint32))
    return np.concatenate([x0, x1]).astype(np.uint32)
