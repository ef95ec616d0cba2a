"""JAX's default random-number stream in numpy: the threefry2x32 hash,
``PRNGKey``, ``split``, ``fold_in``, 32-bit ``random_bits``,
``permutation``, float32 ``uniform`` and ``rademacher``, as
``jax.random`` computes them with ``jax_threefry_partitionable`` on (the
default since JAX 0.5).

The port draws the same random numbers as the JAX package where its
results depend on them: fsc mode 1's pixel split permutes
``arange(l2 * d2)`` with ``permutation(PRNGKey(0), n)``, and the ard
model counts its symmetry rows with two ``uniform`` volumes and probes
its posterior diagonal with ``rademacher`` volumes.
``tests/test_torch_drivers.py`` holds every function here to
``jax.random``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "permutation", "uniform",
           "rademacher"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under key (2,) uint32; returns the two uint32 output words."""
    k1, k2 = (np.uint32(k) for k in key)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """The raw key (2,) uint32 of an integer seed in [0, 2^31), JAX's
    int32 seeds: (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError("PRNGKey: the seed must lie in [0, 2**31)")
    return np.asarray([0, seed], np.uint32)


def _counters(n: int):
    """The 64-bit iota 0..n-1 as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """num new keys (num, 2) uint32 from key."""
    b1, b2 = threefry2x32(key, *_counters(num))
    return np.stack([b1, b2], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """A new key (2,) uint32 from key and the integer data: the hash of
    the counter pair (0, data)."""
    b1, b2 = threefry2x32(key, [0], [np.uint32(data)])
    return np.concatenate([b1, b2])


def random_bits(key, n) -> np.ndarray:
    """Uniformly random uint32 words from key: n of them, or an array of
    shape n (the words of its row-major flat index)."""
    shape = (n,) if np.ndim(n) == 0 else tuple(n)
    b1, b2 = threefry2x32(key, *_counters(math.prod(shape)))
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """float32 uniform in [minval, maxval) of the given shape: the top 23
    bits of each word as the mantissa of a number in [1, 2), minus 1,
    scaled and shifted in float32."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def rademacher(key, shape) -> np.ndarray:
    """float32 +1 / -1 of the given shape: +1 where uniform(key) < 0.5."""
    return np.where(uniform(key, shape) < np.float32(0.5), np.float32(1.0), np.float32(-1.0))


def permutation(key, n: int) -> np.ndarray:
    """A random permutation of arange(n) (int64): ceil(3 ln n / ln(2^32 - 1))
    rounds of fresh 32-bit sort keys, each a stable sort that carries the
    values along."""
    x = np.arange(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(np.iinfo(np.uint32).max)))
    key = np.asarray(key, np.uint32)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x
