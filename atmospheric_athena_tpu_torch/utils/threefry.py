"""The counter-based Threefry-2x32 generator of JAX's default PRNG, in numpy:
``PRNGKey``, ``split`` and ``uniform``, bit for bit what
``jax.random.PRNGKey`` / ``split`` / ``uniform`` return with
``jax_threefry_partitionable`` on (the default of the JAX releases the JAX
package runs on), for the forms the problem generators use (a scalar
integer seed, a split into two keys, float32 or float64 draws in [0, 1)).

Threefry-2x32 is the 20-round ARX block cipher of Salmon et al. (2011),
"Parallel random numbers: as easy as 1, 2, 3": the key (k0, k1) and the
counter pair (x0, x1) go through five groups of four rounds with the key
injected between groups.  In the partitionable form a key's draws of
shape S hash the 64-bit row-major index of each element, split into its
high and low 32-bit words; a split into n keys hashes the indices 0..n-1
the same way.  Float draws take 64 (float64) or 32 (float32) random bits,
keep the mantissa's worth of high bits, set the exponent of [1, 2) and
subtract 1.
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash of the counter words (x0, x1) (uint32 arrays
    of one shape) under `key` (two uint32): two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for grp in range(5):
            for r in _ROT[grp % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(grp + 1) % 3]
            x1 = x1 + ks[(grp + 2) % 3] + np.uint32(grp + 1)
    return x0, x1


def prng_key(seed: int):
    """jax.random.PRNGKey(seed): (seed >> 32, seed & 0xFFFFFFFF) as
    uint32."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _iota_2x32(shape):
    """The row-major index of each element of `shape` as (high, low) uint32
    words."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key, num: int = 2):
    """jax.random.split(key, num): [num, 2] uint32 keys."""
    hi, lo = _iota_2x32((num,))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=1)


def uniform(key, shape, dtype=np.float64):
    """jax.random.uniform(key, shape, dtype) on [0, 1)."""
    dtype = np.dtype(dtype)
    hi, lo = _iota_2x32(tuple(shape))
    b0, b1 = threefry2x32(key, hi, lo)
    if dtype == np.float64:
        bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
        one = np.array(1.0, np.float64).view(np.uint64)
        fl = ((bits >> np.uint64(64 - 52)) | one).view(np.float64)
    elif dtype == np.float32:
        bits = b0 ^ b1
        one = np.array(1.0, np.float32).view(np.uint32)
        fl = ((bits >> np.uint32(32 - 23)) | one).view(np.float32)
    else:
        raise ValueError(f"uniform: float32 or float64, not {dtype}")
    return np.maximum(dtype.type(0.0), fl - dtype.type(1.0))
