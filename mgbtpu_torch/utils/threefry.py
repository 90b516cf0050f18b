"""The Threefry-2x32 counter-based generator and the Rademacher draw of the
JAX package, in numpy.

The V-cycle's Chebyshev smoother estimates lambda_max by power iteration
from ``jax.random.rademacher(jax.random.PRNGKey(1905), (n,), float64)``
(``mgbtpu/solver/newton.py``), and every V-cycle CG count depends on that
start vector. This module reproduces it bit for bit on the host, as JAX
draws it under x64 with ``jax_threefry_partitionable`` (JAX's default):

- the key of an integer seed is (seed >> 32, seed & 0xFFFFFFFF);
- 64 random bits per entry i are threefry2x32(key, (hi(i), lo(i))), the
  two output words joined high word first;
- a uniform in [0, 1) is the top 52 bits as the mantissa of a float in
  [1, 2), minus 1; a Bernoulli(0.5) draw is uniform < 0.5; a Rademacher
  value is 2 b - 1.

Threefry-2x32 is Salmon et al., "Parallel random numbers: as easy as
1, 2, 3" (SC 2011): 20 rounds with the rotations below and a key
injection every four rounds.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """The 2x32 hash of the counter pairs (x0, x1) (uint32 arrays) under
    ``key`` (two uint32 words); returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int):
    """The raw key of an integer seed, as ``jax.random.PRNGKey(seed)``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF))


def random_bits64(key, n: int) -> np.ndarray:
    """n 64-bit random words: entry i from the counter i split into its
    high and low 32-bit halves."""
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                              (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)


def uniform64(key, n: int) -> np.ndarray:
    """n float64 uniforms in [0, 1)."""
    bits = (random_bits64(key, n) >> np.uint64(64 - 52)) \
        | np.float64(1.0).view(np.uint64)
    return bits.view(np.float64) - 1.0


def rademacher(seed: int, n: int) -> np.ndarray:
    """``jax.random.rademacher(jax.random.PRNGKey(seed), (n,), float64)``
    under x64: n entries of +-1.0."""
    b = (uniform64(prng_key(seed), n) < 0.5).astype(np.float64)
    return 2 * b - 1
