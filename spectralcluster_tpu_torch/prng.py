"""The JAX package's random stream, in numpy.

JAX's default PRNG (threefry2x32, with the partitionable bit layout of
``jax_threefry_partitionable``) re-implemented bit for bit for the draws the
port must share with the JAX package: ``key(seed)`` is
``jax.random.PRNGKey(seed)``, ``split`` is ``jax.random.split``,
``gumbel`` is ``jax.random.gumbel`` in float32 (``jax.random.categorical``
is the argmax of logits plus these draws) and ``permutation`` is
``jax.random.permutation`` of an integer (``jax.random.choice`` without
replacement takes its first draws). K-Means++ and ``CustomKMeans``'s random
start seed from it, so the port picks the same starting centroids as the
JAX package for the same seed and the same shapes.
``tests/test_torch_ops.py`` holds each function against ``jax.random``.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
  return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
  """Threefry-2x32, 20 rounds (Salmon et al. 2011), on uint32 arrays."""
  k1, k2 = np.uint32(k1), np.uint32(k2)
  ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
  with np.errstate(over="ignore"):
    x1 = x1.astype(np.uint32) + ks[0]
    x2 = x2.astype(np.uint32) + ks[1]
    for i in range(5):
      for r in _ROTATIONS[i % 2]:
        x1 = x1 + x2
        x2 = _rotl(x2, r) ^ x1
      x1 = x1 + ks[(i + 1) % 3]
      x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
  return x1, x2


def key(seed: int) -> np.ndarray:
  """``jax.random.PRNGKey(seed)`` as a uint32 pair (JAX without x64 takes
  the seed's low 32 bits)."""
  return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _bits_pair(k: np.ndarray, size: int):
  """Both threefry words at flat counters 0..size-1."""
  counters = np.arange(size, dtype=np.uint64)
  hi = (counters >> np.uint64(32)).astype(np.uint32)
  lo = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
  return threefry2x32(k[0], k[1], hi, lo)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
  """``jax.random.split(k, num)``: (num, 2) uint32 keys."""
  b1, b2 = _bits_pair(k, num)
  return np.stack([b1, b2], axis=1)


def _bits32(k: np.ndarray, shape) -> np.ndarray:
  """``jax.random.bits(k, shape)``: 32-bit words, the xor of both
  threefry words (the partitionable layout)."""
  shape = tuple(shape)
  b1, b2 = _bits_pair(k, int(np.prod(shape, dtype=np.int64)))
  return (b1 ^ b2).reshape(shape)


def gumbel(k: np.ndarray, shape) -> np.ndarray:
  """``jax.random.gumbel(k, shape)`` in float32."""
  bits = _bits32(k, shape)
  one = np.array(1.0, np.float32).view(np.uint32)
  floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
  tiny = np.finfo(np.float32).tiny
  u = np.maximum(tiny, floats * (np.float32(1.0) - tiny) + tiny)
  return -np.log(-np.log(u))


def permutation(k: np.ndarray, n: int) -> np.ndarray:
  """``jax.random.permutation(k, n)`` for an integer n (int64 here).

  JAX shuffles by rounds of sorting: each round splits the key, draws one
  32-bit word per element and stable-sorts the elements by those words.
  The round count is JAX's static bound for a uniform shuffle despite word
  collisions, ceil(3·ln(max(1, n)) / ln(2³²−1)): 1 up to n=1625, then 2.
  """
  n = int(n)
  rounds = int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))
  x = np.arange(n, dtype=np.int64)
  for _ in range(rounds):
    k, sub = split(k)
    x = x[np.argsort(_bits32(sub, (n,)), kind="stable")]
  return x
