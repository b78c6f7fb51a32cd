"""The benchmark fixture: k well-separated Gaussian speakers.

The same generator as ``make_embeddings`` in the repository's ``bench.py``,
kept here so that the port's scripts need not import the JAX bench. Its
labels for ``make_embeddings(n)`` are recorded in
``benchmarks/reference_labels.npz`` under ``labels_{n}``.
"""

from __future__ import annotations

import numpy as np


def make_embeddings(n, d=256, k=2, seed=0):
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  labels = np.repeat(np.arange(k), n // k)
  return (centers[labels] + rng.randn(n, d) * 0.4).astype(np.float32)
