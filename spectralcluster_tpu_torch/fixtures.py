"""The benchmark fixtures: k well-separated Gaussian speakers.

``make_embeddings`` is the generator of the repository's ``bench.py`` and
``make_t2d_fixture`` the one of ``benchmarks/t2d_fixture.py``, copied here
so that the port's scripts need not import the JAX bench. Their labels are
recorded under ``labels_{n}`` in ``benchmarks/reference_labels.npz`` and
``benchmarks/reference_labels_t2d.npz``.
"""

from __future__ import annotations

import numpy as np


def make_embeddings(n, d=256, k=2, seed=0):
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  labels = np.repeat(np.arange(k), n // k)
  return (centers[labels] + rng.randn(n, d) * 0.4).astype(np.float32)


def make_t2d_fixture(n, d=256, k=4, seed=0):
  """Turn-to-Diarize fixture: (embeddings, speaker-turn scores, labels).

  k contiguous speaker blocks. A turn score relates segment i-1 to i:
  2.0 (cannot-link) at every speaker change, 0.5 (neutral) at odd i
  within a speaker, else 0.0 (must-link), for
  ``ConstraintMatrix(scores, threshold=1)``.
  """
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  labels = np.repeat(np.arange(k), n // k)
  if labels.size < n:  # n not divisible by k: pad with the last speaker
    labels = np.concatenate([labels, np.full(n - labels.size, k - 1)])
  x = (centers[labels] + rng.randn(n, d) * 0.4).astype(np.float32)
  scores = np.zeros(n)
  for i in range(1, n):
    if labels[i] != labels[i - 1]:
      scores[i] = 2.0       # cannot-link at every speaker change
    elif i % 2:
      scores[i] = 0.5       # neutral
    # else 0.0: must-link for half the within-speaker adjacencies
  return x, scores, labels
