"""The benchmark fixtures: k well-separated Gaussian speakers.

``make_embeddings`` is the generator of the repository's ``bench.py``,
``make_embeddings_k`` the one of ``benchmarks/bench_multispeaker.py``,
``make_t2d_fixture`` the one of ``benchmarks/t2d_fixture.py``,
``make_stream`` the stream of ``benchmarks/bench_streaming.py`` and
``make_batch`` the utterances of ``benchmarks/bench_batch.py``, copied here
so that the port's scripts need not import the JAX benches. Their labels are
recorded under ``labels_{n}`` in ``benchmarks/reference_labels.npz`` and
``benchmarks/reference_labels_t2d.npz``, under ``labels_{n}_k{k}`` in
``benchmarks/reference_labels_multi.npz``, the stream's label histories
in ``tests/data/reference_streaming.npz``
(``tools/record_streaming_reference.py``) and the JAX package's batch
labels in ``tests/data/reference_batch.npz``
(``tools/record_batch_reference.py``).
"""

from __future__ import annotations

import numpy as np


def make_embeddings(n, d=256, k=2, seed=0):
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  labels = np.repeat(np.arange(k), n // k)
  return (centers[labels] + rng.randn(n, d) * 0.4).astype(np.float32)


def make_embeddings_k(n, k, d=256, seed=0):
  """k block-ordered speakers, the last block short when k does not divide
  n. Returns (embeddings, labels)."""
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  labels = np.repeat(np.arange(k), -(-n // k))[:n]
  return (centers[labels] + rng.randn(n, d) * 0.4).astype(np.float32), labels


def make_stream(n_steps, d=64, k=4, seed=0):
  """A stream of n_steps float64 embeddings, each from one of k speakers
  drawn at random. Returns (stream, speakers)."""
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  speakers = rng.randint(0, k, size=n_steps)
  return centers[speakers] + rng.randn(n_steps, d) * 0.3, speakers


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


def make_batch(batch, n=1024, d=256, seed=0):
  """The utterances of the JAX batch bench: utterance i has 2 + i % 3
  block-ordered speakers (the last block short when they do not divide n).
  Returns (utterances, labels), two lists; the first 16 of a longer batch
  are the 16 of a shorter one."""
  rng = np.random.RandomState(seed)
  utts, truths = [], []
  for i in range(batch):
    k = 2 + (i % 3)
    centers = rng.randn(k, d) * 3
    labels = np.repeat(np.arange(k), -(-n // k))[:n]
    utts.append((centers[labels] + rng.randn(n, d) * 0.4).astype(np.float32))
    truths.append(labels)
  return utts, truths
