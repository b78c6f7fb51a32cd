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
(``tools/record_batch_reference.py``). ``make_dc_spectrum`` builds the
symmetric test spectra of the JAX package's ``tests/test_eigen_dc.py``,
each from a seed of its own, on which ``tools/record_dc_reference.py``
records the JAX spectral divide-and-conquer in
``tests/data/reference_dc.npz``.
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


def _sym(n, eigs, seed):
  """A float64 symmetric matrix with eigenvalues ``eigs`` and a random
  orthogonal basis."""
  q, _ = np.linalg.qr(np.random.RandomState(seed).randn(n, n))
  return (q * np.asarray(eigs, np.float64)[None, :]) @ q.T


def _spread(n, seed):
  return np.random.RandomState(seed).randn(n) * 0.5


# name -> (maker of the float64 matrix, options of the solve). Options:
# descend, n_valid, max_block (default 128), and the solver constants a
# case patches (``patch``) or the range capture it degrades (``stub``:
# "first" loses the first draw's columns, "all" every draw's).
DC_SPECTRA = {
    "two_dominant_bulk": (
        lambda: _sym(512, np.concatenate([[260.0, 250.0], _spread(510, 1)]),
                     11), {}),
    "uniform_descend": (lambda: _sym(512, np.linspace(-5, 5, 512), 12), {}),
    "uniform_ascend": (lambda: _sym(512, np.linspace(-5, 5, 512), 12),
                       {"descend": False}),
    "padded_descend": (lambda: _padded(512, 400, np.linspace(-2, 7, 400), 13),
                       {"n_valid": 400}),
    "padded_ascend": (lambda: _padded(512, 400, np.linspace(-2, 7, 400), 13),
                      {"n_valid": 400, "descend": False}),
    # With the wall at 64 even the kept side's smallest block (128) is past
    # it: the subspace fallback answers. At 128 the deflated remainder does.
    "deflated_wall_64": (
        lambda: _sym(512, np.concatenate([[260.0, 250.0],
                                          np.full(510, 1e-3)]), 14),
        {"patch": {"_PROJECT_SPLIT_K": 64}}),
    "deflated_descend": (
        lambda: _sym(512, np.concatenate([[260.0, 250.0],
                                          np.full(510, 1e-3)]), 14),
        {"patch": {"_PROJECT_SPLIT_K": 128}}),
    "deflated_ascend": (
        lambda: _sym(512, np.concatenate([[-260.0, -250.0],
                                          np.full(510, -1e-3)]), 15),
        {"descend": False, "patch": {"_PROJECT_SPLIT_K": 128}}),
    "deflated_padded": (
        lambda: _sym(512, np.concatenate([[260.0, 250.0],
                                          np.full(510, 1e-3)]), 16),
        {"n_valid": 400, "patch": {"_PROJECT_SPLIT_K": 128}}),
    "deep_recursion": (lambda: _sym(512, np.linspace(0.1, 50, 512), 17),
                       {"max_block": 64}),
    "boundary_mode": (lambda: _boundary_mode(512, 18), {}),
    "negative_heavy": (
        lambda: _sym(512, np.concatenate([np.linspace(-50, -1, 504),
                                          np.linspace(1, 4, 8)]), 19), {}),
    "degenerate_at_mean": (
        lambda: _sym(512, np.concatenate([np.full(200, 1.0),
                                          np.full(112, 3.0),
                                          np.full(200, 5.0)]), 20), {}),
    "laplacian_like_ascend": (
        lambda: _sym(512, np.concatenate([[0.0, 1e-3, 2e-3],
                                          np.linspace(0.5, 2.0, 509)]), 21),
        {"descend": False}),
    "capture_redraw": (lambda: _two_bands(256, 22), {"stub": "first"}),
    "empty_basis": (lambda: _two_bands(256, 22), {"stub": "all"}),
    "wide_panel_dominant": (
        lambda: _sym(512, np.concatenate([[260.0, 250.0], _spread(510, 1)]),
                     11), {"patch": {"_QR_PANEL_MAX": 0}}),
    "wide_panel_uniform": (lambda: _sym(512, np.linspace(-5, 5, 512), 12),
                           {"patch": {"_QR_PANEL_MAX": 0}}),
}


def _padded(n, nv, eigs, seed):
  a = np.zeros((n, n))
  a[:nv, :nv] = _sym(nv, eigs, seed)
  return a


def _boundary_mode(n, seed):
  """An extreme-t eigenvalue exactly at the mean, the split point."""
  others = np.concatenate([[10.0, 9.0, 8.0, 7.0, 6.0, 5.0],
                           np.linspace(-5.2, -5.0, n - 7)])
  return _sym(n, np.concatenate([others, [others.sum() / (n - 1)]]), seed)


def _two_bands(n, seed):
  return _sym(n, np.concatenate([np.linspace(2.0, 3.0, 64),
                                 np.linspace(0.0, 0.1, n - 64)]), seed)


def make_dc_spectrum(name):
  """(float64 matrix, options) of the ``DC_SPECTRA`` case ``name``."""
  build, options = DC_SPECTRA[name]
  return build(), dict(options)
