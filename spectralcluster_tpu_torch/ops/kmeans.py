"""Custom-distance K-Means on tensors.

Port of ``spectralcluster_tpu/ops/kmeans.py``, with the host-facing
``CustomKMeans`` and ``run_kmeans`` (numpy in, numpy out):
  * k-means++ seeding (sklearn-style greedy local trials). The draws are
    ``jax.random.categorical``'s Gumbel-max samples from the JAX package's
    own stream (``prng.py``, threefry2x32 in numpy) for
    ``PRNGKey(generator.initial_seed())``, over the rows of the JAX
    package's shape bucket, made on the host and moved to the data's
    device in one copy: a CPU run, a card run and the JAX package pick the
    same starting centroids for the same seed (up to a last-ulp difference
    of float32 ``log`` between numpy and XLA).
  * Lloyd iterations with the reference's exact convergence rule
    (custom_distance_kmeans.py:120-133), evaluated on the device as the
    JAX package's ``lax.while_loop`` does: stop when the mean assigned
    distance is within (1 - tol) of the previous round's, or after
    max_iter + 1 rounds, and return that round's labels. Once stopped the
    centroids are frozen (``torch.where``), so the host reads the stop flag
    only every ``STOP_CHECK_ROUNDS`` rounds; the rounds run past the stop
    change nothing.
  * Fully masked: a number of clusters below the centroid count (surplus
    centroid columns get +inf distance) and weight-0 (padded) rows.
  * Batched (``kmeans_plusplus_batched``, ``lloyd_iterations_batched``,
    ``kmeans_fit_batched``): B utterances at once, (B, N, k) points, one
    key, cluster count, weight row and stop flag each, as the JAX
    package's vmap of ``kmeans_fit``. The Lloyd loop runs while any
    utterance is live, and a finished one is frozen. The single-utterance
    functions run the same code with no batch axis.
  * On the card, ``kmeans_fit`` and ``kmeans_fit_batched`` with the cosine
    metric run as one launch of kernel 8 (``kernels/fused.kmeans``, whose
    twin is this module's k-means++ and Lloyd loop): the draws are made on
    the card and Lloyd ends at its stopping round, with no host read
    (``takes_kernel`` says when). The CPU, the other metrics, callables,
    ``standard_lloyd`` and ``CustomKMeans`` run the eager code here.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from spectralcluster_tpu_torch import prng
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.ops import affinity as affinity_ops

# Lloyd rounds between two host reads of the stop flags on the eager path.
# It bounds the rounds run after every utterance has stopped (at most this
# many less one); a frozen state makes them change nothing, so it cannot
# change a label.
STOP_CHECK_ROUNDS = 16


def takes_kernel(x: torch.Tensor, custom_dist, k_max: int) -> bool:
  """Whether ``kmeans_fit`` (and its batched form) runs as kernel 8: float32
  rows on the card, the cosine metric, and k_max and the column count
  within the kernel's bound. Everything else runs the eager code."""
  return bool(x.is_cuda and x.dtype == torch.float32
              and isinstance(custom_dist, str)
              and custom_dist.lower() == "cosine"
              and k_max <= fused.KMEANS_MAX_WIDTH
              and x.shape[-1] <= fused.KMEANS_MAX_WIDTH)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """x[..., idx, :] per batch: (..., N, d) and (..., t) -> (..., t, d)."""
  return torch.take_along_dim(x, idx[..., :, None], dim=-2)


def _plusplus(x: torch.Tensor, k_max: int, keys: np.ndarray, w: torch.Tensor,
              rows: int) -> torch.Tensor:
  """Greedy k-means++ over x (N, d) or (B, N, d), one raw ``prng`` key per
  utterance in ``keys`` ((1, 2) or (B, 2)). Every Gumbel draw of every
  utterance is made on the host and moved to the device in one copy."""
  n, d = x.shape[-2:]
  batch = x.shape[:-2]
  trials = 2 + int(math.log(max(k_max, 1)))
  draws = []
  for key in keys:
    sub = prng.split(key, k_max + 1)
    draws.append(np.concatenate(
        [prng.gumbel(sub[0], (1, rows))[:, :n]]
        + [prng.gumbel(sub[j], (trials, rows))[:, :n]
           for j in range(1, k_max)]))
  g = torch.from_numpy(np.stack(draws)).to(x.device, x.dtype)
  g = g.reshape(batch + g.shape[1:])          # (..., 1 + (k_max-1)·trials, n)
  valid = w > 0

  c0 = torch.argmax(torch.log(w + 1e-30) + g[..., 0, :], dim=-1)
  centers = torch.zeros(batch + (k_max, d), dtype=x.dtype, device=x.device)
  first = _take_rows(x, c0[..., None])                     # (..., 1, d)
  centers[..., 0, :] = first[..., 0, :]
  closest = affinity_ops.cdist_sqeuclidean(x, first)[..., 0]
  closest = torch.where(valid, closest, 0.0)

  for j in range(1, k_max):
    logits = torch.where(valid, torch.log(closest + 1e-30), -torch.inf)
    gj = g[..., 1 + (j - 1) * trials:1 + j * trials, :]
    cand = torch.argmax(logits[..., None, :] + gj, dim=-1)  # (..., trials)
    picked = _take_rows(x, cand)                            # (..., trials, d)
    d_cand = affinity_ops.cdist_sqeuclidean(x, picked)      # (..., N, trials)
    new_closest = torch.minimum(closest[..., :, None], d_cand)
    new_closest = torch.where(valid[..., :, None], new_closest, 0.0)
    pots = torch.sum(new_closest * w[..., :, None], dim=-2)
    best = torch.argmin(pots, dim=-1)
    centers[..., j, :] = _take_rows(picked, best[..., None])[..., 0, :]
    closest = torch.take_along_dim(new_closest, best[..., None, None],
                                   dim=-1)[..., 0]
  return centers


def kmeans_plusplus(
    x: torch.Tensor,
    k_max: int,
    generator: torch.Generator,
    sample_weight: typing.Optional[torch.Tensor] = None,
    draw_rows: typing.Optional[int] = None,
    key: typing.Optional[np.ndarray] = None) -> torch.Tensor:
  """Greedy k-means++ seeding (sklearn-style local trials), seeded.

  Selection always uses squared-euclidean potentials, as in the reference,
  where sklearn's k-means++ initializes even custom-distance K-Means. The
  draws are the JAX package's for ``PRNGKey(generator.initial_seed())``
  (the generator names the seed and is not advanced), or for ``key``, a
  raw ``prng`` key that takes its place (a key the JAX caller split off),
  over ``draw_rows`` rows, by default ``utils.pad_bucket(N)``: the rows of
  the array the JAX package clusters, which pads to its shape bucket. Rows
  past N carry zero weight there and are never drawn. Returns (k_max, d)
  centers.
  """
  n = x.shape[0]
  w = torch.ones((n,), dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  if key is None:
    key = prng.key(generator.initial_seed())
  rows = utils.pad_bucket(n) if draw_rows is None else draw_rows
  return _plusplus(x, k_max, np.asarray(key, np.uint32)[None], w, rows)


def kmeans_plusplus_batched(
    x: torch.Tensor,
    k_max: int,
    keys,
    sample_weight: typing.Optional[torch.Tensor] = None,
    draw_rows: typing.Optional[int] = None) -> torch.Tensor:
  """k-means++ of B utterances, (B, N, d) -> (B, k_max, d).

  ``keys`` is (B, 2) uint32 JAX key data (``prng.key(seed + i)`` for
  JAX's ``PRNGKey(seed + i)``); utterance b draws what ``kmeans_plusplus``
  draws for ``key=keys[b]``, over ``draw_rows`` rows (default
  ``utils.pad_bucket(N)``) of its (B, N) ``sample_weight``.
  """
  b, n = x.shape[:2]
  keys = np.asarray(keys, np.uint32).reshape(b, 2)
  w = torch.ones((b, n), dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  rows = utils.pad_bucket(n) if draw_rows is None else draw_rows
  return _plusplus(x, k_max, keys, w, rows)


def _update_centroids(x, labels, w, c):
  """Weighted segment means; empty clusters keep their centroid (and make
  no 0/0 on the way, so ``sanity.debug_nans`` stays quiet)."""
  k_max = c.shape[-2]
  onehot = (labels[..., :, None] == torch.arange(k_max, device=x.device))
  onehot = onehot.to(x.dtype) * w[..., :, None]
  counts = torch.sum(onehot, dim=-2)
  sums = torch.matmul(onehot.transpose(-1, -2), x)
  filled = counts[..., :, None] > 0
  return torch.where(filled, sums / torch.where(filled, counts[..., :, None],
                                                1.0), c)


def _all_stopped(live: torch.Tensor, rounds: int, max_rounds: int,
                 check_every: int) -> bool:
  """Whether the loop may end after ``rounds`` rounds. By ``max_rounds``
  every state has stopped, which needs no read; before it, the flags are
  read on the host every ``check_every`` rounds only."""
  if rounds >= max_rounds:
    return True
  return rounds % check_every == 0 and not bool(live.any())


def _lloyd(x, centroids, n_clusters, dist_fn, max_iter, tol, w,
           check_every=STOP_CHECK_ROUNDS, timings=None):
  """The Lloyd loop of ``lloyd_iterations`` over x (N, d) or a batch
  (B, N, d), with the JAX package's stop rule on the device. Returns
  (labels int32, centroids, rounds): ``rounds`` is each state's number of
  assignment rounds, the stopping one included. ``timings`` (an
  observability.StageTimings) counts the rounds the host ran, the stopping
  one up to the next read of the flags, as "lloyd_rounds".

  A stopped state keeps its centroids, so every later round assigns its
  points exactly as its stopping round did: its labels and mean distance
  need no freezing. Every live state has run every round, so JAX's
  ``it >= max_iter`` is the host's round count, and the per-state count
  is kept only to be returned. Each round is a fixed sequence of device
  ops; the host reads the live flags every ``check_every`` rounds.
  """
  k_max = centroids.shape[-2]
  batch = x.shape[:-2]
  w_total = torch.sum(w, dim=-1)
  weighted = w > 0
  col_ok = utils.valid_mask(k_max, n_clusters, x.device)[..., None, :]

  it = torch.zeros(batch, dtype=torch.int32, device=x.device)
  prev = torch.zeros(batch, dtype=x.dtype, device=x.device)
  live = torch.ones(batch, dtype=torch.bool, device=x.device)
  c = centroids
  for rounds in range(1, max_iter + 2):
    dist = torch.where(col_ok, dist_fn(x, c), torch.inf)
    labels = torch.argmin(dist, dim=-1)
    mind = torch.amin(dist, dim=-1)
    mean_dist = torch.sum(torch.where(weighted, mind, 0.0) * w,
                          dim=-1) / w_total
    it.add_(live)
    if rounds > max_iter:  # JAX's it >= max_iter: every state stops
      break
    stop = (mean_dist <= prev) & (mean_dist >= (1.0 - tol) * prev)
    live = live & ~stop
    c = torch.where(live[..., None, None],
                    _update_centroids(x, labels, w, c), c)
    prev = mean_dist
    if _all_stopped(live, rounds, max_iter + 1, check_every):
      break
  if timings is not None:
    timings.count("lloyd_rounds", rounds)
  return labels.to(torch.int32), c, it


def lloyd_iterations(
    x: torch.Tensor,
    centroids: torch.Tensor,
    n_clusters,
    dist_fn: typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    max_iter: int = 10,
    tol: float = 0.001,
    sample_weight: typing.Optional[torch.Tensor] = None,
    timings=None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Reference CustomKMeans.predict semantics. Returns (labels, centroids).

  ``n_clusters`` (int or 0-dim tensor, <= centroids.shape[0]) masks the
  surplus centroid slots out of the assignment. ``torch.argmin`` returns the
  first minimal index, as ``jnp.argmin`` does, so ties break alike.
  ``timings`` counts the rounds run (see ``_lloyd``).
  """
  w = torch.ones(x.shape[:1], dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  labels, c, _ = _lloyd(x, centroids, n_clusters, dist_fn, max_iter, tol, w,
                        timings=timings)
  return labels, c


def lloyd_iterations_batched(
    x: torch.Tensor,
    centroids: torch.Tensor,
    n_clusters: torch.Tensor,
    dist_fn: typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    max_iter: int = 10,
    tol: float = 0.001,
    sample_weight: typing.Optional[torch.Tensor] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """``lloyd_iterations`` of B utterances at once: x (B, N, k), centroids
  (B, k_max, k), n_clusters (B,), sample_weight (B, N), ``dist_fn`` over
  (B, N, k) and (B, k_max, k) (``affinity.get_batched_distance_fn``).
  Returns (labels (B, N), centroids, rounds (B,)); utterance b's labels,
  centroids and rounds are those of ``lloyd_iterations`` on it alone."""
  w = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  return _lloyd(x, centroids, n_clusters, dist_fn, max_iter, tol, w)


def standard_lloyd(
    x: torch.Tensor,
    centroids: torch.Tensor,
    n_clusters,
    max_iter: int = 300,
    tol: float = 1e-4,
    sample_weight: typing.Optional[torch.Tensor] = None,
    timings=None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Plain euclidean Lloyd (the reference's `custom_dist falsy` sklearn branch,
  custom_distance_kmeans.py:33-36): run until centers move < tol or max_iter.

  x (N, d) or a batch (B, N, d). The stop flag stays on the device and
  freezes its centroids; the host reads it every ``STOP_CHECK_ROUNDS``
  rounds. ``timings`` counts the rounds the host ran as "lloyd_rounds".
  """
  k_max = centroids.shape[-2]
  w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  col_ok = utils.valid_mask(k_max, n_clusters, x.device)[..., None, :]

  def assign(c):
    dist = affinity_ops.cdist_sqeuclidean(x, c)
    return torch.argmin(torch.where(col_ok, dist, torch.inf), dim=-1)

  c = centroids
  live = torch.ones(x.shape[:-2], dtype=torch.bool, device=x.device)
  it = -1
  for it in range(max_iter):
    new_c = _update_centroids(x, assign(c), w, c)
    shift = torch.sum((new_c - c) ** 2, dim=(-2, -1))
    c = torch.where(live[..., None, None], new_c, c)
    live = live & ~(shift < tol)
    if _all_stopped(live, it + 1, max_iter, STOP_CHECK_ROUNDS):
      break
  if timings is not None:
    timings.count("lloyd_rounds", it + 1)
  return assign(c).to(torch.int32), c


def kmeans_fit(
    x: torch.Tensor,
    n_clusters,
    generator: torch.Generator,
    custom_dist: typing.Union[str, typing.Callable, None] = "cosine",
    max_iter: int = 10,
    tol: float = 0.001,
    k_max: typing.Optional[int] = None,
    sample_weight: typing.Optional[torch.Tensor] = None,
    draw_rows: typing.Optional[int] = None,
    key: typing.Optional[np.ndarray] = None,
    timings=None,
) -> torch.Tensor:
  """Full K-Means: seeded k-means++ init, then Lloyd with the chosen metric.

  Mirrors reference run_kmeans (custom_distance_kmeans.py:13-52): falsy
  ``custom_dist`` means plain euclidean K-Means with max_iter=300; otherwise
  k-means++ provides the initial centroids for the custom-distance loop.
  ``k_max`` is the centroid count when ``n_clusters`` is a tensor;
  ``draw_rows`` and ``key`` go to ``kmeans_plusplus`` (with ``key``,
  ``generator`` may be None); ``timings`` counts Lloyd's rounds
  ("lloyd_rounds": under kernel 8 its device count, read when the call's
  counters are) and whether kernel 8 ran ("kmeans_kernel", 1 or 0).
  """
  if k_max is None:
    k_max = int(n_clusters)
  kernel = takes_kernel(x, custom_dist, k_max)
  if timings is not None:
    timings.count("kmeans_kernel", int(kernel))
  if kernel:
    if key is None:
      key = prng.key(generator.initial_seed())
    labels, _, rounds = fused.kmeans(x, n_clusters, key, k_max,
                                     sample_weight, draw_rows, max_iter, tol)
    if timings is not None:
      timings.count("lloyd_rounds", rounds)
    return labels
  centroids = kmeans_plusplus(x, k_max, generator, sample_weight, draw_rows,
                              key)
  if not custom_dist:
    labels, _ = standard_lloyd(x, centroids, n_clusters, max_iter=300,
                               sample_weight=sample_weight, timings=timings)
    return labels
  dist_fn = affinity_ops.get_distance_fn(custom_dist)
  labels, _ = lloyd_iterations(x, centroids, n_clusters, dist_fn,
                               max_iter=max_iter, tol=tol,
                               sample_weight=sample_weight, timings=timings)
  return labels


def kmeans_fit_batched(
    x: torch.Tensor,
    n_clusters: torch.Tensor,
    keys,
    custom_dist: typing.Union[str, typing.Callable, None] = "cosine",
    max_iter: int = 10,
    tol: float = 0.001,
    k_max: typing.Optional[int] = None,
    sample_weight: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """``kmeans_fit`` of B utterances: x (B, N, k), n_clusters (B,), keys
  (B, 2) JAX key data, sample_weight (B, N) -> labels (B, N) int32, as the
  JAX package's vmap of ``kmeans_fit``. ``k_max`` defaults to the widest
  count (read on the host)."""
  if k_max is None:
    k_max = int(torch.max(n_clusters))
  if takes_kernel(x, custom_dist, k_max):
    return fused.kmeans(x, n_clusters, keys, k_max, sample_weight,
                        max_iter=max_iter, tol=tol)[0]
  centroids = kmeans_plusplus_batched(x, k_max, keys, sample_weight)
  if not custom_dist:
    labels, _ = standard_lloyd(x, centroids, n_clusters, max_iter=300,
                               sample_weight=sample_weight)
    return labels
  dist_fn = affinity_ops.get_batched_distance_fn(custom_dist)
  labels, _, _ = lloyd_iterations_batched(x, centroids, n_clusters, dist_fn,
                                          max_iter=max_iter, tol=tol,
                                          sample_weight=sample_weight)
  return labels


class CustomKMeans:
  """API-parity shell for the reference's CustomKMeans dataclass
  (custom_distance_kmeans.py:55-141): hold config + optional initial
  centroids, cluster with .predict() on ``device`` (numpy in, numpy out).
  """

  def __init__(self,
               n_clusters: typing.Optional[int] = None,
               centroids=None,
               max_iter: int = 10,
               tol: float = 0.001,
               custom_dist: typing.Union[str, typing.Callable] = "cosine",
               seed: int = 0,
               device: typing.Union[str, torch.device] = "cuda"):
    self.n_clusters = n_clusters
    self.centroids = centroids
    self.max_iter = max_iter
    self.tol = tol
    self.custom_dist = custom_dist
    self.seed = seed
    self.device = device

  def predict(self, embeddings) -> np.ndarray:
    x = torch.as_tensor(np.asarray(embeddings, np.float32)).to(
        utils.resolve_device(self.device))
    n_samples = x.shape[0]
    if self.max_iter <= 0:
      raise ValueError("Number of iterations should be a positive number,"
                       " got %d instead" % self.max_iter)
    if n_samples < self.n_clusters:
      raise ValueError("n_samples=%d should be >= n_clusters=%d" %
                       (n_samples, self.n_clusters))
    if self.centroids is None:
      # The reference draws unseeded; this draw is seeded: the JAX
      # package's jax.random.choice(PRNGKey(seed), n, (k,), replace=False).
      idx = prng.permutation(prng.key(self.seed), n_samples)[:self.n_clusters]
      centroids = x[torch.from_numpy(idx).to(x.device)]
    else:
      centroids = torch.as_tensor(np.asarray(self.centroids, np.float32)).to(
          x.device)
      if centroids.shape[0] != self.n_clusters:
        raise ValueError("The shape of the initial centroids (%s)"
                         "does not match the number of clusters %d" %
                         (str(tuple(centroids.shape)), self.n_clusters))
      if centroids.shape[1] != x.shape[1]:
        raise ValueError(
            "The number of features of the initial centroids %d"
            "does not match the number of features of the data %d." %
            (centroids.shape[1], x.shape[1]))
    labels, final = lloyd_iterations(
        x, centroids, self.n_clusters,
        affinity_ops.get_distance_fn(self.custom_dist),
        max_iter=self.max_iter, tol=self.tol)
    self.centroids = final.cpu().numpy()
    return labels.cpu().numpy()


def run_kmeans(spectral_embeddings,
               n_clusters: int,
               custom_dist: typing.Union[str, typing.Callable],
               max_iter: int,
               generator: typing.Optional[torch.Generator] = None,
               device: typing.Union[str, torch.device] = "cuda") -> np.ndarray:
  """Drop-in replacement for reference run_kmeans — the injectable
  ``post_eigen_cluster_function`` contract (spectral_clusterer.py:82-84).

  Runs on ``device`` at the input's exact shape: eager PyTorch does not
  recompile per shape, so the JAX package's row padding has no purpose
  here (and mahalanobis and callables must not see padded rows). The
  k-means++ draws still cover the rows the JAX package clusters: its shape
  bucket for row-local metrics, the exact N otherwise. The optional
  ``generator`` names the seed of those draws; it defaults to seed 0, the
  analog of the reference's random_state=0.
  """
  x = torch.as_tensor(np.asarray(spectral_embeddings, np.float32)).to(
      utils.resolve_device(device))
  if generator is None:
    generator = torch.Generator().manual_seed(0)
  padded = not custom_dist or (isinstance(custom_dist, str)
                               and custom_dist != "mahalanobis")
  labels = kmeans_fit(x, int(n_clusters), generator, custom_dist=custom_dist,
                      max_iter=int(max_iter), tol=0.001,
                      draw_rows=None if padded else x.shape[0])
  return labels.cpu().numpy()
