"""Custom-distance K-Means on tensors.

Port of ``spectralcluster_tpu/ops/kmeans.py``, with the host-facing
``CustomKMeans`` and ``run_kmeans`` (numpy in, numpy out):
  * k-means++ seeding (sklearn-style greedy local trials). The draws are
    ``jax.random.categorical``'s Gumbel-max samples from the JAX package's
    own stream (``prng.py``, threefry2x32 in numpy) for
    ``PRNGKey(generator.initial_seed())``, over the rows of the JAX
    package's shape bucket, made on the host and moved to the data's
    device: a CPU run, a card run and the JAX package pick the same
    starting centroids for the same seed (up to a last-ulp difference of
    float32 ``log`` between numpy and XLA).
  * Lloyd iterations with the reference's exact convergence rule
    (custom_distance_kmeans.py:120-133), as a Python loop that reads one
    scalar per round: stop when the mean assigned distance is within
    (1 - tol) of the previous round's, or after max_iter + 1 rounds, and
    return that round's labels.
  * Fully masked: a number of clusters below the centroid count (surplus
    centroid columns get +inf distance) and weight-0 (padded) rows.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from spectralcluster_tpu_torch import prng
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.ops import affinity as affinity_ops


def kmeans_plusplus(
    x: torch.Tensor,
    k_max: int,
    generator: torch.Generator,
    sample_weight: typing.Optional[torch.Tensor] = None,
    draw_rows: typing.Optional[int] = None) -> torch.Tensor:
  """Greedy k-means++ seeding (sklearn-style local trials), seeded.

  Selection always uses squared-euclidean potentials, as in the reference,
  where sklearn's k-means++ initializes even custom-distance K-Means. The
  draws are the JAX package's for ``PRNGKey(generator.initial_seed())``
  (the generator names the seed and is not advanced) over ``draw_rows``
  rows, by default ``utils.pad_bucket(N)``: the rows of the array the JAX
  package clusters, which pads to its shape bucket. Rows past N carry zero
  weight there and are never drawn. Returns (k_max, d) centers.
  """
  n, d = x.shape
  w = torch.ones((n,), dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  valid = w > 0
  rows = utils.pad_bucket(n) if draw_rows is None else draw_rows
  keys = prng.split(prng.key(generator.initial_seed()), k_max + 1)

  def gumbel(j, shape):
    g = prng.gumbel(keys[j], shape + (rows,))[..., :n]
    return torch.from_numpy(g).to(x.device, x.dtype)

  c0 = torch.argmax(torch.log(w + 1e-30) + gumbel(0, ()))
  centers = torch.zeros((k_max, d), dtype=x.dtype, device=x.device)
  centers[0] = x[c0]
  closest = affinity_ops.cdist_sqeuclidean(x, x[c0][None, :])[:, 0]
  closest = torch.where(valid, closest, 0.0)
  trials = 2 + int(math.log(max(k_max, 1)))

  for j in range(1, k_max):
    logits = torch.where(valid, torch.log(closest + 1e-30), -torch.inf)
    cand = torch.argmax(logits[None, :] + gumbel(j, (trials,)), dim=1)
    d_cand = affinity_ops.cdist_sqeuclidean(x, x[cand])     # (N, trials)
    new_closest = torch.minimum(closest[:, None], d_cand)
    new_closest = torch.where(valid[:, None], new_closest, 0.0)
    pots = torch.sum(new_closest * w[:, None], dim=0)
    best = torch.argmin(pots)
    centers[j] = x[cand[best]]
    closest = new_closest[:, best]
  return centers


def _update_centroids(x, labels, w, c):
  """Weighted segment means; empty clusters keep their centroid."""
  k_max = c.shape[0]
  onehot = (labels[:, None] == torch.arange(k_max, device=x.device)[None, :])
  onehot = onehot.to(x.dtype) * w[:, None]
  counts = torch.sum(onehot, dim=0)
  sums = torch.matmul(onehot.T, x)
  return torch.where(counts[:, None] > 0, sums / counts[:, None], c)


def lloyd_iterations(
    x: torch.Tensor,
    centroids: torch.Tensor,
    n_clusters,
    dist_fn: typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    max_iter: int = 10,
    tol: float = 0.001,
    sample_weight: typing.Optional[torch.Tensor] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Reference CustomKMeans.predict semantics. Returns (labels, centroids).

  ``n_clusters`` (int or 0-dim tensor, <= centroids.shape[0]) masks the
  surplus centroid slots out of the assignment. ``torch.argmin`` returns the
  first minimal index, as ``jnp.argmin`` does, so ties break alike.
  """
  n = x.shape[0]
  k_max = centroids.shape[0]
  w = torch.ones((n,), dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  w_total = torch.sum(w)
  col_ok = torch.arange(k_max, device=x.device) < n_clusters

  it = 0
  prev = torch.zeros((), dtype=x.dtype, device=x.device)
  c = centroids
  while True:
    dist = torch.where(col_ok[None, :], dist_fn(x, c), torch.inf)
    labels = torch.argmin(dist, dim=1)
    mind = torch.amin(dist, dim=1)
    mean_dist = torch.sum(torch.where(w > 0, mind, 0.0) * w) / w_total
    stop = bool((mean_dist <= prev) & (mean_dist >= (1.0 - tol) * prev)) or (
        it >= max_iter)
    if stop:
      return labels.to(torch.int32), c
    c = _update_centroids(x, labels, w, c)
    prev = mean_dist
    it += 1


def standard_lloyd(
    x: torch.Tensor,
    centroids: torch.Tensor,
    n_clusters,
    max_iter: int = 300,
    tol: float = 1e-4,
    sample_weight: typing.Optional[torch.Tensor] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Plain euclidean Lloyd (the reference's `custom_dist falsy` sklearn branch,
  custom_distance_kmeans.py:33-36): run until centers move < tol or max_iter."""
  n = x.shape[0]
  k_max = centroids.shape[0]
  w = torch.ones((n,), dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  col_ok = torch.arange(k_max, device=x.device) < n_clusters

  def assign(c):
    dist = affinity_ops.cdist_sqeuclidean(x, c)
    return torch.argmin(torch.where(col_ok[None, :], dist, torch.inf), dim=1)

  c = centroids
  for it in range(max_iter):
    new_c = _update_centroids(x, assign(c), w, c)
    shift = torch.sum((new_c - c) ** 2)
    c = new_c
    if bool(shift < tol) or it + 1 >= max_iter:
      break
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
) -> torch.Tensor:
  """Full K-Means: seeded k-means++ init, then Lloyd with the chosen metric.

  Mirrors reference run_kmeans (custom_distance_kmeans.py:13-52): falsy
  ``custom_dist`` means plain euclidean K-Means with max_iter=300; otherwise
  k-means++ provides the initial centroids for the custom-distance loop.
  ``k_max`` is the centroid count when ``n_clusters`` is a tensor;
  ``draw_rows`` goes to ``kmeans_plusplus``.
  """
  if k_max is None:
    k_max = int(n_clusters)
  centroids = kmeans_plusplus(x, k_max, generator, sample_weight, draw_rows)
  if not custom_dist:
    labels, _ = standard_lloyd(x, centroids, n_clusters, max_iter=300,
                               sample_weight=sample_weight)
    return labels
  dist_fn = affinity_ops.get_distance_fn(custom_dist)
  labels, _ = lloyd_iterations(x, centroids, n_clusters, dist_fn,
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
