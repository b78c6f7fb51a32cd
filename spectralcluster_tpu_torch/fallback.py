"""Fallback clusterers and the single-cluster decision.

Port of ``spectralcluster_tpu/fallback.py``, which replaces reference
naive_clusterer.py and fallback_clusterer.py:
  * NaiveClusterer — sequential threshold clustering with running-mean
    centroids (naive_clusterer.py:25-105), on the host in float64;
  * naive_predict_scan — the same clustering with a fixed-size float32
    cluster bank, as the JAX ``lax.scan`` form computes it, as a loop of
    tensor ops on the embeddings' device;
  * FallbackClusterer — AHC (threshold cut) or Naive for tiny inputs
    (fallback_clusterer.py:95-124), with the reference's missing ``raise``
    for unknown types restored;
  * check_single_cluster — all five SingleClusterCondition variants
    (fallback_clusterer.py:127-187), the GMM-BIC test by ops/gmm.py.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from spectralcluster_tpu_torch import ahc
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.ops import gmm as gmm_ops
from spectralcluster_tpu_torch.types import (FallbackClustererType,
                                             FallbackOptions,
                                             SingleClusterCondition)


class NaiveClusterer:
  """Online threshold clustering with running-mean centroids."""

  def __init__(self,
               threshold: float,
               adaptation_threshold: typing.Optional[float] = None):
    self.threshold = threshold
    if adaptation_threshold is None:
      self.adaptation_threshold = threshold
    elif adaptation_threshold < threshold:
      raise ValueError("adaptation_threshold cannot be smaller than threshold")
    else:
      self.adaptation_threshold = adaptation_threshold
    self.centroids: typing.List[np.ndarray] = []
    self.counts: typing.List[int] = []

  def reset(self):
    self.centroids = []
    self.counts = []

  def predict_next(self, embedding: np.ndarray) -> int:
    embedding = np.asarray(embedding, dtype=np.float64).reshape(-1)
    if not self.centroids:
      self.centroids.append(embedding.copy())
      self.counts.append(1)
      return 0
    bank = np.stack(self.centroids)
    sims = (bank @ embedding) / (
        np.linalg.norm(bank, axis=1) * np.linalg.norm(embedding))
    if sims.max() < self.threshold:
      self.centroids.append(embedding.copy())
      self.counts.append(1)
      return len(self.centroids) - 1
    label = int(sims.argmax())
    if sims[label] > self.adaptation_threshold:
      c, k = self.centroids[label], self.counts[label]
      self.centroids[label] = (c * k + embedding) / (k + 1)
      self.counts[label] = k + 1
    return label

  def predict(self, embeddings: np.ndarray) -> np.ndarray:
    return np.array([self.predict_next(e) for e in np.asarray(embeddings)])

  def fit_predict(self, embeddings: np.ndarray) -> np.ndarray:
    return self.predict(embeddings)


def naive_predict_scan(embeddings: torch.Tensor,
                       threshold: float,
                       adaptation_threshold: typing.Optional[float] = None,
                       max_clusters: typing.Optional[int] = None
                       ) -> torch.Tensor:
  """Batch naive clustering over a fixed (max_clusters, d) float32 bank.

  One step per row, on the embeddings' device, reading nothing back to the
  host. Matches NaiveClusterer.predict as long as the stream produces
  <= max_clusters clusters (extra clusters clamp to the last slot).
  Returns int32 labels on the embeddings' device.
  """
  if adaptation_threshold is None:
    adaptation_threshold = threshold
  x = torch.as_tensor(embeddings, dtype=torch.float32)
  n, d = x.shape
  k_max = max_clusters if max_clusters is not None else n
  dev = x.device
  slots = torch.arange(k_max, device=dev)
  bank = torch.zeros((k_max, d), dtype=torch.float32, device=dev)
  counts = torch.zeros((k_max,), dtype=torch.float32, device=dev)
  n_live = torch.zeros((), dtype=torch.int64, device=dev)
  labels = torch.zeros((n,), dtype=torch.int64, device=dev)
  for i in range(n):
    e = x[i]
    sims = (bank @ e) / (torch.linalg.norm(bank, dim=1) * torch.linalg.norm(e)
                         + 1e-30)
    sims = torch.where(slots < n_live, sims, -torch.inf)
    best = torch.argmax(sims)
    best_sim = sims[best]
    is_new = (best_sim < threshold) | (n_live == 0)
    label = torch.where(is_new, torch.clamp_max(n_live, k_max - 1), best)
    adapt = (~is_new) & (best_sim > adaptation_threshold)
    cnt = counts[label]
    merged = (bank[label] * cnt + e) / (cnt + 1.0)
    bank[label] = torch.where(is_new, e, torch.where(adapt, merged,
                                                     bank[label]))
    counts[label] = torch.where(is_new, 1.0, torch.where(adapt, cnt + 1.0,
                                                         cnt))
    n_live = torch.where(is_new, torch.clamp_max(n_live + 1, k_max), n_live)
    labels[i] = label
  return labels.to(torch.int32)


# At this size and above the naive fallback runs as naive_predict_scan, as
# in the JAX package; below it, the host loop.
_NAIVE_SCAN_MIN_N = 256


class FallbackClusterer:
  """Dispatch to AHC (threshold cut) or Naive clustering for tiny inputs.

  ``device`` serves naive_predict_scan (inputs of 256 rows and more); the
  other routes run on the host.
  """

  def __init__(self, options: FallbackOptions,
               device: typing.Union[str, torch.device] = "cuda"):
    self.options = options
    self.device = device
    if options.fallback_clusterer_type not in (
        FallbackClustererType.Agglomerative, FallbackClustererType.Naive):
      raise ValueError("Unsupported fallback_clusterer_type")

  def predict(self, embeddings: np.ndarray) -> np.ndarray:
    embeddings = np.asarray(embeddings)
    if embeddings.shape[0] == 1:
      return np.zeros(1, dtype=np.int64)
    if (self.options.fallback_clusterer_type ==
        FallbackClustererType.Agglomerative):
      return ahc.agglomerative_cluster(
          embeddings, metric="cosine", linkage="average",
          distance_threshold=self.options.agglomerative_threshold)
    clusterer = NaiveClusterer(
        threshold=self.options.naive_threshold,
        adaptation_threshold=self.options.naive_adaptation_threshold)
    if embeddings.shape[0] >= _NAIVE_SCAN_MIN_N:
      x = torch.as_tensor(np.asarray(embeddings, np.float32)).to(
          utils.resolve_device(self.device))
      labels = naive_predict_scan(
          x, threshold=clusterer.threshold,
          adaptation_threshold=clusterer.adaptation_threshold)
      return labels.cpu().numpy().astype(np.int64)
    return clusterer.fit_predict(embeddings)

  def fit_predict(self, embeddings: np.ndarray) -> np.ndarray:
    return self.predict(embeddings)


def check_single_cluster(fallback_options: FallbackOptions,
                         embeddings: typing.Optional[np.ndarray],
                         affinity) -> bool:
  """Single-vs-multi cluster decision; called only when min_clusters == 1.

  Reference fallback_clusterer.py:127-187 semantics for all five
  conditions. ``affinity`` is a numpy array or a tensor; the GMM-BIC test
  and the FallbackClusterer condition run on its device.
  """
  aff = torch.as_tensor(affinity)
  opts = fallback_options
  cond = opts.single_cluster_condition
  if cond == SingleClusterCondition.AllAffinity:
    return bool(torch.amin(aff) > opts.single_cluster_affinity_threshold)
  elif cond == SingleClusterCondition.NeighborAffinity:
    neighbor = torch.diagonal(aff, 1)
    return bool(torch.amin(neighbor) > opts.single_cluster_affinity_threshold)
  elif cond == SingleClusterCondition.AffinityStd:
    return bool(torch.std(aff, correction=0)
                < opts.single_cluster_affinity_threshold)
  elif cond == SingleClusterCondition.AffinityGmmBic:
    offset = opts.single_cluster_affinity_diagonal_offset
    n = aff.shape[0]
    if offset >= n - 1:
      raise ValueError(
          "single_cluster_affinity_diagonal_offset must be significantly "
          "smaller than affinity matrix dimension")
    rows, cols = torch.triu_indices(n, n, offset, device=aff.device)
    upper = aff[rows, cols]
    bic1 = gmm_ops.gmm_bic_1d(upper, 1)
    bic2 = gmm_ops.gmm_bic_1d(upper, 2)
    return bic1 < bic2
  elif cond == SingleClusterCondition.FallbackClusterer:
    temp = FallbackClusterer(fallback_options, device=aff.device)
    labels = temp.predict(embeddings)
    return np.unique(labels).size == 1
  raise TypeError("Unsupported single_cluster_condition")
