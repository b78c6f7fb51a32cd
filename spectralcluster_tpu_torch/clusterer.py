"""SpectralClusterer — the batch entry point of the port (fast path only).

Port of ``spectralcluster_tpu/clusterer.py``: the same constructor knobs and
``predict(embeddings)`` / ``predict_with_details(embeddings)``, plus a
``device`` argument (default "cuda"; pass "cpu" explicitly to run on the
CPU). With no card and no explicit device, ``predict`` raises: it never
moves to the CPU on its own.

Only the fast path is ported: max_clusters set, no autotune, no
constraint, no injected callables, no AHC size reduction, min_clusters != 1
and a row-local metric. Every other branch raises NotImplementedError
naming its ROADMAP queue-1 item. The port runs unpadded: eager PyTorch does
not recompile per shape, so the JAX package's shape buckets are only used
to pick the same solver route.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from spectralcluster_tpu_torch import pipeline as pipeline_lib
from spectralcluster_tpu_torch.observability import StageTimings
from spectralcluster_tpu_torch.types import (ClusterResult, ConstraintOptions,
                                             EigenGapType, EigenSolver,
                                             FallbackOptions, LaplacianType,
                                             RefinementOptions)

_ITEM_7 = "ROADMAP queue 1 item 7 (host API)"
_ITEM_8 = "ROADMAP queue 1 item 8 (Turn-to-Diarize)"


def resolve_device(device) -> torch.device:
  """The torch device to run on; a CUDA device must exist."""
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                       "run on the CPU")
  return dev


class SpectralClusterer:
  """Batch spectral clustering (reference spectral_clusterer.py parity)."""

  def __init__(
      self,
      min_clusters: typing.Optional[int] = None,
      max_clusters: typing.Optional[int] = None,
      refinement_options: typing.Optional[RefinementOptions] = None,
      autotune: typing.Any = None,
      fallback_options: typing.Optional[FallbackOptions] = None,
      laplacian_type: typing.Optional[LaplacianType] = None,
      stop_eigenvalue: float = 1e-2,
      row_wise_renorm: bool = False,
      custom_dist: typing.Union[str, typing.Callable] = "cosine",
      max_iter: int = 300,
      constraint_options: typing.Optional[ConstraintOptions] = None,
      eigengap_type: EigenGapType = EigenGapType.Ratio,
      max_spectral_size: typing.Optional[int] = None,
      affinity_function: typing.Optional[typing.Callable] = None,
      post_eigen_cluster_function: typing.Optional[typing.Callable] = None,
      seed: int = 0,
      eigensolver: EigenSolver = EigenSolver.Auto,
      staged_execution_min_n: typing.Optional[int] = 8192,
      staged_stage_timings: bool = False,
      device: typing.Union[str, torch.device] = "cuda"):
    self.min_clusters = min_clusters
    self.max_clusters = max_clusters
    self.refinement_options = refinement_options or RefinementOptions()
    self.autotune = autotune
    self.fallback_options = fallback_options or FallbackOptions()
    self.laplacian_type = laplacian_type
    self.stop_eigenvalue = stop_eigenvalue
    self.row_wise_renorm = row_wise_renorm
    self.custom_dist = custom_dist
    self.max_iter = max_iter
    self.constraint_options = constraint_options
    self.eigengap_type = eigengap_type
    self.max_spectral_size = max_spectral_size
    self.affinity_function = affinity_function
    self.post_eigen_cluster_function = post_eigen_cluster_function
    self.seed = seed
    self.eigensolver = eigensolver
    # At a shape bucket this large or larger the fast path runs as the
    # staged executor (pipeline.spectral_cluster_fixed_k_staged), as the
    # JAX clusterer does; None disables staging.
    self.staged_execution_min_n = staged_execution_min_n
    # When True, ClusterResult.timings also carries the staged executor's
    # per-stage durations (staged_prep / staged_eigh / staged_subspace /
    # staged_finish).
    self.staged_stage_timings = staged_stage_timings
    self.device = device

  def _config(self) -> pipeline_lib.PipelineConfig:
    return pipeline_lib.PipelineConfig(
        refinement_options=self.refinement_options,
        constraint_options=self.constraint_options,
        laplacian_type=self.laplacian_type,
        min_clusters=self.min_clusters,
        max_clusters=self.max_clusters,
        stop_eigenvalue=self.stop_eigenvalue,
        eigengap_type=self.eigengap_type,
        row_wise_renorm=self.row_wise_renorm,
        custom_dist=self.custom_dist,
        max_iter=self.max_iter,
        eigensolver=self.eigensolver,
        affinity_symmetric=self.affinity_function is None)

  def _refuse_unported(self, num_embeddings: int, constraint_matrix):
    """Raise for every branch of the JAX clusterer that is not the fast path."""
    unported = [
        (constraint_matrix is not None, "constraint_matrix", _ITEM_8),
        (self.autotune is not None, "autotune", _ITEM_8),
        (num_embeddings < self.fallback_options.spectral_min_embeddings,
         "the fallback clusterer for tiny inputs", _ITEM_7),
        (self.max_spectral_size is not None
         and num_embeddings > self.max_spectral_size,
         "max_spectral_size (AHC size reduction)", _ITEM_7),
        (self.max_clusters is None, "max_clusters=None (unbounded k)",
         _ITEM_7),
        (self.affinity_function is not None, "affinity_function", _ITEM_7),
        (self.post_eigen_cluster_function is not None,
         "post_eigen_cluster_function", _ITEM_7),
        (self.min_clusters == 1, "min_clusters=1 (single-cluster check)",
         _ITEM_7),
        (self.custom_dist == "mahalanobis", "custom_dist='mahalanobis'",
         _ITEM_7),
    ]
    for hit, what, item in unported:
      if hit:
        raise NotImplementedError(f"{what} is not ported yet ({item})")

  def predict(
      self,
      embeddings: np.ndarray,
      constraint_matrix: typing.Optional[np.ndarray] = None) -> np.ndarray:
    """Cluster embeddings; returns (N,) labels."""
    return self.predict_with_details(embeddings, constraint_matrix).labels

  def predict_with_details(
      self,
      embeddings: np.ndarray,
      constraint_matrix: typing.Optional[np.ndarray] = None) -> ClusterResult:
    if not isinstance(embeddings, (np.ndarray, torch.Tensor)):
      raise TypeError("embeddings must be a numpy array")
    if len(embeddings.shape) != 2:
      raise ValueError("embeddings must be 2-dimensional")
    num_embeddings = embeddings.shape[0]
    self._refuse_unported(num_embeddings, constraint_matrix)
    device = resolve_device(self.device)
    timings = StageTimings(device)
    cfg = self._config()
    use_staged = (self.staged_execution_min_n is not None
                  and pipeline_lib.pad_bucket(num_embeddings)
                  >= self.staged_execution_min_n)
    with timings.stage("pipeline"):
      x = torch.as_tensor(embeddings, dtype=torch.float32).to(device)
      generator = torch.Generator().manual_seed(self.seed)
      if use_staged:
        out = pipeline_lib.spectral_cluster_fixed_k_staged(
            x, generator, cfg,
            timings=(timings if self.staged_stage_timings else None))
      else:
        out = pipeline_lib.spectral_cluster_fixed_k(x, generator, cfg)
      labels, n_clusters, eigenvalues, max_delta = (t.cpu() for t in out)
    return ClusterResult(
        labels=labels.numpy(),
        n_clusters=int(n_clusters),
        eigenvalues=eigenvalues.numpy(),
        max_delta_norm=float(max_delta),
        timings=timings.as_dict())
