"""SpectralClusterer — the batch entry point of the port.

Port of ``spectralcluster_tpu/clusterer.py``: the same constructor knobs and
``predict(embeddings)`` / ``predict_with_details(embeddings)``, plus a
``device`` argument (default "cuda"; pass "cpu" explicitly to run on the
CPU). With no card and no explicit device, ``predict`` raises: it never
moves to the CPU on its own.

Branches, as in the JAX clusterer: the fallback clusterer for tiny inputs,
the AHC size reduction past ``max_spectral_size``, the fast path (the whole
pipeline on the device), and the host flow for everything else — a user
``affinity_function``, the single-cluster check of ``min_clusters=1``,
``max_clusters=None``, a ``post_eigen_cluster_function``, mahalanobis.
``EigenSolver.HostGeneral`` and the GENERAL structure run LAPACK's general
eig on the host by contract; its seconds are ``timings["host_eig"]``.

Turn-to-Diarize (``configs.make_turntodiarize_clusterer``) takes the host
flow: a ``constraint_matrix`` (from ``constraint.ConstraintMatrix``) goes
to the card, as its three diagonals when it is tri-diagonal, and is applied
before refinement (stage "constraint") or after it; an ``AutoTune`` then
sweeps p_percentile (stage "eig"), one candidate after another: the full
refine -> eig -> gap below ``staged_execution_min_n``, ``eig_topk_staged``
at or above it. AutoTune narrows its own range as it searches, so build a
fresh clusterer (or AutoTune) for each independent predict.

The port runs unpadded: eager PyTorch does not recompile per shape, so the
JAX package's shape buckets are only used to pick the same solver route.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from spectralcluster_tpu_torch import ahc as ahc_lib
from spectralcluster_tpu_torch import fallback as fallback_lib
from spectralcluster_tpu_torch import pipeline as pipeline_lib
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.autotune import AutoTune
from spectralcluster_tpu_torch.constraint import adjust_affinity
from spectralcluster_tpu_torch.observability import StageTimings
from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops
from spectralcluster_tpu_torch.types import (ClusterResult, ConstraintOptions,
                                             EigenGapType, EigenSolver,
                                             FallbackOptions, LaplacianType,
                                             RefinementName,
                                             RefinementOptions)


def _upload_constraint(cm: np.ndarray, device: torch.device) -> torch.Tensor:
  """A host constraint matrix on ``device`` as float32.

  From N=1024 on, a tri-diagonal matrix (what ConstraintMatrix builds,
  reference constraint.py:167-201) goes across as its three diagonals and
  is assembled on the device, as in the JAX clusterer: O(N) bytes instead
  of N² floats (0.42 GB at N=10240). Other matrices go across whole.
  """
  n = cm.shape[0]
  if n >= 1024:
    ii, jj = np.nonzero(cm)
    if ii.size <= 4 * n and np.all(np.abs(ii - jj) <= 1):
      main, up, lo = (torch.as_tensor(np.ascontiguousarray(
          np.diagonal(cm, k)).astype(np.float32)).to(device)
                      for k in (0, 1, -1))
      return torch.diag(main) + torch.diag(up, 1) + torch.diag(lo, -1)
  return torch.as_tensor(np.asarray(cm, np.float32)).to(device)


def _symmetric(cm: np.ndarray) -> bool:
  return bool(np.array_equal(cm, cm.T))


class SpectralClusterer:
  """Batch spectral clustering (reference spectral_clusterer.py parity)."""

  def __init__(
      self,
      min_clusters: typing.Optional[int] = None,
      max_clusters: typing.Optional[int] = None,
      refinement_options: typing.Optional[RefinementOptions] = None,
      autotune: typing.Optional[AutoTune] = None,
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
    # staged executor (pipeline.spectral_cluster_fixed_k_staged) and the
    # host flow's eig stage as pipeline.eig_topk_staged, as the JAX
    # clusterer does; None disables staging.
    self.staged_execution_min_n = staged_execution_min_n
    # When True, every predict also records its spans and counters, in
    # both executors: ClusterResult.timings also carries the staged
    # executor's stages (staged_prep / staged_eigh / staged_dc /
    # staged_subspace / staged_finish), the spans upload, refine, eigh,
    # kmeans and download, and ClusterResult.counters "lloyd_rounds"; each
    # is an ``sct.<name>`` profiler range under ``sct.predict``, and the
    # call goes into observability's in-memory record. Off, no span,
    # counter, event or range of these is entered.
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

  def _fast_path_applicable(self, constraint_matrix) -> bool:
    # Mahalanobis is the one metric that is not row-local (scipy's default
    # VI is the inverse covariance of all rows and centroids), so it takes
    # the host flow, as in the JAX clusterer.
    return (self.autotune is None and constraint_matrix is None
            and self.max_clusters is not None
            and self.affinity_function is None
            and self.post_eigen_cluster_function is None
            and self.custom_dist != "mahalanobis"
            and self.min_clusters != 1)

  def _staged_eig_applicable(self, cfg, num: int,
                             with_constraint: bool) -> bool:
    return (self.staged_execution_min_n is not None
            and pipeline_lib.pad_bucket(num) >= self.staged_execution_min_n
            and pipeline_lib._staged_eig_applicable(cfg, with_constraint))

  def _compute_eigenvectors_ncluster(self,
                                     affinity,
                                     constraint_matrix=None,
                                     p_percentile=None):
    """Refine + eigendecompose + eigengap.

    White-box API parity with reference spectral_clusterer.py:108-168
    (returns (eigenvectors, n_clusters, max_delta_norm)), with p_percentile
    as an explicit argument instead of options mutation.
    """
    v, n, delta, _ = self._eig_stage(affinity, constraint_matrix, p_percentile)
    return v, n, delta

  def _eig_stage(self, affinity, constraint_matrix=None, p_percentile=None,
                 cfg=None, timings=None):
    """Like _compute_eigenvectors_ncluster but also returns eigenvalues.

    ``affinity`` (numpy or tensor) is not modified. ``constraint_matrix``
    (numpy or tensor) applies here only after refinement. Returns numpy
    (eigenvectors, n_clusters, max_delta, eigenvalues); past
    ``staged_execution_min_n`` the eigenvectors are the k_cap columns that
    K-Means can read and the eigenvalues the max_clusters+1 extreme ones.
    """
    device = utils.resolve_device(self.device)
    if cfg is None:
      cfg = self._config()
      if constraint_matrix is not None:
        # The routing predict() does: an asymmetric constraint must not
        # feed eigh a one-triangle view.
        symmetric = _symmetric(np.asarray(constraint_matrix))
        self._check_constraint_solver(symmetric)
        cfg = cfg.replace(constraint_symmetric=symmetric)
    aff = torch.as_tensor(affinity).to(device, torch.float32)
    cm = None
    if constraint_matrix is not None:
      cm = torch.as_tensor(constraint_matrix).to(device, torch.float32)
    if self._staged_eig_applicable(cfg, aff.shape[0], cm is not None):
      out = pipeline_lib.eig_topk_staged(aff, cfg, constraint_matrix=cm,
                                         p_percentile=p_percentile)
    else:
      out = pipeline_lib.refine_and_eigendecompose(
          aff, cfg, p_percentile=p_percentile, timings=timings,
          constraint_matrix=cm)
    w, v, n, delta = (t.cpu() for t in out)
    return v.numpy(), int(n), float(delta), w.numpy()

  def _check_constraint_solver(self, constraint_symmetric: bool):
    if not constraint_symmetric and self.eigensolver in (
        EigenSolver.Eigh, EigenSolver.SubspaceIteration):
      raise ValueError(
          f"EigenSolver.{self.eigensolver.name} requires a symmetric "
          "constraint matrix; use EigenSolver.Auto or HostGeneral.")

  def _autotune_eig(self, affinity, cfg, cm, timings):
    """AutoTune's search (JAX clusterer.py:472-534): one refine -> eig ->
    gap per candidate, on the device, with eigenvectors trimmed to the
    k_cap columns K-Means can read; ``eig_topk_staged`` per candidate at or
    above ``staged_execution_min_n``. Returns numpy (eigenvectors,
    n_clusters, best_p, eigenvalues, max_delta)."""
    seq = self.refinement_options.refinement_sequence or ()
    if RefinementName.RowWiseThreshold not in seq:
      raise ValueError(
          "AutoTune is only effective when the refinement sequence "
          "contains RowWiseThreshold")
    num = affinity.shape[0]
    k_cap = None
    if cfg.max_clusters is not None:
      k_cap = max(cfg.max_clusters, cfg.min_clusters or 0)
    staged = self._staged_eig_applicable(cfg, num, cm is not None)
    # Eigenvalues and eigengap per candidate, keyed by p, so the winner's
    # survive tune_batched (which returns eigenvectors, n_clusters, best_p).
    eig_details: dict = {}

    def one(p):
      if staged:
        return pipeline_lib.eig_topk_staged(
            affinity, cfg, constraint_matrix=cm, p_percentile=float(p))
      w, v, n, delta = pipeline_lib.refine_and_eigendecompose(
          affinity, cfg, p_percentile=float(p), timings=timings,
          constraint_matrix=cm)
      return w, (v if k_cap is None else v[:, :k_cap]), n, delta

    def batch_eval(ps: np.ndarray):
      ratios, vs, ns = [], [], []
      for p in ps:
        w, v, n, delta = (t.cpu() for t in one(p))
        eig_details[float(p)] = (w.numpy(), float(delta))
        ratios.append(self.autotune.ratio_from_proxy(p, float(delta)))
        vs.append(v.numpy())
        ns.append(int(n))
      return np.array(ratios), np.stack(vs), np.array(ns)

    eigenvectors, n_clusters, best_p = self.autotune.tune_batched(batch_eval)
    eigenvalues, max_delta = eig_details[best_p]
    return eigenvectors, n_clusters, best_p, eigenvalues, max_delta

  def _reduce_size_and_predict(self, embeddings: np.ndarray, device,
                               timings: StageTimings) -> ClusterResult:
    """AHC size reduction then recursive spectral clustering
    (reference spectral_clusterer.py:170-199). Returns the inner spectral
    run's ClusterResult with labels chained through the AHC pre-labels;
    ``timings`` records the inner run's stages and counters with the
    prefix ``inner_``."""
    ahc_labels = ahc_lib.agglomerative_cluster(
        embeddings, metric="cosine", linkage="complete",
        n_clusters=self.max_spectral_size)
    ahc_centroids = utils.get_cluster_centroids(embeddings, ahc_labels)
    with timings.prefixed("inner_"):
      inner = self._predict(ahc_centroids, None, True, device, timings)
    inner.labels = utils.chain_labels(ahc_labels, np.asarray(inner.labels))
    return inner

  def predict(
      self,
      embeddings: np.ndarray,
      constraint_matrix: typing.Optional[np.ndarray] = None) -> np.ndarray:
    """Cluster embeddings; returns (N,) labels.

    Control flow mirrors reference spectral_clusterer.py:201-314.
    """
    return self.predict_with_details(embeddings, constraint_matrix).labels

  def predict_with_details(
      self,
      embeddings: np.ndarray,
      constraint_matrix: typing.Optional[np.ndarray] = None) -> ClusterResult:
    if not isinstance(embeddings, (np.ndarray, torch.Tensor)):
      raise TypeError("embeddings must be a numpy array")
    if len(embeddings.shape) != 2:
      raise ValueError("embeddings must be 2-dimensional")
    if isinstance(embeddings, torch.Tensor):
      embeddings = embeddings.detach().cpu().numpy()
    num_embeddings = embeddings.shape[0]
    constraint_symmetric = True
    if constraint_matrix is not None:
      constraint_matrix = np.asarray(constraint_matrix)
      if (constraint_matrix.ndim != 2 or constraint_matrix.shape !=
          (num_embeddings, num_embeddings)):
        raise ValueError(
            "constraint matrix must be a square matrix matching embeddings: "
            f"expected ({num_embeddings}, {num_embeddings}), got "
            f"{constraint_matrix.shape}")
      # eigh reads one triangle: an asymmetric constraint goes to the
      # general eigensolver, as the reference's np.linalg.eig would take it.
      constraint_symmetric = _symmetric(constraint_matrix)
      self._check_constraint_solver(constraint_symmetric)
    device = utils.resolve_device(self.device)
    timings = StageTimings(device, detail=self.staged_stage_timings)
    with timings.call():
      result = self._predict(embeddings, constraint_matrix,
                             constraint_symmetric, device, timings)
    result.timings = timings.as_dict()
    result.counters = timings.counters()
    return result

  def _predict(self, embeddings: np.ndarray, constraint_matrix,
               constraint_symmetric: bool, device,
               timings: StageTimings) -> ClusterResult:
    """``predict_with_details`` past its input checks: the branches, each
    stage recorded in ``timings``."""
    num_embeddings = embeddings.shape[0]

    # Tiny inputs: fallback clusterer (spectral_clusterer.py:230-234).
    if num_embeddings < self.fallback_options.spectral_min_embeddings:
      clusterer = fallback_lib.FallbackClusterer(self.fallback_options,
                                                 device=device)
      with timings.stage("fallback"):
        labels = clusterer.predict(embeddings)
      return ClusterResult(labels=labels,
                           n_clusters=int(np.unique(labels).size))

    # Oversized inputs: AHC reduction (spectral_clusterer.py:236-247).
    if (self.max_spectral_size is not None
        and num_embeddings > self.max_spectral_size):
      if constraint_matrix is not None:
        raise RuntimeError(
            "Cannot handle constraint_matrix when max_spectral_size is set")
      if (self.max_spectral_size < 2 or
          (self.max_clusters and self.max_spectral_size <= self.max_clusters)
          or
          (self.min_clusters and self.max_spectral_size <= self.min_clusters)):
        raise ValueError("max_spectral_size should be a relatively big number")
      with timings.stage("ahc_reduce"):
        result = self._reduce_size_and_predict(embeddings, device, timings)
      result.n_clusters = int(np.unique(result.labels).size)
      return result

    cfg = self._config()

    # Fast path: the whole pipeline on the device.
    if self._fast_path_applicable(constraint_matrix):
      use_staged = (self.staged_execution_min_n is not None
                    and pipeline_lib.pad_bucket(num_embeddings)
                    >= self.staged_execution_min_n
                    and pipeline_lib._staged_applicable(cfg))
      with timings.stage("pipeline"):
        with timings.span("upload"):
          x = torch.as_tensor(embeddings, dtype=torch.float32).to(device)
        generator = torch.Generator().manual_seed(self.seed)
        if use_staged:
          out = pipeline_lib.spectral_cluster_fixed_k_staged(
              x, generator, cfg,
              timings=(timings if self.staged_stage_timings else None))
        else:
          out = pipeline_lib.spectral_cluster_fixed_k(x, generator, cfg,
                                                      timings=timings)
        with timings.span("download"):
          labels, n_clusters, eigenvalues, max_delta = (t.cpu() for t in out)
      return ClusterResult(
          labels=labels.numpy(),
          n_clusters=int(n_clusters),
          eigenvalues=eigenvalues.numpy(),
          max_delta_norm=float(max_delta))

    # Host flow. The affinity stays on the device unless a user function
    # makes it on the host.
    with timings.stage("affinity"):
      if self.affinity_function is None:
        affinity = pipeline_lib.prepare_affinity(
            torch.as_tensor(embeddings, dtype=torch.float32).to(device), cfg)
      else:
        affinity = np.asarray(self.affinity_function(embeddings))

    # Single-vs-multi cluster decision (spectral_clusterer.py:253-256).
    if self.min_clusters == 1:
      with timings.stage("single_cluster_check"):
        single = fallback_lib.check_single_cluster(self.fallback_options,
                                                   embeddings, affinity)
      if single:
        return ClusterResult(labels=np.zeros(num_embeddings, dtype=np.int64),
                             n_clusters=1)

    # Constraint before refinement (spectral_clusterer.py:259-264), on the
    # device; after refinement, it goes to the eig stage.
    cm_for_stage = None
    if constraint_matrix is not None:
      if (self.constraint_options is not None
          and self.constraint_options.apply_before_refinement):
        with timings.stage("constraint"):
          affinity = adjust_affinity(
              torch.as_tensor(affinity).to(device, torch.float32),
              _upload_constraint(constraint_matrix, device),
              self.constraint_options)
        if not constraint_symmetric:
          # The adjusted affinity is asymmetric now; the symmetry analysis
          # decides whether the refinement sequence restores symmetry.
          cfg = cfg.replace(affinity_symmetric=False)
      else:
        cm_for_stage = constraint_matrix
        cfg = cfg.replace(constraint_symmetric=constraint_symmetric)

    best_p = None
    if self.autotune:
      with timings.stage("eig"):
        aff = torch.as_tensor(affinity).to(device, torch.float32)
        cm = (None if cm_for_stage is None
              else _upload_constraint(cm_for_stage, device))
        eigenvectors, n_clusters, best_p, eigenvalues, max_delta = (
            self._autotune_eig(aff, cfg, cm, timings))
    else:
      with timings.stage("eig"):
        eigenvectors, n_clusters, max_delta, eigenvalues = self._eig_stage(
            affinity, cm_for_stage, cfg=cfg, timings=timings)

    if self.min_clusters is not None:
      n_clusters = max(n_clusters, self.min_clusters)

    spectral_embeddings = eigenvectors[:, :n_clusters]
    if self.row_wise_renorm:
      rows_norm = np.linalg.norm(spectral_embeddings, axis=1, ord=2)
      spectral_embeddings = spectral_embeddings / rows_norm.reshape(
          num_embeddings, 1)

    with timings.stage("kmeans"):
      if self.post_eigen_cluster_function is not None:
        labels = self.post_eigen_cluster_function(
            spectral_embeddings=spectral_embeddings,
            n_clusters=n_clusters,
            custom_dist=self.custom_dist,
            max_iter=self.max_iter)
      else:
        labels = kmeans_ops.run_kmeans(
            spectral_embeddings=spectral_embeddings,
            n_clusters=n_clusters,
            custom_dist=self.custom_dist,
            max_iter=self.max_iter,
            generator=torch.Generator().manual_seed(self.seed),
            device=device)
    return ClusterResult(
        labels=np.asarray(labels),
        n_clusters=int(n_clusters),
        eigenvalues=eigenvalues,
        max_delta_norm=float(max_delta),
        best_p_percentile=best_p)
