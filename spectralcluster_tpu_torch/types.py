"""Enums and option dataclasses of the PyTorch port.

A copy of ``spectralcluster_tpu/types.py``: the same enums (same member names
and order) and the same frozen dataclasses with the same fields and defaults,
so a configuration carries across by name (see convert.py). The port keeps
its own copy so it never imports the JAX package.

Every categorical choice in the reference library (wq2012/SpectralCluster) is an
``enum.Enum``; the surface is mirrored 1:1 so capability parity is checkable.

Reference enums covered (file:line cites into the upstream spectralcluster
package):
  - RefinementName        refinement.py:11-18
  - ThresholdType         refinement.py:21-27
  - SymmetrizeType        refinement.py:30-36
  - LaplacianType         laplacian.py:9-21
  - EigenGapType          utils.py:10-17
  - ConstraintName        constraint.py:11-17
  - IntegrationType       constraint.py:20-23
  - SingleClusterCondition fallback_clusterer.py:23-45
  - FallbackClustererType fallback_clusterer.py:48-55
  - AutoTuneProxy         autotune.py:10-23
  - Deflicker             multi_stage_clusterer.py:20-29
"""

from __future__ import annotations

import dataclasses
import enum
import typing

EPS = 1e-10


class RefinementName(enum.Enum):
  """Names of affinity-refinement operations."""
  CropDiagonal = enum.auto()
  GaussianBlur = enum.auto()
  RowWiseThreshold = enum.auto()
  Symmetrize = enum.auto()
  Diffuse = enum.auto()
  RowWiseNormalize = enum.auto()


class ThresholdType(enum.Enum):
  """Row-wise thresholding variants."""
  # Clear values smaller than row_max * p_percentile.
  RowMax = enum.auto()
  # Clear the (p_percentile*100)% smallest values of each row.
  Percentile = enum.auto()


class SymmetrizeType(enum.Enum):
  """Symmetrization variants."""
  Max = enum.auto()      # max(A, A^T)
  Average = enum.auto()  # (A + A^T) / 2


class LaplacianType(enum.Enum):
  """Graph Laplacian variants."""
  Affinity = enum.auto()       # W itself (not a Laplacian)
  Unnormalized = enum.auto()   # L = D - W
  RandomWalk = enum.auto()     # D^{-1} L
  GraphCut = enum.auto()       # D^{-1/2} L D^{-1/2}


class EigenGapType(enum.Enum):
  """Eigengap computation variants."""
  Ratio = enum.auto()
  NormalizedDiff = enum.auto()


class ConstraintName(enum.Enum):
  """Constrained-clustering method names."""
  AffinityIntegration = enum.auto()
  ConstraintPropagation = enum.auto()


class IntegrationType(enum.Enum):
  """Integration types for the AffinityIntegration method."""
  Max = enum.auto()
  Average = enum.auto()


class SingleClusterCondition(enum.Enum):
  """How to decide single-vs-multi cluster when min_clusters == 1."""
  AffinityGmmBic = enum.auto()
  AllAffinity = enum.auto()
  NeighborAffinity = enum.auto()
  AffinityStd = enum.auto()
  FallbackClusterer = enum.auto()


class FallbackClustererType(enum.Enum):
  """Which fallback clusterer to use for tiny inputs."""
  Agglomerative = enum.auto()
  Naive = enum.auto()


class AutoTuneProxy(enum.Enum):
  """DER-proxy to minimize during auto-tuning."""
  # (1 - p) / eigengap  (Park et al., NME-SC, IEEE SPL 2019)
  PercentileOverNME = enum.auto()
  # sqrt(1 - p) / eigengap  (Xia et al., Turn-to-Diarize, ICASSP 2022)
  PercentileSqrtOverNME = enum.auto()


class Deflicker(enum.Enum):
  """Streaming-output label deflicker modes."""
  NoDeflicker = enum.auto()
  OrderBased = enum.auto()
  Hungarian = enum.auto()


class EigenSolver(enum.Enum):
  """How eigendecompositions are performed.

  The reference uses LAPACK's general ``np.linalg.eig`` (utils.py:59). Every
  supported pipeline is restructured so a *symmetric* eigendecomposition
  suffices (see ops/eigen.py); LAPACK's general eig on the host is the
  escape hatch for the GENERAL structure (``sorted_eig_general_host``).
  """
  # Pick the symmetric path when the pipeline structure allows it (always
  # true for the reference's built-in configs), general eig otherwise.
  Auto = enum.auto()
  # Force the symmetric eigh (requires symmetric / diag-similarity structure).
  Eigh = enum.auto()
  # Force the host general eig (escape hatch).
  HostGeneral = enum.auto()
  # Subspace (block power) iteration for the top-k eigenpairs only.
  SubspaceIteration = enum.auto()


@dataclasses.dataclass(frozen=True)
class RefinementOptions:
  """Options for the affinity refinement sequence.

  Mirrors reference refinement.py:71-100 (same defaults), but frozen and
  hashable, with the sequence as a tuple.
  """
  gaussian_blur_sigma: float = 1
  p_percentile: float = 0.95
  thresholding_soft_multiplier: float = 0.01
  thresholding_type: ThresholdType = ThresholdType.RowMax
  thresholding_with_binarization: bool = False
  thresholding_preserve_diagonal: bool = False
  symmetrize_type: SymmetrizeType = SymmetrizeType.Max
  refinement_sequence: typing.Optional[typing.Tuple[RefinementName, ...]] = None

  def __post_init__(self):
    if self.refinement_sequence is not None:
      object.__setattr__(
          self, "refinement_sequence", tuple(self.refinement_sequence))

  def replace(self, **kw) -> "RefinementOptions":
    return dataclasses.replace(self, **kw)

  def get_refinement_operator(self, name: RefinementName):
    """Reference-compatible operator factory (refinement.py:102-133).

    Returns an object with ``refine(affinity) -> np.ndarray`` applying the
    named op with these options (computed by the jnp twin of the op).
    """
    if not isinstance(name, RefinementName):
      raise TypeError("name must be a RefinementName")
    return _RefinementOperator(self, name)


class _RefinementOperator:
  """Reference-compatible refinement operator (refinement.py:39-133).

  Module-scope (constructed once per get_refinement_operator call, like the
  reference's class-per-name instances) with the reference check_input
  semantics: TypeError for non-ndarray input, ValueError for non-square.
  """

  def __init__(self, options: "RefinementOptions", name: RefinementName):
    self._options = options
    self._name = name

  def refine(self, affinity):
    import numpy as np
    import torch
    from spectralcluster_tpu_torch.ops import refinement as _refinement_ops
    if not isinstance(affinity, np.ndarray):
      raise TypeError("affinity must be a numpy array")
    if affinity.ndim != 2 or affinity.shape[0] != affinity.shape[1]:
      raise ValueError("affinity must be a 2-D square matrix")
    mat = torch.as_tensor(np.asarray(affinity, np.float32))
    return _refinement_ops.apply_refinement_op(
        mat, self._name, self._options).numpy()


@dataclasses.dataclass(frozen=True)
class ConstraintOptions:
  """Options for constrained clustering (reference constraint.py:26-49)."""
  constraint_name: ConstraintName
  apply_before_refinement: bool
  integration_type: typing.Optional[IntegrationType] = None
  constraint_propagation_alpha: float = 0.6

  def replace(self, **kw) -> "ConstraintOptions":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FallbackOptions:
  """Options for fallback clustering (reference fallback_clusterer.py:58-92)."""
  spectral_min_embeddings: int = 1
  single_cluster_condition: SingleClusterCondition = (
      SingleClusterCondition.AffinityGmmBic)
  single_cluster_affinity_threshold: float = 0.75
  single_cluster_affinity_diagonal_offset: int = 1
  fallback_clusterer_type: FallbackClustererType = FallbackClustererType.Naive
  agglomerative_threshold: float = 0.5
  naive_threshold: float = 0.5
  naive_adaptation_threshold: typing.Optional[float] = None

  def replace(self, **kw) -> "FallbackOptions":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class ClusterResult:
  """Structured result of a clustering run.

  The reference computes all of these internally (spectral_clusterer.py:108-168)
  but only returns ``labels``; we surface them for observability (SURVEY.md §5).

  Field semantics per path:
    * ``eigenvalues`` is None exactly on the paths where no eigendecomposition
      happens (tiny-input fallback, single-cluster early exit); the AHC
      size-reduction path surfaces the INNER spectral run's eigenvalues.
      Top-k eigensolvers (SubspaceIteration; the spectral-D&C used by the
      staged executor past ``dc_max_block``) return only the
      ``max_clusters + 1`` extreme eigenvalues — the full-eigh paths return
      all N.
    * ``best_p_percentile`` is set only when AutoTune ran.
    * ``timings`` always carries the seconds of each stage of the call
      (summed over its spans), timed on the device's timeline by a pair of
      CUDA events on the card and by the host clock on the CPU (see
      ``observability.StageTimings``): the branch's stages ("pipeline",
      "fallback", "ahc_reduce", the host flow's "affinity" ... "kmeans",
      "host_eig"), and with ``staged_stage_timings`` the staged
      executor's stages and the spans "upload", "refine", "eigh",
      "kmeans" and "download" too. The AHC-reduction path prefixes the
      inner run's stages with ``inner_``.
    * ``counters`` carries the call's counts with ``staged_stage_timings``
      ("lloyd_rounds": the Lloyd rounds the host ran), and is empty
      without it; prefixed like ``timings``.
  """
  labels: typing.Any                     # (N,) int array
  n_clusters: int = 0
  eigenvalues: typing.Optional[typing.Any] = None
  max_delta_norm: float = 0.0
  best_p_percentile: typing.Optional[float] = None
  timings: typing.Optional[dict] = None
  counters: typing.Optional[dict] = None
