"""Preset configurations (reference configs.py parity).

`make_icassp2018_clusterer` — "Speaker Diarization with LSTM" (ICASSP 2018):
full 6-op refinement sequence, no Laplacian, eigengap on the refined
affinity (reference configs.py:21-43).

`make_turntodiarize_clusterer` — "Turn-to-Diarize" (ICASSP 2022):
percentile thresholding with binarization, GraphCut Laplacian, constraint
propagation (α=0.4, before refinement), AutoTune over p ∈ [0.40, 0.95]
step 0.05 (reference configs.py:49-80). Its AutoTune narrows its range as
it searches: build a fresh clusterer for every independent predict.
"""

from __future__ import annotations

from spectralcluster_tpu_torch.autotune import AutoTune
from spectralcluster_tpu_torch.clusterer import SpectralClusterer
from spectralcluster_tpu_torch.types import (ConstraintName, ConstraintOptions,
                                             LaplacianType, RefinementName,
                                             RefinementOptions, SymmetrizeType,
                                             ThresholdType)

ICASSP2018_REFINEMENT_SEQUENCE = (
    RefinementName.CropDiagonal,
    RefinementName.GaussianBlur,
    RefinementName.RowWiseThreshold,
    RefinementName.Symmetrize,
    RefinementName.Diffuse,
    RefinementName.RowWiseNormalize,
)

TURNTODIARIZE_REFINEMENT_SEQUENCE = (
    RefinementName.RowWiseThreshold,
    RefinementName.Symmetrize,
)


def icassp2018_refinement_options() -> RefinementOptions:
  return RefinementOptions(
      gaussian_blur_sigma=1,
      p_percentile=0.95,
      thresholding_soft_multiplier=0.01,
      thresholding_type=ThresholdType.RowMax,
      refinement_sequence=ICASSP2018_REFINEMENT_SEQUENCE)


def make_icassp2018_clusterer(device="cuda", **kwargs) -> SpectralClusterer:
  """The ICASSP 2018 preset; ``kwargs`` override SpectralClusterer knobs
  (e.g. ``eigensolver``)."""
  return SpectralClusterer(**{
      "min_clusters": 2,
      "max_clusters": 7,
      "autotune": None,
      "laplacian_type": None,
      "refinement_options": icassp2018_refinement_options(),
      "custom_dist": "cosine",
      "device": device,
      **kwargs,
  })


def turntodiarize_refinement_options() -> RefinementOptions:
  return RefinementOptions(
      thresholding_soft_multiplier=0.01,
      thresholding_type=ThresholdType.Percentile,
      thresholding_with_binarization=True,
      thresholding_preserve_diagonal=True,
      symmetrize_type=SymmetrizeType.Average,
      refinement_sequence=TURNTODIARIZE_REFINEMENT_SEQUENCE)


def turntodiarize_constraint_options() -> ConstraintOptions:
  return ConstraintOptions(
      constraint_name=ConstraintName.ConstraintPropagation,
      apply_before_refinement=True,
      constraint_propagation_alpha=0.4)


def make_turntodiarize_auto_tune() -> AutoTune:
  return AutoTune(
      p_percentile_min=0.40,
      p_percentile_max=0.95,
      init_search_step=0.05,
      search_level=1)


def make_turntodiarize_clusterer(device="cuda", **kwargs) -> SpectralClusterer:
  """The Turn-to-Diarize preset; ``kwargs`` override SpectralClusterer
  knobs. Call ``predict(x, ConstraintMatrix(scores).compute_diagonals())``."""
  return SpectralClusterer(**{
      "min_clusters": 2,
      "max_clusters": 7,
      "refinement_options": turntodiarize_refinement_options(),
      "constraint_options": turntodiarize_constraint_options(),
      "autotune": make_turntodiarize_auto_tune(),
      "laplacian_type": LaplacianType.GraphCut,
      "row_wise_renorm": True,
      "custom_dist": "cosine",
      "device": device,
      **kwargs,
  })
