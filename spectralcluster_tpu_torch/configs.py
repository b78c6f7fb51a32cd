"""Preset configurations (reference configs.py parity).

`make_icassp2018_clusterer` — "Speaker Diarization with LSTM" (ICASSP 2018):
full 6-op refinement sequence, no Laplacian, eigengap on the refined
affinity (reference configs.py:21-43).

The Turn-to-Diarize sequence and option factories are here too; its
clusterer factory needs constraints and autotune, ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from spectralcluster_tpu_torch.clusterer import SpectralClusterer
from spectralcluster_tpu_torch.types import (ConstraintName, ConstraintOptions,
                                             RefinementName, RefinementOptions,
                                             SymmetrizeType, ThresholdType)

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
