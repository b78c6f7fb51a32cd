"""spectralcluster_tpu_torch — the PyTorch/CUDA port of spectralcluster_tpu.

Runs on one NVIDIA H100 (entry points default to ``device="cuda"``; pass
``device="cpu"`` to run on the CPU, where the hand-written kernels are
replaced by their plain PyTorch twins). Ported so far: the icassp2018
``predict`` fast path, with the refinement hot path's four Pallas kernels
as CUDA kernels (kernels/fused.py, csrc/fused.cu). See ROADMAP.md for what
is still to port.
"""

from spectralcluster_tpu_torch import configs
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import pipeline
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.clusterer import SpectralClusterer
from spectralcluster_tpu_torch.fixtures import make_embeddings
from spectralcluster_tpu_torch.types import (ClusterResult, ConstraintName,
                                             ConstraintOptions, EigenGapType,
                                             EigenSolver, FallbackOptions,
                                             LaplacianType, RefinementName,
                                             RefinementOptions,
                                             SymmetrizeType, ThresholdType)

__all__ = [
    "ClusterResult", "ConstraintName", "ConstraintOptions", "EigenGapType",
    "EigenSolver", "FallbackOptions", "LaplacianType", "RefinementName",
    "RefinementOptions", "SpectralClusterer", "SymmetrizeType",
    "ThresholdType", "configs", "convert", "make_embeddings", "pipeline",
    "utils",
]
