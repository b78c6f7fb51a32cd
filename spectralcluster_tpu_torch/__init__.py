"""spectralcluster_tpu_torch — the PyTorch/CUDA port of spectralcluster_tpu.

Runs on one NVIDIA H100 (entry points default to ``device="cuda"``; pass
``device="cpu"`` to run on the CPU, where the hand-written kernels are
replaced by their plain PyTorch twins). Ported so far: the batch
``SpectralClusterer`` with every branch, both presets (icassp2018 and
Turn-to-Diarize: constraints, Laplacians, AutoTune), the exact top-k route
past ``dc_max_block`` (ops/dc.py), streaming (``MultiStageClusterer``), the
fallback and AHC clusterers (with the native C++ chain, native/), K-Means,
the batch drivers (parallel/batch.py), and all five Pallas kernels of the
JAX package as CUDA kernels (kernels/fused.py, csrc/fused.cu). See
ROADMAP.md for what is still to port.
"""

from spectralcluster_tpu_torch import configs
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import pipeline
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.ahc import agglomerative_cluster
from spectralcluster_tpu_torch.autotune import AutoTune
from spectralcluster_tpu_torch.clusterer import SpectralClusterer
from spectralcluster_tpu_torch.constraint import ConstraintMatrix
from spectralcluster_tpu_torch.convert import clusterer_from
from spectralcluster_tpu_torch.fallback import (FallbackClusterer,
                                                NaiveClusterer,
                                                check_single_cluster)
from spectralcluster_tpu_torch.fixtures import (make_batch, make_embeddings,
                                                make_embeddings_k, make_stream,
                                                make_t2d_fixture)
from spectralcluster_tpu_torch.ops.kmeans import CustomKMeans, run_kmeans
from spectralcluster_tpu_torch.pipeline import (AutoTuneStatic,
                                                PipelineConfig,
                                                spectral_cluster_fixed_k,
                                                spectral_cluster_fixed_k_staged)
from spectralcluster_tpu_torch.streaming import (MultiStageClusterer,
                                                 MultiStageState, match_labels)
from spectralcluster_tpu_torch.types import (AutoTuneProxy, ClusterResult,
                                             ConstraintName,
                                             ConstraintOptions, Deflicker,
                                             EigenGapType, EigenSolver,
                                             FallbackClustererType,
                                             FallbackOptions, IntegrationType,
                                             LaplacianType, RefinementName,
                                             RefinementOptions,
                                             SingleClusterCondition,
                                             SymmetrizeType, ThresholdType)
from spectralcluster_tpu_torch.utils import (chain_labels,
                                             enforce_ordered_labels,
                                             get_cluster_centroids)

ICASSP2018_REFINEMENT_SEQUENCE = configs.ICASSP2018_REFINEMENT_SEQUENCE
TURNTODIARIZE_REFINEMENT_SEQUENCE = configs.TURNTODIARIZE_REFINEMENT_SEQUENCE

__all__ = [
    "AutoTune", "AutoTuneProxy", "AutoTuneStatic", "ClusterResult",
    "ConstraintMatrix", "ConstraintName", "ConstraintOptions", "Deflicker",
    "EigenGapType", "EigenSolver", "FallbackClusterer",
    "FallbackClustererType", "FallbackOptions", "IntegrationType",
    "LaplacianType", "MultiStageClusterer", "MultiStageState",
    "NaiveClusterer", "PipelineConfig", "RefinementName",
    "RefinementOptions", "SingleClusterCondition", "SpectralClusterer",
    "SymmetrizeType", "ThresholdType", "CustomKMeans",
    "agglomerative_cluster", "chain_labels", "check_single_cluster",
    "clusterer_from", "configs", "convert", "run_kmeans",
    "enforce_ordered_labels", "get_cluster_centroids", "make_batch",
    "make_embeddings",
    "make_embeddings_k", "make_stream", "make_t2d_fixture", "match_labels",
    "pipeline", "spectral_cluster_fixed_k",
    "spectral_cluster_fixed_k_staged", "utils",
    "ICASSP2018_REFINEMENT_SEQUENCE", "TURNTODIARIZE_REFINEMENT_SEQUENCE",
]
