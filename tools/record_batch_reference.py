"""Record the JAX package's batch labels for the port's checks on the card.

Runs the JAX package on the CPU over two batches and writes
``tests/data/reference_batch.npz``:

  * ``batch_labels`` (16, 1024): ``parallel.batch.cluster_batch`` on
    ``fixtures.make_batch(16)`` (the utterances of
    ``benchmarks/bench_batch.py``: N=1024, d=256, 2-4 block-ordered
    speakers) with that bench's config (icassp2018, min 2 / max 7 clusters,
    cosine, max_iter=300, Auto) and seed 0; ``batch_truth`` their speakers;
  * ``t2d_labels`` (4, 1024): ``cluster_batch_autotuned`` with the
    Turn-to-Diarize template (``configs.make_turntodiarize_auto_tune()``)
    on 4 x ``make_t2d_fixture(1024)`` with ``ConstraintMatrix(scores,
    threshold=1).compute_diagonals()``, seed 0.

``chip_smoke.py`` holds the port's batch drivers on the card against this
file. Prints the JAX package's AHC backend and the seconds each batch took.

Usage: ./run_cpu.sh python tools/record_batch_reference.py
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from spectralcluster_tpu import ahc, configs, constraint, pipeline  # noqa: E402
from spectralcluster_tpu.parallel import batch as batch_lib  # noqa: E402
from spectralcluster_tpu.types import EigenSolver, LaplacianType  # noqa: E402
from spectralcluster_tpu_torch.fixtures import (make_batch,  # noqa: E402
                                                make_t2d_fixture)

OUT = os.path.join(REPO, "tests", "data", "reference_batch.npz")
BATCH, N, D, T2D_BATCH = 16, 1024, 256, 4


def batch_config():
  """``benchmarks/bench_batch.py``'s config."""
  return pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300,
      eigensolver=EigenSolver.Auto)


def t2d_config():
  """The Turn-to-Diarize clusterer's pipeline, without its AutoTune."""
  return pipeline.PipelineConfig(
      refinement_options=configs.turntodiarize_refinement_options(),
      constraint_options=configs.turntodiarize_constraint_options(),
      laplacian_type=LaplacianType.GraphCut,
      min_clusters=2, max_clusters=7, row_wise_renorm=True,
      custom_dist="cosine")


def main():
  print(f"AHC backend: {'native' if ahc._native_ok() else 'numpy'}",
        flush=True)
  utts, truths = make_batch(BATCH, N, D)
  t0 = time.time()
  labels = batch_lib.cluster_batch(utts, batch_config())
  print(f"cluster_batch {BATCH} x N={N}: {time.time() - t0:.1f} s", flush=True)
  x, scores, _ = make_t2d_fixture(N, D)
  cm = constraint.ConstraintMatrix(scores, threshold=1).compute_diagonals()
  t0 = time.time()
  t2d = batch_lib.cluster_batch_autotuned(
      [x] * T2D_BATCH, t2d_config(), configs.make_turntodiarize_auto_tune(),
      constraint_matrices=[cm] * T2D_BATCH)
  print(f"cluster_batch_autotuned {T2D_BATCH} x T2D N={N}: "
        f"{time.time() - t0:.1f} s", flush=True)
  os.makedirs(os.path.dirname(OUT), exist_ok=True)
  np.savez_compressed(
      OUT, batch_labels=np.stack(labels).astype(np.int16),
      batch_truth=np.stack(truths).astype(np.int16),
      t2d_labels=np.stack(t2d).astype(np.int16))
  print(f"wrote {OUT}", flush=True)


if __name__ == "__main__":
  main()
