"""Record the JAX package's batch labels for the port's checks on the card.

Runs the JAX package on the CPU. ``batch`` writes
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

``solvers`` writes ``tests/data/reference_batch_solvers.npz``, the labels
of the batched step's other two eigensolvers, with that bench's config
otherwise, through ``cluster_batch`` (``make_batched_cluster_fn`` per
chunk) on a mesh of one CPU device, seed 0:

  * ``subspace_labels`` (16, 1024): ``EigenSolver.SubspaceIteration`` on
    ``fixtures.make_batch(16)``;
  * ``host_general_labels`` (4, 1024): ``EigenSolver.HostGeneral`` on
    ``fixtures.make_batch(4)`` (the float64 host eig is ~1 s per
    utterance).

``ragged`` writes ``tests/data/reference_batch_ragged.npz``, the labels of
the batched SubspaceIteration on utterances that stop at other iterations:
``ragged_labels`` (3, 1024) and ``ragged_truth``, ``cluster_batch`` on
``make_embeddings_k(1024, k)`` for k = 2, 4, 7 (``RAGGED_KS``) with that
bench's config and the certified route's solver constants
(``ragged_config``: chunks of 32 iterations, residual 1e-6, at most 2,048),
on a mesh of one CPU device, seed 0.

``chip_smoke.py`` holds the port's batch drivers on the card against these
files, and the CPU tests hold a few utterances of each. Prints the JAX
package's AHC backend and the seconds each batch took.

Usage: ./run_cpu.sh python tools/record_batch_reference.py
[batch|solvers|ragged] (all three when no argument is given)
"""

import os
import sys
import time

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from spectralcluster_tpu import ahc, configs, constraint, pipeline  # noqa: E402
from spectralcluster_tpu.parallel import batch as batch_lib  # noqa: E402
from spectralcluster_tpu.parallel import mesh as mesh_lib  # noqa: E402
from spectralcluster_tpu.types import EigenSolver, LaplacianType  # noqa: E402
from spectralcluster_tpu_torch.fixtures import (make_batch,  # noqa: E402
                                                make_embeddings_k,
                                                make_t2d_fixture)

OUT = os.path.join(REPO, "tests", "data", "reference_batch.npz")
OUT_SOLVERS = os.path.join(REPO, "tests", "data",
                           "reference_batch_solvers.npz")
OUT_RAGGED = os.path.join(REPO, "tests", "data", "reference_batch_ragged.npz")
RAGGED_KS = (2, 4, 7)
BATCH, N, D, T2D_BATCH = 16, 1024, 256, 4
HOST_GENERAL_BATCH = 4


def batch_config(eigensolver=EigenSolver.Auto):
  """``benchmarks/bench_batch.py``'s config."""
  return pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300,
      eigensolver=eigensolver)


def ragged_config():
  """The bench's SubspaceIteration with the certified route's solver
  constants (spectralcluster_tpu/ops/dc.py:1076-1077): utterances whose
  residual settles near the float32 floor run on after the others
  stop."""
  return batch_config(EigenSolver.SubspaceIteration).replace(
      subspace_iters=32, subspace_residual_tol=1e-6, subspace_max_iters=2048,
      subspace_drift_tol=None)


def t2d_config():
  """The Turn-to-Diarize clusterer's pipeline, without its AutoTune."""
  return pipeline.PipelineConfig(
      refinement_options=configs.turntodiarize_refinement_options(),
      constraint_options=configs.turntodiarize_constraint_options(),
      laplacian_type=LaplacianType.GraphCut,
      min_clusters=2, max_clusters=7, row_wise_renorm=True,
      custom_dist="cosine")


def record_batch():
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


def record_solvers():
  # One device: a padding utterance of a wider mesh would reach the host
  # eig with n_valid=1, whose refined matrix is NaN.
  mesh = mesh_lib.make_mesh(dp=1, mp=1, devices=jax.devices()[:1])
  out = {}
  for key, solver, b in (
      ("subspace_labels", EigenSolver.SubspaceIteration, BATCH),
      ("host_general_labels", EigenSolver.HostGeneral, HOST_GENERAL_BATCH)):
    utts, _ = make_batch(b, N, D)
    t0 = time.time()
    labels = batch_lib.cluster_batch(utts, batch_config(solver), mesh)
    print(f"cluster_batch {solver.name} {b} x N={N}: "
          f"{time.time() - t0:.1f} s", flush=True)
    out[key] = np.stack(labels).astype(np.int16)
  os.makedirs(os.path.dirname(OUT_SOLVERS), exist_ok=True)
  np.savez_compressed(OUT_SOLVERS, **out)
  print(f"wrote {OUT_SOLVERS}", flush=True)


def record_ragged():
  mesh = mesh_lib.make_mesh(dp=1, mp=1, devices=jax.devices()[:1])
  utts, truths = zip(*(make_embeddings_k(N, k, D) for k in RAGGED_KS))
  t0 = time.time()
  labels = batch_lib.cluster_batch(list(utts), ragged_config(), mesh)
  print(f"cluster_batch SubspaceIteration (ragged) {len(utts)} x N={N}: "
        f"{time.time() - t0:.1f} s", flush=True)
  os.makedirs(os.path.dirname(OUT_RAGGED), exist_ok=True)
  np.savez_compressed(OUT_RAGGED,
                      ragged_labels=np.stack(labels).astype(np.int16),
                      ragged_truth=np.stack(truths).astype(np.int16))
  print(f"wrote {OUT_RAGGED}", flush=True)


def main():
  which = sys.argv[1] if len(sys.argv) > 1 else "all"
  if which not in ("batch", "solvers", "ragged", "all"):
    raise SystemExit(f"unknown record {which!r}: batch, solvers, ragged or "
                     "all")
  print(f"AHC backend: {'native' if ahc._native_ok() else 'numpy'}",
        flush=True)
  if which in ("batch", "all"):
    record_batch()
  if which in ("solvers", "all"):
    record_solvers()
  if which in ("ragged", "all"):
    record_ragged()


if __name__ == "__main__":
  main()
