"""The batched step's last two routes, against the 2-D ones and JAX (CPU).

On the same numpy inputs:

  * kernel 5's batched form (``row_wise_normalize_batched``, its plain
    version on the CPU) against the 2-D one per matrix, bit for bit, on a
    ragged batch with a single valid row;
  * the batched host eig (``sorted_eig_general_host`` on (B, N, N))
    against the 2-D call per matrix, bit for bit;
  * the batched subspace solver (JAX's vmap of its ``while_loop``: each
    lane frozen at its own convergence) against the 2-D solve per lane:
    Ritz values, eigenvectors and iteration counts bit for bit, with lanes
    that stop at different chunks and an ``n_valid=1`` lane, both scan
    directions; CholeskyQR2's rescue decided per lane;
  * ``cluster_batch`` and ``cluster_batch_streamed`` with
    SubspaceIteration against the JAX package's labels recorded in
    ``tests/data/reference_batch_solvers.npz`` at N=1024 (four of its
    utterances: each one's labels do not depend on the others).

``tests/test_torch_batched.py`` holds both routes of
``spectral_cluster_fixed_k_batched`` against the 2-D pipeline and
``make_batched_cluster_fn`` against the JAX package's (HostGeneral at
N=64: its float64 host eig is O(N³)).
"""

import os

import numpy as np
import pytest
import torch

from spectralcluster_tpu_torch import configs, pipeline
from spectralcluster_tpu_torch.fixtures import make_batch
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.ops import eigen
from spectralcluster_tpu_torch.parallel import batch
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
from spectralcluster_tpu_torch.types import EigenSolver

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N = 64
# Geometric spectra r**j: the closer r is to 1, the more chunks of 24
# iterations a lane needs (24, 48, 72 and 96 descending at N=64), and a
# lane with one valid row.
DECAYS = (0.9, 0.98, 0.99, 0.995, None)
N_VALID = (64, 48, 64, 57, 1)


def _spectra(largest: bool) -> np.ndarray:
  """(B, N, N) symmetric float32 matrices, zero past each n_valid."""
  q, _ = np.linalg.qr(np.random.RandomState(0).randn(N, N))
  out = np.zeros((len(DECAYS), N, N), np.float32)
  for i, (r, nv) in enumerate(zip(DECAYS, N_VALID)):
    if r is None:
      out[i, 0, 0] = 2.5
      continue
    lam = r ** np.arange(N)
    a = ((q * (lam if largest else 2.0 - lam)) @ q.T).astype(np.float32)
    out[i, :nv, :nv] = 0.5 * (a + a.T)[:nv, :nv]
  return out


def _solve(mat, n_valid, largest, stats, **kw):
  return eigen.topk_eigh_subspace_masked(
      mat, 8, torch.Generator().manual_seed(42), largest, n_valid,
      residual_tol=2e-3, stats=stats, **kw)


def test_row_wise_normalize_batched_per_matrix():
  rng = np.random.RandomState(0)
  a = torch.from_numpy(rng.randn(5, 40, 40).astype(np.float32) - 0.3)
  nv = (40, 33, 1, 17, 40)
  got = fused.row_wise_normalize_batched(a, torch.tensor(nv))
  full = fused.row_wise_normalize_batched(a)
  for i, n in enumerate(nv):
    torch.testing.assert_close(got[i], fused.row_wise_normalize(a[i], n),
                               rtol=0, atol=0, equal_nan=True)
    assert torch.equal(full[i], fused.row_wise_normalize(a[i]))
  with pytest.raises(ValueError, match="unsupported device"):
    fused.row_wise_normalize_batched(torch.empty((2, 8, 8), device="meta"))


@pytest.mark.parametrize("descend", [True, False])
def test_sorted_eig_general_host_batched_per_matrix(descend):
  a = torch.from_numpy(
      np.random.RandomState(1).randn(4, 48, 48).astype(np.float32))
  w, v = eigen.sorted_eig_general_host(a, descend)
  assert w.shape == (4, 48) and v.shape == (4, 48, 48)
  for i in range(4):
    w1, v1 = eigen.sorted_eig_general_host(a[i], descend)
    assert torch.equal(w[i], w1) and torch.equal(v[i], v1)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("drift_tol", [1e-4, None])
def test_subspace_batched_per_lane(largest, drift_tol):
  mats = torch.from_numpy(_spectra(largest))
  stats = {}
  w, v = _solve(mats, torch.tensor(N_VALID), largest, stats,
                drift_tol=drift_tol)
  assert w.shape == (5, 8) and v.shape == (5, N, 8)
  iters = []
  for i, nv in enumerate(N_VALID):
    alone = {}
    w1, v1 = _solve(mats[i], nv, largest, alone, drift_tol=drift_tol)
    assert torch.equal(w[i], w1) and torch.equal(v[i], v1)
    assert int(stats["iters"][i]) == alone["iters"]
    iters.append(alone["iters"])
  # The lanes stop at different chunks: the batch ran past the first
  # lanes' stops and froze them.
  assert len(set(iters)) >= 3


def test_cholqr2_rescue_is_per_lane():
  # Panel 1 overflows its Gram (non-finite in both passes): its rescue must
  # leave the other panels on their own 1e-6 pass.
  rng = np.random.RandomState(2)
  y = rng.randn(3, N, 15).astype(np.float32)
  y[1] *= 1e25
  y = torch.from_numpy(y)
  got = eigen.cholqr2_shifted(y)
  for i in range(3):
    torch.testing.assert_close(got[i], eigen.cholqr2_shifted(y[i]), rtol=0,
                               atol=0, equal_nan=True)
  assert torch.isfinite(got[0]).all() and not torch.isfinite(got[1]).all()


def test_rank_collapsed_lane_leaves_the_others_unchanged():
  mats = torch.from_numpy(_spectra(True))
  nv = torch.tensor(N_VALID)
  w, v = _solve(mats, nv, True, {})
  keep = [0, 1, 2, 3]             # without the n_valid=1 lane
  w_k, v_k = _solve(mats[keep], nv[keep], True, {})
  assert torch.equal(w[keep], w_k) and torch.equal(v[keep], v_k)


def _reference():
  with np.load(os.path.join(REPO, "tests", "data",
                            "reference_batch_solvers.npz")) as ref:
    return ref["subspace_labels"], ref["host_general_labels"]


def test_cluster_batch_subspace_matches_the_reference():
  # tools/record_batch_reference.py's batch_config(SubspaceIteration). The
  # HostGeneral labels of that file are held on the card only: the host
  # eig at N=1024 takes minutes on a loaded CPU.
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300,
      eigensolver=EigenSolver.SubspaceIteration)
  want, _ = _reference()
  utts, _ = make_batch(4)
  mesh = mesh_lib.make_mesh(dp=2, devices=[CPU] * 2)
  got = batch.cluster_batch(utts, cfg, mesh)
  streamed = batch.cluster_batch_streamed(utts, cfg, mesh, chunk=2,
                                          window=2)
  for a, s, b in zip(got, streamed, want):
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(s, b)
