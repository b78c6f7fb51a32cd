"""The port's CUDA kernels against their plain twins, on the card.

These tests need a CUDA card and nvcc; without a card they skip. They import
only torch and the port, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import itertools
import os

import numpy as np
import pytest
import torch

from spectralcluster_tpu_torch import (configs, constraint, pipeline,
                                       precision, streaming, utils)
from spectralcluster_tpu_torch.clusterer import SpectralClusterer
from spectralcluster_tpu_torch.constraint import ConstraintMatrix
from spectralcluster_tpu_torch.fixtures import (make_embeddings, make_stream,
                                                make_t2d_fixture)
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.ops import dc
from spectralcluster_tpu_torch.parallel import batch
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
from spectralcluster_tpu_torch.parallel import sharded
from spectralcluster_tpu_torch.types import Deflicker, EigenSolver

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernels have no CPU mode; the CPU "
                "tests run their plain twins)")
  return torch.device("cuda")


def _mat(n, seed, device, shift=0.0):
  # Drawn on the card: N=20000 is 1.6 GB.
  gen = torch.Generator(device).manual_seed(seed)
  return torch.randn((n, n), generator=gen, device=device) + shift


# The affinity's tiling edges: N around its 128-row tiles, d around its
# 16-deep k slices (zero-padded by the wrapper).
_AFFINITY_EDGES = list(itertools.product((1, 127, 128, 129, 1001),
                                         (1, 33, 256, 257)))


@pytest.mark.parametrize("n,d", [(1000, 100), (64, 256), (513, 33)]
                         + _AFFINITY_EDGES)
def test_affinity(cuda, n, d):
  x = torch.as_tensor(
      np.random.RandomState(0).randn(n, d).astype(np.float32)).to(cuda)
  got = fused.affinity(x)
  # float32 sums in another order than cuBLAS's.
  torch.testing.assert_close(got, fused.affinity_plain(x), rtol=1e-5,
                             atol=1e-6)
  assert torch.equal(got, got.T)


# Row max edges: a row shorter than a float4, a ragged N, and N=20000, more
# rows than one resident wave of warps holds.
_ROW_MAX_EDGES = [(n, nv) for n in (7, 1001, 20000)
                  for nv in (None, n - 1, 1)]


@pytest.mark.parametrize("n,n_valid", [(1000, 937), (1024, None), (7, 5)]
                         + _ROW_MAX_EDGES)
@pytest.mark.parametrize("exclude", [False, True])
def test_row_max(cuda, n, n_valid, exclude):
  a = _mat(n, 1, cuda, -0.5)
  assert torch.equal(fused.row_max(a, exclude, n_valid),
                     fused.row_max_plain(a, exclude, n_valid))


@pytest.mark.parametrize("n,n_valid", [(1000, 937), (1024, None), (1001, None),
                                     (1001, 1000)])
@pytest.mark.parametrize("inplace", [False, True])
def test_crop_diagonal(cuda, n, n_valid, inplace):
  a = _mat(n, 2, cuda, -3.0)
  want = fused.crop_diagonal_plain(a, n_valid)
  got = fused.crop_diagonal(a.clone(), n_valid, inplace=inplace)
  assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1000, 1024, 33])
@pytest.mark.parametrize("flags", [
    {}, dict(binarize=True, preserve_diagonal=True, average=True)])
def test_threshold_symmetrize(cuda, n, flags):
  a = _mat(n, 3, cuda)
  thr = fused.row_max_plain(a) * 0.6
  assert torch.equal(fused.threshold_symmetrize_general(a, thr, 0.01, **flags),
                     fused.threshold_symmetrize_general_plain(a, thr, 0.01,
                                                              **flags))


@pytest.mark.parametrize("n,n_valid", [(1000, 937), (1024, None), (7, 5)])
def test_row_wise_normalize(cuda, n, n_valid):
  a = _mat(n, 4, cuda, -0.5)
  assert torch.equal(fused.row_wise_normalize(a, n_valid),
                     fused.row_wise_normalize_plain(a, n_valid))


def _reference(n):
  return np.load(os.path.join(os.path.dirname(__file__), os.pardir,
                              "benchmarks", "reference_labels.npz"))[
                                  f"labels_{n}"]


_MAIN_KERNELS = {"affinity", "row_max", "crop_diagonal",
                 "threshold_symmetrize_general"}


def test_predict_launches_every_kernel(cuda):
  # Auto's path: kernels 1-4; RowWiseNormalize is absorbed into the eigh
  # similarity transform (ROWNORM_TAIL), so kernel 5 does not run.
  fused.reset_launch_counts()
  labels = configs.make_icassp2018_clusterer().predict(make_embeddings(2048))
  counts = fused.launch_counts()
  assert all(counts[k] > 0 for k in _MAIN_KERNELS)
  assert counts["row_wise_normalize"] == 0
  np.testing.assert_array_equal(utils.enforce_ordered_labels(labels),
                                _reference(2048))


def test_host_general_predict_launches_all_five(cuda):
  fused.reset_launch_counts()
  result = configs.make_icassp2018_clusterer(
      eigensolver=EigenSolver.HostGeneral).predict_with_details(
          make_embeddings(512))
  assert all(v > 0 for v in fused.launch_counts().values())
  assert "host_eig" in result.timings
  np.testing.assert_array_equal(utils.enforce_ordered_labels(result.labels),
                                _reference(512))


def _t2d_inputs(n):
  x, scores, _ = make_t2d_fixture(n)
  return x, ConstraintMatrix(scores, threshold=1).compute_diagonals()


def test_t2d_predict_on_the_card(cuda):
  # The host flow: E2CP, then AutoTune's 11 candidates, each through
  # kernel 4's T2D form (Percentile, Average, binarize, preserve_diagonal).
  x, cm = _t2d_inputs(1024)
  fused.reset_launch_counts()
  result = configs.make_turntodiarize_clusterer().predict_with_details(x, cm)
  counts = fused.launch_counts()
  assert counts["affinity"] == 1
  assert counts["threshold_symmetrize_general"] == 11
  ref = np.load(os.path.join(os.path.dirname(__file__), os.pardir,
                             "benchmarks", "reference_labels_t2d.npz"))
  np.testing.assert_array_equal(utils.enforce_ordered_labels(result.labels),
                                ref["labels_1024"])
  assert result.n_clusters == 4
  assert abs(result.best_p_percentile - 0.785) < 1e-9


@pytest.mark.parametrize("alpha", [0.4, 0.97])
def test_e2cp_card_matches_cpu(cuda, alpha):
  x, cm = _t2d_inputs(512)
  aff = fused.affinity_plain(torch.as_tensor(x))
  q = torch.as_tensor(cm.astype(np.float32))
  want, want_res = constraint.constraint_propagation(aff, q, alpha,
                                                     with_residual=True)
  got, got_res = constraint.constraint_propagation(aff.to(cuda), q.to(cuda),
                                                   alpha, with_residual=True)
  torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
  assert float(got_res) <= 1e-6 and float(want_res) <= 1e-6


@pytest.mark.parametrize("try_iterative_first", [None, False])
def test_eigh_topk_dc_card_matches_cpu(cuda, try_iterative_first):
  # A dominant spectrum over a quasi-degenerate bulk: the certified route
  # (or, forced off, the sign-chain split) on the card and on the CPU, from
  # the same CPU-drawn start panels. Eigenvalues within 2e-4·scale.
  rng = np.random.RandomState(0)
  n = 1024
  q, _ = np.linalg.qr(rng.randn(n, n))
  eigs = np.concatenate([[260.0, 250.0, 240.0, 230.0],
                         1e-3 + rng.randn(n - 4) * 1e-4])
  a = torch.as_tensor(((q * eigs[None, :]) @ q.T).astype(np.float32))
  out = {}
  for device in ("cpu", cuda):
    info = {}
    w, v, res, scale = dc.eigh_topk_dc(
        a.to(device), 8, torch.Generator().manual_seed(17), max_block=128,
        try_iterative_first=try_iterative_first, info=info)
    out[str(device)] = (w.cpu().numpy(), res, scale, info["route"])
  (w_cpu, res_cpu, scale_cpu, route_cpu), (w_gpu, res_gpu, _, route_gpu) = (
      out.values())
  assert route_cpu == route_gpu == ("split" if try_iterative_first is
                                    False else "certified")
  assert res_gpu <= 1e-5 and res_cpu <= 1e-5
  np.testing.assert_allclose(w_gpu, w_cpu, atol=2e-4 * scale_cpu)


def _rel_err(c, exact):
  return float(torch.amax(torch.abs(c.double() - exact))
               / torch.amax(torch.abs(exact)))


def test_three_tf32_products_are_float32_accurate(cuda):
  # precision.matmul's "high" (3×TF32, the card's counterpart of XLA's
  # 3-pass bf16) against float64, as max error over max|C|: within a few
  # times IEEE float32's own (itself far inside the K·2^-24 ≈ 1.2e-4 bound
  # of K=2048 terms), and well below one TF32 product's ("default", ~2^-11
  # per operand).
  gen = torch.Generator(cuda).manual_seed(0)
  a = torch.randn((2048, 2048), generator=gen, device=cuda)
  b = torch.randn((2048, 2048), generator=gen, device=cuda)
  exact = a.double() @ b.double()
  err = {p: _rel_err(precision.matmul(a, b, p), exact)
         for p in precision.PRECISIONS}
  assert err["highest"] < 1e-5, err
  assert err["high"] < 5 * err["highest"], err
  assert err["high"] * 20 < err["default"], err
  assert not torch.backends.cuda.matmul.allow_tf32


def _split_operand(n=1024):
  rng = np.random.RandomState(0)
  q, _ = np.linalg.qr(rng.randn(n, n))
  eigs = np.concatenate([[260.0, 250.0], rng.randn(n - 2) * 0.5])
  return torch.as_tensor(((q * eigs[None, :]) @ q.T).astype(np.float32))


def test_split_card_matches_cpu(cuda):
  # The sign-chain split at N=1024, max_block=128 (so its blocks recurse),
  # at its default precision ("high": 3×TF32 on the card, IEEE float32 on
  # the CPU): the same branch at every level, eigenvalues within
  # 2e-4·scale, and the caller's TF32 flags as they were.
  a = _split_operand()
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
  out = {}
  for device in ("cpu", cuda):
    info = {}
    w, _, res, scale = dc.eigh_topk_dc(
        a.to(device), 8, torch.Generator().manual_seed(17), max_block=128,
        try_iterative_first=False, info=info)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == flags
    out[str(device)] = (w.cpu().numpy(), res, scale,
                        [(lv["depth"], lv["branch"]) for lv in info["levels"]])
  (w_cpu, res_cpu, scale_cpu, br_cpu), (w_gpu, res_gpu, _, br_gpu) = (
      out.values())
  assert br_cpu == br_gpu and br_cpu
  assert res_gpu <= 1e-3 and res_cpu <= 1e-3
  np.testing.assert_allclose(w_gpu, w_cpu, atol=2e-4 * scale_cpu)


def test_stream_card_matches_cpu(cuda):
  # 200 steps at L=10, U1=20, U2=60 (four compressions): the card's label
  # history equals the CPU's at every step, up to label ids. The blur is
  # off: at these sizes GaussianBlur runs along stream order and mixes the
  # speakers, which leaves K-Means near ties that a last-bit difference
  # between the card's and the CPU's eigenvectors can tip (seen at step 89
  # with the blur on); without it each predict separates the speakers.
  stream, _ = make_stream(200)

  def clusterer(device):
    return streaming.MultiStageClusterer(
        SpectralClusterer(
            min_clusters=2, max_clusters=7,
            refinement_options=configs.icassp2018_refinement_options(
            ).replace(gaussian_blur_sigma=0),
            device=device),
        fallback_threshold=0.5, L=10, U1=20, U2=60,
        deflicker=Deflicker.Hungarian)

  on_card, on_cpu = clusterer("cuda"), clusterer("cpu")
  fused.reset_launch_counts()
  for step, e in enumerate(stream, start=1):
    got, want = on_card.streaming_predict(e), on_cpu.streaming_predict(e)
    np.testing.assert_array_equal(utils.enforce_ordered_labels(got),
                                  utils.enforce_ordered_labels(want),
                                  err_msg=f"step {step}")
  np.testing.assert_array_equal(on_card.compression_labels,
                                on_cpu.compression_labels)
  assert all(fused.launch_counts()[k] > 0 for k in (
      "affinity", "row_max", "crop_diagonal", "threshold_symmetrize_general"))


def _batch_cfg():
  return pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, max_iter=300)


def _batch_utterances(lengths, seed=0, d=64):
  # Block-ordered speakers, 2-4 per utterance, well separated.
  rng = np.random.RandomState(seed)
  out = []
  for i, n in enumerate(lengths):
    k = 2 + i % 3
    labels = np.repeat(np.arange(k), -(-n // k))[:n]
    out.append((rng.randn(k, d)[labels] * 3
                + rng.randn(n, d) * 0.4).astype(np.float32))
  return out


def test_cluster_batch_card_matches_cpu(cuda):
  # A ragged batch: the card's labels equal the CPU's, and each utterance
  # launches kernels 1-4 (row_max twice).
  utts = _batch_utterances((300, 512, 200, 450, 512, 64))
  fused.reset_launch_counts()
  got = batch.cluster_batch(utts, _batch_cfg(), mesh_lib.make_mesh())
  counts = fused.launch_counts()
  want = batch.cluster_batch(utts, _batch_cfg(), mesh_lib.make_mesh(
      devices=[torch.device("cpu")]))
  for a, b in zip(got, want):
    np.testing.assert_array_equal(utils.enforce_ordered_labels(a),
                                  utils.enforce_ordered_labels(b))
  assert counts == {"affinity": 6, "row_max": 12, "crop_diagonal": 6,
                    "threshold_symmetrize_general": 6,
                    "row_wise_normalize": 0}


def test_cluster_batch_streamed_card_matches_serial(cuda):
  # The windowed driver (side-stream copies, pinned buffers) returns the
  # serial chunked loop's labels id for id; a bf16 transfer keeps these
  # separated speakers' labels.
  utts = _batch_utterances((256, 200, 256, 100, 256, 180, 256), seed=1)
  mesh = mesh_lib.make_mesh()
  streamed = batch.cluster_batch_streamed(utts, _batch_cfg(), mesh, chunk=3,
                                          window=2)
  serial = []
  for lo in range(0, len(utts), 3):
    serial.extend(batch.cluster_batch(utts[lo:lo + 3], _batch_cfg(), mesh,
                                      seed=lo))
  half = batch.cluster_batch_streamed(utts, _batch_cfg(), mesh, chunk=3,
                                      window=2, transfer_dtype=torch.bfloat16)
  for s, r, h in zip(streamed, serial, half):
    np.testing.assert_array_equal(s, r)
    np.testing.assert_array_equal(utils.enforce_ordered_labels(s),
                                  utils.enforce_ordered_labels(h))


@pytest.mark.parametrize("n,use_ring", [(512, False), (509, True)])
def test_cluster_large_sharded_card_matches_cpu(cuda, n, use_ring):
  # Four in-process shards on the card against four on the CPU (509: 3 pad
  # rows): the same labels, the reference's at 512, and no kernel launch.
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300)
  x = make_embeddings(512)[:n]
  fused.reset_launch_counts()
  got, got_n = sharded.cluster_large_sharded(
      x, cfg, mesh_lib.make_mesh(dp=1, mp=4, devices=[cuda] * 4),
      use_ring_affinity=use_ring)
  assert not any(fused.launch_counts().values())
  want, want_n = sharded.cluster_large_sharded(
      x, cfg, mesh_lib.make_mesh(dp=1, mp=4,
                                 devices=[torch.device("cpu")] * 4),
      use_ring_affinity=use_ring)
  assert got_n == want_n == 2
  ref = np.load(os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "benchmarks", "reference_labels.npz"))
  for labels in (got, want):
    np.testing.assert_array_equal(utils.enforce_ordered_labels(labels),
                                  ref["labels_512"][:n])
