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

from spectralcluster_tpu_torch import (configs, constraint, observability,
                                       pipeline, precision, prng, streaming,
                                       utils)
from spectralcluster_tpu_torch.clusterer import SpectralClusterer
from spectralcluster_tpu_torch.constraint import ConstraintMatrix
from spectralcluster_tpu_torch.fixtures import (make_embeddings, make_stream,
                                                make_t2d_fixture)
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.ops import dc, eigen
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


# The batched forms (one launch per chunk): each against its twin, and
# each utterance of the batch against the 2-D kernel on it alone.
_BATCH_N_VALID = (1000, 937, 1, 500, 1000)


def _batch(n, seed, device, shift=0.0):
  gen = torch.Generator(device).manual_seed(seed)
  return torch.randn((len(_BATCH_N_VALID), n, n), generator=gen,
                     device=device) + shift


# The batched affinity (csrc/fused.cu, 1b): a block per piece of a 128x128
# tile pair, the B·T(T-1)/2 off-diagonal pairs first, then the B·T diagonal
# tiles at 3/4 of a tile, the last min(B·T, slots / 4) of them as an upper
# row half and a lower quad (66 of 264 slots on an H100 SXM). Cases: every
# diagonal tile split (1, 5, 6, 7 x 1024), some (9 x 1024, 88 x 100, 16 x
# 1024, 64 x 1024); a grid under, at and over one wave of 264 blocks (5, 6,
# 7 x 1024: 220, 264, 308); a lower quad past N (960, 64) or of one row
# (65); N % 4 != 0 (1001, 129, 513); d past whole 16-deep slices (257, 100),
# d % 4 != 0 (257, 33, 3, 1, padded by the wrapper); N = 1.
@pytest.mark.parametrize("b,n,d", [(5, 1000, 100), (16, 1024, 256),
                                   (3, 129, 33), (2, 1, 1), (1, 1024, 256),
                                   (5, 1024, 64), (6, 1024, 64),
                                   (7, 1024, 64), (9, 1024, 64),
                                   (88, 100, 64), (64, 1024, 256),
                                   (3, 960, 64), (2, 64, 16), (4, 192, 257),
                                   (2, 1001, 8), (1, 65, 3), (7, 513, 16),
                                   (8, 1024, 64), (2, 2500, 16)])
def test_affinity_batched(cuda, b, n, d):
  x = torch.as_tensor(
      np.random.RandomState(0).randn(b, n, d).astype(np.float32)).to(cuda)
  got = fused.affinity_batched(x)
  torch.testing.assert_close(got, fused.affinity_plain(x), rtol=1e-5,
                             atol=1e-6)
  for i in range(b):
    assert torch.equal(got[i], fused.affinity(x[i]))
    assert torch.equal(got[i], got[i].T)


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_row_max_batched(cuda, exclude, ragged):
  a = _batch(1000, 5, cuda, -0.5)
  nv = torch.tensor(_BATCH_N_VALID, device=cuda) if ragged else None
  got = fused.row_max_batched(a, exclude, nv)
  assert torch.equal(got, fused.row_max_plain(a, exclude, nv))
  for i in range(a.shape[0]):
    assert torch.equal(got[i], fused.row_max(
        a[i], exclude, _BATCH_N_VALID[i] if ragged else None))


# The batched row max (csrc/fused.cu, 2b): a warp per row, each lane's
# loads of a 512·kRbLoads-byte stretch (4 KB) in flight at once. Cases: a
# row past one stretch (2500: three, the last partial; 2503 without float4
# loads), N % 4 != 0 (1001, 7: the tail columns and the scalar path), the
# batch path's 16 x 1024 and the streamed chunk's 64 x 1024, N = 1; n_valid
# of N, N - 1, 0, 1 and N/2 + 3 by turns, and past [0, N] (clamped).
@pytest.mark.parametrize("b,n", [(3, 2500), (2, 2503), (5, 1001), (4, 7),
                                 (16, 1024), (64, 1024), (3, 1)])
@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_row_max_batched_shapes(cuda, b, n, exclude, ragged):
  gen = torch.Generator(cuda).manual_seed(9)
  a = torch.randn((b, n, n), generator=gen, device=cuda) - 0.5
  nvs = [(n, n - 1, 0, 1, n // 2 + 3, n + 5, -3)[i % 7] for i in range(b)]
  nv = torch.tensor(nvs, device=cuda) if ragged else None
  got = fused.row_max_batched(a, exclude, nv)
  assert torch.equal(got, fused.row_max_plain(a, exclude, nv))
  for i in range(b):
    assert torch.equal(got[i], fused.row_max(
        a[i], exclude, nvs[i] if ragged else None))


@pytest.mark.parametrize("inplace", [False, True])
def test_crop_diagonal_batched(cuda, inplace):
  a = _batch(1001, 6, cuda, -3.0)
  nv = torch.tensor(_BATCH_N_VALID, device=cuda)
  want = fused.crop_diagonal_plain(a, nv)
  assert torch.equal(fused.crop_diagonal_batched(a.clone(), nv, inplace),
                     want)


@pytest.mark.parametrize("flags", [
    {}, dict(binarize=True, preserve_diagonal=True, average=True)])
def test_threshold_symmetrize_batched(cuda, flags):
  a = _batch(1000, 7, cuda)
  thr = fused.row_max_plain(a) * 0.6
  got = fused.threshold_symmetrize_general_batched(a, thr, 0.01, **flags)
  assert torch.equal(got, fused.threshold_symmetrize_general_plain(
      a, thr, 0.01, **flags))
  assert torch.equal(got[2], fused.threshold_symmetrize_general(
      a[2], thr[2], 0.01, **flags))


@pytest.mark.parametrize("b,n,ragged", [(5, 1000, False), (5, 1000, True),
                                         (16, 1024, False), (3, 7, False)])
def test_row_wise_normalize_batched(cuda, b, n, ragged):
  gen = torch.Generator(cuda).manual_seed(8)
  a = torch.randn((b, n, n), generator=gen, device=cuda) - 0.5
  nv = torch.tensor(_BATCH_N_VALID, device=cuda) if ragged else None
  got = fused.row_wise_normalize_batched(a, nv)
  torch.testing.assert_close(got, fused.row_wise_normalize_plain(a, nv),
                             rtol=0, atol=0, equal_nan=True)
  for i in range(b):
    torch.testing.assert_close(
        got[i], fused.row_wise_normalize(
            a[i], _BATCH_N_VALID[i] if ragged else None),
        rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("form", ["twin", "kernel"])
def test_lloyd_reads_no_host_value_between_its_checks(cuda, form):
  # The batched Lloyd loop on the card with every host read forbidden:
  # the eager twin with checks sparser than max_iter + 1 rounds makes
  # none, and its labels, centroids and rounds equal those of the checked
  # loop; kernel 8 (seeding and Lloyd in one launch) makes none, and its
  # labels and rounds equal the twin's, its centroids within float32 sums
  # in another order.
  from spectralcluster_tpu_torch.ops import affinity as t_aff
  from spectralcluster_tpu_torch.ops import kmeans as t_kmeans
  rng = np.random.RandomState(0)
  x = torch.as_tensor(rng.randn(16, 1024, 7).astype(np.float32)).to(cuda)
  w = torch.ones((16, 1024), device=cuda)
  n_clusters = torch.tensor([2, 3, 4, 5, 6, 7, 7, 3] * 2, device=cuda)
  keys = np.stack([np.array([0, i], np.uint32) for i in range(16)])
  centroids = t_kmeans.kmeans_plusplus_batched(x, 7, keys, w)
  dist = t_aff.get_batched_distance_fn("cosine")
  fused.kmeans(x, n_clusters, keys, 7, w, max_iter=300)  # builds, warms
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    if form == "twin":
      got = t_kmeans._lloyd(x, centroids, n_clusters, dist, 300, 0.001, w,
                            check_every=10_000)
    else:
      got = fused.kmeans(x, n_clusters, keys, 7, w, max_iter=300)
  finally:
    torch.cuda.set_sync_debug_mode("default")
  want = t_kmeans.lloyd_iterations_batched(x, centroids, n_clusters, dist,
                                           300, 0.001, w)
  if form == "twin":
    for a, b in zip(got, want):
      assert torch.equal(a, b)
  else:
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)


# Kernel 8 (fused.kmeans) against its twin. Keys of every width of the
# stream: zero, small, and both words set.
_KM_KEYS = [prng.key(s) for s in (0, 1, 42, 4100001611, 2**32 - 1)]


@pytest.fixture(scope="module")
def gumbel_probe():
  """probe_gumbel of tests/csrc/gumbel_probe.cu: kernel 8's draws alone."""
  import ctypes
  from spectralcluster_tpu_torch.kernels import build
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  lib = ctypes.CDLL(build.build((os.path.join(
      os.path.dirname(os.path.abspath(__file__)), "csrc",
      "gumbel_probe.cu"),)))
  lib.probe_gumbel.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                               ctypes.c_void_p]
  lib.probe_gumbel.restype = ctypes.c_int
  return lib.probe_gumbel


@pytest.mark.parametrize("key", range(len(_KM_KEYS)))
@pytest.mark.parametrize("rows", [256, 768, 1024, 24064])
def test_gumbel_draws_are_prng_draws(cuda, gumbel_probe, key, rows):
  # Kernel 8's draws are prng.gumbel's bit for bit (numpy's float32 log,
  # rebuilt operation for operation), for every trial of a k-means++ step:
  # trial t's draw at row i is the sub-key's flat counter t·rows + i.
  k = _KM_KEYS[key]
  sub = prng.split(k, 8)[3]
  count = 5 * rows
  for kk in (k, sub):
    out = torch.empty((count,), device=cuda)
    assert gumbel_probe(int(kk[0]), int(kk[1]), count, out.data_ptr()) == 0
    got = out.cpu().numpy()
    want = prng.gumbel(kk, (count,))
    bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
    assert bad.size == 0, (bad.size, bad[:8], got[bad[:8]], want[bad[:8]])
  np.testing.assert_array_equal(prng.gumbel(sub, (3, rows)),
                                prng.gumbel(sub, (3 * rows,)).reshape(3, rows))


def _km_points(n, k, seed, batch=()):
  """Unit rows near k random directions in 7 columns, as the spectral
  embeddings K-Means clusters."""
  rng = np.random.RandomState(seed)
  centres = rng.randn(*batch, k, 7)
  pick = rng.randint(0, k, size=batch + (n,))
  x = np.take_along_axis(centres, pick[..., None], axis=-2)
  x = x + 0.35 * rng.randn(*batch, n, 7)
  x /= np.linalg.norm(x, axis=-1, keepdims=True)
  return x.astype(np.float32)


@pytest.mark.parametrize("n", [256, 777, 1024, 8192, 20480])
def test_kmeans_kernel_seeds_as_the_twin(cuda, n):
  # max_iter=0 stops at the first round with the seeded centres.
  x = torch.as_tensor(_km_points(n, 5, n)).to(cuda)
  for s in (0, 7):
    key = prng.key(s)
    got = fused.kmeans(x, 5, key, 7, max_iter=0)
    want = fused.kmeans_plain(x, 5, key, 7, max_iter=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    assert torch.equal(got[0], want[0])
    assert int(got[2]) == int(want[2]) == 1


@pytest.mark.parametrize("n", [256, 777, 1024, 8192, 20480])
def test_kmeans_kernel_labels_and_rounds_as_the_twin(cuda, n):
  for k in range(2, 8):
    x = torch.as_tensor(_km_points(n, k, 100 * n + k)).to(cuda)
    nc = torch.tensor(k, device=cuda)
    w = torch.ones((n,), device=cuda)
    got = fused.kmeans(x, nc, prng.key(k), 7, w, max_iter=300)
    want = fused.kmeans_plain(x, nc, prng.key(k), 7, w, max_iter=300)
    assert torch.equal(got[0], want[0]), (k, int(got[2]), int(want[2]))
    assert int(got[2]) == int(want[2]), k
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,seed", [(256, 4100001611), (777, 4100001612),
                                    (1024, 4100001613), (8192, 4100001614),
                                    (20480, 4100001615)])
def test_kmeans_kernel_on_recordings_as_the_twin(cuda, monkeypatch, n, seed):
  # The spectral embeddings of the benchmark generator's recordings, taken
  # where the pipeline hands them to K-Means: the kernel's labels and
  # rounds are the twin's.
  from portbench import generator
  from spectralcluster_tpu_torch.ops import kmeans as t_kmeans
  traffic = {"d": 256, "turn_mean": 12, "share_alpha": 1.0,
             "centre_scale": 3.0, "noise": 0.4}
  seen = []
  fit = t_kmeans.kmeans_fit

  def spy(x, n_clusters, gen, **kw):
    seen.append((x.clone(), n_clusters, prng.key(gen.initial_seed()), kw))
    return fit(x, n_clusters, gen, **kw)

  monkeypatch.setattr(t_kmeans, "kmeans_fit", spy)
  for k in (2, 4, 7):
    rec = generator.make_recording(generator.rng_for(seed, k), 0, n, k,
                                   traffic)
    configs.make_icassp2018_clusterer(
        eigensolver=EigenSolver.Eigh).predict(rec.embeddings)
  for x, nc, key, kw in seen:
    args = (x, nc, key, kw["k_max"], kw["sample_weight"], None,
            kw["max_iter"], kw["tol"])
    got, want = fused.kmeans(*args), fused.kmeans_plain(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])


def test_kmeans_kernel_batched_as_each_utterance_alone(cuda):
  # A ragged (16, 1024, 7) batch: each utterance's labels and rounds are
  # those of the kernel on it alone, and the twin's.
  x = torch.as_tensor(_km_points(1024, 6, 3, batch=(16,))).to(cuda)
  nv = torch.tensor([1024, 1000, 777, 512, 300, 1024, 64, 900] * 2,
                    device=cuda)
  w = (torch.arange(1024, device=cuda) < nv[:, None]).float()
  x = x * w[..., None]
  n_clusters = torch.tensor([2, 3, 4, 5, 6, 7, 7, 3] * 2, device=cuda)
  keys = np.stack([prng.key(100 + i) for i in range(16)])
  fused.reset_launch_counts()
  labels, cents, rounds = fused.kmeans(x, n_clusters, keys, 7, w,
                                       max_iter=300)
  assert fused.launch_counts()["kmeans"] == 1
  want = fused.kmeans_plain(x, n_clusters, keys, 7, w, max_iter=300)
  assert torch.equal(labels, want[0]) and torch.equal(rounds, want[2])
  for i in range(16):
    alone = fused.kmeans(x[i], n_clusters[i], keys[i], 7, w[i], max_iter=300)
    assert torch.equal(labels[i], alone[0])
    assert torch.equal(rounds[i], alone[2])
    assert torch.equal(cents[i], alone[1])


def test_kmeans_fit_is_one_launch_and_no_host_read(cuda):
  # kmeans_fit on the card: one kernel-8 launch a call, and no host sync
  # (its count and weights on the card, its key by value); the rounds
  # counter is read with the call's counters.
  from spectralcluster_tpu_torch.ops import kmeans as t_kmeans
  x = torch.as_tensor(_km_points(1000, 4, 9)).to(cuda)
  nc = torch.tensor(4, device=cuda)
  w = torch.ones((1000,), device=cuda)
  gen = torch.Generator().manual_seed(5)
  t_kmeans.kmeans_fit(x, nc, gen, k_max=7, sample_weight=w, max_iter=300)
  timings = observability.StageTimings(cuda)
  fused.reset_launch_counts()
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    for _ in range(3):
      labels = t_kmeans.kmeans_fit(x, nc, gen, k_max=7, sample_weight=w,
                                   max_iter=300, timings=timings)
  finally:
    torch.cuda.set_sync_debug_mode("default")
  assert fused.launch_counts()["kmeans"] == 3
  assert sum(fused.launch_counts().values()) == 3
  want = fused.kmeans_plain(x, nc, prng.key(5), 7, w, max_iter=300)
  assert torch.equal(labels, want[0])
  assert timings.counters() == {"kmeans_kernel": 3,
                                "lloyd_rounds": 3 * int(want[2])}


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
  counts = fused.launch_counts()
  assert all(counts[k] > 0 for k in _MAIN_KERNELS | {"row_wise_normalize"})
  assert "host_eig" in result.timings
  np.testing.assert_array_equal(utils.enforce_ordered_labels(result.labels),
                                _reference(512))


@pytest.mark.parametrize("staged", [False, True])
def test_spans_are_timed_by_events_on_the_card(cuda, monkeypatch, staged):
  # Spans on, both executors: every span carries its CUDA event pair's
  # device seconds, as ClusterResult.timings does, and no span syncs the
  # card; the labels are those of the untraced run.
  rec = observability.CallRecord()
  monkeypatch.setattr(observability, "RECORD", rec)
  x = make_embeddings(1024)
  plain = configs.make_icassp2018_clusterer(
      staged_execution_min_n=512 if staged else None).predict(x)

  def no_sync(*_a, **_k):
    raise AssertionError("a span synchronized the card")

  monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
  result = configs.make_icassp2018_clusterer(
      staged_execution_min_n=512 if staged else None,
      staged_stage_timings=True).predict_with_details(x)
  np.testing.assert_array_equal(result.labels, plain)
  middle = ({"staged_prep", "staged_eigh", "staged_finish"} if staged
            else {"refine", "eigh"})
  assert set(result.timings) == {"pipeline", "upload", "kmeans",
                                 "download"} | middle
  assert result.counters["lloyd_rounds"] >= 1
  (call,) = rec.last()
  assert call.spans[0].name == "predict"
  for s in call.spans:
    assert s.device_s is not None and s.device_s > 0
  for s in call.spans[1:]:
    assert abs(result.timings[s.name] - s.device_s) < 1e-12
  # The stages tile the pipeline span on the device's timeline.
  pipe = result.timings["pipeline"]
  assert sum(v for k, v in result.timings.items()
             if k in middle | {"upload", "download"}
             or (k == "kmeans" and not staged)) <= pipe * 1.001


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
  # A ragged batch: the card's labels equal the CPU's, and the batched
  # step launches kernels 1-4 once for the chunk (row_max twice).
  utts = _batch_utterances((300, 512, 200, 450, 512, 64))
  fused.reset_launch_counts()
  got = batch.cluster_batch(utts, _batch_cfg(), mesh_lib.make_mesh())
  counts = fused.launch_counts()
  want = batch.cluster_batch(utts, _batch_cfg(), mesh_lib.make_mesh(
      devices=[torch.device("cpu")]))
  for a, b in zip(got, want):
    np.testing.assert_array_equal(utils.enforce_ordered_labels(a),
                                  utils.enforce_ordered_labels(b))
  # One chunk on one card: each batched kernel once (row_max twice); the
  # batched eigh runs none of the subspace solver's kernels.
  assert counts == {"affinity": 0, "row_max": 0, "crop_diagonal": 0,
                    "threshold_symmetrize_general": 0,
                    "row_wise_normalize": 0, "affinity_batched": 1,
                    "row_max_batched": 2, "crop_diagonal_batched": 1,
                    "threshold_symmetrize_general_batched": 1,
                    "row_wise_normalize_batched": 0, "panel_matmul": 0,
                    "cholqr_pass": 0, "cholqr_pass_pair": 0, "kmeans": 1}


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


@pytest.mark.parametrize("largest", [True, False])
def test_subspace_batched_card_matches_2d_per_lane(cuda, largest):
  # Lanes that stop at different chunks (geometric spectra r**j) and one
  # valid row: each lane's Ritz values within 1e-4·max|λ| of its 2-D solve
  # on the card, and its iterations.
  n, nvs = 256, (256, 200, 256, 1)
  q, _ = np.linalg.qr(np.random.RandomState(0).randn(n, n))
  mats = np.zeros((len(nvs), n, n), np.float32)
  for i, (r, nv) in enumerate(zip((0.9, 0.98, 0.995), nvs)):
    lam = r ** np.arange(n)
    a = (q * (lam if largest else 2.0 - lam)) @ q.T
    mats[i, :nv, :nv] = (0.5 * (a + a.T))[:nv, :nv]
  mats[3, 0, 0] = 2.5
  mats = torch.as_tensor(mats).to(cuda)

  def solve(m, nv, stats):
    return eigen.topk_eigh_subspace_masked(
        m, 8, torch.Generator().manual_seed(42), largest, nv,
        residual_tol=2e-3, drift_tol=1e-4, stats=stats)

  stats = {}
  w, _ = solve(mats, torch.tensor(nvs, device=cuda), stats)
  iters = []
  for i, nv in enumerate(nvs):
    alone = {}
    w1, _ = solve(mats[i], nv, alone)
    scale = float(torch.amax(torch.abs(w1)))
    torch.testing.assert_close(w[i], w1, rtol=0, atol=1e-4 * scale)
    iters.append((int(stats["iters"][i]), alone["iters"]))
  assert all(a == b for a, b in iters)
  assert len({a for a, _ in iters}) >= 2


@pytest.mark.parametrize("eigensolver", [EigenSolver.SubspaceIteration,
                                         EigenSolver.HostGeneral])
def test_batched_solvers_card_match_the_2d_pipeline(cuda, eigensolver):
  # One chunk of ragged utterances through the batched solver (or kernel 5b
  # and the batched host eig) against the 2-D pipeline per utterance on the
  # card: labels and counts equal, Ritz values within 1e-4·max|λ| (bmm and
  # mm may sum in other orders on the card).
  lengths = (300, 512, 200, 450)
  utts = _batch_utterances(lengths, seed=2)
  x = torch.zeros((len(lengths), 512, 64), device=cuda)
  for i, u in enumerate(utts):
    x[i, :len(u)] = torch.as_tensor(u)
  nv = torch.tensor(lengths, dtype=torch.int32, device=cuda)
  cfg = _batch_cfg().replace(eigensolver=eigensolver)
  keys = np.stack([prng.key(i) for i in range(len(lengths))])
  fused.reset_launch_counts()
  labels, n_clusters, w, _ = pipeline.spectral_cluster_fixed_k_batched(
      x, keys, cfg, n_valid=nv)
  counts = fused.launch_counts()
  general = eigensolver == EigenSolver.HostGeneral
  assert counts["row_wise_normalize_batched"] == int(general)
  assert counts["row_wise_normalize"] == 0
  for i, n in enumerate(lengths):
    want = pipeline.spectral_cluster_fixed_k(
        x[i], torch.Generator().manual_seed(i), cfg, n_valid=n)
    assert torch.equal(labels[i], want[0])
    assert int(n_clusters[i]) == int(want[1])
    top = w[i][:8] if general else w[i]
    scale = float(torch.amax(torch.abs(want[2][:8])))
    torch.testing.assert_close(top, want[2][:8], rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("n,use_ring", [(512, False), (509, True)])
def test_cluster_large_sharded_card_matches_cpu(cuda, n, use_ring):
  # Four in-process shards on the card against four on the CPU (509: 3 pad
  # rows): the same labels, the reference's at 512, no refinement kernel
  # launch, the subspace solver's kernels on every stripe, and one K-Means
  # launch (kernel 8) on the gathered embedding.
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300)
  x = make_embeddings(512)[:n]
  fused.reset_launch_counts()
  got, got_n = sharded.cluster_large_sharded(
      x, cfg, mesh_lib.make_mesh(dp=1, mp=4, devices=[cuda] * 4),
      use_ring_affinity=use_ring)
  counts = fused.launch_counts()
  solver = ("panel_matmul", "cholqr_pass_pair")
  assert not any(v for k, v in counts.items()
                 if k not in solver + ("kmeans",))
  assert all(counts[k] for k in solver) and counts["kmeans"] == 1
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


# The subspace solver's kernels (6-7) and its Gram. Each output of kernel 6
# and of the card's Gram is a float64 sum of exact products rounded once,
# so it lies within the float32 bound of the twin's K-term sum,
# 2·K·2⁻²⁴·(|a|·|x|), and within one float32 rounding of a float64
# product (plus the float64 sum's own bound, K·2⁻⁵²·(|a|·|x|)).
def _within_sum_bound(got, want, a, x):
  magnitude = torch.matmul(torch.abs(a).double(), torch.abs(x).double())
  k = a.shape[-1]
  assert bool(torch.all(torch.abs(got - want).double()
                        <= 2.0 * k * 2.0**-24 * magnitude))
  exact = torch.matmul(a.double(), x.double())
  assert bool(torch.all(torch.abs(got.double() - exact)
                        <= 2.0**-24 * torch.abs(exact)
                        + k * 2.0**-52 * magnitude))


# Beside the solver's shapes, the kernel's edges: m around its 128-row
# blocks, k around its 32-deep tiles and 96-deep x chunks, b around its
# 8-column MMA groups and 32-column launches, batches of 1 and 16.
@pytest.mark.parametrize("shape", [(20480, 20480, 16), (10240, 10240, 8),
                                   (1000, 1000, 1), (999, 1001, 17),
                                   (16, 1024, 1024, 16), (2, 37, 37, 5),
                                   (5120, 20480, 16), (129, 95, 32),
                                   (127, 97, 9), (1, 300, 8), (300, 1, 3),
                                   (1, 1000, 1000, 1), (16, 129, 191, 17),
                                   (3, 1000, 33, 40)])
def test_panel_matmul(cuda, shape):
  *lead, m, k, b = shape
  gen = torch.Generator(cuda).manual_seed(3)
  a = torch.randn((*lead, m, k), generator=gen, device=cuda)
  x = torch.randn((*lead, k, b), generator=gen, device=cuda)
  got = fused.panel_matmul(a, x)
  _within_sum_bound(got, fused.panel_matmul_plain(a, x), a, x)


def test_panel_matmul_stripe_and_transposed_panel(cuda):
  # A row stripe of a larger matrix, and a panel that is the transpose of a
  # contiguous matrix (the solver's layout): the stripe's rows of the whole
  # product, bit for bit.
  gen = torch.Generator(cuda).manual_seed(4)
  a = torch.randn((4096, 4096), generator=gen, device=cuda)
  x = torch.randn((16, 4096), generator=gen, device=cuda).T
  whole = fused.panel_matmul(a, x)
  assert torch.equal(fused.panel_matmul(a[1024:2048], x), whole[1024:2048])
  assert torch.equal(whole, fused.panel_matmul(a, x.contiguous()))


@pytest.mark.parametrize("b", [1, 8, 16, 17, 32])
@pytest.mark.parametrize("lead", [(), (16,)])
def test_panel_matmul_widths_pitch_and_determinism(cuda, b, lead):
  # Each width in one launch, a row pitch of k + 1 floats
  # (not a multiple of 16 bytes: the kernel's 4-byte loads) beside the
  # aligned operand, and two calls on the same inputs with equal bits.
  m, k = (1000, 1000) if lead else (4099, 4096)
  gen = torch.Generator(cuda).manual_seed(7)
  wide = torch.randn((*lead, m, k + 1), generator=gen, device=cuda)
  a = wide[..., :k]
  x = torch.randn((*lead, k, b), generator=gen, device=cuda)
  for mat in (a, a.contiguous()):
    fused.reset_launch_counts()
    got = fused.panel_matmul(mat, x)
    assert fused.launch_counts()["panel_matmul"] == 1
    _within_sum_bound(got, fused.panel_matmul_plain(mat, x), mat, x)
    assert torch.equal(got, fused.panel_matmul(mat, x))


@pytest.mark.parametrize("shape", [(20480, 16, 16), (10240, 16, 8),
                                   (16, 1024, 16, 16), (999, 19, 3),
                                   (1, 40, 40)])
def test_panel_gram(cuda, shape):
  *lead, k, p, r = shape
  gen = torch.Generator(cuda).manual_seed(5)
  a = torch.randn((*lead, k, p), generator=gen, device=cuda)
  b = torch.randn((*lead, k, r), generator=gen, device=cuda)
  got = eigen.panel_gram(a, b)
  at = a.transpose(-1, -2)
  _within_sum_bound(got, torch.matmul(at, b), at, b)


@pytest.mark.parametrize("shape", [(20480, 16), (3, 1024, 16), (999, 19),
                                   (300, 40)])
@pytest.mark.parametrize("delta_rel", [1e-6, 1e-2])
def test_cholqr_pass(cuda, shape, delta_rel):
  # One pass against cuSOLVER's Cholesky and cuBLAS's solve: float32
  # factorizations in other orders, within 1e-5; the same info.
  gen = torch.Generator(cuda).manual_seed(6)
  y = torch.randn(shape, generator=gen, device=cuda)
  gram = eigen.panel_gram(y, y)
  q, info = fused.cholqr_pass(y, gram, delta_rel)
  q_plain, info_plain = fused.cholqr_pass_plain(y, gram, delta_rel)
  torch.testing.assert_close(q, q_plain, rtol=0, atol=1e-5)
  assert torch.equal(info.long(), info_plain.long()) and not bool(info.any())
  # The transposed layout of the same panel gives the same bits.
  q_t, _ = fused.cholqr_pass(y.transpose(-1, -2).contiguous()
                             .transpose(-1, -2), gram, delta_rel)
  assert torch.equal(q_t, q)


@pytest.mark.parametrize("shape", [(20480, 16), (3, 1024, 16), (999, 19),
                                   (300, 40), (16, 1024, 8), (257, 1)])
def test_cholqr_pass_pair(cuda, shape):
  # One launch: each pass equal bit for bit to the single-pass kernel (the
  # parent's code) at its shift, and within 1e-5 of cuSOLVER's and
  # cuBLAS's (twin); the same info; no panel flagged; the workspace zero
  # again after the launch.
  gen = torch.Generator(cuda).manual_seed(8)
  y = torch.randn(shape, generator=gen, device=cuda)
  gram = eigen.panel_gram(y, y)
  fused.reset_launch_counts()
  q1, q2, info, bad = fused.cholqr_pass_pair(y, gram, 1e-6, 1e-2)
  assert fused.launch_counts()["cholqr_pass_pair"] == 1
  for q, rel in ((q1, 1e-6), (q2, 1e-2)):
    alone, alone_info = fused.cholqr_pass(y, gram, rel)
    assert torch.equal(q, alone)
    if rel == 1e-6:
      assert torch.equal(info, alone_info)
    plain, _ = fused.cholqr_pass_plain(y, gram, rel)
    torch.testing.assert_close(q, plain, rtol=0, atol=1e-5)
  w1, w2, w_info, w_bad = fused.cholqr_pass_pair_plain(y, gram, 1e-6, 1e-2)
  assert torch.equal(info.long(), w_info.long()) and not bool(info.any())
  assert torch.equal(bad, w_bad) and not bool(bad.any())
  assert not bool(fused._qr_tickets(y.device).any())


def test_cholqr_pass_pair_flags_the_failed_panels(cuda):
  # A batch of four panels: an Inf in one, an indefinite Gram in another.
  # Only those two are flagged (the twin agrees), whatever block holds the
  # Inf; the workspace is zero after each launch.
  gen = torch.Generator(cuda).manual_seed(9)
  y = torch.randn((4, 3000, 16), generator=gen, device=cuda)
  gram = eigen.panel_gram(y, y)
  y[1, 2999, 5] = torch.inf
  gram[3] = -torch.eye(16, device=cuda)
  q1, q2, info, bad = fused.cholqr_pass_pair(y, gram, 1e-6, 1e-2)
  _, _, w_info, w_bad = fused.cholqr_pass_pair_plain(y, gram, 1e-6, 1e-2)
  assert bad.tolist() == [False, True, False, True] == w_bad.tolist()
  assert info.tolist() == [0, 0, 0, 1] == w_info.tolist()
  assert bool(torch.isfinite(q2[0]).all()) and bool(torch.isfinite(q2[2]).all())
  assert not bool(fused._qr_tickets(y.device).any())
  y[1, 0, 0] = -torch.inf
  _, _, _, bad = fused.cholqr_pass_pair(y[1], gram[1], 1e-6, 1e-2)
  assert bool(bad)
  assert not bool(fused._qr_tickets(y.device).any())


def test_cholqr_pass_failed_factorization(cuda):
  y = torch.randn((4096, 16), device=cuda)
  bad = -torch.eye(16, device=cuda)
  q, info = fused.cholqr_pass(y, bad, 1e-6)
  _, info_plain = fused.cholqr_pass_plain(y, bad, 1e-6)
  assert int(info) == int(info_plain) == 1
  assert not bool(torch.isfinite(q).all())


# Recordings of portbench's long traffic (seed, position in its pool) on
# which the Auto top-k route counted wrong on the card: 202/9 (N=10035,
# 2 speakers) returned cluster eigenpairs near 0 in place of 0.82, 0.57
# and 0.53, from both the certified attempt and the split's deflated
# remainder. tools/diagnose_dc_route.py --witness reads their routes.
_DC_WITNESSES = [(201, 2), (202, 7), (202, 9)]


@pytest.mark.parametrize("seed,index", _DC_WITNESSES)
def test_auto_counts_long_recordings_as_the_float64_reference(cuda, seed,
                                                              index):
  import json
  from portbench import compare, generator
  from portbench.reference import icassp2018 as reference
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

  def load(*parts):
    with open(os.path.join(root, "portbench", *parts)) as f:
      return json.load(f)

  config = load("configs", "icassp2018.json")
  rec = generator.make_pool(load("traffic", "long.json"), seed)[index]
  result = configs.make_icassp2018_clusterer(
      device="cuda", staged_stage_timings=True).predict_with_details(
          rec.embeddings)
  got = compare.call_numbers(
      {"labels": result.labels, "n_clusters": result.n_clusters,
       "eigenvalues": result.eigenvalues},
      reference.solve(rec, config, "float64", "cuda"))
  assert got["n_clusters_diff"] == 0 and got["label_error"] == 0, (
      got, result.counters)
  limit = load("limits", "icassp2018.long.json")["limits"]["eig_err_max"]
  assert got["eig_err"] <= limit, (got, result.counters)
