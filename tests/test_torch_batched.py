"""The port's batched step against the JAX package's vmapped one (CPU).

On the same numpy inputs:

  * the plain twins of kernels 1-4, which the batched wrappers run on the
    CPU, against the 2-D twins per utterance, bit for bit, with ragged
    n_valid;
  * the batched refinement against ``jax.vmap`` of the JAX package's
    ``apply_refinement_sequence`` (its plain route) with (B,) n_valid and
    p_percentile: 1e-5 relative, the tolerance of ``test_torch_ops.py``
    (float32 sums of Diffuse in another order);
  * K-Means: the device stop flag against the host loop it replaced (kept
    here as the reference), and the batched Lloyd against the loop per
    utterance, bit for bit with round counts; ``kmeans_fit_batched``
    against ``jax.vmap(kmeans_fit)``, labels id for id;
  * ``spectral_cluster_fixed_k_batched`` against the 2-D pipeline per
    utterance, bit for bit, for every route of the batched step;
  * ``make_batched_cluster_fn``, ``make_batched_autotune_eval_fn`` and
    ``make_batched_kmeans_fn`` against the JAX package's on a JAX mesh of
    one CPU device: labels id for id, n_clusters equal, AutoTune deltas
    within 1e-4 relative (eigenvalue gaps of another eigh);
  * the three drivers, now one batched step per chunk, against the JAX
    package's labels recorded in ``tests/data/reference_batch.npz`` at
    N=1024 (a few of its utterances: each one's labels do not depend on
    the others);
  * ``observability.block_and_time`` and ``profile_trace``, as
    ``tests/test_aux.py`` tests the JAX package's.

The JAX side stays at N <= 64 and B <= 6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import pipeline as j_pipeline
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu.ops import kmeans as j_kmeans
from spectralcluster_tpu.ops import refinement as j_ref
from spectralcluster_tpu.parallel import batch as j_batch
from spectralcluster_tpu.parallel import mesh as j_mesh
from spectralcluster_tpu_torch import (configs, constraint, convert,
                                       observability, pipeline, prng)
from spectralcluster_tpu_torch.fixtures import make_batch, make_t2d_fixture
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.ops import affinity as t_aff
from spectralcluster_tpu_torch.ops import kmeans as t_kmeans
from spectralcluster_tpu_torch.ops import refinement as t_ref
from spectralcluster_tpu_torch.parallel import batch
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
from spectralcluster_tpu_torch.types import EigenSolver, LaplacianType

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N_VALID = (64, 41, 9, 64, 1)        # ragged, a full one, a single row


def _stack(n=64, seed=0, shift=-0.25):
  """(B, n, n) float32 matrices, each zero past its n_valid."""
  rng = np.random.RandomState(seed)
  a = rng.rand(len(N_VALID), n, n).astype(np.float32) + shift
  for i, nv in enumerate(N_VALID):
    a[i, nv:] = 0.0
    a[i, :, nv:] = 0.0
  return a


def _utterances(lengths, d=16, k=3, seed=0, noise=0.3):
  rng = np.random.RandomState(seed)
  out = []
  for n in lengths:
    centers = rng.randn(k, d) * 2
    labels = np.repeat(np.arange(k), -(-n // k))[:n]
    out.append((centers[labels] + rng.randn(n, d) * noise).astype(np.float32))
  return out


def _padded(utts, n_pad=None):
  n_pad = n_pad or pipeline.pad_bucket(max(u.shape[0] for u in utts))
  x = np.zeros((len(utts), n_pad, utts[0].shape[1]), np.float32)
  for i, u in enumerate(utts):
    x[i, :u.shape[0]] = u
  return x, np.array([u.shape[0] for u in utts], np.int32)


def _chain_constraints(lengths, n_pad):
  cms = np.zeros((len(lengths), n_pad, n_pad), np.float32)
  for i, n in enumerate(lengths):
    for j in range(n - 1):
      cms[i, j, j + 1] = cms[i, j + 1, j] = 1.0 if j % 3 else -1.0
  return cms


# ---------------------------------------------------------------------------
# Kernels 1-4: the batched wrappers' CPU path (the twins) per utterance.
# ---------------------------------------------------------------------------


def test_affinity_batched_twin_per_utterance():
  x = np.random.RandomState(0).randn(5, 40, 24).astype(np.float32)
  got = fused.affinity_batched(torch.from_numpy(x))
  for i in range(5):
    assert torch.equal(got[i], fused.affinity(torch.from_numpy(x[i])))


@pytest.mark.parametrize("exclude", [False, True])
def test_row_max_batched_twin_per_utterance(exclude):
  a = torch.from_numpy(_stack())
  nv = torch.tensor(N_VALID)
  got = fused.row_max_batched(a, exclude, nv)
  assert got.shape == (5, 64, 1)
  for i, n in enumerate(N_VALID):
    assert torch.equal(got[i], fused.row_max(a[i], exclude, n))
  full = fused.row_max_batched(a, exclude)
  for i in range(5):
    assert torch.equal(full[i], fused.row_max(a[i], exclude))


def test_crop_diagonal_batched_twin_per_utterance():
  a = torch.from_numpy(_stack())
  got = fused.crop_diagonal_batched(a, torch.tensor(N_VALID), inplace=True)
  for i, n in enumerate(N_VALID):
    assert torch.equal(got[i], fused.crop_diagonal(a[i], n))


@pytest.mark.parametrize("flags", [
    {}, dict(binarize=True, preserve_diagonal=True, average=True)])
def test_threshold_symmetrize_batched_twin_per_utterance(flags):
  a = torch.from_numpy(_stack())
  thr = fused.row_max_batched(a, n_valid=torch.tensor(N_VALID)) * 0.8
  got = fused.threshold_symmetrize_general_batched(a, thr, 0.01, **flags)
  for i in range(5):
    assert torch.equal(got[i], fused.threshold_symmetrize_general(
        a[i], thr[i], 0.01, **flags))


def test_batched_wrappers_check_their_inputs():
  meta = torch.empty((2, 8, 8), device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    fused.row_max_batched(meta)
  with pytest.raises(ValueError, match="unsupported device"):
    fused.affinity_batched(torch.empty((2, 8, 4), device="meta"))


# ---------------------------------------------------------------------------
# Refinement: the batch against jax.vmap of the JAX package's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["icassp2018", "turntodiarize"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_batched_refinement_matches_vmapped_jax(preset, use_kernels):
  a = _stack(shift=0.0)
  nv = np.array(N_VALID, np.int32)
  ps = np.array([0.95, 0.8, 0.6, 0.9, 0.7], np.float32)
  if preset == "icassp2018":
    ours_opts = configs.icassp2018_refinement_options()
    ref_opts = j_configs.icassp2018_refinement_options()
  else:
    ours_opts = configs.turntodiarize_refinement_options()
    ref_opts = j_configs.turntodiarize_refinement_options()
  ours = t_ref.apply_refinement_sequence(
      torch.from_numpy(a), ours_opts, p_percentile=torch.from_numpy(ps),
      n_valid=torch.from_numpy(nv), use_kernels=use_kernels,
      consume_input=True)
  ref = jax.vmap(lambda m, n, p: j_ref.apply_refinement_sequence(
      m, ref_opts, p_percentile=p, n_valid=n, use_pallas=False))(
          jnp.asarray(a), jnp.asarray(nv), jnp.asarray(ps))
  np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-6)
  # Each matrix as alone, bit for bit (a single valid row normalizes 0/0
  # to NaN in both).
  for i, n in enumerate(N_VALID):
    alone = t_ref.apply_refinement_sequence(
        torch.from_numpy(a[i]), ours_opts, p_percentile=torch.tensor(ps[i]),
        n_valid=n, use_kernels=use_kernels)
    torch.testing.assert_close(alone, ours[i], rtol=0, atol=0,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# K-Means.
# ---------------------------------------------------------------------------


def _host_loop_lloyd(x, centroids, n_clusters, dist_fn, max_iter, tol, w):
  """The Lloyd loop before the stop flag moved to the device: one host
  read of the stop rule per round. Returns (labels, centroids, rounds)."""
  k_max = centroids.shape[0]
  col_ok = torch.arange(k_max) < n_clusters
  it, prev, c = 0, torch.zeros(()), centroids
  while True:
    dist = torch.where(col_ok[None, :], dist_fn(x, c), torch.inf)
    labels = torch.argmin(dist, dim=1)
    mind = torch.amin(dist, dim=1)
    mean_dist = torch.sum(torch.where(w > 0, mind, 0.0) * w) / torch.sum(w)
    if bool((mean_dist <= prev) & (mean_dist >= (1.0 - tol) * prev)) or (
        it >= max_iter):
      return labels.to(torch.int32), c, it + 1
    c = t_kmeans._update_centroids(x, labels, w, c)
    prev = mean_dist
    it += 1


def _kmeans_inputs(b=6, n=64, k=5, k_max=7, seed=0):
  rng = np.random.RandomState(seed)
  lengths = np.array([64, 50, 33, 64, 12, 45][:b])
  x = torch.from_numpy(rng.randn(b, n, k).astype(np.float32))
  w = torch.from_numpy(
      (np.arange(n)[None] < lengths[:, None]).astype(np.float32))
  n_clusters = torch.tensor([2, 3, 7, 5, 4, 6][:b])
  keys = np.stack([prng.key(seed + i) for i in range(b)])
  return x, w, n_clusters, keys, k_max


@pytest.mark.parametrize("max_iter,tol", [(300, 0.001), (3, 0.001),
                                          (300, 0.2)])
@pytest.mark.parametrize("metric", ["cosine", "sqeuclidean"])
def test_lloyd_batched_matches_the_host_loop(max_iter, tol, metric):
  x, w, n_clusters, keys, k_max = _kmeans_inputs()
  centroids = t_kmeans.kmeans_plusplus_batched(x, k_max, keys, w)
  labels, c, rounds = t_kmeans.lloyd_iterations_batched(
      x, centroids, n_clusters, t_aff.get_batched_distance_fn(metric),
      max_iter, tol, w)
  for i in range(x.shape[0]):
    assert torch.equal(centroids[i], t_kmeans.kmeans_plusplus(
        x[i], k_max, None, w[i], key=keys[i]))
    want = _host_loop_lloyd(x[i], centroids[i], n_clusters[i],
                            t_aff.get_distance_fn(metric), max_iter, tol,
                            w[i])
    alone = t_kmeans._lloyd(x[i], centroids[i], n_clusters[i],
                            t_aff.get_distance_fn(metric), max_iter, tol,
                            w[i])
    for got in ((labels[i], c[i], rounds[i]), alone):
      assert torch.equal(got[0], want[0])
      assert torch.equal(got[1], want[1])
      assert int(got[2]) == want[2]
  assert int(rounds.max()) <= max_iter + 1


@pytest.mark.parametrize("check_every", [1, 5, 10_000])
def test_lloyd_stop_reads_change_no_label(check_every):
  x, w, n_clusters, keys, k_max = _kmeans_inputs(seed=3)
  centroids = t_kmeans.kmeans_plusplus_batched(x, k_max, keys, w)
  want = t_kmeans.lloyd_iterations_batched(
      x, centroids, n_clusters, t_aff.get_batched_distance_fn("cosine"),
      300, 0.001, w)
  got = t_kmeans._lloyd(x, centroids, n_clusters,
                        t_aff.get_batched_distance_fn("cosine"), 300, 0.001,
                        w, check_every=check_every)
  for a, b in zip(got, want):
    assert torch.equal(a, b)


def test_standard_lloyd_batched_per_utterance():
  x, w, n_clusters, keys, k_max = _kmeans_inputs(seed=4)
  centroids = t_kmeans.kmeans_plusplus_batched(x, k_max, keys, w)
  labels, c = t_kmeans.standard_lloyd(x, centroids, n_clusters,
                                      sample_weight=w)
  for i in range(x.shape[0]):
    li, ci = t_kmeans.standard_lloyd(x[i], centroids[i], n_clusters[i],
                                     sample_weight=w[i])
    assert torch.equal(li, labels[i]) and torch.equal(ci, c[i])


@pytest.mark.parametrize("metric", ["cosine", None])
def test_kmeans_fit_batched_matches_vmapped_jax(metric):
  x, w, n_clusters, keys, k_max = _kmeans_inputs(seed=1)
  ours = t_kmeans.kmeans_fit_batched(x, n_clusters, keys, custom_dist=metric,
                                     max_iter=300, k_max=k_max,
                                     sample_weight=w)
  ref = jax.vmap(lambda xi, nc, key, wi: j_kmeans.kmeans_fit(
      xi, nc, key, custom_dist=metric, max_iter=300, k_max=k_max,
      sample_weight=wi))(jnp.asarray(x.numpy()), jnp.asarray(n_clusters),
                         jnp.asarray(keys), jnp.asarray(w.numpy()))
  np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_batched_distances_per_utterance():
  rng = np.random.RandomState(2)
  x = torch.from_numpy(rng.randn(3, 20, 6).astype(np.float32))
  y = torch.from_numpy(rng.randn(3, 4, 6).astype(np.float32))
  for metric in t_aff.supported_distances():
    got = t_aff.get_batched_distance_fn(metric)(x, y)
    for i in range(3):
      assert torch.equal(got[i], t_aff.get_distance_fn(metric)(x[i], y[i]))


# ---------------------------------------------------------------------------
# The batched pipeline against the 2-D one, and against the JAX step.
# ---------------------------------------------------------------------------


def _icassp():
  return pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, max_iter=300)


def _t2d_cfg(**kw):
  return pipeline.PipelineConfig(
      refinement_options=configs.turntodiarize_refinement_options(),
      constraint_options=configs.turntodiarize_constraint_options(),
      laplacian_type=LaplacianType.GraphCut, min_clusters=2, max_clusters=7,
      row_wise_renorm=True, **kw)


@pytest.mark.parametrize("route", ["auto", "subspace", "plain_ops",
                                   "host_general", "t2d_autotune"])
def test_fixed_k_batched_equals_the_2d_pipeline(route):
  lengths = [40, 64, 23, 57]
  x, nv = _padded(_utterances(lengths, seed=1))
  cms = None
  cfg = {"auto": _icassp(),
         "subspace": _icassp().replace(
             eigensolver=EigenSolver.SubspaceIteration),
         "plain_ops": _icassp().replace(use_kernels=False),
         "host_general": _icassp().replace(eigensolver=EigenSolver.HostGeneral),
         "t2d_autotune": _t2d_cfg(autotune=pipeline.AutoTuneStatic(
             0.4, 0.95, 0.05))}[route]
  if route == "t2d_autotune":
    cms = torch.from_numpy(_chain_constraints(lengths, x.shape[1]))
  keys = np.stack([prng.key(5 + i) for i in range(4)])
  labels, n_clusters, w, delta = pipeline.spectral_cluster_fixed_k_batched(
      torch.from_numpy(x), keys, cfg, cms, torch.from_numpy(nv))
  for i, n in enumerate(lengths):
    want = pipeline.spectral_cluster_fixed_k(
        torch.from_numpy(x[i]), torch.Generator().manual_seed(5 + i), cfg,
        n_valid=n, constraint_matrix=None if cms is None else cms[i])
    for got, exp in zip((labels[i], n_clusters[i], w[i], delta[i]), want):
      assert torch.equal(got, exp)


def _jax_mesh():
  return j_mesh.make_mesh(dp=1, mp=1, devices=jax.devices()[:1])


def _jax_keys(seed, b):
  return np.asarray(jax.vmap(jax.random.PRNGKey)(seed + np.arange(b)))


@pytest.mark.parametrize("eigensolver", ["Auto", "SubspaceIteration",
                                         "HostGeneral"])
def test_make_batched_cluster_fn_matches_jax(eigensolver):
  # SubspaceIteration: JAX's vmapped while_loop, each lane frozen at its
  # own convergence; HostGeneral: kernel 5 and the host eig per chunk.
  jcfg = j_pipeline.PipelineConfig(
      refinement_options=j_configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300,
      eigensolver=j_types.EigenSolver[eigensolver])
  cfg = convert.pipeline_config_from(jcfg)
  lengths = [64, 50, 33, 64]
  x, nv = _padded(_utterances(lengths, seed=2, noise=0.5))
  keys = _jax_keys(0, 4)
  np.testing.assert_array_equal(
      keys, np.stack([prng.key(i) for i in range(4)]))
  fn = batch.make_batched_cluster_fn(cfg, mesh_lib.make_mesh(
      dp=2, devices=[CPU] * 2))
  labels, n_clusters = fn(x, nv, keys)
  j_labels, j_n = j_batch.make_batched_cluster_fn(jcfg, _jax_mesh())(
      jnp.asarray(x), jnp.asarray(nv), jnp.asarray(keys))
  np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
  np.testing.assert_array_equal(n_clusters.numpy(), np.asarray(j_n))


def test_make_batched_autotune_eval_and_kmeans_fns_match_jax():
  jcfg = j_pipeline.PipelineConfig(
      refinement_options=j_configs.turntodiarize_refinement_options(),
      constraint_options=j_configs.turntodiarize_constraint_options(),
      laplacian_type=j_types.LaplacianType.GraphCut,
      min_clusters=2, max_clusters=7, row_wise_renorm=True,
      custom_dist="cosine")
  cfg = convert.pipeline_config_from(jcfg)
  lengths = [48, 64, 30]
  x, nv = _padded(_utterances(lengths, seed=3, k=2, noise=0.2))
  cms = _chain_constraints(lengths, x.shape[1])
  ps = np.array([[0.6, 0.7, 0.8], [0.9, 0.65, 0.75], [0.85, 0.85, 0.85]],
                np.float32)
  mesh = mesh_lib.make_mesh(dp=1, devices=[CPU])
  vs, ns, deltas = batch.make_batched_autotune_eval_fn(cfg, mesh, True)(
      x, nv, ps, cms)
  j_vs, j_ns, j_deltas = j_batch.make_batched_autotune_eval_fn(
      jcfg, _jax_mesh(), True)(jnp.asarray(x), jnp.asarray(nv),
                               jnp.asarray(ps), jnp.asarray(cms))
  assert vs.shape == np.asarray(j_vs).shape
  np.testing.assert_array_equal(ns.numpy(), np.asarray(j_ns))
  # Eigenvalue gaps of another eigh: 1e-4 relative.
  np.testing.assert_allclose(deltas.numpy(), np.asarray(j_deltas), rtol=1e-4)
  # The final stage on the same winners: labels id for id.
  best = np.asarray(j_vs)[:, 0]
  n_gap = np.asarray(j_ns)[:, 0]
  keys = _jax_keys(7, 3)
  labels, n_clusters = batch.make_batched_kmeans_fn(cfg, mesh)(
      torch.from_numpy(best.copy()), torch.from_numpy(n_gap.copy()), nv,
      keys)
  j_labels, j_n = j_batch.make_batched_kmeans_fn(jcfg, _jax_mesh())(
      jnp.asarray(best), jnp.asarray(n_gap), jnp.asarray(nv),
      jnp.asarray(keys))
  np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
  np.testing.assert_array_equal(n_clusters.numpy(), np.asarray(j_n))


# ---------------------------------------------------------------------------
# The drivers at the reference batch's N=1024.
# ---------------------------------------------------------------------------


def _reference_batch():
  with np.load(os.path.join(REPO, "tests", "data",
                            "reference_batch.npz")) as ref:
    return ref["batch_labels"], ref["t2d_labels"]


def _bench_cfg():
  # tools/record_batch_reference.py's batch_config().
  return pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300,
      eigensolver=EigenSolver.Auto)


def test_cluster_batch_and_streamed_match_the_reference():
  want, _ = _reference_batch()
  utts, _ = make_batch(16)
  mesh = mesh_lib.make_mesh(dp=2, devices=[CPU] * 2)
  got = batch.cluster_batch(utts[:3], _bench_cfg(), mesh)
  for a, b in zip(got, want[:3]):
    np.testing.assert_array_equal(a, b)
  # Chunks of two from seed 0: utterance i is seeded i, as in the record.
  streamed = batch.cluster_batch_streamed(utts[:3], _bench_cfg(), mesh,
                                          chunk=2, window=2)
  for a, b in zip(streamed, want[:3]):
    np.testing.assert_array_equal(a, b)


def test_cluster_batch_autotuned_matches_the_reference():
  _, want = _reference_batch()
  x, scores, _ = make_t2d_fixture(1024)
  cm = constraint.ConstraintMatrix(scores, threshold=1).compute_diagonals()
  got = batch.cluster_batch_autotuned(
      [x], _t2d_cfg(custom_dist="cosine"),
      configs.make_turntodiarize_auto_tune(),
      mesh_lib.make_mesh(devices=[CPU]), constraint_matrices=[cm])
  np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# Profiler helpers.
# ---------------------------------------------------------------------------


def test_block_and_time():
  out, secs = observability.block_and_time(
      lambda: {"a": (torch.ones((8, 8)) * 2.0,), "b": [3]})
  assert secs >= 0
  np.testing.assert_allclose(out["a"][0].numpy(), 2.0)
  assert out["b"] == [3]


def test_profile_trace_accepts_host_trace_kwarg(tmp_path):
  with observability.profile_trace(str(tmp_path / "trace"), host_trace=True):
    torch.ones((4, 4)).sum()
  traces = os.listdir(tmp_path / "trace")
  assert len(traces) == 1 and traces[0].endswith(".json")
