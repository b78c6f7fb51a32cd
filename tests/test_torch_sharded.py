"""The port's row-sharded path (``parallel/sharded.py``, ``ring.py``,
``sanity.py``, ``collectives.py``, ``stripes.py`` and the rest of
``mesh.py``) against the JAX package's and the port's single-device
pipeline, on the same numpy inputs (CPU).

The port runs 8 shards in one process (``make_mesh(dp=1, mp=8,
devices=[cpu] * 8)``). The JAX side runs ``cluster_large_sharded`` on one
CPU device (``JAX_PLATFORMS=cpu`` without a forced device count gives
JAX one), ring form included. Scenarios and sizes are ``tests/test_parallel.py``'s
(``TestShardedLargeN``, ``TestSanity``, ``TestRingAffinity``), plus a
padded ascending case and the icassp2018 preset at N=512 against
``benchmarks/reference_labels.npz``. Labels are compared after
``enforce_ordered_labels``: the subspace start panels differ from JAX's by
design (ROADMAP "Start panels"), and JAX at one device pads no row.

The sharded refinement operand is held against the single-device
``pipeline._symmetric_eig_operand``: bit for bit up to Diffuse, within
rtol 1e-5 of max|·| after it (its block products reorder the sums).
"""

import os

import jax
import numpy as np
import pytest
import torch

from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import pipeline as j_pipeline
from spectralcluster_tpu.ops import kmeans as j_kmeans
from spectralcluster_tpu.parallel import mesh as j_mesh
from spectralcluster_tpu.parallel import ring as j_ring
from spectralcluster_tpu.parallel import sharded as j_sharded
from spectralcluster_tpu_torch import configs, convert, pipeline, prng, utils
from spectralcluster_tpu_torch.fixtures import make_embeddings
from spectralcluster_tpu_torch.ops import affinity as affinity_ops
from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops
from spectralcluster_tpu_torch.ops import refinement as refinement_ops
from spectralcluster_tpu_torch.parallel import batch as batch_lib
from spectralcluster_tpu_torch.parallel import collectives
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
from spectralcluster_tpu_torch.parallel import ring
from spectralcluster_tpu_torch.parallel import sanity
from spectralcluster_tpu_torch.parallel import sharded
from spectralcluster_tpu_torch.parallel import stripes
from spectralcluster_tpu_torch.types import (EigenGapType, LaplacianType,
                                             RefinementName,
                                             RefinementOptions)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _mesh(dp=1, mp=8):
  return mesh_lib.make_mesh(dp=dp, mp=mp, devices=[CPU] * (dp * mp))


def _jax_mesh():
  return j_mesh.make_mesh(dp=1, mp=1, devices=jax.devices()[:1])


def _jcfg(max_clusters=4, sigma=0, max_iter=30):
  # gaussian_blur_sigma=0 by default, as in tests/test_parallel.py.
  return j_pipeline.PipelineConfig(
      refinement_options=j_configs.icassp2018_refinement_options().replace(
          gaussian_blur_sigma=sigma),
      min_clusters=2, max_clusters=max_clusters,
      custom_dist="cosine", max_iter=max_iter)


def _cfg(**kw):
  return convert.pipeline_config_from(_jcfg(**kw))


def _utterance(rng, n, d=8, k=2, noise=0.05):
  centers = np.eye(k, d) * 4.0
  labels = np.repeat(np.arange(k), -(-n // k))[:n]
  return (centers[labels] + rng.randn(n, d) * noise).astype(np.float32), labels


def _ordered(labels):
  return utils.enforce_ordered_labels(np.asarray(labels))


class TestMeshHelpers:

  def test_shardings_name_what_the_drivers_read(self):
    mesh = _mesh(dp=4, mp=2)
    assert mesh.shape == {"batch": 4, "model": 2}
    assert mesh.ranks is None
    assert mesh_lib.row_sharding(mesh, 10) == [slice(0, 5), slice(5, 10)]
    assert mesh_lib.batch_rows(mesh, 6) == [[0, 1], [2, 3], [4, 5], []]
    assert mesh_lib.batch_sharding(mesh, 6) == [CPU] * 6
    assert mesh_lib.replicated(mesh) == [CPU] * 8
    with pytest.raises(ValueError):
      mesh_lib.row_sharding(mesh, 9)
    groups = collectives.axis_groups(mesh, "model")
    assert [g.size for g in groups] == [2] * 4
    assert [g.size for g in collectives.axis_groups(mesh, "batch")] == [4, 4]
    assert collectives.model_group(mesh).shards == [0, 1]

  def test_no_silent_switch_between_backends(self):
    # A mesh of torch.distributed ranks runs the batch drivers only in a
    # joined world: without one they raise instead of computing the rows
    # of every rank in this process, and a CUDA world without a card
    # raises: nothing drops to gloo or to the CPU.
    devices = np.empty((2,), dtype=object)
    devices[:] = [CPU, CPU]
    ranked = mesh_lib.Mesh(devices.reshape(2, 1), np.arange(2).reshape(2, 1))
    with pytest.raises(ValueError, match="process group"):
      batch_lib.cluster_batch([np.zeros((8, 4), np.float32)], _cfg(), ranked)
    if not torch.cuda.is_available():
      with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.initialize_distributed("localhost:1", 1, 0)

  def test_sharded_refuses_what_jax_refuses(self):
    mesh = _mesh()
    with pytest.raises(ValueError, match="max_clusters"):
      sharded.make_sharded_cluster_fn(_cfg().replace(max_clusters=None), mesh)
    general = _cfg().replace(refinement_options=RefinementOptions(
        refinement_sequence=(RefinementName.RowWiseThreshold,)))
    with pytest.raises(ValueError, match="symmetric"):
      sharded.make_sharded_cluster_fn(general, mesh)
    # An ascending scan needs a SYMMETRIC structure; icassp2018's ends in a
    # RowWiseNormalize tail.
    with pytest.raises(ValueError, match="symmetric"):
      sharded.make_sharded_cluster_fn(
          _cfg().replace(laplacian_type=LaplacianType.GraphCut), mesh)


class TestCollectives:

  def test_in_process_collectives(self):
    group = collectives.model_group(_mesh(mp=4))
    xs = [torch.full((2, 3), float(r)) for r in range(4)]
    np.testing.assert_array_equal(group.all_gather(xs)[:, 0].numpy(),
                                  [0, 0, 1, 1, 2, 2, 3, 3])
    assert float(group.all_reduce([x.sum() for x in xs])) == 36.0
    assert float(group.all_reduce([x.max() for x in xs], "max")) == 3.0
    shifted = group.ring_shift(xs)
    assert [float(s[0, 0]) for s in shifted] == [3.0, 0.0, 1.0, 2.0]
    # sends[i][j]: i*10 + j, with i + 1 rows.
    sends = [[torch.full((i + 1, 2), float(10 * i + j)) for j in range(4)]
             for i in range(4)]
    recv = group.all_to_all(sends)
    for j in range(4):
      assert [float(b[0, 0]) for b in recv[j]] == [10 * i + j
                                                   for i in range(4)]
      assert [b.shape[0] for b in recv[j]] == [1, 2, 3, 4]


class TestShardedLargeN:

  @pytest.mark.parametrize("n,k,seed,use_ring", [
      (64, 4, 2, False),   # test_sharded_matches_unsharded_labels
      (61, 3, 3, False),   # test_autopads_indivisible_n
      (64, 4, 4, True),    # test_ring_affinity_path_matches_gspmd_path
      (59, 2, 5, True),    # test_ring_affinity_with_padding
  ])
  def test_matches_jax(self, n, k, seed, use_ring):
    rng = np.random.RandomState(seed)
    x, true = _utterance(rng, n, d=16, k=k)
    labels, n_clusters = sharded.cluster_large_sharded(
        x, _cfg(), mesh=_mesh(), num_iters=16, use_ring_affinity=use_ring)
    j_labels, j_n = j_sharded.cluster_large_sharded(
        x, _jcfg(), mesh=_jax_mesh(), num_iters=16,
        use_ring_affinity=use_ring)
    assert labels.shape == (n,)
    assert n_clusters == int(j_n) == k
    np.testing.assert_array_equal(_ordered(labels), _ordered(j_labels))
    np.testing.assert_array_equal(_ordered(labels), _ordered(true))
    if use_ring:
      gather_labels, gather_n = sharded.cluster_large_sharded(
          x, _cfg(), mesh=_mesh(), num_iters=16)
      assert gather_n == n_clusters
      np.testing.assert_array_equal(labels, gather_labels)

  @pytest.mark.parametrize("use_ring", [False, True])
  def test_icassp2018_preset_at_512(self, use_ring):
    # The preset as bench.py runs it (blur sigma 1, max 7, max_iter 300):
    # the blur's halo crosses stripes of 64 rows.
    x = make_embeddings(512)
    want = np.load(os.path.join(REPO, "benchmarks",
                                "reference_labels.npz"))["labels_512"]
    labels, n_clusters = sharded.cluster_large_sharded(
        x, _cfg(max_clusters=7, sigma=1, max_iter=300), mesh=_mesh(),
        use_ring_affinity=use_ring)
    j_labels, j_n = j_sharded.cluster_large_sharded(
        x, _jcfg(max_clusters=7, sigma=1, max_iter=300), mesh=_jax_mesh(),
        use_ring_affinity=use_ring)
    assert n_clusters == int(j_n) == 2
    np.testing.assert_array_equal(_ordered(labels), _ordered(j_labels))
    np.testing.assert_array_equal(_ordered(labels), _ordered(want))

  def test_matches_single_device_at_representative_n(self):
    # test_sharded_matches_full_eigh_at_representative_n: N=2048, held
    # against the port's single-device full-eigh pipeline.
    rng = np.random.RandomState(7)
    n, d, k = 2048, 32, 4
    centers = rng.randn(k, d) * 3.0
    true = np.repeat(np.arange(k), n // k)
    x = (centers[true] + rng.randn(n, d) * 0.4).astype(np.float32)
    cfg = _cfg(max_clusters=7)
    labels, n_clusters = sharded.cluster_large_sharded(x, cfg, mesh=_mesh())
    ref_labels, ref_n, _, _ = pipeline.spectral_cluster_fixed_k(
        torch.as_tensor(x), torch.Generator().manual_seed(0), cfg)
    assert n_clusters == int(ref_n) == k
    np.testing.assert_array_equal(_ordered(ref_labels.numpy()),
                                  _ordered(labels))

  def test_padded_ascending_graphcut_normalized_diff(self):
    # A GraphCut Laplacian scanned ascending with NormalizedDiff, N not
    # divisible by P: the masked solver's shifted pad block, the λ_max
    # power iteration and the Laplacian's gathered column scale.
    rng = np.random.RandomState(11)
    x, true = _utterance(rng, 203, d=16, k=3, noise=0.3)
    cfg = pipeline.PipelineConfig(
        refinement_options=configs.turntodiarize_refinement_options(),
        laplacian_type=LaplacianType.GraphCut,
        eigengap_type=EigenGapType.NormalizedDiff, min_clusters=2,
        max_clusters=5, custom_dist="cosine")
    info = {}
    labels, n_clusters = sharded.cluster_large_sharded(x, cfg, mesh=_mesh(),
                                                       info=info)
    assert info["n_pad"] == 208
    one, one_n = sharded.cluster_large_sharded(x, cfg, mesh=_mesh(mp=1))
    ref_labels, ref_n, ref_w, _ = pipeline.spectral_cluster_fixed_k(
        torch.as_tensor(x), torch.Generator().manual_seed(0), cfg)
    assert n_clusters == one_n == int(ref_n) == 3
    np.testing.assert_allclose(info["eigenvalues"], ref_w.numpy()[:6],
                               atol=1e-4)
    for got in (labels, one):
      np.testing.assert_array_equal(_ordered(got), _ordered(ref_labels))
    np.testing.assert_array_equal(_ordered(labels), _ordered(true))


def _operand_cases():
  icassp = configs.icassp2018_refinement_options()
  t2d = configs.turntodiarize_refinement_options()
  return [
      # (n, mp, refinement options, laplacian)
      (61, 8, icassp, None),                           # padded, blur σ=1
      (64, 8, icassp.replace(gaussian_blur_sigma=3), None),  # halo > stripe
      (49, 8, icassp.replace(gaussian_blur_sigma=3), None),  # a stripe of pads
      (512, 8, icassp, None),
      (61, 8, t2d, LaplacianType.GraphCut),
      (64, 4, t2d, LaplacianType.RandomWalk),
      (45, 4, t2d.replace(refinement_sequence=(
          RefinementName.CropDiagonal, RefinementName.RowWiseNormalize,
          RefinementName.Symmetrize)), LaplacianType.Unnormalized),
  ]


@pytest.mark.parametrize("n,mp,ropts,laplacian", _operand_cases())
def test_stripes_equal_single_device_operand(n, mp, ropts, laplacian):
  rng = np.random.RandomState(n)
  x, _ = _utterance(rng, n, d=16, k=3, noise=0.5)
  n_pad = -(-n // mp) * mp
  n_valid = n if n_pad != n else None
  xp = torch.zeros((n_pad, 16))
  xp[:n] = torch.as_tensor(x)
  cfg = pipeline.PipelineConfig(refinement_options=ropts,
                                laplacian_type=laplacian, max_clusters=4,
                                use_kernels=False)
  descend = laplacian is None
  structure = pipeline._eig_structure(cfg)
  aff = refinement_ops.mask_padding(
      affinity_ops.compute_affinity_matrix(xp), n_valid)
  layout = stripes.Layout(collectives.model_group(_mesh(mp=mp)), n_pad,
                          n_valid)
  aff_stripes = list(torch.split(aff, n_pad // mp))

  seq = tuple(ropts.refinement_sequence)
  prefix = seq[:seq.index(RefinementName.Diffuse)] if (
      RefinementName.Diffuse in seq) else seq
  want = refinement_ops.apply_refinement_sequence(
      aff, ropts, sequence=prefix, n_valid=n_valid)
  got = stripes.apply_refinement_sequence(layout, aff_stripes, ropts, prefix)
  np.testing.assert_array_equal(torch.cat(got).numpy(), want.numpy())

  want_m, want_scale = pipeline._symmetric_eig_operand(
      aff, cfg, None, n_valid, structure)
  got_m, got_scale = stripes.symmetric_eig_operand(layout, aff_stripes, cfg,
                                                   structure, descend)
  scale = float(torch.amax(torch.abs(want_m)))
  np.testing.assert_allclose(torch.cat(got_m).numpy(), want_m.numpy(),
                             rtol=0, atol=1e-5 * scale)
  assert (got_scale is None) == (want_scale is None)
  if want_scale is not None:
    np.testing.assert_allclose(torch.cat(got_scale).numpy(),
                               want_scale.numpy(), rtol=1e-5)


class TestSanity:

  def test_replica_consistency_passes_on_replicated(self):
    sanity.check_replica_consistency(_mesh(dp=4, mp=2), np.arange(16.0))
    sanity.check_replica_consistency(
        _mesh(dp=4, mp=2), [torch.arange(16.0)] * 8)

  def test_replica_consistency_catches_divergence(self):
    # Each device's "replicated" copy carries its own index.
    bad = [torch.zeros(8) + i for i in range(8)]
    with pytest.raises(AssertionError, match="replica consistency"):
      sanity.check_replica_consistency(_mesh(dp=8, mp=1), bad)

  def test_batched_pipeline_deterministic(self):
    rng = np.random.RandomState(0)
    mesh = _mesh(dp=8, mp=1)
    utts = [_utterance(rng, 24)[0] for _ in range(8)]
    sanity.check_deterministic(
        lambda: np.concatenate(batch_lib.cluster_batch(utts, _cfg(), mesh)))

  def test_sharded_path_deterministic(self):
    x, _ = _utterance(np.random.RandomState(1), 61, d=16, k=3)
    sanity.check_deterministic(
        lambda: sharded.cluster_large_sharded(x, _cfg(sigma=1), _mesh()))
    with pytest.raises(AssertionError, match="nondeterministic"):
      sanity.check_deterministic(lambda: torch.randn(3))

  def test_debug_nans_traps_nan_only(self):
    with sanity.debug_nans():
      with pytest.raises(FloatingPointError):
        torch.log(torch.tensor(-1.0))
      assert float(torch.log(torch.tensor(0.0))) == -np.inf
      # The sharded path makes no NaN. (With padding, K-Means' cosine
      # distance of a zero pad row is 0/0, masked by its zero weight: the
      # single-device pipeline does the same.)
      x, _ = _utterance(np.random.RandomState(3), 64, d=16, k=3)
      for use_ring in (False, True):
        sharded.cluster_large_sharded(x, _cfg(sigma=1), _mesh(),
                                      use_ring_affinity=use_ring)
    # Restored off: the same op must NOT raise afterwards.
    assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))
    with sanity.debug_nans(enable=False):
      assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))

  def test_ring_order_holds_on_both_axes(self):
    mesh = _mesh(dp=2, mp=4)
    sanity.check_ring_order(mesh, "model")
    sanity.check_ring_order(mesh, "batch")


class TestRingAffinity:

  def test_matches_dense_and_jax(self):
    rng = np.random.RandomState(0)
    x = rng.randn(64, 16).astype(np.float32)
    got = torch.cat(ring.ring_affinity(torch.as_tensor(x), _mesh()))
    dense = affinity_ops.compute_affinity_matrix(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)
    j_out = j_ring.ring_affinity(jax.numpy.asarray(x), _jax_mesh())
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), atol=1e-5)


def test_kmeans_key_draws_jax_split_key():
  # The sharded step seeds K-Means with the third of PRNGKey(seed)'s three
  # split keys, over the padded rows: the same centers as JAX's.
  rng = np.random.RandomState(0)
  x = rng.randn(72, 5).astype(np.float32)
  w = np.ones(72, np.float32)
  w[70:] = 0
  key = prng.split(prng.key(3), 3)[2]
  got = kmeans_ops.kmeans_plusplus(torch.as_tensor(x), 4, None,
                                   torch.as_tensor(w), draw_rows=72, key=key)
  j_key = jax.random.split(jax.random.PRNGKey(3), 3)[2]
  want = j_kmeans.kmeans_plusplus(jax.numpy.asarray(x), 4, j_key,
                                  jax.numpy.asarray(w))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
