"""The port's host API vs the JAX package's, on the same numpy inputs (CPU).

Each clusterer case builds one JAX ``SpectralClusterer`` and carries it
across with ``convert.clusterer_from(..., device="cpu")``, so both run the
same knobs. Labels must agree up to permutation (``enforce_ordered_labels``),
cluster counts exactly, eigenvalues to 1e-4·max|w| (float32 sums in another
order). The host-numpy pieces (AHC, naive clustering, label utilities) must
agree exactly.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralcluster_tpu import ahc as j_ahc
from spectralcluster_tpu import clusterer as j_clusterer
from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import fallback as j_fallback
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu import utils as j_utils
from spectralcluster_tpu.ops import kmeans as j_kmeans
from spectralcluster_tpu_torch import ahc
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import fallback
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.fixtures import make_embeddings
from spectralcluster_tpu_torch.ops import kmeans as t_kmeans

torch.set_num_threads(1)

_order = utils.enforce_ordered_labels
_SCC = j_types.SingleClusterCondition


def _cosine_affinity(embeddings):
  """A user affinity_function, in numpy, usable by both packages."""
  x = np.asarray(embeddings, np.float64)
  x = x / np.linalg.norm(x, axis=1, keepdims=True)
  return ((x @ x.T + 1.0) / 2.0).astype(np.float32)


def _row_scaled_affinity(embeddings):
  """An asymmetric user affinity (D·A, D positive diagonal): with the
  default (empty) refinement sequence it is the GENERAL structure, which
  Auto hands to the host general eig in both packages."""
  a = _cosine_affinity(embeddings)
  d = np.linspace(0.5, 1.5, a.shape[0], dtype=np.float32)
  return (d[:, None] * a).astype(np.float32)


def _farthest_point_labels(spectral_embeddings, n_clusters, **_):
  """A deterministic post_eigen_cluster_function (no randomness, so both
  packages give the same labels from the same eigenvectors)."""
  x = np.asarray(spectral_embeddings, np.float64)
  seeds = [0]
  for _ in range(n_clusters - 1):
    d = np.min([np.sum((x - x[s]) ** 2, axis=1) for s in seeds], axis=0)
    seeds.append(int(np.argmax(d)))
  dist = np.stack([np.sum((x - x[s]) ** 2, axis=1) for s in seeds], axis=1)
  return np.argmin(dist, axis=1)


_ICASSP = dict(min_clusters=2, max_clusters=7,
               refinement_options=j_configs.icassp2018_refinement_options())

# name -> (JAX SpectralClusterer kwargs, N, speakers)
_CASES = {
    "max_clusters_none": (dict(_ICASSP, max_clusters=None), 192, 3),
    "affinity_function": (dict(_ICASSP, affinity_function=_cosine_affinity),
                          192, 3),
    "affinity_function_general": (
        dict(min_clusters=2, max_clusters=7,
             affinity_function=_row_scaled_affinity), 192, 3),
    "post_eigen_cluster_function": (
        dict(_ICASSP, post_eigen_cluster_function=_farthest_point_labels),
        192, 3),
    "mahalanobis": (dict(_ICASSP, custom_dist="mahalanobis"), 192, 3),
    "max_spectral_size": (dict(_ICASSP, max_spectral_size=64), 192, 3),
    "row_wise_renorm_host_general": (
        dict(_ICASSP, max_clusters=None, row_wise_renorm=True,
             eigensolver=j_types.EigenSolver.HostGeneral), 192, 3),
    "fallback_agglomerative": (
        dict(_ICASSP, fallback_options=j_types.FallbackOptions(
            spectral_min_embeddings=500,
            fallback_clusterer_type=j_types.FallbackClustererType
            .Agglomerative)), 96, 3),
    "fallback_naive": (
        dict(_ICASSP, fallback_options=j_types.FallbackOptions(
            spectral_min_embeddings=500)), 96, 3),
    "fallback_naive_scan": (
        dict(_ICASSP, fallback_options=j_types.FallbackOptions(
            spectral_min_embeddings=500)), 256, 4),
    "staged_eig_stage": (
        dict(_ICASSP, post_eigen_cluster_function=_farthest_point_labels,
             staged_execution_min_n=64), 192, 3),
    "staged_eig_stage_mahalanobis": (
        dict(_ICASSP, custom_dist="mahalanobis", staged_execution_min_n=64,
             eigensolver=j_types.EigenSolver.SubspaceIteration), 192, 3),
}
for _cond in _SCC:
  for _k in (1, 3):
    _CASES[f"min_clusters_1_{_cond.name}_k{_k}"] = (
        dict(_ICASSP, min_clusters=1, fallback_options=j_types.FallbackOptions(
            single_cluster_condition=_cond)), 192, _k)


def _compare(ours, theirs):
  np.testing.assert_array_equal(_order(np.asarray(ours.labels)),
                                _order(np.asarray(theirs.labels)))
  assert ours.n_clusters == theirs.n_clusters
  if theirs.eigenvalues is None:
    assert ours.eigenvalues is None
    return
  jw = np.asarray(theirs.eigenvalues)
  assert ours.eigenvalues.shape == jw.shape
  k = min(8, jw.shape[0])
  np.testing.assert_allclose(ours.eigenvalues[:k], jw[:k],
                             atol=1e-4 * float(np.max(np.abs(jw[:k]))))
  np.testing.assert_allclose(ours.max_delta_norm, theirs.max_delta_norm,
                             rtol=1e-3)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_branch_matches_jax_clusterer(case):
  kwargs, n, k = _CASES[case]
  x = make_embeddings(n, d=16, k=k, seed=11)
  jax_clusterer = j_clusterer.SpectralClusterer(**kwargs)
  ours = convert.clusterer_from(jax_clusterer, device="cpu")
  _compare(ours.predict_with_details(x),
           jax_clusterer.predict_with_details(x))


def test_run_kmeans_as_post_eigen_cluster_function():
  # The package's own run_kmeans in the injectable slot (the JAX package's
  # on the JAX side); K-Means seeds differ, so labels up to permutation.
  x = make_embeddings(192, d=16, k=3, seed=12)
  theirs = j_clusterer.SpectralClusterer(
      **_ICASSP, post_eigen_cluster_function=j_kmeans.run_kmeans).predict(x)
  ours = convert.clusterer_from(
      j_clusterer.SpectralClusterer(**_ICASSP), device="cpu")
  ours.post_eigen_cluster_function = functools.partial(t_kmeans.run_kmeans,
                                                       device="cpu")
  np.testing.assert_array_equal(_order(ours.predict(x)), _order(theirs))


def test_compute_eigenvectors_ncluster_matches():
  x = make_embeddings(129, d=16, k=3, seed=13)
  jax_clusterer = j_clusterer.SpectralClusterer(**_ICASSP)
  ours = convert.clusterer_from(jax_clusterer, device="cpu")
  aff = _cosine_affinity(x)
  v, n, delta = ours._compute_eigenvectors_ncluster(aff)
  jv, jn, jdelta = jax_clusterer._compute_eigenvectors_ncluster(aff)
  assert n == jn == 3 and v.shape == np.asarray(jv).shape
  np.testing.assert_allclose(delta, jdelta, rtol=1e-3)


def test_clusterer_from_carries_every_knob():
  jax_clusterer = j_clusterer.SpectralClusterer(
      **_ICASSP, fallback_options=j_types.FallbackOptions(
          spectral_min_embeddings=5, naive_threshold=0.3,
          single_cluster_condition=_SCC.AffinityStd),
      laplacian_type=j_types.LaplacianType.Affinity, stop_eigenvalue=0.02,
      row_wise_renorm=True, custom_dist="euclidean", max_iter=17,
      eigengap_type=j_types.EigenGapType.NormalizedDiff,
      max_spectral_size=300, affinity_function=_cosine_affinity,
      post_eigen_cluster_function=_farthest_point_labels, seed=3,
      eigensolver=j_types.EigenSolver.HostGeneral,
      staged_execution_min_n=None, staged_stage_timings=True)
  ours = convert.clusterer_from(jax_clusterer, device="cpu")
  assert ours.device == "cpu"

  def plain(v):
    if isinstance(v, tuple):
      return tuple(plain(e) for e in v)
    if dataclasses.is_dataclass(v):
      return {f.name: plain(getattr(v, f.name))
              for f in dataclasses.fields(v)}
    return v.name if hasattr(v, "name") and not callable(v) else v

  for name, value in vars(jax_clusterer).items():
    assert plain(getattr(ours, name)) == plain(value), name


def test_input_validation_matches():
  ours = convert.clusterer_from(j_clusterer.SpectralClusterer(**_ICASSP),
                                device="cpu")
  with pytest.raises(TypeError):
    ours.predict([[1.0, 2.0]])
  with pytest.raises(ValueError, match="2-dimensional"):
    ours.predict(np.zeros(5, np.float32))
  with pytest.raises(ValueError, match="square matrix matching"):
    ours.predict(make_embeddings(32, d=8), constraint_matrix=np.eye(31))
  with pytest.raises(ValueError, match="relatively big number"):
    ours.max_spectral_size = 4
    ours.predict(make_embeddings(32, d=8))


# ---------------------------------------------------------------------------
# Fallback, AHC and the label utilities.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("linkage", ["complete", "average", "single"])
@pytest.mark.parametrize("cut", [dict(n_clusters=4),
                                 dict(distance_threshold=0.5)])
def test_agglomerative_cluster_matches(linkage, cut):
  x = make_embeddings(60, d=8, k=4, seed=14)
  ours = ahc.agglomerative_cluster(x, "cosine", linkage, **cut)
  ref = j_ahc.agglomerative_cluster(x, "cosine", linkage, **cut)
  np.testing.assert_array_equal(ours, ref)
  np.testing.assert_array_equal(
      ahc.euclidean_distance_matrix(x), j_ahc.euclidean_distance_matrix(x))


def test_naive_clusterers_match():
  x = make_embeddings(64, d=8, k=4, seed=15)
  ours = fallback.NaiveClusterer(0.5, 0.6).predict(x)
  np.testing.assert_array_equal(ours,
                                j_fallback.NaiveClusterer(0.5, 0.6).predict(x))
  scan = fallback.naive_predict_scan(torch.as_tensor(x), 0.5, 0.6)
  jscan = j_fallback.naive_predict_scan(jnp.asarray(x), 0.5, 0.6)
  np.testing.assert_array_equal(scan.numpy(), np.asarray(jscan))
  np.testing.assert_array_equal(scan.numpy(), ours)
  with pytest.raises(ValueError, match="adaptation_threshold"):
    fallback.NaiveClusterer(0.5, 0.4)


@pytest.mark.parametrize("cond", list(_SCC), ids=lambda c: c.name)
@pytest.mark.parametrize("k", [1, 2])
def test_check_single_cluster_matches(cond, k):
  x = make_embeddings(100, d=16, k=k, seed=16)
  aff = _cosine_affinity(x)
  opts = j_types.FallbackOptions(single_cluster_condition=cond)
  ours = fallback.check_single_cluster(convert.convert_value(opts), x, aff)
  assert ours == j_fallback.check_single_cluster(opts, x, aff)


def test_label_utilities_match():
  rng = np.random.RandomState(17)
  labels = rng.randint(0, 4, 30)
  x = rng.randn(30, 5).astype(np.float32)
  np.testing.assert_array_equal(utils.enforce_ordered_labels(labels),
                                j_utils.enforce_ordered_labels(labels))
  np.testing.assert_array_equal(utils.get_cluster_centroids(x, labels),
                                j_utils.get_cluster_centroids(x, labels))
  pre = np.array([0, 1, 1, 2, 0])
  main = np.array([5, 6, 7])
  np.testing.assert_array_equal(utils.chain_labels(pre, main),
                                j_utils.chain_labels(pre, main))
  assert utils.chain_labels(None, main) is main
  with pytest.raises(ValueError, match="pre_labels has"):
    utils.chain_labels(pre, main[:2])


@pytest.mark.parametrize("symmetric", [True, False])
def test_numeric_utilities_match(symmetric):
  x = make_embeddings(40, d=8, k=2, seed=18)
  np.testing.assert_allclose(
      utils.compute_affinity_matrix(x, device="cpu"),
      j_utils.compute_affinity_matrix(x), rtol=1e-5, atol=1e-6)
  m = _cosine_affinity(x) if symmetric else _row_scaled_affinity(x)
  w, v = utils.compute_sorted_eigenvectors(m, device="cpu")
  jw, jv = j_utils.compute_sorted_eigenvectors(m)
  # float32 eigh or float64 eig, sums in another order: 1e-4·max|w|.
  np.testing.assert_allclose(w, jw, atol=1e-4 * float(np.max(np.abs(jw))))
  assert v.shape == jv.shape
  got = utils.compute_number_of_clusters(w, max_clusters=5)
  want = j_utils.compute_number_of_clusters(jw, max_clusters=5)
  assert got[0] == want[0] == 2
  np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
