"""The port's ops vs the JAX package's, on the same numpy inputs (CPU).

Element-wise and reduction ops agree to 1e-6 (1e-5 relative where a matmul
sums in another order); eigensolvers agree on eigenvalues (1e-4·max|w|) and
on the spanned subspace (principal angles < 1e-3); K-Means fed the same
initial centroids gives the same labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralcluster_tpu.ops import affinity as j_aff
from spectralcluster_tpu.ops import blur as j_blur
from spectralcluster_tpu.ops import eigen as j_eigen
from spectralcluster_tpu.ops import gmm as j_gmm
from spectralcluster_tpu.ops import kmeans as j_kmeans
from spectralcluster_tpu.ops import quantile as j_quant
from spectralcluster_tpu.ops import refinement as j_ref
from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu_torch import configs
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import types
from spectralcluster_tpu_torch.ops import affinity as t_aff
from spectralcluster_tpu_torch.ops import blur as t_blur
from spectralcluster_tpu_torch.ops import eigen as t_eigen
from spectralcluster_tpu_torch.ops import gmm as t_gmm
from spectralcluster_tpu_torch.ops import kmeans as t_kmeans
from spectralcluster_tpu_torch.ops import quantile as t_quant
from spectralcluster_tpu_torch.ops import refinement as t_ref

torch.set_num_threads(1)


def _t(a):
  return torch.as_tensor(np.array(a))


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _padded(n, n_valid, seed, shift=0.0):
  """Square float32 matrix whose rows/cols >= n_valid are zero."""
  a = np.random.RandomState(seed).rand(n, n).astype(np.float32) + shift
  a[n_valid:, :] = 0.0
  a[:, n_valid:] = 0.0
  return a.astype(np.float32)


def _close(ours, ref, rtol=0.0, atol=1e-6):
  np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Affinity, blur, quantile.
# ---------------------------------------------------------------------------


def test_affinity_and_cdist():
  rng = np.random.RandomState(0)
  x = rng.randn(60, 16).astype(np.float32)
  y = rng.randn(7, 16).astype(np.float32)
  _close(t_aff.compute_affinity_matrix(_t(x)),
         j_aff.compute_affinity_matrix(jnp.asarray(x)), rtol=1e-5)
  for name in ("cosine", "sqeuclidean"):
    _close(t_aff.get_distance_fn(name)(_t(x), _t(y)),
           j_aff.get_distance_fn(name)(jnp.asarray(x), jnp.asarray(y)),
           rtol=1e-5, atol=1e-5)


def test_unported_metrics_raise():
  # Every metric of the JAX registry is ported; an unknown one raises as
  # it does there.
  assert t_aff.supported_distances() == j_aff.supported_distances()
  with pytest.raises(ValueError, match="Unsupported distance"):
    t_aff.get_distance_fn("nope")
  with pytest.raises(TypeError):
    t_aff.get_distance_fn(123)


def _pair_distance(u, v):
  """A user metric over single vectors, written for jnp and torch alike."""
  return abs(u - v).sum() + ((u - v) ** 2).sum() ** 0.5


@pytest.mark.parametrize("metric",
                         list(j_aff.supported_distances()) + [_pair_distance])
def test_distance_fn_matches_jax(metric):
  # Same numpy inputs; rtol 1e-5 (float32 sums in another order), atol 1e-5
  # for the distances near 0 of the cancelling forms.
  rng = np.random.RandomState(20)
  x = rng.randn(40, 6).astype(np.float32)
  y = rng.randn(5, 6).astype(np.float32)
  ours = t_aff.get_distance_fn(metric)(_t(x), _t(y))
  ref = j_aff.get_distance_fn(metric)(jnp.asarray(x), jnp.asarray(y))
  assert tuple(ours.shape) == (40, 5)
  _close(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sigma", [1.0, 2.5])
def test_gaussian_blur(sigma):
  a = np.random.RandomState(1).rand(40, 40).astype(np.float32)
  _close(t_blur.gaussian_blur(_t(a), sigma),
         j_blur.gaussian_blur(jnp.asarray(a), sigma))


@pytest.mark.parametrize("n_valid", [37, 5, 2])
def test_gaussian_blur_masked(n_valid):
  a = _padded(48, n_valid, 2)
  _close(t_blur.gaussian_blur_masked(_t(a), 1.0, n_valid),
         j_blur.gaussian_blur_masked(jnp.asarray(a), 1.0, n_valid))
  # A tensor n_valid reflects at the same boundary.
  _close(t_blur.gaussian_blur_masked(_t(a), 1.0, torch.tensor(n_valid)),
         j_blur.gaussian_blur_masked(jnp.asarray(a), 1.0, n_valid))


@pytest.mark.parametrize("q", [0.0, 0.37, 0.85, 1.0])
def test_quantiles(q):
  a = np.random.RandomState(3).randn(20, 33).astype(np.float32)
  _close(t_quant.row_quantile(_t(a), q),
         j_quant.row_quantile(jnp.asarray(a), q))
  qs = np.array([0.1, q], np.float32)
  _close(t_quant.quantile_from_sorted(t_quant.sort_rows(_t(a)), _t(qs)),
         j_quant.quantile_from_sorted(j_quant.sort_rows(jnp.asarray(a)), qs))
  srt = t_quant.sort_rows_masked(_t(a), 25)
  _close(t_quant.quantile_from_sorted_masked(srt, q, 25),
         j_quant.quantile_from_sorted_masked(
             j_quant.sort_rows_masked(jnp.asarray(a), 25), q, 25))


# ---------------------------------------------------------------------------
# Refinement ops, masked and not.
# ---------------------------------------------------------------------------

_R = types.RefinementName


@pytest.mark.parametrize("n_valid", [None, 50])
@pytest.mark.parametrize("op", [
    "mask_padding", "crop_diagonal", "gaussian_blur", "threshold_rowmax",
    "threshold_percentile_t2d", "symmetrize_max", "symmetrize_average",
    "diffuse", "row_wise_normalize", "row_max_scale"])
def test_refinement_op(op, n_valid):
  a = _padded(64, 64 if n_valid is None else n_valid, 4, shift=-0.2)
  ta, ja = _t(a), jnp.asarray(a)
  rtol = 0.0
  if op == "mask_padding":
    ours, ref = t_ref.mask_padding(ta, n_valid), j_ref.mask_padding(ja, n_valid)
  elif op == "crop_diagonal":
    ours, ref = t_ref.crop_diagonal(ta, n_valid), j_ref.crop_diagonal(
        ja, n_valid)
  elif op == "gaussian_blur":
    ours = t_ref.gaussian_blur(ta, 1.0, n_valid)
    ref = j_ref.gaussian_blur(ja, 1.0, n_valid)
  elif op == "threshold_rowmax":
    ours = t_ref.row_wise_threshold(ta, 0.8, 0.01, types.ThresholdType.RowMax,
                                    n_valid=n_valid)
    ref = j_ref.row_wise_threshold(ja, 0.8, 0.01,
                                   j_types.ThresholdType.RowMax,
                                   n_valid=n_valid)
  elif op == "threshold_percentile_t2d":
    ours = t_ref.row_wise_threshold(ta, 0.6, 0.01,
                                    types.ThresholdType.Percentile, True, True,
                                    n_valid)
    ref = j_ref.row_wise_threshold(ja, 0.6, 0.01,
                                   j_types.ThresholdType.Percentile, True,
                                   True, n_valid)
  elif op.startswith("symmetrize"):
    kind = "Max" if op.endswith("max") else "Average"
    ours = t_ref.symmetrize(ta, types.SymmetrizeType[kind], n_valid)
    ref = j_ref.symmetrize(ja, j_types.SymmetrizeType[kind], n_valid)
  elif op == "diffuse":
    ours, ref = t_ref.diffuse(ta, n_valid), j_ref.diffuse(ja, n_valid)
    rtol = 1e-5
  elif op == "row_wise_normalize":
    ours = t_ref.row_wise_normalize(ta, n_valid)
    ref = j_ref.row_wise_normalize(ja, n_valid)
  else:
    ours = t_ref.row_max_scale(ta, n_valid)
    ref = j_ref.row_max_scale(ja, n_valid)
    # The kernel route (its twin, here) gives the same scale.
    _close(t_ref.row_max_scale(ta, n_valid, use_kernels=True), ref)
  _close(ours, ref, rtol=rtol)


@pytest.mark.parametrize("preset", ["icassp2018", "turntodiarize"])
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("n_valid", [None, 70])
def test_refinement_sequence(preset, use_kernels, n_valid):
  a = _padded(96, 96 if n_valid is None else n_valid, 5)
  if preset == "icassp2018":
    ours_opts = configs.icassp2018_refinement_options()
    ref_opts = j_configs.icassp2018_refinement_options()
  else:
    ours_opts = configs.turntodiarize_refinement_options()
    ref_opts = j_configs.turntodiarize_refinement_options()
  ours = t_ref.apply_refinement_sequence(_t(a), ours_opts, n_valid=n_valid,
                                         use_kernels=use_kernels,
                                         consume_input=True)
  ref = j_ref.apply_refinement_sequence(jnp.asarray(a), ref_opts,
                                        n_valid=n_valid, use_pallas=False)
  _close(ours, ref, rtol=1e-5)


@pytest.mark.parametrize("seq,sym", [
    ((_R.CropDiagonal, _R.GaussianBlur, _R.RowWiseThreshold, _R.Symmetrize,
      _R.Diffuse, _R.RowWiseNormalize), True),
    ((_R.RowWiseThreshold, _R.Symmetrize), True),
    ((_R.RowWiseThreshold,), True),
    ((_R.GaussianBlur,), False),
    ((), True),
])
def test_analyze_symmetry_and_split(seq, sym):
  jseq = tuple(j_types.RefinementName[s.name] for s in seq)
  assert t_ref.analyze_symmetry(seq, sym) == j_ref.analyze_symmetry(jseq, sym)
  ours = t_ref.split_at_threshold(seq)
  ref = j_ref.split_at_threshold(jseq)
  assert [[s.name for s in part] for part in ours] == [
      [s.name for s in part] for part in ref]


def test_refinement_operator_factory():
  a = np.random.RandomState(6).rand(20, 20).astype(np.float32)
  opts = types.RefinementOptions()
  out = opts.get_refinement_operator(_R.CropDiagonal).refine(a)
  ref = j_types.RefinementOptions().get_refinement_operator(
      j_types.RefinementName.CropDiagonal).refine(a)
  np.testing.assert_allclose(out, ref, atol=1e-6)


# ---------------------------------------------------------------------------
# Eigen ops.
# ---------------------------------------------------------------------------


def _planted(n, top, seed, bulk=0.3):
  """Symmetric matrix with eigenvalues `top` plus a bulk in [0, bulk]."""
  rng = np.random.RandomState(seed)
  q, _ = np.linalg.qr(rng.randn(n, n))
  w = np.concatenate([np.asarray(top, float), rng.rand(n - len(top)) * bulk])
  return ((q * w) @ q.T).astype(np.float32)


def _max_angle(u1, u2):
  """Largest principal angle between the column spans of u1 and u2."""
  q1, _ = np.linalg.qr(np.asarray(u1, np.float64))
  q2, _ = np.linalg.qr(np.asarray(u2, np.float64))
  s = np.linalg.svd(q1.T @ q2, compute_uv=False)
  return float(np.arccos(np.clip(s.min(), -1.0, 1.0)))


_TOP = [10.0, 8.0, 6.0, 4.5, 3.0, 2.0]


@pytest.mark.parametrize("with_scale", [False, True])
def test_sorted_eigh_similarity(with_scale):
  m = _planted(80, _TOP, 7)
  scale = (np.random.RandomState(8).rand(80) + 0.5).astype(np.float32)
  ts = _t(scale) if with_scale else None
  js = jnp.asarray(scale) if with_scale else None
  w, v = t_eigen.sorted_eigh_similarity(_t(m), ts)
  jw, jv = j_eigen.sorted_eigh_similarity(jnp.asarray(m), js)
  wmax = float(np.max(np.abs(jw)))
  _close(w, jw, atol=1e-4 * wmax)
  assert _max_angle(v[:, :6], np.asarray(jv)[:, :6]) < 1e-3


@pytest.mark.parametrize("descend", [True, False])
def test_sorted_eig_general_host(descend):
  # An asymmetric matrix D^-1 S with a real spectrum: both packages run
  # LAPACK's eig on the same float64 copy, so they agree to float32
  # rounding (atol 1e-5·max|w|); eigenvectors up to sign.
  s = _planted(60, _TOP, 21)
  d = (np.random.RandomState(22).rand(60) + 0.5).astype(np.float32)
  m = (s / d[:, None]).astype(np.float32)
  w, v = t_eigen.sorted_eig_general_host(_t(m), descend)
  jw, jv = j_eigen.sorted_eig_general_host(jnp.asarray(m), descend)
  wmax = float(np.max(np.abs(jw)))
  _close(w, jw, atol=1e-5 * wmax)
  signs = np.sign(np.sum(_np(v)[:, :6] * np.asarray(jv)[:, :6], axis=0))
  _close(_np(v)[:, :6] * signs, np.asarray(jv)[:, :6], atol=1e-5)
  assert w.dtype == torch.float32 and v.shape == (60, 60)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("n_valid", [None, 64])
def test_topk_eigh_subspace_masked(largest, n_valid):
  k = 4
  n = 80
  nv = n if n_valid is None else n_valid
  m = np.zeros((n, n), np.float32)
  if largest:
    m[:nv, :nv] = _planted(nv, _TOP, 9)
  else:
    # Bottom of a PSD operator: planted small eigenvalues, bulk well above.
    q, _ = np.linalg.qr(np.random.RandomState(10).randn(nv, nv))
    w = np.concatenate([[0.0, 0.05, 0.3, 0.6],
                        3.0 + np.random.RandomState(11).rand(nv - 4)])
    m[:nv, :nv] = ((q * w) @ q.T).astype(np.float32)
  if n_valid is not None:
    m = np.asarray(j_eigen.apply_padding_sentinels(jnp.asarray(m), n_valid,
                                                   largest))
  kw = dict(largest=largest, n_valid=n_valid, num_iters=24,
            residual_tol=1e-5, max_iters=960, drift_tol=None)
  w, v = t_eigen.topk_eigh_subspace_masked(
      _t(m), k, torch.Generator().manual_seed(42), **kw)
  jw, jv = j_eigen.topk_eigh_subspace_masked(
      jnp.asarray(m), k, jax.random.PRNGKey(42), **kw)
  wmax = max(float(np.max(np.abs(jw))), 1.0)
  _close(w, jw, atol=1e-4 * wmax)
  assert _max_angle(v, jv) < 1e-3
  # Both agree with the dense solver too.
  exact = np.linalg.eigvalsh(m[:nv, :nv].astype(np.float64))
  want = exact[::-1][:k] if largest else exact[:k]
  np.testing.assert_allclose(_np(w), want, atol=1e-4 * wmax)


def test_cholqr2_shifted():
  y = np.random.RandomState(12).randn(200, 8).astype(np.float32)
  q = t_eigen.cholqr2_shifted(_t(y))
  _close(q, j_eigen.cholqr2_shifted(jnp.asarray(y)), atol=1e-4)
  np.testing.assert_allclose(_np(q).T @ _np(q), np.eye(8), atol=1e-5)
  # A rank-one panel stays finite (the shifted passes keep Cholesky alive).
  rank1 = np.repeat(y[:, :1], 8, axis=1)
  assert torch.isfinite(t_eigen.cholqr2_shifted(_t(rank1))).all()


@pytest.mark.parametrize("descend", [True, False])
@pytest.mark.parametrize("gap", ["Ratio", "NormalizedDiff"])
@pytest.mark.parametrize("n_valid,max_clusters", [(None, None), (None, 4),
                                                  (9, 7), (3, None)])
def test_compute_number_of_clusters(descend, gap, n_valid, max_clusters):
  for seed in range(4):
    rng = np.random.RandomState(seed)
    w = np.sort(np.concatenate([rng.rand(3) * 5 + 1, rng.rand(9) * 0.02]))
    w = w[::-1] if descend else w
    w = w.astype(np.float32)
    kw = dict(max_clusters=max_clusters, stop_eigenvalue=1e-2,
              descend=descend, n_valid=n_valid)
    n, delta = t_eigen.compute_number_of_clusters(
        _t(w), eigengap_type=types.EigenGapType[gap], **kw)
    jn, jdelta = j_eigen.compute_number_of_clusters(
        jnp.asarray(w), eigengap_type=j_types.EigenGapType[gap], **kw)
    assert int(n) == int(jn)
    np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-6)


@pytest.mark.parametrize("n_valid,wmax", [(None, None), (6, None),
                                          (None, 500.0)])
def test_snap_small_eigenvalues(n_valid, wmax):
  w = np.array([5.0, 2.0, 1e-5, -3e-6, 4e-4, 0.1, -7.0, 9.0], np.float32)
  _close(t_eigen.snap_small_eigenvalues(_t(w), n_valid, 1e-5, wmax),
         j_eigen.snap_small_eigenvalues(jnp.asarray(w), n_valid, 1e-5, wmax))


@pytest.mark.parametrize("descend", [True, False])
def test_padding_sentinels_and_recovery(descend):
  m = _padded(40, 31, 13)
  m = (m + m.T) / 2
  _close(t_eigen.apply_padding_sentinels(_t(m), 31, descend),
         j_eigen.apply_padding_sentinels(jnp.asarray(m), 31, descend),
         atol=1e-5)
  u = np.random.RandomState(14).randn(40, 5).astype(np.float32)
  s = np.random.RandomState(15).rand(40).astype(np.float32) + 0.1
  _close(t_eigen.recover_similarity_eigenvectors(_t(u), _t(s), 31),
         j_eigen.recover_similarity_eigenvectors(jnp.asarray(u),
                                                 jnp.asarray(s), 31))


# ---------------------------------------------------------------------------
# K-Means.
# ---------------------------------------------------------------------------


def _blobs(n=300, d=5, k=3, seed=16, sep=4.0):
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * sep
  labels = np.arange(n) % k
  return (centers[labels] + rng.randn(n, d) * 0.7).astype(np.float32)


@pytest.mark.parametrize("metric", ["cosine", "sqeuclidean"])
def test_lloyd_iterations_same_init(metric):
  x = _blobs()
  init = x[[0, 1, 2, 3, 4]]        # k_max=5, three live clusters
  weight = (np.arange(300) < 280).astype(np.float32)
  labels, c = t_kmeans.lloyd_iterations(
      _t(x), _t(init), 3, t_aff.get_distance_fn(metric), max_iter=50,
      sample_weight=_t(weight))
  jl, jc = j_kmeans.lloyd_iterations(
      jnp.asarray(x), jnp.asarray(init), 3, j_aff.get_distance_fn(metric),
      max_iter=50, sample_weight=jnp.asarray(weight))
  np.testing.assert_array_equal(_np(labels), np.asarray(jl))
  _close(c, jc, rtol=1e-5, atol=1e-5)


def test_standard_lloyd_same_init():
  x = _blobs(seed=17)
  init = x[[0, 1, 2]]
  labels, c = t_kmeans.standard_lloyd(_t(x), _t(init), 3)
  jl, jc = j_kmeans.standard_lloyd(jnp.asarray(x), jnp.asarray(init), 3)
  np.testing.assert_array_equal(_np(labels), np.asarray(jl))
  _close(c, jc, rtol=1e-5, atol=1e-5)


def test_kmeans_plusplus_picks_distinct_valid_rows():
  x = _blobs(seed=18, sep=10.0)
  weight = (np.arange(300) < 250).astype(np.float32)
  centers = _np(t_kmeans.kmeans_plusplus(
      _t(x), 3, torch.Generator().manual_seed(0), _t(weight)))
  rows = [np.flatnonzero((x == c).all(axis=1)) for c in centers]
  assert all(r.size == 1 and r[0] < 250 for r in rows)
  assert len({int(r[0]) % 3 for r in rows}) == 3   # one seed per blob


@pytest.mark.parametrize("seed", [0, 17, 2**31 - 1])
def test_prng_matches_jax_random(seed):
  from spectralcluster_tpu_torch import prng
  key = jax.random.PRNGKey(seed)
  np.testing.assert_array_equal(prng.key(seed), np.asarray(key))
  keys = prng.split(prng.key(seed), 5)
  j_keys = jax.random.split(key, 5)
  np.testing.assert_array_equal(keys, np.asarray(j_keys))
  for shape in ((7,), (3, 130)):
    # The uniform bits are equal; float32 log in numpy and in XLA may round
    # the last bit apart (4 float32 ulps of the largest draws here).
    np.testing.assert_allclose(
        prng.gumbel(keys[2], shape),
        np.asarray(jax.random.gumbel(j_keys[2], shape)), rtol=0, atol=1e-6)


# One sort round up to n=1625, two above (JAX's static round count).
@pytest.mark.parametrize("n", [1, 2, 10, 257, 1625, 1626, 4000])
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_prng_permutation_matches_jax(n, seed):
  from spectralcluster_tpu_torch import prng
  ours = prng.permutation(prng.key(seed), n)
  key = jax.random.PRNGKey(seed)
  np.testing.assert_array_equal(ours,
                                np.asarray(jax.random.permutation(key, n)))
  k = min(n, 5)
  np.testing.assert_array_equal(
      ours[:k], np.asarray(jax.random.choice(key, n, (k,), replace=False)))


@pytest.mark.parametrize("seed", [0, 1, 7, 12])
def test_custom_kmeans_random_start_matches_jax(seed):
  # Overlapping blobs: the start decides which optimum Lloyd lands in, so
  # label ids agree only if the starts do.
  x = _blobs(n=2000, d=4, seed=26, sep=1.0)
  ours = t_kmeans.CustomKMeans(n_clusters=4, max_iter=20, seed=seed,
                               device="cpu").predict(x)
  theirs = j_kmeans.CustomKMeans(n_clusters=4, max_iter=20,
                                 seed=seed).predict(x)
  np.testing.assert_array_equal(ours, np.asarray(theirs))


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_plusplus_draws_match_jax(seed):
  # Bucket-sized input (the JAX package clusters its bucket's rows), with
  # padded rows of weight 0: the same starting centroids as JAX.
  x = _blobs(n=64, d=4, seed=24, sep=2.0)
  weight = (np.arange(64) < 50).astype(np.float32)
  ours = t_kmeans.kmeans_plusplus(_t(x), 4, torch.Generator().manual_seed(
      seed), _t(weight))
  ref = j_kmeans.kmeans_plusplus(jnp.asarray(x), 4, jax.random.PRNGKey(seed),
                                 jnp.asarray(weight))
  np.testing.assert_array_equal(_np(ours), np.asarray(ref))


@pytest.mark.parametrize("metric", ["cosine", None])
def test_kmeans_fit_matches_up_to_permutation(metric):
  from spectralcluster_tpu_torch import utils
  x = _blobs(seed=19)
  ours = t_kmeans.kmeans_fit(_t(x), 3, torch.Generator().manual_seed(0),
                             custom_dist=metric, max_iter=300)
  ref = j_kmeans.kmeans_fit(jnp.asarray(x), 3, jax.random.PRNGKey(0),
                            custom_dist=metric, max_iter=300)
  np.testing.assert_array_equal(utils.enforce_ordered_labels(_np(ours)),
                                utils.enforce_ordered_labels(np.asarray(ref)))


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "mahalanobis",
                                    None, _pair_distance])
def test_run_kmeans_matches_up_to_permutation(metric):
  from spectralcluster_tpu_torch import utils
  x = _blobs(n=120, d=4, seed=23, sep=6.0)
  ours = t_kmeans.run_kmeans(x, 3, metric, 300, device="cpu")
  ref = j_kmeans.run_kmeans(x, 3, metric, 300)
  assert ours.shape == (120,)
  np.testing.assert_array_equal(utils.enforce_ordered_labels(ours),
                                utils.enforce_ordered_labels(np.asarray(ref)))


@pytest.mark.parametrize("given_centroids", [False, True])
def test_custom_kmeans_matches(given_centroids):
  from spectralcluster_tpu_torch import utils
  x = _blobs(n=90, d=4, seed=24, sep=6.0)
  init = x[[0, 1, 2]] if given_centroids else None
  # Without centroids both packages draw jax.random.choice's start for the
  # seed (prng.permutation): the same start either way.
  ours = t_kmeans.CustomKMeans(n_clusters=3, centroids=init, max_iter=50,
                               seed=5, device="cpu")
  ref = j_kmeans.CustomKMeans(n_clusters=3, centroids=init, max_iter=50,
                              seed=5)
  labels, jlabels = ours.predict(x), ref.predict(x)
  np.testing.assert_array_equal(utils.enforce_ordered_labels(labels),
                                utils.enforce_ordered_labels(jlabels))
  np.testing.assert_array_equal(labels, np.asarray(jlabels))
  # The same start: the same rounds, so the same centroids (float32 sums in
  # another order: rtol 1e-5).
  _close(ours.centroids, ref.centroids, rtol=1e-5, atol=1e-5)
  with pytest.raises(ValueError, match="should be >= n_clusters"):
    t_kmeans.CustomKMeans(n_clusters=200, device="cpu").predict(x)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("bimodal", [False, True])
def test_gmm_1d_matches_jax(k, bimodal):
  rng = np.random.RandomState(25)
  x = rng.randn(2000) * 0.05 + 0.6
  if bimodal:
    x = np.concatenate([x, rng.randn(1500) * 0.05 + 0.95])
  x = x.astype(np.float32)
  w, mu, var, ll = t_gmm.fit_gmm_1d(_t(x), n_components=k)
  jw, jmu, jvar, jll = j_gmm.fit_gmm_1d(jnp.asarray(x), n_components=k)
  # Float32 EM with sums in another order: rtol 1e-4.
  for ours, ref in ((w, jw), (mu, jmu), (var, jvar), (ll, jll)):
    _close(ours, ref, rtol=1e-4, atol=1e-6)
  np.testing.assert_allclose(t_gmm.gmm_bic_1d(x, k), j_gmm.gmm_bic_1d(x, k),
                             rtol=1e-4)


# ---------------------------------------------------------------------------
# Types and the carried-across configuration.
# ---------------------------------------------------------------------------


def test_enums_and_option_defaults_match():
  import dataclasses
  import enum
  for name in dir(j_types):
    obj = getattr(j_types, name)
    if isinstance(obj, type) and issubclass(obj, enum.Enum):
      assert [m.name for m in getattr(types, name)] == [m.name for m in obj]
  for name in ("RefinementOptions", "ConstraintOptions", "FallbackOptions"):
    ours = {f.name: (f.default if f.default is not dataclasses.MISSING
                     else None)
            for f in dataclasses.fields(getattr(types, name))}
    ref = {f.name: (f.default if f.default is not dataclasses.MISSING
                    else None)
           for f in dataclasses.fields(getattr(j_types, name))}
    assert ours.keys() == ref.keys()
    for key, val in ref.items():
      want = val.name if isinstance(val, enum.Enum) else val
      got = ours[key].name if isinstance(ours[key], enum.Enum) else ours[key]
      assert got == want, (name, key)


def test_convert_refinement_options_every_field():
  import dataclasses
  src = j_configs.turntodiarize_refinement_options().replace(
      gaussian_blur_sigma=2.0, p_percentile=0.7)
  out = convert.convert_value(src)
  assert isinstance(out, types.RefinementOptions)
  for f in dataclasses.fields(src):
    a, b = getattr(src, f.name), getattr(out, f.name)
    if isinstance(a, tuple):
      assert [x.name for x in a] == [x.name for x in b]
    elif hasattr(a, "name"):
      assert a.name == b.name and isinstance(b, type(b))
    else:
      assert a == b
