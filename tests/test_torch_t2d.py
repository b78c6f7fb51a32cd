"""The port's Turn-to-Diarize path vs the JAX package and the recorded labels.

Laplacian and constrained pipelines (``refine_and_eigendecompose``,
``spectral_cluster_fixed_k`` with ``AutoTuneStatic``, ``eig_topk_staged``
with a constraint) against the JAX package on the same numpy inputs, and
``make_turntodiarize_clusterer().predict(x, ConstraintMatrix(scores)
.compute_diagonals())`` against ``benchmarks/reference_labels_t2d.npz`` and
the JAX clusterer's best_p, on the CPU (``device="cpu"``, kernels replaced
by their plain twins). Eigenvalues at rtol 1e-4 (float32 eigensolvers,
sums in another order), eigengap counts and labels (up to permutation)
equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralcluster_tpu import clusterer as j_clusterer
from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import pipeline as j_pipeline
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu_torch import clusterer
from spectralcluster_tpu_torch import configs
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import pipeline
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.constraint import ConstraintMatrix
from spectralcluster_tpu_torch.fixtures import make_t2d_fixture
from spectralcluster_tpu_torch.types import EigenSolver

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "benchmarks", "reference_labels_t2d.npz")
N, N_PAD = 150, 192
_order = utils.enforce_ordered_labels
_E2CP = j_types.ConstraintName.ConstraintPropagation


def _inputs(n=N, n_pad=None, asymmetric=False, d=32, k=3, seed=0):
  """(embeddings, constraint matrix), both zero-padded to n_pad rows."""
  x, scores, _ = make_t2d_fixture(n, d=d, k=k, seed=seed)
  cm = ConstraintMatrix(scores, threshold=1).compute_diagonals()
  if asymmetric:
    cm = np.triu(cm)
  n_pad = n_pad or n
  xp = np.zeros((n_pad, d), np.float32)
  xp[:n] = x
  cmp = np.zeros((n_pad, n_pad), np.float32)
  cmp[:n, :n] = cm
  return xp, cmp


def _jcfg(**kw):
  return j_pipeline.PipelineConfig(**{
      "refinement_options": j_configs.turntodiarize_refinement_options(),
      "laplacian_type": j_types.LaplacianType.GraphCut,
      "min_clusters": 2, "max_clusters": 7, **kw})


def _e2cp(before=True, alpha=0.4):
  return j_types.ConstraintOptions(_E2CP, before,
                                   constraint_propagation_alpha=alpha)


def _eig_both(jcfg, x, cm, n_valid, p=None):
  """refine_and_eigendecompose through both packages, the constraint (if
  any) applied where the configuration says."""
  cfg = convert.pipeline_config_from(jcfg)
  c = None if cm is None else torch.as_tensor(cm)
  jc = None if cm is None else jnp.asarray(cm)
  aff = pipeline.prepare_affinity(torch.as_tensor(x), cfg, n_valid,
                                  constraint_matrix=c)
  ours = pipeline.refine_and_eigendecompose(aff, cfg, p_percentile=p,
                                            n_valid=n_valid,
                                            constraint_matrix=c)
  jaff = j_pipeline.prepare_affinity(jnp.asarray(x), jcfg, jc,
                                     n_valid=n_valid)
  theirs = j_pipeline.refine_and_eigendecompose(
      jaff, jcfg, p_percentile=p, constraint_matrix=jc, n_valid=n_valid)
  return cfg, ours, theirs


def _check_eigs(ours, theirs, k=8):
  w, v, n_c, delta = ours
  jw, jv, jn_c, jdelta = theirs
  assert int(n_c) == int(jn_c)
  assert w.shape == jw.shape and v.shape == jv.shape
  wmax = float(np.max(np.abs(np.asarray(jw)[:k])))
  np.testing.assert_allclose(w.numpy()[:k], np.asarray(jw)[:k], rtol=1e-4,
                             atol=1e-6 * wmax)
  np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-3)
  return int(n_c)


@pytest.mark.parametrize("lap", ["GraphCut", "RandomWalk", "Unnormalized"])
@pytest.mark.parametrize("n_valid", [None, N])
def test_laplacian_pipeline_matches_jax(lap, n_valid):
  x, _ = _inputs(n_pad=None if n_valid is None else N_PAD)
  jcfg = _jcfg(laplacian_type=j_types.LaplacianType[lap])
  cfg, ours, theirs = _eig_both(jcfg, x, None, n_valid)
  assert pipeline._solver_structure(cfg) == "symmetric"
  assert _check_eigs(ours, theirs) == 3


# name -> (JAX PipelineConfig kwargs, asymmetric constraint, structure)
_CONSTRAINED = {
    "e2cp_before": (dict(constraint_options=_e2cp(True)), False,
                    "symmetric"),
    "e2cp_after": (dict(constraint_options=_e2cp(False)), False, "symmetric"),
    # An asymmetric constraint after refinement: the host general eig.
    "e2cp_after_asymmetric": (dict(constraint_options=_e2cp(False),
                                   constraint_symmetric=False), True,
                              "general"),
    # Before refinement, the T2D sequence's Symmetrize restores symmetry.
    "integration_before_asymmetric": (
        dict(constraint_options=j_types.ConstraintOptions(
            j_types.ConstraintName.AffinityIntegration, True,
            integration_type=j_types.IntegrationType.Max),
             constraint_symmetric=False), True, "symmetric"),
    "e2cp_before_affinity_path": (
        dict(constraint_options=_e2cp(True), laplacian_type=None), False,
        "symmetric"),
}


@pytest.mark.parametrize("case", sorted(_CONSTRAINED))
@pytest.mark.parametrize("n_valid", [None, N])
def test_constrained_pipeline_matches_jax(case, n_valid):
  kwargs, asymmetric, structure = _CONSTRAINED[case]
  x, cm = _inputs(n_pad=None if n_valid is None else N_PAD,
                  asymmetric=asymmetric)
  cfg, ours, theirs = _eig_both(_jcfg(**kwargs), x, cm, n_valid, p=0.785)
  assert pipeline._solver_structure(cfg, True) == structure
  assert _check_eigs(ours, theirs) >= 2


@pytest.mark.parametrize("n_valid", [None, N])
def test_fixed_k_autotune_static_matches_jax(n_valid):
  x, cm = _inputs(n_pad=None if n_valid is None else N_PAD)
  jcfg = _jcfg(constraint_options=_e2cp(True), row_wise_renorm=True,
               autotune=j_pipeline.AutoTuneStatic(0.40, 0.95, 0.05))
  cfg = convert.pipeline_config_from(jcfg)
  assert cfg.autotune == pipeline.AutoTuneStatic(0.40, 0.95, 0.05)
  assert not pipeline._staged_applicable(cfg, True)
  labels, n_c, w, delta = pipeline.spectral_cluster_fixed_k(
      torch.as_tensor(x), torch.Generator().manual_seed(0), cfg, n_valid,
      constraint_matrix=torch.as_tensor(cm))
  jlabels, jn_c, jw, jdelta = j_pipeline.spectral_cluster_fixed_k(
      jnp.asarray(x), jax.random.PRNGKey(0), jcfg, jnp.asarray(cm), n_valid)
  assert int(n_c) == int(jn_c) == 3
  np.testing.assert_allclose(w.numpy()[:8], np.asarray(jw)[:8], rtol=1e-4,
                             atol=1e-6)
  np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-3)
  np.testing.assert_array_equal(_order(labels.numpy()[:N]),
                                _order(np.asarray(jlabels)[:N]))
  # The staged executor cannot split in-graph autotune: it runs unsplit.
  staged = pipeline.spectral_cluster_fixed_k_staged(
      torch.as_tensor(x), torch.Generator().manual_seed(0), cfg, n_valid,
      constraint_matrix=torch.as_tensor(cm))
  np.testing.assert_array_equal(staged[0].numpy(), labels.numpy())


@pytest.mark.parametrize("solver", ["Auto", "SubspaceIteration", "Eigh"])
@pytest.mark.parametrize("n_valid", [None, N])
def test_eig_topk_staged_with_constraint_matches_jax(solver, n_valid):
  x, cm = _inputs(n_pad=None if n_valid is None else N_PAD)
  jcfg = _jcfg(constraint_options=_e2cp(False),
               eigensolver=j_types.EigenSolver[solver])
  cfg = convert.pipeline_config_from(jcfg)
  aff = pipeline.prepare_affinity(torch.as_tensor(x), cfg, n_valid)
  before = aff.clone()
  w, v, n_c, delta = pipeline.eig_topk_staged(
      aff, cfg, constraint_matrix=torch.as_tensor(cm), n_valid=n_valid,
      p_percentile=0.785)
  assert torch.equal(aff, before)
  jaff = j_pipeline.prepare_affinity(jnp.asarray(x), jcfg, n_valid=n_valid)
  jw, jv, jn_c, jdelta = j_pipeline.eig_topk_staged(
      jaff, jcfg, constraint_matrix=jnp.asarray(cm),
      n_valid=None if n_valid is None else jnp.int32(n_valid),
      p_percentile=0.785)
  assert int(n_c) == int(jn_c) == 3
  assert w.shape == jw.shape and v.shape == jv.shape
  # The cluster eigenvalues and the first bulk one: the subspace routes
  # start from other panels, and the deeper bulk stops at the drift gate.
  np.testing.assert_allclose(w.numpy()[:4], np.asarray(jw)[:4], rtol=1e-4,
                             atol=1e-6)
  np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-3)


def _t2d(n):
  x, scores, _ = make_t2d_fixture(n)
  return x, ConstraintMatrix(scores, threshold=1).compute_diagonals()


@pytest.mark.parametrize("n", [256, 1024])
def test_t2d_clusterer_matches_reference_and_jax(n):
  x, cm = _t2d(n)
  with np.load(REFERENCE) as z:
    ref = z[f"labels_{n}"]
  ours = configs.make_turntodiarize_clusterer(
      device="cpu").predict_with_details(x, cm)
  theirs = j_configs.make_turntodiarize_clusterer().predict_with_details(
      x, cm)
  np.testing.assert_array_equal(_order(ours.labels), ref)
  assert ours.n_clusters == theirs.n_clusters == 4
  assert abs(ours.best_p_percentile - theirs.best_p_percentile) <= 1e-9
  assert abs(ours.best_p_percentile - 0.785) <= 1e-9
  assert set(ours.timings) == {"affinity", "constraint", "eig", "kmeans"}
  jw = np.asarray(theirs.eigenvalues)
  assert ours.eigenvalues.shape == jw.shape == (n,)
  np.testing.assert_allclose(ours.eigenvalues[:8], jw[:8], rtol=1e-4,
                             atol=1e-6)


def test_clusterer_from_jax_t2d_clusterer_gives_the_same_labels():
  x, cm = _t2d(256)
  jax_clusterer = j_configs.make_turntodiarize_clusterer()
  ours = convert.clusterer_from(jax_clusterer, device="cpu")
  at = ours.autotune
  assert (at.p_percentile_min, at.p_percentile_max, at.search_step,
          at.search_level, at.proxy.name) == (0.40, 0.95, 0.05, 1,
                                              "PercentileSqrtOverNME")
  theirs = jax_clusterer.predict_with_details(x, cm)
  got = ours.predict_with_details(x, cm)
  np.testing.assert_array_equal(_order(got.labels), _order(theirs.labels))
  assert got.best_p_percentile == pytest.approx(theirs.best_p_percentile,
                                                abs=1e-9)
  # Both AutoTunes narrowed their range the same way.
  assert (at.p_percentile_min, at.p_percentile_max, at.search_step) == (
      jax_clusterer.autotune.p_percentile_min,
      jax_clusterer.autotune.p_percentile_max,
      jax_clusterer.autotune.search_step)


def test_forced_staged_sweep_matches_default():
  # As tests/test_staged.py checks for JAX: eig_topk_staged per candidate
  # (ascending subspace iteration) against the full eigh per candidate.
  x, cm = _t2d(256)
  default = configs.make_turntodiarize_clusterer(
      device="cpu").predict_with_details(x, cm)
  staged = configs.make_turntodiarize_clusterer(
      device="cpu", staged_execution_min_n=64).predict_with_details(x, cm)
  np.testing.assert_array_equal(_order(default.labels), _order(staged.labels))
  assert default.n_clusters == staged.n_clusters == 4
  assert default.best_p_percentile == staged.best_p_percentile
  assert default.eigenvalues.shape == (256,)
  assert staged.eigenvalues.shape == (8,)
  with np.load(REFERENCE) as z:
    np.testing.assert_array_equal(_order(staged.labels), z["labels_256"])


def _no_autotune_kwargs():
  return dict(min_clusters=2, max_clusters=7,
              refinement_options=j_configs.turntodiarize_refinement_options(),
              constraint_options=j_configs.turntodiarize_constraint_options(),
              laplacian_type=j_types.LaplacianType.GraphCut,
              row_wise_renorm=True)


@pytest.mark.parametrize("staged_min_n", [8192, 64])
def test_constrained_clusterer_without_autotune_matches_jax(staged_min_n):
  x, cm = _inputs(n=192, d=16, seed=3)
  jax_clusterer = j_clusterer.SpectralClusterer(
      **_no_autotune_kwargs(), staged_execution_min_n=staged_min_n)
  ours = convert.clusterer_from(jax_clusterer, device="cpu")
  got = ours.predict_with_details(x, cm)
  theirs = jax_clusterer.predict_with_details(x, cm)
  np.testing.assert_array_equal(_order(got.labels), _order(theirs.labels))
  assert got.n_clusters == theirs.n_clusters == 3
  assert got.best_p_percentile is None
  assert got.eigenvalues.shape == np.asarray(theirs.eigenvalues).shape


@pytest.mark.parametrize("apply_before", [True, False])
def test_asymmetric_constraint_routes_like_jax(apply_before):
  x, cm = _inputs(n=192, d=16, seed=3, asymmetric=True)
  kwargs = dict(_no_autotune_kwargs(),
                constraint_options=_e2cp(apply_before))
  jax_clusterer = j_clusterer.SpectralClusterer(**kwargs)
  ours = convert.clusterer_from(jax_clusterer, device="cpu")
  got = ours.predict_with_details(x, cm)
  theirs = jax_clusterer.predict_with_details(x, cm)
  np.testing.assert_array_equal(_order(got.labels), _order(theirs.labels))
  assert got.n_clusters == theirs.n_clusters
  # After refinement an asymmetric constraint leaves no symmetric form.
  assert ("host_eig" in got.timings) == (not apply_before)
  for solver in ("Eigh", "SubspaceIteration"):
    ours.eigensolver = EigenSolver[solver]
    with pytest.raises(ValueError, match="requires a symmetric constraint"):
      ours.predict(x, cm)


def test_white_box_eig_stage_with_constraint_matches_jax():
  x, cm = _inputs(n=129, d=16, seed=5)
  kwargs = dict(_no_autotune_kwargs(), constraint_options=_e2cp(False))
  jax_clusterer = j_clusterer.SpectralClusterer(**kwargs)
  ours = convert.clusterer_from(jax_clusterer, device="cpu")
  aff = np.asarray(j_pipeline.prepare_affinity(
      jnp.asarray(x), jax_clusterer._config()))
  v, n, delta = ours._compute_eigenvectors_ncluster(aff, cm)
  jv, jn, jdelta = jax_clusterer._compute_eigenvectors_ncluster(aff, cm)
  assert n == jn == 3 and v.shape == np.asarray(jv).shape
  np.testing.assert_allclose(delta, jdelta, rtol=1e-3)


def test_upload_constraint_sends_the_tridiagonal_band():
  _, scores, _ = make_t2d_fixture(1024, d=8)
  cm = ConstraintMatrix(scores, threshold=1).compute_diagonals()
  got = clusterer._upload_constraint(cm, torch.device("cpu"))
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), cm.astype(np.float32))
  dense = np.random.RandomState(0).rand(1024, 1024)
  np.testing.assert_array_equal(
      clusterer._upload_constraint(dense, torch.device("cpu")).numpy(),
      dense.astype(np.float32))
  jgot = j_clusterer.SpectralClusterer._upload_constraint(cm)
  np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
