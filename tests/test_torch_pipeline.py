"""The port's pipeline and clusterer vs the JAX package and the recorded labels.

End to end, ``make_icassp2018_clusterer().predict`` on the bench fixture
must reproduce ``benchmarks/reference_labels.npz`` with both eigensolvers,
on the CPU (``device="cpu"``, kernels replaced by their plain twins), and
agree with the JAX package's labels up to permutation.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import pipeline as j_pipeline
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu_torch import configs
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import pipeline
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.fixtures import make_embeddings
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.observability import StageTimings
from spectralcluster_tpu_torch.types import EigenSolver

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "benchmarks", "reference_labels.npz")
SOLVERS = ("Auto", "SubspaceIteration")


def _cfg(solver="Auto", **kw):
  return pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, eigensolver=EigenSolver[solver], **kw)


def _jcfg(solver="Auto"):
  return j_pipeline.PipelineConfig(
      refinement_options=j_configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7,
      eigensolver=j_types.EigenSolver[solver])


@pytest.mark.parametrize("n", [512, 1024, 2048])
@pytest.mark.parametrize("solver", SOLVERS)
def test_predict_matches_reference_and_jax(n, solver):
  x = make_embeddings(n)
  with np.load(REFERENCE) as z:
    ref = z[f"labels_{n}"]
  ours = configs.make_icassp2018_clusterer(
      device="cpu", eigensolver=EigenSolver[solver]).predict(x)
  np.testing.assert_array_equal(utils.enforce_ordered_labels(ours), ref)
  jax_clusterer = j_configs.make_icassp2018_clusterer()
  jax_clusterer.eigensolver = j_types.EigenSolver[solver]
  theirs = jax_clusterer.predict(x)
  np.testing.assert_array_equal(utils.enforce_ordered_labels(ours),
                                utils.enforce_ordered_labels(theirs))


def test_make_embeddings_is_the_bench_fixture():
  for args in ((512,), (300, 64, 3, 5)):
    np.testing.assert_array_equal(make_embeddings(*args),
                                  bench.make_embeddings(*args))


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("n_valid", [None, 300])
def test_refine_and_eigendecompose_matches_jax(solver, n_valid):
  x = np.zeros((384, 64), np.float32)
  x[:300] = make_embeddings(300, d=64, k=3, seed=3)
  if n_valid is None:
    x = x[:300]
  cfg, jcfg = _cfg(solver), _jcfg(solver)
  aff = pipeline.prepare_affinity(torch.as_tensor(x), cfg, n_valid)
  w, v, n_c, delta = pipeline.refine_and_eigendecompose(aff, cfg,
                                                        n_valid=n_valid)
  jaff = j_pipeline.prepare_affinity(jnp.asarray(x), jcfg, n_valid=n_valid)
  jw, jv, jn_c, jdelta = j_pipeline.refine_and_eigendecompose(
      jaff, jcfg, n_valid=n_valid)
  np.testing.assert_allclose(aff.numpy(), np.asarray(jaff), rtol=1e-5,
                             atol=1e-6)
  assert int(n_c) == int(jn_c) == 3
  k = 8
  wmax = float(np.max(np.abs(np.asarray(jw)[:k])))
  np.testing.assert_allclose(w.numpy()[:k], np.asarray(jw)[:k],
                             atol=1e-4 * wmax)
  np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-3)
  assert w.shape == jw.shape and v.shape == jv.shape


@pytest.mark.parametrize("solver", SOLVERS)
def test_padded_run_matches_unpadded(solver):
  x = make_embeddings(300, d=32, k=3, seed=4)
  xp = np.zeros((384, 32), np.float32)
  xp[:300] = x
  cfg = _cfg(solver)
  gen = lambda: torch.Generator().manual_seed(0)
  lab, n_c, w, _ = pipeline.spectral_cluster_fixed_k(torch.as_tensor(x), gen(),
                                                     cfg)
  plab, pn_c, pw, _ = pipeline.spectral_cluster_fixed_k(
      torch.as_tensor(xp), gen(), cfg, n_valid=300)
  assert int(n_c) == int(pn_c) == 3
  np.testing.assert_array_equal(
      utils.enforce_ordered_labels(lab.numpy()),
      utils.enforce_ordered_labels(plab.numpy()[:300]))
  assert (plab.numpy()[300:] == 0).all()
  wmax = float(w.abs().max())
  np.testing.assert_allclose(pw.numpy()[:8], w.numpy()[:8], atol=1e-4 * wmax)


@pytest.mark.parametrize("solver", SOLVERS)
def test_staged_matches_monolithic(solver):
  x = torch.as_tensor(make_embeddings(512))
  cfg = _cfg(solver)
  timings = StageTimings("cpu")
  out = pipeline.spectral_cluster_fixed_k_staged(
      x, torch.Generator().manual_seed(0), cfg, timings=timings)
  ref = pipeline.spectral_cluster_fixed_k(x, torch.Generator().manual_seed(0),
                                          cfg)
  np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
  assert int(out[1]) == int(ref[1]) == 2
  middle = "staged_subspace" if solver == "SubspaceIteration" else "staged_eigh"
  assert set(timings.as_dict()) == {"staged_prep", middle, "staged_finish",
                                    "kmeans"}
  assert set(timings.counters()) == {"lloyd_rounds", "kmeans_kernel"}


def test_staged_auto_past_dc_max_block_returns_topk():
  # The route there is the exact top-k route (stage staged_dc):
  # max_clusters+1 extreme eigenvalues in scan order, from a certified
  # float32 solve, Lanczos on this descending scan (within 2e-4·max|w| of
  # the full eigh's).
  x = torch.as_tensor(make_embeddings(512))
  timings = StageTimings("cpu")
  topk = pipeline.spectral_cluster_fixed_k_staged(
      x, torch.Generator().manual_seed(0), _cfg(dc_max_block=256),
      timings=timings)
  full = pipeline.spectral_cluster_fixed_k(
      x, torch.Generator().manual_seed(0), _cfg())
  assert set(timings.as_dict()) == {"staged_prep", "staged_dc",
                                    "dc_lanczos", "staged_finish",
                                    "kmeans"}
  assert topk[2].shape == (8,) and full[2].shape == (512,)
  np.testing.assert_allclose(topk[2].numpy(), full[2].numpy()[:8],
                             atol=2e-4 * float(full[2].abs().max()))
  np.testing.assert_array_equal(topk[0].numpy(), full[0].numpy())
  # An explicit Eigh keeps the full spectrum there, as in the JAX executor.
  eigh = pipeline.spectral_cluster_fixed_k_staged(
      x, torch.Generator().manual_seed(0),
      _cfg("Eigh", dc_max_block=256))
  assert eigh[2].shape == (512,)


# No symmetric form: the threshold leaves the matrix asymmetric before the
# final RowWiseNormalize, so analyze_symmetry gives GENERAL.
_GENERAL_SEQ = ("CropDiagonal", "GaussianBlur", "RowWiseThreshold",
                "RowWiseNormalize")


def _general_cfgs(route):
  if route == "HostGeneral":
    return _cfg("HostGeneral"), _jcfg("HostGeneral")
  cfg, jcfg = _cfg(), _jcfg()
  seq = tuple(j_types.RefinementName[s] for s in _GENERAL_SEQ)
  jcfg = jcfg.replace(refinement_options=jcfg.refinement_options.replace(
      refinement_sequence=seq))
  return convert.pipeline_config_from(jcfg), jcfg


@pytest.mark.parametrize("route", ["HostGeneral", "Auto"])
@pytest.mark.parametrize("n_valid", [None, 300])
def test_general_route_matches_jax(route, n_valid):
  x = np.zeros((384, 32), np.float32)
  x[:300] = make_embeddings(300, d=32, k=3, seed=3)
  if n_valid is None:
    x = x[:300]
  cfg, jcfg = _general_cfgs(route)
  assert pipeline._solver_structure(cfg) == "general"
  timings = StageTimings("cpu")
  aff = pipeline.prepare_affinity(torch.as_tensor(x), cfg, n_valid)
  w, v, n_c, _ = pipeline.refine_and_eigendecompose(
      aff, cfg, n_valid=n_valid, timings=timings)
  assert set(timings.as_dict()) == {"refine", "host_eig"}
  jaff = j_pipeline.prepare_affinity(jnp.asarray(x), jcfg, n_valid=n_valid)
  jw, jv, jn_c, _ = j_pipeline.refine_and_eigendecompose(jaff, jcfg,
                                                         n_valid=n_valid)
  assert int(n_c) == int(jn_c) == 3
  assert w.shape == jw.shape and v.shape == jv.shape
  # Both run LAPACK's eig on float32 matrices that differ in rounding.
  wmax = float(np.max(np.abs(np.asarray(jw)[:8])))
  np.testing.assert_allclose(w.numpy()[:8], np.asarray(jw)[:8],
                             atol=1e-4 * wmax)
  labels = pipeline.spectral_cluster_fixed_k(
      torch.as_tensor(x), torch.Generator().manual_seed(0), cfg,
      n_valid=n_valid)[0].numpy()
  jlabels = np.asarray(j_pipeline.spectral_cluster_fixed_k(
      jnp.asarray(x), jax.random.PRNGKey(0), jcfg, n_valid=n_valid)[0])
  np.testing.assert_array_equal(utils.enforce_ordered_labels(labels[:300]),
                                utils.enforce_ordered_labels(jlabels[:300]))


@pytest.mark.parametrize("solver", ["Eigh", "SubspaceIteration"])
def test_symmetric_solvers_refuse_general(solver):
  cfg, jcfg = _general_cfgs("Auto")
  cfg = cfg.replace(eigensolver=EigenSolver[solver])
  jcfg = jcfg.replace(eigensolver=j_types.EigenSolver[solver])
  aff = np.random.RandomState(7).rand(64, 64).astype(np.float32)
  with pytest.raises(ValueError, match="not symmetric"):
    pipeline.refine_and_eigendecompose(torch.as_tensor(aff), cfg)
  with pytest.raises(ValueError, match="not symmetric"):
    j_pipeline.refine_and_eigendecompose(jnp.asarray(aff), jcfg)


def test_staged_executor_runs_host_general_unsplit():
  # As in JAX, a configuration the executor cannot split runs monolithic.
  cfg = _cfg("HostGeneral")
  assert not pipeline._staged_applicable(cfg)
  assert pipeline._staged_applicable(_cfg("SubspaceIteration"))
  x = torch.as_tensor(make_embeddings(256, d=32))
  timings = StageTimings("cpu")
  staged = pipeline.spectral_cluster_fixed_k_staged(
      x, torch.Generator().manual_seed(0), cfg, timings=timings)
  mono = pipeline.spectral_cluster_fixed_k(
      x, torch.Generator().manual_seed(0), cfg)
  assert set(timings.as_dict()) == {"refine", "host_eig", "kmeans"}
  for a, b in zip(staged, mono):
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("n_valid", [None, 300])
def test_eig_topk_staged_matches_jax(solver, n_valid):
  x = np.zeros((384, 64), np.float32)
  x[:300] = make_embeddings(300, d=64, k=3, seed=3)
  if n_valid is None:
    x = x[:300]
  cfg, jcfg = _cfg(solver), _jcfg(solver)
  aff = pipeline.prepare_affinity(torch.as_tensor(x), cfg, n_valid)
  before = aff.clone()
  w, v, n_c, delta = pipeline.eig_topk_staged(aff, cfg, n_valid=n_valid)
  assert torch.equal(aff, before)
  jaff = j_pipeline.prepare_affinity(jnp.asarray(x), jcfg, n_valid=n_valid)
  jw, jv, jn_c, jdelta = j_pipeline.eig_topk_staged(
      jaff, jcfg, n_valid=None if n_valid is None else jnp.int32(n_valid))
  assert int(n_c) == int(jn_c) == 3
  assert w.shape == jw.shape == (8,) and v.shape == jv.shape == (x.shape[0], 7)
  wmax = float(np.max(np.abs(np.asarray(jw))))
  np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-4 * wmax)
  np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-3)


def test_eig_topk_staged_eigh_routes():
  # Eigh takes the full eigh: all N eigenvalues within dc_max_block, the
  # max_clusters+1 extreme ones (the exact top-k route of ops/dc.py) past
  # it; this operand's bulk declines the certified solve, so the dc route
  # answers from its spectral divide-and-conquer, whose eigenvalues agree
  # with the full eigh's to float32 noise at the operand's scale.
  x = torch.as_tensor(make_embeddings(300, d=64, k=3, seed=3))
  cfg = _cfg("Eigh")
  aff = pipeline.prepare_affinity(x, cfg)
  full = pipeline.eig_topk_staged(aff, cfg)
  topk = pipeline.eig_topk_staged(aff, cfg.replace(dc_max_block=256))
  assert full[0].shape == (300,) and topk[0].shape == (8,)
  np.testing.assert_allclose(topk[0].numpy(), full[0].numpy()[:8],
                             atol=1e-5 * float(full[0].abs().max()), rtol=0)
  assert int(full[2]) == int(topk[2]) == 3
  with pytest.raises(ValueError, match="general-eig or unbounded-k"):
    pipeline.eig_topk_staged(aff, _cfg("HostGeneral"))
  # A constraint after refinement on the Eigh route, as in JAX (after the
  # icassp2018 sequence's RowWiseNormalize tail it would be GENERAL).
  options = j_types.ConstraintOptions(
      j_types.ConstraintName.AffinityIntegration, False,
      integration_type=j_types.IntegrationType.Average)
  jcfg = _jcfg("Eigh").replace(
      constraint_options=options,
      refinement_options=j_configs.turntodiarize_refinement_options())
  cm = np.eye(300, k=1, dtype=np.float32) + np.eye(300, k=-1,
                                                   dtype=np.float32)
  w, _, n_c, delta = pipeline.eig_topk_staged(
      aff, convert.pipeline_config_from(jcfg),
      constraint_matrix=torch.as_tensor(cm))
  jw, _, jn_c, jdelta = j_pipeline.eig_topk_staged(
      jnp.asarray(aff.numpy()), jcfg, constraint_matrix=jnp.asarray(cm))
  assert int(n_c) == int(jn_c) and w.shape == jw.shape == (300,)
  np.testing.assert_allclose(w.numpy()[:8], np.asarray(jw)[:8],
                             atol=1e-4 * float(np.max(np.abs(jw))))
  np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-3)


def test_clusterer_defaults_to_the_card():
  clusterer = configs.make_icassp2018_clusterer()
  assert clusterer.device == "cuda"
  if torch.cuda.is_available():
    pytest.skip("a card is present: the no-card refusal cannot be shown")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    clusterer.predict(make_embeddings(64, d=8))


def test_predict_details_on_cpu_launch_no_kernel():
  fused.reset_launch_counts()
  result = configs.make_icassp2018_clusterer(
      device="cpu", staged_execution_min_n=512,
      staged_stage_timings=True).predict_with_details(make_embeddings(512))
  assert result.n_clusters == 2
  assert set(result.timings) == {"pipeline", "upload", "staged_prep",
                                 "staged_eigh", "staged_finish", "kmeans",
                                 "download"}
  assert all(v == 0 for v in fused.launch_counts().values())


def test_convert_pipeline_config_every_field():
  jcfg = j_pipeline.PipelineConfig(
      refinement_options=j_configs.turntodiarize_refinement_options(),
      constraint_options=j_configs.turntodiarize_constraint_options(),
      laplacian_type=j_types.LaplacianType.GraphCut, min_clusters=3,
      max_clusters=9, stop_eigenvalue=0.05,
      eigengap_type=j_types.EigenGapType.NormalizedDiff, row_wise_renorm=True,
      custom_dist="sqeuclidean", max_iter=17,
      eigensolver=j_types.EigenSolver.SubspaceIteration,
      affinity_symmetric=False, constraint_symmetric=False,
      eigenvalue_snap_tol=1e-6, use_pallas=False, matmul_precision="high",
      subspace_iters=12, subspace_residual_tol=1e-4, subspace_max_iters=99,
      subspace_drift_tol=None, dc_max_block=4096, dc_sign_precision="highest")
  cfg = convert.pipeline_config_from(jcfg)

  def plain(v):
    if hasattr(v, "name") and not isinstance(v, str):
      return v.name
    if isinstance(v, tuple):
      return tuple(plain(e) for e in v)
    if dataclasses.is_dataclass(v):
      return {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    return v

  for f in dataclasses.fields(jcfg):
    name = "use_kernels" if f.name == "use_pallas" else f.name
    assert plain(getattr(cfg, name)) == plain(getattr(jcfg, f.name)), f.name
  assert len(dataclasses.fields(cfg)) == len(dataclasses.fields(jcfg))
  # An in-graph autotune spec carries across field by field.
  jstatic = j_pipeline.AutoTuneStatic(
      0.5, 0.9, 0.1, proxy=j_types.AutoTuneProxy.PercentileOverNME)
  static = convert.pipeline_config_from(jcfg.replace(autotune=jstatic)).autotune
  assert plain(static) == plain(jstatic)
  np.testing.assert_array_equal(static.candidates(), jstatic.candidates())


def test_subspace_survives_a_collapsed_basis():
  # Two speakers at d=32: block power iteration collapses the 16-column
  # basis onto the rank-2 top, and the Ritz matrix carries float32
  # denormals. torch's float32 eigh raised there; JAX's returned.
  x = make_embeddings(256, d=32)
  out = pipeline.spectral_cluster_fixed_k(
      torch.as_tensor(x), torch.Generator().manual_seed(0),
      _cfg("SubspaceIteration"))
  ref = j_pipeline.spectral_cluster_fixed_k(
      jnp.asarray(x), jax.random.PRNGKey(0), _jcfg("SubspaceIteration"))
  assert int(out[1]) == int(ref[1]) == 2
  np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]),
                             atol=1e-4 * float(np.max(np.abs(ref[2]))))
  np.testing.assert_array_equal(utils.enforce_ordered_labels(out[0].numpy()),
                                utils.enforce_ordered_labels(ref[0]))


def test_converted_config_runs_like_the_port_config():
  x = torch.as_tensor(make_embeddings(256, d=32))
  cfg = convert.pipeline_config_from(_jcfg("SubspaceIteration"))
  a = pipeline.spectral_cluster_fixed_k(x, torch.Generator().manual_seed(0),
                                        cfg)
  b = pipeline.spectral_cluster_fixed_k(x, torch.Generator().manual_seed(0),
                                        _cfg("SubspaceIteration"))
  np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


def _imports(path):
  tree = ast.parse(open(path).read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def _port_files():
  root = os.path.join(REPO, "spectralcluster_tpu_torch")
  files = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tools", "profile_predict_torch.py")]
  for dirpath, _, names in os.walk(root):
    files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
  return files


def test_port_imports_neither_jax_nor_the_jax_package():
  files = _port_files()
  assert len(files) > 10
  for path in files:
    for mod in _imports(path):
      top = mod.split(".")[0]
      assert top not in ("jax", "jaxlib"), (path, mod)
      assert mod != "spectralcluster_tpu" and not mod.startswith(
          "spectralcluster_tpu."), (path, mod)
