"""The port's exact top-k route (``ops/dc.py``) and its pipeline wiring vs
the JAX package, on the same numpy inputs (CPU).

Spectra are the JAX tests' own (``tests/test_eigen_dc.py``) at n ≤ 512
with ``max_block=128``, and the staged pipeline at ``dc_max_block=48``.
Tolerances, as stated in each test: eigenvalues within 1e-3·λmax of a
float64 numpy eigh and within 2e-4·scale of the JAX route (float32 solves
from different start panels); residual certificates ≤ 1e-5; the separated
pairs' subspaces equal to 1e-4 in their smallest principal cosine.
"""

import ast
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import pipeline as j_pipeline
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu.ops import dc as j_dc
from spectralcluster_tpu.ops import eigen as j_eigen
from spectralcluster_tpu_torch import configs
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import pipeline
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.fixtures import (make_embeddings,
                                                make_embeddings_k)
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.observability import StageTimings
from spectralcluster_tpu_torch.ops import dc
from spectralcluster_tpu_torch.ops import eigen as eigen_ops
from spectralcluster_tpu_torch.ops import refinement

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_sym(n, eigs, seed):
  q, _ = np.linalg.qr(np.random.RandomState(seed).randn(n, n))
  return (q * np.asarray(eigs)[None, :]) @ q.T


def _gen(seed=0):
  return torch.Generator().manual_seed(seed)


def _dominant(n=512):
  # Diarization-like: four dominant eigenvalues over a quasi-degenerate
  # bulk (test_eigen_dc.py:426-447).
  rng = np.random.RandomState(1)
  eigs = np.concatenate([[260.0, 250.0, 240.0, 230.0],
                         1e-3 + rng.randn(n - 4) * 1e-4])
  return _make_sym(n, eigs, seed=2), 4


def _padded_ascending(n=512, nv=400):
  # Two dominant negative eigenvalues over a flat bulk, padded, scanned
  # ascending (test_eigen_dc.py:449-463).
  eigs = np.concatenate([[-260.0, -250.0], np.full(nv - 2, -1e-3)])
  a = np.zeros((n, n), np.float32)
  a[:nv, :nv] = _make_sym(nv, eigs, seed=3).astype(np.float32)
  return a, nv, 2


def _both(a, t, descend=True, n_valid=None, **kw):
  """The port's and JAX's eigh_topk_dc on the same float32 operand (with
  the padding sentinels when n_valid is set)."""
  a32 = a.astype(np.float32)
  m_j = jnp.asarray(a32)
  m_t = torch.as_tensor(a32)
  if n_valid is not None:
    m_j = j_eigen.apply_padding_sentinels(m_j, n_valid, descend)
    m_t = eigen_ops.apply_padding_sentinels(m_t, n_valid, descend)
  info = {}
  ours = dc.eigh_topk_dc(m_t, t, _gen(), descend=descend, n_valid=n_valid,
                         max_block=128, info=info, **kw)
  theirs = j_dc.eigh_topk_dc(m_j, t, jax.random.PRNGKey(0), descend=descend,
                             n_valid=n_valid, max_block=128, **kw)
  return ours, theirs, info


@pytest.mark.parametrize("case", ["dominant", "padded_ascending"])
def test_certified_route_matches_jax(case):
  if case == "dominant":
    (a, n_sep), nv, descend = _dominant(), None, True
  else:
    a, nv, n_sep = _padded_ascending()
    descend = False
  (w, v, res, scale), (jw, jv, jres, jscale), info = _both(
      a, 8, descend=descend, n_valid=nv)
  assert info["route"] == "certified"
  w, v, jw, jv = w.numpy(), v.numpy(), np.asarray(jw), np.asarray(jv)
  nvv = a.shape[0] if nv is None else nv
  ref = np.linalg.eigh(a[:nvv, :nvv].astype(np.float64))[0]
  ref = ref[::-1][:8] if descend else ref[:8]
  lam = float(np.max(np.abs(ref)))
  np.testing.assert_allclose(w, ref, atol=1e-3 * lam)
  np.testing.assert_allclose(w, jw, atol=2e-4 * scale)
  assert res <= dc._ITER_ACCEPT_RES and jres <= j_dc._ITER_ACCEPT_RES
  assert 0.3 * lam <= scale <= 3.2 * lam
  # The separated pairs span the same subspace as JAX's.
  cosines = np.linalg.svd(v[:, :n_sep].T @ jv[:, :n_sep], compute_uv=False)
  assert cosines.min() >= 1 - 1e-4
  if nv is not None:
    assert np.abs(v[nv:]).max() < 1e-3


def test_probe_detects_missed_top_eigenvalue():
  # The probe gets t pairs that leave out the dominant one
  # (test_eigen_dc.py:485-502): the deflated remainder must surface it,
  # in both packages.
  n, t = 256, 4
  rng = np.random.RandomState(4)
  a = _make_sym(n, np.concatenate([[100.0, 50.0, 45.0, 40.0, 35.0],
                                   rng.randn(n - 5) * 0.3]), seed=5)
  w64, v64 = np.linalg.eigh(a)
  w_miss = w64[::-1][1:t + 1].astype(np.float32)
  v_miss = v64[:, ::-1][:, 1:t + 1].astype(np.float32)
  b = float(np.abs(a).sum(1).max()) + 1.0
  a32 = a.astype(np.float32)
  est, _ = dc._probe_next(torch.as_tensor(a32), torch.as_tensor(v_miss),
                          torch.as_tensor(w_miss), None, b, _gen(3), True)
  j_est, _ = jax.device_get(j_dc._probe_next_jit(n, t, True, False)(
      jnp.asarray(a32), jnp.asarray(v_miss), jnp.asarray(w_miss),
      jnp.asarray(n), jnp.float32(b), jax.random.PRNGKey(3)))
  assert est > 90.0 and float(j_est) > 90.0
  # And the certified route declines on it.
  w_t = float(w_miss[-1])
  assert est > w_t + dc._MISS_MARGIN * b


@pytest.mark.parametrize("how", ["forced", "spread_bulk"])
def test_decline_lands_on_full_eigh(how):
  # Named for the route the port declined to before it had the split.
  # Forced: try_iterative_first=False on the dominant spectrum. Spread
  # bulk: the six bulk pairs of t=8 cannot meet the 1e-5 residual within
  # the iteration cap (test_eigen_dc.py:465-483), so the route declines by
  # itself. Either way the spectral divide-and-conquer answers, as in JAX,
  # with the exact eigenvalues.
  if how == "forced":
    a, _ = _dominant()
    kw = {"try_iterative_first": False}
  else:
    rng = np.random.RandomState(6)
    a = _make_sym(512, np.concatenate([[260.0, 250.0],
                                       rng.randn(510) * 0.5]), seed=7)
    kw = {}
  info = {}
  w, v, res, scale = dc.eigh_topk_dc(torch.as_tensor(a.astype(np.float32)),
                                     8, _gen(), max_block=128, info=info,
                                     **kw)
  assert info["route"] == "split" and info["levels"]
  ref = np.linalg.eigh(a)[0][::-1][:8]
  np.testing.assert_allclose(w.numpy(), ref, atol=1e-3 * ref[0])
  assert res <= dc._ITER_ACCEPT_RES
  # The split's norm estimate: |sigma| + a power-iteration ‖m − σI‖₂
  # (test_eigen_dc.py's band).
  anorm = float(np.max(np.abs(np.linalg.eigvalsh(a))))
  assert 0.3 * anorm <= scale <= 3.2 * anorm
  if how == "forced":
    certified, _, _, _ = dc.eigh_topk_dc(
        torch.as_tensor(a.astype(np.float32)), 8, _gen(), max_block=128)
    np.testing.assert_allclose(w.numpy(), certified.numpy(),
                               atol=2e-4 * scale)


def test_dense_branch_matches_jax():
  a, _ = _dominant(n=96)
  (w, _, res, scale), (jw, _, jres, jscale), info = _both(a, 8)
  assert info["route"] == "dense" and res == jres == 0.0
  np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=2e-4 * jscale)
  assert scale == pytest.approx(jscale, rel=1e-5)


@pytest.mark.parametrize("res,raises", [(1e-3, False), (0.0101, True),
                                        (float("nan"), True)])
def test_check_residual(res, raises):
  for check in (dc._check_residual, j_dc._check_residual):
    if raises:
      with pytest.raises(RuntimeError, match="residual"):
        check(res)
    else:
      check(res)


def _icassp_cfg(**kw):
  return j_pipeline.PipelineConfig(
      refinement_options=j_configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, **kw)


# test_eigen_dc.py:540-574: (w, res, wscale, whether it warns).
WARN_CASES = {
    "count_depends_on_banded_value": ([5.0, 0.0101, 1e-6, 1e-6], 1e-4, True),
    "count_is_robust": ([5.0, 4.0, 0.0099, 0.0090, 0.0085, 0.0080], 1e-3,
                        False),
    "values_clear_of_stop": ([5.0, 4.0, 1e-6], 1e-6, False),
}


@pytest.mark.parametrize("case", sorted(WARN_CASES))
def test_warn_near_stop_matches_jax(case):
  w, res, expected = WARN_CASES[case]
  jcfg = _icassp_cfg()
  hits = []
  for warn, cfg in ((pipeline._warn_near_stop,
                     convert.pipeline_config_from(jcfg)),
                    (j_pipeline._warn_near_stop, jcfg)):
    with warnings.catch_warnings(record=True) as rec:
      warnings.simplefilter("always")
      hit = warn(np.array(w), res=res, wscale=5.0, cfg=cfg, where="test")
    assert len(rec) == int(hit)
    hits.append(hit)
  assert hits == [expected, expected]


@pytest.mark.parametrize("first_answers", [True, False])
def test_staged_pipeline_surfaces_the_warning(monkeypatch, first_answers):
  # The staged executor's dc route warns when a solve hands back values
  # inside the uncertainty band (test_eigen_dc.py:576-595): on this
  # descending scan its first solve, Lanczos, held to the certified
  # route's residual; or, where Lanczos declines on its residual, the
  # certified attempt. Only the first such solve warns.
  def fake_dc(m, t, generator, **kw):
    w = torch.tensor([5.0, 0.01] + [1e-6] * 6)
    return w, torch.eye(m.shape[0], 8), 1e-3, 5.0

  def fake_lanczos(m, t, generator, *a, **kw):
    w, u, _, scale = fake_dc(m, t, generator)
    res = dc._ITER_ACCEPT_RES if first_answers else 2 * dc._ITER_ACCEPT_RES
    return w, u, res, scale

  monkeypatch.setattr(dc, "eigh_topk_dc", fake_dc)
  monkeypatch.setattr(dc, "lanczos_topt", fake_lanczos)
  cfg = convert.pipeline_config_from(_icassp_cfg(dc_max_block=64))
  x = torch.as_tensor(np.random.RandomState(0).randn(128, 8).astype(
      np.float32))
  with warnings.catch_warnings(record=True) as rec:
    warnings.simplefilter("always")
    pipeline.spectral_cluster_fixed_k_staged(x, _gen(), cfg)
  assert sum("stop_eigenvalue" in str(r.message) for r in rec) == 1


def _staged_embeddings(n=96, d=16, k=3, seed=0):
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  labels = np.repeat(np.arange(k), n // k)
  return (centers[labels] + rng.randn(n, d) * 0.3).astype(np.float32)


def _separated(n=120, d=128):
  """The record-size regime of test_eigen_dc.py:357-390: three
  well-separated speakers."""
  rng = np.random.RandomState(7)
  centers = rng.randn(3, d) * 3.0
  labels = np.repeat(np.arange(3), n // 3)
  return (centers[labels] + rng.randn(n, d) * 0.05).astype(np.float32)


def _separated_cfg(**kw):
  # A hard threshold and no blur collapse the operand's bulk to the
  # float32 floor, as record-size inputs do, so both packages take the
  # certified route (a decline sends the JAX package through its sign
  # chain, minutes of compiles on a loaded CPU).
  return _icassp_cfg(dc_max_block=48, **kw).replace(
      refinement_options=j_configs.icassp2018_refinement_options().replace(
          thresholding_soft_multiplier=0.0, gaussian_blur_sigma=0))


def _laplacian_cfg():
  return j_pipeline.PipelineConfig(
      refinement_options=j_types.RefinementOptions(
          thresholding_type=j_types.ThresholdType.Percentile,
          p_percentile=0.9,
          refinement_sequence=(j_types.RefinementName.RowWiseThreshold,
                               j_types.RefinementName.Symmetrize)),
      laplacian_type=j_types.LaplacianType.GraphCut,
      eigengap_type=j_types.EigenGapType.NormalizedDiff,
      min_clusters=1, max_clusters=5, row_wise_renorm=True, dc_max_block=48)


def _record_routes(monkeypatch):
  """Lists that receive the route each package's dc solver takes:
  "certified", or its decline, the sign-chain "split"; and the port's
  "lanczos" where its staged executor runs Lanczos (on a descending scan
  before the certified attempt)."""
  routes, j_routes = [], []
  solve, j_certified = dc.eigh_topk_dc, j_dc._certified_iterative_topt
  lanczos = dc.lanczos_topt

  def recording(*a, **kw):
    info = {}
    out = solve(*a, info=info, **kw)
    routes.append(info["route"])
    return out

  def recording_lanczos(*a, **kw):
    routes.append("lanczos")
    return lanczos(*a, **kw)

  def j_recording(*a, **kw):
    out = j_certified(*a, **kw)
    j_routes.append("split" if out is None else "certified")
    return out

  monkeypatch.setattr(dc, "eigh_topk_dc", recording)
  monkeypatch.setattr(dc, "lanczos_topt", recording_lanczos)
  monkeypatch.setattr(j_dc, "_certified_iterative_topt", j_recording)
  return routes, j_routes


@pytest.mark.parametrize("case", ["icassp2018", "padded", "laplacian_ascend"])
def test_staged_dc_matches_jax(case, monkeypatch):
  # test_eigen_dc.py:341-419: dc_max_block=48 puts N=96 and 120 (buckets
  # 128) on the dc route.
  n_valid = None
  if case == "laplacian_ascend":
    jcfg, x = _laplacian_cfg(), _staged_embeddings(seed=1)
  else:
    jcfg, x = _separated_cfg(), _separated()
  if case == "padded":
    x = np.concatenate([_separated(n=90), np.zeros((38, 128), np.float32)])
    n_valid = 90
  routes, j_routes = _record_routes(monkeypatch)
  timings = StageTimings("cpu")
  labels, n_c, w, _ = pipeline.spectral_cluster_fixed_k_staged(
      torch.as_tensor(x), _gen(), convert.pipeline_config_from(jcfg),
      n_valid=n_valid, timings=timings)
  jlabels, jn_c, jw, _ = jax.device_get(
      j_pipeline.spectral_cluster_fixed_k_staged(
          jnp.asarray(x), jax.random.PRNGKey(0), jcfg,
          n_valid=None if n_valid is None else jnp.int32(n_valid)))
  # The port's first solve: Lanczos on a descending scan, the certified
  # attempt on an ascending one; both answer here.
  first = "certified" if case == "laplacian_ascend" else "lanczos"
  assert routes == [first] and j_routes == ["certified"]
  assert set(timings.as_dict()) == {"staged_prep", "staged_dc",
                                    "dc_" + first, "staged_finish",
                                    "kmeans"}
  nv = x.shape[0] if n_valid is None else n_valid
  assert int(n_c) == int(jn_c)
  np.testing.assert_array_equal(utils.enforce_ordered_labels(labels[:nv]),
                                utils.enforce_ordered_labels(jlabels[:nv]))
  assert w.shape == jw.shape == (jcfg.max_clusters + 1,)
  # The snapped eigenvalues (ClusterResult.eigenvalues on this route).
  np.testing.assert_allclose(w.numpy(), jw,
                             atol=2e-4 * float(np.max(np.abs(jw))))


def test_eig_topk_staged_eigh_runs_dc(monkeypatch):
  # Eigh past dc_max_block in eig_topk_staged takes the dc route too.
  routes, j_routes = _record_routes(monkeypatch)
  jcfg = _separated_cfg(eigensolver=j_types.EigenSolver.Eigh)
  x = _separated()
  cfg = convert.pipeline_config_from(jcfg)
  aff = pipeline.prepare_affinity(torch.as_tensor(x), cfg)
  w, _, n_c, delta = pipeline.eig_topk_staged(aff, cfg)
  jaff = j_pipeline.prepare_affinity(jnp.asarray(x), jcfg)
  jw, _, jn_c, jdelta = j_pipeline.eig_topk_staged(jaff, jcfg)
  assert routes == ["lanczos"] and j_routes == ["certified"]
  assert int(n_c) == int(jn_c) == 3
  np.testing.assert_allclose(w.numpy(), np.asarray(jw),
                             atol=2e-4 * float(np.max(np.abs(jw))))
  np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-3)


@pytest.mark.parametrize("n,k", [(10240, 4), (10240, 7), (300, 7)])
def test_make_embeddings_k_is_the_bench_fixture(n, k):
  # benchmarks/bench_multispeaker.py's make_embeddings_k, read from the
  # file (importing the bench would configure JAX's compile cache).
  path = os.path.join(REPO, "benchmarks", "bench_multispeaker.py")
  with open(path) as f:
    tree = ast.parse(f.read())
  fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
            and node.name == "make_embeddings_k")
  scope = {"np": np}
  exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), scope)
  x, labels = make_embeddings_k(n, k)
  want_x, want_labels = scope["make_embeddings_k"](n, k)
  np.testing.assert_array_equal(x, want_x)
  np.testing.assert_array_equal(labels, want_labels)


# ---------------------------------------------------------------------------
# The subspace solver's product and Gram (kernel 6 and a float64 product
# on the card) and the certified route on the smoke's fixtures, against the JAX package.
# ---------------------------------------------------------------------------


def _gamma_bound(a, x):
  """The float32 bound of a K-term sum, 2·K·2⁻²⁴·(|a|·|x|), elementwise."""
  a, x = np.abs(a.astype(np.float64)), np.abs(x.astype(np.float64))
  return 2.0 * a.shape[-1] * 2.0**-24 * (a @ x)


@pytest.mark.parametrize("shape", [(300, 300, 16), (301, 257, 9),
                                   (3, 128, 128, 16), (75, 300, 1)])
def test_panel_matmul_twin_against_jax(shape):
  # On the CPU the wrapper is its twin, torch.matmul, bit for bit (the
  # solver's CPU path keeps its bits); both sum within the float32 bound of
  # a K-term sum of JAX's float32 dot on the same numpy input.
  rng = np.random.RandomState(5)
  *lead, m, k, b = shape
  a = rng.randn(*lead, m, k).astype(np.float32)
  x = rng.randn(*lead, k, b).astype(np.float32)
  got = fused.panel_matmul(torch.as_tensor(a), torch.as_tensor(x))
  torch.testing.assert_close(got, torch.matmul(torch.as_tensor(a),
                                               torch.as_tensor(x)),
                             rtol=0, atol=0)
  want = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(x),
                               preferred_element_type=jnp.float32))
  assert np.all(np.abs(got.numpy() - want) <= _gamma_bound(a, x))


def test_panel_matmul_reads_a_row_stripe():
  # A stripe of rows of a larger matrix (the row-sharded solver's operand)
  # gives the stripe's rows of the whole product.
  rng = np.random.RandomState(6)
  a = torch.as_tensor(rng.randn(256, 256).astype(np.float32))
  x = torch.as_tensor(rng.randn(256, 16).astype(np.float32))
  torch.testing.assert_close(fused.panel_matmul(a[64:128], x),
                             torch.matmul(a, x)[64:128], rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(512, 16, 16), (300, 16, 8),
                                   (4, 256, 16, 16), (257, 19, 3)])
def test_panel_gram_twin_against_jax(shape):
  # On the CPU the solver's Gram is the float32 torch.matmul, bit for bit;
  # within the float32 bound of a K-term sum of JAX's float32 dot.
  rng = np.random.RandomState(7)
  *lead, k, p, r = shape
  a = rng.randn(*lead, k, p).astype(np.float32)
  b = rng.randn(*lead, k, r).astype(np.float32)
  got = eigen_ops.panel_gram(torch.as_tensor(a), torch.as_tensor(b))
  at = torch.as_tensor(a).transpose(-1, -2)
  torch.testing.assert_close(got, torch.matmul(at, torch.as_tensor(b)),
                             rtol=0, atol=0)
  a_t = np.swapaxes(a, -1, -2)
  want = np.asarray(jnp.matmul(jnp.asarray(a_t), jnp.asarray(b),
                               preferred_element_type=jnp.float32))
  assert np.all(np.abs(got.numpy() - want) <= _gamma_bound(a_t, b))


def _smoke_operand(x):
  """chip_smoke.py's certified-route operand (fused.affinity, then the
  ROWNORM_TAIL operand), on the CPU, as numpy."""
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7)
  m, _ = pipeline._symmetric_eig_operand(
      fused.affinity(torch.as_tensor(x)), cfg, None, None,
      refinement.ROWNORM_TAIL, consume_input=True)
  return m.numpy()


@pytest.mark.parametrize("k", [2, 4, 7])
def test_certified_route_on_smoke_fixtures_matches_jax(k):
  # The smoke's route gate cut to N=512: both packages' certified route on
  # the same float32 operand take the same route, the port's residual trace
  # has one entry per 32-iteration chunk and, where the solve stopped
  # before the cap, ends at or under the solver's tolerance. Eigenvalues
  # within 2e-4·scale of JAX's (float32 solves from different panels).
  x = make_embeddings(512) if k == 2 else make_embeddings_k(512, k)[0]
  m = _smoke_operand(x)
  info = {}
  ours = dc._certified_iterative_topt(
      torch.as_tensor(m), 8, _gen(pipeline._DC_SEED), True, None, info)
  theirs = j_dc._certified_iterative_topt(
      jnp.asarray(m), 8, jax.random.PRNGKey(17), True, None)
  assert (ours is None) == (theirs is None)
  trace = info["res_trace"]
  assert len(trace) == info["iters"] // dc._SUBSPACE_ITERS
  if info["iters"] < dc._SUBSPACE_MAX_ITERS:
    assert trace[-1] <= dc._SUBSPACE_RESIDUAL_TOL < min(trace[:-1] or [1.0])
  if ours is not None:
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]),
                               atol=2e-4 * ours[3])
    assert ours[2] <= dc._ITER_ACCEPT_RES and theirs[2] <= j_dc._ITER_ACCEPT_RES


def test_subspace_residual_trace_batched():
  # A (B, N, N) batch reports its trace per chunk and per matrix; a matrix
  # frozen at its stop keeps its last residual.
  rng = np.random.RandomState(8)
  mats = []
  for r in (0.9, 0.995):
    q, _ = np.linalg.qr(rng.randn(128, 128))
    mats.append((q * r ** np.arange(128)) @ q.T)
  mats = torch.as_tensor(np.stack(mats).astype(np.float32))
  stats = {}
  eigen_ops.topk_eigh_subspace(mats, 4, _gen(), num_iters=8,
                               residual_tol=1e-4, max_iters=256, stats=stats)
  trace = np.asarray(stats["res"])
  iters = stats["iters"].numpy()
  assert trace.shape == (int(iters.max()) // 8, 2)
  for lane in range(2):
    stop = int(iters[lane]) // 8 - 1
    assert np.all(trace[stop:, lane] == trace[stop, lane])


def test_recorded_route_reference_agrees():
  # tests/data/reference_dc_route.json (tools/record_dc_route_reference.py):
  # on each of the smoke's operands built on the CPU, the port took the JAX
  # package's route, below the iteration cap, and certified.
  with open(os.path.join(REPO, "tests", "data",
                         "reference_dc_route.json")) as f:
    record = json.load(f)
  assert record["constants"] == {
      "iter_accept_res": dc._ITER_ACCEPT_RES,
      "subspace_iters": dc._SUBSPACE_ITERS,
      "subspace_residual_tol": dc._SUBSPACE_RESIDUAL_TOL,
      "subspace_max_iters": dc._SUBSPACE_MAX_ITERS}
  assert set(record["cases"]) == {"n10240_k2", "n20480_k2", "n10240_k4",
                                  "n10240_k7"}
  for case in record["cases"].values():
    port, jax_route = case["port"], case["jax"]
    assert port["accepted"] == jax_route["accepted"]
    assert port["iters"] < dc._SUBSPACE_MAX_ITERS
    assert len(port["res_trace"]) == port["iters"] // dc._SUBSPACE_ITERS
    if port["accepted"]:
      assert port["res"] <= dc._ITER_ACCEPT_RES
      assert jax_route["res"] <= j_dc._ITER_ACCEPT_RES


@pytest.mark.parametrize("batch", [None, 3])
def test_cholqr_pass_twin_against_jax(batch):
  # CholeskyQR2 through the pass's twin (cholesky_ex and a triangular
  # solve) against JAX's cholqr2_shifted on the same numpy panel, each
  # panel of a batch alone: the same orthonormal basis within 1e-5 (float32
  # Cholesky and solves in other orders), orthonormal to 1e-5.
  rng = np.random.RandomState(9)
  lead = () if batch is None else (batch,)
  y = (rng.randn(*lead, 300, 16) * np.logspace(0, 3, 16)).astype(np.float32)
  got = eigen_ops.cholqr2_shifted(torch.as_tensor(y)).numpy()
  for i in range(1 if batch is None else batch):
    yi, gi = (y, got) if batch is None else (y[i], got[i])
    want = np.asarray(j_eigen.cholqr2_shifted(jnp.asarray(yi)))
    np.testing.assert_allclose(gi, want, atol=1e-5)
    np.testing.assert_allclose(gi.T @ gi, np.eye(16), atol=1e-5)
  gram = eigen_ops.panel_gram(torch.as_tensor(y), torch.as_tensor(y))
  q, info = fused.cholqr_pass(torch.as_tensor(y), gram, 1e-6)
  q_plain, info_plain = fused.cholqr_pass_plain(torch.as_tensor(y), gram, 1e-6)
  torch.testing.assert_close(q, q_plain, rtol=0, atol=0)
  assert torch.equal(info, info_plain) and not bool(torch.any(info))


def test_cholqr_pass_reports_a_failed_factorization():
  # An indefinite Gram: info names the failed column, as cholesky_ex does,
  # and CholeskyQR2 then takes the 1e-2 rescue.
  y = torch.as_tensor(np.random.RandomState(10).randn(64, 4).astype(
      np.float32))
  _, info = fused.cholqr_pass(y, -torch.eye(4), 1e-6)
  assert int(info) == 1
