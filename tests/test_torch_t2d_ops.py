"""The port's Turn-to-Diarize pieces vs the JAX package's, on the CPU.

Laplacians (ops/laplacian.py), E2CP and the other constraint operations
(constraint.py), AutoTune (autotune.py) and AutoTuneStatic, each fed the
same numpy inputs as its JAX counterpart. Tolerances: Laplacians at rtol
1e-5, atol 1e-6 (float32 elementwise work in another order); E2CP at rtol
1e-4, atol 1e-5 (about 30 float32 (N, N) products); host-numpy pieces
exactly.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralcluster_tpu import autotune as j_autotune
from spectralcluster_tpu import constraint as j_constraint
from spectralcluster_tpu import pipeline as j_pipeline
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu.ops import laplacian as j_laplacian
from spectralcluster_tpu_torch import autotune
from spectralcluster_tpu_torch import constraint
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import pipeline
from spectralcluster_tpu_torch.fixtures import make_t2d_fixture
from spectralcluster_tpu_torch.ops import laplacian
from spectralcluster_tpu_torch.types import (AutoTuneProxy, ConstraintName,
                                             ConstraintOptions,
                                             IntegrationType, LaplacianType)

torch.set_num_threads(1)

N, N_PAD = 150, 192


def _affinity(seed=0, n=N, n_pad=None):
  """A T2D-fixture cosine affinity, zero-padded to n_pad."""
  x, _, _ = make_t2d_fixture(n, d=32, k=3, seed=seed)
  xn = x / np.linalg.norm(x, axis=1, keepdims=True)
  a = ((xn @ xn.T + 1.0) / 2.0).astype(np.float32)
  if n_pad is None:
    return a
  out = np.zeros((n_pad, n_pad), np.float32)
  out[:n, :n] = a
  return out


def _constraint(seed=0, n=N, n_pad=None, asymmetric=False):
  _, scores, _ = make_t2d_fixture(n, d=32, k=3, seed=seed)
  cm = constraint.ConstraintMatrix(scores, threshold=1).compute_diagonals()
  if asymmetric:
    cm = np.triu(cm)
  out = np.zeros((n_pad or n,) * 2, np.float32)
  out[:n, :n] = cm
  return out


def test_make_t2d_fixture_is_the_bench_fixture():
  path = os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "benchmarks", "t2d_fixture.py")
  spec = importlib.util.spec_from_file_location("t2d_fixture", path)
  bench_fixture = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(bench_fixture)
  for args in ((256,), (103, 16, 3, 5)):
    for ours, theirs in zip(make_t2d_fixture(*args),
                            bench_fixture.make_t2d_fixture(*args)):
      np.testing.assert_array_equal(ours, theirs)


def _pair(a):
  return torch.as_tensor(a), jnp.asarray(a)


def _close(got, want, rtol, atol):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                             atol=atol)


@pytest.mark.parametrize("lap", list(LaplacianType), ids=lambda t: t.name)
@pytest.mark.parametrize("n_valid", [None, N])
def test_laplacians_match_jax(lap, n_valid):
  a, ja = _pair(_affinity(n_pad=None if n_valid is None else N_PAD))
  jlap = j_types.LaplacianType[lap.name]
  _close(laplacian.compute_laplacian(a, lap, n_valid=n_valid),
         j_laplacian.compute_laplacian(ja, jlap, n_valid=n_valid), 1e-5, 1e-6)
  m, s = laplacian.laplacian_similarity(a, lap, n_valid=n_valid)
  jm, js = j_laplacian.laplacian_similarity(ja, jlap, n_valid=n_valid)
  _close(m, jm, 1e-5, 1e-6)
  assert (s is None) == (js is None)
  if s is not None:
    _close(s, js, 1e-5, 1e-6)


def test_compute_laplacian_refuses_a_non_enum():
  with pytest.raises(TypeError, match="LaplacianType"):
    laplacian.compute_laplacian(torch.eye(3), "GraphCut")


@pytest.mark.parametrize("kind", list(IntegrationType), ids=lambda t: t.name)
def test_affinity_integration_matches_jax(kind):
  a, ja = _pair(_affinity())
  q, jq = _pair(_constraint())
  got = constraint.affinity_integration(a, q, kind)
  want = j_constraint.affinity_integration(
      ja, jq, j_types.IntegrationType[kind.name])
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alpha", [0.4, 0.97])
@pytest.mark.parametrize("n_valid", [None, N])
@pytest.mark.parametrize("asymmetric", [False, True])
def test_constraint_propagation_matches_jax(alpha, n_valid, asymmetric):
  # α=0.4 is the preset's fixed-point route, α=0.97 the dense LU route.
  n_pad = None if n_valid is None else N_PAD
  a, ja = _pair(_affinity(n_pad=n_pad))
  q, jq = _pair(_constraint(n_pad=n_pad, asymmetric=asymmetric))
  got, res = constraint.constraint_propagation(a, q, alpha, n_valid,
                                               with_residual=True)
  want, jres = j_constraint.constraint_propagation(ja, jq, alpha, n_valid,
                                                   with_residual=True)
  _close(got, want, 1e-4, 1e-5)
  assert float(res) <= 1e-6 and float(jres) <= 1e-6
  assert (float(res) == 0.0) == (float(jres) == 0.0) == (alpha >= 0.95)
  # The same step count as the JAX while_loop's gate would take.
  _, _, steps = constraint.propagate(a, q, alpha, n_valid)
  if alpha < 0.95:
    assert 0 < max(steps) < constraint._neumann_cap(alpha)
  else:
    assert steps == (0, 0)


@pytest.mark.parametrize("alpha", [0.0, 0.4, 0.6, 0.9, 0.94])
def test_neumann_cap_matches_jax(alpha):
  assert constraint._neumann_cap(alpha) == j_constraint._neumann_cap(alpha)
  assert constraint._neumann_cap(0.4) == 32


@pytest.mark.parametrize("options", [
    ConstraintOptions(ConstraintName.ConstraintPropagation, True,
                      constraint_propagation_alpha=0.4),
    ConstraintOptions(ConstraintName.AffinityIntegration, False,
                      integration_type=IntegrationType.Max),
], ids=["propagation", "integration"])
@pytest.mark.parametrize("n_valid", [None, N])
def test_adjust_affinity_matches_jax(options, n_valid):
  n_pad = None if n_valid is None else N_PAD
  a, ja = _pair(_affinity(n_pad=n_pad))
  q, jq = _pair(_constraint(n_pad=n_pad))
  got = constraint.adjust_affinity(a, q, options, n_valid)
  want = j_constraint.adjust_affinity(ja, jq, _jax_options(options),
                                      n_valid)
  _close(got, want, 1e-4, 1e-5)
  if n_valid is not None:
    assert not got[n_valid:].any() and not got[:, n_valid:].any()


def _jax_options(options):
  return j_types.ConstraintOptions(
      constraint_name=j_types.ConstraintName[options.constraint_name.name],
      apply_before_refinement=options.apply_before_refinement,
      integration_type=(None if options.integration_type is None else
                        j_types.IntegrationType[options.integration_type.name]),
      constraint_propagation_alpha=options.constraint_propagation_alpha)


@pytest.mark.parametrize("shapes,message", [
    (((3,), (3, 3)), "affinity must be a 2-D square matrix"),
    (((3, 4), (3, 3)), "affinity must be a 2-D square matrix"),
    (((3, 3), (3, 4)), "constraint matrix must be a 2-D square matrix"),
    (((3, 3), (4, 4)), "must have the same shape"),
])
def test_adjust_affinity_shape_errors_match_jax(shapes, message):
  options = ConstraintOptions(ConstraintName.AffinityIntegration, True,
                              integration_type=IntegrationType.Max)
  a, q = (np.zeros(s, np.float32) for s in shapes)
  with pytest.raises(ValueError, match=message):
    constraint.adjust_affinity(torch.as_tensor(a), torch.as_tensor(q),
                               options)
  with pytest.raises(ValueError, match=message):
    j_constraint.adjust_affinity(jnp.asarray(a), jnp.asarray(q),
                                 _jax_options(options))


@pytest.mark.parametrize("threshold", [1, 0.4])
def test_constraint_matrix_matches_jax(threshold):
  _, scores, _ = make_t2d_fixture(97, d=8, k=3, seed=4)
  for s in (scores, scores[:1], []):
    np.testing.assert_array_equal(
        constraint.ConstraintMatrix(s, threshold).compute_diagonals(),
        j_constraint.ConstraintMatrix(s, threshold).compute_diagonals())
  with pytest.raises(ValueError, match="larger or equal to 0"):
    constraint.ConstraintMatrix([0.0, -1.0])


def _multimodal(p):
  return float(np.sin(37.0 * p) + 0.5 * np.cos(11.0 * p) + (p - 0.8) ** 2)


@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("pmin,pmax,step", [
    (0.40, 0.95, 0.05),   # the Turn-to-Diarize preset's grid
    (0.60, 0.95, 0.01),
    (0.50, 1.00, 0.25),   # narrowed levels regenerate searched values
])
def test_autotune_tune_matches_jax(level, pmin, pmax, step):
  kwargs = dict(p_percentile_min=pmin, p_percentile_max=pmax,
                init_search_step=step, search_level=level)
  ours, theirs = autotune.AutoTune(**kwargs), j_autotune.AutoTune(**kwargs)
  assert ours.get_percentile_range() == theirs.get_percentile_range()
  calls = {"ours": [], "theirs": []}

  def callback(who):
    def cb(p):
      calls[who].append(float(p))
      return _multimodal(p), np.full((4, 4), p), int(1 + round(p * 100) % 5)
    return cb

  v1, n1, p1 = ours.tune(callback("ours"))
  v2, n2, p2 = theirs.tune(callback("theirs"))
  assert calls["ours"] == calls["theirs"]
  assert (p1, n1) == (p2, n2)
  np.testing.assert_array_equal(v1, v2)
  assert (ours.search_step, ours.p_percentile_min, ours.p_percentile_max) == (
      theirs.search_step, theirs.p_percentile_min, theirs.p_percentile_max)


@pytest.mark.parametrize("proxy", list(AutoTuneProxy), ids=lambda p: p.name)
def test_ratio_from_proxy_matches_jax(proxy):
  ours = autotune.AutoTune(proxy=proxy)
  theirs = j_autotune.AutoTune(proxy=j_types.AutoTuneProxy[proxy.name])
  for p, delta in ((0.785, 3.25), (np.float64(0.4), 1e-3)):
    assert ours.ratio_from_proxy(p, delta) == theirs.ratio_from_proxy(p, delta)
  # A zero eigengap gives inf, as numpy division does (not an exception).
  with np.errstate(divide="ignore"):
    assert ours.ratio_from_proxy(0.785, 0.0) == np.inf
  with pytest.raises(TypeError, match="AutoTuneProxy"):
    autotune.AutoTune(proxy="PercentileOverNME")


def test_autotune_empty_range_raises():
  at = autotune.AutoTune(p_percentile_min=0.5, p_percentile_max=0.5)
  with pytest.raises(ValueError, match="range is empty"):
    at.tune(lambda p: (0.0, np.zeros(1), 1))


@pytest.mark.parametrize("kwargs", [
    {}, dict(p_percentile_min=0.40, p_percentile_max=0.95,
             init_search_step=0.05)])
def test_autotune_static_matches_jax(kwargs):
  ours = pipeline.AutoTuneStatic(**kwargs)
  theirs = j_pipeline.AutoTuneStatic(**kwargs)
  np.testing.assert_array_equal(ours.candidates(), theirs.candidates())
  assert ours.proxy.name == theirs.proxy.name
  assert convert.convert_value(theirs) == ours
  with pytest.raises(ValueError, match="search_level=1 only"):
    pipeline.AutoTuneStatic(search_level=2, **kwargs)
  with pytest.raises(ValueError, match="search_level=1 only"):
    j_pipeline.AutoTuneStatic(search_level=2, **kwargs)
