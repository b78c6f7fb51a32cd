"""The icassp2018 preset's Auto route past ``dc_max_block`` on the CPU.

The staged executor's top-k route (``ops/dc.py``, stage "staged_dc") on a
turn-structured recording of the benchmark's long traffic at a CPU size,
held against the benchmark's plain float64 reference
(``portbench/reference/icassp2018.py``) through the comparison that
decides a run's ``correct`` (``portbench/compare.py``), with the limits of
the ``icassp2018.long`` cell; and the completeness certificate that sends
an answer the route cannot vouch for to the full eigh.
"""

import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

from portbench import compare, generator
from portbench.reference import icassp2018 as reference
from spectralcluster_tpu_torch import configs, pipeline
from spectralcluster_tpu_torch.observability import StageTimings
from spectralcluster_tpu_torch.ops import dc
from spectralcluster_tpu_torch.ops import eigen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts):
  with open(os.path.join(ROOT, *parts)) as f:
    return json.load(f)


def _cfg():
  return configs.make_icassp2018_clusterer(device="cpu")._config().replace(
      dc_max_block=128)


_ROUTE_COUNTERS = ("dc_certified", "dc_subspace_iters", "dc_lanczos",
                   "dc_lanczos_steps", "dc_resolved", "dc_full_eigh")


def _lanczos_declines(*a, **kw):
  """``dc.lanczos_topt`` handing back pairs it cannot vouch for."""
  return None, None, math.inf, None


@pytest.mark.parametrize("route", ["lanczos", "certified", "split"])
def test_staged_dc_matches_the_float64_reference(monkeypatch, route):
  config = _json("portbench", "configs", "icassp2018_auto.json")
  traffic = _json("portbench", "traffic", "long.json")
  limits = _json("portbench", "limits", "icassp2018.long.json")["limits"]
  # 320 segments of six speakers. The scan descends, so Lanczos answers
  # first; where it declines, the certified attempt (after 1,088
  # iterations), or with the iterative routes off the forced split.
  rec = generator.make_recording(generator.rng_for(2, 1, 6), 0, 320, 6,
                                 traffic)
  if route != "lanczos":
    monkeypatch.setattr(dc, "lanczos_topt", _lanczos_declines)
  monkeypatch.setattr(dc, "_TRY_ITERATIVE_FIRST", route != "split")
  infos, solve = [], dc.eigh_topk_dc

  def recording(*a, **kw):
    infos.append({})
    return solve(*a, info=infos[-1], **kw)

  monkeypatch.setattr(dc, "eigh_topk_dc", recording)
  timings = StageTimings("cpu")
  labels, n_clusters, w, _ = pipeline.spectral_cluster_fixed_k_staged(
      torch.as_tensor(rec.embeddings), torch.Generator().manual_seed(0),
      _cfg(), timings=timings)
  counters = timings.counters()
  assert set(_ROUTE_COUNTERS) <= set(counters)
  assert [i["route"] for i in infos] == ([] if route == "lanczos"
                                         else [route])
  assert counters["dc_lanczos"] == int(route == "lanczos")
  assert (counters["dc_lanczos_steps"] > 0) == (route == "lanczos")
  assert counters["dc_certified"] == int(route == "certified")
  assert counters["dc_subspace_iters"] == (
      dc.subspace_iterations(infos[0]) if infos else 0)
  assert counters["dc_subspace_iters"] == (1088 if route == "certified"
                                           else 0)
  assert counters["dc_resolved"] == int(route != "lanczos")
  assert counters["dc_full_eigh"] == 0
  spans = timings.as_dict()
  assert "dc_lanczos" in spans
  assert "dc_" + route in spans
  assert ("dc_resolve" in spans) == bool(infos)
  got = compare.call_numbers(
      {"labels": labels.numpy(), "n_clusters": int(n_clusters),
       "eigenvalues": w.numpy()},
      reference.solve(rec, config, "float64", "cpu"))
  assert got["n_clusters_diff"] <= limits["n_clusters_diff"]
  assert got["label_error"] <= limits["label_error"]
  assert got["eig_err"] <= limits["eig_err_max"]


def _spectrum(values, n=64, seed=0):
  """A symmetric float32 matrix with the given eigenvalues and a random
  orthonormal basis (columns in the order of ``values``)."""
  q, _ = np.linalg.qr(np.random.RandomState(seed).randn(n, n))
  m = (q * np.asarray(values)) @ q.T
  return (torch.as_tensor(m.astype(np.float32)),
          torch.as_tensor(q.astype(np.float32)))


@pytest.mark.parametrize("descend", [True, False])
def test_completeness_certificate(descend):
  sign = 1.0 if descend else -1.0
  top = [50.0, 40.0, 3.0, 1.0]
  rest = list(np.linspace(-0.01, 0.01, 59))
  m, q = _spectrum([sign * v for v in top + [0.5] + rest])
  w = torch.tensor([sign * v for v in top])
  # The four extreme pairs: complete.
  assert dc.complete_beyond(m, w, q[:, :4], 1e-3, descend)
  # Pairs 0, 1, 2 and a cluster pair in place of pair 3: the 1.0 and the
  # 0.5 are missed.
  v = torch.cat([q[:, :3], q[:, 10:11]], dim=1)
  w_missed = torch.tensor([sign * v for v in (50.0, 40.0, 3.0, 0.005)])
  assert not dc.complete_beyond(m, w_missed, v, 1e-3, descend)
  # A missed value inside the uncertainty band reads as complete.
  assert dc.complete_beyond(m, w_missed, v, 1.1, descend)


def test_completeness_certificate_at_the_snap():
  # Values that the scan snaps to 0 need not be told apart: a missed 0.02
  # under a snap of 0.05 does not change the snapped spectrum.
  m, q = _spectrum([50.0, 40.0, 0.02] + list(np.linspace(-1e-3, 1e-3, 61)))
  v = torch.cat([q[:, :2], q[:, 20:21]], dim=1)
  w = torch.tensor([50.0, 40.0, float(np.linspace(-1e-3, 1e-3, 61)[17])])
  assert not dc.complete_beyond(m, w, v, 1e-3, True)
  assert dc.complete_beyond(m, w, v, 1e-3, True, snap=0.05)
  assert not dc.complete_beyond(m, w, v, 1e-3, True, snap=0.01)


@pytest.mark.parametrize("second_answers", [True, False])
def test_an_incomplete_answer_is_re_solved(monkeypatch, second_answers):
  # The first solve (Lanczos, on this descending scan) hands back a
  # cluster pair in place of the fourth largest, with a small residual:
  # the staged executor re-solves (span "dc_resolve", counter
  # "dc_resolved") by eigh_topk_dc (here its dense branch), or, where that
  # too misses a pair, by the full eigh (counter "dc_full_eigh"), and
  # returns their t extreme pairs.
  m, q = _spectrum([50.0, 40.0, 3.0, 1.0, 0.5]
                   + list(np.linspace(-0.01, 0.01, 59)))
  t = 8

  def incomplete(*_a, **_k):
    w = torch.tensor([50.0, 40.0, 3.0] + [0.005] * (t - 3))
    return w, torch.cat([q[:, :3], q[:, 10:10 + t - 3]], dim=1), 1e-6, 50.0

  monkeypatch.setattr(dc, "lanczos_topt", incomplete)
  if not second_answers:
    monkeypatch.setattr(dc, "eigh_topk_dc", incomplete)
  full, vectors = torch.linalg.eigh(m)
  timings = StageTimings("cpu")
  with warnings.catch_warnings():
    warnings.simplefilter("error")
    w, u, wscale = pipeline._dc_topk(m, _cfg(), None, True, timings)
  np.testing.assert_allclose(w.numpy(), full.flip(0)[:t].numpy(), atol=1e-5)
  # The isolated pairs' vectors (those of the cluster are not unique).
  np.testing.assert_allclose(np.abs(u[:, :5].numpy()),
                             np.abs(vectors.flip(1)[:, :5].numpy()),
                             atol=1e-4)
  assert float(wscale) == pytest.approx(50.0)
  assert "dc_resolve" in timings.as_dict()
  counters = timings.counters()
  assert counters["dc_resolved"] == 1
  assert counters["dc_lanczos"] == 0
  assert counters["dc_full_eigh"] == int(not second_answers)


# Eight isolated values over a cluster at 0: every solve of the route can
# answer. dc_max_block=32 puts n=64 past the dense branch.
_ISOLATED = [50.0, 40.0, 30.0, 20.0, 10.0, 8.0, 6.0, 4.0] + list(
    np.linspace(-0.01, 0.01, 56))


@pytest.mark.parametrize("case", ["lanczos", "lanczos_declines",
                                  "ascending"])
def test_the_route_answers_by_its_first_sound_solve(monkeypatch, case):
  # A descending scan asks Lanczos first and the certified attempt only
  # where Lanczos cannot vouch; an ascending one keeps the certified
  # attempt first and does not run Lanczos when it answers.
  descend = case != "ascending"
  sign = 1.0 if descend else -1.0
  m, _ = _spectrum([sign * v for v in _ISOLATED])
  lanczos = dc.lanczos_topt
  runs = []

  def spy(*a, **kw):
    runs.append(case)
    w, u, res, scale = lanczos(*a, **kw)
    return w, u, math.inf if case == "lanczos_declines" else res, scale

  monkeypatch.setattr(dc, "lanczos_topt", spy)
  timings = StageTimings("cpu")
  with warnings.catch_warnings():
    warnings.simplefilter("error")
    w, _, _ = pipeline._dc_topk(m, _cfg().replace(dc_max_block=32), None,
                                descend, timings)
  want = np.sort(sign * np.asarray(_ISOLATED))
  want = want[::-1] if descend else want
  # Within the certificate's bound: the accepted residual times the scale.
  np.testing.assert_allclose(w.numpy(), want[:8],
                             atol=dc._ITER_ACCEPT_RES * 50.0)
  counters = timings.counters()
  assert set(_ROUTE_COUNTERS) <= set(counters)
  assert counters["dc_full_eigh"] == 0
  assert len(runs) == int(descend)
  if case == "lanczos":
    assert counters["dc_lanczos"] == 1 and counters["dc_lanczos_steps"] > 0
    assert counters["dc_certified"] == counters["dc_subspace_iters"] == 0
    assert counters["dc_resolved"] == 0
    assert set(timings.as_dict()) == {"dc_lanczos"}
  else:
    assert counters["dc_lanczos"] == 0
    assert counters["dc_certified"] == 1
    assert counters["dc_subspace_iters"] > 0
    assert counters["dc_resolved"] == int(descend)
    assert ("dc_lanczos" in timings.as_dict()) == descend


@pytest.mark.parametrize("descend", [True, False])
@pytest.mark.parametrize("n_valid", [None, 50])
def test_lanczos_finds_the_extreme_pairs(descend, n_valid):
  # A decaying tail under two large values, as on the long recordings:
  # the t extreme pairs in scan order, residuals at Lanczos's tolerance.
  sign = 1.0 if descend else -1.0
  values = [sign * v for v in [900.0, 700.0, 30.0] + list(
      np.geomspace(2.0, 1e-4, 61))]
  m, _ = _spectrum(values)
  want = np.sort(np.asarray(values, np.float64))
  if n_valid is not None:
    m, _ = _spectrum(values[:n_valid], n=n_valid)
    want = np.sort(np.asarray(values[:n_valid], np.float64))
    m = eigen.apply_padding_sentinels(
        torch.nn.functional.pad(m, (0, 64 - n_valid, 0, 64 - n_valid)),
        n_valid, descend)
  want = want[::-1] if descend else want
  w, u, res, scale = dc.lanczos_topt(m, 8, torch.Generator().manual_seed(0),
                                     descend, n_valid)
  np.testing.assert_allclose(w.numpy(), want[:8], rtol=1e-5, atol=1e-3)
  assert res <= dc._LANCZOS_TOL
  assert scale == pytest.approx(900.0, rel=1e-5)
  r = torch.linalg.norm(m @ u - u * w[None, :], dim=0)
  assert float(r.max()) <= 1e-3

