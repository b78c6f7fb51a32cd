"""The port's span recorder (``observability.StageTimings``) on the CPU.

Both executors with ``staged_stage_timings`` on and off: the exact stage
and span keys, the ``lloyd_rounds`` counter against the rounds Lloyd ran,
the ``sct.*`` profiler ranges under ``sct.predict``, the bounded
in-memory record of the last calls, the top-k route's spans and counters
(``dc_*``) with kernel 6's shape sums, and that no span waits for the card
(``torch.cuda.synchronize`` patched to raise). The CUDA event path is
driven here by a fake event; ``tests/test_torch_gpu.py`` runs it on a card.
"""

import math

import numpy as np
import pytest
import torch

from spectralcluster_tpu_torch import configs, observability
from spectralcluster_tpu_torch.constraint import ConstraintMatrix
from spectralcluster_tpu_torch.fixtures import (make_embeddings,
                                                make_t2d_fixture)
from spectralcluster_tpu_torch.observability import Call, CallRecord, Span
from spectralcluster_tpu_torch.ops import affinity as affinity_ops
from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops

torch.set_num_threads(1)

N = 300
MONOLITHIC = {"pipeline", "upload", "refine", "eigh", "kmeans", "download"}
STAGED = {"pipeline", "upload", "staged_prep", "staged_eigh",
          "staged_finish", "kmeans", "download"}


@pytest.fixture
def record(monkeypatch):
  """A fresh in-memory record, and torch.cuda.synchronize forbidden."""
  rec = CallRecord()
  monkeypatch.setattr(observability, "RECORD", rec)

  def no_sync(*_a, **_k):
    raise AssertionError("a span synchronized the card")

  monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
  return rec


def _clusterer(staged: bool, detail: bool, **kw):
  return configs.make_icassp2018_clusterer(
      device="cpu", staged_execution_min_n=256 if staged else None,
      staged_stage_timings=detail, **kw)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("detail", [False, True])
def test_predict_records_the_exact_spans(record, staged, detail):
  result = _clusterer(staged, detail).predict_with_details(
      make_embeddings(N, d=32))
  assert result.n_clusters == 2
  if not detail:
    # Off: what predict recorded before spans, and nothing else.
    assert set(result.timings) == {"pipeline"}
    assert result.counters == {} and len(record) == 0
    return
  assert set(result.timings) == (STAGED if staged else MONOLITHIC)
  assert set(result.counters) == {"lloyd_rounds", "kmeans_kernel"}
  (call,) = record.last()
  root, *spans = call.spans
  assert root.name == "predict" and root.parent is None
  assert call.counters == result.counters
  parents = {s.name: s.parent for s in spans}
  assert parents["pipeline"] == "predict"
  assert parents["kmeans"] == ("staged_finish" if staged else "pipeline")
  for name in result.timings:
    if name not in ("pipeline", "kmeans"):
      assert parents[name] == "pipeline"
  # Off the card a span's duration is its host seconds.
  for s in spans:
    assert s.device_s is None and result.timings[s.name] == s.host_s
  assert root.host_s >= sum(s.host_s for s in spans
                            if s.parent == "predict")


@pytest.mark.parametrize("staged", [False, True])
def test_lloyd_rounds_counts_the_rounds_lloyd_ran(record, monkeypatch,
                                                  staged):
  ran = []
  lloyd = kmeans_ops._lloyd

  def watched(x, centroids, n_clusters, dist_fn, *a, **kw):
    calls = [0]

    def counted(p, c):
      calls[0] += 1
      return dist_fn(p, c)

    out = lloyd(x, centroids, n_clusters, counted, *a, **kw)
    ran.append((calls[0], int(out[2])))
    return out

  monkeypatch.setattr(kmeans_ops, "_lloyd", watched)
  result = _clusterer(staged, True).predict_with_details(
      make_embeddings(N, d=32))
  ((rounds, it),) = ran
  # Every round assigns once; the host runs the stopping round up to its
  # next read of the flags. On the CPU K-Means runs eagerly, not as the
  # card's kernel.
  assert result.counters == {"lloyd_rounds": rounds, "kmeans_kernel": 0}
  assert rounds == min(kmeans_ops.STOP_CHECK_ROUNDS * math.ceil(
      it / kmeans_ops.STOP_CHECK_ROUNDS), 300 + 1)


@pytest.mark.parametrize("max_iter", [3, 40, 300])
def test_lloyd_counter_against_the_returned_rounds(max_iter):
  gen = torch.Generator().manual_seed(5)
  x = torch.randn(200, 4, generator=gen)
  c0 = x[:4].clone()
  timings = observability.StageTimings("cpu")
  calls = [0]
  cosine = affinity_ops.get_distance_fn("cosine")

  def counted(p, c):
    calls[0] += 1
    return cosine(p, c)

  _, _, it = kmeans_ops._lloyd(x, c0, 4, counted, max_iter, 0.001,
                               torch.ones(200), timings=timings)
  assert timings.counters() == {"lloyd_rounds": calls[0]}
  assert calls[0] == min(kmeans_ops.STOP_CHECK_ROUNDS * math.ceil(
      int(it) / kmeans_ops.STOP_CHECK_ROUNDS), max_iter + 1)
  # standard_lloyd counts its host rounds too.
  plain = observability.StageTimings("cpu")
  kmeans_ops.standard_lloyd(x, c0, 4, max_iter=max_iter, timings=plain)
  assert 1 <= plain.counters()["lloyd_rounds"] <= max_iter


@pytest.mark.parametrize("staged", [False, True])
def test_sct_ranges_nest_under_sct_predict(record, staged):
  x = make_embeddings(N, d=32)
  activities = [torch.profiler.ProfilerActivity.CPU]
  with torch.profiler.profile(activities=activities) as prof:
    result = _clusterer(staged, True).predict_with_details(x)
    _clusterer(staged, False).predict_with_details(x)
  ranges = [e for e in prof.events() if e.name.startswith("sct.")]
  # One call's ranges: the knob-off call enters none.
  assert sorted(e.name for e in ranges) == sorted(
      ["sct.predict"] + [f"sct.{k}" for k in result.timings])
  for e in ranges:
    chain, p = [], e.cpu_parent
    while p is not None:
      chain.append(p.name)
      p = p.cpu_parent
    assert (e.name == "sct.predict") == ("sct.predict" not in chain)
    want = {"sct.kmeans": "sct.staged_finish" if staged else "sct.pipeline",
            "sct.pipeline": "sct.predict", "sct.predict": None}
    inner = next((n for n in chain if n.startswith("sct.")), None)
    assert inner == want.get(e.name, "sct.pipeline"), (e.name, chain)


def test_record_is_bounded_and_keeps_the_last_calls(monkeypatch):
  rec = CallRecord(3)
  monkeypatch.setattr(observability, "RECORD", rec)
  x = make_embeddings(N, d=32)
  order = [False, True, False, True, False]   # monolithic, staged, ...
  for staged in order:
    _clusterer(staged, True).predict(x)
  assert len(rec) == 3
  staged_seen = [any(s.name == "staged_prep" for s in c.spans)
                 for c in observability.recorded_calls()]
  assert staged_seen == order[-3:]
  assert observability.recorded_calls(2) == rec.last(2) == rec.last()[1:]
  assert observability.recorded_calls(10) == rec.last()
  # Synthetic calls: oldest first, the oldest dropped.
  small = CallRecord(2)
  for i in range(4):
    small.append(Call((Span("predict", None, float(i), None),), {}))
  assert [c.spans[0].host_s for c in small.last()] == [2.0, 3.0]
  assert [c.spans[0].host_s for c in small.last(1)] == [3.0]


def test_a_failed_call_is_recorded(record):
  clusterer = _clusterer(False, True, max_spectral_size=100)
  x = make_embeddings(N, d=32)
  with pytest.raises(RuntimeError, match="constraint_matrix"):
    clusterer.predict(x, np.eye(N))
  (call,) = record.last()
  assert [s.name for s in call.spans] == ["predict"]


@pytest.mark.parametrize("detail", [False, True])
def test_ahc_reduction_prefixes_the_inner_run(record, detail):
  clusterer = _clusterer(False, detail, max_spectral_size=100)
  result = clusterer.predict_with_details(make_embeddings(N, d=32))
  inner = {"pipeline"} | (MONOLITHIC if detail else set())
  assert set(result.timings) == {f"inner_{k}" for k in inner} | {
      "ahc_reduce"}
  assert set(result.counters) == (
      {"inner_lloyd_rounds", "inner_kmeans_kernel"} if detail else set())
  assert len(record) == int(detail)
  if detail:
    parents = {s.name: s.parent for s in record.last()[0].spans}
    assert parents["inner_pipeline"] == "ahc_reduce"


@pytest.mark.parametrize("detail", [False, True])
def test_host_flow_stages(record, detail):
  x, scores, _ = make_t2d_fixture(256)
  cm = ConstraintMatrix(scores, threshold=1).compute_diagonals()
  result = configs.make_turntodiarize_clusterer(
      device="cpu", staged_stage_timings=detail).predict_with_details(x, cm)
  host = {"affinity", "constraint", "eig", "kmeans"}
  assert set(result.timings) == host | ({"refine", "eigh"} if detail
                                        else set())
  assert result.counters == {}
  assert len(record) == int(detail)


class _FakeEvent:
  """A CUDA event on the host: records the host clock; elapsed_time reads
  a fixed 250 ms per pair, so device seconds are told from host ones."""
  made = 0

  def __init__(self, enable_timing=False):
    assert enable_timing
    _FakeEvent.made += 1
    self.recorded = False
    self.waited = False

  def record(self, stream=None):
    self.recorded = True

  def synchronize(self):
    self.waited = True

  def elapsed_time(self, end):
    assert self.recorded and end.recorded and end.waited
    return 250.0


def test_a_device_count_is_read_with_the_counters(record):
  # A count given as a tensor (a round count still on the card) is read
  # when the call's counters are, once, and not where it was counted.
  timings = observability.StageTimings("cpu")
  rounds = torch.tensor(4, dtype=torch.int32)
  with timings.call():
    timings.count("lloyd_rounds", rounds)
    timings.count("lloyd_rounds", 1)
    rounds += 2
  (call,) = record.last()
  assert call.counters == {"lloyd_rounds": 7}
  rounds += 10
  assert timings.counters() == {"lloyd_rounds": 7}
  off = observability.StageTimings("cpu", detail=False)
  off.count("lloyd_rounds", rounds)
  assert off.counters() == {}


def test_cuda_spans_are_event_pairs_read_once(record, monkeypatch):
  monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
  monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
  _FakeEvent.made = 0
  off = observability.StageTimings("cuda", detail=False)
  with off.call():
    with off.stage("pipeline"):
      with off.span("upload"):
        pass
      off.count("lloyd_rounds", 3)
  # Off: the stage's two events and nothing new.
  assert _FakeEvent.made == 2
  assert off.as_dict() == {"pipeline": 0.25} and off.counters() == {}
  assert len(record) == 0

  _FakeEvent.made = 0
  on = observability.StageTimings("cuda", detail=True)
  with on.call():
    with on.stage("pipeline"):
      with on.span("upload"):
        pass
      with on.span("upload"):
        pass
      on.count("lloyd_rounds", 3)
      on.count("lloyd_rounds", 2)
  assert _FakeEvent.made == 8
  assert on.as_dict() == {"upload": 0.5, "pipeline": 0.25}
  assert on.counters() == {"lloyd_rounds": 5}
  (call,) = record.last()
  assert [(s.name, s.parent, s.device_s) for s in call.spans] == [
      ("predict", None, 0.25), ("upload", "pipeline", 0.25),
      ("upload", "pipeline", 0.25), ("pipeline", "predict", 0.25)]
  assert all(s.host_s < 0.25 for s in call.spans)


# The top-k route inside the staged executor: a recording of portbench's
# long traffic at a CPU size, dc_max_block lowered so that the route runs.
# Lanczos answers first on this descending scan, in its first cap's 160
# steps; where it declines, the certified attempt, after 1,088 iterations;
# with the iterative routes off as well, the split.
LANCZOS_STEPS = 160


def _route_call(monkeypatch, route, detail=True):
  from portbench import generator
  from spectralcluster_tpu_torch import pipeline
  from spectralcluster_tpu_torch.ops import dc
  traffic = {"turn_mean": 12, "share_alpha": 1.0, "d": 256,
             "centre_scale": 3.0, "noise": 0.4}
  rec = generator.make_recording(generator.rng_for(2, 1, 6), 0, 320, 6,
                                 traffic)
  if route != "lanczos":
    monkeypatch.setattr(dc, "lanczos_topt",
                        lambda *a, **kw: (None, None, math.inf, None))
  monkeypatch.setattr(dc, "_TRY_ITERATIVE_FIRST", route != "split")
  infos, solve = [], dc.eigh_topk_dc

  def recording(*a, **kw):
    infos.append({})
    return solve(*a, info=infos[-1], **kw)

  monkeypatch.setattr(dc, "eigh_topk_dc", recording)
  cfg = configs.make_icassp2018_clusterer(device="cpu")._config().replace(
      dc_max_block=128)
  timings = observability.StageTimings("cpu", detail=detail)
  pipeline.spectral_cluster_fixed_k_staged(
      torch.as_tensor(rec.embeddings), torch.Generator().manual_seed(0), cfg,
      timings=timings)
  return timings, infos


@pytest.mark.parametrize("route", ["lanczos", "certified", "split"])
def test_the_dc_route_records_its_spans_and_counters(monkeypatch, route):
  from spectralcluster_tpu_torch.ops import dc
  timings, infos = _route_call(monkeypatch, route)
  assert [i["route"] for i in infos] == ([] if route == "lanczos"
                                         else [route])
  span = "dc_" + route
  # Lanczos's span wraps the first solve, whether it answers or declines;
  # "dc_resolve" every solve after it.
  resolved = {"dc_resolve", span} if infos else set()
  assert set(timings.as_dict()) == {"staged_prep", "staged_dc", "dc_lanczos",
                                    "staged_finish", "kmeans", *resolved}
  parents = {s.name: s.parent for s in timings.spans()}
  assert parents["dc_lanczos"] == "staged_dc"
  if infos:
    assert parents["dc_resolve"] == "staged_dc"
    assert parents[span] == "dc_resolve"
  counters = timings.counters()
  assert counters["dc_lanczos"] == int(route == "lanczos")
  assert counters["dc_lanczos_steps"] == (LANCZOS_STEPS if route == "lanczos"
                                          else 0)
  assert counters["dc_certified"] == int(route == "certified")
  assert counters["dc_subspace_iters"] == (
      dc.subspace_iterations(infos[0]) if infos else 0)
  assert counters["dc_subspace_iters"] == (1088 if route == "certified"
                                           else 0)
  assert counters["dc_resolved"] == int(route != "lanczos")
  assert counters["dc_full_eigh"] == 0


def test_the_dc_route_records_nothing_without_detail(monkeypatch):
  timings, _ = _route_call(monkeypatch, "split", detail=False)
  assert set(timings.as_dict()) == {"staged_prep", "staged_dc",
                                    "staged_finish"}
  assert timings.counters() == {}


@pytest.mark.parametrize("route", ["lanczos", "certified"])
def test_panel_work_counts_the_routes_products(monkeypatch, route):
  # Kernel 6's shape sums against the products its CPU twin made: Lanczos's
  # at one column, or the certified attempt's panels.
  from spectralcluster_tpu_torch.kernels import fused
  shapes, plain = [], fused.panel_matmul_plain

  def twin(mat, x):
    shapes.append((mat.shape[-2], mat.shape[-1], x.shape[-1]))
    return plain(mat, x)

  monkeypatch.setattr(fused, "panel_matmul_plain", twin)
  timings, _ = _route_call(monkeypatch, route)
  counters = timings.counters()
  assert shapes and all(m == n == 320 for m, n, _ in shapes)
  assert counters["panel_matmul_mnb"] == sum(m * n * b for m, n, b in shapes)
  assert counters["panel_matmul_io"] == sum(m * n + n * b + m * b
                                            for m, n, b in shapes)
