"""CPU tests of the readers of the program's spans and counters
(``portbench/metrics/refine_ms.py`` ... ``edge_ms.py``).

    python -m pytest portbench/tests -q

Each reader takes the window's calls from the program's in-memory record
(``spectralcluster_tpu_torch.observability.recorded_calls``): the last
``len(ctx["calls"])`` calls. Here the record holds synthetic calls, then a
traced CPU run fills it.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from spectralcluster_tpu_torch import observability  # noqa: E402
from spectralcluster_tpu_torch.observability import (Call,  # noqa: E402
                                                     CallRecord, Span)

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NEW = ("refine_ms", "eigh_ms", "kmeans_ms", "lloyd_rounds", "edge_ms")


def _call(refine, eigh, kmeans, rounds, upload, download):
  """A recorded monolithic call: device seconds the given values, host
  seconds ten times them (so the two clocks cannot be mixed up)."""
  def span(name, parent, sec):
    return Span(name, parent, 10 * sec, sec)
  spans = (span("predict", None, 1.0),
           span("upload", "pipeline", upload),
           span("refine", "pipeline", refine),
           span("eigh", "pipeline", eigh),
           span("kmeans", "pipeline", kmeans),
           span("download", "pipeline", download),
           span("pipeline", "predict", 0.9))
  return Call(spans, {"lloyd_rounds": rounds})


@pytest.fixture
def record(monkeypatch):
  rec = CallRecord()
  monkeypatch.setattr(observability, "RECORD", rec)
  return rec


def _read(name, ctx):
  return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def test_readers_take_the_windows_calls(record):
  # A warm-up call before the window, then the window's two calls.
  record.append(_call(9.0, 9.0, 9.0, 999, 9.0, 9.0))
  record.append(_call(0.002, 0.010, 0.006, 16, 0.001, 0.0005))
  record.append(_call(0.004, 0.012, 0.008, 32, 0.003, 0.0015))
  ctx = {"calls": [{}, {}]}
  assert _read("refine_ms", ctx) == pytest.approx(3.0)
  assert _read("eigh_ms", ctx) == pytest.approx(11.0)
  assert _read("kmeans_ms", ctx) == pytest.approx(7.0)
  assert _read("lloyd_rounds", ctx) == pytest.approx(24.0)
  # Host ms of upload + download: 10 × (1.5 ms, 4.5 ms) averaged.
  assert _read("edge_ms", ctx) == pytest.approx(30.0)
  for name in NEW:
    assert isinstance(_read(name, ctx), float)


def test_readers_read_nothing_where_nothing_was_recorded(record,
                                                         monkeypatch):
  ctx = {"calls": [{}, {}]}
  # Calls without the spans (the staged executor has no "refine"; a
  # program off the card has no device seconds).
  record.append(Call((Span("predict", None, 1.0, None),
                      Span("refine", "pipeline", 0.5, None)), {}))
  record.append(Call((Span("predict", None, 1.0, None),), {}))
  for name in ("refine_ms", "eigh_ms", "kmeans_ms", "lloyd_rounds"):
    assert _read(name, ctx) is None
  assert _read("edge_ms", {"calls": []}) is None
  # A program that keeps no record (an older checkout) reads nothing and
  # does not raise.
  monkeypatch.delattr(observability, "recorded_calls")
  for name in NEW:
    assert _read(name, ctx) is None


def test_the_new_metrics_are_declared():
  by_name = {m["name"]: m for m in BENCH["per_layer"]}
  for name in NEW + ("edge_ms.long",):
    m = by_name[name]
    assert m["source"] in ("program_span", "program_counter")
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                       run.quantity(m) + ".py"))
  assert by_name["edge_ms.long"]["workloads"] == ["icassp2018_eigh.long"]


@pytest.fixture
def tiny(monkeypatch):
  orig = run.cell

  def small(workload):
    bench, wl, config, traffic, limits = orig(workload)
    traffic = dict(traffic, pool=2, sizes={"kind": "uniform", "lo": 200,
                                           "hi": 300})
    return bench, wl, config, traffic, limits

  monkeypatch.setattr(run, "cell", small)


@pytest.mark.parametrize("workload,edge", [
    ("icassp2018.calls", "edge_ms"),
    ("icassp2018_eigh.long", "edge_ms.long")])
def test_a_traced_cpu_run_reads_the_record(tiny, record, workload, edge):
  result = run.execute(workload, 4242424242, 0.2, True, "cpu")
  assert result["correct"]
  calls = observability.recorded_calls(result["attempted"])
  assert len(calls) == result["attempted"]
  host_ms = [1e3 * sum(s.host_s for s in c.spans
                       if s.name in ("upload", "download")) for c in calls]
  assert result["metrics"][edge]["value"] == pytest.approx(
      sum(host_ms) / len(host_ms))
  if workload == "icassp2018.calls":
    rounds = [c.counters["lloyd_rounds"] for c in calls]
    assert result["metrics"]["lloyd_rounds"]["value"] == pytest.approx(
        sum(rounds) / len(rounds))
    # Off the card no span has device seconds: no device-ms reading.
    for name in ("refine_ms", "eigh_ms", "kmeans_ms"):
      assert name not in result["metrics"]
