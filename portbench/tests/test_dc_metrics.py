"""CPU tests of the readers of the top-k route's metrics
(``portbench/metrics/dc_*.py`` and ``panel_matmul_roofline_pct.py``).

    python -m pytest portbench/tests -q

The readers take the window's calls from the program's in-memory record
(``spectralcluster_tpu_torch.observability.recorded_calls``); here it holds
synthetic calls, then a traced CPU run of ``icassp2018.long`` at a CPU
size, with ``dc_max_block`` lowered so that the route runs, fills it.
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

from portbench import roofline, run  # noqa: E402
from spectralcluster_tpu_torch import observability  # noqa: E402
from spectralcluster_tpu_torch.observability import (Call,  # noqa: E402
                                                     CallRecord, Span)

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NEW = ("dc_certified_share", "dc_iters", "dc_resolved_share", "dc_split_ms",
       "dc_certified_ms", "panel_matmul_roofline_pct")
CARD = "NVIDIA H100 80GB HBM3"


def _call(certified, split, resolved, iters, mnb, io, device=True):
  """A recorded staged call that ran the route: its certified attempt
  took ``certified`` device seconds, its split ``split`` (None: no split)."""
  def span(name, parent, sec):
    return Span(name, parent, 10 * sec, sec if device else None)
  spans = [span("predict", None, 5.0), span("dc_certified", "staged_dc",
                                             certified)]
  if split is not None:
    spans.append(span("dc_split", "staged_dc", split))
  spans.append(span("staged_dc", "pipeline", 4.0))
  return Call(tuple(spans), {
      "dc_certified": int(split is None), "dc_subspace_iters": iters,
      "dc_resolved": resolved, "panel_matmul_mnb": mnb,
      "panel_matmul_io": io})


@pytest.fixture
def record(monkeypatch):
  rec = CallRecord()
  monkeypatch.setattr(observability, "RECORD", rec)
  return rec


def _read(name, ctx):
  return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def _ctx(n, kernel_s):
  return {"calls": [{}] * n, "card": CARD,
          "trace": {"device_s_by_name": {
              "void panel_matmul_kernel<2, true>(float const*)": kernel_s,
              "sytrd": 9.0}}}


def test_readers_take_the_windows_calls(record):
  record.append(_call(9.0, 9.0, 1, 99999, 1, 1))   # before the window
  record.append(_call(0.5, None, 0, 1024, 10**10, 10**9))
  record.append(_call(0.8, 1.2, 1, 3072, 3 * 10**10, 2 * 10**9))
  ctx = _ctx(2, 0.01)
  assert _read("dc_certified_share", ctx) == pytest.approx(0.5)
  assert _read("dc_iters", ctx) == pytest.approx(2048.0)
  assert _read("dc_resolved_share", ctx) == pytest.approx(0.5)
  # Device ms per call that ran the route, 0 where it did not split.
  assert _read("dc_split_ms", ctx) == pytest.approx(600.0)
  assert _read("dc_certified_ms", ctx) == pytest.approx(650.0)
  # Bytes bound in each call: 4 · 3e9 bytes at 3.35 TB/s over 10 ms of
  # kernel 6.
  peaks = roofline.card_peaks(CARD)
  bound = 4 * 3 * 10**9 / peaks["bytes_per_s"]
  assert 2 * 3 * 10**10 / peaks["fp32_flops_per_s"] < 4 * 2 * 10**9 / (
      peaks["bytes_per_s"])
  assert _read("panel_matmul_roofline_pct", ctx) == pytest.approx(
      100 * bound / 0.01)


def test_readers_read_nothing_where_nothing_was_recorded(record,
                                                         monkeypatch):
  ctx = _ctx(2, 0.01)
  # A parent's calls: no route counters.
  record.append(Call((Span("predict", None, 1.0, 0.5),), {}))
  record.append(Call((Span("predict", None, 1.0, 0.5),), {"lloyd_rounds": 3}))
  for name in NEW:
    assert _read(name, ctx) is None
  # Off the card the route's spans have no device seconds.
  record.append(_call(0.5, 0.5, 0, 10, 10, 10, device=False))
  record.append(_call(0.5, None, 0, 10, 10, 10, device=False))
  ctx["trace"]["device_s_by_name"] = {}
  for name in ("dc_split_ms", "dc_certified_ms", "panel_matmul_roofline_pct"):
    assert _read(name, ctx) is None
  assert _read("dc_certified_share", ctx) == pytest.approx(0.5)
  monkeypatch.delattr(observability, "recorded_calls")
  for name in NEW:
    assert _read(name, ctx) is None


def test_the_new_metrics_are_declared():
  by_name = {m["name"]: m for m in BENCH["per_layer"]}
  for name in NEW:
    m = by_name[name]
    assert m["workloads"] == ["icassp2018.long"]
    assert m["moves"] == "segments_per_s"
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                       name + ".py"))
  cells = {w["name"]: w for w in BENCH["workloads"]}
  assert cells["icassp2018.long"]["config"] == "icassp2018_auto"
  end = {m["name"]: m for m in BENCH["end_to_end"]}
  assert "icassp2018.long" in end["segments_per_s"]["workloads"]
  assert "icassp2018.long" not in end["segments_per_s.long"]["workloads"]


@pytest.fixture
def tiny(monkeypatch):
  """The long cell at a CPU size, its recordings on the staged executor's
  top-k route (``dc_max_block`` lowered)."""
  orig = run.cell

  def small(workload):
    bench, wl, config, traffic, limits = orig(workload)
    traffic = dict(traffic, pool=2, sizes={"kind": "uniform", "lo": 300,
                                           "hi": 330})
    return bench, wl, config, traffic, limits

  monkeypatch.setattr(run, "cell", small)
  from spectralcluster_tpu_torch import clusterer, configs
  make, config_of = configs.make_icassp2018_clusterer, (
      clusterer.SpectralClusterer._config)
  monkeypatch.setattr(configs, "make_icassp2018_clusterer",
                      lambda **kw: make(staged_execution_min_n=256, **kw))
  monkeypatch.setattr(clusterer.SpectralClusterer, "_config",
                      lambda self: config_of(self).replace(dc_max_block=128))


def test_a_traced_cpu_run_reads_the_route(tiny, record):
  result = run.execute("icassp2018.long", 4242424242, 0.2, True, "cpu")
  assert result["correct"], result["checks"]
  calls = observability.recorded_calls(result["attempted"])
  assert all("dc_certified" in c.counters for c in calls)
  for name, counter in (("dc_certified_share", "dc_certified"),
                        ("dc_iters", "dc_subspace_iters"),
                        ("dc_resolved_share", "dc_resolved")):
    values = [c.counters[counter] for c in calls]
    assert result["metrics"][name]["value"] == pytest.approx(
        sum(values) / len(values))
  # Off the card: no device-ms reading and no kernel time.
  for name in ("dc_split_ms", "dc_certified_ms", "panel_matmul_roofline_pct"):
    assert name not in result["metrics"]
