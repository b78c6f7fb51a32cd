"""CPU tests of the readers of the top-k route's Lanczos solve
(``portbench/metrics/dc_lanczos_share.py``, ``dc_lanczos_steps.py``,
``dc_lanczos_ms.py``).

    python -m pytest portbench/tests -q

The readers take the window's calls from the program's in-memory record
(``spectralcluster_tpu_torch.observability.recorded_calls``); here it holds
synthetic calls, then a traced CPU run of ``icassp2018.long`` at a CPU
size (``test_dc_metrics.py``'s ``tiny``), whose descending scans Lanczos
answers first.
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
from portbench.tests.test_dc_metrics import record, tiny  # noqa: E402,F401
from spectralcluster_tpu_torch import observability  # noqa: E402
from spectralcluster_tpu_torch.observability import Call, Span  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NEW = ("dc_lanczos_share", "dc_lanczos_steps", "dc_lanczos_ms")


def _call(lanczos_s, steps, kept, device=True):
  """A recorded staged call that ran the route: its Lanczos solve took
  ``lanczos_s`` device seconds (None: it did not run)."""
  def span(name, parent, sec):
    return Span(name, parent, 10 * sec, sec if device else None)
  spans = [span("predict", None, 5.0)]
  if lanczos_s is not None:
    spans.append(span("dc_lanczos", "staged_dc", lanczos_s))
  spans.append(span("staged_dc", "pipeline", 4.0))
  return Call(tuple(spans), {
      "dc_certified": int(not kept), "dc_subspace_iters": 0 if kept else 64,
      "dc_lanczos": int(kept), "dc_lanczos_steps": steps,
      "dc_resolved": int(not kept)})


def _read(name, ctx):
  return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def test_readers_take_the_windows_calls(record):
  record.append(_call(9.0, 1280, 0))   # before the window
  record.append(_call(0.1, 160, 1))
  record.append(_call(0.3, 320, 0))
  record.append(_call(None, 0, 0))     # an ascending scan's certified answer
  ctx = {"calls": [{}] * 3}
  assert _read("dc_lanczos_share", ctx) == pytest.approx(1 / 3)
  assert _read("dc_lanczos_steps", ctx) == pytest.approx(160.0)
  # Device ms per call that ran the route, 0 where Lanczos did not run.
  assert _read("dc_lanczos_ms", ctx) == pytest.approx(400.0 / 3)


def test_readers_read_nothing_where_nothing_was_recorded(record,
                                                         monkeypatch):
  ctx = {"calls": [{}] * 2}
  # A parent's route calls: its counters and spans, none of Lanczos's.
  for _ in range(2):
    record.append(Call((Span("predict", None, 1.0, 0.5),
                        Span("dc_certified", "staged_dc", 0.5, 0.4)),
                       {"dc_certified": 1, "dc_subspace_iters": 1024,
                        "dc_resolved": 0}))
  for name in NEW:
    assert _read(name, ctx) is None
  # Off the card the span has no device seconds.
  record.append(_call(0.5, 160, 1, device=False))
  record.append(_call(0.5, 160, 1, device=False))
  assert _read("dc_lanczos_ms", ctx) is None
  assert _read("dc_lanczos_share", ctx) == pytest.approx(1.0)
  monkeypatch.delattr(observability, "recorded_calls")
  for name in NEW:
    assert _read(name, ctx) is None


def test_the_new_metrics_are_declared():
  by_name = {m["name"]: m for m in BENCH["per_layer"]}
  for name in NEW:
    m = by_name[name]
    assert m["workloads"] == ["icassp2018.long"]
    assert m["moves"] == "segments_per_s"
    assert m["layer"] == by_name["dc_certified_share"]["layer"]
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                       name + ".py"))


def test_a_traced_cpu_run_reads_lanczos(tiny, record):
  result = run.execute("icassp2018.long", 4242424243, 0.2, True, "cpu")
  assert result["correct"], result["checks"]
  calls = observability.recorded_calls(result["attempted"])
  assert all("dc_lanczos" in c.counters for c in calls)
  for name, counter in (("dc_lanczos_share", "dc_lanczos"),
                        ("dc_lanczos_steps", "dc_lanczos_steps")):
    values = [c.counters[counter] for c in calls]
    assert result["metrics"][name]["value"] == pytest.approx(
        sum(values) / len(values))
  assert result["metrics"]["dc_lanczos_share"]["value"] > 0
  # Off the card: no device-ms reading.
  assert "dc_lanczos_ms" not in result["metrics"]
