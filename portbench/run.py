"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

One process: set-up (the pool of recordings drawn from the seed, the
clusterer, one untimed call on the pool's smallest and on its largest
recording, which builds the kernels on a first run), then a closed loop
with one caller over whole passes of the pool, for ``--seconds`` or up to
one pass more, then the
plain reference on every recording the window used, then one JSON line.
Everything is found by the names in ``BENCHMARK.json``: the workload names
its configuration (``configs/<config>.json``, with its plain reference
``reference/<config>.py``) and its traffic (``traffic/<traffic>.json``),
which names the timed entry (``entries/<entry>.py``); the limits of the
comparison are ``limits/<workload>.json``; each per-layer metric is read by
``metrics/<name>.py``. A metric named ``<name>.<qualifier>`` is the same
quantity as ``<name>``, reported under its own name in the cells it lists
(its own bound, or its own end-to-end metric to move).

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiled window in
which the stage timings are on. Build and kernel caches stay inside the
checkout (``build/``).
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

# pylint: disable=wrong-import-position
import argparse
import contextlib
import gc
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel and build caches at fixed paths inside the checkout, so that only
# a checkout's first run builds.
os.environ["SCT_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "build", "spectralcluster_tpu_torch")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from portbench import compare, generator  # noqa: E402

# Whole top-level module names that no process of a cell may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "spectralcluster_tpu")


def forbidden_modules() -> list:
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


def load_json(*parts) -> dict:
  with open(os.path.join(ROOT, *parts)) as f:
    return json.load(f)


def cell(workload: str):
  """(benchmark, workload entry, configuration, traffic, limits)."""
  bench = load_json("BENCHMARK.json")
  wl = next(w for w in bench["workloads"] if w["name"] == workload)
  cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
  config = load_json(cfg_entry["file"])
  traffic = load_json("portbench", "traffic", wl["traffic"] + ".json")
  limits = load_json("portbench", "limits", workload + ".json")["limits"]
  return bench, wl, config, traffic, limits


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
  """The metric entries this cell reports in this mode."""
  group = bench["per_layer"] if trace else bench["end_to_end"]
  return [m for m in group
          if "workloads" not in m or workload in m["workloads"]]


def quantity(metric: dict) -> str:
  """The quantity a metric reports: its name before the first dot."""
  return metric["name"].split(".")[0]


def percentile(values, q: float) -> float:
  return float(np.percentile(np.asarray(values, np.float64), q))


def run_window(entry, items, seconds: float, trace: bool, sync):
  """The closed loop: one caller issues calls on the items in turn, in
  whole passes over them, until ``seconds`` have passed and a pass has
  ended; the window closes when the last call returns. Every window thus
  does the same work per pass, and its rate does not hang on which call
  the clock stopped at. Returns (calls, window seconds, the profiler's
  events or None)."""
  import torch
  if trace:
    from portbench import trace as trace_lib
    from spectralcluster_tpu_torch.kernels import fused
    profiling = trace_lib.profiled()
  else:
    profiling = contextlib.nullcontext({})
  calls = []
  with profiling as box:
    with torch.profiler.record_function("portbench:window"):
      t0 = time.perf_counter()
      while time.perf_counter() - t0 < seconds or len(calls) % len(items):
        item = items[len(calls) % len(items)]
        before = fused.launch_counts() if trace else None
        start = time.perf_counter()
        try:
          with torch.profiler.record_function("portbench:call"):
            out = entry.call(item)
          error = None
        except Exception as exc:  # a failed call counts, and is reported
          out, error = None, f"{type(exc).__name__}: {exc}"
        sync()
        record = {"item": item, "out": out, "error": error,
                  "latency_s": time.perf_counter() - start,
                  "segments": entry.segments(item)}
        if trace:
          after = fused.launch_counts()
          record["launches"] = {k: after[k] - before[k] for k in after}
        calls.append(record)
      window_s = time.perf_counter() - t0
  return calls, window_s, box.get("events")


def end_to_end(wanted: list, calls: list, window_s: float,
               peak_bytes: int, setup_s: float) -> dict:
  done = [c for c in calls if c["error"] is None]
  values = {
      "segments_per_s": sum(c["segments"] for c in done) / window_s,
      "latency_p90_s": percentile([c["latency_s"] for c in calls], 90),
      "peak_mem_gib": peak_bytes / 2**30,
      "setup_s": setup_s,
  }
  return {m["name"]: {"value": values[quantity(m)], "unit": m["unit"]}
          for m in wanted}


def window_shape(calls: list, n_items: int) -> str:
  """How the window's pace moved: segments/s in each quarter of the calls,
  and each item's first call in the window over its later calls' median
  (first pass / later), which reads above 1 where something warms up
  inside the window."""
  quarters = []
  for q in range(4):
    part = calls[q * len(calls) // 4:(q + 1) * len(calls) // 4]
    t = sum(c["latency_s"] for c in part)
    quarters.append(sum(c["segments"] for c in part) / t if t else 0.0)
  ratios = []
  for i in range(n_items):
    lat = [c["latency_s"] for c in calls[i::n_items]]
    if len(lat) >= 2:
      ratios.append(lat[0] / float(np.median(lat[1:])))
  first = (f"median {np.median(ratios):.4f}, max {max(ratios):.4f}"
           if ratios else "no item called twice")
  return ("window quarters, segments/s: "
          + " ".join(f"{v:.1f}" for v in quarters)
          + f"; first pass / later: {first}")


def per_layer(wanted: list, ctx: dict) -> dict:
  out = {}
  for m in wanted:
    reader = importlib.import_module(f"portbench.metrics.{quantity(m)}")
    value = reader.read(ctx)
    if value is not None:
      out[m["name"]] = {"value": value, "unit": m["unit"]}
  return out


def check(calls: list, config: dict, limits: dict, device: str):
  """The plain reference on every recording the window used, in float64,
  against every call's answer. Returns (correct, checks, n_failed)."""
  ref_lib = importlib.import_module(
      f"portbench.reference.{config['reference']}")
  failed = sum(c["error"] is not None for c in calls)
  by_recording = {}
  for c in calls:
    if c["out"] is not None:
      rec = c["item"]
      by_recording.setdefault(rec.index, (rec, []))[1].append(c["out"])
  per_recording = []
  for rec, answers in by_recording.values():
    ref = ref_lib.solve(rec, config, "float64", device)
    per_recording.append(compare.worst(
        [compare.call_numbers(ans, ref) for ans in answers]))
  correct, checks = compare.judge(compare.over_recordings(per_recording),
                                  limits)
  return correct and failed == 0 and bool(per_recording), checks, failed


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", chips_required: int = 1,
            break_answer=None) -> dict:
  """One run of the cell; returns the result's line as a dict.
  ``break_answer`` (tests only) alters each answer where it is produced."""
  import torch
  bench, wl, config, traffic, limits = cell(workload)
  cuda = device == "cuda"
  pool = generator.make_pool(traffic, seed)
  entry_mod = importlib.import_module(f"portbench.entries.{traffic['entry']}")
  entry = entry_mod.Entry(config, traffic, device, trace)

  def sync():
    if cuda:
      torch.cuda.synchronize()

  # Warm-up: the port neither pads nor compiles per size, and picks its
  # route by size, so the pool's smallest and largest items take every
  # route the window takes and the largest sets the memory pool.
  sizes = [entry.segments(rec) for rec in pool]
  for i in sorted({sizes.index(min(sizes)), sizes.index(max(sizes))}):
    entry.call(pool[i])
  sync()
  if break_answer is not None:
    entry.call = break_answer(entry.call)
  setup_s = time.perf_counter() - _T_START
  setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
  if cuda:
    torch.cuda.reset_peak_memory_stats()
  calls, window_s, events = run_window(entry, pool, seconds, trace, sync)
  window_peak = torch.cuda.max_memory_allocated() if cuda else 0
  found = forbidden_modules()
  if found:
    raise SystemExit(f"forbidden modules loaded: {found}")

  kind = torch.cuda.get_device_name(0) if cuda else "cpu"
  if trace:
    from portbench import trace as trace_lib
    win = [e for e in events if e.name() == "portbench:window"]
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    summary = trace_lib.summarize(events, w0, w1)
    del events
    ctx = {"calls": calls, "trace": summary, "config": config, "card": kind}
    metrics = per_layer(metrics_for(bench, workload, True), ctx)
  else:
    summary = None
    metrics = end_to_end(metrics_for(bench, workload, False), calls,
                         window_s, window_peak, setup_s)

  entry.close()
  del entry
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()
  t_check = time.perf_counter()
  correct, checks, failed = check(calls, config, limits, device)
  check_s = time.perf_counter() - t_check

  result = {
      "correct": bool(correct),
      "attempted": len(calls),
      "failed": failed,
      "metrics": metrics,
      "device": {
          "platform": "gpu" if cuda else "cpu",
          "kind": kind,
          "count": chips_required,
          "memory_peak_bytes": max(setup_peak, window_peak),
      },
  }
  if summary is not None:
    result["device"]["busy_s"] = summary["busy_s"]
    result["device"]["window_s"] = summary["window_s"]
    result["breakdown"] = {
        "device_ops": trace_lib.top_device_ops(summary["device_s_by_name"]),
        "idle_gaps": summary["idle_gaps"],
    }
  errors = sorted({c["error"] for c in calls if c["error"]})
  for err in errors[:5]:
    print(f"failed call: {err}", file=sys.stderr)
  print(f"window {window_s:.3f} s, {len(calls)} calls; reference "
        f"{check_s:.3f} s", file=sys.stderr)
  print(window_shape(calls, len(pool)), file=sys.stderr)
  result["checks"] = checks
  return result


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  import torch
  _, wl, _, _, _ = cell(args.workload)
  need = int(wl["chips"])
  if not torch.cuda.is_available() or torch.cuda.device_count() < need:
    print(f"{args.workload} needs {need} CUDA card(s); found "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 2
  result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", need)
  for name, c in result["checks"].items():
    print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
  print(json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
