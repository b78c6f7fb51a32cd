"""Shared reading of the program's in-memory record of its calls
(``spectralcluster_tpu_torch.observability.recorded_calls``) for the span
and counter metrics.

The window's calls are the last ``len(ctx["calls"])`` calls the program
recorded: ``run.py`` reads the metrics right after the window, before
anything else calls the program. A program that keeps no such record
gives no reading.
"""

from __future__ import annotations


def window_calls(ctx: dict) -> list:
  """The window's calls as the program recorded them, oldest first."""
  n = len(ctx["calls"])
  try:
    from spectralcluster_tpu_torch import observability
    recorded = observability.recorded_calls
  except (ImportError, AttributeError):
    return []
  return recorded(n) if n else []


def mean_span_ms(ctx: dict, names, clock: str) -> "float | None":
  """Mean over the window's calls that hold any of the spans named of
  their seconds on ``clock`` ("device_s" or "host_s"), summed over those
  spans, in ms; None when no call holds one with that clock (off the
  card, spans have no device seconds)."""
  per_call = []
  for call in window_calls(ctx):
    found = [getattr(s, clock) for s in call.spans if s.name in names]
    if found and None not in found:
      per_call.append(sum(found))
  if not per_call:
    return None
  return 1e3 * sum(per_call) / len(per_call)


def mean_count(ctx: dict, name: str) -> "float | None":
  """Mean over the window's calls that hold the counter of its count."""
  counts = [call.counters[name] for call in window_calls(ctx)
            if name in call.counters]
  if not counts:
    return None
  return float(sum(counts)) / len(counts)
