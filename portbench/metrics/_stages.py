"""Shared reading of ``ClusterResult.timings`` for the stage metrics."""

from __future__ import annotations


def mean_stage_ms(ctx: dict, stages) -> "float | None":
  """Mean over the traced calls of the seconds the named stages took in
  each call (summed when several are present), in ms; None when no call
  has any of them."""
  per_call = []
  for c in ctx["calls"]:
    if c["out"] is None:
      continue
    timings = c["out"].get("timings") or {}
    found = [timings[s] for s in stages if s in timings]
    if found:
      per_call.append(sum(found))
  if not per_call:
    return None
  return 1e3 * sum(per_call) / len(per_call)
