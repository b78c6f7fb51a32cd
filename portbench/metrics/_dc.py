"""Shared reading of the top-k route's spans (``ops/dc.py``) from the
program's record of its calls.

A call ran the route where it holds the route's counter "dc_certified".
A span is read per such call, 0 where the call did not enter it, so that
a window whose calls all certify still reads its split time (0). A
program without the counter gives no reading, and neither does a run off
the card, where spans have no device seconds.
"""

from __future__ import annotations

from portbench.metrics._spans import window_calls


def mean_route_span_ms(ctx: dict, name: str) -> "float | None":
  """Device ms of the span ``name`` per window call that ran the route."""
  per_call = []
  for call in window_calls(ctx):
    if "dc_certified" not in call.counters:
      continue
    if call.spans[0].device_s is None:
      return None
    per_call.append(sum(s.device_s for s in call.spans if s.name == name))
  if not per_call:
    return None
  return 1e3 * sum(per_call) / len(per_call)
