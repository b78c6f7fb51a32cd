"""Shared arithmetic of the kernels' roofline shares."""

from __future__ import annotations

from portbench import roofline


def device_seconds(ctx: dict, names) -> float:
  """Device time of the kernels whose trace name contains one of
  ``names``."""
  return sum(sec for kname, sec in ctx["trace"]["device_s_by_name"].items()
             if any(n in kname for n in names))


def share_pct(ctx: dict, names, bound_of) -> "float | None":
  """100 × the least time over the device time of the kernels named,
  ``bound_of(peaks)`` giving the least time; None where the trace holds
  none of them."""
  spent = device_seconds(ctx, names)
  if spent <= 0:
    return None
  bound_s = bound_of(roofline.card_peaks(ctx["card"]))
  return 100.0 * bound_s / spent if bound_s > 0 else None
