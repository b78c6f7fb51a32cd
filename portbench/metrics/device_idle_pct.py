"""device_idle_pct: 100 × (1 − busy / window), busy being the union of the
card's kernel, copy and memset intervals in the traced window."""


def read(ctx):
  t = ctx["trace"]
  if t["window_s"] <= 0 or t["device_events"] == 0:
    return None
  return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
