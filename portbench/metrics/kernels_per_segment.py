"""kernels_per_segment: device kernels and copies in the traced window over
the segments its calls clustered."""


def read(ctx):
  segments = sum(c["segments"] for c in ctx["calls"] if c["error"] is None)
  if not segments or not ctx["trace"]["device_events"]:
    return None
  return ctx["trace"]["device_events"] / segments
