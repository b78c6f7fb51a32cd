"""edge_ms: a call's edges on the host, per call: the input's conversion
and copy to the card (span "upload") and the answer's four reads back
(span "download"), host ms, from the program's spans."""

from portbench.metrics._spans import mean_span_ms


def read(ctx):
  return mean_span_ms(ctx, ("upload", "download"), "host_s")
