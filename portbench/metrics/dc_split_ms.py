"""dc_split_ms: the top-k route's split (the sign chain and its levels),
device ms per call that ran the route, from the program's span
"dc_split" (0 in a call that certified)."""

from portbench.metrics._dc import mean_route_span_ms


def read(ctx):
  return mean_route_span_ms(ctx, "dc_split")
