"""dc_certified_ms: the top-k route's certified attempt (the subspace
solve and its completeness probe, accepted or declined), device ms per
call that ran the route, from the program's span "dc_certified"."""

from portbench.metrics._dc import mean_route_span_ms


def read(ctx):
  return mean_route_span_ms(ctx, "dc_certified")
