"""dc_lanczos_ms: the top-k route's Lanczos solve (its Krylov steps and
Rayleigh-Ritz reads, accepted or not), device ms per call that ran the
route, from the program's span "dc_lanczos" (0 in a call that did not run
it). A program without the counter "dc_lanczos" gives no reading."""

from portbench.metrics._dc import mean_route_span_ms
from portbench.metrics._spans import mean_count


def read(ctx):
  if mean_count(ctx, "dc_lanczos") is None:
    return None
  return mean_route_span_ms(ctx, "dc_lanczos")
