"""eigh_ms: the monolithic executor's full symmetric eigensolver
(``sorted_eigh_similarity``), device ms per call, from the program's span
"eigh"."""

from portbench.metrics._spans import mean_span_ms


def read(ctx):
  return mean_span_ms(ctx, ("eigh",), "device_s")
