"""kmeans_ms: K-Means (k-means++ and Lloyd), device ms per call, from the
program's span "kmeans"."""

from portbench.metrics._spans import mean_span_ms


def read(ctx):
  return mean_span_ms(ctx, ("kmeans",), "device_s")
