"""lloyd_rounds: the Lloyd rounds the host ran per call, from the
program's counter "lloyd_rounds"."""

from portbench.metrics._spans import mean_count


def read(ctx):
  return mean_count(ctx, "lloyd_rounds")
