"""dc_iters: subspace iterations per call across the top-k route (the
certified attempt, the split's fallbacks and deflated remainders), from
the program's counter "dc_subspace_iters"."""

from portbench.metrics._spans import mean_count


def read(ctx):
  return mean_count(ctx, "dc_subspace_iters")
