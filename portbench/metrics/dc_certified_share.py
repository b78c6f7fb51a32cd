"""dc_certified_share: the share of the window's calls whose top-k route
answered by the certified subspace solve, from the program's counter
"dc_certified" (1 where it did, 0 where it declined to the split)."""

from portbench.metrics._spans import mean_count


def read(ctx):
  return mean_count(ctx, "dc_certified")
