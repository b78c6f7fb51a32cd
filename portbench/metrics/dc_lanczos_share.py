"""dc_lanczos_share: the share of the window's calls whose top-k route
answered by Lanczos, from the program's counter "dc_lanczos" (1 where
Lanczos's pairs were kept, 0 where another solve answered)."""

from portbench.metrics._spans import mean_count


def read(ctx):
  return mean_count(ctx, "dc_lanczos")
