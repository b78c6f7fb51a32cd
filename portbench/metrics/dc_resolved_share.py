"""dc_resolved_share: the share of the window's calls whose eigenpairs
came from the full eigh because the top-k route's certificate could not
decide the count or vouch that its pairs are the extreme ones, from the
program's counter "dc_resolved"."""

from portbench.metrics._spans import mean_count


def read(ctx):
  return mean_count(ctx, "dc_resolved")
