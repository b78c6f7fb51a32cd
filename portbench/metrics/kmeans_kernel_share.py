"""kmeans_kernel_share: the share of the window's calls whose K-Means ran
as the port's one-launch kernel, from the program's counter
"kmeans_kernel" (1 where it did, 0 where K-Means ran eagerly). A program
without the counter gives no reading."""

from portbench.metrics._spans import mean_count


def read(ctx):
  return mean_count(ctx, "kmeans_kernel")
