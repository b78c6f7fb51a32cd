"""dc_lanczos_steps: Krylov steps per call of the top-k route's Lanczos
solve (each one product of kernel 6 at one column), 0 in a call that did
not run it, from the program's counter "dc_lanczos_steps"."""

from portbench.metrics._spans import mean_count


def read(ctx):
  return mean_count(ctx, "dc_lanczos_steps")
