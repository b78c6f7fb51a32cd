"""eig_ms: the staged executor's eigensolver stage per call, from
``ClusterResult.timings``, whichever solver the route took."""

from portbench.metrics._stages import mean_stage_ms

STAGES = ("staged_dc", "staged_eigh", "staged_subspace")


def read(ctx):
  return mean_stage_ms(ctx, STAGES)
