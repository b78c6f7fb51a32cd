"""prep_ms: the staged executor's prep stage (affinity, refinement,
Diffuse) per call, from ``ClusterResult.timings``."""

from portbench.metrics._stages import mean_stage_ms

STAGES = ("staged_prep",)


def read(ctx):
  return mean_stage_ms(ctx, STAGES)
