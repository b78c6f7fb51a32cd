"""finish_ms: the staged executor's finish stage (K-Means) per call, from
``ClusterResult.timings``."""

from portbench.metrics._stages import mean_stage_ms

STAGES = ("staged_finish",)


def read(ctx):
  return mean_stage_ms(ctx, STAGES)
