"""refine_ms: the monolithic executor from the embeddings up to the
eigensolver's operand (kernel 1, the refinement sequence, the operand),
device ms per call, from the program's span "refine"."""

from portbench.metrics._spans import mean_span_ms


def read(ctx):
  return mean_span_ms(ctx, ("refine",), "device_s")
