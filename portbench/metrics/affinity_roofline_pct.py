"""affinity_roofline_pct: the cosine affinity's least time at each call's
N (``roofline.affinity_work``, summed over the traced calls that ran the
affinity kernel) over the device time of the kernels named below."""

from portbench import roofline
from portbench.metrics import _roofline

# Trace names of the kernels that compute the 2-D affinity.
KERNELS = ("affinity_kernel",)
# The program's launch counter of the same kernel.
COUNTER = "affinity"


def read(ctx):
  d = int(ctx["config"]["embedding_dim"])

  def bound_of(peaks):
    return sum(
        c.get("launches", {}).get(COUNTER, 0)
        * roofline.bound_s(roofline.affinity_work(c["segments"], d), peaks)
        for c in ctx["calls"])

  return _roofline.share_pct(ctx, KERNELS, bound_of)
