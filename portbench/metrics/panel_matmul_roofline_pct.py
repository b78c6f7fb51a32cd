"""panel_matmul_roofline_pct: kernel 6's share of its roofline, the least
time of the window's panel products over the device time of the kernels
named below.

The program counts per call the shapes of the route's products
(counters "panel_matmul_mnb", Σ m·n·b, and "panel_matmul_io",
Σ (m·n + n·b + m·b), for an (m, n) operand times an (n, b) panel, row
stripes and sub-level blocks at their own m and n); ``work`` turns them
into operations and bytes. The bound is the larger of the operations over
the card's float64 tensor-core peak, which on the cards of ``peaks.json``
equals their float32 figure, and the bytes over its memory bandwidth. A
program without the counters gives no reading."""

from portbench import roofline
from portbench.metrics import _roofline
from portbench.metrics._spans import window_calls

# Trace names of kernel 6.
KERNELS = ("panel_matmul_kernel",)


def work(mnb: int, io: int):
  """(operations, bytes) of products whose shape sums are ``mnb`` and
  ``io``: 2·m·n·b float64 multiply-adds' operations, and each float32
  element of the operand and panel read once and of the product written
  once."""
  return 2 * mnb, 4 * io


def read(ctx):
  calls = [c for c in window_calls(ctx) if "panel_matmul_mnb" in c.counters]
  if not calls:
    return None

  def bound_of(peaks):
    return sum(roofline.bound_s(work(c.counters["panel_matmul_mnb"],
                                     c.counters["panel_matmul_io"]), peaks)
               for c in calls)

  return _roofline.share_pct(ctx, KERNELS, bound_of)
