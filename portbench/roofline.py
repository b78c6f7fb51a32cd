"""Peaks of the card and the least work of the kernels' operations.

The peaks are the data sheet's (``peaks.json``), matched on the name that
``torch.cuda.get_device_name()`` gives. A kernel's bound is the larger of
its float32 operations over the float32 peak and its bytes over the memory
bandwidth, with each input byte read once and each output byte written
once: the least time the card could take for the operation, whatever
implements it.
"""

from __future__ import annotations

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def card_peaks(name: str) -> dict:
  with open(os.path.join(_HERE, "peaks.json")) as f:
    table = json.load(f)
  for row in table["cards"]:
    if row["match"] in name:
      return row
  raise KeyError(f"no data-sheet peaks for card {name!r}")


def affinity_work(n: int, d: int):
  """Cosine affinity of (n, d) float32 rows: the symmetric least work,
  n(n+1)/2 dot products of 2d operations; reads n·d, writes n² floats."""
  return n * (n + 1) * d, 4 * (n * d + n * n)


def bound_s(work, peaks: dict) -> float:
  flops, nbytes = work
  return max(flops / peaks["fp32_flops_per_s"], nbytes / peaks["bytes_per_s"])
