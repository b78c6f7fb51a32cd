"""Stage timing for one clustering call."""

from __future__ import annotations

import contextlib
import time
import typing

import torch


class StageTimings:
  """Accumulates wall-clock stage durations for one clustering call.

  With a CUDA ``device``, each stage synchronizes the card before it reads
  the clock at its start and at its end, so a duration is the device time
  of the work the stage enqueued, not the time to enqueue it.
  """

  def __init__(self, device: typing.Union[str, torch.device, None] = None):
    self.timings: typing.Dict[str, float] = {}
    self._cuda = device is not None and torch.device(device).type == "cuda"

  def _sync(self):
    if self._cuda:
      torch.cuda.synchronize()

  @contextlib.contextmanager
  def stage(self, name: str):
    self._sync()
    t0 = time.perf_counter()
    try:
      yield
    finally:
      self._sync()
      self.timings[name] = self.timings.get(name, 0.0) + (
          time.perf_counter() - t0)

  def as_dict(self) -> dict:
    return dict(self.timings)
