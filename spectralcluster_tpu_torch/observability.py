"""Observability: stage timing and profiler hooks.

Port of ``spectralcluster_tpu/observability.py``:
  * ``StageTimings`` — wall-clock durations of pipeline stages;
  * ``profile_trace`` — a context manager around ``torch.profiler`` that
    writes a Chrome trace of the enclosed block (the JAX package wraps
    ``jax.profiler.trace``);
  * ``block_and_time`` — run a function, wait for the cards that hold its
    outputs, and return the outputs with the seconds taken (the JAX
    package blocks with ``jax.block_until_ready``).
"""

from __future__ import annotations

import contextlib
import os
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


def _cuda_devices(out, found: typing.Set[torch.device]):
  """The CUDA devices of every tensor in a nested structure (tuples,
  lists, dicts and their values)."""
  if isinstance(out, torch.Tensor):
    if out.device.type == "cuda":
      found.add(out.device)
  elif isinstance(out, dict):
    for value in out.values():
      _cuda_devices(value, found)
  elif isinstance(out, (list, tuple)):
    for value in out:
      _cuda_devices(value, found)
  return found


def block_and_time(fn, *args, **kwargs):
  """Run fn, wait for its outputs, return (outputs, seconds).

  Every CUDA device that holds a tensor of the (nested) outputs is
  synchronized before the clock is read, so the seconds include the
  device work the call enqueued.
  """
  t0 = time.perf_counter()
  out = fn(*args, **kwargs)
  for device in _cuda_devices(out, set()):
    torch.cuda.synchronize(device)
  return out, time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: str, host_trace: bool = True):
  """Capture a ``torch.profiler`` trace of the enclosed block.

  Records the host's activity, and the card's where CUDA is available,
  and writes it as a Chrome trace, ``trace_<pid>_<ns>.json`` under
  ``log_dir`` (made if missing). ``host_trace`` is accepted and ignored,
  as in the JAX package: the host is always recorded.
  """
  del host_trace
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield
  prof.export_chrome_trace(os.path.join(
      log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
