"""Observability: stage spans, counters and profiler hooks.

Port of ``spectralcluster_tpu/observability.py``:
  * ``StageTimings`` — the port's one span recorder: the durations of
    pipeline stages, timed on the device's timeline without syncing the
    card, the counters recorded at the same boundaries, ``sct.<span>``
    profiler ranges, and the bounded in-memory record of the last calls
    (``recorded_calls``);
  * ``profile_trace`` — a context manager around ``torch.profiler`` that
    writes a Chrome trace of the enclosed block (the JAX package wraps
    ``jax.profiler.trace``);
  * ``block_and_time`` — run a function, wait for the cards that hold its
    outputs, and return the outputs with the seconds taken (the JAX
    package blocks with ``jax.block_until_ready``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
import typing

import torch

# One span of a call: its name, the name of the span that encloses it
# (None for a call's root), host seconds, and device seconds (the elapsed
# time of a CUDA event pair; None off the card).
Span = collections.namedtuple("Span", "name parent host_s device_s")

# One recorded call: its spans, root first, the rest in the order they
# ended, and its counters.
Call = collections.namedtuple("Call", "spans counters")

# Calls the in-memory record keeps: a 40 s window of predicts on
# 256-1024 segments with spans on makes about a thousand.
RECORD_CALLS = 4096

_NO_SPAN = contextlib.nullcontext()


class CallRecord:
  """The last ``size`` recorded calls of this process, oldest first."""

  def __init__(self, size: int = RECORD_CALLS):
    self._calls = collections.deque(maxlen=size)

  def append(self, call: Call):
    self._calls.append(call)

  def last(self, n: typing.Optional[int] = None) -> typing.List[Call]:
    """The last ``n`` calls (all when None), oldest first."""
    calls = list(self._calls)
    return calls if n is None else calls[max(len(calls) - n, 0):]

  def __len__(self) -> int:
    return len(self._calls)


# Process-wide, as the profiler is: a benchmark reads the calls of its
# window here after the window.
RECORD = CallRecord()


def recorded_calls(n: typing.Optional[int] = None) -> typing.List[Call]:
  """The last ``n`` calls recorded with spans on, oldest first."""
  return RECORD.last(n)


def _elapsed_s(start, end) -> typing.Optional[float]:
  """Seconds between two recorded CUDA events on the device's timeline,
  once the later one has completed; None off the card."""
  if start is None:
    return None
  end.synchronize()
  return start.elapsed_time(end) * 1e-3


class StageTimings:
  """The spans and counters of one clustering call.

  A stage's duration is its time on the device's timeline: with a CUDA
  ``device``, the elapsed time of a pair of CUDA events recorded on the
  device's current stream at the stage's edges, read once, when the
  durations are first asked for (``as_dict``, ``spans``, or the end of
  ``call``), after the answer has reached the host; no stage waits for the
  card. Off the card it is host seconds.

  ``stage`` records always. ``span`` and ``count`` record only with
  ``detail`` (``SpectralClusterer(staged_stage_timings=True)``), and then
  every stage and span is also a ``torch.profiler.record_function`` range
  named ``sct.<name>``, nested under one ``sct.predict`` range per
  ``call``, so under the profiler the spans sit on the clock of the
  device's kernels. A ``call`` with ``detail`` goes into ``RECORD``.
  """

  def __init__(self, device: typing.Union[str, torch.device, None] = None,
               detail: bool = True):
    self.detail = detail
    self._device = None
    if device is not None and torch.device(device).type == "cuda":
      self._device = torch.device(device)
    self._pending = []   # [name, parent, host_s, start event, end event]
    self._spans: typing.List[Span] = []
    self._counters: typing.Dict[str, int] = {}
    self._open: typing.List[str] = []
    self._prefix = ""

  def _event(self):
    if self._device is None:
      return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(self._device))
    return event

  @contextlib.contextmanager
  def stage(self, name: str):
    name = self._prefix + name
    parent = self._open[-1] if self._open else None
    if self.detail:
      scope = torch.profiler.record_function("sct." + name)
      scope.__enter__()
      self._open.append(name)
    start = self._event()
    t0 = time.perf_counter()
    try:
      yield
    finally:
      host_s = time.perf_counter() - t0
      self._pending.append([name, parent, host_s, start, self._event()])
      if self.detail:
        self._open.pop()
        scope.__exit__(None, None, None)

  def span(self, name: str):
    """A stage recorded only with ``detail``."""
    return self.stage(name) if self.detail else _NO_SPAN

  def count(self, name: str, n: int):
    """Add ``n`` to the counter ``name`` (with ``detail`` only)."""
    if self.detail:
      name = self._prefix + name
      self._counters[name] = self._counters.get(name, 0) + int(n)

  @contextlib.contextmanager
  def prefixed(self, prefix: str):
    """Record the enclosed stages and counters under ``prefix`` + name."""
    outer = self._prefix
    self._prefix = outer + prefix
    try:
      yield
    finally:
      self._prefix = outer

  @contextlib.contextmanager
  def call(self):
    """One clustering call. With ``detail``: its root span "predict"
    (range ``sct.predict``; not a stage of ``as_dict``), and at its end,
    raised or not, the call's spans and counters appended to ``RECORD``."""
    if not self.detail:
      yield
      return
    scope = torch.profiler.record_function("sct.predict")
    scope.__enter__()
    self._open.append("predict")
    start = self._event()
    t0 = time.perf_counter()
    try:
      yield
    finally:
      host_s = time.perf_counter() - t0
      end = self._event()
      self._open.pop()
      scope.__exit__(None, None, None)
      root = Span("predict", None, host_s, _elapsed_s(start, end))
      RECORD.append(Call((root,) + tuple(self.spans()), self.counters()))

  def _resolve(self):
    for name, parent, host_s, start, end in self._pending:
      self._spans.append(Span(name, parent, host_s, _elapsed_s(start, end)))
    self._pending.clear()

  def spans(self) -> typing.List[Span]:
    """Every stage and span recorded so far, in the order they ended."""
    self._resolve()
    return list(self._spans)

  def as_dict(self) -> dict:
    """Seconds per stage name, summed over its spans: device seconds on
    the card, host seconds off it."""
    out: typing.Dict[str, float] = {}
    for s in self.spans():
      out[s.name] = out.get(s.name, 0.0) + (
          s.host_s if s.device_s is None else s.device_s)
    return out

  def counters(self) -> typing.Dict[str, int]:
    return dict(self._counters)


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
  as in the JAX package: the host is always recorded. A ``predict`` with
  ``staged_stage_timings=True`` shows there as ``sct.predict`` with its
  ``sct.<span>`` ranges under it.
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
