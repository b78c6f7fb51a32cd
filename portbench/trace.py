"""The traced window: ``torch.profiler`` events read in memory.

The card's activity (kernels, copies, memsets) gives the busy time as the
union of their intervals, so copies on a side stream that overlap kernels
count once. The host's operator events name each idle gap by the innermost
operator running at its midpoint, or by the harness's call span when the
host was in plain Python. No Chrome trace is written.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

import torch


@contextlib.contextmanager
def profiled():
  """Profile the enclosed window; yields a dict that holds the events
  once the block has ended."""
  box = {}
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    yield box
  box["events"] = prof.profiler.kineto_results.events()


def _is_device(event) -> bool:
  """Whether an event on the card's timeline is a kernel, copy or memset.
  The profiler also puts each ``record_function`` span there as a user
  annotation; that is no device work."""
  flag = getattr(event, "is_user_annotation", None)
  return not (flag is not None and flag()) and not (
      event.name().startswith("portbench:"))


def summarize(events, window_start_ns: int, window_end_ns: int) -> dict:
  """Busy seconds (union of device intervals), device time by kernel
  name, the device event count, and the longest idle gaps named by the
  host. Times are clipped to the window (ns on the profiler's clock)."""
  device, host = [], []
  for ev in events:
    start = ev.start_ns()
    end = start + ev.duration_ns()
    if end <= window_start_ns or start >= window_end_ns:
      continue
    start, end = max(start, window_start_ns), min(end, window_end_ns)
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
      if _is_device(ev):
        device.append((start, end, ev.name()))
    elif end > start:
      host.append((start, end, ev.name()))
  device.sort()
  by_name = collections.Counter()
  launches = collections.Counter()
  busy, gaps = 0, []
  cur_s, cur_e = window_start_ns, window_start_ns
  for start, end, name in device:
    by_name[name] += (end - start) * 1e-9
    launches[name] += 1
    if start > cur_e:
      busy += cur_e - cur_s
      gaps.append((cur_e, start))
      cur_s, cur_e = start, end
    else:
      cur_e = max(cur_e, end)
  busy += cur_e - cur_s
  if window_end_ns > cur_e:
    gaps.append((cur_e, window_end_ns))
  return {
      "busy_s": busy * 1e-9,
      "window_s": (window_end_ns - window_start_ns) * 1e-9,
      "device_s_by_name": dict(by_name),
      "launches_by_name": dict(launches),
      "device_events": len(device),
      "idle_gaps": _name_gaps(gaps, host),
  }


def _name_gaps(gaps, host, keep: int = 10):
  """The ``keep`` longest gaps as [name, seconds], named by the innermost
  host event that spans the gap's midpoint; several gaps of one name are
  summed."""
  longest = sorted(gaps, key=lambda g: g[0] - g[1])[:keep * 20]
  host.sort()
  starts = [h[0] for h in host]
  named = collections.Counter()
  for g0, g1 in longest:
    mid = (g0 + g1) // 2
    i = bisect.bisect_right(starts, mid)
    best, best_len = "host: between calls", None
    # Innermost: the shortest host event that spans the midpoint, among
    # those that start before it (the search is bounded for speed).
    for j in range(i - 1, max(-1, i - 4000), -1):
      s, e, name = host[j]
      if e >= mid and (best_len is None or e - s < best_len):
        best, best_len = name, e - s
    named[best] += (g1 - g0) * 1e-9
  return [[name, sec] for name, sec in named.most_common(keep)]


def top_device_ops(by_name: dict, keep: int = 10):
  return [[name, sec] for name, sec in
          sorted(by_name.items(), key=lambda kv: -kv[1])[:keep]]
