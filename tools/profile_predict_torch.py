#!/usr/bin/env python3
"""Where one icassp2018 `predict` of the PyTorch port spends its time.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_predict_torch.py [--n 10240] [--runs 3]

For each eigensolver it prints one JSON line with
  * the stage and span timings of each warm run (``staged_stage_timings``:
    each the device time of its work, from a pair of CUDA events);
  * K-Means, from the program's record of the run
    (``observability.recorded_calls``): the "kmeans" span's host and
    device seconds (k-means++ and Lloyd) and the Lloyd rounds the host ran
    (counter "lloyd_rounds");
  * for SubspaceIteration, from one torch.profiler trace of a warm predict:
    wall ms, device busy ms (the sum of the device time of every kernel),
    the device's idle share of the profiled wall time (the profiler slows
    the host, so this overstates the idle share of an untraced run), and
    the five kernels with the most device time.
    Auto is not traced: its full eigh launches so many small solver
    kernels that summarizing the trace takes minutes, and its stage
    timings already show the eigh as nearly all of its time.
The profiled run is separate from the timed runs. The fixture is the
bench's make_embeddings(n) (two speakers, d=256).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--n", type=int, default=10240)
  parser.add_argument("--runs", type=int, default=3)
  args = parser.parse_args()

  import torch
  if not torch.cuda.is_available():
    print("profile_predict_torch: no CUDA device", file=sys.stderr)
    return 2
  sys.path.insert(0, HERE)
  from torch.profiler import ProfilerActivity, profile

  from spectralcluster_tpu_torch import configs, observability
  from spectralcluster_tpu_torch.fixtures import make_embeddings
  from spectralcluster_tpu_torch.types import EigenSolver

  smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                 "--format=csv,noheader").read().strip()
  x = make_embeddings(args.n)
  for solver in (EigenSolver.Auto, EigenSolver.SubspaceIteration):
    clusterer = configs.make_icassp2018_clusterer(
        eigensolver=solver, staged_stage_timings=True)
    clusterer.predict(x)                      # warm-up
    runs = []
    for _ in range(args.runs):
      result = clusterer.predict_with_details(x)
      (call,) = observability.recorded_calls(1)
      kmeans = [s for s in call.spans if s.name == "kmeans"]
      runs.append({"timings_s": result.timings,
                   "lloyd_rounds": call.counters.get("lloyd_rounds"),
                   "kmeans_host_s": sum(s.host_s for s in kmeans),
                   "kmeans_device_s": sum(s.device_s for s in kmeans)})
    line = {"solver": solver.name, "n": args.n, "card": smi, "runs": runs}
    if solver == EigenSolver.SubspaceIteration:
      with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clusterer.predict(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
      # Kernel entries only: an op's own entry, and a span's ``sct.*``
      # range, repeat its kernels' time.
      kernels = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("sct.")]

      def device_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

      busy_ms = sum(device_ms(e) for e in kernels)
      top = sorted(kernels, key=device_ms, reverse=True)[:5]
      line.update(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                  device_idle_share=1.0 - busy_ms / wall_ms,
                  top_kernels_ms={e.key: device_ms(e) for e in top})
    print(json.dumps(line), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
