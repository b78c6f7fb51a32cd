#!/usr/bin/env python3
"""Where one icassp2018 `predict` of the PyTorch port spends its time.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_predict_torch.py [--n 10240] [--runs 3]

For each eigensolver it prints one JSON line with
  * the staged executor's stage timings of each warm run (the stages
    synchronize the card, so each is the device time of its work);
  * K-Means: Lloyd rounds run, and seconds in k-means++ and in Lloyd;
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

  from spectralcluster_tpu_torch import configs
  from spectralcluster_tpu_torch.fixtures import make_embeddings
  from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops
  from spectralcluster_tpu_torch.types import EigenSolver

  # Instrument K-Means from outside: count Lloyd rounds (one centroid
  # update per round that did not stop) and time its two phases.
  counts = {"rounds": 0, "kmeanspp_s": 0.0, "lloyd_s": 0.0}
  update, plusplus, lloyd = (kmeans_ops._update_centroids,
                             kmeans_ops.kmeans_plusplus,
                             kmeans_ops.lloyd_iterations)

  def timed(fn, key):
    def wrapped(*a, **kw):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = fn(*a, **kw)
      torch.cuda.synchronize()
      counts[key] += time.perf_counter() - t0
      return out
    return wrapped

  def counted_update(*a):
    counts["rounds"] += 1
    return update(*a)

  kmeans_ops._update_centroids = counted_update
  kmeans_ops.kmeans_plusplus = timed(plusplus, "kmeanspp_s")
  kmeans_ops.lloyd_iterations = timed(lloyd, "lloyd_s")

  smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                 "--format=csv,noheader").read().strip()
  x = make_embeddings(args.n)
  for solver in (EigenSolver.Auto, EigenSolver.SubspaceIteration):
    clusterer = configs.make_icassp2018_clusterer(
        eigensolver=solver, staged_stage_timings=True)
    clusterer.predict(x)                      # warm-up
    runs = []
    for _ in range(args.runs):
      counts.update(rounds=0, kmeanspp_s=0.0, lloyd_s=0.0)
      result = clusterer.predict_with_details(x)
      runs.append({"timings_s": result.timings, **counts})
    line = {"solver": solver.name, "n": args.n, "card": smi, "runs": runs}
    if solver == EigenSolver.SubspaceIteration:
      with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clusterer.predict(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
      # Kernel entries only: an op's own entry repeats its kernels' time.
      kernels = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]

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
