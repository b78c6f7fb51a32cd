#!/usr/bin/env python3
"""Run the port's row-sharded path across torch.distributed ranks.

    python3 tools/torch_distributed_validate.py [--ranks 4]
    python3 tools/torch_distributed_validate.py --ranks 4 --device cuda \
        --n 20480 --d 256 --warm-runs 2

Starts ``--ranks`` processes on this machine that join one world at a free
localhost port (``parallel/mesh.initialize_distributed``, called twice:
the second call must do nothing): gloo on the CPU, or NCCL with rank r on
card r (``--device cuda``, one card per rank). Each rank checks:

  * a cross-rank ``all_reduce``;
  * ``cluster_large_sharded`` on a mesh of the world's ranks, with and
    without the ring affinity, gives the labels and cluster count of the
    same path with as many shards in one process on the rank's device, on
    ``make_embeddings_k(n, 3, d)`` (the default N=249 does not divide 2 or
    4 ranks: padding; the blur's halo crosses stripes);
  * with 4 ranks, a (2, 2) mesh: two ``model`` lines of 2 ranks each run
    the path apart, and agree with 2 shards in one process;
  * ``check_ring_order`` on both mesh axes and
    ``check_replica_consistency`` across processes, which must also catch
    a value that differs per rank;
  * no op of the distributed run makes a tensor larger than
    (N_pad/P + 2r)·N_pad elements (r the blur radius): no rank holds an
    (N, N) matrix.

With ``--warm-runs`` each rank also times that many more runs of each form
(host clock, card synced) beside as many of the in-process shards, with
the peak memory of each. Each rank prints one JSON line; the script prints
{"ok": true, ...} last and exits 0 when every rank passed. It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import sys
import time

SPEAKERS = 3
SIGMA = 1.0      # blur radius int(4σ+0.5) = 4 rows

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, device: str, n: int, d: int,
            warm_runs: int) -> None:
  import numpy as np
  import torch
  import torch.distributed as dist
  from torch.utils._python_dispatch import TorchDispatchMode
  from torch.utils._pytree import tree_leaves

  from spectralcluster_tpu_torch import configs, observability, pipeline
  from spectralcluster_tpu_torch import utils
  from spectralcluster_tpu_torch.fixtures import make_embeddings_k
  from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
  from spectralcluster_tpu_torch.parallel import sanity, sharded

  torch.set_num_threads(1)

  class LargestTensor(TorchDispatchMode):
    """Records the most elements any op's output holds."""
    largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
          self.largest = max(self.largest, t.numel())
      return out

  for _ in range(2):
    mesh_lib.initialize_distributed(f"localhost:{port}", world, rank,
                                    device=device)
  dev = (torch.device("cuda", rank) if device == "cuda"
         else torch.device("cpu"))
  cuda = dev.type == "cuda"

  def sync():
    if cuda:
      torch.cuda.synchronize(dev)

  report = {"rank": rank, "world": world, "device": str(dev), "n": n}
  if cuda:
    report["card"] = torch.cuda.get_device_name(dev)
  total = torch.tensor([float(rank + 1)], device=dev)
  dist.all_reduce(total)
  report["all_reduce"] = float(total)
  assert report["all_reduce"] == world * (world + 1) / 2

  x, truth = make_embeddings_k(n, SPEAKERS, d=d)
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options().replace(
          gaussian_blur_sigma=SIGMA),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300)
  mesh = mesh_lib.make_mesh(dp=1, mp=world)
  assert mesh.ranks.tolist() == [list(range(world))]
  assert mesh.devices[0, rank] == dev
  n_pad = -(-n // world) * world
  limit = (n_pad // world + 2 * int(4 * SIGMA + 0.5)) * n_pad
  local = mesh_lib.make_mesh(dp=1, mp=world, devices=[dev] * world)

  def ordered(labels):
    return utils.enforce_ordered_labels(np.asarray(labels)).tolist()

  def timed(mesh, use_ring):
    timings = observability.StageTimings(dev)
    if cuda:
      torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    sharded.cluster_large_sharded(x, cfg, mesh, use_ring_affinity=use_ring,
                                  timings=timings)
    sync()
    row = {"wall_s": time.perf_counter() - t0,
           "stages_s": timings.as_dict()}
    if cuda:
      row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return row

  for use_ring in (False, True):
    want, want_n = sharded.cluster_large_sharded(x, cfg, local,
                                                 use_ring_affinity=use_ring)
    probe = LargestTensor()
    with probe:
      got, got_n = sharded.cluster_large_sharded(x, cfg, mesh,
                                                 use_ring_affinity=use_ring)
    key = "ring" if use_ring else "all_gather"
    report[key] = {"n_clusters": got_n, "largest_tensor": probe.largest,
                   "limit": limit,
                   "labels_equal_in_process": ordered(got) == ordered(want),
                   "labels_equal_truth": ordered(got) == ordered(truth)}
    assert got_n == want_n, (got_n, want_n)
    assert ordered(got) == ordered(want)
    assert probe.largest <= limit, (probe.largest, limit)
    if warm_runs:
      report[key]["distributed_warm"] = [timed(mesh, use_ring)
                                         for _ in range(warm_runs)]
      report[key]["in_process_warm"] = [timed(local, use_ring)
                                        for _ in range(warm_runs)]

  sanity.check_ring_order(mesh, "model")
  sanity.check_replica_consistency(mesh, torch.arange(16.0))
  try:
    sanity.check_replica_consistency(mesh, torch.arange(16.0) + rank)
    raise RuntimeError("a per-rank value passed the replica check")
  except AssertionError:
    report["replica_divergence_caught"] = True

  if world == 4:
    grid = mesh_lib.make_mesh(dp=2, mp=2)
    sanity.check_ring_order(grid, "model")
    sanity.check_ring_order(grid, "batch")
    got, got_n = sharded.cluster_large_sharded(x, cfg, grid)
    want, want_n = sharded.cluster_large_sharded(
        x, cfg, mesh_lib.make_mesh(dp=1, mp=2, devices=[dev] * 2))
    assert got_n == want_n and ordered(got) == ordered(want)
    report["grid_2x2_labels_equal_in_process"] = True
  dist.barrier()
  dist.destroy_process_group()
  print(json.dumps(report), flush=True)


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--ranks", type=int, default=4)
  parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
  parser.add_argument("--n", type=int, default=249,
                      help="rows; the default does not divide 2 or 4")
  parser.add_argument("--d", type=int, default=32)
  parser.add_argument("--warm-runs", type=int, default=0)
  parser.add_argument("--timeout", type=float, default=100.0,
                      help="seconds until unfinished ranks are killed")
  args = parser.parse_args()
  port = _free_port()
  ctx = multiprocessing.get_context("spawn")
  procs = [ctx.Process(target=_worker, args=(
      r, args.ranks, port, args.device, args.n, args.d, args.warm_runs))
           for r in range(args.ranks)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + args.timeout
  for p in procs:
    p.join(max(0.0, deadline - time.monotonic()))
  failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
  for p in procs:
    if p.is_alive():
      p.kill()
      p.join()
  if failed:
    print(f"ranks {failed} failed", file=sys.stderr)
    return 1
  print(json.dumps({"ok": True, "ranks": args.ranks}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
