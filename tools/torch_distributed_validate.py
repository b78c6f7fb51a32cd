#!/usr/bin/env python3
"""Run the port's row-sharded path and batch drivers across
torch.distributed ranks.

    python3 tools/torch_distributed_validate.py [--ranks 4]
    python3 tools/torch_distributed_validate.py --ranks 4 --device cuda \
        --n 20480 --d 256 --warm-runs 2 --batch 64 --batch-n 1024

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
    (N, N) matrix;
  * the batch leg (as the JAX package's ``benchmarks/multihost_validate.py``
    runs its DP step across processes): ``cluster_batch`` (Auto, and
    SubspaceIteration and, on the first world + 1 utterances, HostGeneral),
    ``cluster_batch_streamed`` (chunk 4, window 2) and
    ``cluster_batch_autotuned`` (a two-level search with constraints) on a
    mesh of the world's ranks, ``--batch`` ragged utterances of up to
    ``--batch-n`` rows (the default 7 does not divide 2 or 4 ranks), give
    every rank the labels of the same drivers in one process on a mesh of
    as many shards on the rank's device; with 4 ranks also on a (2, 2)
    mesh; a rank that passes other utterances makes every rank raise.

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


def _batch_leg(rank: int, world: int, dev, d: int, batch: int, batch_n: int,
               warm_runs: int, sync) -> dict:
  """The batch drivers on a mesh of the world's ranks against the same
  drivers with as many shards in this process."""
  import numpy as np
  import torch

  from spectralcluster_tpu_torch import configs, pipeline
  from spectralcluster_tpu_torch import types as types_lib
  from spectralcluster_tpu_torch.autotune import AutoTune
  from spectralcluster_tpu_torch.fixtures import make_batch
  from spectralcluster_tpu_torch.parallel import batch as batch_lib
  from spectralcluster_tpu_torch.parallel import mesh as mesh_lib

  full, _ = make_batch(batch, batch_n, d)
  # Ragged: utterance i loses (i % 4) eighths of its rows.
  utts = [u[:batch_n - (i % 4) * (batch_n // 8)] for i, u in enumerate(full)]
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options().replace(
          gaussian_blur_sigma=0),
      min_clusters=2, max_clusters=4, custom_dist="cosine", max_iter=30)
  t2d_cfg = pipeline.PipelineConfig(
      refinement_options=configs.turntodiarize_refinement_options(),
      constraint_options=configs.turntodiarize_constraint_options(),
      laplacian_type=types_lib.LaplacianType.GraphCut, min_clusters=1,
      max_clusters=5, row_wise_renorm=True, custom_dist="cosine")
  cms = []
  for u in utts:
    cm = np.zeros((u.shape[0],) * 2, np.float32)
    for j in range(u.shape[0] - 1):
      cm[j, j + 1] = cm[j + 1, j] = 1.0 if j % 3 else -1.0
    cms.append(cm)

  def autotune():
    return AutoTune(p_percentile_min=0.60, p_percentile_max=0.95,
                    init_search_step=0.05, search_level=2)

  subspace_cfg = cfg.replace(
      eigensolver=types_lib.EigenSolver.SubspaceIteration)
  general_cfg = cfg.replace(eigensolver=types_lib.EigenSolver.HostGeneral)
  drivers = {
      "cluster_batch": lambda mesh: batch_lib.cluster_batch(
          utts, cfg, mesh, seed=3),
      # The batched step's other two eigensolvers; HostGeneral's host eig
      # on world + 1 utterances only (uneven shards still).
      "cluster_batch_subspace": lambda mesh: batch_lib.cluster_batch(
          utts, subspace_cfg, mesh),
      "cluster_batch_host_general": lambda mesh: batch_lib.cluster_batch(
          utts[:world + 1], general_cfg, mesh),
      "cluster_batch_streamed": lambda mesh: batch_lib.cluster_batch_streamed(
          utts, cfg, mesh, chunk=4, window=2),
      "cluster_batch_autotuned": lambda mesh:
          batch_lib.cluster_batch_autotuned(
              utts, t2d_cfg, autotune(), mesh, constraint_matrices=cms),
  }
  ranked = mesh_lib.make_mesh(dp=world, mp=1)
  local = mesh_lib.make_mesh(dp=world, mp=1, devices=[dev] * world)

  def equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))

  def timed(fn, mesh):
    sync()
    t0 = time.perf_counter()
    fn(mesh)
    sync()
    return time.perf_counter() - t0

  out = {"batch": batch, "batch_n": batch_n}
  for name, fn in drivers.items():
    got, want = fn(ranked), fn(local)
    assert equal(got, want), name
    out[name] = {"batch_equal_single_process": True}
    if warm_runs:
      out[name]["distributed_warm_s"] = [timed(fn, ranked)
                                         for _ in range(warm_runs)]
      out[name]["in_process_warm_s"] = [timed(fn, local)
                                        for _ in range(warm_runs)]
  if world == 4:
    grid = mesh_lib.make_mesh(dp=2, mp=2)
    got = drivers["cluster_batch"](grid)
    want = drivers["cluster_batch"](
        mesh_lib.make_mesh(dp=2, mp=1, devices=[dev] * 2))
    assert equal(got, want)
    out["grid_2x2_batch_equal_single_process"] = True
  try:
    batch_lib.cluster_batch(utts[:-1] if rank == 0 else utts, cfg, ranked)
    raise RuntimeError("ranks with other utterances were not caught")
  except ValueError:
    out["batch_mismatch_caught"] = True
  torch.distributed.barrier()
  return out


def _worker(rank: int, world: int, port: int, device: str, n: int, d: int,
            warm_runs: int, batch: int, batch_n: int) -> None:
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
  report["batch_leg"] = _batch_leg(rank, world, dev, d, batch, batch_n,
                                   warm_runs, sync)
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
  parser.add_argument("--batch", type=int, default=7,
                      help="utterances of the batch leg; the default does "
                           "not divide 2 or 4")
  parser.add_argument("--batch-n", type=int, default=32,
                      help="rows of the longest utterance of the batch leg")
  parser.add_argument("--timeout", type=float, default=100.0,
                      help="seconds until unfinished ranks are killed")
  args = parser.parse_args()
  port = _free_port()
  ctx = multiprocessing.get_context("spawn")
  procs = [ctx.Process(target=_worker, args=(
      r, args.ranks, port, args.device, args.n, args.d, args.warm_runs,
      args.batch, args.batch_n))
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
