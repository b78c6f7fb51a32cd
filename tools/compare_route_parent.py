#!/usr/bin/env python3
"""Time the predict legs that the subspace solver's arithmetic reaches, on
this checkout and on an earlier one, in turns on one card.

Run from the root of a checkout on a machine with a CUDA card, giving the
root of the earlier checkout (for example `git archive <commit>` unpacked
into a directory that .gitignore lists):

    python3 tools/compare_route_parent.py --parent DIR [--order pccp]
                                          [--warm-runs 5] [--big-warm-runs 3]
                                          [--batch-warm-runs 3] [--out FILE]

Both trees build their kernels first, side by side. Then each turn of
--order (p: the --parent tree, c: this checkout) is a process of its own
that imports `spectralcluster_tpu_torch` from that tree and runs, with
the icassp2018 settings that `chip_smoke.py` uses:

  * Auto and SubspaceIteration `predict_with_details` on
    `make_embeddings(10240)` (stage timings on; one cold run, --warm-runs
    warm): each warm run's wall and stage seconds (`staged_prep`,
    `staged_dc` or `staged_subspace`, `staged_finish`) and their medians,
    the iterations of each subspace solve and the rounds of each Lloyd
    loop of the warm runs; then Auto the same way on
    `make_embeddings(20480)` with --big-warm-runs warm runs;
  * `cluster_batch` with SubspaceIteration on `make_batch(16)` (16 x 1024;
    one cold call, --batch-warm-runs warm): walls and median, the
    iterations of the batched subspace solve and the Lloyd rounds of each
    utterance, from the last warm call.

Iterations and rounds are the counts `ops.eigen.topk_eigh_subspace` and
`ops.kmeans._lloyd` return on the card; they are read after each timed
call ends, so counting adds no host read inside a call. Every turn's
labels are compared with the first turn's of the same tree and with the
other tree's. One JSON line per leg and turn, then a summary line, then
the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 10240
N_BIG = 20480
BATCH = 16


def worker(tree: str, warm_runs: int, big_warm_runs: int,
           batch_warm_runs: int) -> list:
  """One turn: the legs on the package of ``tree``; returns JSON rows."""
  sys.path.insert(0, tree)
  import numpy as np
  import torch

  from spectralcluster_tpu_torch import configs, pipeline
  from spectralcluster_tpu_torch.fixtures import make_batch, make_embeddings
  from spectralcluster_tpu_torch.ops import eigen as eigen_ops
  from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops
  from spectralcluster_tpu_torch.parallel import batch as batch_lib
  from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
  from spectralcluster_tpu_torch.types import EigenSolver

  import spectralcluster_tpu_torch
  if not os.path.abspath(spectralcluster_tpu_torch.__file__).startswith(
      os.path.abspath(tree) + os.sep):
    raise SystemExit(f"imported {spectralcluster_tpu_torch.__file__}, "
                     f"not the package of {tree}")
  iters, rounds = [], []
  solve, lloyd = eigen_ops.topk_eigh_subspace, kmeans_ops._lloyd

  def counted_solve(*a, **kw):
    if kw.get("stats") is None:
      kw["stats"] = {}
    out = solve(*a, **kw)
    iters.append(kw["stats"])
    return out

  def counted_lloyd(*a, **kw):
    out = lloyd(*a, **kw)
    rounds.append(out[2])
    return out

  eigen_ops.topk_eigh_subspace = counted_solve
  kmeans_ops._lloyd = counted_lloyd

  def counts():
    got = ([np.asarray(torch.as_tensor(s["iters"]).cpu()).tolist()
            for s in iters],
           [np.asarray(r.cpu()).tolist() for r in rounds])
    del iters[:], rounds[:]
    return got

  def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0

  rows = []
  embs = {N: make_embeddings(N), N_BIG: make_embeddings(N_BIG)}
  for solver, n, runs in ((EigenSolver.Auto, N, warm_runs),
                          (EigenSolver.SubspaceIteration, N, warm_runs),
                          (EigenSolver.Auto, N_BIG, big_warm_runs)):
    emb = embs[n]
    clusterer = configs.make_icassp2018_clusterer(
        eigensolver=solver, staged_stage_timings=True)
    timed(lambda: clusterer.predict_with_details(emb))
    counts()
    walls, stages = [], {}
    for _ in range(runs):
      result, seconds = timed(lambda: clusterer.predict_with_details(emb))
      walls.append(seconds)
      for k, v in result.timings.items():
        if k.startswith("staged_"):
          stages.setdefault(k, []).append(v)
    solve_iters, lloyd_rounds = counts()
    rows.append({
        "leg": solver.name + ("" if n == N else f"_{n}"), "n": n,
        "warm_wall_s": statistics.median(walls),
        "warm_wall_s_runs": walls,
        "stages_median_s": {k: statistics.median(v)
                            for k, v in stages.items()},
        "stages_s_runs": stages,
        "subspace_iters": solve_iters, "lloyd_rounds": lloyd_rounds,
        "labels": np.asarray(result.labels).tolist()})
  utts, _ = make_batch(BATCH)
  mesh = mesh_lib.make_mesh()
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300,
      eigensolver=EigenSolver.SubspaceIteration)
  timed(lambda: batch_lib.cluster_batch(utts, cfg, mesh))
  walls = []
  for _ in range(batch_warm_runs):
    counts()
    labels, seconds = timed(lambda: batch_lib.cluster_batch(utts, cfg, mesh))
    walls.append(seconds)
  solve_iters, lloyd_rounds = counts()
  rows.append({
      "leg": "batch_subspace", "batch": BATCH, "n": 1024,
      "warm_wall_s": statistics.median(walls), "warm_wall_s_runs": walls,
      "subspace_iters": solve_iters, "lloyd_rounds": lloyd_rounds,
      "labels": [np.asarray(x).tolist() for x in labels]})
  return rows


def build(tree: str) -> float:
  t0 = time.perf_counter()
  subprocess.run(
      [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
       "from spectralcluster_tpu_torch.kernels import build; build.build()",
       tree], check=True, cwd=tree)
  return time.perf_counter() - t0


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--parent", required=True)
  parser.add_argument("--order", default="pccp")
  parser.add_argument("--warm-runs", type=int, default=5)
  parser.add_argument("--big-warm-runs", type=int, default=3)
  parser.add_argument("--batch-warm-runs", type=int, default=3)
  parser.add_argument("--out")
  parser.add_argument("--worker", help=argparse.SUPPRESS)
  args = parser.parse_args()
  if args.worker:
    print(json.dumps(worker(args.worker, args.warm_runs, args.big_warm_runs,
                            args.batch_warm_runs)))
    return 0
  import torch
  if not torch.cuda.is_available():
    print("compare_route_parent: no CUDA device", file=sys.stderr)
    return 2
  trees = {"p": os.path.abspath(args.parent), "c": ROOT}
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    built = dict(zip(trees, pool.map(build, trees.values())))
  print(json.dumps({"phase": "build", "seconds": built}), flush=True)
  lines, first = [], {}
  for turn, who in enumerate(args.order):
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--parent", args.parent,
         "--worker", trees[who], "--warm-runs", str(args.warm_runs),
         "--big-warm-runs", str(args.big_warm_runs),
         "--batch-warm-runs", str(args.batch_warm_runs)],
        check=True, capture_output=True, text=True, cwd=trees[who])
    for row in json.loads(out.stdout.strip().splitlines()[-1]):
      key = row["leg"]
      labels = row.pop("labels")
      first.setdefault((who, key), labels)
      other = first.get(("c" if who == "p" else "p", key))
      row.update(turn=turn, tree=who,
                 labels_equal_first_turn=labels == first[(who, key)],
                 labels_equal_other_tree=(None if other is None
                                          else labels == other))
      lines.append(row)
      print(json.dumps(row), flush=True)
  summary = {}
  for row in lines:
    legs = summary.setdefault(row["leg"], {})
    legs.setdefault(row["tree"], []).append(row["warm_wall_s"])
    for k, v in row.get("stages_s_runs", {}).items():
      legs.setdefault(f"{row['tree']} {k}", []).extend(v)
  summary = {leg: {k: statistics.median(v) for k, v in legs.items()}
             for leg, legs in summary.items()}
  ok = all(r["labels_equal_first_turn"] and r["labels_equal_other_tree"]
           is not False for r in lines)
  print(json.dumps({"phase": "summary", "median_s": summary,
                    "labels_equal": ok}), flush=True)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  print(smi, flush=True)
  if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
      json.dump({"rows": lines, "summary": summary, "smi": smi}, f, indent=1)
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
