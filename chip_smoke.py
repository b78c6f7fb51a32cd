#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. device — the card's name and power limit (nvidia-smi);
  2. build — compiles csrc/fused.cu with nvcc at first use; prints ptxas's
     registers, static shared memory and spill bytes per kernel, and the
     blocks resident per SM of the affinity, row_max and crop_diagonal;
  3. kernels — each hand-written kernel against its plain PyTorch twin on the
     card, at the main path's shapes (N=10240, d=256; kernel 5 on the
     Diffuse output, its input on the HostGeneral path) and at a ragged
     N=1000 with n_valid=937 on a matrix with negative entries; kernels 2-5
     must agree bit for bit, the affinity within rtol=1e-5, atol=1e-6 (its
     float32 sums run in another order) and equal to its transpose bit for
     bit. Then times (CUDA events around 10 calls back to back behind one
     untimed call, median of 20 such means after warm-up) of each kernel,
     its twin and a one-call library yardstick where one exists (the
     affinity's `addmm` timed with the row normalization, as the kernel's
     wrapper is), beside the card's bound for the same work (the
     affinity's as the symmetric least work, N(N+1)/2 dot products), and of
     the main path's other device stages (blur, Diffuse, full eigh, top-k
     subspace);
  3b. the exact top-k route's parts, each alone, on the icassp2018 Auto
     operand at N=10240 and 20480: the certified route (accepted or
     declined, its iterations, res, scale, est_next against w_t), the
     completeness probe, the full eigh (the yardstick), and the sign-chain
     split: at 10240 forced (try_iterative_first=False) at "highest" (IEEE
     float32) and at "high" (3×TF32), its eigenvalues within 2e-4·scale of
     the certified route's; at 20480 the natural decline, its eigenvalues
     within 2e-4·scale of the full eigh's top t. Each split prints its
     levels (branch, k_f, k_pad, k_eff, residuals), the host seconds of
     prep, each sign step (with its TFLOP/s against the card's float32 and
     TF32 peaks), projection, Ritz and remainder, and its peak memory
     beside the predicted one;
  4. paths — make_icassp2018_clusterer(...).predict on make_embeddings(N),
     labels held against benchmarks/reference_labels.npz at N=512, 2048 and
     the leg's N, with launch counts zeroed after the cold run and read
     after the warm runs (the comparison launches of phase 3 do not count);
     each leg fails if a kernel of its path did not launch:
       * Auto and SubspaceIteration at N=10240 (one cold run, WARM_RUNS
         warm): kernels 1-4 (RowWiseNormalize is absorbed into the eigh
         similarity transform there). Auto runs the exact top-k route
         (ops/dc.py, stage staged_dc); each Auto leg prints the route its
         dc solve took and fails on a certified residual above 1e-5;
       * Auto at N=20480 (labels_20480; its dc route must decline to the
         split), and at N=10240 on make_embeddings_k(N, k) for k=4 and k=7
         (benchmarks/reference_labels_multi.npz), one cold run and one
         warm; then Auto at N=10240 with the dc route forced to decline,
         on make_embeddings(N) and make_embeddings_k(N, 4): the split
         only, the same labels, eigenvalues within 2e-4·scale of the
         certified legs';
       * HostGeneral at N=4096 (one cold run, one warm): all five kernels;
         its host LAPACK eig is reported apart from the device stages. N is
         cut from 10240 because the float64 general eig is O(N^3) on the
         host;
       * the host API at N=10240, post_eigen_cluster_function=run_kmeans
         (one cold run, two warm): the host flow with eig_topk_staged,
         kernels 1-4.
  5. Turn-to-Diarize — first each stage alone at N=10240 on
     make_t2d_fixture(N): one E2CP (with its steps and residuals), one
     Percentile threshold (row sort and quantile), kernel 4's T2D form on
     the constrained affinity against its twin (bit for bit) and timed
     beside its RowMax/Max form, and one ascending top-k subspace iteration
     on the GraphCut operand. Then make_turntodiarize_clusterer().predict(x,
     ConstraintMatrix(scores, threshold=1).compute_diagonals()), a fresh
     clusterer per predict (AutoTune narrows its own range), labels held
     against benchmarks/reference_labels_t2d.npz at N=256, 1024, 2048 and
     10240 (one cold run, T2D_WARM_RUNS warm); the affinity must launch
     once and kernel 4 once per AutoTune candidate (11).
  6. streaming — MultiStageClusterer over make_stream(1500) (the JAX
     streaming bench's stream and main clusterer; L=50, U1=100, U2=600),
     once without deflicker and once with the Hungarian deflicker: each
     history recorded in tests/data/reference_streaming.npz (steps 1, 50,
     51, 100, 101, 600, 601, 1100, 1101, 1500) must be equal after
     enforce_ordered_labels, as must the final compression chain; 2
     compressions; the history covers all 1500 steps; kernels 1-4 must
     launch. Prints steps/s per window and, from a torch.profiler trace of
     ten more steps, the device's idle share. The AHC pre-clustering must
     run the native C++ chain (``ahc.backend() == "native"``, built with
     g++ at first use); each stream prints the host split of its steps past
     U1 (AHC seconds against predict seconds), and the pre-cluster AHC of
     600 stream rows is timed alone with each backend (labels equal).
  7. batch — parallel/batch.py at the JAX batch bench's shape
     (benchmarks/bench_batch.py: make_batch(16), N=1024, d=256, 2-4
     block-ordered speakers; icassp2018, min 2 / max 7, cosine, max_iter
     300, Auto): cluster_batch once cold and BATCH_WARM_RUNS warm, labels
     held against tests/data/reference_batch.npz (the JAX package's
     cluster_batch, recorded by tools/record_batch_reference.py) after
     enforce_ordered_labels, with id-for-id equality and gt_match
     reported; kernels 1-4 must launch 16/32/16/16 times per warm call.
     Then the loop's stages alone per utterance (affinity and refinement,
     eigh, K-Means), card synced around each. Then cluster_batch_streamed
     over make_batch(STREAMED_BATCH) with chunk=64, window=4 in float32:
     its first two chunks must equal cluster_batch on those chunks with
     seed=lo, its first 16 the reference; gt_match, utterances/s and, from
     a torch.profiler trace (card activity only) of one more full chunk,
     the device's idle share, with the trace's stop and summary timed
     apart; then one bf16-transfer pass
     over the first STREAMED_BF16 utterances (gt_match printed beside the
     float32 one, ungated). Then cluster_batch_autotuned with the Turn-to-Diarize
     template on 4 x make_t2d_fixture(1024) with its constraints: labels
     held against the reference file; kernel 4 (T2D form) must launch once
     per AutoTune candidate per utterance; equality with
     benchmarks/reference_labels_t2d.npz and with the port's
     SpectralClusterer is printed, ungated.
  8. sharded — parallel/sharded.py's cluster_large_sharded on
     make_embeddings(20480) with the icassp2018 PipelineConfig (min 2 /
     max 7, cosine, max_iter 300): (a) initialize_distributed joins an NCCL
     world of one rank, make_mesh() names it, one cold run and two warm;
     (b) SHARDS=4 shards in one process on the card (NCCL refuses two
     ranks on one card), the all-gather and the ring affinity, one cold
     run and one warm each: labels equal (a)'s and labels_20480, Ritz
     values within SHARDED_EIG_RTOL of (a)'s; (c) the 4 stripes of the
     refinement operand against the single-device operand on N=20477 (3
     pad rows): bit for bit before Diffuse, within OPERAND_RTOL after; then
     cluster_large_sharded on those 20477 rows at P=4 and P=1: labels and
     n_clusters equal; (d) check_ring_order and check_replica_consistency
     on both meshes (a per-shard value must be caught), and debug_nans
     around one run at N=2048; (e) no kernel launches in the phase. Each
     run prints n_clusters, subspace iterations, the final residual, the
     peak memory and the host seconds per stage, card synced.
  Each phase prints the seconds elapsed at its end. Together about 10
  minutes on one H100, most of it the host eig, the host side of the
  streams and the streamed batch (Lloyd's rounds, each read on the host).

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

N_MAIN = 10240
D_MAIN = 256
N_RAGGED = 1000
NV_RAGGED = 937
P_ROWMAX = 0.95
REPS = 20
EVENT_BATCH = 10
WARM_RUNS = 5
N_GENERAL = 4096
GENERAL_WARM_RUNS = 1
API_WARM_RUNS = 2
T2D_WARM_RUNS = 2
N_BIG = 20480
DC_REPS = 3           # the certified route alone: one cold run, two timed
MULTI_KS = (4, 7)
STREAM_STEPS = 1500
STREAM_WINDOWS = ((1, 50), (51, 100), (101, 600), (601, 1100), (1101, 1500))
STREAM_L, STREAM_U1, STREAM_U2 = 50, 100, 600
PROFILED_STEPS = 10
T2D_P = 0.785  # the p the JAX bench's AutoTune picked at every size
N_BATCH = 1024                 # benchmarks/bench_batch.py's shape
BATCH = 16
BATCH_WARM_RUNS = 3
STREAMED_BATCH = 1024          # BASELINE.md's 1024-utterance scale
STREAMED_CHUNK, STREAMED_WINDOW = 64, 4
STREAMED_BF16 = 256            # the bf16-transfer pass: its first utterances
T2D_BATCH = 4
AHC_ROWS = 600                 # the stream's U2: the largest pre-cluster
SHARDS = 4                     # in-process shards of the row-sharded phase
N_SHARDED_PAD = 20477          # N_SHARDED_PAD % SHARDS == 1: 3 pad rows
N_NAN_TRAP = 2048
# Ritz values at P=4 against P=1, as a share of max|w|: the float32 bound
# of an N-term dot product, N·2^-24 ~ 1.2e-3 at N=20480. The operands are
# equal bit for bit; the panel products and Grams sum in another order.
SHARDED_EIG_RTOL = 1e-3
OPERAND_RTOL = 1e-5            # the stripes' operand after Diffuse, of max|m|

# (HBM bytes/s, float32 FLOP/s on the CUDA cores, dense TF32 FLOP/s on the
# tensor cores), NVIDIA data sheets.
_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 378e12),
    ("H100 NVL", 3.9e12, 60e12, 418e12),
    ("H200", 4.8e12, 67e12, 495e12),
    ("H100", 3.35e12, 67e12, 495e12),   # SXM: "NVIDIA H100 80GB HBM3"
)

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
  print(*a, flush=True)


def card_peaks(name: str):
  for key, *peaks in _PEAKS:
    if key in name:
      return peaks
  raise RuntimeError(f"no data-sheet peaks for card {name!r}")


def time_ms(torch, fn, reps=REPS, batch=EVENT_BATCH, warmup=3) -> float:
  """Median over `reps` of the mean card time of one call.

  Each rep is `batch` calls back to back between two CUDA events, after one
  untimed call that keeps the card busy meanwhile, so the host enqueues
  ahead of the card as it does on the main path, and the time is the
  card's, not the host's launch overhead (one call per event pair counts
  that overhead whenever it exceeds the kernel's own time).
  """
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()  # keeps the card busy while the host enqueues the timed calls
    start.record()
    for _ in range(batch):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / batch)
  return statistics.median(times)


def sharded_phase(torch, np, dev, want_big, log) -> dict:
  """8. The row-sharded path (parallel/sharded.py) at N_BIG, icassp2018.

  (a) an NCCL world of one rank (initialize_distributed, make_mesh()):
  one cold run, two warm; (b) SHARDS shards in one process on the card,
  the all-gather and the ring affinity, one cold run and one warm each;
  (c) N_SHARDED_PAD rows (3 pad rows at SHARDS) against the NCCL world's
  one shard, after the refinement operand's SHARDS stripes are held
  against the single-device operand on that input (``operand_check``);
  (d) check_ring_order and check_replica_consistency on both meshes, and
  debug_nans around one sharded run at N_NAN_TRAP. Labels must equal
  ``want_big`` after enforce_ordered_labels, and (b)'s Ritz values (a)'s
  within SHARDED_EIG_RTOL of max|w|. Raises SystemExit on a failed gate.
  The caller reads the kernel launch counts around it.
  """
  import socket

  import torch.distributed as dist

  from spectralcluster_tpu_torch import configs, observability, pipeline
  from spectralcluster_tpu_torch import utils
  from spectralcluster_tpu_torch.fixtures import make_embeddings
  from spectralcluster_tpu_torch.ops import affinity as affinity_ops
  from spectralcluster_tpu_torch.ops import refinement as refinement_ops
  from spectralcluster_tpu_torch.parallel import collectives
  from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
  from spectralcluster_tpu_torch.parallel import sanity, sharded, stripes
  from spectralcluster_tpu_torch.precision import fp32_precision

  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300)

  def ordered(labels):
    return utils.enforce_ordered_labels(np.asarray(labels))

  def run(x, mesh, use_ring=False):
    timings = observability.StageTimings(dev)
    info = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    labels, n_clusters = sharded.cluster_large_sharded(
        x, cfg, mesh, use_ring_affinity=use_ring, timings=timings, info=info)
    wall = time.perf_counter() - t0
    return labels, {
        "wall_s": wall, "stages_s": timings.as_dict(),
        "n_clusters": n_clusters, "shards": info["shards"],
        "n_pad": info["n_pad"], "subspace_iters": info["iters"],
        "residual": info["residual"],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "eigenvalues": info["eigenvalues"].tolist()}

  def operand_check(x, mesh):
    """The stripes of the refinement operand against the single-device
    ``pipeline._symmetric_eig_operand`` on the same padded affinity: bit
    for bit before Diffuse, within OPERAND_RTOL of max|m| after it."""
    n = x.shape[0]
    n_pad = -(-n // SHARDS) * SHARDS
    xp = torch.zeros((n_pad, x.shape[1]), device=dev)
    xp[:n] = torch.as_tensor(x).to(dev)
    plain = cfg.replace(use_kernels=False)
    seq = tuple(cfg.refinement_options.refinement_sequence)
    layout = stripes.Layout(collectives.model_group(mesh), n_pad, n)
    with fp32_precision():
      aff = refinement_ops.mask_padding(
          affinity_ops.compute_affinity_matrix(xp), n)
      parts = list(torch.split(aff, n_pad // SHARDS))
      want = refinement_ops.apply_refinement_sequence(
          aff, cfg.refinement_options, sequence=seq[:4], n_valid=n)
      got = stripes.apply_refinement_sequence(
          layout, parts, cfg.refinement_options, seq[:4])
      pre_equal = all(torch.equal(g, w) for g, w in zip(
          got, torch.split(want, n_pad // SHARDS)))
      del got, want
      want_m, _ = pipeline._symmetric_eig_operand(
          aff, plain, None, n, refinement_ops.ROWNORM_TAIL)
      got_m, _ = stripes.symmetric_eig_operand(
          layout, parts, plain, refinement_ops.ROWNORM_TAIL, True)
      err = max(float(torch.max(torch.abs(g - w))) for g, w in zip(
          got_m, torch.split(want_m, n_pad // SHARDS)))
      err /= float(torch.max(torch.abs(want_m)))
    del aff, parts, want_m, got_m
    torch.cuda.empty_cache()
    row = {"n": n, "shards": SHARDS, "pre_diffuse_bit_equal": pre_equal,
           "operand_err_rel": err, "tolerance": OPERAND_RTOL}
    if not (pre_equal and err <= OPERAND_RTOL):
      raise SystemExit(f"sharded: the stripes differ from the "
                       f"single-device operand: {row}")
    return row

  out = {}
  with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
  mesh_lib.initialize_distributed(f"localhost:{port}", 1, 0)
  try:
    nccl = mesh_lib.make_mesh(dp=1, mp=1)
    in_process = mesh_lib.make_mesh(dp=1, mp=SHARDS, devices=[dev] * SHARDS)
    big = make_embeddings(N_BIG)
    runs = []
    for _ in range(3):
      labels_a, row = run(big, nccl)
      runs.append(row)
      if not np.array_equal(ordered(labels_a), want_big):
        raise SystemExit("sharded (NCCL, 1 rank): labels differ from the "
                         f"reference at N={N_BIG}")
    out["nccl_world_1"] = {"cold": runs[0], "warm": runs[1:]}
    log(json.dumps({"phase": "sharded", "leg": "nccl_world_1",
                    **out["nccl_world_1"]}))
    w_a = np.asarray(runs[-1]["eigenvalues"])
    for use_ring in (False, True):
      leg = f"in_process_{SHARDS}_" + ("ring" if use_ring else "all_gather")
      legs = []
      for _ in range(2):
        labels_b, row = run(big, in_process, use_ring)
        row["labels_equal_nccl_world_1"] = bool(np.array_equal(labels_b,
                                                               labels_a))
        row["eig_err_rel"] = float(np.max(np.abs(
            np.asarray(row["eigenvalues"]) - w_a)) / np.max(np.abs(w_a)))
        legs.append(row)
        if not np.array_equal(ordered(labels_b), want_big):
          raise SystemExit(f"sharded ({leg}): labels differ from the "
                           f"reference at N={N_BIG}")
        if row["eig_err_rel"] > SHARDED_EIG_RTOL:
          raise SystemExit(f"sharded ({leg}): Ritz values differ from one "
                           f"shard's by {row['eig_err_rel']:.3g} of max|w|")
      out[leg] = {"cold": legs[0], "warm": legs[1:]}
      log(json.dumps({"phase": "sharded", "leg": leg, **out[leg]}))
    padded = big[:N_SHARDED_PAD]
    out["stripes_vs_single_device"] = operand_check(padded, in_process)
    log(json.dumps({"phase": "sharded", "leg": "stripes_vs_single_device",
                    **out["stripes_vs_single_device"]}))
    labels_p4, row_p4 = run(padded, in_process)
    labels_p1, row_p1 = run(padded, nccl)
    out["padded"] = {"n": N_SHARDED_PAD, "p4": row_p4, "p1": row_p1,
                     "labels_equal": bool(np.array_equal(
                         ordered(labels_p4), ordered(labels_p1)))}
    log(json.dumps({"phase": "sharded", "leg": "padded", **out["padded"]}))
    if not (out["padded"]["labels_equal"]
            and row_p4["n_clusters"] == row_p1["n_clusters"]):
      raise SystemExit(f"sharded: P={SHARDS} and P=1 differ at "
                       f"N={N_SHARDED_PAD}")
    for mesh in (nccl, in_process):
      sanity.check_ring_order(mesh, "model")
      sanity.check_ring_order(mesh, "batch")
      sanity.check_replica_consistency(mesh, torch.arange(16.0))
    try:
      sanity.check_replica_consistency(
          in_process, [torch.arange(16.0) + r for r in range(SHARDS)])
      raise SystemExit("sharded: a per-shard value passed the replica check")
    except AssertionError:
      pass
    t0 = time.perf_counter()
    with sanity.debug_nans():
      labels_nan, n_nan = sharded.cluster_large_sharded(
          make_embeddings(N_NAN_TRAP), cfg, in_process)
    out["sanity"] = {"ring_order": True, "replica_consistency": True,
                     "debug_nans_n": N_NAN_TRAP,
                     "debug_nans_s": time.perf_counter() - t0,
                     "debug_nans_n_clusters": n_nan}
    log(json.dumps({"phase": "sharded", "leg": "sanity", **out["sanity"]}))
  finally:
    dist.destroy_process_group()
  return out


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--out", help="also write every result to this JSON")
  args = parser.parse_args()

  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  # IEEE float32 everywhere, the yardsticks included.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision("highest")
  sys.path.insert(0, HERE)
  import numpy as np

  from spectralcluster_tpu_torch import ahc
  from spectralcluster_tpu_torch import clusterer as clusterer_lib
  from spectralcluster_tpu_torch import (configs, constraint, observability,
                                         pipeline, streaming, utils)
  from spectralcluster_tpu_torch.fixtures import (make_batch,
                                                  make_embeddings,
                                                  make_embeddings_k,
                                                  make_stream,
                                                  make_t2d_fixture)
  from spectralcluster_tpu_torch.native import ahc_native
  from spectralcluster_tpu_torch.parallel import batch as batch_lib
  from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
  from spectralcluster_tpu_torch.kernels import build
  from spectralcluster_tpu_torch.kernels import fused
  from spectralcluster_tpu_torch.ops import dc as dc_ops
  from spectralcluster_tpu_torch.ops import eigen as eigen_ops
  from spectralcluster_tpu_torch.ops.kmeans import run_kmeans
  from spectralcluster_tpu_torch.ops import quantile as quantile_ops
  from spectralcluster_tpu_torch.ops import refinement as ref_ops
  from spectralcluster_tpu_torch.types import (Deflicker, EigenSolver,
                                               LaplacianType)

  results = {"elapsed_s": {}}
  dev = torch.device("cuda")
  t_start_run = time.perf_counter()

  def mark(phase):
    """Seconds since the start of the run, at the end of each phase."""
    results["elapsed_s"][phase] = time.perf_counter() - t_start_run
    log(json.dumps({"phase": "elapsed", "after": phase,
                    "s": results["elapsed_s"][phase]}))

  # 1. Device.
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()
  kind = torch.cuda.get_device_name(0)
  count = torch.cuda.device_count()
  bw, fp32, tf32 = card_peaks(kind)
  results["device"] = {"nvidia_smi": smi, "kind": kind, "count": count,
                       "torch": torch.__version__, "cuda": torch.version.cuda,
                       "peak_bytes_per_s": bw, "peak_fp32_flops": fp32,
                       "peak_tf32_flops": tf32}
  log(json.dumps({"phase": "device", **results["device"]}))

  # 2. Build.
  t0 = time.perf_counter()
  lib_path = build.build()
  build.load()
  build_s = time.perf_counter() - t0
  resident = {}
  for i, name in enumerate(("affinity", "row_max", "crop_diagonal")):
    blocks = ctypes.c_int(0)
    rc = build.load().sct_resident_blocks(i, ctypes.byref(blocks))
    if rc != 0:
      raise SystemExit(f"sct_resident_blocks({name}): CUDA error {rc}")
    resident[name] = blocks.value
  ptxas = build.ptxas_report(lib_path)
  results["build"] = {
      "seconds": build_s, "library": os.path.basename(lib_path),
      "ptxas": ptxas, "resident_blocks_per_sm": resident,
      # The two kernels redesigned for this card should not spill.
      "spill_bytes_affinity_row_max": sum(
          r.get("spill_stores", 0) + r.get("spill_loads", 0)
          for k, r in ptxas.items()
          if k.startswith(("affinity_kernel", "row_max_kernel")))}
  log(json.dumps({"phase": "build", **results["build"]}))

  # 3. Kernels against their twins.
  rng = np.random.RandomState(0)
  x = torch.as_tensor(make_embeddings(N_MAIN, D_MAIN)).to(dev)
  aff = fused.affinity(x)
  # The main path's inputs: crop gets the fresh affinity, row_max and
  # threshold_symmetrize get the blurred, cropped affinity.
  blurred = ref_ops.gaussian_blur(fused.crop_diagonal_plain(aff), 1.0)
  blurred = blurred.contiguous()
  ragged = torch.as_tensor(rng.randn(N_RAGGED, N_RAGGED).astype(np.float32)
                           - 0.5).to(dev)
  x_ragged = torch.as_tensor(
      rng.randn(N_RAGGED, 100).astype(np.float32)).to(dev)

  def t2d_thresholds(mat, n_valid=None, p=0.85):
    """The T2D path's Percentile thresholds (preserve_diagonal)."""
    eye = torch.eye(mat.shape[0], dtype=torch.bool, device=dev)
    a = torch.where(eye, 0.0, mat)
    if n_valid is None:
      q = quantile_ops.quantile_from_sorted(quantile_ops.sort_rows(a), p)
    else:
      q = quantile_ops.quantile_from_sorted_masked(
          quantile_ops.sort_rows_masked(a, n_valid), p, n_valid)
    return q[:, None].contiguous()

  checks = []

  def check(name, case, got, want, exact):
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(got - want)))
    ok = (err == 0.0 if exact else
          bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6)))
    checks.append({"kernel": name, "case": case, "max_abs_err": err,
                   "tolerance": "exact" if exact else "rtol=1e-5,atol=1e-6",
                   "ok": ok})
    log(json.dumps({"phase": "kernels", **checks[-1]}))

  check("affinity", f"N={N_MAIN},d={D_MAIN}", aff, fused.affinity_plain(x),
        False)
  check("affinity", f"N={N_MAIN},d={D_MAIN},against its transpose", aff,
        aff.T, True)
  aff_ragged = fused.affinity(x_ragged)
  check("affinity", f"N={N_RAGGED},d=100", aff_ragged,
        fused.affinity_plain(x_ragged), False)
  check("affinity", f"N={N_RAGGED},d=100,against its transpose", aff_ragged,
        aff_ragged.T, True)
  del aff_ragged
  check("row_max", f"N={N_MAIN}", fused.row_max(blurred),
        fused.row_max_plain(blurred), True)
  for excl in (False, True):
    check("row_max", f"N={N_RAGGED},n_valid={NV_RAGGED},exclude={excl}",
          fused.row_max(ragged, excl, NV_RAGGED),
          fused.row_max_plain(ragged, excl, NV_RAGGED), True)
  check("crop_diagonal", f"N={N_MAIN},in_place",
        fused.crop_diagonal(aff.clone(), inplace=True),
        fused.crop_diagonal_plain(aff), True)
  for inplace in (False, True):
    check("crop_diagonal",
          f"N={N_RAGGED},n_valid={NV_RAGGED},in_place={inplace}",
          fused.crop_diagonal(ragged.clone(), NV_RAGGED, inplace=inplace),
          fused.crop_diagonal_plain(ragged, NV_RAGGED), True)
  thr_main = fused.row_max(blurred) * P_ROWMAX
  thr_ragged = fused.row_max(ragged, n_valid=NV_RAGGED) * P_ROWMAX
  t2d = dict(binarize=True, preserve_diagonal=True, average=True)
  for case, mat, thr, flags in (
      (f"N={N_MAIN},RowMax/Max", blurred, thr_main, {}),
      (f"N={N_MAIN},T2D", blurred, t2d_thresholds(blurred), t2d),
      (f"N={N_RAGGED},RowMax/Max", ragged, thr_ragged, {}),
      (f"N={N_RAGGED},n_valid={NV_RAGGED},T2D", ragged,
       t2d_thresholds(ragged, NV_RAGGED), t2d)):
    check("threshold_symmetrize_general", case,
          fused.threshold_symmetrize_general(mat, thr, 0.01, **flags),
          fused.threshold_symmetrize_general_plain(mat, thr, 0.01, **flags),
          True)
  # Kernel 5's input on the HostGeneral path: the Diffuse output.
  sym = fused.threshold_symmetrize_general(blurred, thr_main, 0.01)
  diffused = ref_ops.diffuse(sym)
  check("row_wise_normalize", f"N={N_MAIN},Diffuse output",
        fused.row_wise_normalize(diffused),
        fused.row_wise_normalize_plain(diffused), True)
  check("row_wise_normalize", f"N={N_RAGGED},n_valid={NV_RAGGED}",
        fused.row_wise_normalize(ragged, NV_RAGGED),
        fused.row_wise_normalize_plain(ragged, NV_RAGGED), True)
  failed = [c for c in checks if not c["ok"]]
  if failed:
    raise SystemExit(f"kernel disagrees with its twin: {failed}")
  results["checks"] = checks

  # Times at the main path's shapes, and each kernel's bound on this card.
  n, d = N_MAIN, D_MAIN
  half = torch.full((), 0.5, device=dev)
  crop_scratch = aff.clone()

  def addmm_affinity():
    # The same footing as fused.affinity: the row normalization included.
    xn = fused.normalize_rows(x)
    return torch.addmm(half, xn, xn.T, beta=1.0, alpha=0.5)

  timed = {
      # The output is symmetric: the least work is N(N+1)/2 dot products.
      "affinity": (lambda: fused.affinity(x), lambda: fused.affinity_plain(x),
                   addmm_affinity, (n * d + n * n) * 4, n * (n + 1) * d),
      "row_max": (lambda: fused.row_max(blurred),
                  lambda: fused.row_max_plain(blurred),
                  lambda: torch.amax(blurred, dim=1, keepdim=True),
                  (n * n + n) * 4, n * n),
      "crop_diagonal": (
          lambda: fused.crop_diagonal(crop_scratch, inplace=True),
          lambda: fused.crop_diagonal_plain(aff), None,
          (n * n + n) * 4, n * n),
      "threshold_symmetrize_general": (
          lambda: fused.threshold_symmetrize_general(blurred, thr_main, 0.01),
          lambda: fused.threshold_symmetrize_general_plain(blurred, thr_main,
                                                           0.01),
          None, (2 * n * n + n) * 4, 4 * n * n),
      "row_wise_normalize": (
          lambda: fused.row_wise_normalize(diffused),
          lambda: fused.row_wise_normalize_plain(diffused), None,
          2 * n * n * 4, 2 * n * n),
  }
  # Why a kernel has no one-call library yardstick.
  no_library = {
      "crop_diagonal": "no single PyTorch call: a row max, then a diagonal "
                       "write",
      "threshold_symmetrize_general": "no single PyTorch call: thresholding "
                                      "and the symmetrize are several calls",
      "row_wise_normalize": "no single PyTorch call: amax, then a division",
  }
  times = {}
  with torch.no_grad():
    for name, (kern, plain, library, nbytes, nops) in timed.items():
      bytes_ms = nbytes / bw * 1e3
      ops_ms = nops / fp32 * 1e3
      times[name] = {
          "ms": time_ms(torch, kern),
          "plain_ms": time_ms(torch, plain),
          "library_ms": time_ms(torch, library) if library else None,
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      }
      log(json.dumps({"phase": "timing", "kernel": name, **times[name]}))

  # Where the main path's time goes: its other device stages at N_MAIN,
  # each timed alone on the same inputs the pipeline gives it.
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7)
  del diffused
  m, _ = pipeline._symmetric_eig_operand(aff.clone(), cfg, None, None,
                                         ref_ops.ROWNORM_TAIL)

  def subspace():
    return eigen_ops.topk_eigh_subspace(
        m, 8, torch.Generator().manual_seed(42), num_iters=24,
        residual_tol=2e-3, max_iters=384, drift_tol=1e-4)

  breakdown = {
      "gaussian_blur": lambda: ref_ops.gaussian_blur(aff, 1.0),
      "diffuse": lambda: ref_ops.diffuse(sym),
      "full_eigh": lambda: torch.linalg.eigh(m),
      "subspace_topk": subspace,
  }
  results["breakdown_ms"] = {}
  with torch.no_grad():
    for name, fn in breakdown.items():
      results["breakdown_ms"][name] = time_ms(torch, fn, reps=3, batch=1,
                                              warmup=1)
  log(json.dumps({"phase": "breakdown_ms", **results["breakdown_ms"]}))
  mark("kernels")
  del crop_scratch, blurred, ragged, aff, sym

  # 3b. The exact top-k route's parts, each alone, on the Auto operand.
  t_dc = cfg.max_clusters + 1

  def host_s(fn):
    """Host seconds of a host-orchestrated routine, card synced around."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out

  def dc_generator():
    return torch.Generator().manual_seed(pipeline._DC_SEED)

  # Float32 (N, N) buffers the split holds at its peak, the operand m
  # included: at "high" the quintic step's product x·poly (x, poly, the
  # product and both operands' TF32 halves); else the symmetrization of a
  # step's product (x, the product, its sum with its transpose, the half).
  def split_buffers(precision):
    return 8 if precision == "high" else 5

  def split_row(info, n, precision, seconds, res, scale):
    """The split's levels: branch, sizes, residuals, host seconds per stage
    and each sign step's ms and TFLOP/s (3 products of 2n³ per quintic
    step, 2 per cubic one; "high" runs each as three TF32 products)."""
    levels = []
    for lv in info["levels"]:
      steps = []
      for kind, s in zip(lv.get("sign_steps", ()),
                         lv["seconds"].get("sign_steps", ())):
        flops = (3 if kind == "quintic" else 2) * 2.0 * lv["n"] ** 3
        step = {"kind": kind, "ms": s * 1e3, "tflops": flops / s / 1e12}
        if precision == "highest":
          step["share_of_fp32_peak"] = flops / s / fp32
        else:
          passes = 3 if precision == "high" else 1
          step["tf32_tflops"] = passes * flops / s / 1e12
          step["share_of_tf32_peak"] = passes * flops / s / tf32
        steps.append(step)
      stages = {k: v for k, v in lv["seconds"].items() if k != "sign_steps"}
      stages["sign_chain"] = sum(lv["seconds"].get("sign_steps", ()))
      levels.append({**{k: v for k, v in lv.items() if k != "seconds"},
                     "seconds": stages, "steps": steps})
    return {"precision": precision, "seconds": seconds, "res": res,
            "scale": scale, "levels": levels,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "predicted_peak_mem_gb": split_buffers(precision) * n * n * 4 / 1e9}

  def run_split(m, n, **kw):
    torch.cuda.reset_peak_memory_stats()
    info = {}
    seconds, (w, _, res, scale) = host_s(lambda: dc_ops.eigh_topk_dc(
        m, t_dc, dc_generator(), max_block=cfg.dc_max_block, info=info,
        _n_bucket=utils.pad_bucket(n), **kw))
    if info["route"] != "split":
      raise SystemExit(f"dc at N={n} {kw}: took {info['route']}, not the "
                       "split")
    return w, split_row(info, n, info["sign_precision"], seconds, res, scale)

  def dc_breakdown(m, n, forced_split):
    row = {"phase": "dc_breakdown", "n": n}
    runs = []
    for _ in range(DC_REPS):
      info = {}
      seconds, out = host_s(lambda: dc_ops._certified_iterative_topt(
          m, t_dc, dc_generator(), True, None, info))
      runs.append(seconds)
    row["certified"] = {
        "accepted": out is not None, **info, "seconds_cold": runs[0],
        "seconds": statistics.median(runs[1:])}
    if out is not None and not out[2] <= 1e-5:
      raise SystemExit(f"dc route at N={n}: certified residual {out[2]}")
    eigh_s, (w_all, u_all) = host_s(lambda: torch.linalg.eigh(m))
    row["full_eigh_seconds"] = eigh_s
    # The probe alone, on the t extreme pairs of the full eigh (its cost
    # does not depend on which pairs it is given).
    w_top = torch.flip(w_all, (0,))[:t_dc].contiguous()
    u_top = torch.flip(u_all, (1,))[:, :t_dc].contiguous()
    del w_all, u_all
    b = float(torch.amax(torch.sum(torch.abs(m), dim=1))) + 1.0
    probe_runs = [host_s(lambda: dc_ops._probe_next(
        m, u_top, w_top, None, b, dc_generator(), True)) for _ in range(3)]
    row["probe"] = {"seconds": statistics.median(p[0] for p in probe_runs),
                    "est_next": probe_runs[-1][1][0],
                    "norm_lo": probe_runs[-1][1][1]}
    if forced_split:
      # The split alone at both precisions, held to the certified route.
      if out is None:
        raise SystemExit(f"dc route at N={n}: the certified route declined")
      row["split"] = []
      for precision in ("highest", "high"):
        w, split = run_split(m, n, try_iterative_first=False,
                             sign_precision=precision)
        split["max_abs_diff_vs_certified"] = err = float(
            torch.max(torch.abs(w - out[0])))
        row["split"].append(split)
        log(json.dumps({"phase": "dc_split", "n": n, **split}))
        if not err <= 2e-4 * out[3]:
          raise SystemExit(f"split at N={n}, {precision}: eigenvalues differ "
                           f"from the certified route's by {err}")
    else:
      # The natural decline (the certified route declines first), held to
      # the full eigh's top t.
      w, split = run_split(m, n)
      split["max_abs_diff_vs_eigh"] = err = float(
          torch.max(torch.abs(w - w_top)))
      row["split"] = [split]
      log(json.dumps({"phase": "dc_split", "n": n, **split}))
      if not err <= 2e-4 * split["scale"]:
        raise SystemExit(f"split at N={n}: eigenvalues differ from the "
                         f"full eigh's by {err}")
    del w_top, u_top
    log(json.dumps({k: v for k, v in row.items() if k != "split"}))
    return row

  results["dc_breakdown"] = [dc_breakdown(m, N_MAIN, forced_split=True)]
  del m
  aff = fused.affinity(torch.as_tensor(make_embeddings(N_BIG, D_MAIN)).to(dev))
  m, _ = pipeline._symmetric_eig_operand(aff, cfg, None, None,
                                         ref_ops.ROWNORM_TAIL,
                                         consume_input=True)
  del aff
  results["dc_breakdown"].append(dc_breakdown(m, N_BIG, forced_split=False))
  del m
  torch.cuda.empty_cache()
  mark("dc_breakdown")

  # 4. Paths: each leg's launch counts are zeroed after its cold run and
  # read after its warm runs.
  ref = np.load(os.path.join(HERE, "benchmarks", "reference_labels.npz"))
  ref_multi = np.load(os.path.join(HERE, "benchmarks",
                                   "reference_labels_multi.npz"))
  main_kernels = ("affinity", "row_max", "crop_diagonal",
                  "threshold_symmetrize_general")
  # Every dc solve of the pipeline reports its route here; a leg may force
  # the route to decline.
  dc_infos = []
  dc_force = {"decline": False}
  solve_dc = dc_ops.eigh_topk_dc

  def recording_dc(*a, **kw):
    info = {}
    if dc_force["decline"]:
      kw["try_iterative_first"] = False
    out = solve_dc(*a, info=info, **kw)
    dc_infos.append({**info, "res_returned": out[2], "scale": out[3]})
    return out

  dc_ops.eigh_topk_dc = recording_dc

  def drive(leg, clusterer, n, warm_runs, expected, emb=None, want=None,
            small_sizes=(512, 2048), **extra):
    for n_small in small_sizes:
      small = clusterer.predict(make_embeddings(n_small))
      if not np.array_equal(utils.enforce_ordered_labels(small),
                            ref[f"labels_{n_small}"]):
        raise SystemExit(f"{leg}: labels differ from the reference at "
                         f"N={n_small}")
    if emb is None:
      emb, want = make_embeddings(n, D_MAIN), ref[f"labels_{n}"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cold = clusterer.predict_with_details(emb)
    cold_s = time.perf_counter() - t0
    fused.reset_launch_counts()
    del dc_infos[:]
    warm_s = []
    for _ in range(warm_runs):
      t0 = time.perf_counter()
      result = clusterer.predict_with_details(emb)
      warm_s.append(time.perf_counter() - t0)
    launches = fused.launch_counts()
    labels = utils.enforce_ordered_labels(result.labels)
    run = {
        "leg": leg, "n": n, "d": D_MAIN, **extra,
        "n_clusters": result.n_clusters,
        "parity": bool(np.array_equal(labels, want)),
        "eigenvalues": [float(v) for v in result.eigenvalues[:8]],
        "eigenvalues_shape": list(result.eigenvalues.shape),
        "cold_wall_s": cold_s, "warm_wall_s": statistics.median(warm_s),
        "warm_wall_s_runs": warm_s, "warm_runs": warm_runs,
        "stage_timings_s_cold_run": cold.timings,
        "stage_timings_s_last_run": result.timings, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if dc_infos:
      # The dc solve of the last warm run, and the routes of all of them.
      run["dc_routes"] = [i["route"] for i in dc_infos]
      run["dc"] = dc_infos[-1]
    if "host_eig" in result.timings:
      # The host LAPACK eig apart from everything else in the predict.
      run["host_eig_s"] = result.timings["host_eig"]
      run["device_and_rest_s"] = (result.timings["pipeline"]
                                  - result.timings["host_eig"])
    log(json.dumps({"phase": "path", **run}))
    if not run["parity"]:
      raise SystemExit(f"{leg}: labels differ from the reference")
    if not np.all(np.isfinite(result.eigenvalues)):
      raise SystemExit(f"{leg}: non-finite eigenvalues")
    idle = [k for k in expected if launches[k] == 0]
    if idle:
      raise SystemExit(f"{leg}: kernels not launched by predict: {idle}")
    bad = [i for i in dc_infos
           if i["route"] == "certified" and not i["res_returned"] <= 1e-5]
    if bad:
      raise SystemExit(f"{leg}: certified residual above 1e-5: {bad}")
    return run

  runs = {}
  for solver in (EigenSolver.Auto, EigenSolver.SubspaceIteration):
    runs[solver.name] = drive(
        solver.name, configs.make_icassp2018_clusterer(
            eigensolver=solver, staged_stage_timings=True),
        N_MAIN, WARM_RUNS, main_kernels, solver=solver.name)
  runs["HostGeneral"] = drive(
      "HostGeneral", configs.make_icassp2018_clusterer(
          eigensolver=EigenSolver.HostGeneral),
      N_GENERAL, GENERAL_WARM_RUNS, main_kernels + ("row_wise_normalize",),
      solver="HostGeneral",
      reduced=f"N cut from {N_MAIN} to {N_GENERAL}: the float64 general eig "
              "runs on the host and is O(N^3) (31.5 s at 4096, 500 s at "
              "10240 in benchmarks/baseline_numpy.json, on another host)")
  runs["host_api"] = drive(
      "host_api", configs.make_icassp2018_clusterer(
          post_eigen_cluster_function=run_kmeans),
      N_MAIN, API_WARM_RUNS, main_kernels, solver="Auto",
      post_eigen_cluster_function="run_kmeans")
  # The exact top-k route at the other record sizes and speaker counts.
  auto = configs.make_icassp2018_clusterer(staged_stage_timings=True)
  runs["Auto_20480"] = drive("Auto_20480", auto, N_BIG, 1, main_kernels,
                             small_sizes=(), solver="Auto")
  for k in MULTI_KS:
    emb, _ = make_embeddings_k(N_MAIN, k, D_MAIN)
    runs[f"Auto_k{k}"] = drive(
        f"Auto_k{k}", auto, N_MAIN, 1, main_kernels, emb=emb,
        want=ref_multi[f"labels_{N_MAIN}_k{k}"], small_sizes=(),
        solver="Auto", fixture=f"make_embeddings_k(N, k={k})")
  dc_force["decline"] = True
  runs["Auto_forced_decline"] = drive(
      "Auto_forced_decline", auto, N_MAIN, 1, main_kernels, small_sizes=(),
      solver="Auto", forced="try_iterative_first=False")
  emb, _ = make_embeddings_k(N_MAIN, 4, D_MAIN)
  runs["Auto_k4_forced_decline"] = drive(
      "Auto_k4_forced_decline", auto, N_MAIN, 1, main_kernels, emb=emb,
      want=ref_multi[f"labels_{N_MAIN}_k4"], small_sizes=(), solver="Auto",
      fixture="make_embeddings_k(N, k=4)", forced="try_iterative_first=False")
  dc_force["decline"] = False
  if set(runs["Auto_20480"]["dc_routes"]) != {"split"}:
    raise SystemExit(f"Auto_20480 took {runs['Auto_20480']['dc_routes']}, "
                     "not the split")
  for leg, certified in (("Auto_forced_decline", "Auto"),
                         ("Auto_k4_forced_decline", "Auto_k4")):
    forced = runs[leg]
    if set(forced["dc_routes"]) != {"split"}:
      raise SystemExit(f"{leg} took {forced['dc_routes']}")
    scale = runs[certified]["dc"]["scale"]
    err = float(np.max(np.abs(np.subtract(forced["eigenvalues"],
                                          runs[certified]["eigenvalues"]))))
    forced["max_abs_diff_vs_certified_leg"] = err
    if not err <= 2e-4 * scale:
      raise SystemExit(f"{leg}: eigenvalues differ from the {certified} "
                       f"leg's by {err} (scale {scale})")

  mark("paths")

  # 5. Turn-to-Diarize: its device stages alone at N_MAIN, then the leg.
  t2d_x, t2d_scores, _ = make_t2d_fixture(N_MAIN, D_MAIN)
  t2d_cm_host = constraint.ConstraintMatrix(
      t2d_scores, threshold=1).compute_diagonals()
  t2d_cfg = configs.make_turntodiarize_clusterer()._config()
  alpha = t2d_cfg.constraint_options.constraint_propagation_alpha
  aff = fused.affinity(torch.as_tensor(t2d_x).to(dev))
  t2d_cm = torch.as_tensor(t2d_cm_host.astype(np.float32)).to(dev)
  adjusted, e2cp_res = constraint.constraint_propagation(
      aff, t2d_cm, alpha, with_residual=True)
  e2cp_steps = constraint.propagate(aff, t2d_cm, alpha)[2]
  t2d_thr = t2d_thresholds(adjusted, p=T2D_P)
  check("threshold_symmetrize_general",
        f"N={N_MAIN},T2D on the constrained affinity, p={T2D_P}",
        fused.threshold_symmetrize_general(adjusted, t2d_thr, 0.01, **t2d),
        fused.threshold_symmetrize_general_plain(adjusted, t2d_thr, 0.01,
                                                 **t2d), True)
  if not checks[-1]["ok"]:
    raise SystemExit(f"kernel disagrees with its twin: {checks[-1]}")
  t2d_m, _ = pipeline._symmetric_eig_operand(adjusted.clone(), t2d_cfg, T2D_P,
                                             None, ref_ops.SYMMETRIC)
  with torch.no_grad():
    times["threshold_symmetrize_general"].update(
        t2d_ms=time_ms(torch, lambda: fused.threshold_symmetrize_general(
            adjusted, t2d_thr, 0.01, **t2d)),
        t2d_plain_ms=time_ms(
            torch, lambda: fused.threshold_symmetrize_general_plain(
                adjusted, t2d_thr, 0.01, **t2d)))
    t2d_breakdown = {
        "e2cp": lambda: constraint.constraint_propagation(aff, t2d_cm, alpha),
        "percentile_threshold": lambda: t2d_thresholds(adjusted, p=T2D_P),
        "subspace_topk_ascending": lambda: pipeline._subspace(
            t2d_m, t2d_cfg, None, False),
    }
    results["t2d_breakdown_ms"] = {
        name: time_ms(torch, fn, reps=2 if name == "e2cp" else 3, batch=1,
                      warmup=1)
        for name, fn in t2d_breakdown.items()}
    # The subspace iteration's length: one CholeskyQR2 per iteration, plus
    # one for the start panel.
    orthonormalize = eigen_ops.cholqr2_shifted
    calls = []
    eigen_ops.cholqr2_shifted = lambda y: calls.append(1) or orthonormalize(y)
    try:
      pipeline._subspace(t2d_m, t2d_cfg, None, False)
    finally:
      eigen_ops.cholqr2_shifted = orthonormalize
    results["t2d_subspace_iterations"] = len(calls) - 1
  # The constraint stage's host work, on the host clock: the symmetry check
  # of predict's input validation and the tri-diagonal upload.
  host_s = {}
  for name, fn in (
      ("symmetry_check", lambda: clusterer_lib._symmetric(t2d_cm_host)),
      ("upload_constraint",
       lambda: clusterer_lib._upload_constraint(t2d_cm_host, dev))):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s[name] = time.perf_counter() - t0
  results["t2d_host_s"] = host_s
  results["e2cp"] = {"alpha": alpha, "rel_residual": float(e2cp_res),
                     "steps_left_right": list(e2cp_steps),
                     "step_cap": constraint._neumann_cap(alpha)}
  log(json.dumps({"phase": "t2d_stages", "n": N_MAIN, "e2cp": results["e2cp"],
                  "breakdown_ms": results["t2d_breakdown_ms"],
                  "subspace_iterations": results["t2d_subspace_iterations"],
                  "subspace_max_iters": t2d_cfg.subspace_max_iters,
                  "host_s": host_s,
                  "threshold_symmetrize_general":
                      times["threshold_symmetrize_general"]}))
  if not float(e2cp_res) <= 1e-6:
    raise SystemExit(f"E2CP did not converge: {results['e2cp']}")
  del aff, t2d_cm, adjusted, t2d_thr, t2d_m

  t2d_ref = np.load(os.path.join(HERE, "benchmarks",
                                 "reference_labels_t2d.npz"))
  with open(os.path.join(HERE, "benchmarks", "bench_t2d.json")) as f:
    jax_best_p = {row["n"]: row["best_p"] for row in json.load(f)}

  def t2d_inputs(n):
    x, scores, _ = make_t2d_fixture(n, D_MAIN)
    return x, constraint.ConstraintMatrix(scores,
                                          threshold=1).compute_diagonals()

  def t2d_predict(x, cm):
    """One timed predict, on a fresh clusterer: AutoTune narrows its own
    range as it searches."""
    clusterer = configs.make_turntodiarize_clusterer()
    t0 = time.perf_counter()
    result = clusterer.predict_with_details(x, cm)
    return result, time.perf_counter() - t0

  def t2d_parity(n, result):
    return bool(np.array_equal(utils.enforce_ordered_labels(result.labels),
                               t2d_ref[f"labels_{n}"]))

  for n_small in (256, 1024, 2048):
    small, _ = t2d_predict(*t2d_inputs(n_small))
    if not t2d_parity(n_small, small):
      raise SystemExit(f"T2D: labels differ from the reference at "
                       f"N={n_small} (best_p {small.best_p_percentile})")
  torch.cuda.reset_peak_memory_stats()
  cold, cold_s = t2d_predict(t2d_x, t2d_cm_host)
  fused.reset_launch_counts()
  warm_s = []
  for _ in range(T2D_WARM_RUNS):
    result, seconds = t2d_predict(t2d_x, t2d_cm_host)
    warm_s.append(seconds)
  launches = fused.launch_counts()
  runs["t2d"] = {
      "leg": "t2d", "n": N_MAIN, "d": D_MAIN, "solver": "Auto",
      "route": "host flow: E2CP, then AutoTune's 11 candidates through "
               "eig_topk_staged (ascending subspace iteration)",
      "n_clusters": result.n_clusters,
      "best_p_percentile": result.best_p_percentile,
      "jax_bench_best_p": jax_best_p.get(N_MAIN),
      "parity": t2d_parity(N_MAIN, result),
      "eigenvalues": [float(v) for v in result.eigenvalues[:8]],
      "eigenvalues_shape": list(result.eigenvalues.shape),
      "cold_wall_s": cold_s, "warm_wall_s": statistics.median(warm_s),
      "warm_wall_s_runs": warm_s, "warm_runs": T2D_WARM_RUNS,
      "stage_timings_s_cold_run": cold.timings,
      "stage_timings_s_last_run": result.timings, "launches": launches,
      "launches_per_predict": {k: v / T2D_WARM_RUNS
                               for k, v in launches.items()},
      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
  }
  log(json.dumps({"phase": "path", **runs["t2d"]}))
  if not runs["t2d"]["parity"]:
    raise SystemExit("t2d: labels differ from the reference")
  if not np.all(np.isfinite(result.eigenvalues)):
    raise SystemExit("t2d: non-finite eigenvalues")
  idle = [k for k in ("affinity", "threshold_symmetrize_general")
          if launches[k] == 0]
  if idle:
    raise SystemExit(f"t2d: kernels not launched by predict: {idle}")
  mark("t2d")

  # 6. Streaming, against the JAX package's recorded histories. The AHC
  # pre-clustering must run the native chain: build it here, so that a
  # failed build stops the run with g++'s message.
  t0 = time.perf_counter()
  ahc_native.build()
  ahc_build_s = time.perf_counter() - t0
  if ahc.backend() != "native":
    raise SystemExit("streaming: the native AHC chain did not load")
  stream_ref = np.load(os.path.join(HERE, "tests", "data",
                                    "reference_streaming.npz"))
  stream, _ = make_stream(STREAM_STEPS)
  results["streaming"] = {}
  # The host split of a step past U1: AHC and predict seconds, read by
  # wrapping the AHC entry point and the main clusterer's predict.
  split = {"on": False, "ahc_s": 0.0, "predict_s": 0.0}
  ahc_labels = ahc.ahc_labels

  def split_timer(key, fn):
    def wrapper(*a, **kw):
      t0 = time.perf_counter()
      try:
        return fn(*a, **kw)
      finally:
        if split["on"]:
          split[key] += time.perf_counter() - t0
    return wrapper

  ahc.ahc_labels = split_timer("ahc_s", ahc_labels)
  for mode, deflicker in (("nodeflicker", Deflicker.NoDeflicker),
                          ("hungarian", Deflicker.Hungarian)):
    ms = streaming.MultiStageClusterer(
        clusterer_lib.SpectralClusterer(
            min_clusters=2, max_clusters=7,
            refinement_options=configs.icassp2018_refinement_options()),
        fallback_threshold=0.5, L=STREAM_L, U1=STREAM_U1, U2=STREAM_U2,
        deflicker=deflicker)
    ms.main.predict = split_timer("predict_s", ms.main.predict)
    split.update(ahc_s=0.0, predict_s=0.0)
    fused.reset_launch_counts()
    checked, compressions, ends = {}, 0, {}
    t_start = time.perf_counter()
    for step, e in enumerate(stream, start=1):
      rows = 0 if ms.cache is None else np.atleast_2d(ms.cache).shape[0]
      split["on"] = step > STREAM_U1
      out = ms.streaming_predict(e)
      if ms.cache.shape[0] <= rows:  # the cache was compressed
        compressions += 1
      key = f"{mode}_step_{step}"
      if key in stream_ref.files:
        checked[step] = {
            "equal": bool(np.array_equal(utils.enforce_ordered_labels(out),
                                         utils.enforce_ordered_labels(
                                             stream_ref[key]))),
            "equal_ids": bool(np.array_equal(
                np.asarray(out).astype(np.int64),
                stream_ref[key].astype(np.int64)))}
      ends[step] = time.perf_counter()
    split["on"] = False
    torch.cuda.synchronize()
    launches = fused.launch_counts()
    past_l = STREAM_STEPS - STREAM_L + 1
    past_u1 = STREAM_STEPS - STREAM_U1
    step_s = (ends[STREAM_STEPS] - ends[STREAM_U1]) / past_u1
    rates = {}
    for lo, hi in STREAM_WINDOWS:
      begin = ends[lo - 1] if lo > 1 else t_start
      rates[f"{lo}-{hi}"] = (hi - lo + 1) / (ends[hi] - begin)
    row = {
        "phase": "streaming", "mode": mode, "steps": STREAM_STEPS,
        "L": STREAM_L, "U1": STREAM_U1, "U2": STREAM_U2,
        "seconds": ends[STREAM_STEPS] - t_start, "steps_per_s": rates,
        "history_len": int(np.asarray(out).shape[0]),
        "compressions": compressions,
        "compressions_reference": int(stream_ref[f"{mode}_compressions"]),
        "compression_chain_equal": bool(np.array_equal(
            ms.compression_labels,
            stream_ref[f"{mode}_compression_labels"])),
        "checked_steps": checked, "launches": launches,
        "launches_per_step_past_L": {k: v / past_l
                                     for k, v in launches.items()},
        "ahc_backend": ahc.backend(),
        "host_split_per_step_past_U1_s": {
            "step": step_s, "ahc": split["ahc_s"] / past_u1,
            "predict": split["predict_s"] / past_u1,
            "rest": step_s - (split["ahc_s"] + split["predict_s"]) / past_u1},
    }
    if mode == "nodeflicker":
      # The device's idle share over a few more steps past U1, traced.
      from torch.profiler import ProfilerActivity, profile
      with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for e in stream[:PROFILED_STEPS]:
          ms.streaming_predict(e)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
      busy_ms = sum(
          getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0.0)) / 1e3
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA)
      row["profiled"] = {"steps": PROFILED_STEPS, "wall_ms": wall_ms,
                         "device_busy_ms": busy_ms,
                         "device_idle_share": 1.0 - busy_ms / wall_ms}
    results["streaming"][mode] = row
    log(json.dumps(row))
    failed = [s for s, c in checked.items() if not c["equal"]]
    if failed or len(checked) != 10:
      raise SystemExit(f"streaming {mode}: histories differ from the "
                       f"reference at steps {failed}")
    if not (compressions == row["compressions_reference"] == 2
            and row["compression_chain_equal"]
            and row["history_len"] == STREAM_STEPS):
      raise SystemExit(f"streaming {mode}: compression chain or history "
                       f"length wrong: {row}")
    idle = [k for k in main_kernels if launches[k] == 0]
    if idle:
      raise SystemExit(f"streaming {mode}: kernels not launched: {idle}")
  ahc.ahc_labels = ahc_labels

  # The pre-cluster AHC alone, on the stream's first AHC_ROWS rows (the
  # largest cache, U2), with each backend.
  dist = ahc.cosine_distance_matrix(stream[:AHC_ROWS])
  ahc_runs = {}
  for backend, reps in (("native", 5), ("numpy", 3)):
    native_ok = ahc._native_ok
    if backend == "numpy":
      ahc._native_ok = lambda: False
    try:
      assert ahc.backend() == backend
      runs_s = []
      for _ in range(reps):
        t0 = time.perf_counter()
        labels_ahc = ahc.ahc_labels(dist, "complete", n_clusters=STREAM_U1)
        runs_s.append(time.perf_counter() - t0)
    finally:
      ahc._native_ok = native_ok
    ahc_runs[backend] = (statistics.median(runs_s), labels_ahc)
  results["ahc"] = {
      "rows": AHC_ROWS, "n_clusters": STREAM_U1, "build_s": ahc_build_s,
      "library": os.path.basename(ahc_native.library_path()),
      "native_s": ahc_runs["native"][0], "numpy_s": ahc_runs["numpy"][0],
      "labels_equal": bool(np.array_equal(ahc_runs["native"][1],
                                          ahc_runs["numpy"][1]))}
  log(json.dumps({"phase": "ahc", **results["ahc"]}))
  if not results["ahc"]["labels_equal"]:
    raise SystemExit("ahc: the native and numpy chains disagree")
  mark("streaming")

  # 7. Batch clustering (parallel/batch.py) at the JAX batch bench's shape.
  batch_ref = np.load(os.path.join(HERE, "tests", "data",
                                   "reference_batch.npz"))
  mesh = mesh_lib.make_mesh()
  bcfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300,
      eigensolver=EigenSolver.Auto)

  def ordered_equal(got, want):
    return bool(np.array_equal(utils.enforce_ordered_labels(got),
                               utils.enforce_ordered_labels(want)))

  def gt_match(preds, truths):
    return sum(ordered_equal(p, t) for p, t in zip(preds, truths))

  def timed_call(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0

  utts, truths = make_batch(BATCH, N_BATCH, D_MAIN)
  cold, cold_s = timed_call(lambda: batch_lib.cluster_batch(utts, bcfg, mesh))
  fused.reset_launch_counts()
  warm_s = []
  for _ in range(BATCH_WARM_RUNS):
    labels_b, seconds = timed_call(
        lambda: batch_lib.cluster_batch(utts, bcfg, mesh))
    warm_s.append(seconds)
  launches = fused.launch_counts()
  want = {"affinity": BATCH, "row_max": 2 * BATCH, "crop_diagonal": BATCH,
          "threshold_symmetrize_general": BATCH, "row_wise_normalize": 0}
  per_call = {k: v / BATCH_WARM_RUNS for k, v in launches.items()}
  ref_labels = list(batch_ref["batch_labels"])
  run = {
      "leg": "cluster_batch", "batch": BATCH, "n": N_BATCH, "d": D_MAIN,
      "mesh": mesh.shape, "parity": all(ordered_equal(a, b) for a, b in
                                        zip(labels_b, ref_labels)),
      "parity_ids": all(np.array_equal(a, b.astype(a.dtype))
                        for a, b in zip(labels_b, ref_labels)),
      "warm_equal_cold": all(np.array_equal(a, b)
                             for a, b in zip(labels_b, cold)),
      "gt_match": gt_match(labels_b, truths),
      "cold_wall_s": cold_s, "warm_wall_s": statistics.median(warm_s),
      "warm_wall_s_runs": warm_s,
      "utterances_per_s": BATCH / statistics.median(warm_s),
      "launches": launches, "launches_per_call": per_call,
  }

  # The loop's stages alone, per utterance: the staged executor's split of
  # the same pipeline (prep: affinity and refinement; eigh; finish: the
  # eigengap and K-Means), the card synced around each stage. Its labels
  # must be the batch's.
  stage_timings = observability.StageTimings(dev)
  split_labels = []
  for i, u in enumerate(utts):
    split_labels.append(pipeline.spectral_cluster_fixed_k_staged(
        torch.as_tensor(u).to(dev), torch.Generator().manual_seed(i), bcfg,
        n_valid=N_BATCH, timings=stage_timings)[0].cpu().numpy())
  run["stage_split_s"] = stage_timings.as_dict()
  run["stage_split_labels_equal"] = all(
      np.array_equal(a, b) for a, b in zip(split_labels, labels_b))
  results["batch"] = run
  log(json.dumps({"phase": "batch", **run}))
  if not run["parity"]:
    raise SystemExit("cluster_batch: labels differ from the JAX package's")
  if not run["stage_split_labels_equal"]:
    raise SystemExit("cluster_batch: the staged split's labels differ")
  if per_call != want:
    raise SystemExit(f"cluster_batch: launches per call {per_call}, "
                     f"expected {want}")
  mark("batch")

  # The streamed driver at the 1024-utterance scale.
  s_utts, s_truths = make_batch(STREAMED_BATCH, N_BATCH, D_MAIN)
  fused.reset_launch_counts()
  streamed, streamed_s = timed_call(lambda: batch_lib.cluster_batch_streamed(
      s_utts, bcfg, mesh, chunk=STREAMED_CHUNK, window=STREAMED_WINDOW))
  launches = fused.launch_counts()
  serial = []
  for lo in (0, STREAMED_CHUNK):
    serial.extend(batch_lib.cluster_batch(
        s_utts[lo:lo + STREAMED_CHUNK], bcfg, mesh, seed=lo))
  half, half_s = timed_call(lambda: batch_lib.cluster_batch_streamed(
      s_utts[:STREAMED_BF16], bcfg, mesh, chunk=STREAMED_CHUNK,
      window=STREAMED_WINDOW, transfer_dtype=torch.bfloat16))
  # The device's idle share over one more full chunk, traced: the card's
  # activity only, which keeps the trace small (Lloyd launches thousands of
  # small kernels per utterance). The trace's stop and its summary are
  # timed apart from the traced run.
  from torch.profiler import ProfilerActivity, profile
  prof = profile(activities=[ProfilerActivity.CUDA])
  prof.start()
  t0 = time.perf_counter()
  batch_lib.cluster_batch_streamed(
      s_utts[:STREAMED_CHUNK], bcfg, mesh, chunk=STREAMED_CHUNK,
      window=STREAMED_WINDOW)
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  prof.stop()
  trace_stop_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  busy_ms = sum(
      getattr(e, "self_device_time_total",
              getattr(e, "self_cuda_time_total", 0.0)) / 1e3
      for e in prof.key_averages()
      if e.device_type == torch.autograd.DeviceType.CUDA)
  trace_summary_s = time.perf_counter() - t0
  run = {
      "leg": "cluster_batch_streamed", "batch": STREAMED_BATCH,
      "n": N_BATCH, "d": D_MAIN, "chunk": STREAMED_CHUNK,
      "window": STREAMED_WINDOW, "seconds": streamed_s,
      "utterances_per_s": STREAMED_BATCH / streamed_s,
      "gt_match": gt_match(streamed, s_truths),
      "first_two_chunks_equal_serial": all(
          np.array_equal(a, b) for a, b in zip(streamed, serial)),
      "first_batch_equal_reference": all(
          ordered_equal(a, b) for a, b in zip(streamed, ref_labels)),
      "launches": launches,
      "launches_per_utterance": {k: v / STREAMED_BATCH
                                 for k, v in launches.items()},
      "bf16_transfer": {
          "batch": STREAMED_BF16, "seconds": half_s,
          "utterances_per_s": STREAMED_BF16 / half_s,
          "gt_match": gt_match(half, s_truths),
          "float32_gt_match_same_utterances": gt_match(
              streamed[:STREAMED_BF16], s_truths),
          "labels_equal_float32": sum(ordered_equal(a, b) for a, b in
                                      zip(half, streamed))},
      "profiled": {"utterances": STREAMED_CHUNK, "chunk": STREAMED_CHUNK,
                   "window": STREAMED_WINDOW, "wall_ms": wall_ms,
                   "device_busy_ms": busy_ms,
                   "device_idle_share": 1.0 - busy_ms / wall_ms,
                   "trace_stop_s": trace_stop_s,
                   "trace_summary_s": trace_summary_s},
  }
  results["batch_streamed"] = run
  log(json.dumps({"phase": "batch_streamed", **run}))
  if not (run["first_two_chunks_equal_serial"]
          and run["first_batch_equal_reference"]):
    raise SystemExit("cluster_batch_streamed: labels differ from the serial "
                     "chunked loop or the reference")
  idle = [k for k in main_kernels if launches[k] != STREAMED_BATCH
          * want[k] // BATCH]
  if idle:
    raise SystemExit(f"cluster_batch_streamed: launches {launches}")
  mark("batch_streamed")

  # A constrained, auto-tuned batch: the Turn-to-Diarize template.
  t2d_b_x, t2d_b_scores, _ = make_t2d_fixture(N_BATCH, D_MAIN)
  t2d_b_cm = constraint.ConstraintMatrix(
      t2d_b_scores, threshold=1).compute_diagonals()
  tcfg = pipeline.PipelineConfig(
      refinement_options=configs.turntodiarize_refinement_options(),
      constraint_options=configs.turntodiarize_constraint_options(),
      laplacian_type=LaplacianType.GraphCut, min_clusters=2, max_clusters=7,
      row_wise_renorm=True, custom_dist="cosine")
  candidates = len(configs.make_turntodiarize_auto_tune().get_percentile_range())

  def autotuned():
    return batch_lib.cluster_batch_autotuned(
        [t2d_b_x] * T2D_BATCH, tcfg, configs.make_turntodiarize_auto_tune(),
        mesh, constraint_matrices=[t2d_b_cm] * T2D_BATCH)

  _, t2d_cold_s = timed_call(autotuned)
  fused.reset_launch_counts()
  t2d_labels, t2d_warm_s = timed_call(autotuned)
  launches = fused.launch_counts()
  t2d_ref_b = list(batch_ref["t2d_labels"])
  clusterer_labels = configs.make_turntodiarize_clusterer().predict(
      t2d_b_x, t2d_b_cm)
  run = {
      "leg": "cluster_batch_autotuned", "batch": T2D_BATCH, "n": N_BATCH,
      "d": D_MAIN, "candidates_per_utterance": candidates,
      "parity": all(ordered_equal(a, b) for a, b in zip(t2d_labels,
                                                        t2d_ref_b)),
      "parity_ids": all(np.array_equal(a, b.astype(a.dtype))
                        for a, b in zip(t2d_labels, t2d_ref_b)),
      "equal_reference_labels_t2d": all(
          ordered_equal(a, t2d_ref[f"labels_{N_BATCH}"]) for a in t2d_labels),
      "equal_spectral_clusterer": all(
          ordered_equal(a, clusterer_labels) for a in t2d_labels),
      "cold_wall_s": t2d_cold_s, "warm_wall_s": t2d_warm_s,
      "utterances_per_s": T2D_BATCH / t2d_warm_s, "launches": launches,
  }
  results["batch_autotuned"] = run
  log(json.dumps({"phase": "batch_autotuned", **run}))
  if not run["parity"]:
    raise SystemExit("cluster_batch_autotuned: labels differ from the JAX "
                     "package's")
  if (launches["threshold_symmetrize_general"] != candidates * T2D_BATCH
      or launches["affinity"] != T2D_BATCH):
    raise SystemExit(f"cluster_batch_autotuned: launches {launches}")
  mark("batch_autotuned")

  # 8. The row-sharded path: no kernel may launch in it.
  fused.reset_launch_counts()
  results["sharded"] = sharded_phase(torch, np, dev, ref[f"labels_{N_BIG}"],
                                     log)
  sharded_launches = fused.launch_counts()
  results["sharded"]["launches"] = sharded_launches
  log(json.dumps({"phase": "sharded", "launches": sharded_launches}))
  if any(sharded_launches.values()):
    raise SystemExit(f"sharded: kernels launched {sharded_launches}")
  mark("sharded")
  batch_launches = {
      "cluster_batch": results["batch"]["launches"],
      "cluster_batch_streamed": results["batch_streamed"]["launches"],
      "cluster_batch_autotuned": launches}

  sources = {
      "affinity": "fused.py:46-77 affinity_pallas",
      "row_max": "fused.py:85-140 row_max_pallas",
      "crop_diagonal": "fused.py:226-254 crop_diagonal_pallas",
      "threshold_symmetrize_general":
          "fused.py:148-218 threshold_symmetrize_general_pallas",
      "row_wise_normalize": "fused.py:262-283 row_wise_normalize_pallas",
  }
  kernels = []
  for name in timed:
    err = max(c["max_abs_err"] for c in checks if c["kernel"] == name)
    per_predict = runs["HostGeneral" if name == "row_wise_normalize"
                       else "Auto"]
    kernel = {
        "name": name, "route": "cuda",
        "source": "spectralcluster_tpu_torch/csrc/fused.cu",
        "replaces": "spectralcluster_tpu/kernels/" + sources[name],
        "launches": (sum(r["launches"][name] for r in runs.values())
                     + sum(r["launches"][name]
                           for r in results["streaming"].values())
                     + sum(r[name] for r in batch_launches.values())),
        "launches_per_predict":
            per_predict["launches"][name] / per_predict["warm_runs"],
        "launches_per_batch_utterance":
            results["batch"]["launches_per_call"][name] / BATCH,
        "launches_per_autotuned_batch_utterance":
            batch_launches["cluster_batch_autotuned"][name] / T2D_BATCH,
        "launches_auto_20480_predict": runs["Auto_20480"]["launches"][name],
        "launches_per_stream_step_past_L": results["streaming"][
            "nodeflicker"]["launches_per_step_past_L"][name],
        "launches_sharded": sharded_launches[name],
        "max_abs_err": err, "kernel_ms": times[name]["ms"],
        **times[name],
    }
    if name in no_library:
      kernel["library_note"] = no_library[name]
    if name == "threshold_symmetrize_general":
      kernel["launches_per_t2d_predict"] = (
          runs["t2d"]["launches_per_predict"][name])
    kernels.append(kernel)
  results["kernels"] = kernels
  results["paths"] = runs
  if args.out:
    with open(args.out, "w") as f:
      json.dump(results, f, indent=1)
  log(json.dumps({"kernels": kernels}))
  log("\n".join(smi))
  log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                         "count": count}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
