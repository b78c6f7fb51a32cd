#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. device — the card's name and power limit (nvidia-smi);
  2. build — compiles csrc/fused.cu with nvcc at first use; prints ptxas's
     registers, static shared memory and spill bytes per kernel, the
     blocks resident per SM of the affinity, row_max and crop_diagonal and
     of the batched affinity and row_max, and the batched affinity's grid
     at B=16 and 64;
  3. kernels — each hand-written kernel against its plain PyTorch twin on the
     card, at the main path's shapes (N=10240, d=256; kernel 5 on the
     Diffuse output, its input on the HostGeneral path) and at a ragged
     N=1000 with n_valid=937 on a matrix with negative entries; kernels 2-5
     must agree bit for bit, the affinity within rtol=1e-5, atol=1e-6 (its
     float32 sums run in another order) and equal to its transpose bit for
     bit. The batched forms of kernels 1-5 (the batched step's vmap) the
     same way at the batch path's B=16, N=1024 (d=256; kernel 5b on each
     utterance's Diffuse output) and on a ragged batch of five N=1000
     matrices with n_valid (1000, 937, 1, 500, 1000) read on the card; each
     affinity and each kernel 5b matrix of a batch must also equal the 2-D
     kernel's bit for bit; 1b and 2b also at the streamed chunk's B=64,
     N=1024, 1b there also against its transpose. The subspace solver's
     kernels on the operands it gives them: the panel product (6) on the
     certified route's shifted operand at N=10240 (and, in 3b, at 20480)
     by 16, 8 and 1 columns, on a quarter of its rows (at 20480 the
     5120-row stripe of four shards) and on the batched operands, and the
     solver's float64 Gram (``ops.eigen.panel_gram``, no kernel) of the
     Ritz matrix and of CholeskyQR2, each within the float32 bound of a
     K-term sum of the twin (|Δ| ≤ 2·K·2⁻²⁴·(|a|·|x|)) and within one
     float32 rounding of a float64 sum of the same inputs (|got − exact|
     ≤ 2⁻²⁴·|exact| + K·2⁻⁵²·(|a|·|x|): a float32 or TF32 sum fails it),
     cuBLAS's error against that sum printed beside, kernel 6 also equal
     bit for bit across two calls and to its C entry called alone, and
     timed per operand and width through its wrapper, alone and against
     cuBLAS's float32 product, with its k split; the CholeskyQR pass pair
     (7, both shifts in one launch): each pass equal bit for bit to the
     single-pass kernel at its shift, no farther from the same pass
     computed in float64 than four times the twin's distance (cuSOLVER's
     Cholesky, cuBLAS's solve) plus 1e-6, the same info, its flag that of
     its own outputs, one Inf in one panel of a batch flagging that panel
     alone, its workspace zero after each launch; timed alone and through
     its wrapper beside the two single passes it replaces, and one
     CholeskyQR2 each way; then the solver's launches per iteration (48
     iterations less 24). Then times (CUDA events
     around 10 calls back to back behind one untimed call, median of 20
     such means after warm-up) of each kernel, its twin and a one-call
     library yardstick where one exists (the affinity's `addmm` timed with the row normalization, as
     the kernel's wrapper is), beside the card's bound for the same work
     (the affinity's as the symmetric least work, N(N+1)/2 dot products);
     the batched affinity's kernel alone beside its wrapper, at B=16 and at
     the streamed chunk's B=64 (the build phase prints its grid and waves);
     the batched row max and its `amax` also with the L2 flushed by a
     128 MB write before each call, and the row max's kernel alone (its C
     entry) both ways; and the main path's other device stages (blur,
     Diffuse, full eigh, top-k subspace);
  3b. the exact top-k route's parts, each alone, on the icassp2018 Auto
     operand at N=10240 and 20480: the certified route (accepted or
     declined, its iterations, res, scale, est_next against w_t, and its
     residual after each 32-iteration chunk beside the route the port and
     the JAX package took on the same operand built on the CPU,
     tests/data/reference_dc_route.json, written by
     tools/record_dc_route_reference.py), the completeness probe, the full
     eigh (the yardstick), and the sign-chain split, forced
     (try_iterative_first=False): at 10240 at "highest" (IEEE float32) and
     at "high" (3×TF32), at 20480 at the default precision, its
     eigenvalues within 2e-4·scale of the certified route's (of the full
     eigh's top t where the route declined). Then the certified route
     alone on make_embeddings_k(10240, k), k=4 and 7. Each route fails the
     run if it accepts where the JAX package declined or the reverse, or
     runs to the 2,048-iteration cap where the CPU certified below it.
     Each split prints its
     levels (branch, k_f, k_pad, k_eff, residuals), the host seconds of
     prep, each sign step (with its TFLOP/s against the card's float32 and
     TF32 peaks), projection, Ritz and remainder, and its peak memory
     beside the predicted one;
  3c. kmeans — kernel 8 (k-means++ and the cosine Lloyd loop in one
     launch) against its twin on the inputs the main path gives it: the
     spectral embeddings the icassp2018 predict hands to kmeans_fit at
     N=1024, 10240 and 20480, and the ragged (16, 1024) chunk that
     cluster_batch hands to kmeans_fit_batched (16 utterances of 256 to
     1024 rows): labels equal; rounds equal, or, where they differ, the
     stop rule's mean within KM_BOUNDARY of 0 on both sides (where it
     rounds to <= 0 the rule cannot fire); k-means++'s seeds (both sides
     at max_iter=0) within KM_SEED_RTOL of the rows' largest norm (rows
     of one tight cluster) or, where the card's twin (cuBLAS products)
     parts from them further, the twin's run on the CPU, the centroids
     then within 1e-5 of that run's where the rounds are its; centroids
     within rtol=1e-5, atol=1e-6 where neither happened; timed as the
     other kernels (its launch counts reset just before: one
     kernel-8 launch a call, nothing else) beside the twin, and beside its
     latency bound: its launch and its serial steps (block barriers, block
     sums and argmaxes, each thread's Gumbel draws row after row) in the
     kernel's order, each at the latency that tools/kmeans_latency.cu
     measures for it on one block of 512 threads;
  4. paths — make_icassp2018_clusterer(...).predict on make_embeddings(N),
     labels held against benchmarks/reference_labels.npz at N=512, 2048 and
     the leg's N, with launch counts zeroed after the cold run and read
     after the warm runs (the comparison launches of phase 3 do not count);
     each leg fails if a kernel of its path did not launch, or if K-Means
     did not run as one kernel-8 launch a predict:
       * Auto and SubspaceIteration at N=10240 (one cold run, WARM_RUNS
         warm): kernels 1-4 (RowWiseNormalize is absorbed into the eigh
         similarity transform there) and the subspace solver's 6-7, as
         the host API leg below. Auto runs the exact top-k route
         (ops/dc.py, stage staged_dc); each Auto leg prints the route its
         dc solve took and fails on a certified residual above 1e-5;
       * Auto at N=20480 (labels_20480), and at N=10240 on
         make_embeddings_k(N, k) for k=4 and k=7
         (benchmarks/reference_labels_multi.npz), one cold run and one
         warm; each Auto leg's dc solves must take the JAX package's
         recorded route (tests/data/reference_dc_route.json: certified)
         and stop below the iteration cap where the CPU did, and launch the
         subspace solver's kernels (6-7) as well as 1-4; then Auto at
         N=10240 with the dc route forced to decline,
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
     300, Auto), one batched step per chunk: cluster_batch once cold and
     BATCH_WARM_RUNS warm, labels held id for id against
     tests/data/reference_batch.npz (the JAX package's cluster_batch,
     recorded by tools/record_batch_reference.py), gt_match reported; the
     batched kernels 1-4 must launch 1/2/1/1 times per chunk and the 2-D
     ones not at all; peak memory beside PEAK_BUFFERS (B, N, N) buffers.
     Then the batched step's stages alone (prep: affinity, refinement,
     operand; the batched eigh; finish: eigengap and K-Means), card
     synced around each, labels equal to the batch's; its Lloyd loop once
     more under torch.cuda.set_sync_debug_mode("error") with no stop check
     (no host read in any round), equal to the checked loop, and each
     utterance's rounds. Then the batched step's other two eigensolvers on
     the same utterances, each held against the 2-D pipeline run on each
     utterance on the card (labels and counts equal) and against
     tests/data/reference_batch_solvers.npz (the JAX package's labels, id
     for id): SubspaceIteration on all 16 (one cold call, BATCH_WARM_RUNS
     warm; launches 1/2/1/1 per chunk and kernels 6-7; Ritz values within
     SOLVER_EIG_RTOL·max|λ| of the 2-D solve's; the batched solve alone
     against the 2-D solve of each utterance in turn, with the iterations
     of each); the same on three utterances that stop at other
     iterations, make_embeddings_k(1024, k) for k=2, 4, 7 with the
     certified route's solver constants (chunks of 32, residual 1e-6, at
     most 2,048), against tests/data/reference_batch_ragged.npz and the
     speakers, and HostGeneral on the first HOST_GENERAL_BATCH (one cold
     call, one warm: kernels 1-5 in batched form once per chunk (row_max
     once), the 2-D kernel 5 never; the chunk's host_eig seconds). Then
     cluster_batch_streamed over
     make_batch(STREAMED_BATCH) with chunk=64, window=4 in float32: its
     first two chunks must equal cluster_batch on those chunks with
     seed=lo, its first 16 the reference id for id; launches 1/2/1/1 per
     chunk; gt_match, utterances/s, peak memory and, from a
     torch.profiler trace (card activity only) of one more full chunk,
     the device's idle share and its largest kernels, with the trace's
     stop and summary timed apart; then one bf16-transfer pass over the
     first STREAMED_BF16 utterances (gt_match printed beside the float32
     one, ungated). Then cluster_batch_autotuned with the Turn-to-Diarize
     template on 4 x make_t2d_fixture(1024) with its constraints: labels
     held id for id against the reference file; each AutoTune level is one
     (4, 11) batched call, so the affinity and kernel 4 (T2D form) launch
     once per level; equality with benchmarks/reference_labels_t2d.npz
     and with the port's SpectralClusterer is printed, ungated.
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
     around one run at N=2048; (e) no refinement kernel launches in the
     phase, and its subspace solve launches kernels 6-7 on the stripes.
     Each run prints n_clusters, subspace iterations, the final residual,
     the peak memory and the host seconds per stage, card synced.
  Each phase prints the seconds elapsed at its end. Together about 10
  minutes on one H100, most of it the host eig and the host side of the
  streams.

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
KM_THREADS = 512      # kernel 8's block (kKmThreads)
KM_PROBE_REPS = 256   # chained steps a latency probe of kernel 8 times
# Lloyd's stop rule cannot fire once its mean distance rounds to <= 0
# (ROADMAP, shared with the JAX package); where the mean sits within this
# of 0, the last bit of a sum decides between stopping and running to
# max_iter + 1 rounds, so kernel 8's round count may differ from the twin's
# there (its labels may not).
KM_BOUNDARY = 2.0 ** -20
# k-means++ seeds of kernel 8 and its twin may part by this much of the
# rows' largest norm: two rows of one tight cluster in a spectral
# embedding, whose potentials tie to float32 rounding; rows of two
# clusters lie ~1e-1 of it apart.
KM_SEED_RTOL = 1e-3
MULTI_KS = (4, 7)
RAGGED_KS = (2, 4, 7)          # the ragged batched-SubspaceIteration leg
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
NV_BATCH_RAGGED = (1000, 937, 1, 500, 1000)   # the ragged batch's n_valid
# The batched step's predicted peak memory, in (B, N, N) float32 buffers
# alive at once: the affinity, the blur's two sums and the gather it adds
# to, the thresholded matrix, the Diffuse product, the eigen operand and
# eigh's eigenvectors and workspace.
PEAK_BUFFERS = 8
T2D_BATCH = 4
HOST_GENERAL_BATCH = 4         # the batched HostGeneral leg: ~0.4 s of host
                               # eig per utterance
SOLVER_EIG_RTOL = 1e-4         # batched against 2-D Ritz values, of max|λ|
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


def time_flushed_ms(torch, fn, flush, reps=REPS, warmup=3) -> float:
  """Median over `reps` of one call's card time right after a write of
  `flush` (128 MB, more than the L2's 50 MB), so the call finds its input
  in device memory; the L2 then holds the flush's dirty lines, which the
  call's reads evict, as a caller after a large write would."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    flush.fill_(1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
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
                                         pipeline, prng, streaming, utils)
  from spectralcluster_tpu_torch import precision as precision_lib
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
  from spectralcluster_tpu_torch.ops import affinity as affinity_ops
  from spectralcluster_tpu_torch.ops import dc as dc_ops
  from spectralcluster_tpu_torch.ops import eigen as eigen_ops
  from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops
  from spectralcluster_tpu_torch.precision import fp32_precision
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
  for i, name in enumerate(("affinity", "row_max", "crop_diagonal",
                            "affinity_batched", "row_max_batched")):
    blocks = ctypes.c_int(0)
    rc = build.load().sct_resident_blocks(i, ctypes.byref(blocks))
    if rc != 0:
      raise SystemExit(f"sct_resident_blocks({name}): CUDA error {rc}")
    resident[name] = blocks.value
  # The batched affinity's grid at the batch path's and the streamed
  # chunk's shapes, against the card's resident blocks.
  affinity_batched_schedule = {}
  for b in (BATCH, STREAMED_CHUNK):
    blocks, split, slots = (ctypes.c_longlong(0), ctypes.c_int(0),
                            ctypes.c_int(0))
    rc = build.load().sct_affinity_batched_schedule(
        b, N_BATCH, ctypes.byref(blocks), ctypes.byref(split),
        ctypes.byref(slots))
    if rc != 0:
      raise SystemExit(f"sct_affinity_batched_schedule: CUDA error {rc}")
    t = -(-N_BATCH // fused.AFFINITY_TILE)
    affinity_batched_schedule[f"B={b},N={N_BATCH}"] = {
        "blocks": blocks.value, "split_diagonal_tiles": split.value,
        "resident_blocks": slots.value,
        # In 128x128 tiles' work: a diagonal tile is 3/4 of one.
        "waves": (b * t * (t - 1) / 2 + 0.75 * b * t) / slots.value}
  ptxas = build.ptxas_report(lib_path)
  results["build"] = {
      "seconds": build_s, "library": os.path.basename(lib_path),
      "ptxas": ptxas, "resident_blocks_per_sm": resident,
      "affinity_batched_schedule": affinity_batched_schedule,
      # The kernels redesigned for this card should not spill.
      "spill_bytes_affinity_row_max": sum(
          r.get("spill_stores", 0) + r.get("spill_loads", 0)
          for k, r in ptxas.items()
          if k.startswith(("affinity", "row_max")))}
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
    """The T2D path's Percentile thresholds (preserve_diagonal), of a
    matrix or a batch."""
    eye = torch.eye(mat.shape[-1], dtype=torch.bool, device=dev)
    a = torch.where(eye, 0.0, mat)
    if n_valid is None:
      q = quantile_ops.quantile_from_sorted(quantile_ops.sort_rows(a), p)
    else:
      q = quantile_ops.quantile_from_sorted_masked(
          quantile_ops.sort_rows_masked(a, n_valid), p, n_valid)
    return q[..., None].contiguous()

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
  # The batched forms (kernels 1-4 under the batched step's vmap), at the
  # batch path's (BATCH, N_BATCH) on its own inputs, and on a ragged batch
  # whose n_valid the kernels read on the card.
  x_b = torch.as_tensor(np.stack(make_batch(BATCH, N_BATCH, D_MAIN)[0])).to(
      dev)
  aff_b = fused.affinity_batched(x_b)
  blurred_b = ref_ops.gaussian_blur(fused.crop_diagonal_plain(aff_b),
                                    1.0).contiguous()
  ragged_b = torch.as_tensor(rng.randn(len(NV_BATCH_RAGGED), N_RAGGED,
                                       N_RAGGED).astype(np.float32)
                             - 0.5).to(dev)
  nv_b = torch.tensor(NV_BATCH_RAGGED, dtype=torch.int32, device=dev)
  x_b_ragged = torch.as_tensor(rng.randn(len(NV_BATCH_RAGGED), N_RAGGED,
                                         100).astype(np.float32)).to(dev)
  batch_case = f"B={BATCH},N={N_BATCH}"
  ragged_case = (f"B={len(NV_BATCH_RAGGED)},N={N_RAGGED},"
                 f"n_valid={NV_BATCH_RAGGED}")
  check("affinity_batched", f"{batch_case},d={D_MAIN}", aff_b,
        fused.affinity_plain(x_b), False)
  check("affinity_batched", f"{batch_case},against its transpose", aff_b,
        aff_b.transpose(1, 2), True)
  aff_b_ragged = fused.affinity_batched(x_b_ragged)
  check("affinity_batched", f"B={len(NV_BATCH_RAGGED)},N={N_RAGGED},d=100",
        aff_b_ragged, fused.affinity_plain(x_b_ragged), False)
  check("affinity_batched", "each utterance against the 2-D kernel",
        aff_b_ragged, torch.stack([fused.affinity(u) for u in x_b_ragged]),
        True)
  del aff_b_ragged
  check("affinity_batched", f"{batch_case},each utterance against the 2-D "
        "kernel", aff_b, torch.stack([fused.affinity(u) for u in x_b]), True)
  # 1b and 2b at the streamed chunk's (STREAMED_CHUNK, N_BATCH), the shape
  # the streamed leg runs them at.
  chunk_case = f"B={STREAMED_CHUNK},N={N_BATCH}"
  x_b64 = torch.as_tensor(np.stack(
      make_batch(STREAMED_CHUNK, N_BATCH, D_MAIN)[0])).to(dev)
  aff_b64 = fused.affinity_batched(x_b64)
  check("affinity_batched", f"{chunk_case},d={D_MAIN}", aff_b64,
        fused.affinity_plain(x_b64), False)
  check("affinity_batched", f"{chunk_case},each utterance against the 2-D "
        "kernel", aff_b64, torch.stack([fused.affinity(u) for u in x_b64]),
        True)
  check("affinity_batched", f"{chunk_case},against its transpose", aff_b64,
        aff_b64.transpose(1, 2), True)
  blurred_b64 = ref_ops.gaussian_blur(fused.crop_diagonal_plain(aff_b64),
                                      1.0).contiguous()
  check("row_max_batched", chunk_case, fused.row_max_batched(blurred_b64),
        fused.row_max_plain(blurred_b64), True)
  del blurred_b64
  check("row_max_batched", batch_case, fused.row_max_batched(blurred_b),
        fused.row_max_plain(blurred_b), True)
  for excl in (False, True):
    check("row_max_batched", f"{ragged_case},exclude={excl}",
          fused.row_max_batched(ragged_b, excl, nv_b),
          fused.row_max_plain(ragged_b, excl, nv_b), True)
  check("crop_diagonal_batched", f"{batch_case},in_place",
        fused.crop_diagonal_batched(aff_b.clone(), inplace=True),
        fused.crop_diagonal_plain(aff_b), True)
  for inplace in (False, True):
    check("crop_diagonal_batched", f"{ragged_case},in_place={inplace}",
          fused.crop_diagonal_batched(ragged_b.clone(), nv_b, inplace),
          fused.crop_diagonal_plain(ragged_b, nv_b), True)
  thr_b = fused.row_max_batched(blurred_b) * P_ROWMAX
  thr_b_ragged = fused.row_max_batched(ragged_b, n_valid=nv_b) * P_ROWMAX
  for case, mat, thr, flags in (
      (f"{batch_case},RowMax/Max", blurred_b, thr_b, {}),
      (f"{batch_case},T2D", blurred_b, t2d_thresholds(blurred_b), t2d),
      (f"{ragged_case},RowMax/Max", ragged_b, thr_b_ragged, {}),
      (f"{ragged_case},T2D", ragged_b, t2d_thresholds(ragged_b, nv_b), t2d)):
    check("threshold_symmetrize_general_batched", case,
          fused.threshold_symmetrize_general_batched(mat, thr, 0.01, **flags),
          fused.threshold_symmetrize_general_plain(mat, thr, 0.01, **flags),
          True)
  # Kernel 5b on its batched HostGeneral input (the Diffuse output of each
  # utterance) and on the ragged batch; each matrix also against the 2-D
  # kernel.
  diffused_b = ref_ops.diffuse(
      fused.threshold_symmetrize_general_batched(blurred_b, thr_b, 0.01))
  for case, mat, nv, nvs in (
      (f"{batch_case},Diffuse output", diffused_b, None, [None] * BATCH),
      (ragged_case, ragged_b, nv_b, NV_BATCH_RAGGED)):
    got = fused.row_wise_normalize_batched(mat, nv)
    check("row_wise_normalize_batched", case, got,
          fused.row_wise_normalize_plain(mat, nv), True)
    check("row_wise_normalize_batched", f"{case},each against the 2-D kernel",
          got, torch.stack([fused.row_wise_normalize(m, v)
                            for m, v in zip(mat, nvs)]), True)
  del ragged_b, x_b_ragged
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

  bb, nb = BATCH, N_BATCH
  crop_scratch_b = aff_b.clone()

  def baddbmm_affinity():
    xn = fused.normalize_rows(x_b)
    return torch.baddbmm(half, xn, xn.transpose(1, 2), beta=1.0, alpha=0.5)

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
      # The batched forms at the batch path's (BATCH, N_BATCH), per launch.
      "affinity_batched": (
          lambda: fused.affinity_batched(x_b),
          lambda: fused.affinity_plain(x_b), baddbmm_affinity,
          (bb * nb * D_MAIN + bb * nb * nb) * 4,
          bb * nb * (nb + 1) * D_MAIN),
      "row_max_batched": (
          lambda: fused.row_max_batched(blurred_b),
          lambda: fused.row_max_plain(blurred_b),
          lambda: torch.amax(blurred_b, dim=-1, keepdim=True),
          bb * (nb * nb + nb) * 4, bb * nb * nb),
      "crop_diagonal_batched": (
          lambda: fused.crop_diagonal_batched(crop_scratch_b, inplace=True),
          lambda: fused.crop_diagonal_plain(aff_b), None,
          bb * (nb * nb + nb) * 4, bb * nb * nb),
      "threshold_symmetrize_general_batched": (
          lambda: fused.threshold_symmetrize_general_batched(blurred_b, thr_b,
                                                             0.01),
          lambda: fused.threshold_symmetrize_general_plain(blurred_b, thr_b,
                                                           0.01),
          None, bb * (2 * nb * nb + nb) * 4, bb * 4 * nb * nb),
      "row_wise_normalize_batched": (
          lambda: fused.row_wise_normalize_batched(diffused_b),
          lambda: fused.row_wise_normalize_plain(diffused_b), None,
          bb * 2 * nb * nb * 4, bb * 2 * nb * nb),
  }
  # Why a kernel has no one-call library yardstick.
  no_library = {
      "crop_diagonal": "no single PyTorch call: a row max, then a diagonal "
                       "write",
      "threshold_symmetrize_general": "no single PyTorch call: thresholding "
                                      "and the symmetrize are several calls",
      "row_wise_normalize": "no single PyTorch call: amax, then a division",
      "crop_diagonal_batched": "no single PyTorch call: a row max, then a "
                               "diagonal write",
      "threshold_symmetrize_general_batched": "no single PyTorch call: "
                                              "thresholding and the "
                                              "symmetrize are several calls",
      "row_wise_normalize_batched": "no single PyTorch call: amax, then a "
                                    "division",
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
    # 1b: the kernel alone (its C entry on normalized rows made beforehand)
    # beside the wrapper (row normalization included), at the batch path's
    # shape and at the streamed chunk's (STREAMED_CHUNK, N_BATCH). 2b and
    # its amax: also with the L2 flushed before each call.
    lib, stream = build.load(), torch.cuda.current_stream(dev).cuda_stream
    for b, xb, aff_want in ((bb, x_b, aff_b),
                            (STREAMED_CHUNK, x_b64, aff_b64)):
      xn_b = fused.normalize_rows(xb).contiguous()
      out_b = torch.empty((b, nb, nb), device=dev)

      def alone(xn_b=xn_b, out_b=out_b, b=b):
        rc = lib.sct_affinity_batched(xn_b.data_ptr(), out_b.data_ptr(), b,
                                      nb, D_MAIN, stream)
        if rc:
          raise SystemExit(f"sct_affinity_batched: CUDA error {rc}")

      parts = {"kernel_alone_ms": time_ms(torch, alone)}
      if b != bb:
        parts["ms"] = time_ms(torch, lambda xb=xb: fused.affinity_batched(xb))
        parts["bound_ms"] = b * nb * (nb + 1) * D_MAIN / fp32 * 1e3
      # The kernel alone gives the wrapper's output, gated above.
      if not torch.equal(out_b, aff_want):
        raise SystemExit(f"sct_affinity_batched alone at B={b} disagrees "
                         "with its wrapper")
      key = "affinity_batched" if b == bb else f"affinity_batched_b{b}"
      times.setdefault(key, {}).update(parts)
      log(json.dumps({"phase": "timing", "kernel": key,
                      "shape": f"B={b},N={nb},d={D_MAIN}", **times[key]}))
      del xn_b, out_b
    del x_b64, aff_b64
    flush = torch.empty(128 << 18, device=dev)
    rmax_b = torch.empty((bb, nb, 1), device=dev)

    def row_max_alone():
      rc = lib.sct_row_max_batched(blurred_b.data_ptr(), rmax_b.data_ptr(),
                                   bb, nb, None, 0, 1, stream)
      if rc:
        raise SystemExit(f"sct_row_max_batched: CUDA error {rc}")

    times["row_max_batched"].update({
        "kernel_alone_ms": time_ms(torch, row_max_alone),
        "ms_l2_flushed": time_flushed_ms(torch, timed["row_max_batched"][0],
                                         flush),
        "kernel_alone_ms_l2_flushed": time_flushed_ms(torch, row_max_alone,
                                                      flush),
        "library_ms_l2_flushed": time_flushed_ms(
            torch, timed["row_max_batched"][2], flush)})
    log(json.dumps({"phase": "timing", "kernel": "row_max_batched",
                    **times["row_max_batched"]}))
    del flush, rmax_b

  # Where the main path's time goes: its other device stages at N_MAIN,
  # each timed alone on the same inputs the pipeline gives it.
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7)
  del diffused
  m, _ = pipeline._symmetric_eig_operand(aff.clone(), cfg, None, None,
                                         ref_ops.ROWNORM_TAIL)

  # The subspace solver's panel product (kernel 6) and its Gram
  # (ops.eigen.panel_gram: a float64 library product on the card, no
  # kernel) on the operands the solver gives them: the certified route's
  # shifted operand m + b·I at N_MAIN by its (N, 16) panel (and by the
  # probe's 8 and the norm estimate's 1 column), a quarter of its rows (a
  # row-sharded stripe), and the batched step's (BATCH, N_BATCH) operands
  # by their panels; the Grams of those panels with their products. Each
  # sums in another order than cuBLAS, so each output is held to the
  # float32 bound of a K-term sum, |got − want| ≤ 2·K·2⁻²⁴·(|a|·|x|)
  # element by element. Their point is the float64 sum, so each output is
  # also held to one float32 rounding of a float64 sum of the same inputs,
  # |got − exact| ≤ 2⁻²⁴·|exact| + K·2⁻⁵²·(|a|·|x|): a float32 sum in any
  # order, or TF32, breaks it on these operands. cuBLAS's float32 error
  # against that sum is printed beside.
  op_main = m.clone()
  op_main.diagonal().add_(float(torch.amax(torch.sum(torch.abs(m), dim=1)))
                          + 1.0)
  panel_gen = torch.Generator().manual_seed(pipeline._DC_SEED)
  q_main = eigen_ops.cholqr2_shifted(
      eigen_ops.start_panel(n, 16, panel_gen, torch.float32, dev))
  m_b, _ = pipeline._symmetric_eig_operand(
      aff_b.clone(), cfg, None, None, ref_ops.ROWNORM_TAIL)
  q_b = eigen_ops.cholqr2_shifted(eigen_ops.start_panel(
      N_BATCH, 16, panel_gen, torch.float32, dev).expand(BATCH, -1, -1))
  accuracy = {}

  def float64_share(got, at, x):
    """(max |got − exact|, its largest share of the float64 gate's bound
    2⁻²⁴·|exact| + K·2⁻⁵²·(|a|·|x|)) for got ≈ at @ x: a share above 1
    is farther from a float64 sum than one float32 rounding."""
    magnitude = torch.matmul(torch.abs(at).double(), torch.abs(x).double())
    exact = torch.matmul(at.double(), x.double())
    err64 = torch.abs(got.double() - exact)
    bound64 = (2.0**-24 * torch.abs(exact)
               + at.shape[-1] * 2.0**-52 * magnitude)
    share = err64 / torch.clamp_min(bound64, torch.finfo(torch.float64).tiny)
    return float(torch.max(err64)), float(torch.max(share))

  def check_bounded(name, case, got, want, a, x, gram=False):
    """got against want within the float32 bound of their K-term sums, and
    within one float32 rounding of a float64 sum of the same inputs."""
    k_sum = a.shape[-2] if gram else a.shape[-1]
    at = a.transpose(-1, -2) if gram else a
    bound = 2.0 * k_sum * 2.0**-24 * torch.matmul(torch.abs(at),
                                                  torch.abs(x))
    torch.cuda.synchronize()
    diff = torch.abs(got - want)
    err = float(torch.max(diff))
    err64, share = float64_share(got, at, x)
    twin_err64, twin_share = float64_share(want, at, x)
    ok = bool(torch.all(diff <= bound)) and share <= 1.0
    accuracy[f"{name} {case}"] = {
        "kernel_vs_float64": err64, "cublas_vs_float64": twin_err64,
        "float64_bound_share": share,
        "cublas_float64_bound_share": twin_share}
    checks.append({"kernel": name, "case": case, "max_abs_err": err,
                   "tolerance": "|Δ| <= 2·K·2^-24·(|a|·|x|) and "
                                "|got − exact| <= 2^-24·|exact| + "
                                "K·2^-52·(|a|·|x|)", "ok": ok,
                   **accuracy[f"{name} {case}"]})
    log(json.dumps({"phase": "kernels", **checks[-1]}))

  def float32_gram(a, b):
    return torch.matmul(a.transpose(-1, -2), b)

  # Kernel 6 alone: its C entry on buffers made beforehand, no wrapper.
  def panel_alone(op, x):
    batch = op.shape[0] if op.dim() == 3 else 1
    rows, depth = op.shape[-2:]
    out = torch.empty(op.shape[:-1] + (x.shape[-1],), device=dev)
    args = (op.data_ptr(), x.data_ptr(), out.data_ptr(), batch, rows, depth,
            op.stride(-2), op.stride(0) if op.dim() == 3 else 0, x.shape[-1],
            x.stride(-2), x.stride(-1), x.stride(0) if x.dim() == 3 else 0,
            stream)

    def run():
      rc = lib.sct_panel_matmul(*args)
      if rc:
        raise SystemExit(f"sct_panel_matmul: CUDA error {rc}")
    return run, out

  def panel_split(op, cols):
    """The k split (cluster size) the kernel takes for op by cols, and the
    card's resident blocks of that kernel."""
    splits, resident = ctypes.c_int(0), ctypes.c_int(0)
    vec = int(op.data_ptr() % 16 == 0 and op.stride(-2) % 4 == 0
              and (op.dim() == 2 or op.stride(0) % 4 == 0))
    rc = lib.sct_panel_matmul_schedule(
        op.shape[0] if op.dim() == 3 else 1, op.shape[-2], op.shape[-1],
        cols, vec, ctypes.byref(splits), ctypes.byref(resident))
    if rc:
      raise SystemExit(f"sct_panel_matmul_schedule: CUDA error {rc}")
    return {"k_split": splits.value, "resident_blocks": resident.value}

  panel_rows = results["panel_matmul_cases"] = {}

  def panel_case(case, op, q):
    """Kernel 6 on op by q's first 16, 8 and 1 columns (the iterations',
    the probe's and the norm steps' widths): the gates of check_bounded;
    two calls and the kernel alone equal bit for bit; the wrapper's, the
    kernel's alone and cuBLAS's float32 product's times beside the bound
    (one read of op, x and y; 2·M·K·b operations)."""
    for cols in (16, 8, 1):
      x = q[..., :cols]
      label = f"{case},b={cols}"
      got = fused.panel_matmul(op, x)
      check_bounded("panel_matmul", label, got,
                    fused.panel_matmul_plain(op, x), op, x)
      run, out = panel_alone(op, x)
      run()
      again = fused.panel_matmul(op, x)
      torch.cuda.synchronize()
      checks.append({"kernel": "panel_matmul",
                     "case": f"{label},two calls and the kernel alone",
                     "max_abs_err": float(torch.max(torch.abs(got - again))),
                     "tolerance": "equal bits",
                     "ok": torch.equal(got, again) and torch.equal(got, out)})
      log(json.dumps({"phase": "kernels", **checks[-1]}))
      batch = op.shape[0] if op.dim() == 3 else 1
      rows, depth = op.shape[-2:]
      bytes_ms = batch * (rows * depth + (rows + depth) * cols) * 4 / bw * 1e3
      ops_ms = 2 * batch * rows * depth * cols / fp32 * 1e3
      row = {"ms": time_ms(torch, lambda: fused.panel_matmul(op, x)),
             "kernel_alone_ms": time_ms(torch, run),
             "library_ms": time_ms(torch, lambda: torch.matmul(op, x)),
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             **panel_split(op, cols)}
      row["share_of_bound"] = row["bound_ms"] / row["ms"]
      panel_rows[label] = row
      log(json.dumps({"phase": "timing", "kernel": "panel_matmul",
                      "case": label, **row}))
      del got, again, out

  panel_case(f"N={n},certified operand", op_main, q_main)
  stripe = op_main[n // 4:n // 2]
  panel_case(f"rows {n // 4}:{n // 2} of N={n}", stripe, q_main)
  panel_case(f"{batch_case},batched operand", m_b, q_b)
  y_main = fused.panel_matmul(op_main, q_main)
  check_bounded("panel_gram", f"N={n},p=r=16,Ritz matrix",
                eigen_ops.panel_gram(q_main, y_main),
                float32_gram(q_main, y_main), q_main, y_main, gram=True)
  check_bounded("panel_gram", f"N={n},p=r=16,CholeskyQR2 Gram",
                eigen_ops.panel_gram(y_main, y_main),
                float32_gram(y_main, y_main), y_main, y_main, gram=True)
  y_b = fused.panel_matmul(m_b, q_b)
  check_bounded("panel_gram", f"{batch_case},p=r=16,Ritz matrix",
                eigen_ops.panel_gram(q_b, y_b), float32_gram(q_b, y_b),
                q_b, y_b, gram=True)
  # The float64 gate can fail: cuBLAS's float32 product (the twin) and
  # one TF32 product of the certified operand must each break it.
  rejected = {
      "float32": float64_share(fused.panel_matmul_plain(op_main, q_main),
                               op_main, q_main)[1],
      "tf32": float64_share(
          precision_lib.matmul(op_main, q_main, "default"), op_main,
          q_main)[1]}
  checks.append({"kernel": "panel_matmul",
                 "case": f"N={n},b=16,the float64 gate on other sums",
                 "max_abs_err": 0.0, "float64_bound_share": rejected,
                 "tolerance": "each share > 1 (rejected)",
                 "ok": all(v > 1.0 for v in rejected.values())})
  log(json.dumps({"phase": "kernels", **checks[-1]}))
  # Kernel 7, the CholeskyQR passes at both shifts in one launch, on the
  # certified route's panel and the batched step's (whose unshifted
  # operand leaves its panel's Gram ill conditioned) with their Grams.
  # Each of the pair's passes must equal the single-pass kernel at its
  # shift bit for bit (the same factorization and solve code), and info;
  # and each is held to the same pass computed in float64 from the same
  # float32 Gram: no farther from it than four times the twin's distance
  # (cuSOLVER's Cholesky, cuBLAS's solve; both float32 factorizations
  # whose error grows with the shifted Gram's condition), plus 1e-6. No
  # panel is flagged but where the first pass failed or left a non-finite
  # value; then one with an Inf in its last row must be, alone, and the
  # flag's workspace is zero after every launch.
  def float64_pass(y_in, gram_in, rel):
    g64 = gram_in.double()
    delta = rel * torch.clamp_min(torch.amax(
        torch.diagonal(g64, dim1=-2, dim2=-1), dim=-1), 1e-30)
    eye = torch.eye(g64.shape[-1], dtype=torch.float64, device=dev)
    low = torch.linalg.cholesky(g64 + delta[..., None, None] * eye)
    return torch.linalg.solve_triangular(
        low, y_in.double().transpose(-1, -2), upper=False).transpose(-1, -2)

  tickets = fused._qr_tickets(dev)
  for case, y_in in ((f"N={n},b=16", y_main), (f"{batch_case},b=16", y_b)):
    gram_in = eigen_ops.panel_gram(y_in, y_in)
    q1, q2, info_k, bad_k = fused.cholqr_pass_pair(y_in, gram_in, 1e-6, 1e-2)
    for rel, q_k in ((1e-6, q1), (1e-2, q2)):
      q_s, info_s = fused.cholqr_pass(y_in, gram_in, rel)
      q_p, info_p = fused.cholqr_pass_plain(y_in, gram_in, rel)
      exact = float64_pass(y_in, gram_in, rel)
      torch.cuda.synchronize()
      err_k = float(torch.max(torch.abs(q_k.double() - exact)))
      err_p = float(torch.max(torch.abs(q_p.double() - exact)))
      same = torch.equal(q_k, q_s) and (rel != 1e-6 or torch.equal(
          info_k, info_s))
      checks.append({
          "kernel": "cholqr_pass_pair", "case": f"{case},shift={rel}",
          "max_abs_err": float(torch.max(torch.abs(q_k - q_p))),
          "kernel_vs_float64": err_k, "cusolver_vs_float64": err_p,
          "equal_to_the_single_pass": same,
          "tolerance": "bits of the single pass; kernel_vs_float64 <= "
                       "4·cusolver_vs_float64 + 1e-6",
          "ok": same and err_k <= 4 * err_p + 1e-6
                and torch.equal(info_k.long(), info_p.long())
                and torch.equal(bad_k, (info_k != 0) | ~torch.all(
                    torch.isfinite(q1), dim=(-2, -1)))
                and not bool(torch.any(tickets))})
      log(json.dumps({"phase": "kernels", **checks[-1]}))
  y_inf = y_b.clone()
  y_inf[1, -1, 3] = torch.inf
  _, _, _, bad_inf = fused.cholqr_pass_pair(
      y_inf, eigen_ops.panel_gram(y_b, y_b), 1e-6, 1e-2)
  want_bad = [i == 1 for i in range(BATCH)]
  checks.append({"kernel": "cholqr_pass_pair",
                 "case": f"{batch_case},an Inf in panel 1's last row",
                 "max_abs_err": 0.0, "flags": bad_inf.tolist(),
                 "tolerance": "panel 1 flagged alone; workspace zero",
                 "ok": bad_inf.tolist() == want_bad
                       and not bool(torch.any(tickets))})
  log(json.dumps({"phase": "kernels", **checks[-1]}))
  del y_inf
  failed = [c for c in checks if not c["ok"]]
  if failed:
    raise SystemExit(f"kernel disagrees with its twin: {failed}")
  results["panel_accuracy"] = accuracy
  gram_main = eigen_ops.panel_gram(y_main, y_main)
  panel_timed = {
      # One read of the operand, the panel and the output; 2·M·K·b FLOP.
      "panel_matmul": (
          lambda: fused.panel_matmul(op_main, q_main),
          lambda: fused.panel_matmul_plain(op_main, q_main),
          lambda: torch.matmul(op_main, q_main),
          (n * n + 2 * n * 16) * 4, 2 * n * n * 16),
      # The panel read, both q written, the Gram read; the two forward
      # solves' 2·N·b² FLOP (the (b, b) Choleskys are negligible).
      "cholqr_pass_pair": (
          lambda: fused.cholqr_pass_pair(y_main, gram_main, 1e-6, 1e-2),
          lambda: fused.cholqr_pass_pair_plain(y_main, gram_main, 1e-6,
                                               1e-2),
          None, (3 * n * 16 + 16 * 16) * 4, 2 * n * 16 * 16),
  }
  no_library["cholqr_pass_pair"] = ("no single PyTorch call: two Choleskys "
                                    "and two triangular solves")
  with torch.no_grad():
    for name, (kern, plain, library, nbytes, nops) in panel_timed.items():
      bytes_ms = nbytes / bw * 1e3
      ops_ms = nops / fp32 * 1e3
      times[name] = {
          "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
          "library_ms": time_ms(torch, library) if library else None,
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
          "shape": f"N={n},b=16",
      }
      if name == "panel_matmul":
        case = panel_rows[f"N={n},certified operand,b=16"]
        times[name]["kernel_alone_ms"] = case["kernel_alone_ms"]
        batched = panel_rows[f"{batch_case},batched operand,b=16"]
        times[name][f"at_B={BATCH},N={N_BATCH}"] = {
            k: batched[k] for k in ("ms", "kernel_alone_ms", "library_ms",
                                    "bound_ms")}
      log(json.dumps({"phase": "timing", "kernel": name, **times[name]}))
    # Kernel 7 alone (its C entry on buffers made beforehand) beside its
    # wrapper, and the parent's way of running a CholeskyQR pass: the
    # single-pass kernel at each shift, alone and through its wrapper.
    # Then one CholeskyQR2 (two Grams, two pairs, two selections) against
    # the same with two single passes, isfinite, all and where per pass.
    qt2 = torch.empty((2, 16, n), device=dev)
    qt1 = torch.empty((16, n), device=dev)
    info_b = torch.empty((), dtype=torch.int32, device=dev)
    bad_b = torch.empty((), dtype=torch.bool, device=dev)
    yargs = (1, n, 16, 0, y_main.stride(0), y_main.stride(1))

    def pair_alone():
      rc = lib.sct_cholqr_pass_pair(
          y_main.data_ptr(), gram_main.data_ptr(), qt2.data_ptr(),
          info_b.data_ptr(), bad_b.data_ptr(), tickets.data_ptr(), *yargs,
          1e-6, 1e-2, stream)
      if rc:
        raise SystemExit(f"sct_cholqr_pass_pair: CUDA error {rc}")

    def single_alone(rel):
      rc = lib.sct_cholqr_pass(y_main.data_ptr(), gram_main.data_ptr(),
                               qt1.data_ptr(), info_b.data_ptr(), *yargs,
                               rel, stream)
      if rc:
        raise SystemExit(f"sct_cholqr_pass: CUDA error {rc}")

    def cholqr2_two_launches(y):
      for _ in range(2):
        gram = eigen_ops.panel_gram(y, y)
        y1, info = fused.cholqr_pass(y, gram, 1e-6)
        ok = (info == 0) & torch.all(torch.isfinite(y1), dim=(-2, -1))
        y2, _ = fused.cholqr_pass(y, gram, 1e-2)
        y = torch.where(ok[..., None, None], y1, y2)
      return y

    pair_alone()
    torch.cuda.synchronize()
    if not (torch.equal(qt2[0].T, fused.cholqr_pass_pair(
        y_main, gram_main, 1e-6, 1e-2)[0]) and not bool(tickets.any())):
      raise SystemExit("sct_cholqr_pass_pair alone disagrees with its "
                       "wrapper")
    if not torch.equal(eigen_ops.cholqr2_shifted(y_main),
                       cholqr2_two_launches(y_main)):
      raise SystemExit("CholeskyQR2 through the pair differs from the two "
                       "single passes")
    times["cholqr_pass_pair"].update({
        "kernel_alone_ms": time_ms(torch, pair_alone),
        "two_single_passes_ms": time_ms(torch, lambda: (
            fused.cholqr_pass(y_main, gram_main, 1e-6),
            fused.cholqr_pass(y_main, gram_main, 1e-2))),
        "two_single_passes_alone_ms": time_ms(torch, lambda: (
            single_alone(1e-6), single_alone(1e-2))),
        "cholqr2_ms": time_ms(torch,
                              lambda: eigen_ops.cholqr2_shifted(y_main)),
        "cholqr2_two_launches_ms": time_ms(
            torch, lambda: cholqr2_two_launches(y_main))})
    log(json.dumps({"phase": "timing", "kernel": "cholqr_pass_pair",
                    **times["cholqr_pass_pair"]}))
    del qt2, qt1
    # The solver's Gram (no kernel): the float64 product it takes on the
    # card against cuBLAS's float32 one, both with their casts.
    grams = results["panel_gram_ms"] = {}
    for case, (a, y) in ((f"N={n},b=16", (q_main, y_main)),
                         (f"{batch_case},b=16", (q_b, y_b))):
      grams[case] = {
          "float64_ms": time_ms(
              torch, lambda a=a, y=y: eigen_ops.panel_gram(a, y)),
          "float32_ms": time_ms(torch, lambda a=a, y=y: float32_gram(a, y))}
    log(json.dumps({"phase": "timing", "panel_gram": grams}))
  timed.update(panel_timed)

  # Launches per solver iteration: the subspace solver's launches at 48
  # iterations less those at 24 (the start and Rayleigh–Ritz cancel), by
  # 24.
  def solver_launches(iters):
    fused.reset_launch_counts()
    eigen_ops.topk_eigh_subspace(m, 8, torch.Generator().manual_seed(42),
                                 num_iters=iters)
    torch.cuda.synchronize()
    return fused.launch_counts()

  short, long_ = solver_launches(24), solver_launches(48)
  results["launches_per_solver_iteration"] = {
      k: (long_[k] - short[k]) / 24 for k in ("panel_matmul", "cholqr_pass",
                                              "cholqr_pass_pair")}
  log(json.dumps({"phase": "kernels", "launches_per_solver_iteration":
                  results["launches_per_solver_iteration"]}))
  del op_main, q_main, y_main, stripe, m_b, q_b, y_b, gram_main

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
  del x_b, aff_b, blurred_b, crop_scratch_b, thr_b, thr_b_ragged, nv_b
  del diffused_b

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

  # The certified route as the CPU takes it: both packages' runs of
  # _certified_iterative_topt on each operand below, built on the CPU
  # (tools/record_dc_route_reference.py).
  with open(os.path.join(HERE, "tests", "data",
                         "reference_dc_route.json")) as f:
    route_ref = json.load(f)["cases"]

  def certified_route(m, case):
    """The certified route alone (one cold run, DC_REPS - 1 timed), its
    residual after each 32-iteration chunk printed beside the route the
    port took on the CPU and the JAX package's, both recorded for the same
    operand. Fails if the card's route (accepted or declined) differs from
    the JAX package's, or if the card runs to the iteration cap where the
    CPU certified below it."""
    runs = []
    for _ in range(DC_REPS):
      info = {}
      seconds, out = host_s(lambda: dc_ops._certified_iterative_topt(
          m, t_dc, dc_generator(), True, None, info))
      runs.append(seconds)
    ref_case = route_ref[case]
    cpu = {k: ref_case["port"][k] for k in (
        "accepted", "iters", "res_abs", "res", "res_trace")
           if k in ref_case["port"]}
    row = {"accepted": out is not None, **info, "seconds_cold": runs[0],
           "seconds": statistics.median(runs[1:]),
           "cpu_recorded": cpu, "jax_recorded": {
               k: ref_case["jax"][k] for k in ("accepted", "res")}}
    log(json.dumps({"phase": "dc_route", "case": case,
                    "accepted": row["accepted"], "iters": info["iters"],
                    "res_abs": info["res_abs"], "res": info.get("res"),
                    "res_trace": info["res_trace"],
                    "cpu_accepted": cpu["accepted"], "cpu_iters": cpu["iters"],
                    "cpu_res_abs": cpu["res_abs"],
                    "cpu_res_trace": cpu["res_trace"],
                    "jax_accepted": ref_case["jax"]["accepted"],
                    "jax_res": ref_case["jax"]["res"]}))
    if row["accepted"] != ref_case["jax"]["accepted"]:
      raise SystemExit(f"dc route, {case}: the card's certified route "
                       f"{'accepted' if row['accepted'] else 'declined'}, "
                       "the JAX package's "
                       + ("accepted" if ref_case["jax"]["accepted"]
                          else "declined"))
    cap = dc_ops._SUBSPACE_MAX_ITERS
    if cpu["iters"] < cap <= info["iters"]:
      raise SystemExit(f"dc route, {case}: the card ran to the {cap}-"
                       f"iteration cap where the CPU certified after "
                       f"{cpu['iters']}")
    if out is not None and not out[2] <= 1e-5:
      raise SystemExit(f"dc route, {case}: certified residual {out[2]}")
    return row, out

  def dc_breakdown(m, n, case, split_precisions):
    row = {"phase": "dc_breakdown", "n": n, "case": case}
    row["certified"], out = certified_route(m, case)
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
    # The split alone (try_iterative_first=False), held to the certified
    # route's eigenvalues, or to the full eigh's top t where the route
    # declined.
    want, what, scale = ((w_top, "the full eigh's", None) if out is None
                         else (out[0], "the certified route's", out[3]))
    row["split"] = []
    for precision in split_precisions:
      w, split = run_split(m, n, try_iterative_first=False,
                           sign_precision=precision)
      split["max_abs_diff_vs_reference"] = err = float(
          torch.max(torch.abs(w - want)))
      split["reference"] = what
      row["split"].append(split)
      log(json.dumps({"phase": "dc_split", "n": n, **split}))
      if not err <= 2e-4 * (scale or split["scale"]):
        raise SystemExit(f"split at N={n}, {precision}: eigenvalues differ "
                         f"from {what} by {err}")
    del w_top, u_top
    log(json.dumps({k: v for k, v in row.items() if k != "split"}))
    return row

  def big_operand(x):
    aff = fused.affinity(torch.as_tensor(x).to(dev))
    op, _ = pipeline._symmetric_eig_operand(aff, cfg, None, None,
                                            ref_ops.ROWNORM_TAIL,
                                            consume_input=True)
    return op

  results["dc_breakdown"] = [dc_breakdown(m, N_MAIN, f"n{N_MAIN}_k2",
                                          ("highest", "high"))]
  del m
  # At N_BIG the split at the sign chain's default precision only; the
  # route at k=4 and k=7 alone.
  m = big_operand(make_embeddings(N_BIG, D_MAIN))
  results["dc_breakdown"].append(dc_breakdown(
      m, N_BIG, f"n{N_BIG}_k2", (dc_ops._sign_precision(),)))
  # Kernel 6 at N_BIG as at N_MAIN: the certified route's shifted operand,
  # and a quarter of its rows (a stripe of the row-sharded path at four
  # shards).
  op_big = m.clone()
  op_big.diagonal().add_(float(torch.amax(torch.sum(torch.abs(m), dim=1)))
                         + 1.0)
  del m
  q_big = eigen_ops.cholqr2_shifted(eigen_ops.start_panel(
      N_BIG, 16, dc_generator(), torch.float32, dev))
  with torch.no_grad():
    panel_case(f"N={N_BIG},certified operand", op_big, q_big)
    panel_case(f"rows {N_BIG // 4}:{N_BIG // 2} of N={N_BIG}",
               op_big[N_BIG // 4:N_BIG // 2], q_big)
  del op_big, q_big
  torch.cuda.empty_cache()
  failed = [c for c in checks if not c["ok"]]
  if failed:
    raise SystemExit(f"kernel disagrees with its twin: {failed}")
  results["dc_route_multi"] = {}
  for k in MULTI_KS:
    m = big_operand(make_embeddings_k(N_MAIN, k, D_MAIN)[0])
    results["dc_route_multi"][f"k{k}"], _ = certified_route(
        m, f"n{N_MAIN}_k{k}")
    del m
  torch.cuda.empty_cache()
  mark("dc_breakdown")

  # 3c. Kernel 8 (the whole K-Means) against its twin on what the main
  # path hands it: the spectral embeddings that the icassp2018 predict
  # passes to kmeans_fit at N_BATCH (a call's size), N_MAIN and N_BIG, and
  # the ragged (16, 1024) chunk that cluster_batch passes to
  # kmeans_fit_batched.
  km_inputs = {}
  fit, fit_batched = kmeans_ops.kmeans_fit, kmeans_ops.kmeans_fit_batched

  def fit_spy(x, n_clusters, generator=None, **kw):
    key = kw.get("key")
    km_inputs[f"N={x.shape[-2]}"] = (
        x.clone(), n_clusters,
        prng.key(generator.initial_seed()) if key is None else key,
        kw["k_max"], kw["sample_weight"], kw.get("draw_rows"),
        kw["max_iter"], kw["tol"])
    return fit(x, n_clusters, generator, **kw)

  def fit_batched_spy(x, n_clusters, keys, **kw):
    km_inputs[f"B={x.shape[0]},N={x.shape[1]},ragged"] = (
        x.clone(), n_clusters.clone(), np.array(keys), kw["k_max"],
        kw["sample_weight"].clone(), None, kw["max_iter"], kw["tol"])
    return fit_batched(x, n_clusters, keys, **kw)

  kmeans_ops.kmeans_fit = fit_spy
  kmeans_ops.kmeans_fit_batched = fit_batched_spy
  try:
    for n in (N_BATCH, N_MAIN, N_BIG):
      configs.make_icassp2018_clusterer().predict(make_embeddings(n, D_MAIN))
    km_lengths = (1024, 1000, 777, 512, 300, 1024, 256, 900) * 2
    batch_lib.cluster_batch(
        [make_embeddings_k(n, 2 + i % 6, D_MAIN, seed=i)[0]
         for i, n in enumerate(km_lengths)],
        pipeline.PipelineConfig(
            refinement_options=configs.icassp2018_refinement_options(),
            min_clusters=2, max_clusters=7, custom_dist="cosine",
            max_iter=300, eigensolver=EigenSolver.Auto),
        mesh_lib.make_mesh())
  finally:
    kmeans_ops.kmeans_fit = fit
    kmeans_ops.kmeans_fit_batched = fit_batched
  # The latencies kernel 8 waits on (tools/kmeans_latency.cu): each probe
  # at 0 and KM_PROBE_REPS steps, timed as the kernel is.
  probe = ctypes.CDLL(build.build((os.path.join(HERE, "tools",
                                                "kmeans_latency.cu"),)))
  probe.probe_kmeans_latency.argtypes = [ctypes.c_int] * 3 + [
      ctypes.c_void_p] * 2
  probe.probe_kmeans_latency.restype = ctypes.c_int
  probe_out = torch.empty((1,), device=dev)

  def probe_ms(what, m, reps):
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
      rc = probe.probe_kmeans_latency(what, m, reps, probe_out.data_ptr(),
                                      stream)
      if rc:
        raise SystemExit(f"probe_kmeans_latency: CUDA error {rc}")
    return time_ms(torch, run)

  km_launch_ms = probe_ms(0, 1, 0)
  km_lat = {}
  for name, what, m in (("sync", 0, 1), ("sum_wide", 1, 72), ("sum_1", 2, 1),
                        ("sum_trials", 2, 3), ("argmax_1", 3, 1),
                        ("argmax_trials", 3, 3), ("draw_1", 4, 1),
                        ("draws_trials", 4, 3)):
    km_lat[name] = (probe_ms(what, m, KM_PROBE_REPS) - km_launch_ms) / (
        KM_PROBE_REPS)
  km_lat["launch"] = km_launch_ms
  log(json.dumps({"phase": "kmeans_latency_ms", **km_lat}))

  def kmeans_latency_ms(n, k_max, rounds):
    """Kernel 8's latency model at width 8 (one pass of eight clusters, 3
    trials): its launch, then its block-wide steps in order, each at the
    latency measured above, and each thread's draws one row after another;
    the per-row arithmetic between the steps is left out."""
    rows = -(-n // KM_THREADS)
    lat = km_lat
    seed = (lat["sync"]
            + rows * lat["draw_1"] + lat["argmax_1"] + 2 * lat["sync"]
            + (k_max - 1) * (rows * lat["draws_trials"]
                             + lat["argmax_trials"] + 3 * lat["sync"]
                             + lat["sum_trials"]))
    lloyd = (lat["sum_1"] + lat["sync"] + rounds * lat["sum_1"]
             + (rounds - 1) * (lat["sum_wide"] + 2 * lat["sync"]))
    return lat["launch"] + seed + lloyd

  def kmeans_against_twin(args_, got, want):
    """Per utterance: rounds, labels equal, the centroids' largest gap;
    the stop rule's mean at each side's stopping round (the weighted mean
    of each row's least cosine distance to the centroids it stopped with);
    whether the k-means++ seeds (max_iter=0) equal the twin's on the card
    and, where they part, the twin's on the CPU (the path the CPU tests
    hold against the JAX package), with the centroids' gap to that run."""
    n, d, k_max = args_[0].shape[-2], args_[0].shape[-1], args_[3]
    x_u, w_u = args_[0].reshape(-1, n, d), args_[4].reshape(-1, n)
    n_cl = torch.as_tensor(args_[1]).reshape(-1).expand(x_u.shape[0])
    seed_args = args_[:6] + (0, args_[7])
    seeds = [fn(*seed_args)[1].reshape(-1, k_max, d)
             for fn in (fused.kmeans, fused.kmeans_plain)]
    host_args = tuple(a.cpu() if torch.is_tensor(a) else a for a in args_)
    host = None
    lab = [o[0].reshape(-1, n) for o in (got, want)]
    cen = [o[1].reshape(-1, k_max, d) for o in (got, want)]
    rnd = [o[2].reshape(-1) for o in (got, want)]

    def gap(a, b):
      return float(torch.max(torch.abs(a.cpu() - b.cpu())))

    rows = []
    for u in range(x_u.shape[0]):
      live = w_u[u] > 0
      xs, ws = x_u[u][live], w_u[u][live]
      means = [float(torch.sum(affinity_ops.cdist_cosine(
          xs, c[u, :int(n_cl[u])]).min(-1).values * ws) / torch.sum(ws))
               for c in cen]
      row = {
          "u": u, "n_clusters": int(n_cl[u]), "rounds": int(rnd[0][u]),
          "twin_rounds": int(rnd[1][u]),
          "labels_equal": bool(torch.equal(lab[0][u], lab[1][u])),
          "centroid_gap": gap(cen[0][u], cen[1][u]),
          "stop_mean": means[0], "twin_stop_mean": means[1],
          "seeds_gap": gap(seeds[0][u], seeds[1][u]),
          # Rows of one tight cluster lie this close: k-means++'s
          # potentials of two of them tie to the sums' rounding.
          "seeds_tol": KM_SEED_RTOL * float(torch.amax(torch.linalg.norm(
              xs, dim=-1)))}
      if row["seeds_gap"] > row["seeds_tol"]:
        if host is None:
          host = [fused.kmeans_plain(*a_) for a_ in (
              host_args[:6] + (0, host_args[7]), host_args)]
        row["cpu_seeds_gap"] = gap(seeds[0][u],
                                   host[0][1].reshape(-1, k_max, d)[u])
        row["cpu_rounds"] = int(host[1][2].reshape(-1)[u])
        row["cpu_centroid_gap"] = gap(cen[0][u],
                                      host[1][1].reshape(-1, k_max, d)[u])
      rows.append(row)
    return rows

  km_rows = []
  for case, args_ in km_inputs.items():
    x_km, k_max = args_[0], args_[3]
    if max(k_max, x_km.shape[-1]) > 8 or 2 + int(np.log(k_max)) != 3:
      raise SystemExit(f"kmeans {case}: the latency model is for width 8 "
                       "and 3 trials")
    got, want = fused.kmeans(*args_), fused.kmeans_plain(*args_)
    check("kmeans", f"{case},labels", got[0].float(), want[0].float(), True)
    per_utt = kmeans_against_twin(args_, got, want)
    log(json.dumps({"phase": "kernels", "kernel": "kmeans", "case": case,
                    "utterances": per_utt}))
    # Rounds may differ only where the stop rule's mean sits at 0; seeds
    # may part from the twin on the card only where they are the twin's
    # on the CPU (cuBLAS rounds k-means++'s potentials otherwise), and the
    # centroids are then held against that run.
    same = [u["u"] for u in per_utt if u["rounds"] == u["twin_rounds"]
            and u["seeds_gap"] <= u["seeds_tol"]]
    if same:
      check("kmeans", f"{case},centroids",
            got[1].reshape(-1, k_max, x_km.shape[-1])[same],
            want[1].reshape(-1, k_max, x_km.shape[-1])[same], False)
    parted = [u for u in per_utt if u["seeds_gap"] > u["seeds_tol"]]
    for name, off, err, tol in (
        ("rounds", [u for u in per_utt if u["rounds"] != u["twin_rounds"]
                    and not (abs(u["stop_mean"]) <= KM_BOUNDARY
                             and abs(u["twin_stop_mean"]) <= KM_BOUNDARY)],
         max(abs(u["rounds"] - u["twin_rounds"]) for u in per_utt),
         f"exact, or both stop means within {KM_BOUNDARY} of 0"),
        ("seeds", [u for u in parted if u["cpu_seeds_gap"] > u["seeds_tol"]],
         max(u["seeds_gap"] for u in per_utt),
         f"the card twin's, or the CPU twin's, within {KM_SEED_RTOL} of "
         "the rows' largest norm"),
        ("centroids where the seeds are the CPU twin's",
         [u for u in parted if u["rounds"] == u["cpu_rounds"]
          and not u["cpu_centroid_gap"] <= 1e-5],
         max([u["cpu_centroid_gap"] for u in parted] or [0.0]),
         "1e-5 where the rounds are the CPU twin's")):
      checks.append({"kernel": "kmeans", "case": f"{case},{name}",
                     "max_abs_err": err, "tolerance": tol, "ok": not off})
      log(json.dumps({"phase": "kernels", **checks[-1]}))
    fused.reset_launch_counts()
    kernel_ms = time_ms(torch, lambda a=args_: fused.kmeans(*a))
    calls = 3 + REPS * (1 + EVENT_BATCH)
    launches = fused.launch_counts()
    plain_ms = time_ms(torch, lambda a=args_: fused.kmeans_plain(*a),
                       reps=3, batch=2, warmup=1)
    rounds = got[2].reshape(-1).tolist()
    bound = max(kmeans_latency_ms(x_km.shape[-2], k_max, r) for r in rounds)
    km_rows.append({
        "case": case, "rounds": rounds, "ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
        "bound_by": "latency", "share_of_bound": bound / kernel_ms,
        "launches_per_call": launches["kmeans"] / calls,
        "other_launches": sum(launches.values()) - launches["kmeans"]})
    log(json.dumps({"phase": "timing", "kernel": "kmeans", **km_rows[-1]}))
    if launches["kmeans"] != calls or km_rows[-1]["other_launches"]:
      raise SystemExit(f"kmeans {case}: launches {launches} for {calls} "
                       "calls")
  failed = [c for c in checks if not c["ok"]]
  if failed:
    raise SystemExit(f"kernel disagrees with its twin: {failed}")
  results["kmeans"] = {"latency_ms": km_lat, "cases": km_rows}
  times["kmeans"] = {**km_rows[0], "cases": km_rows}
  timed["kmeans"] = None
  no_library["kmeans"] = ("no single PyTorch call: k-means++ and the Lloyd "
                          "loop are ~550 calls")
  del km_inputs, x_km, got, want
  torch.cuda.empty_cache()
  mark("kmeans")

  # 4. Paths: each leg's launch counts are zeroed after its cold run and
  # read after its warm runs.
  ref = np.load(os.path.join(HERE, "benchmarks", "reference_labels.npz"))
  ref_multi = np.load(os.path.join(HERE, "benchmarks",
                                   "reference_labels_multi.npz"))
  main_kernels = ("affinity", "row_max", "crop_diagonal",
                  "threshold_symmetrize_general")
  # The subspace solver's kernels: every leg that runs a subspace solve
  # (SubspaceIteration, the certified route, the split's remainder).
  solver_kernels = ("panel_matmul", "cholqr_pass_pair")
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
    if launches["kmeans"] != warm_runs:
      raise SystemExit(f"{leg}: {launches['kmeans']} K-Means launches "
                       f"(kernel 8) in {warm_runs} predicts")
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
        N_MAIN, WARM_RUNS, main_kernels + solver_kernels, solver=solver.name)
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
      N_MAIN, API_WARM_RUNS, main_kernels + solver_kernels, solver="Auto",
      post_eigen_cluster_function="run_kmeans")
  # The exact top-k route at the other record sizes and speaker counts.
  auto = configs.make_icassp2018_clusterer(staged_stage_timings=True)
  runs["Auto_20480"] = drive("Auto_20480", auto, N_BIG, 1,
                             main_kernels + solver_kernels, small_sizes=(),
                             solver="Auto")
  for k in MULTI_KS:
    emb, _ = make_embeddings_k(N_MAIN, k, D_MAIN)
    runs[f"Auto_k{k}"] = drive(
        f"Auto_k{k}", auto, N_MAIN, 1, main_kernels + solver_kernels, emb=emb,
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
  # Each Auto leg's dc solves take the route that the JAX package took on
  # the same operand built on the CPU (tests/data/reference_dc_route.json),
  # and certify below the iteration cap where the CPU did.
  for leg, case in (("Auto", f"n{N_MAIN}_k2"), ("Auto_20480", f"n{N_BIG}_k2"),
                    *((f"Auto_k{k}", f"n{N_MAIN}_k{k}") for k in MULTI_KS)):
    want = "certified" if route_ref[case]["jax"]["accepted"] else "split"
    if set(runs[leg]["dc_routes"]) != {want}:
      raise SystemExit(f"{leg} took {runs[leg]['dc_routes']}, the JAX "
                       f"package's route is {want}")
    iters = runs[leg]["dc"]["iters"]
    cpu_iters = route_ref[case]["port"]["iters"]
    if cpu_iters < dc_ops._SUBSPACE_MAX_ITERS <= iters:
      raise SystemExit(f"{leg}: the certified route ran to the iteration cap "
                       f"where the CPU certified after {cpu_iters}")
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
                     "steps_left_right": [int(s) for s in e2cp_steps],
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

  # 7. Batch clustering (parallel/batch.py) at the JAX batch bench's shape:
  # one batched step per chunk on the card.
  batch_ref = np.load(os.path.join(HERE, "tests", "data",
                                   "reference_batch.npz"))
  mesh = mesh_lib.make_mesh()
  bcfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, custom_dist="cosine", max_iter=300,
      eigensolver=EigenSolver.Auto)
  # Launches of one chunk on one card: each batched kernel once, row_max
  # twice (CropDiagonal's statistic is in crop_diagonal; the RowMax
  # threshold and the ROWNORM_TAIL scale are the two row_max launches).
  per_chunk = {"affinity_batched": 1, "row_max_batched": 2,
               "crop_diagonal_batched": 1,
               "threshold_symmetrize_general_batched": 1, "kmeans": 1}

  def expected(chunks, per=None):
    return {k: (per or per_chunk).get(k, 0) * chunks
            for k in fused.launch_counts()}

  def solver_launches_ok(launches, want):
    """The refinement kernels as ``want`` says; the subspace solver's
    kernels at least once (their count follows the iterations)."""
    return ({k: v for k, v in launches.items() if k not in solver_kernels}
            == {k: v for k, v in want.items() if k not in solver_kernels}
            and all(launches[k] for k in solver_kernels))

  def ordered_equal(got, want):
    return bool(np.array_equal(utils.enforce_ordered_labels(got),
                               utils.enforce_ordered_labels(want)))

  def gt_match(preds, truths):
    return sum(ordered_equal(p, t) for p, t in zip(preds, truths))

  def timed_call(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0

  def predicted_peak_gb(b):
    return PEAK_BUFFERS * b * N_BATCH * N_BATCH * 4 / 1e9

  utts, truths = make_batch(BATCH, N_BATCH, D_MAIN)
  cold, cold_s = timed_call(lambda: batch_lib.cluster_batch(utts, bcfg, mesh))
  fused.reset_launch_counts()
  torch.cuda.reset_peak_memory_stats()
  warm_s = []
  for _ in range(BATCH_WARM_RUNS):
    labels_b, seconds = timed_call(
        lambda: batch_lib.cluster_batch(utts, bcfg, mesh))
    warm_s.append(seconds)
  launches = fused.launch_counts()
  per_call = {k: v / BATCH_WARM_RUNS for k, v in launches.items()}
  ref_labels = list(batch_ref["batch_labels"])
  run = {
      "leg": "cluster_batch", "batch": BATCH, "n": N_BATCH, "d": D_MAIN,
      "mesh": mesh.shape, "chunks_per_call": 1,
      "parity": all(ordered_equal(a, b) for a, b in
                    zip(labels_b, ref_labels)),
      "parity_ids": all(np.array_equal(a, b.astype(a.dtype))
                        for a, b in zip(labels_b, ref_labels)),
      "warm_equal_cold": all(np.array_equal(a, b)
                             for a, b in zip(labels_b, cold)),
      "gt_match": gt_match(labels_b, truths),
      "cold_wall_s": cold_s, "warm_wall_s": statistics.median(warm_s),
      "warm_wall_s_runs": warm_s,
      "utterances_per_s": BATCH / statistics.median(warm_s),
      "launches": launches, "launches_per_chunk": per_call,
      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
      "predicted_peak_mem_gb": predicted_peak_gb(BATCH),
  }

  # The batched step's stages, each card-synced: prep (affinity,
  # refinement, eigen operand), the batched eigh, finish (snap, eigengap,
  # K-Means); its labels must be the batch's. Then its Lloyd loop alone
  # with every host read forbidden between the stop checks, and the
  # rounds each utterance ran.
  x_b = torch.as_tensor(np.stack(utts)).to(dev)
  nv_b = torch.full((BATCH,), N_BATCH, dtype=torch.int32, device=dev)
  keys_b = np.stack([prng.key(i) for i in range(BATCH)])
  for _ in range(2):  # a cold pass, then the timed one
    stage_timings = observability.StageTimings(dev)
    with fp32_precision():
      with stage_timings.stage("batched_prep"):
        m_b, scale_b = pipeline._symmetric_eig_operand(
            pipeline.prepare_affinity(x_b, bcfg, nv_b), bcfg, None, nv_b,
            ref_ops.ROWNORM_TAIL, consume_input=True)
      with stage_timings.stage("batched_eigh"):
        w_b, u_b = eigen_ops.sorted_eigh(m_b)
      del m_b
      with stage_timings.stage("batched_finish"):
        v_b = eigen_ops.recover_similarity_eigenvectors(u_b, scale_b, nv_b)
        _, n_gap_b, _ = pipeline._gap(w_b, bcfg, True, nv_b)
        split_labels, n_cl_b = pipeline._cluster_from_eigs_batched(
            v_b, n_gap_b, bcfg, keys_b, nv_b, 0.001)
  run["stage_split_s"] = stage_timings.as_dict()
  run["stage_split_labels_equal"] = all(
      np.array_equal(a, b) for a, b in zip(split_labels.cpu().numpy(),
                                           labels_b))
  with fp32_precision():
    emb_b = pipeline.spectral_embeddings_from_eigs(v_b, n_cl_b, 7, False,
                                                   nv_b)
    weight_b = torch.ones((BATCH, N_BATCH), device=dev)
    cents_b = kmeans_ops.kmeans_plusplus_batched(emb_b, 7, keys_b, weight_b)
    dist_b = affinity_ops.get_batched_distance_fn("cosine")
    want_lloyd = kmeans_ops.lloyd_iterations_batched(
        emb_b, cents_b, n_cl_b, dist_b, 300, 0.001, weight_b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
      got_lloyd = kmeans_ops._lloyd(emb_b, cents_b, n_cl_b, dist_b, 300,
                                    0.001, weight_b, check_every=10 ** 9)
    finally:
      torch.cuda.set_sync_debug_mode("default")
  run["lloyd_rounds"] = want_lloyd[2].cpu().tolist()
  run["lloyd_stop_check_rounds"] = kmeans_ops.STOP_CHECK_ROUNDS
  run["lloyd_without_host_reads_equal"] = all(
      torch.equal(a, b) for a, b in zip(got_lloyd, want_lloyd))
  del x_b, u_b, v_b, emb_b, cents_b
  results["batch"] = run
  log(json.dumps({"phase": "batch", **run}))
  if not run["parity_ids"]:
    raise SystemExit("cluster_batch: labels differ from the JAX package's")
  if not run["stage_split_labels_equal"]:
    raise SystemExit("cluster_batch: the staged split's labels differ")
  if not run["lloyd_without_host_reads_equal"]:
    raise SystemExit("cluster_batch: Lloyd without host reads differs")
  if launches != expected(BATCH_WARM_RUNS):
    raise SystemExit(f"cluster_batch: launches per chunk {per_call}, "
                     f"expected {per_chunk}")
  mark("batch")

  # The batched step's other two eigensolvers on the same utterances: one
  # batched SubspaceIteration solve per chunk (each utterance frozen at its
  # own convergence), and HostGeneral's kernel 5b with one host eig of the
  # chunk. Each is held against the 2-D pipeline on each utterance on the
  # card and against the JAX package's labels
  # (tests/data/reference_batch_solvers.npz).
  solver_ref = np.load(os.path.join(HERE, "tests", "data",
                                    "reference_batch_solvers.npz"))

  def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0

  def per_utterance_2d(cfg, xs):
    """The 2-D pipeline on each utterance alone, as a chunk holds it
    (n_valid=N, the K-Means stream of PRNGKey(i))."""
    return [pipeline.spectral_cluster_fixed_k(
        x, torch.Generator().manual_seed(i), cfg, n_valid=N_BATCH)
            for i, x in enumerate(xs)]

  def ritz_err(w, want):
    """max |w - want| over the first k, relative to max|want|."""
    k = min(w.shape[-1], want.shape[-1], bcfg.max_clusters + 1)
    return float(torch.amax(torch.abs(w[:k] - want[:k]))
                 / torch.amax(torch.abs(want[:k])))

  def against_2d(labels, n_clusters, w, alone):
    return {
        "labels_equal_2d": all(np.array_equal(a, b[0].cpu().numpy())
                               for a, b in zip(labels, alone)),
        "n_clusters_equal_2d": [int(a) for a in n_clusters] == [
            int(b[1]) for b in alone],
        "ritz_err_2d": max(ritz_err(a, b[2]) for a, b in zip(w, alone))}

  x_b = torch.as_tensor(np.stack(utts)).to(dev)
  nv_b = torch.full((BATCH,), N_BATCH, dtype=torch.int32, device=dev)
  keys_b = np.stack([prng.key(i) for i in range(BATCH)])
  scfg = bcfg.replace(eigensolver=EigenSolver.SubspaceIteration)
  _, cold_s = timed_call(lambda: batch_lib.cluster_batch(utts, scfg, mesh))
  fused.reset_launch_counts()
  warm_s = []
  for _ in range(BATCH_WARM_RUNS):
    labels_s, seconds = timed_call(
        lambda: batch_lib.cluster_batch(utts, scfg, mesh))
    warm_s.append(seconds)
  launches = fused.launch_counts()
  step_labels, step_n, step_w, _ = pipeline.spectral_cluster_fixed_k_batched(
      x_b, keys_b, scfg, n_valid=nv_b)
  alone, alone_s = synced(lambda: per_utterance_2d(scfg, x_b))
  # The eig stage alone: the chunk's one batched solve against the 2-D
  # solve of each utterance in turn, on the same operand.
  with fp32_precision():
    m_b, _ = pipeline._symmetric_eig_operand(
        pipeline.prepare_affinity(x_b, scfg, nv_b), scfg, None, nv_b,
        ref_ops.ROWNORM_TAIL, consume_input=True)
    for _ in range(2):  # a cold pass, then the timed one
      stats = {}
      (w_solve, _), eig_s = synced(
          lambda: pipeline._subspace(m_b, scfg, nv_b, True, stats))
      loop_stats = [{} for _ in range(BATCH)]
      loop_w, loop_s = synced(lambda: [
          pipeline._subspace(m, scfg, N_BATCH, True, st)[0]
          for m, st in zip(m_b, loop_stats)])
  del m_b
  run = {
      "leg": "cluster_batch_subspace", "batch": BATCH, "n": N_BATCH,
      "d": D_MAIN, "eigensolver": "SubspaceIteration",
      "parity_ids": all(np.array_equal(a, b.astype(a.dtype)) for a, b in
                        zip(labels_s, solver_ref["subspace_labels"])),
      "step_labels_equal_driver": all(
          np.array_equal(a, b) for a, b in
          zip(step_labels.cpu().numpy(), labels_s)),
      **against_2d(labels_s, step_n, step_w, alone),
      "gt_match": gt_match(labels_s, truths),
      "cold_wall_s": cold_s, "warm_wall_s": statistics.median(warm_s),
      "warm_wall_s_runs": warm_s,
      "utterances_per_s": BATCH / statistics.median(warm_s),
      "iters_per_utterance": stats["iters"].tolist(),
      "iters_per_utterance_2d": [st["iters"] for st in loop_stats],
      "eig_batched_s": eig_s, "eig_2d_loop_s": loop_s,
      "eig_ritz_err_2d": max(ritz_err(a, b) for a, b in zip(w_solve, loop_w)),
      "pipeline_2d_loop_s": alone_s,
      "launches": launches,
      "launches_per_chunk": {k: v / BATCH_WARM_RUNS
                             for k, v in launches.items()},
  }
  results["batch_subspace"] = run
  log(json.dumps({"phase": "batch_subspace", **run}))
  if not (run["parity_ids"] and run["step_labels_equal_driver"]):
    raise SystemExit("cluster_batch (SubspaceIteration): labels differ from "
                     "the JAX package's or the batched step's")
  if not (run["labels_equal_2d"] and run["n_clusters_equal_2d"]):
    raise SystemExit("cluster_batch (SubspaceIteration): labels or counts "
                     "differ from the 2-D pipeline's")
  if not (run["ritz_err_2d"] <= SOLVER_EIG_RTOL
          and run["eig_ritz_err_2d"] <= SOLVER_EIG_RTOL):
    raise SystemExit("cluster_batch (SubspaceIteration): Ritz values differ "
                     f"from the 2-D solve's by more than {SOLVER_EIG_RTOL}")
  if not solver_launches_ok(launches, expected(BATCH_WARM_RUNS)):
    raise SystemExit(f"cluster_batch (SubspaceIteration): launches "
                     f"{launches}, expected {expected(BATCH_WARM_RUNS)} and "
                     f"{solver_kernels}")
  mark("batch_subspace")

  # The batched SubspaceIteration on utterances that stop at other
  # iterations: make_embeddings_k(N_BATCH, k) for k in RAGGED_KS, with the
  # certified route's solver constants (chunks of 32 iterations, residual
  # 1e-6, at most 2,048), so each utterance is frozen at its own stop while
  # the others go on. The same label gates as above, against
  # tests/data/reference_batch_ragged.npz (the JAX package's labels, id
  # for id) and the speakers; prints each lane's iterations and the
  # batched solve's seconds beside the 2-D solves'.
  ragged_ref = np.load(os.path.join(HERE, "tests", "data",
                                    "reference_batch_ragged.npz"))
  rcfg = scfg.replace(subspace_iters=32, subspace_residual_tol=1e-6,
                      subspace_max_iters=2048, subspace_drift_tol=None)
  r_utts, r_truths = zip(*(make_embeddings_k(N_BATCH, k, D_MAIN)
                           for k in RAGGED_KS))
  r_utts, rb = list(r_utts), len(RAGGED_KS)
  _, cold_s = timed_call(lambda: batch_lib.cluster_batch(r_utts, rcfg, mesh))
  fused.reset_launch_counts()
  labels_r, warm_s = timed_call(
      lambda: batch_lib.cluster_batch(r_utts, rcfg, mesh))
  launches = fused.launch_counts()
  x_r = torch.as_tensor(np.stack(r_utts)).to(dev)
  nv_r = torch.full((rb,), N_BATCH, dtype=torch.int32, device=dev)
  step_labels, step_n, step_w, _ = pipeline.spectral_cluster_fixed_k_batched(
      x_r, np.stack([prng.key(i) for i in range(rb)]), rcfg, n_valid=nv_r)
  alone, alone_s = synced(lambda: per_utterance_2d(rcfg, x_r))
  with fp32_precision():
    m_r, _ = pipeline._symmetric_eig_operand(
        pipeline.prepare_affinity(x_r, rcfg, nv_r), rcfg, None, nv_r,
        ref_ops.ROWNORM_TAIL, consume_input=True)
    for _ in range(2):  # a cold pass, then the timed one
      stats = {}
      (w_solve, _), eig_s = synced(
          lambda: pipeline._subspace(m_r, rcfg, nv_r, True, stats))
      loop_stats = [{} for _ in range(rb)]
      loop_w, loop_s = synced(lambda: [
          pipeline._subspace(mm, rcfg, N_BATCH, True, st)[0]
          for mm, st in zip(m_r, loop_stats)])
  del m_r, x_r
  run = {
      "leg": "cluster_batch_subspace_ragged", "batch": rb, "n": N_BATCH,
      "d": D_MAIN, "speakers": list(RAGGED_KS),
      "eigensolver": "SubspaceIteration, 32 / 1e-6 / 2048",
      "parity_ids": all(np.array_equal(a, b.astype(a.dtype)) for a, b in
                        zip(labels_r, ragged_ref["ragged_labels"])),
      "step_labels_equal_cluster_batch": all(
          np.array_equal(a, b) for a, b in
          zip(step_labels.cpu().numpy(), labels_r)),
      **against_2d(labels_r, step_n, step_w, alone),
      "gt_match": gt_match(labels_r, r_truths),
      "cold_wall_s": cold_s, "warm_wall_s": warm_s,
      "iters_per_utterance": stats["iters"].tolist(),
      "iters_per_utterance_2d": [st["iters"] for st in loop_stats],
      "eig_batched_s": eig_s, "eig_2d_loop_s": loop_s,
      "eig_ritz_err_2d": max(ritz_err(a, b) for a, b in zip(w_solve, loop_w)),
      "pipeline_2d_loop_s": alone_s, "launches": launches,
  }
  results["batch_subspace_ragged"] = run
  log(json.dumps({"phase": "batch_subspace_ragged", **run}))
  if not (run["parity_ids"] and run["step_labels_equal_cluster_batch"]
          and run["gt_match"] == rb):
    raise SystemExit("cluster_batch (SubspaceIteration, ragged): labels "
                     "differ from the JAX package's, the batched step's or "
                     "the speakers")
  if not (run["labels_equal_2d"] and run["n_clusters_equal_2d"]):
    raise SystemExit("cluster_batch (SubspaceIteration, ragged): labels or "
                     "counts differ from the 2-D pipeline's")
  if not (run["ritz_err_2d"] <= SOLVER_EIG_RTOL
          and run["eig_ritz_err_2d"] <= SOLVER_EIG_RTOL):
    raise SystemExit("cluster_batch (SubspaceIteration, ragged): Ritz values "
                     f"differ from the 2-D solve's by more than "
                     f"{SOLVER_EIG_RTOL}")
  if not solver_launches_ok(launches, expected(1)):
    raise SystemExit(f"cluster_batch (SubspaceIteration, ragged): launches "
                     f"{launches}, expected {expected(1)} and "
                     f"{solver_kernels}")
  mark("batch_subspace_ragged")

  # HostGeneral: the whole refinement sequence in batched kernels, kernel
  # 5b once per chunk and never the 2-D kernel 5, then one host eig of the
  # chunk.
  hb = HOST_GENERAL_BATCH
  hcfg = bcfg.replace(eigensolver=EigenSolver.HostGeneral)
  per_general_chunk = {"affinity_batched": 1, "row_max_batched": 1,
                       "crop_diagonal_batched": 1,
                       "threshold_symmetrize_general_batched": 1,
                       "row_wise_normalize_batched": 1, "kmeans": 1}
  _, cold_s = timed_call(
      lambda: batch_lib.cluster_batch(utts[:hb], hcfg, mesh))
  fused.reset_launch_counts()
  labels_h, warm_s = timed_call(
      lambda: batch_lib.cluster_batch(utts[:hb], hcfg, mesh))
  launches = fused.launch_counts()
  stage_timings = observability.StageTimings(dev)
  step_labels, step_n, step_w, _ = pipeline.spectral_cluster_fixed_k_batched(
      x_b[:hb], keys_b[:hb], hcfg, n_valid=nv_b[:hb], timings=stage_timings)
  alone, alone_s = synced(lambda: per_utterance_2d(hcfg, x_b[:hb]))
  run = {
      "leg": "cluster_batch_host_general", "batch": hb, "n": N_BATCH,
      "d": D_MAIN, "eigensolver": "HostGeneral",
      "parity_ids": all(np.array_equal(a, b.astype(a.dtype)) for a, b in
                        zip(labels_h, solver_ref["host_general_labels"])),
      "step_labels_equal_driver": all(
          np.array_equal(a, b) for a, b in
          zip(step_labels.cpu().numpy(), labels_h)),
      **against_2d(labels_h, step_n, step_w, alone),
      "gt_match": gt_match(labels_h, truths[:hb]),
      "cold_wall_s": cold_s, "warm_wall_s": warm_s,
      "utterances_per_s": hb / warm_s,
      "stage_s": stage_timings.as_dict(),
      "pipeline_2d_loop_s": alone_s,
      "launches": launches,
  }
  results["batch_host_general"] = run
  log(json.dumps({"phase": "batch_host_general", **run}))
  if not (run["parity_ids"] and run["step_labels_equal_driver"]):
    raise SystemExit("cluster_batch (HostGeneral): labels differ from the "
                     "JAX package's or the batched step's")
  if not (run["labels_equal_2d"] and run["n_clusters_equal_2d"]):
    raise SystemExit("cluster_batch (HostGeneral): labels or counts differ "
                     "from the 2-D pipeline's")
  if launches != expected(1, per_general_chunk):
    raise SystemExit(f"cluster_batch (HostGeneral): launches {launches}, "
                     f"expected {expected(1, per_general_chunk)}")
  del x_b
  mark("batch_host_general")

  # The streamed driver at the 1024-utterance scale.
  s_utts, s_truths = make_batch(STREAMED_BATCH, N_BATCH, D_MAIN)
  fused.reset_launch_counts()
  torch.cuda.reset_peak_memory_stats()
  streamed, streamed_s = timed_call(lambda: batch_lib.cluster_batch_streamed(
      s_utts, bcfg, mesh, chunk=STREAMED_CHUNK, window=STREAMED_WINDOW))
  launches = fused.launch_counts()
  streamed_peak_gb = torch.cuda.max_memory_allocated() / 1e9
  chunks = -(-STREAMED_BATCH // STREAMED_CHUNK)
  serial = []
  for lo in (0, STREAMED_CHUNK):
    serial.extend(batch_lib.cluster_batch(
        s_utts[lo:lo + STREAMED_CHUNK], bcfg, mesh, seed=lo))
  half, half_s = timed_call(lambda: batch_lib.cluster_batch_streamed(
      s_utts[:STREAMED_BF16], bcfg, mesh, chunk=STREAMED_CHUNK,
      window=STREAMED_WINDOW, transfer_dtype=torch.bfloat16))
  # The device's idle share over one more full chunk, traced: the card's
  # activity only. The trace's stop and its summary are timed apart from
  # the traced run.
  from torch.profiler import ProfilerActivity, profile
  prof = profile(activities=[ProfilerActivity.CUDA])
  torch.cuda.synchronize()
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
  averages = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

  def device_ms(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0)) / 1e3

  busy_ms = sum(device_ms(e) for e in averages)
  top = sorted(averages, key=device_ms, reverse=True)[:8]
  trace_summary_s = time.perf_counter() - t0
  run = {
      "leg": "cluster_batch_streamed", "batch": STREAMED_BATCH,
      "n": N_BATCH, "d": D_MAIN, "chunk": STREAMED_CHUNK,
      "window": STREAMED_WINDOW, "chunks": chunks, "seconds": streamed_s,
      "utterances_per_s": STREAMED_BATCH / streamed_s,
      "gt_match": gt_match(streamed, s_truths),
      "first_two_chunks_equal_serial": all(
          np.array_equal(a, b) for a, b in zip(streamed, serial)),
      "first_batch_equal_reference": all(
          np.array_equal(a, b.astype(a.dtype))
          for a, b in zip(streamed, ref_labels)),
      "launches": launches,
      "launches_per_chunk": {k: v / chunks for k, v in launches.items()},
      "peak_mem_gb": streamed_peak_gb,
      "predicted_peak_mem_gb": predicted_peak_gb(STREAMED_CHUNK),
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
                   "top_device_ms": {e.key[:80]: device_ms(e) for e in top},
                   "trace_stop_s": trace_stop_s,
                   "trace_summary_s": trace_summary_s},
  }
  results["batch_streamed"] = run
  log(json.dumps({"phase": "batch_streamed", **run}))
  if not (run["first_two_chunks_equal_serial"]
          and run["first_batch_equal_reference"]):
    raise SystemExit("cluster_batch_streamed: labels differ from the serial "
                     "chunked loop or the reference")
  if launches != expected(chunks):
    raise SystemExit(f"cluster_batch_streamed: launches {launches}, "
                     f"expected {expected(chunks)}")
  mark("batch_streamed")

  # A constrained, auto-tuned batch: the Turn-to-Diarize template. Each
  # AutoTune level is one (B, C) batched step: the affinity and kernel 4
  # launch once per level (Percentile thresholds: no row_max).
  t2d_b_x, t2d_b_scores, _ = make_t2d_fixture(N_BATCH, D_MAIN)
  t2d_b_cm = constraint.ConstraintMatrix(
      t2d_b_scores, threshold=1).compute_diagonals()
  tcfg = pipeline.PipelineConfig(
      refinement_options=configs.turntodiarize_refinement_options(),
      constraint_options=configs.turntodiarize_constraint_options(),
      laplacian_type=LaplacianType.GraphCut, min_clusters=2, max_clusters=7,
      row_wise_renorm=True, custom_dist="cosine")
  t2d_tune = configs.make_turntodiarize_auto_tune()
  candidates = len(t2d_tune.get_percentile_range())
  levels = t2d_tune.search_level

  def autotuned():
    return batch_lib.cluster_batch_autotuned(
        [t2d_b_x] * T2D_BATCH, tcfg, configs.make_turntodiarize_auto_tune(),
        mesh, constraint_matrices=[t2d_b_cm] * T2D_BATCH)

  _, t2d_cold_s = timed_call(autotuned)
  fused.reset_launch_counts()
  torch.cuda.reset_peak_memory_stats()
  t2d_labels, t2d_warm_s = timed_call(autotuned)
  launches = fused.launch_counts()
  t2d_ref_b = list(batch_ref["t2d_labels"])
  clusterer_labels = configs.make_turntodiarize_clusterer().predict(
      t2d_b_x, t2d_b_cm)
  per_level = {"affinity_batched": 1,
               "threshold_symmetrize_general_batched": 1}
  # One batched K-Means (kernel 8) on the winning candidates, after the
  # levels.
  want_autotuned = dict(expected(levels, per_level), kmeans=1)
  run = {
      "leg": "cluster_batch_autotuned", "batch": T2D_BATCH, "n": N_BATCH,
      "d": D_MAIN, "candidates_per_utterance": candidates,
      "levels": levels,
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
      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
  }
  results["batch_autotuned"] = run
  log(json.dumps({"phase": "batch_autotuned", **run}))
  if not run["parity_ids"]:
    raise SystemExit("cluster_batch_autotuned: labels differ from the JAX "
                     "package's")
  if launches != want_autotuned:
    raise SystemExit(f"cluster_batch_autotuned: launches {launches}, "
                     f"expected {want_autotuned}")
  mark("batch_autotuned")

  # 8. The row-sharded path: no refinement kernel may launch in it; its
  # subspace solve multiplies each stripe by the panel with the solver's
  # kernels, and its K-Means on the gathered embedding is kernel 8.
  fused.reset_launch_counts()
  results["sharded"] = sharded_phase(torch, np, dev, ref[f"labels_{N_BIG}"],
                                     log)
  sharded_launches = fused.launch_counts()
  results["sharded"]["launches"] = sharded_launches
  log(json.dumps({"phase": "sharded", "launches": sharded_launches}))
  sharded_kernels = solver_kernels + ("kmeans",)
  if (any(v for k, v in sharded_launches.items() if k not in sharded_kernels)
      or not all(sharded_launches[k] for k in sharded_kernels)):
    raise SystemExit(f"sharded: kernels launched {sharded_launches}, "
                     f"expected {sharded_kernels} only")
  mark("sharded")
  batch_launches = {
      "cluster_batch": results["batch"]["launches"],
      "cluster_batch_subspace": results["batch_subspace"]["launches"],
      "cluster_batch_subspace_ragged":
          results["batch_subspace_ragged"]["launches"],
      "cluster_batch_host_general": results["batch_host_general"]["launches"],
      "cluster_batch_streamed": results["batch_streamed"]["launches"],
      "cluster_batch_autotuned": results["batch_autotuned"]["launches"]}

  sources = {
      "affinity": "fused.py:46-77 affinity_pallas",
      "row_max": "fused.py:85-140 row_max_pallas",
      "crop_diagonal": "fused.py:226-254 crop_diagonal_pallas",
      "threshold_symmetrize_general":
          "fused.py:148-218 threshold_symmetrize_general_pallas",
      "row_wise_normalize": "fused.py:262-283 row_wise_normalize_pallas",
  }
  # The solver's kernels and kernel 8 replace XLA operations of the JAX
  # package, not Pallas kernels.
  solver_sources = {
      "cholqr_pass_pair": "spectralcluster_tpu/ops/eigen.py:280-304 (XLA "
                          "Cholesky and triangular solve of cholqr2_shifted "
                          "at both shifts; no Pallas kernel)",
      "panel_matmul": "spectralcluster_tpu/ops/eigen.py:415-427 (XLA dot: "
                      "the subspace iteration's (N, N) x (N, b) product; "
                      "no Pallas kernel)",
      "kmeans": "spectralcluster_tpu/ops/kmeans.py kmeans_fit (XLA ops: "
                "k-means++ and the cosine Lloyd while_loop; no Pallas "
                "kernel)",
  }
  kernels = []
  for name in timed:
    err = max(c["max_abs_err"] for c in checks if c["kernel"] == name)
    base = name[:-len("_batched")] if name.endswith("_batched") else name
    kernel = {
        "name": name, "route": "cuda",
        "source": "spectralcluster_tpu_torch/csrc/fused.cu",
        "replaces": solver_sources[name] if name in solver_sources else (
            "spectralcluster_tpu/kernels/" + sources[base] + (
                " under vmap (parallel/batch.py:38-122)" if base != name
                else "")),
        "launches": (sum(r["launches"][name] for r in runs.values())
                     + sum(r["launches"][name]
                           for r in results["streaming"].values())
                     + sum(r[name] for r in batch_launches.values())),
        "launches_per_batch_chunk":
            results["batch"]["launches_per_chunk"][name],
        "launches_per_host_general_batch_chunk":
            results["batch_host_general"]["launches"][name],
        "launches_autotuned_batch":
            batch_launches["cluster_batch_autotuned"][name],
        "launches_sharded": sharded_launches[name],
        "max_abs_err": err, "kernel_ms": times[name]["ms"],
        **times[name],
    }
    if base == name:
      per_predict = runs["HostGeneral" if name == "row_wise_normalize"
                         else "Auto"]
      kernel.update({
          "launches_per_predict":
              per_predict["launches"][name] / per_predict["warm_runs"],
          "launches_auto_20480_predict":
              runs["Auto_20480"]["launches"][name],
          "launches_per_stream_step_past_L": results["streaming"][
              "nodeflicker"]["launches_per_step_past_L"][name]})
    else:
      kernel["shape"] = f"B={BATCH},N={N_BATCH},d={D_MAIN}"
    if name == "affinity_batched":
      kernel[f"at_B={STREAMED_CHUNK}"] = times[
          f"affinity_batched_b{STREAMED_CHUNK}"]
    if name in no_library:
      kernel["library_note"] = no_library[name]
    if name == "threshold_symmetrize_general":
      kernel["launches_per_t2d_predict"] = (
          runs["t2d"]["launches_per_predict"][name])
    if name in solver_kernels:
      # Per call of each cell that runs the subspace solver.
      kernel["launches_by_cell"] = {
          "Auto_10240_predict": kernel["launches_per_predict"],
          "Auto_20480_predict": kernel["launches_auto_20480_predict"],
          "SubspaceIteration_10240_predict": (
              runs["SubspaceIteration"]["launches"][name]
              / runs["SubspaceIteration"]["warm_runs"]),
          "t2d_predict": runs["t2d"]["launches_per_predict"][name],
          "stream_step_past_L": kernel["launches_per_stream_step_past_L"],
          "batch_chunk": kernel["launches_per_batch_chunk"],
          "subspace_batch_chunk": (
              batch_launches["cluster_batch_subspace"][name]
              / BATCH_WARM_RUNS),
          "ragged_subspace_batch_chunk":
              batch_launches["cluster_batch_subspace_ragged"][name],
          "sharded_phase": sharded_launches[name],
          "per_solver_iteration":
              results["launches_per_solver_iteration"][name]}
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
