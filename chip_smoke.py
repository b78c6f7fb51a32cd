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
  4. paths — make_icassp2018_clusterer(...).predict on make_embeddings(N),
     labels held against benchmarks/reference_labels.npz at N=512, 2048 and
     the leg's N, with launch counts zeroed after the cold run and read
     after the warm runs (the comparison launches of phase 3 do not count);
     each leg fails if a kernel of its path did not launch:
       * Auto and SubspaceIteration at N=10240 (one cold run, WARM_RUNS
         warm): kernels 1-4 (RowWiseNormalize is absorbed into the eigh
         similarity transform there);
       * HostGeneral at N=4096 (one cold run, two warm): all five kernels;
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
  Together about 3-4 minutes on one H100, most of it the host eig.

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
BATCH = 10
WARM_RUNS = 5
N_GENERAL = 4096
GENERAL_WARM_RUNS = 2
API_WARM_RUNS = 2
T2D_WARM_RUNS = 2
T2D_P = 0.785  # the p the JAX bench's AutoTune picked at every size

# (HBM bytes/s, float32 FLOP/s on the CUDA cores), NVIDIA data sheets.
_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),   # SXM: "NVIDIA H100 80GB HBM3"
)

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
  print(*a, flush=True)


def card_peaks(name: str):
  for key, bw, flops in _PEAKS:
    if key in name:
      return bw, flops
  raise RuntimeError(f"no data-sheet peaks for card {name!r}")


def time_ms(torch, fn, reps=REPS, batch=BATCH, warmup=3) -> float:
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

  from spectralcluster_tpu_torch import clusterer as clusterer_lib
  from spectralcluster_tpu_torch import configs, constraint, pipeline, utils
  from spectralcluster_tpu_torch.fixtures import (make_embeddings,
                                                  make_t2d_fixture)
  from spectralcluster_tpu_torch.kernels import build
  from spectralcluster_tpu_torch.kernels import fused
  from spectralcluster_tpu_torch.ops import eigen as eigen_ops
  from spectralcluster_tpu_torch.ops.kmeans import run_kmeans
  from spectralcluster_tpu_torch.ops import quantile as quantile_ops
  from spectralcluster_tpu_torch.ops import refinement as ref_ops
  from spectralcluster_tpu_torch.types import EigenSolver

  results = {}
  dev = torch.device("cuda")

  # 1. Device.
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()
  kind = torch.cuda.get_device_name(0)
  count = torch.cuda.device_count()
  bw, fp32 = card_peaks(kind)
  results["device"] = {"nvidia_smi": smi, "kind": kind, "count": count,
                       "torch": torch.__version__, "cuda": torch.version.cuda,
                       "peak_bytes_per_s": bw, "peak_fp32_flops": fp32}
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
  del crop_scratch, blurred, ragged, aff, sym, m

  # 4. Paths: each leg's launch counts are zeroed after its cold run and
  # read after its warm runs.
  ref = np.load(os.path.join(HERE, "benchmarks", "reference_labels.npz"))
  main_kernels = ("affinity", "row_max", "crop_diagonal",
                  "threshold_symmetrize_general")

  def drive(leg, clusterer, n, warm_runs, expected, **extra):
    for n_small in (512, 2048):
      small = clusterer.predict(make_embeddings(n_small))
      if not np.array_equal(utils.enforce_ordered_labels(small),
                            ref[f"labels_{n_small}"]):
        raise SystemExit(f"{leg}: labels differ from the reference at "
                         f"N={n_small}")
    emb = make_embeddings(n, D_MAIN)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cold = clusterer.predict_with_details(emb)
    cold_s = time.perf_counter() - t0
    fused.reset_launch_counts()
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
        "parity": bool(np.array_equal(labels, ref[f"labels_{n}"])),
        "eigenvalues": [float(v) for v in result.eigenvalues[:8]],
        "eigenvalues_shape": list(result.eigenvalues.shape),
        "cold_wall_s": cold_s, "warm_wall_s": statistics.median(warm_s),
        "warm_wall_s_runs": warm_s, "warm_runs": warm_runs,
        "stage_timings_s_cold_run": cold.timings,
        "stage_timings_s_last_run": result.timings, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
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
        "launches": sum(r["launches"][name] for r in runs.values()),
        "launches_per_predict":
            per_predict["launches"][name] / per_predict["warm_runs"],
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
