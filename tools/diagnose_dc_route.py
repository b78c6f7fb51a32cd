#!/usr/bin/env python3
"""Bisect the certified top-k route of ops/dc.py between the card and the CPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/diagnose_dc_route.py [--cases 20480,k4,k7]
                                       [--cpu-loops 20480,k4,k7]
                                       [--out FILE]

For each case (``20480``: ``make_embeddings(20480)``; ``k4``, ``k7``:
``make_embeddings_k(10240, k)``) the icassp2018 Auto operand is built as
``chip_smoke.py`` builds it (``fused.affinity``, then the ROWNORM_TAIL
operand of ``pipeline._symmetric_eig_operand``), once on the card and once
on the CPU from the same embeddings. One JSON line each:

  * ``operand``: max|s − sᵀ| of the Diffuse output and max|m − mᵀ| of the
    operand, on each device; max|m_card − m_cpu| / max|m|;
  * ``product``: the error of one ``op @ q`` (op the route's shifted
    operand m + b·I, the product its loop makes) and of the Rayleigh–Ritz
    matrix ``qᵀ (op q)`` (a panel Gram) against float64 sums of the same
    float32 inputs, the largest column norm of the difference and the
    largest entry of it, for q the orthonormalized start panel (16
    columns) and the route's final eigenvectors (8): by cuBLAS
    (``torch.matmul``) and by the port's (``fused.panel_matmul``,
    ``eigen_ops.panel_gram``) on the card, by ``torch.matmul`` on the CPU,
    all on the card's operand;
  * ``route``: ``dc._certified_iterative_topt`` (t=8, descending, the
    generator seeded ``pipeline._DC_SEED``) with its residual after each
    32-iteration chunk, accepted or not, iterations, res_abs, res and the
    host seconds (card synced), on the card, with the loop's products and
    Grams by: cuBLAS (``cublas``); the panel kernel and cuBLAS
    (``kernel_product``); the port's (``kernels``: the product kernel,
    the float64 Gram and the CholeskyQR pass kernel); float64 sums of the
    float32 inputs (``float64``); the CholeskyQR passes by cuSOLVER and
    cuBLAS but in ``kernels``; each on the card's operand, and ``cublas`` and
    ``kernels`` also on the CPU's; then, for the cases in ``--cpu-loops``,
    on the CPU (``torch.matmul``) on the card's operand and on its own.

With ``--witness seed/index,...`` (recordings of ``portbench/traffic/long.json``
drawn by ``portbench/generator.py``), for each recording: the operand the
staged executor hands ``_dc_topk`` (``prepare_affinity``, then
``_symmetric_eig_operand``, unpadded, on the card); ``dc.eigh_topk_dc`` on
it, as ``pipeline._dc_topk`` calls it, at each of ``--precisions`` and with
and without the certified attempt first, each with its route, the certified
attempt's diagnostics, every split level's branch, reason and residual, the
returned eigenvalues, the count the eigengap rule gives on them and whether
``_warn_near_stop`` warns; the card's full float32 ``eigh`` and a float64
``eigvalsh`` of the same operand with their counts; the predict of the
icassp2018 preset; and for the recordings in ``--cpu-witness``, the split on
the CPU from the card's operand. With ``--pool seed,...``, every recording
of those seeds' pools through the preset's ``predict``: the route, each
split level's branch and reason, the route's counters (``dc_certified``,
``dc_subspace_iters``, ``dc_resolved``: whether the full eigh re-solved
it), the count and the stage and span seconds. With ``--topk`` too, each
such recording's operand goes instead through ``pipeline._dc_topk`` as
the staged executor calls it (descending, unpadded, with its stage
timings on the card): the solve that answered ("lanczos", "certified" or
"full_eigh"), Lanczos's steps, the route's counters and spans, the seconds
(card synced), and the count the eigengap rule gives on its pairs against
the float64 reference's (``portbench/reference/icassp2018.py``, on the
card) and its admissible counts, with the eigenvalues' largest gap over the
largest.

With ``--bisect-small-ops``, only the card's operand, for each of
``--seeds``: ``cublas``, ``kernels``, the kernels' product and Gram with
cuSOLVER's passes, and the kernel's or a float64 product with CholeskyQR2
and the Ritz Gram on the CPU (the panel copied there and back); and the
CPU's loop for the ``--cpu-loops`` cases.

The arithmetic of a run is chosen by swapping ``fused.panel_matmul``,
``eigen_ops.panel_gram`` and ``fused.cholqr_pass``, through which
``ops/eigen.py`` and ``ops/dc.py`` make every product, Gram and CholeskyQR
pass of the route.
Ends with the card's name and power limit, as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from spectralcluster_tpu_torch import configs, pipeline  # noqa: E402
from spectralcluster_tpu_torch.fixtures import (make_embeddings,  # noqa: E402
                                                make_embeddings_k)
from spectralcluster_tpu_torch.kernels import fused  # noqa: E402
from spectralcluster_tpu_torch.ops import dc as dc_ops  # noqa: E402
from spectralcluster_tpu_torch.ops import eigen as eigen_ops  # noqa: E402
from spectralcluster_tpu_torch.ops import refinement as ref_ops  # noqa: E402

T = 8
LINES = []


def log(obj):
  LINES.append(obj)
  print(json.dumps(obj), flush=True)


def embeddings(case):
  if case == "20480":
    return make_embeddings(20480)
  return make_embeddings_k(10240, int(case[1:]))[0]


def operand(x, dev):
  """(the Diffuse output's asymmetry, the operand m): pipeline.py's
  ROWNORM_TAIL branch step by step, held to _symmetric_eig_operand."""
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7)
  aff = fused.affinity(torch.as_tensor(x).to(dev))
  ropts = cfg.refinement_options
  s = ref_ops.apply_refinement_sequence(
      aff.clone(), ropts, sequence=ropts.refinement_sequence[:-1],
      p_percentile=None, n_valid=None, use_kernels=cfg.use_kernels)
  s_asym = float(torch.max(torch.abs(s - s.T)))
  d = ref_ops.row_max_scale(s, None, use_kernels=cfg.use_kernels)
  inv_sqrt = 1.0 / torch.sqrt(d)
  m_steps = inv_sqrt[:, None] * s * inv_sqrt[None, :]
  del s
  m, _ = pipeline._symmetric_eig_operand(aff, cfg, None, None,
                                         ref_ops.ROWNORM_TAIL,
                                         consume_input=True)
  if not torch.equal(m, m_steps):
    raise SystemExit("the step-by-step operand differs from pipeline's")
  return s_asym, m


def shifted(m):
  b = float(torch.amax(torch.sum(torch.abs(m), dim=1))) + 1.0
  op = m.clone()
  op.diagonal().add_(b)
  return op


class Float64Product:
  """mat @ x summed in float64 from the float32 inputs, rounded once; the
  float64 copy of each operand is made once per run."""

  def __init__(self):
    self.cache = {}

  def __call__(self, mat, x):
    # The entry holds mat itself, so its storage is not reused by another
    # tensor of the same shape while the cache lives.
    key = (mat.data_ptr(), tuple(mat.shape))
    if key not in self.cache:
      self.cache[key] = (mat, mat.double())
    return torch.matmul(self.cache[key][1], x.double()).float()


def float64_gram(a, b):
  return torch.matmul(a.double().transpose(-1, -2), b.double()).float()


def float32_gram(a, b):
  return torch.matmul(a.transpose(-1, -2), b)


@contextlib.contextmanager
def products(matmul, gram, cholqr=None):
  """The route's products, Grams and CholeskyQR passes by the given
  functions (the passes by cuSOLVER and cuBLAS, the twin, by default)."""
  saved = fused.panel_matmul, eigen_ops.panel_gram, fused.cholqr_pass
  fused.panel_matmul, eigen_ops.panel_gram = matmul, gram
  fused.cholqr_pass = cholqr or fused.cholqr_pass_plain
  try:
    yield
  finally:
    fused.panel_matmul, eigen_ops.panel_gram, fused.cholqr_pass = saved


def synced_seconds(fn, dev):
  if dev.type == "cuda":
    torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  if dev.type == "cuda":
    torch.cuda.synchronize()
  return time.perf_counter() - t0, out


@contextlib.contextmanager
def host_cholqr2():
  """CholeskyQR2 of every panel on the CPU (its Gram, Cholesky and
  triangular solve), the panel copied there and back."""
  saved = eigen_ops.cholqr2_shifted
  eigen_ops.cholqr2_shifted = lambda y: saved(y.cpu()).to(y.device)
  try:
    yield
  finally:
    eigen_ops.cholqr2_shifted = saved


def host_gram(a, b):
  return float32_gram(a.cpu(), b.cpu()).to(a.device)


def route(case, m, loop, operand_from, seed=None):
  info = {}
  seed = pipeline._DC_SEED if seed is None else seed
  seconds, out = synced_seconds(lambda: dc_ops._certified_iterative_topt(
      m, T, torch.Generator().manual_seed(seed), True, None,
      info), m.device)
  row = {"phase": "route", "case": case, "loop": loop, "seed": seed,
         "operand": operand_from, "accepted": out is not None,
         "seconds": seconds,
         "ms_per_iteration": seconds / info["iters"] * 1e3, **info}
  log(row)
  return out


def errors(op, q, matmul, gram):
  """(column-norm error of op @ q, entry error of qᵀ (op q)), each against
  float64 sums; the Gram's inputs are the float32 q and op @ q."""
  want = torch.matmul(op.double(), q.double())
  got = matmul(op, q)
  product = float(torch.amax(torch.linalg.norm(got.double() - want, dim=0)))
  ritz = gram(q, got).double()
  ritz_want = torch.matmul(q.double().T, got.double())
  return product, float(torch.amax(torch.abs(ritz - ritz_want)))


def witness_operand(rec, cfg, dev):
  """The operand the staged executor hands ``_dc_topk`` for one recording:
  ``prepare_affinity``, then ``_symmetric_eig_operand``, unpadded."""
  x = torch.as_tensor(rec.embeddings, dtype=torch.float32).to(dev)
  with pipeline.fp32_precision():
    aff = pipeline.prepare_affinity(x, cfg, None)
    m, _ = pipeline._symmetric_eig_operand(aff, cfg, None, None,
                                           pipeline._eig_structure(cfg),
                                           consume_input=True)
  return m


def count_of(w, res, wscale, cfg):
  """(the eigengap rule's count on w (descending), whether
  ``_warn_near_stop`` warns)."""
  wt = torch.as_tensor(np.asarray(w, np.float32))
  _, n_gap, _ = pipeline._gap(wt, cfg, True, None,
                              torch.tensor(wscale, dtype=torch.float32))
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    warned = pipeline._warn_near_stop(np.asarray(w, np.float64), res, wscale,
                                      cfg, "witness")
  return max(int(n_gap), cfg.min_clusters), bool(warned or caught)


def dc_row(name, m, cfg, precision, iterative_first):
  info = {}
  t = cfg.max_clusters + 1
  seconds, out = synced_seconds(lambda: dc_ops.eigh_topk_dc(
      m, t, torch.Generator().manual_seed(pipeline._DC_SEED), descend=True,
      max_block=cfg.dc_max_block, sign_precision=precision,
      try_iterative_first=iterative_first, info=info,
      _n_bucket=pipeline.pad_bucket(m.shape[0])), m.device)
  w, _, res, wscale = out
  w = w.cpu().numpy().astype(np.float64)
  n, warned = count_of(w, res, wscale, cfg)
  if "res_trace" in info:
    trace = info.pop("res_trace")
    info["res_trace_first_last"] = [trace[:3], trace[-3:]]
  return {"phase": "witness_dc", "case": name, "device": m.device.type,
          "precision": precision, "iterative_first": iterative_first,
          "seconds": seconds, "w": w.tolist(), "res": res, "wscale": wscale,
          "count": n, "warned": warned, "info": info}


def witness(cases, precisions, cpu_cases, dev):
  """The witness recordings' routes (module docstring, ``--witness``)."""
  sys.path.insert(0, ROOT)
  from portbench import generator, run
  traffic = run.load_json("portbench", "traffic", "long.json")
  clusterer = configs.make_icassp2018_clusterer(device=dev.type)
  cfg = clusterer._config()
  pools = {}
  for name in cases:
    seed, index = (int(v) for v in name.split("/"))
    if seed not in pools:
      pools[seed] = generator.make_pool(traffic, seed)
    rec = pools[seed][index]
    seconds, res = synced_seconds(
        lambda: clusterer.predict_with_details(rec.embeddings), dev)
    log({"phase": "witness_predict", "case": name,
         "n": int(rec.embeddings.shape[0]), "speakers": rec.n_speakers,
         "seconds": seconds, "n_clusters": int(res.n_clusters),
         "eigenvalues": np.asarray(res.eigenvalues)[:8].tolist()})
    m = witness_operand(rec, cfg, dev)
    for precision in precisions:
      for first in (True, False):
        log(dc_row(name, m, cfg, precision, first))
    t = cfg.max_clusters + 1
    seconds, w32 = synced_seconds(
        lambda: eigen_ops.sorted_eigh(m)[0][:t + 8].cpu().numpy(), dev)
    w64 = torch.flip(torch.linalg.eigvalsh(m.double()), (0,))[:t + 8]
    w64 = w64.cpu().numpy()
    log({"phase": "witness_eigh", "case": name, "eigh_seconds": seconds,
         "float32": w32.tolist(), "float64": w64.tolist(),
         "count_float32": count_of(w32[:t], 0.0, float(np.abs(w32).max()),
                                   cfg)[0],
         "count_float64": count_of(w64[:t], 0.0, float(np.abs(w64).max()),
                                   cfg)[0]})
    if name in cpu_cases:
      m_cpu = m.cpu()
      del m
      torch.cuda.empty_cache()
      log(dc_row(name, m_cpu, cfg, "high", False))
      del m_cpu
    else:
      del m
    torch.cuda.empty_cache()


def pool_routes(seeds, dev):
  """The route of every recording of the long traffic's pools (module
  docstring, ``--pool``)."""
  sys.path.insert(0, ROOT)
  from portbench import generator, run
  traffic = run.load_json("portbench", "traffic", "long.json")
  clusterer = configs.make_icassp2018_clusterer(device=dev.type,
                                                staged_stage_timings=True)
  infos, solve = [], dc_ops.eigh_topk_dc

  def recording(*a, **kw):
    infos.append({})
    return solve(*a, info=infos[-1], **kw)

  dc_ops.eigh_topk_dc = recording
  try:
    for seed in seeds:
      for rec in generator.make_pool(traffic, seed):
        infos.clear()
        seconds, res = synced_seconds(
            lambda: clusterer.predict_with_details(rec.embeddings), dev)
        info = infos[0] if infos else {}
        log({"phase": "pool_route", "seed": seed, "index": rec.index,
             "n": int(rec.embeddings.shape[0]), "speakers": rec.n_speakers,
             "route": info.get("route"),
             "certified_iters": info.get("iters"),
             "branches": [(lv.get("depth"), lv.get("branch"),
                           lv.get("reason")) for lv in info.get("levels", [])],
             "counters": res.counters, "n_clusters": int(res.n_clusters),
             "eigenvalues": np.asarray(res.eigenvalues)[:8].tolist(),
             "timings": res.timings, "seconds": seconds})
  finally:
    dc_ops.eigh_topk_dc = solve


def topk_pool_routes(seeds, dev):
  """The staged executor's top-k route on every recording of the long
  traffic's pools, against the float64 reference (module docstring,
  ``--pool`` with ``--topk``)."""
  from portbench import generator, run
  from portbench.reference import icassp2018 as reference
  from spectralcluster_tpu_torch.observability import StageTimings
  traffic = run.load_json("portbench", "traffic", "long.json")
  config = run.load_json("portbench", "configs", "icassp2018_auto.json")
  cfg = configs.make_icassp2018_clusterer(device=dev.type)._config()
  for seed in seeds:
    for rec in generator.make_pool(traffic, seed):
      m = witness_operand(rec, cfg, dev)
      timings = StageTimings(dev)
      seconds, (w, _, wscale) = synced_seconds(
          lambda: pipeline._dc_topk(m, cfg, None, True, timings), dev)
      del m
      torch.cuda.empty_cache()
      counters = timings.counters()
      answered = ("full_eigh" if counters["dc_full_eigh"] else
                  "lanczos" if counters["dc_lanczos"] else "certified")
      w = w.cpu().numpy().astype(np.float64)
      count, _ = count_of(w, 0.0, float(wscale), cfg)
      ref = reference.solve(rec, config, "float64", dev.type)
      torch.cuda.empty_cache()
      w_ref = np.asarray(ref["eigenvalues"], np.float64)
      log({"phase": "topk_route", "seed": seed, "index": rec.index,
           "n": int(rec.embeddings.shape[0]), "speakers": rec.n_speakers,
           "answered": answered,
           "lanczos_steps": counters["dc_lanczos_steps"],
           "counters": counters, "spans": timings.as_dict(),
           "seconds": seconds, "count": count,
           "reference_count": ref["n_clusters"],
           "admissible": sorted(int(c) for c in ref["counts"]),
           "count_admissible": count in ref["counts"],
           "eig_err": float(np.max(np.abs(w[:w_ref.shape[0]] - w_ref))
                            / np.max(np.abs(w_ref)))})


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--cases", default="20480,k4,k7")
  parser.add_argument("--cpu-loops", default="20480,k4,k7")
  parser.add_argument("--bisect-small-ops", action="store_true",
                      help="only the card operand: the route with both "
                      "kernels, and with CholeskyQR2 and the Ritz Gram on "
                      "the CPU after the kernel's or a float64 product, "
                      "for each of --seeds, and the CPU's loop on the card "
                      "operand for the --cpu-loops cases")
  parser.add_argument("--seeds", default="17")
  parser.add_argument("--witness", default="",
                      help="seed/index of portbench's long traffic, "
                      "comma-separated: the routes of those recordings")
  parser.add_argument("--precisions", default="high,highest")
  parser.add_argument("--pool", default="",
                      help="seeds of portbench's long traffic: the route "
                      "of every recording of their pools")
  parser.add_argument("--topk", action="store_true",
                      help="with --pool: each recording's operand through "
                      "pipeline._dc_topk as the staged executor calls it, "
                      "against the float64 reference")
  parser.add_argument("--cpu-witness", default="",
                      help="witness recordings whose split also runs on "
                      "the CPU from the card's operand")
  parser.add_argument("--out")
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("diagnose_dc_route: no CUDA device", file=sys.stderr)
    return 2
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.set_float32_matmul_precision("highest")
  torch.set_num_threads(os.cpu_count())
  dev, cpu = torch.device("cuda"), torch.device("cpu")
  cpu_loops = set(filter(None, args.cpu_loops.split(",")))
  seeds = [int(v) for v in args.seeds.split(",")]
  if args.witness:
    witness(args.witness.split(","), args.precisions.split(","),
            set(filter(None, args.cpu_witness.split(","))), dev)
    args.cases = ""
  if args.pool:
    pool_seeds = [int(v) for v in args.pool.split(",")]
    if args.topk:
      topk_pool_routes(pool_seeds, dev)
    else:
      pool_routes(pool_seeds, dev)
    args.cases = ""
  for case in filter(None, args.cases.split(",")):
    x = embeddings(case)
    if args.bisect_small_ops:
      _, m_card = operand(x, dev)
      f64 = Float64Product()
      kernels = (fused.panel_matmul, eigen_ops.panel_gram)
      runs = {
          "cublas": (torch.matmul, float32_gram, None, False),
          "kernels": (*kernels, fused.cholqr_pass, False),
          "kernels+cusolver_cholqr": (*kernels, None, False),
          "kernel_product+host_cholqr2": (fused.panel_matmul, host_gram,
                                          None, True),
          "float64+host_cholqr2": (f64, host_gram, None, True)}
      for seed in seeds:
        for loop, (matmul, gram, cholqr, host) in runs.items():
          with products(matmul, gram, cholqr), (
              host_cholqr2() if host else contextlib.nullcontext()):
            route(case, m_card, loop, "card", seed)
          f64.cache.clear()
        if case in cpu_loops:
          with products(torch.matmul, float32_gram):
            route(case, m_card.cpu(), "cpu", "card", seed)
      del m_card
      torch.cuda.empty_cache()
      continue
    t0 = time.perf_counter()
    s_asym_card, m_card = operand(x, dev)
    s_asym_cpu, m_cpu = operand(x, cpu)
    m_card_on_cpu = m_card.cpu()
    drift = float(torch.max(torch.abs(m_card_on_cpu - m_cpu))
                  / torch.max(torch.abs(m_cpu)))
    log({"phase": "operand", "case": case, "n": m_card.shape[0],
         "diffuse_asym_card": s_asym_card, "diffuse_asym_cpu": s_asym_cpu,
         "m_asym_card": float(torch.max(torch.abs(m_card - m_card.T))),
         "m_asym_cpu": float(torch.max(torch.abs(m_cpu - m_cpu.T))),
         "max_abs_m": float(torch.max(torch.abs(m_cpu))),
         "card_vs_cpu_rel": drift,
         "build_seconds": time.perf_counter() - t0})
    m_cpu_on_card = m_cpu.to(dev)
    f64 = Float64Product()
    kernel, kernel_gram = fused.panel_matmul, eigen_ops.panel_gram
    plain_gram = float32_gram
    runs = {"cublas": (torch.matmul, plain_gram),
            "kernel_product": (kernel, plain_gram),
            "kernels": (kernel, kernel_gram, fused.cholqr_pass),
            "float64": (f64, float64_gram)}
    final = None
    for loop, fns in runs.items():
      with products(*fns):
        out = route(case, m_card, loop, "card")
      if loop == "kernels" and out is not None:
        final = out[1]
      f64.cache.clear()
    for loop in ("cublas", "kernels"):
      with products(*runs[loop]):
        route(case, m_cpu_on_card, loop, "cpu")
    del m_cpu_on_card
    op = shifted(m_card)
    op_cpu = op.cpu()
    n = op.shape[0]
    q0 = torch.linalg.qr(torch.randn(
        (n, 16), generator=torch.Generator().manual_seed(pipeline._DC_SEED)))[0]
    panels = {"start": q0}
    if final is not None:
      panels["final"] = final.cpu()
    for name, q in panels.items():
      row = {"phase": "product", "case": case, "panel": name,
             "columns": q.shape[1]}
      for who, (mat, qq, fns) in {
          "cublas": (op, q.to(dev), (torch.matmul, plain_gram)),
          "kernels": (op, q.to(dev), (kernel, kernel_gram)),
          "cpu": (op_cpu, q, (torch.matmul, plain_gram))}.items():
        row[who], row[who + "_ritz_gram"] = errors(mat, qq, *fns)
      log(row)
    del op, op_cpu
    if case in cpu_loops:
      with products(torch.matmul, plain_gram):
        route(case, m_card_on_cpu, "cpu", "card")
        route(case, m_cpu, "cpu", "cpu")
    del m_card, m_cpu, m_card_on_cpu
    torch.cuda.empty_cache()
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  log({"phase": "device", "nvidia_smi": smi,
       "torch": torch.__version__, "cuda": torch.version.cuda})
  if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
      json.dump(LINES, f, indent=1)
  return 0


if __name__ == "__main__":
  sys.exit(main())
