#!/usr/bin/env python3
"""Hold the port's CUDA kernels against an earlier version of fused.cu.

Run from the root of a checkout on a machine with a CUDA card, giving the
earlier source file (for example from `git show <commit>:<path>`):

    python3 tools/compare_fused_parent.py --parent OLD_fused.cu [--out FILE]

The earlier version's `sct_affinity` may be the one before the symmetric
kernel, `sct_affinity(xn, out, n, d, stream)` on the normalized embeddings
row-major, or the current `sct_affinity(xt, out, n, ld, d_pad, stream)`
on the padded transpose; the tool reads which from the source. Its
`sct_row_max` and `sct_crop_diagonal` take what the current ones take.
Both libraries build with the same nvcc flags
(`kernels/build.py`). On the bench fixture (`make_embeddings(N)`, d=256) and
on the blurred, cropped affinity, as `chip_smoke.py` feeds the row max, it
prints one JSON line per kernel:

  * the max abs difference between the two versions' outputs, and whether
    they are equal bit for bit (the affinity too: both sum each element's d
    products in k order);
  * each version's time in turns, parent, current, current, parent (CUDA
    events around BATCH back-to-back C calls of the kernel alone, the median
    of REPS such means per turn), on the same inputs;
  * ptxas's registers and spill bytes of each version's kernel.

Then the card's name and power limit, as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 10240
D = 256
REPS = 20
BATCH = 10

_P, _I = ctypes.c_void_p, ctypes.c_int
# The earlier version's C interface, with the affinity's before the
# symmetric kernel.
_PARENT_SIGNATURES = {
    "sct_affinity": (_P, _P, _I, _I, _P),
    "sct_row_max": (_P, _P, _I, _I, _I, _I, _P),
    "sct_crop_diagonal": (_P, _P, _I, _I, _I, _P),
}
_SYMMETRIC_AFFINITY = "int sct_affinity(const float* xt"


def _time_ms(torch, fn, reps=REPS, batch=BATCH, warmup=3) -> float:
  # As chip_smoke.time_ms: the mean of `batch` calls back to back between
  # two CUDA events, median over `reps`.
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
  parser.add_argument("--parent", required=True,
                      help="the earlier version of csrc/fused.cu")
  parser.add_argument("--out", help="also write the results to this JSON")
  args = parser.parse_args()

  import torch
  if not torch.cuda.is_available():
    print("compare_fused_parent: no CUDA device", file=sys.stderr)
    return 2
  torch.backends.cuda.matmul.allow_tf32 = False
  sys.path.insert(0, ROOT)
  from spectralcluster_tpu_torch.fixtures import make_embeddings
  from spectralcluster_tpu_torch.kernels import build, fused
  from spectralcluster_tpu_torch.ops import refinement as ref_ops

  parent_src = os.path.abspath(args.parent)
  with open(parent_src) as f:
    parent_symmetric = _SYMMETRIC_AFFINITY in f.read()
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    cur_path, par_path = pool.map(build.build,
                                  (build.SOURCES, (parent_src,)))
  cur = build.load()
  par = ctypes.CDLL(par_path)
  for name, argtypes in _PARENT_SIGNATURES.items():
    if name == "sct_affinity" and parent_symmetric:
      argtypes = build._SIGNATURES[name]
    getattr(par, name).argtypes = list(argtypes)
    getattr(par, name).restype = ctypes.c_int
  ptxas = {"parent": build.ptxas_report(par_path),
           "current": build.ptxas_report(cur_path)}

  def call(lib, fn, *fn_args):
    rc = getattr(lib, fn)(*fn_args)
    if rc != 0:
      raise RuntimeError(f"{fn}: CUDA error {rc}")

  dev = torch.device("cuda")
  stream = torch.cuda.current_stream(dev).cuda_stream
  x = torch.as_tensor(make_embeddings(N, D)).to(dev)
  xn = fused.normalize_rows(x).contiguous()
  xt = fused.affinity_operand(xn)
  aff = {v: torch.empty((N, N), device=dev) for v in ("parent", "current")}
  blurred = ref_ops.gaussian_blur(fused.crop_diagonal_plain(fused.affinity(x)),
                                  1.0).contiguous()
  rmax = {v: torch.empty((N, 1), device=dev) for v in ("parent", "current")}
  crop = {}

  def symmetric_affinity(lib, v):
    call(lib, "sct_affinity", xt.data_ptr(), aff[v].data_ptr(), N,
         xt.shape[1], xt.shape[0], stream)

  runs = {
      "affinity": {
          "parent": (
              (lambda: symmetric_affinity(par, "parent")) if parent_symmetric
              else lambda: call(par, "sct_affinity", xn.data_ptr(),
                                aff["parent"].data_ptr(), N, D, stream)),
          "current": lambda: symmetric_affinity(cur, "current"),
      },
      "row_max": {
          v: (lambda lib, v=v: call(lib, "sct_row_max", blurred.data_ptr(),
                                    rmax[v].data_ptr(), N, N, 0, 1, stream))
          for v in ("parent", "current")},
      "crop_diagonal": {
          v: (lambda lib, v=v: call(lib, "sct_crop_diagonal",
                                    crop[v].data_ptr(), crop[v].data_ptr(), N,
                                    N, 1, stream))
          for v in ("parent", "current")},
  }
  libs = {"parent": par, "current": cur}
  outputs = {"affinity": aff, "row_max": rmax, "crop_diagonal": crop}
  results = []
  with torch.no_grad():
    for kernel, fns in runs.items():
      if kernel == "crop_diagonal":
        for v in ("parent", "current"):
          crop[v] = aff["current"].clone()
      times = {"parent": [], "current": []}
      for v in ("parent", "current", "current", "parent"):
        fn = fns[v]
        if kernel != "affinity":
          fn = (lambda f=fn, lib=libs[v]: f(lib))
        times[v].append(_time_ms(torch, fn))
      torch.cuda.synchronize()
      got, want = outputs[kernel]["current"], outputs[kernel]["parent"]
      results.append({
          "kernel": kernel, "n": N,
          "max_abs_diff": float(torch.max(torch.abs(got - want))),
          "bit_equal": bool(torch.equal(got, want)),
          "parent_ms": times["parent"], "current_ms": times["current"],
          **{f"ptxas_{v}": {k: r for k, r in ptxas[v].items()
                            if k.startswith(f"{kernel}_kernel")}
             for v in ("parent", "current")},
      })
      print(json.dumps(results[-1]), flush=True)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  print(smi)
  if args.out:
    with open(args.out, "w") as f:
      json.dump({"kernels": results, "nvidia_smi": smi}, f, indent=1)
  return 0


if __name__ == "__main__":
  sys.exit(main())
