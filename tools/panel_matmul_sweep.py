#!/usr/bin/env python3
"""Time the panel product (kernel 6 of csrc/fused.cu) at every k split.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/panel_matmul_sweep.py [--out FILE]

Builds two copies of `csrc/fused.cu` with one text edit each, so that a
call can force the kernel's k split S (the cluster size, 1-8; 0 keeps the
kernel's own choice): the source as it is, and the same with every block
starting its k range at its first tile (no spread of the row blocks'
starting tiles). On random operands at the solver's shapes (N=10240 and
20480, a 5120-row stripe of 20480, 16 x 1024; each by the transpose of a
contiguous (b, K) panel, as the solver gives it, b = 16 and 1) it prints,
per shape, each copy's time at every S (`chip_smoke.time_ms`: CUDA events
around 10 back-to-back calls, the median of 20 such means), the S the
kernel chooses and its resident blocks, each copy's largest share of the
float64 gate's bound (2^-24·|exact| + K·2^-52·(|a|·|x|)), cuBLAS's float32
product's time and the byte bound; then the card's name and power limit.
The copies are built under build/ (git-ignored).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (batch, N, rows of the N x N operand or None, widths)
CASES = (((), 10240, None, (16, 1)), ((), 20480, None, (16, 1)),
         ((), 20480, (5120, 10240), (16, 1)), ((16,), 1024, None, (16, 1)))
SPLITS = range(0, 9)
_CHOICE = ("template <int NG, bool VEC>\n"
           "int panel_splits(long long blocks, int tiles) {\n")
_START = "const int rot =\n      tiles > 0 ?"


def sources() -> dict:
  """{copy: path} of the two edited copies of csrc/fused.cu."""
  with open(os.path.join(ROOT, "spectralcluster_tpu_torch", "csrc",
                         "fused.cu")) as f:
    text = f.read()
  if text.count(_CHOICE) != 1 or text.count(_START) != 1:
    raise SystemExit("panel_matmul_sweep: csrc/fused.cu no longer has the "
                     "lines this tool edits")
  forced = text.replace(
      _CHOICE, "int g_forced_splits = 0;\n" + _CHOICE
      + "  if (g_forced_splits) return g_forced_splits;\n").replace(
          '}  // extern "C"',
          "void sct_force_splits(int s) { g_forced_splits = s; }\n"
          '}  // extern "C"')
  copies = {"spread_starts": forced,
            "first_tile_starts": forced.replace(_START,
                                                "const int rot =\n      0 ?")}
  out = os.path.join(ROOT, "build", "panel_matmul_sweep")
  os.makedirs(out, exist_ok=True)
  paths = {}
  for name, src in copies.items():
    paths[name] = os.path.join(out, f"fused_{name}.cu")
    with open(paths[name], "w") as f:
      f.write(src)
  return paths


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--out", help="also write the rows to this JSON")
  args = parser.parse_args()
  import torch
  if not torch.cuda.is_available():
    print("panel_matmul_sweep: no CUDA device", file=sys.stderr)
    return 2
  torch.backends.cuda.matmul.allow_tf32 = False
  sys.path.insert(0, ROOT)
  from chip_smoke import card_peaks, time_ms
  from spectralcluster_tpu_torch.kernels import build

  paths = sources()
  with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
    built = dict(zip(paths, pool.map(lambda p: build.build((p,)),
                                     paths.values())))
  libs = {}
  for name, path in built.items():
    lib = ctypes.CDLL(path)
    for fn in ("sct_panel_matmul", "sct_panel_matmul_schedule"):
      getattr(lib, fn).argtypes = list(build._SIGNATURES[fn])
    lib.sct_force_splits.argtypes = [ctypes.c_int]
    libs[name] = lib
  dev = torch.device("cuda")
  bw = card_peaks(torch.cuda.get_device_name(dev))[0]
  stream = torch.cuda.current_stream(dev).cuda_stream
  gen = torch.Generator(dev).manual_seed(0)
  rows_out = []
  for lead, n, rows, widths in CASES:
    full = torch.randn((*lead, n, n), generator=gen, device=dev)
    a = full if rows is None else full[rows[0]:rows[1]]
    batch = lead[0] if lead else 1
    m = a.shape[-2]
    for b in widths:
      x = torch.randn((*lead, b, n), generator=gen,
                      device=dev).transpose(-1, -2)
      exact = torch.matmul(a.double(), x.double())
      bound64 = (2.0**-24 * torch.abs(exact) + n * 2.0**-52 * torch.matmul(
          torch.abs(a).double(), torch.abs(x).double()))
      row = {"shape": [*lead, m, n, b],
             "bound_ms": batch * (m * n + (m + n) * b) * 4 / bw * 1e3,
             "cublas_ms": time_ms(torch, lambda: torch.matmul(a, x))}
      for name, lib in libs.items():
        y = torch.empty((*lead, m, b), device=dev)
        call = (a.data_ptr(), x.data_ptr(), y.data_ptr(), batch, m, n,
                a.stride(-2), a.stride(0) if lead else 0, b, x.stride(-2),
                x.stride(-1), x.stride(0) if lead else 0, stream)

        def run(lib=lib, call=call):
          rc = lib.sct_panel_matmul(*call)
          if rc:
            raise SystemExit(f"sct_panel_matmul: CUDA error {rc}")

        times = {}
        for s in SPLITS:
          lib.sct_force_splits(s)
          times[s] = time_ms(torch, run)
        lib.sct_force_splits(0)
        run()
        splits, resident = ctypes.c_int(0), ctypes.c_int(0)
        lib.sct_panel_matmul_schedule(batch, m, n, b, 1,
                                      ctypes.byref(splits),
                                      ctypes.byref(resident))
        torch.cuda.synchronize()
        row[name] = {
            "ms_by_split": times, "chosen_split": splits.value,
            "resident_blocks": resident.value,
            "float64_bound_share": float(torch.max(
                torch.abs(y.double() - exact) / bound64))}
      rows_out.append(row)
      print(json.dumps(row), flush=True)
      del exact, bound64
    del full, a
    torch.cuda.empty_cache()
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  print(smi)
  if args.out:
    with open(args.out, "w") as f:
      json.dump({"rows": rows_out, "nvidia_smi": smi}, f, indent=1)
  return 0


if __name__ == "__main__":
  sys.exit(main())
