"""Readings that set a cell's limits: the program and the control.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--out control.jsonl]

For each seed: the cell's pool of recordings, one call of the timed entry
on each (the answers a window would give, without a window), then the
plain reference in float64 on each, and the control: the reference put in
the program's place and computed in the precision just below the one the
configuration states (TF32 products for IEEE float32). Prints one JSON
line per seed with the compared numbers of the program and of the control
over the pool (``compare.py``), and each recording's. The benchmark's own
runs do not run this; its readings set ``limits/<workload>.json``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["SCT_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "build", "spectralcluster_tpu_torch")
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

from portbench import compare, generator, run  # noqa: E402


def readings(workload: str, seed: int, control: str, device: str) -> dict:
  import torch
  _, _, config, traffic, _ = run.cell(workload)
  pool = generator.make_pool(traffic, seed)
  entry_mod = importlib.import_module(f"portbench.entries.{traffic['entry']}")
  entry = entry_mod.Entry(config, traffic, device, False)
  t0 = time.perf_counter()
  answers = [(rec, entry.call(rec)) for rec in pool]
  program_s = time.perf_counter() - t0
  entry.close()
  del entry
  gc.collect()
  if device == "cuda":
    torch.cuda.empty_cache()
  ref_lib = importlib.import_module(
      f"portbench.reference.{config['reference']}")
  prog, ctrl, rows, ref_s, ctrl_s = [], [], [], 0.0, 0.0
  for rec, ans in answers:
    t0 = time.perf_counter()
    ref = ref_lib.solve(rec, config, "float64", device)
    ref_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    low = ref_lib.solve(rec, config, control, device)
    ctrl_s += time.perf_counter() - t0
    prog.append(compare.call_numbers(ans, ref))
    ctrl.append(compare.call_numbers(low, ref))
    rows.append({
        "n": int(rec.embeddings.shape[0]), "speakers": rec.n_speakers,
        "n_clusters": [ans.get("n_clusters"), ref["n_clusters"],
                       low["n_clusters"]],
        "eigenvalues": [None if ans.get("eigenvalues") is None else
                        np.asarray(ans["eigenvalues"]).tolist(),
                        ref["eigenvalues"].tolist(),
                        low["eigenvalues"].tolist()],
        "reference_residual": ref["residual"],
        "program": prog[-1], "control": ctrl[-1]})
  return {"workload": workload, "seed": seed, "control": control,
          "program": compare.over_recordings(prog),
          "control_numbers": compare.over_recordings(ctrl),
          "recordings": rows, "program_s": program_s,
          "reference_s": ref_s, "control_s": ctrl_s}


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", required=True)
  ap.add_argument("--out", default=None)
  args = ap.parse_args(argv)
  import torch
  device = "cuda" if torch.cuda.is_available() else "cpu"
  for seed in (int(s) for s in args.seeds.split(",")):
    line = json.dumps(readings(args.workload, seed, "tf32", device))
    print(line, flush=True)
    if args.out:
      with open(args.out, "a") as f:
        f.write(line + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
