"""A second witness for a cell whose program disagrees with the reference.

    python3 portbench/tools/witness.py --config icassp2018 --traffic long \
        --seeds 201,202,203 [--out witness.jsonl]

For each seed, each recording of the traffic's pool is clustered by the
configuration's preset as it states itself, by the same preset with
``eigensolver=EigenSolver.Eigh`` (the card's full symmetric solve: another
path of the program), and by the float64 reference. Prints, per recording,
the cluster counts, the leading eigenvalues, the compared numbers
(``compare.py``) of both program paths, and the program's warnings. Not
run by the benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
os.environ["SCT_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "build", "spectralcluster_tpu_torch")
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from portbench import compare, generator, run  # noqa: E402


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--config", required=True)
  ap.add_argument("--traffic", required=True)
  ap.add_argument("--seeds", required=True)
  ap.add_argument("--out", default=None)
  args = ap.parse_args(argv)
  import importlib
  import torch
  import spectralcluster_tpu_torch as sct
  device = "cuda" if torch.cuda.is_available() else "cpu"
  config = run.load_json("portbench", "configs", args.config + ".json")
  traffic = run.load_json("portbench", "traffic", args.traffic + ".json")
  ref_lib = importlib.import_module(
      f"portbench.reference.{config['reference']}")
  make = getattr(sct.configs, config["preset"])
  for seed in (int(s) for s in args.seeds.split(",")):
    for rec in generator.make_pool(traffic, seed):
      row = {"seed": seed, "index": rec.index,
             "n": int(rec.embeddings.shape[0]), "speakers": rec.n_speakers}
      for name, kw in (("program", {}),
                       ("program_eigh",
                        {"eigensolver": sct.EigenSolver.Eigh})):
        with warnings.catch_warnings(record=True) as caught:
          warnings.simplefilter("always")
          res = make(device=device, **kw).predict_with_details(
              rec.embeddings)
        row[name] = {"n_clusters": int(res.n_clusters),
                     "labels": np.asarray(res.labels),
                     "eigenvalues": np.asarray(res.eigenvalues)[:8].tolist(),
                     "warnings": [str(w.message)[:160] for w in caught]}
      torch.cuda.empty_cache() if device == "cuda" else None
      ref = ref_lib.solve(rec, config, "float64", device)
      row["reference"] = {"n_clusters": ref["n_clusters"],
                          "eigenvalues": ref["eigenvalues"].tolist()}
      for name in ("program", "program_eigh"):
        out = row[name]
        got = compare.call_numbers(out, ref)
        out["numbers"] = got
        del out["labels"]
      line = json.dumps(row)
      print(line, flush=True)
      if args.out:
        with open(args.out, "a") as f:
          f.write(line + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
