"""Record the JAX package's streaming label histories for the port's checks.

Drives the JAX ``MultiStageClusterer`` over ``fixtures.make_stream(1500)``
(the stream of ``benchmarks/bench_streaming.py``) with that bench's main
clusterer (min 2, max 7 clusters, icassp2018 refinement) and L=50, U1=100,
U2=600, fallback_threshold 0.5: once without deflicker and once with the
Hungarian deflicker. Writes ``tests/data/reference_streaming.npz``:

  * ``{mode}_step_{s}``: the label history returned at step s, for s in
    STEPS (int16);
  * ``{mode}_compression_labels``: the final compression chain;
  * ``{mode}_compressions``: how many dynamic compressions ran;

with mode ``nodeflicker`` or ``hungarian``. ``chip_smoke.py`` holds the
port's stream on the card against this file. Prints which AHC backend the
JAX package used (its native nn-chain library, or numpy).

Usage: ./run_cpu.sh python tools/record_streaming_reference.py
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from spectralcluster_tpu import ahc, configs  # noqa: E402
from spectralcluster_tpu.clusterer import SpectralClusterer  # noqa: E402
from spectralcluster_tpu.streaming import MultiStageClusterer  # noqa: E402
from spectralcluster_tpu.types import Deflicker  # noqa: E402
from spectralcluster_tpu_torch.fixtures import make_stream  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "reference_streaming.npz")
N_STEPS = 1500
STEPS = (1, 50, 51, 100, 101, 600, 601, 1100, 1101, 1500)
MODES = {"nodeflicker": Deflicker.NoDeflicker,
         "hungarian": Deflicker.Hungarian}


def main():
  stream, _ = make_stream(N_STEPS)
  print(f"AHC backend: {'native' if ahc._native_ok() else 'numpy'}",
        flush=True)
  db = {}
  for mode, deflicker in MODES.items():
    main_clusterer = SpectralClusterer(
        min_clusters=2, max_clusters=7,
        refinement_options=configs.icassp2018_refinement_options())
    ms = MultiStageClusterer(main_clusterer=main_clusterer,
                             fallback_threshold=0.5, L=50, U1=100, U2=600,
                             deflicker=deflicker)
    compressions = 0
    t0 = time.time()
    for step, e in enumerate(stream, start=1):
      rows = 0 if ms.cache is None else np.atleast_2d(ms.cache).shape[0]
      out = ms.streaming_predict(e)
      if ms.cache.shape[0] <= rows:  # the cache was compressed
        compressions += 1
      if step in STEPS:
        db[f"{mode}_step_{step}"] = np.asarray(out).astype(np.int16)
    db[f"{mode}_compression_labels"] = np.asarray(
        ms.compression_labels).astype(np.int16)
    db[f"{mode}_compressions"] = np.asarray(compressions)
    print(f"{mode}: {N_STEPS} steps in {time.time() - t0:.1f} s, "
          f"{compressions} compressions, "
          f"{np.unique(np.asarray(out)).size} labels", flush=True)
  os.makedirs(os.path.dirname(OUT), exist_ok=True)
  np.savez_compressed(OUT, **db)
  print(f"wrote {OUT}", flush=True)


if __name__ == "__main__":
  main()
