"""Timed entry: ``SpectralClusterer.predict``, one recording per call.

The configuration's ``preset`` names the port's preset maker
(``configs.make_icassp2018_clusterer``, ...), built once and called for
every recording; ``clusterer_kwargs`` are passed to the preset maker
(``eigensolver`` by its ``EigenSolver`` name). Each call ends with the
labels on the host.

An entry is what ``run.py`` drives: ``call(recording)`` returns the
answer that ``compare.py`` judges, ``segments(recording)`` the work it
counts, and ``close()`` frees the program's state.
"""

from __future__ import annotations

import numpy as np


class Entry:

  def __init__(self, config: dict, traffic: dict, device: str, trace: bool):
    import spectralcluster_tpu_torch as sct
    # The traced run reads the staged executor's stage durations, which
    # synchronize the card at each stage.
    kwargs = {"staged_stage_timings": True} if trace else {}
    for key, value in (config.get("clusterer_kwargs") or {}).items():
      kwargs[key] = (getattr(sct.EigenSolver, value)
                     if key == "eigensolver" else value)
    self._t = config["options"]["max_clusters"] + 1
    self._clusterer = getattr(sct.configs, config["preset"])(device=device,
                                                             **kwargs)

  def call(self, item):
    """Cluster one recording; returns its answer."""
    result = self._clusterer.predict_with_details(item.embeddings)
    w = result.eigenvalues
    return {
        "labels": np.asarray(result.labels),
        "n_clusters": int(result.n_clusters),
        "eigenvalues": None if w is None else np.asarray(w)[:self._t].copy(),
        "timings": dict(result.timings or {}),
    }

  def segments(self, item) -> int:
    return int(item.embeddings.shape[0])

  def close(self):
    self._clusterer = None
