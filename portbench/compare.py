"""The comparison that decides ``correct``.

Each timed call's answer is held against the plain reference of its
configuration (``reference/<name>.py``), computed in float64 after the
window on the same recording. Per recording (the worst of its calls):

  * ``n_clusters_diff``: the distance of the program's cluster count from
    the reference's admissible counts: its own, and those its eigengap
    rule gives on eigenvalues within the configuration's ``count_band``
    of its own, where an eigenvalue lies that close to a threshold of the
    rule (the float32 program cannot decide those);
  * ``label_error``: the share of the recording's segments whose label is
    not the nearest cluster mean (cosine distance) in the reference's
    spectral embedding of as many columns by ``MARGIN`` or more, or 1
    where the labels name a number of clusters that is not admissible.
    Any converged K-Means partition of the right rows reads 0, whatever
    its start;
  * ``eig_err``: the largest gap between a returned eigenvalue and the
    reference's, over the max_clusters + 1 extreme ones, as a share of the
    largest of those reference eigenvalues in magnitude.

Over the recordings of a run: the worst ``n_clusters_diff`` and
``label_error``, and the median and the largest ``eig_err``
(``eig_err_median``, ``eig_err_max``). A cell limits the numbers its
``limits/<workload>.json`` names: an eigenvalue gap's limit sits between
what the program and what the control (the reference in the precision
below the stated one) read, so a cell limits the largest where it
separates the two, else the median. A number over its limit, a call that
failed, or a call with no answer makes the run not correct.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import common

# A label counts as wrong only where another cluster's mean is nearer than
# its own by this much cosine distance: rounding alone, and Lloyd's stop on
# the centroids' shift, leave a segment this close to a boundary at most.
MARGIN = 1e-2


def call_numbers(out: dict, ref: dict) -> dict:
  """The compared numbers of one call's answer ``out`` against ``ref``."""
  got = {}
  labels = np.asarray(out["labels"]).ravel()
  emb = ref["embedding"]
  k = np.unique(labels).size
  if labels.shape[0] != emb.shape[0] or k not in ref["counts"]:
    got["label_error"] = 1.0
  else:
    got["label_error"] = (common.label_errors(emb[:, :k], labels, MARGIN)
                          / labels.shape[0])
  if out.get("n_clusters") is not None:
    got["n_clusters_diff"] = min(abs(int(out["n_clusters"]) - c)
                                 for c in ref["counts"])
  if out.get("eigenvalues") is not None:
    w_ref = np.asarray(ref["eigenvalues"], np.float64)
    w = np.asarray(out["eigenvalues"], np.float64)[:w_ref.shape[0]]
    if w.shape != w_ref.shape or not np.all(np.isfinite(w)):
      got["eig_err"] = float("inf")
    else:
      got["eig_err"] = float(np.max(np.abs(w - w_ref))
                             / np.max(np.abs(w_ref)))
  return got


def worst(numbers: list) -> dict:
  """Each number's worst over a list of calls' numbers."""
  out: dict = {}
  for got in numbers:
    for key, value in got.items():
      out[key] = max(out.get(key, value), value)
  return out


def over_recordings(per_recording: list) -> dict:
  """A run's numbers from each recording's worst: the worst of each,
  and the median and the largest ``eig_err``."""
  out = worst(per_recording)
  errs = [r["eig_err"] for r in per_recording if "eig_err" in r]
  out.pop("eig_err", None)
  if errs:
    out["eig_err_median"] = float(np.median(errs))
    out["eig_err_max"] = float(np.max(errs))
  return out


def judge(numbers: dict, limits: dict):
  """(correct, checks): each limited number beside its limit, in the
  limits' order. A limited number that no call produced fails."""
  checks = {}
  correct = True
  for key, limit in limits.items():
    value = numbers.get(key)
    ok = value is not None and value <= limit
    correct = correct and ok
    checks[key] = {"value": value, "limit": limit}
  return correct, checks
