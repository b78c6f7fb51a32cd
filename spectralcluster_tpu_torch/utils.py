"""Label utilities of the port (host numpy)."""

from __future__ import annotations

import numpy as np


def enforce_ordered_labels(labels: np.ndarray) -> np.ndarray:
  """First-appearance relabeling -> permutation-invariant label sequences.

  Reference utils.py:133-156.
  """
  labels = np.asarray(labels)
  new_labels = labels.copy()
  label_map = {}
  for element in labels.tolist():
    if element not in label_map:
      label_map[element] = len(label_map)
  for key, val in label_map.items():
    new_labels[labels == key] = val
  return new_labels
