"""Linear sum assignment (Hungarian algorithm), host-side.

A copy of ``spectralcluster_tpu/hungarian.py``, which replaces
scipy.optimize.linear_sum_assignment as used by the streaming deflicker
(reference multi_stage_clusterer.py:52). The cost matrices are tiny
(num_speakers² ≤ ~100), so a host O(n³) shortest-augmenting-path solver is
the right tool; being the same solver, it resolves ties as the JAX package
does.
"""

from __future__ import annotations

import typing

import numpy as np


def linear_sum_assignment(
    cost: np.ndarray,
    maximize: bool = False) -> typing.Tuple[np.ndarray, np.ndarray]:
  """Solve min/max-cost bipartite assignment for an (n, m) matrix, n ≤ m.

  Returns (row_ind, col_ind) with rows in increasing order, like scipy.
  """
  cost = np.asarray(cost, dtype=np.float64)
  if cost.ndim != 2:
    raise ValueError("cost matrix must be 2-D")
  n, m = cost.shape
  transposed = n > m
  if transposed:
    cost = cost.T
    n, m = m, n
  if maximize:
    cost = -cost

  # Shortest-augmenting-path Hungarian with potentials (1-based arrays).
  u = np.zeros(n + 1)
  v = np.zeros(m + 1)
  p = np.zeros(m + 1, dtype=np.int64)     # p[j]: row matched to column j
  way = np.zeros(m + 1, dtype=np.int64)
  for i in range(1, n + 1):
    p[0] = i
    j0 = 0
    minv = np.full(m + 1, np.inf)
    used = np.zeros(m + 1, dtype=bool)
    while True:
      used[j0] = True
      i0 = p[j0]
      cur = cost[i0 - 1, :] - u[i0] - v[1:]
      free = ~used[1:]
      better = free & (cur < minv[1:])
      minv[1:][better] = cur[better]
      way[1:][better] = j0
      masked = np.where(free, minv[1:], np.inf)
      j1 = int(np.argmin(masked)) + 1
      delta = masked[j1 - 1]
      u[p[used]] += delta
      v[used] -= delta
      minv[~used] -= delta
      j0 = j1
      if p[j0] == 0:
        break
    while j0:
      j1 = way[j0]
      p[j0] = p[j1]
      j0 = j1

  col_of_row = np.zeros(n, dtype=np.int64)
  for j in range(1, m + 1):
    if p[j] > 0:
      col_of_row[p[j] - 1] = j - 1
  rows = np.arange(n)
  if transposed:
    order = np.argsort(col_of_row)
    return col_of_row[order], rows[order]
  return rows, col_of_row
