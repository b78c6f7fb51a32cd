"""Agglomerative hierarchical clustering (AHC), on the host.

Port of ``spectralcluster_tpu/ahc.py``, which replaces
sklearn.cluster.AgglomerativeClustering as the reference uses it:
  * pre-clustering: metric="cosine", linkage="complete", fixed n_clusters
    (spectral_clusterer.py:184-188, multi_stage_clusterer.py:108-111)
  * fallback: metric="cosine", linkage="average", distance_threshold cut
    (fallback_clusterer.py:110-115)

AHC's merge loop is sequential, so it runs on the host as the
nearest-neighbor-chain algorithm: O(N²) in all, the same dendrogram as
greedy agglomeration for the reducible linkages used here. A C++ chain
(``native/``, built with g++ at first use) answers when it is available,
as in the JAX package; the numpy chain is the fallback, with the same
merges and the same label ids. ``backend()`` says which one answers.
"""

from __future__ import annotations

import typing

import numpy as np

_LINKAGES = ("complete", "average", "single")

try:
  from spectralcluster_tpu_torch.native import ahc_native
except Exception:  # pragma: no cover - the native build is optional
  ahc_native = None


def _native_ok() -> bool:
  """Lazily build and load the C++ chain (the first call may compile it)."""
  return ahc_native is not None and ahc_native.available()


def backend() -> str:
  """The chain that answers ``nn_chain_linkage`` and ``ahc_labels``:
  "native" (the C++ library) or "numpy"."""
  return "native" if _native_ok() else "numpy"


def cosine_distance_matrix(embeddings: np.ndarray) -> np.ndarray:
  """1 - cosine similarity, computed with one (N,d)x(d,N) matmul."""
  x = np.asarray(embeddings, dtype=np.float64)
  norms = np.linalg.norm(x, axis=1, keepdims=True)
  sim = (x / norms) @ (x / norms).T
  d = 1.0 - sim
  np.fill_diagonal(d, 0.0)
  return d


def euclidean_distance_matrix(embeddings: np.ndarray) -> np.ndarray:
  x = np.asarray(embeddings, dtype=np.float64)
  sq = np.sum(x * x, axis=1)
  d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
  np.fill_diagonal(d2, 0.0)
  return np.sqrt(np.maximum(d2, 0.0))


def nn_chain_linkage(dist: np.ndarray,
                     linkage: str = "complete") -> np.ndarray:
  """Nearest-neighbor-chain agglomeration.

  Args:
    dist: (N, N) symmetric distance matrix.
    linkage: "complete" | "average" | "single".

  Returns:
    (N-1, 3) array of merges [id_a, id_b, height] in chain order; cluster ids
    are scipy-style: originals 0..N-1, the i-th merge creates id N+i.
  """
  if linkage not in _LINKAGES:
    raise ValueError(f"Unsupported linkage {linkage!r}")
  n = dist.shape[0]
  if _native_ok():
    return ahc_native.nn_chain_linkage(dist, linkage)
  d = np.array(dist, dtype=np.float64, copy=True)
  np.fill_diagonal(d, np.inf)
  size = np.ones(n, dtype=np.int64)
  # `slot_id[s]` = current cluster id occupying matrix slot s.
  slot_id = np.arange(n, dtype=np.int64)
  active = np.ones(n, dtype=bool)
  merges = np.empty((n - 1, 3), dtype=np.float64)
  chain: typing.List[int] = []
  next_id = n
  for m in range(n - 1):
    if not chain:
      chain.append(int(np.flatnonzero(active)[0]))
    while True:
      x = chain[-1]
      row = np.where(active, d[x], np.inf)
      row[x] = np.inf
      y = int(np.argmin(row))
      # Prefer the previous chain element on ties (termination guarantee).
      if len(chain) > 1 and row[chain[-2]] == row[y]:
        y = chain[-2]
      if len(chain) > 1 and y == chain[-2]:
        height = row[y]
        chain.pop()
        chain.pop()
        break
      chain.append(y)
    # Merge slots x and y into slot x with a new cluster id.
    merges[m] = (slot_id[x], slot_id[y], height)
    sx, sy = size[x], size[y]
    if linkage == "complete":
      new_row = np.maximum(d[x], d[y])
    elif linkage == "average":
      new_row = (sx * d[x] + sy * d[y]) / (sx + sy)
    else:  # single
      new_row = np.minimum(d[x], d[y])
    d[x, :] = new_row
    d[:, x] = new_row
    d[x, x] = np.inf
    active[y] = False
    size[x] = sx + sy
    slot_id[x] = next_id
    next_id += 1
  return merges


def _cut_labels(merges: np.ndarray, n: int,
                apply_mask: np.ndarray) -> np.ndarray:
  """Union-find over the selected merges, then first-appearance relabel."""
  parent = np.arange(2 * n - 1, dtype=np.int64)

  def find(a: int) -> int:
    while parent[a] != a:
      parent[a] = parent[parent[a]]
      a = parent[a]
    return a

  next_id = n
  for i in range(len(merges)):
    a, b = int(merges[i, 0]), int(merges[i, 1])
    if apply_mask[i]:
      parent[find(a)] = next_id
      parent[find(b)] = next_id
    next_id += 1
  roots = np.array([find(i) for i in range(n)])
  # First-appearance relabel, as the C++ chain does (ahc.cc), so both
  # backends return the same label ids, not just the same partition.
  remap: typing.Dict[int, int] = {}
  labels = np.empty(n, dtype=np.int64)
  for i, r in enumerate(roots):
    labels[i] = remap.setdefault(int(r), len(remap))
  return labels


def ahc_labels(dist: np.ndarray,
               linkage: str = "complete",
               n_clusters: typing.Optional[int] = None,
               distance_threshold: typing.Optional[float] = None) -> np.ndarray:
  """Cut a dendrogram into flat labels.

  Exactly one of ``n_clusters`` / ``distance_threshold`` must be given,
  mirroring sklearn's AgglomerativeClustering contract. The threshold cut
  merges all pairs with linkage distance < threshold (sklearn semantics:
  "the linkage distance threshold above which clusters will not be merged").
  """
  if (n_clusters is None) == (distance_threshold is None):
    raise ValueError(
        "Exactly one of n_clusters and distance_threshold must be set.")
  n = dist.shape[0]
  if n == 1:
    return np.zeros(1, dtype=np.int64)
  if n_clusters is not None and n_clusters >= n:
    return np.arange(n, dtype=np.int64)
  if _native_ok():
    return ahc_native.ahc_labels(dist, linkage, n_clusters,
                                 distance_threshold)
  merges = nn_chain_linkage(dist, linkage)
  # Stable sort by height = scipy/sklearn dendrogram order.
  order = np.argsort(merges[:, 2], kind="stable")
  if n_clusters is not None:
    keep = order[: n - n_clusters]
  else:
    keep = order[merges[order, 2] < distance_threshold]
  mask = np.zeros(len(merges), dtype=bool)
  mask[keep] = True
  return _cut_labels(merges, n, mask)


def agglomerative_cluster(
    embeddings: np.ndarray,
    metric: str = "cosine",
    linkage: str = "complete",
    n_clusters: typing.Optional[int] = None,
    distance_threshold: typing.Optional[float] = None) -> np.ndarray:
  """End-to-end AHC on embeddings (the sklearn-call replacement)."""
  if metric == "cosine":
    dist = cosine_distance_matrix(embeddings)
  elif metric == "euclidean":
    dist = euclidean_distance_matrix(embeddings)
  else:
    raise ValueError(f"Unsupported AHC metric {metric!r}")
  return ahc_labels(dist, linkage, n_clusters, distance_threshold)
