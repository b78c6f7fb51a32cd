"""Batch clustering of many utterances over a device mesh.

Port of ``spectralcluster_tpu/parallel/batch.py``, with its signatures and
return values: the batched step's factories ``make_batched_cluster_fn``,
``make_batched_autotune_eval_fn`` and ``make_batched_kmeans_fn``, and the
drivers ``cluster_batch``, ``cluster_batch_streamed`` and
``cluster_batch_autotuned``. As in the JAX package, a chunk of padded
utterances is one program: ``pipeline.spectral_cluster_fixed_k_batched``,
the written-out ``vmap`` of the fixed-k pipeline, whose kernels, eigh and
K-Means loop run once per chunk per device, not once per utterance,
whatever the eigensolver.

  * every utterance is zero-padded to ``pad_bucket`` of the longest one in
    the call (of the whole stream in ``cluster_batch_streamed``) and keeps
    ``n_valid`` = its length, as a (B,) tensor on the device. Running it
    unpadded would not be the same: k-means++ draws over the padded rows;
  * utterance i draws its K-Means seeding from the JAX key data
    ``prng.key(seed + i)``, the JAX package's ``PRNGKey(seed + i)``;
  * the batch axis is cut as the JAX package pads it, to b_pad, a multiple
    of the mesh's ``batch`` size: shard k holds rows [k·b_pad/dp,
    (k+1)·b_pad/dp). In one process shard k runs on ``mesh.devices[k, 0]``
    (the shards of one device run as one call); the JAX package's padding
    utterances are discarded there, so the port does not compute them;
  * on a mesh of ``torch.distributed`` ranks each rank computes the shard
    of its batch index and the results are gathered over its ``batch``
    line (``collectives.axis_groups(mesh, "batch")``), so every rank
    returns the whole batch. Every rank must pass the same utterances; the
    drivers check the count and the lengths across ranks and raise on a
    mismatch;
  * constraint matrices are zero-padded to (n_pad, n_pad) per utterance.

The JAX package caches its factories' compiled steps per ``(cfg, mesh)``.
Here a factory's result holds only ``cfg`` and ``mesh`` (the kernels are
built once per process by ``kernels/build.py``), so nothing is cached.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import typing
import zlib

import numpy as np
import torch

from spectralcluster_tpu_torch import pipeline as pipeline_lib
from spectralcluster_tpu_torch import prng
from spectralcluster_tpu_torch.parallel import collectives
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
from spectralcluster_tpu_torch.precision import fp32_precision


def _padded_constraint(cm, n_pad: int) -> np.ndarray:
  out = np.zeros((n_pad, n_pad), dtype=np.float32)
  k = np.asarray(cm).shape[0]
  out[:k, :k] = cm
  return out


def _check_constraints(constraint_matrices, b: int):
  if constraint_matrices is not None and len(constraint_matrices) != b:
    raise ValueError("need one constraint matrix per utterance")


def _keys(seed: int, rows) -> np.ndarray:
  """(len(rows), 2) uint32 JAX key data of ``PRNGKey(seed + row)``."""
  return np.stack([prng.key(seed + j) for j in rows]).reshape(-1, 2)


def _shards(mesh: mesh_lib.Mesh,
            count: int) -> typing.List[typing.Tuple[torch.device,
                                                    typing.List[int]]]:
  """The (device, rows) this process computes of a batch of ``count``.

  In one process every device that holds rows (``mesh.batch_sharding``),
  shards of one device merged; on a mesh of ranks the one shard of this
  rank's batch index (``mesh.batch_rows``), possibly empty.
  """
  if mesh.ranks is not None:
    group = collectives.axis_groups(mesh, "batch")[0]
    return [(group.devices[0],
             mesh_lib.batch_rows(mesh, count)[group.position])]
  by_device = collections.OrderedDict()
  for j, dev in enumerate(mesh_lib.batch_sharding(mesh, count)):
    by_device.setdefault(dev, []).append(j)
  return list(by_device.items())


def _gather_rows(mesh: mesh_lib.Mesh, count: int, parts) -> torch.Tensor:
  """The (count, ...) tensor of a batch from the ``(rows, tensor)`` parts
  this process computed, on the first part's device. On a mesh of ranks
  each rank's shard is padded to the first shard's rows and all-gathered
  over its batch line; the padding is dropped."""
  if mesh.ranks is not None:
    ((rows, t),) = parts
    per = len(mesh_lib.batch_rows(mesh, count)[0])
    padded = t.new_zeros((per,) + tuple(t.shape[1:]))
    padded[:len(rows)] = t
    group = collectives.axis_groups(mesh, "batch")[0]
    return group.all_gather([padded])[:count]
  first = parts[0][1]
  out = first.new_empty((count,) + tuple(first.shape[1:]))
  for rows, t in parts:
    out[rows] = t.to(out.device)
  return out


def _map_shards(mesh: mesh_lib.Mesh, count: int, step, empty):
  """``step(device, rows)``, a tuple of tensors, on each shard this process
  computes of a batch of ``count`` (``empty(device)``, the same tensors
  with no rows, where a rank's shard holds none); each output gathered
  over the batch into a (count, ...) tensor."""
  parts = [(rows, step(dev, rows) if rows else empty(dev))
           for dev, rows in _shards(mesh, count)]
  return tuple(_gather_rows(mesh, count, [(rows, out[i])
                                          for rows, out in parts])
               for i in range(len(parts[0][1])))


def _no_labels(device: torch.device, n: int):
  """The (labels, n_clusters) of a shard with no rows."""
  return (torch.zeros((0, n), dtype=torch.int32, device=device),
          torch.zeros((0,), dtype=torch.int32, device=device))


def _as_host_keys(keys) -> np.ndarray:
  if isinstance(keys, torch.Tensor):
    keys = keys.cpu().numpy()
  return np.asarray(keys, dtype=np.uint32)


def _rows_to(t, rows, device: torch.device):
  """Rows ``rows`` of a host array or a tensor, on ``device``."""
  if t is None:
    return None
  return torch.as_tensor(t[rows]).to(device)


class _BatchedClusterFn:
  """``make_batched_cluster_fn``'s step: the whole batch through
  ``__call__``, one device's rows through ``shard``."""

  def __init__(self, cfg: pipeline_lib.PipelineConfig, mesh: mesh_lib.Mesh):
    self.cfg = cfg
    self.mesh = mesh

  def shard(self, x: torch.Tensor, n_valid: torch.Tensor, keys: np.ndarray,
            constraint_matrices: typing.Optional[torch.Tensor] = None):
    """The batched step on one device's (B_k, N, d) rows: (labels
    (B_k, N), n_clusters (B_k,)), int32."""
    labels, n_clusters, _, _ = pipeline_lib.spectral_cluster_fixed_k_batched(
        x, keys, self.cfg, constraint_matrices, n_valid)
    return labels.to(torch.int32), n_clusters.to(torch.int32)

  def __call__(self, embeddings, n_valid, keys, constraint_matrices=None):
    b, n = embeddings.shape[:2]
    keys = _as_host_keys(keys)
    return _map_shards(
        self.mesh, b,
        lambda dev, rows: self.shard(
            _rows_to(embeddings, rows, dev).float(),
            _rows_to(n_valid, rows, dev), keys[rows],
            _rows_to(constraint_matrices, rows, dev)),
        lambda dev: _no_labels(dev, n))


def make_batched_cluster_fn(cfg: pipeline_lib.PipelineConfig,
                            mesh: mesh_lib.Mesh):
  """The DP batched clustering step.

  Returns fn(embeddings (B, N, d), n_valid (B,), keys (B, 2),
  constraint_matrices (B, N, N) or None) -> (labels (B, N), n_clusters
  (B,)) as tensors; ``keys`` is uint32 JAX key data. The JAX package
  wants B divisible by the mesh's batch axis size; here any B splits as
  its padding to such a multiple would, and no padding row is computed.
  ``fn.shard`` runs one device's rows.
  """
  return _BatchedClusterFn(cfg, mesh)


def make_batched_autotune_eval_fn(cfg: pipeline_lib.PipelineConfig,
                                  mesh: mesh_lib.Mesh, with_constraint: bool):
  """One AutoTune level for a whole batch: fn(embeddings (B, N, d),
  n_valid (B,), ps (B, C), constraint_matrices=None) -> (eigenvectors
  (B, C, N, k_cap), n_clusters (B, C), deltas (B, C)): the affinity once
  per utterance, then refine -> eigh -> gap for its C candidates, as one
  (B·C, N, N) batch per device."""
  k_cap = max(cfg.max_clusters, cfg.min_clusters or 0)

  def fn(embeddings, n_valid, ps, constraint_matrices=None):
    if (constraint_matrices is not None) != with_constraint:
      raise ValueError(f"this step was built with with_constraint="
                       f"{with_constraint}")
    b, n = embeddings.shape[:2]
    c = np.asarray(ps).shape[1]

    def step(dev, rows):
      cms = _rows_to(constraint_matrices, rows, dev)
      nv = _rows_to(n_valid, rows, dev)
      with fp32_precision():
        affinity = pipeline_lib.prepare_affinity(
            _rows_to(embeddings, rows, dev).float(), cfg, nv, cms)
        _, vs, ns, deltas = pipeline_lib.evaluate_candidates_batched(
            affinity, cfg, _rows_to(ps, rows, dev).float(), nv, cms, k_cap)
      return vs, ns.to(torch.int32), deltas

    return _map_shards(mesh, b, step, lambda dev: (
        torch.zeros((0, c, n, k_cap), device=dev),
        torch.zeros((0, c), dtype=torch.int32, device=dev),
        torch.zeros((0, c), device=dev)))

  return fn


def make_batched_kmeans_fn(cfg: pipeline_lib.PipelineConfig,
                           mesh: mesh_lib.Mesh):
  """Final AutoTune stage: batched K-Means on the winning eigenvectors.
  fn(vs (B, N, k), n_gap (B,), n_valid (B,), keys (B, 2)) -> (labels
  (B, N), n_clusters (B,))."""

  def fn(vs, n_gap, n_valid, keys):
    b, n = vs.shape[:2]
    keys = _as_host_keys(keys)

    def step(dev, rows):
      with fp32_precision():
        labels, n_clusters = pipeline_lib._cluster_from_eigs_batched(
            _rows_to(vs, rows, dev), _rows_to(n_gap, rows, dev), cfg,
            keys[rows], _rows_to(n_valid, rows, dev), 0.001)
      return labels.to(torch.int32), n_clusters.to(torch.int32)

    return _map_shards(mesh, b, step, lambda dev: _no_labels(dev, n))

  return fn


def _check_same_batch(mesh: mesh_lib.Mesh, lengths, d: int):
  """On a mesh of ranks: every rank must pass the same utterances (count,
  width and lengths), or the gathered batch would mix them."""
  if mesh.ranks is None:
    return
  group = collectives.mesh_group(mesh)
  crc = zlib.crc32(np.asarray(lengths, np.int64).tobytes())
  mine = torch.tensor([[len(lengths), d, crc]], dtype=torch.int64,
                      device=group.devices[0])
  every = group.all_gather([mine])
  if not bool(torch.all(every == mine)):
    raise ValueError("every rank must pass the same utterances (count and "
                     f"lengths); got {every.tolist()}")


_Part = collections.namedtuple("_Part", "device rows x n_valid cms ready host")


def _stage(utterances, lengths, constraint_matrices, lo: int, count: int,
           mesh: mesh_lib.Mesh, n_pad: int, host_dtype: torch.dtype,
           copy_streams: typing.Dict) -> typing.List[_Part]:
  """Pad this process's utterances of lo..lo+count-1 into one host buffer
  per device (pinned for a card) and start their copies to the device; on
  a card the copies run on the card's side stream in ``copy_streams`` and
  ``ready`` is the event that ends them."""
  d = np.asarray(utterances[lo]).shape[1]
  parts = []
  for dev, rows in _shards(mesh, count):
    cuda = dev.type == "cuda"
    host = torch.zeros((len(rows), n_pad, d), dtype=host_dtype,
                       pin_memory=cuda)
    host_nv = torch.tensor([lengths[lo + j] for j in rows],
                           dtype=torch.int32)
    for r, j in enumerate(rows):
      u = torch.as_tensor(np.asarray(utterances[lo + j]))
      host[r, :u.shape[0]] = u.to(host_dtype)
    host_cms = None
    if constraint_matrices is not None:
      host_cms = torch.from_numpy(np.stack([
          _padded_constraint(constraint_matrices[lo + j], n_pad)
          for j in rows]).reshape(len(rows), n_pad, n_pad))
    if cuda:
      host_nv = host_nv.pin_memory()
      if host_cms is not None:
        host_cms = host_cms.pin_memory()
    ready = None
    if cuda and dev not in copy_streams:
      copy_streams[dev] = torch.cuda.Stream(dev)
    with (torch.cuda.stream(copy_streams[dev]) if cuda
          else contextlib.nullcontext()):
      x = host.to(dev, non_blocking=True)
      nv = host_nv.to(dev, non_blocking=True)
      cms = None if host_cms is None else host_cms.to(dev, non_blocking=True)
      if cuda:
        ready = torch.cuda.Event()
        ready.record()
    parts.append(_Part(dev, rows, x, nv, cms, ready,
                       (host, host_nv, host_cms)))
  return parts


def _compute(fn: _BatchedClusterFn, parts: typing.List[_Part], lo: int,
             count: int, seed: int):
  """Cluster a staged chunk, one batched step per device on its current
  stream (the labels of a mesh of ranks gathered over the batch line),
  then start the labels' copies back to (pinned) host memory."""
  computed = []
  for part in parts:
    x, nv, cms = part.x, part.n_valid, part.cms
    if part.ready is not None:
      stream = torch.cuda.current_stream(part.device)
      stream.wait_event(part.ready)
      # The copies were allocated on the side stream: keep their memory
      # until this stream is done with it.
      for t in (x, nv, cms):
        if t is not None:
          t.record_stream(stream)
    labels = _no_labels(part.device, x.shape[1])[0]
    if part.rows:
      x = x.float()  # a half-width transfer is cast to float32 on the device
      labels = fn.shard(x, nv, _keys(seed + lo, part.rows), cms)[0]
    computed.append((part.rows, labels))
  if fn.mesh.ranks is not None:
    computed = [(list(range(count)), _gather_rows(fn.mesh, count, computed))]
  fetches = []
  for rows, labels in computed:
    cuda = labels.device.type == "cuda"
    host = torch.empty(labels.shape, dtype=labels.dtype, pin_memory=cuda)
    host.copy_(labels, non_blocking=True)
    done = None
    if cuda:
      done = torch.cuda.Event()
      done.record()
    fetches.append((rows, host, done))
  return lo, fetches


def _fetch(computed, lengths) -> typing.List[np.ndarray]:
  """Wait for a chunk's labels and trim each to its utterance's length."""
  lo, fetches = computed
  out = {}
  for rows, host, done in fetches:
    if done is not None:
      done.synchronize()
    for r, j in enumerate(rows):
      out[j] = host[r, :lengths[lo + j]].numpy().copy()
  return [out[j] for j in sorted(out)]


def _drive(utterances, cfg, mesh, seed, chunk, window, constraint_matrices,
           host_dtype, n_pad) -> typing.List[np.ndarray]:
  """Stage up to ``window`` chunks ahead of the one being clustered, and
  fetch a chunk's labels ``window`` chunks after it was clustered."""
  b = len(utterances)
  lengths = [np.asarray(u).shape[0] for u in utterances]
  fn = make_batched_cluster_fn(cfg, mesh)
  copy_streams = {}
  staged, computed = collections.deque(), collections.deque()
  out: typing.List[np.ndarray] = []
  next_lo = 0
  for lo in range(0, b, chunk):
    while next_lo < b and len(staged) < window:
      staged.append(_stage(utterances, lengths, constraint_matrices, next_lo,
                           min(chunk, b - next_lo), mesh, n_pad, host_dtype,
                           copy_streams))
      next_lo += chunk
    computed.append(_compute(fn, staged.popleft(), lo, min(chunk, b - lo),
                             seed))
    if len(computed) >= window:
      out.extend(_fetch(computed.popleft(), lengths))
  while computed:
    out.extend(_fetch(computed.popleft(), lengths))
  return out


def cluster_batch_streamed(
    utterances: typing.Sequence[np.ndarray],
    cfg: pipeline_lib.PipelineConfig,
    mesh: typing.Optional[mesh_lib.Mesh] = None,
    seed: int = 0,
    chunk: int = 16,
    window: int = 4,
    constraint_matrices: typing.Optional[
        typing.Sequence[np.ndarray]] = None,
    transfer_dtype: typing.Optional[torch.dtype] = None,
) -> typing.List[np.ndarray]:
  """Chunked batch clustering with transfer/compute overlap.

  Chunk i+1..i+window are padded into pinned host buffers and copied to
  the card on a side stream (``non_blocking``) while chunk i is clustered
  on the main stream, one batched step per device, which waits on each
  chunk's copy event; each chunk's labels come back by a non-blocking copy
  that is waited on only when they are handed back. Utterance lo+j of the
  chunk at lo is seeded ``seed + lo + j``, and every chunk pads to the
  bucket of the longest utterance of the whole stream, so the labels equal
  ``cluster_batch`` on each chunk with ``seed=lo`` when every chunk holds
  one.

  ``transfer_dtype=torch.bfloat16`` ships the embeddings at half width and
  casts them to float32 on the card before the pipeline runs, which stays
  IEEE float32. The rounding perturbs cosine affinities by ~1e-3: the
  labels are those of other inputs, so keep the float32 default where
  parity with the reference is checked.
  """
  if mesh is None:
    mesh = mesh_lib.make_mesh()
  dp = mesh.shape["batch"]
  if chunk % dp:
    chunk = -(-chunk // dp) * dp
  _check_constraints(constraint_matrices, len(utterances))
  lengths = [np.asarray(u).shape[0] for u in utterances]
  _check_same_batch(mesh, lengths, np.asarray(utterances[0]).shape[1])
  n_pad = pipeline_lib.pad_bucket(max(lengths))
  return _drive(utterances, cfg, mesh, seed, chunk, window,
                constraint_matrices, transfer_dtype or torch.float32, n_pad)


def cluster_batch(
    utterances: typing.Sequence[np.ndarray],
    cfg: pipeline_lib.PipelineConfig,
    mesh: typing.Optional[mesh_lib.Mesh] = None,
    seed: int = 0,
    constraint_matrices: typing.Optional[
        typing.Sequence[np.ndarray]] = None,
) -> typing.List[np.ndarray]:
  """Cluster many variable-length utterances, data parallel.

  Pads every utterance to a common bucket, spreads the batch over the
  mesh's ``batch`` axis and returns per-utterance label arrays (trimmed to
  the true lengths). ``constraint_matrices`` (one per utterance, or None)
  enables the constrained Turn-to-Diarize configs; with ``cfg.autotune``
  (an ``AutoTuneStatic``) every utterance's level-1 sweep runs in the same
  batched step.
  """
  if mesh is None:
    mesh = mesh_lib.make_mesh()
  dp = mesh.shape["batch"]
  b = len(utterances)
  b_pad = -(-b // dp) * dp
  return cluster_batch_streamed(utterances, cfg, mesh=mesh, seed=seed,
                                chunk=b_pad, window=1,
                                constraint_matrices=constraint_matrices)


def cluster_batch_autotuned(
    utterances: typing.Sequence[np.ndarray],
    cfg: pipeline_lib.PipelineConfig,
    autotune,
    mesh: typing.Optional[mesh_lib.Mesh] = None,
    seed: int = 0,
    constraint_matrices: typing.Optional[
        typing.Sequence[np.ndarray]] = None,
) -> typing.List[np.ndarray]:
  """Multi-level auto-tuned batch clustering, one batched call per level.

  ``autotune`` is an ``autotune.AutoTune`` TEMPLATE: each utterance runs
  its own ``search()`` on a copy, with the reference's memoization and
  narrowing, all in lockstep. Each level evaluates every utterance's
  un-memoized candidates as one (B, C) call of
  ``make_batched_autotune_eval_fn``, C the most new candidates of any
  utterance; shorter rows repeat their last candidate and those results
  are ignored, as in the JAX package. The level's counts and deltas come
  to the host for the narrowing; the winners' eigenvectors stay on the
  device, and one ``make_batched_kmeans_fn`` call seeded ``seed + i``
  finishes the batch. cfg.autotune must be None (this driver IS the
  autotune loop); cfg.max_clusters is required.
  """
  if cfg.autotune is not None:
    raise ValueError("cluster_batch_autotuned drives the search itself; "
                     "leave cfg.autotune unset")
  if cfg.max_clusters is None:
    raise ValueError("cluster_batch_autotuned requires cfg.max_clusters")
  if mesh is None:
    mesh = mesh_lib.make_mesh()
  b = len(utterances)
  _check_constraints(constraint_matrices, b)
  lengths = [np.asarray(u).shape[0] for u in utterances]
  d = np.asarray(utterances[0]).shape[1]
  _check_same_batch(mesh, lengths, d)
  n_pad = pipeline_lib.pad_bucket(max(lengths))
  # The rows split over the batch axis as the JAX package's padding to a
  # multiple of it would split them; no padding row is computed.
  batch = np.zeros((b, n_pad, d), dtype=np.float32)
  n_valid = np.array(lengths, dtype=np.int32)
  for i, u in enumerate(utterances):
    batch[i, :lengths[i]] = u
  cms = None
  if constraint_matrices is not None:
    cms = np.stack([_padded_constraint(cm, n_pad)
                    for cm in constraint_matrices])
  eval_fn = make_batched_autotune_eval_fn(cfg, mesh, cms is not None)

  searches = [copy.copy(autotune).search() for _ in range(b)]
  pending = [next(s) for s in searches]
  fill = [0.5] * b
  results: typing.List[typing.Any] = [None] * b
  live = [True] * b
  while any(live):
    c_max = max(len(pending[i]) for i in range(b) if live[i])
    if c_max:
      ps = np.zeros((b, c_max), dtype=np.float32)
      for i in range(b):
        row = list(pending[i]) if live[i] and len(pending[i]) else [fill[i]]
        ps[i] = (row + [row[-1]] * c_max)[:c_max]
        fill[i] = row[-1]
      vs, ns, deltas = eval_fn(batch, n_valid, ps, cms)
      ns, deltas = ns.cpu().numpy(), deltas.cpu().numpy()
    for i in range(b):
      if not live[i]:
        continue
      cands = pending[i]
      sent = None
      if len(cands):
        k = len(cands)
        ratios = np.array([autotune.ratio_from_proxy(float(p), float(dl))
                           for p, dl in zip(cands, deltas[i, :k])])
        sent = (ratios, vs[i, :k], ns[i, :k])
      try:
        pending[i] = searches[i].send(sent)
      except StopIteration as done:
        results[i] = done.value
        live[i] = False

  best_vs = torch.stack([r[0] for r in results])
  n_gap = torch.tensor([r[1] for r in results], dtype=torch.int32)
  labels, _ = make_batched_kmeans_fn(cfg, mesh)(
      best_vs, n_gap, n_valid, _keys(seed, range(b)))
  labels = labels.cpu().numpy()
  return [labels[i, :lengths[i]] for i in range(b)]
