"""Batch clustering of many utterances over a device mesh.

Port of ``spectralcluster_tpu/parallel/batch.py``, with its signatures and
return values: ``cluster_batch``, ``cluster_batch_streamed`` and
``cluster_batch_autotuned``. The JAX package vmaps the fixed-k pipeline
over a padded batch in one compiled step; the port loops the same
per-utterance pipeline on the card, with the vmap's semantics utterance
for utterance:

  * every utterance is zero-padded to ``pad_bucket`` of the longest one in
    the call (of the whole stream in ``cluster_batch_streamed``) and runs
    ``pipeline.spectral_cluster_fixed_k`` at that padded shape with
    ``n_valid`` = its length. Running it unpadded would not be the same:
    k-means++ draws over the padded rows, so a short utterance beside a
    long one would take other draws;
  * utterance i seeds its K-Means with ``Generator().manual_seed(seed + i)``
    where the JAX package uses ``PRNGKey(seed + i)``; through ``prng.py``
    the draws are the JAX package's own;
  * the batch axis is padded to a multiple of the mesh's ``batch`` size and
    shard k runs on ``mesh.devices[k, 0]`` (``mesh.batch_sharding``): the
    drivers use column 0 only, as the JAX package's DP driver shards only
    the ``batch`` axis (the row-sharded path, ``sharded.py``, uses the
    ``model`` line); the JAX package's padding utterances are discarded
    there, so the port does not compute them;
  * constraint matrices are zero-padded to (n_pad, n_pad) per utterance.

Kernels 1-4 keep their 2-D wrappers, so each launches once per utterance
(``row_max`` twice on the icassp2018 sequence).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import typing

import numpy as np
import torch

from spectralcluster_tpu_torch import pipeline as pipeline_lib
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


def _cluster_one(x: torch.Tensor, n_valid: int, seed: int,
                 cfg: pipeline_lib.PipelineConfig,
                 cm: typing.Optional[torch.Tensor]) -> torch.Tensor:
  """One padded utterance through the fixed-k pipeline; (n_pad,) labels."""
  labels, _, _, _ = pipeline_lib.spectral_cluster_fixed_k(
      x, torch.Generator().manual_seed(seed), cfg, n_valid=n_valid,
      constraint_matrix=cm)
  return labels


_Part = collections.namedtuple("_Part", "device rows x cms ready host")


def _stage(utterances, constraint_matrices, lo: int, count: int, devices,
           n_pad: int, host_dtype: torch.dtype,
           copy_streams: typing.Dict) -> typing.List[_Part]:
  """Pad utterances lo..lo+count-1 into one host buffer per device (pinned
  for a card) and start their copies to the device; on a card the copies
  run on the card's side stream in ``copy_streams`` and ``ready`` is the
  event that ends them."""
  d = np.asarray(utterances[lo]).shape[1]
  by_device = collections.defaultdict(list)
  for j, dev in enumerate(devices[:count]):
    by_device[dev].append(j)
  parts = []
  for dev, rows in by_device.items():
    cuda = dev.type == "cuda"
    host = torch.zeros((len(rows), n_pad, d), dtype=host_dtype,
                       pin_memory=cuda)
    for r, j in enumerate(rows):
      u = torch.as_tensor(np.asarray(utterances[lo + j]))
      host[r, :u.shape[0]] = u.to(host_dtype)
    host_cms = None
    if constraint_matrices is not None:
      host_cms = torch.from_numpy(np.stack([
          _padded_constraint(constraint_matrices[lo + j], n_pad)
          for j in rows]))
      if cuda:
        host_cms = host_cms.pin_memory()
    ready = None
    if cuda and dev not in copy_streams:
      copy_streams[dev] = torch.cuda.Stream(dev)
    with (torch.cuda.stream(copy_streams[dev]) if cuda
          else contextlib.nullcontext()):
      x = host.to(dev, non_blocking=True)
      cms = None if host_cms is None else host_cms.to(dev, non_blocking=True)
      if cuda:
        ready = torch.cuda.Event()
        ready.record()
    parts.append(_Part(dev, rows, x, cms, ready, (host, host_cms)))
  return parts


def _compute(parts: typing.List[_Part], lo: int, lengths, seed: int,
             cfg: pipeline_lib.PipelineConfig):
  """Cluster a staged chunk on its devices' current streams, then start
  the labels' copies back to (pinned) host memory."""
  fetches = []
  for part in parts:
    x, cms = part.x, part.cms
    if part.ready is not None:
      stream = torch.cuda.current_stream(part.device)
      stream.wait_event(part.ready)
      # The copies were allocated on the side stream: keep their memory
      # until this stream is done with it.
      x.record_stream(stream)
      if cms is not None:
        cms.record_stream(stream)
    x = x.float()  # a half-width transfer is cast to float32 on the device
    labels = torch.stack([
        _cluster_one(x[r], lengths[lo + j], seed + lo + j, cfg,
                     None if cms is None else cms[r])
        for r, j in enumerate(part.rows)])
    cuda = part.device.type == "cuda"
    host = torch.empty(labels.shape, dtype=labels.dtype, pin_memory=cuda)
    host.copy_(labels, non_blocking=True)
    done = None
    if cuda:
      done = torch.cuda.Event()
      done.record()
    fetches.append((part.rows, host, done))
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
  devices = mesh_lib.batch_sharding(mesh, chunk)
  copy_streams = {}
  staged, computed = collections.deque(), collections.deque()
  out: typing.List[np.ndarray] = []
  next_lo = 0
  for lo in range(0, b, chunk):
    while next_lo < b and len(staged) < window:
      staged.append(_stage(utterances, constraint_matrices, next_lo,
                           min(chunk, b - next_lo), devices, n_pad,
                           host_dtype, copy_streams))
      next_lo += chunk
    computed.append(_compute(staged.popleft(), lo, lengths, seed, cfg))
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
  on the main stream, which waits on each chunk's copy event; each chunk's
  labels come back by a non-blocking copy that is waited on only when they
  are handed back. Utterance lo+j of the chunk at lo is seeded
  ``seed + lo + j``, and every chunk pads to the bucket of the longest
  utterance of the whole stream, so the labels equal ``cluster_batch`` on
  each chunk with ``seed=lo`` when every chunk holds one.

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
  n_pad = pipeline_lib.pad_bucket(max(np.asarray(u).shape[0]
                                      for u in utterances))
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
  (an ``AutoTuneStatic``) each utterance runs the level-1 sweep.
  """
  if mesh is None:
    mesh = mesh_lib.make_mesh()
  dp = mesh.shape["batch"]
  b = len(utterances)
  b_pad = -(-b // dp) * dp
  return cluster_batch_streamed(utterances, cfg, mesh=mesh, seed=seed,
                                chunk=b_pad, window=1,
                                constraint_matrices=constraint_matrices)


def _tune(affinity: torch.Tensor, cfg: pipeline_lib.PipelineConfig,
          autotune, n_valid: int, cm, k_cap: int):
  """One utterance's hierarchical p_percentile search on a copy of the
  ``autotune`` template. Returns the winner's (eigenvectors[:, :k_cap],
  eigengap count) on the affinity's device."""
  search = copy.copy(autotune)

  def batch_eval(ps):
    ratios, vs, ns = [], [], []
    for p in ps:
      _, v, n, delta = pipeline_lib.refine_and_eigendecompose(
          affinity, cfg, n_valid=n_valid, constraint_matrix=cm,
          p_percentile=torch.tensor(p, dtype=torch.float32,
                                    device=affinity.device))
      ratios.append(search.ratio_from_proxy(float(p), float(delta)))
      vs.append(v[:, :k_cap].contiguous())
      ns.append(n)
    return np.array(ratios), vs, ns

  v, n_gap, _ = search.tune_batched(batch_eval)
  return v, torch.tensor(n_gap, dtype=torch.int32, device=affinity.device)


def cluster_batch_autotuned(
    utterances: typing.Sequence[np.ndarray],
    cfg: pipeline_lib.PipelineConfig,
    autotune,
    mesh: typing.Optional[mesh_lib.Mesh] = None,
    seed: int = 0,
    constraint_matrices: typing.Optional[
        typing.Sequence[np.ndarray]] = None,
) -> typing.List[np.ndarray]:
  """Multi-level auto-tuned batch clustering.

  ``autotune`` is an ``autotune.AutoTune`` TEMPLATE: each utterance runs
  ``tune_batched`` on its own copy, with the reference's memoization and
  narrowing. A candidate p (on the card as float32, as in the JAX package)
  is ``prepare_affinity`` -> ``refine_and_eigendecompose(p)`` ->
  ``v[:, :k_cap]``; the winner goes to the masked K-Means seeded
  ``seed + i``. The JAX package pads each level's candidate rows to one
  XLA shape; eager PyTorch evaluates only each utterance's new candidates.
  cfg.autotune must be None (this driver IS the autotune loop);
  cfg.max_clusters is required.
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
  n_pad = pipeline_lib.pad_bucket(max(lengths))
  d = np.asarray(utterances[0]).shape[1]
  k_cap = max(cfg.max_clusters, cfg.min_clusters or 0)
  out = []
  devices = mesh_lib.batch_sharding(mesh, b)
  for i, (u, dev) in enumerate(zip(utterances, devices)):
    x = np.zeros((n_pad, d), dtype=np.float32)
    x[:lengths[i]] = u
    x = torch.from_numpy(x).to(dev)
    cm = None
    if constraint_matrices is not None:
      cm = torch.from_numpy(_padded_constraint(constraint_matrices[i],
                                               n_pad)).to(dev)
    with fp32_precision():
      affinity = pipeline_lib.prepare_affinity(x, cfg, lengths[i], cm)
      v, n_gap = _tune(affinity, cfg, autotune, lengths[i], cm, k_cap)
      del affinity
      labels, _ = pipeline_lib._cluster_from_eigs(
          v, n_gap, cfg, torch.Generator().manual_seed(seed + i), lengths[i],
          0.001)
    out.append(labels[:lengths[i]])
  return [labels.cpu().numpy() for labels in out]
