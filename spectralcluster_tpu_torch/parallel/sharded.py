"""Row-sharded clustering of one recording too large for one device.

Port of ``spectralcluster_tpu/parallel/sharded.py``. The N×N affinity and
every matrix derived from it live only as row stripes over one ``model``
line of the mesh: shard r holds rows [r·N/P, (r+1)·N/P) (N padded to a
multiple of P and carried as ``n_valid``); no shard ever holds an (N, N)
tensor. Where the JAX package lets GSPMD insert the collectives, the port
calls them itself (``collectives.py``): the same SPMD code runs P shards
in one process (``make_mesh(devices=...)``) or one shard per
``torch.distributed`` rank (``initialize_distributed``, then
``make_mesh()``).

  1. affinity: each shard normalizes its (N/P, d) rows and either
     all-gathers the normalized (N, d) embeddings or, with
     ``use_ring_affinity``, passes its block around the ring
     (``ring.py``); then the padding mask;
  2. refinement → symmetric eigen operand (+ eigenvector scale), sentinels
     applied: ``stripes.symmetric_eig_operand``, element for element the
     single-device ``pipeline._symmetric_eig_operand`` (bit for bit up to
     Diffuse);
  3. the max_clusters+1 extreme eigenpairs by the row-sharded masked
     subspace iteration (``eigen.topk_eigh_subspace_sharded``), with
     ``num_iters``, ``oversample``, ``cfg.subspace_residual_tol`` and
     ``cfg.subspace_max_iters``; for an ascending NormalizedDiff scan a
     12-step power iteration appends λ_max, as in JAX;
  4. the snap against the valid block's Gershgorin bound (as the port's
     single-device subspace route snaps), the eigengap count, the spectral
     embeddings on the stripes, then one all-gather of the (N, max_clusters)
     embedding and K-Means on every process from the JAX key's draws, so
     every shard holds the same labels.

Differences from the JAX function, by design: the solver is the masked one
(the JAX sharded step calls the unmasked solver on the sentinel operand),
the snap takes the Gershgorin ``wmax`` (JAX snaps against the top-k's own
max), and the block products (Diffuse, the Grams, the ring hops) sum in
another order. No hand-written kernel runs here, as none runs in the JAX
sharded step (``use_pallas=False`` there).
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from spectralcluster_tpu_torch import pipeline as pipeline_lib
from spectralcluster_tpu_torch import prng
from spectralcluster_tpu_torch.ops import eigen as eigen_ops
from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops
from spectralcluster_tpu_torch.ops import refinement as refinement_ops
from spectralcluster_tpu_torch.parallel import collectives
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
from spectralcluster_tpu_torch.parallel import ring as ring_lib
from spectralcluster_tpu_torch.parallel import stripes as stripes_lib
from spectralcluster_tpu_torch.precision import fp32_precision
from spectralcluster_tpu_torch.types import EigenGapType


def _power_iterate_lambda_max(layout: stripes_lib.Layout, mats,
                              generator: torch.Generator,
                              iters: int = 12) -> torch.Tensor:
  """Largest-eigenvalue estimate of the row-sharded ``mats`` by power
  iteration (JAX sharded.py:49-68). The start vector is zero on the padded
  coordinates, and the sentinel-padded matrix is block diagonal, so the
  estimate is the valid block's λ_max. Replicated, 0-dim."""
  group, m = layout.group, layout.m
  v = torch.randn((layout.n,), generator=generator, dtype=mats[0].dtype)
  if layout.n_valid is not None:
    v = torch.where(torch.arange(layout.n) < layout.n_valid, v, 0.0)
  vs = [v[layout.offset(i):layout.offset(i) + m].to(x.device)
        for i, x in enumerate(mats)]

  def normalize(vs):
    norm = torch.sqrt(group.all_reduce([torch.dot(u, u) for u in vs]))
    return [u / torch.clamp_min(norm.to(u.device), 1e-30) for u in vs]

  def matvec(vs):
    full = group.all_gather(vs)
    return [torch.matmul(x, full.to(x.device)) for x in mats]

  vs = normalize(vs)
  for _ in range(iters):
    vs = normalize(matvec(vs))
  return group.all_reduce([torch.dot(u, y) for u, y in zip(vs, matvec(vs))])


def make_sharded_cluster_fn(cfg: pipeline_lib.PipelineConfig,
                            mesh: mesh_lib.Mesh, num_iters: int = 24,
                            oversample: int = 8,
                            use_ring_affinity: bool = False):
  """Build a row-sharded large-N clustering step over ``mesh``'s ``model``
  line.

  Returns fn(embeddings (N, d), seed=0, n_valid=None, timings=None,
  info=None) -> (labels (N,), n_clusters), tensors on this process's first
  shard device. ``embeddings`` is the whole array (every process passes
  the same one), N a multiple of the line's size; pass ``n_valid`` when
  its rows past it are padding (their labels are 0). ``timings`` (an
  observability.StageTimings) records the stages "affinity", "refinement",
  "subspace" and "kmeans"; ``info`` (a dict) receives the Ritz
  eigenvalues, the subspace iterations and final residual, N and P.
  Requires cfg.max_clusters and a symmetric / rownorm-tail refinement
  structure, as the JAX function does.
  """
  if cfg.max_clusters is None:
    raise ValueError("sharded path requires max_clusters")
  pipeline_lib._check_supported(cfg)
  k = cfg.max_clusters + 1
  descend = pipeline_lib._descend(cfg)
  structure = refinement_ops.analyze_symmetry(
      cfg.refinement_options.refinement_sequence, cfg.affinity_symmetric)
  if structure == refinement_ops.GENERAL or (
      not descend and structure != refinement_ops.SYMMETRIC):
    raise ValueError(
        "sharded path requires a symmetric / rownorm-tail refinement "
        "structure (no general eigensolver exists on device)")
  group = collectives.model_group(mesh)

  def step(embeddings: torch.Tensor, seed: int = 0, n_valid=None,
           timings=None, info: typing.Optional[dict] = None):
    n_pad = embeddings.shape[0]
    layout = stripes_lib.Layout(group, n_pad, n_valid)
    ranges = mesh_lib.row_sharding(mesh, n_pad)
    # One generator: the subspace start panel, then λ_max's start vector.
    generator = torch.Generator().manual_seed(seed)
    # The JAX step's key split: (eig, lmax, km); K-Means draws from km
    # over the N padded rows.
    km_key = prng.split(prng.key(seed), 3)[2]
    with fp32_precision():
      with pipeline_lib._stage(timings, "affinity"):
        blocks = [embeddings[ranges[s]].to(dev)
                  for s, dev in zip(group.shards, group.devices)]
        if use_ring_affinity:
          aff = ring_lib.ring_affinity_stripes(group, blocks)
        else:
          xn = [ring_lib.normalize_rows(b) for b in blocks]
          full = group.all_gather(xn)
          aff = [(torch.matmul(x, full.to(x.device).T) + 1.0) / 2.0
                 for x in xn]
          del full
        del blocks
        aff = stripes_lib.mask_padding(layout, aff)
      with pipeline_lib._stage(timings, "refinement"):
        mat, scale = stripes_lib.symmetric_eig_operand(layout, aff, cfg,
                                                       structure, descend)
        del aff
        wmax = stripes_lib.valid_gershgorin(layout, mat)
      with pipeline_lib._stage(timings, "subspace"):
        stats = {}
        w, u = eigen_ops.topk_eigh_subspace_sharded(
            group, mat, k, generator, largest=descend, n_valid=n_valid,
            num_iters=num_iters, oversample=oversample,
            residual_tol=cfg.subspace_residual_tol,
            max_iters=cfg.subspace_max_iters, stats=stats)
        lam_max = None
        if not descend and cfg.eigengap_type == EigenGapType.NormalizedDiff:
          # The bottom-k iteration does not produce the largest eigenvalue
          # that ascending NormalizedDiff normalizes by (reference
          # utils.py:109-110): append an estimate for the scan's max (the
          # scan range excludes the last slot).
          lam_max = _power_iterate_lambda_max(layout, mat, generator)
        del mat
      with pipeline_lib._stage(timings, "kmeans"):
        vs = stripes_lib.recover_similarity_eigenvectors(layout, u, scale)
        w_snap = eigen_ops.snap_small_eigenvalues(
            w, tol=cfg.eigenvalue_snap_tol, wmax=wmax)
        scan = w_snap if lam_max is None else torch.cat(
            [w_snap, lam_max.to(w_snap.device)[None]])
        n_clusters, _ = eigen_ops.compute_number_of_clusters(
            scan, max_clusters=cfg.max_clusters,
            stop_eigenvalue=cfg.stop_eigenvalue,
            eigengap_type=cfg.eigengap_type, descend=descend)
        if cfg.min_clusters is not None:
          n_clusters = torch.clamp_min(n_clusters, cfg.min_clusters)
        emb = []
        for i, v in enumerate(vs):
          e = pipeline_lib.spectral_embeddings_from_eigs(
              v, n_clusters.to(v.device), cfg.max_clusters,
              cfg.row_wise_renorm)
          if n_valid is not None:
            e = torch.where(layout.valid_rows(i, v.device)[:, None], e, 0.0)
          emb.append(e)
        emb = group.all_gather(emb)
        valid = torch.arange(n_pad, device=emb.device) < (
            n_pad if n_valid is None else n_valid)
        labels = kmeans_ops.kmeans_fit(
            emb, n_clusters, None, custom_dist=cfg.custom_dist,
            max_iter=cfg.max_iter, k_max=cfg.max_clusters,
            sample_weight=valid.to(emb.dtype), draw_rows=n_pad, key=km_key)
        labels = torch.where(valid, labels, 0)
    if info is not None:
      info.update(eigenvalues=w.cpu().numpy(), n_pad=n_pad,
                  shards=group.size, **stats)
    return labels, n_clusters

  return step


def cluster_large_sharded(
    embeddings: np.ndarray,
    cfg: pipeline_lib.PipelineConfig,
    mesh: typing.Optional[mesh_lib.Mesh] = None,
    seed: int = 0,
    num_iters: int = 24,
    use_ring_affinity: bool = False,
    timings=None,
    info: typing.Optional[dict] = None,
) -> typing.Tuple[np.ndarray, int]:
  """Cluster one large recording with the N×N work split over the mesh's
  ``model`` line.

  ``mesh`` defaults to every device on the ``model`` axis (the ranks of an
  initialized world, else every card). N that does not divide the line is
  padded up and masked through the pipeline (``n_valid``), as every other
  entry point does. ``seed`` plays the JAX ``PRNGKey(seed)``'s part: the
  K-Means draws are the JAX step's for that key. ``timings`` and ``info``
  go to the step (``make_sharded_cluster_fn``). Returns (labels (N,)
  numpy, n_clusters).
  """
  if mesh is None:
    mesh = mesh_lib.make_mesh(dp=1, mp=None)
  mp = mesh.shape["model"]
  x = torch.as_tensor(np.asarray(embeddings, np.float32))
  n = x.shape[0]
  n_pad = -(-n // mp) * mp
  fn = make_sharded_cluster_fn(cfg, mesh, num_iters=num_iters,
                               use_ring_affinity=use_ring_affinity)
  if n_pad != n:
    x = torch.cat([x, x.new_zeros((n_pad - n, x.shape[1]))])
  labels, n_clusters = fn(x, seed, n if n_pad != n else None, timings, info)
  return labels.cpu().numpy()[:n], int(n_clusters)
