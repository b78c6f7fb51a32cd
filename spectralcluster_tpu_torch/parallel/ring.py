"""Ring-exchange row-sharded affinity construction.

Port of ``spectralcluster_tpu/parallel/ring.py``. Each shard of a mesh
line holds a row block of the (N, d) embeddings and builds its (N/P, N)
affinity stripe by passing the normalized blocks around the ring: P−1
``ring_shift`` hops of the small (N/P, d) block, each hop one
``(x̂_r x̂_srcᵀ + 1)/2`` block product (``torch.matmul``, the plain product
the JAX package also computes outside any Pallas kernel), instead of an
all-gather of the (N, d) embeddings. The blocks are then placed in column
order. The hops run through ``parallel/collectives.py``, in one process or
between ``torch.distributed`` ranks.
"""

from __future__ import annotations

import typing

import torch

from spectralcluster_tpu_torch.parallel import collectives
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib
from spectralcluster_tpu_torch.precision import fp32_precision


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
  """Rows scaled to unit norm; the 1e-30 clamp keeps padded all-zero rows
  finite (their affinity is masked by the caller, but no NaN is ever
  made)."""
  norms = torch.linalg.norm(x, dim=1, keepdim=True)
  return x / torch.clamp_min(norms, 1e-30)


def ring_affinity_stripes(group, blocks: typing.List[torch.Tensor]
                          ) -> typing.List[torch.Tensor]:
  """This process's (N/P, N) affinity stripes from its (N/P, d) embedding
  blocks, by P−1 ring hops over ``group``."""
  p = group.size
  xn = [normalize_rows(b) for b in blocks]
  m = xn[0].shape[0]
  out = [x.new_zeros((m, p * m)) for x in xn]
  circ = list(xn)
  for hop in range(p):
    for i, x in enumerate(xn):
      # The block held at this hop came from shard (r - hop) mod P.
      src = (group.shards[i] - hop) % p
      out[i][:, src * m:(src + 1) * m] = (
          torch.matmul(x, circ[i].T) + 1.0) * 0.5
    if hop + 1 < p:
      circ = group.ring_shift(circ)
  return out


def make_ring_affinity_fn(mesh: mesh_lib.Mesh, axis_name: str = "model"):
  """fn(blocks) -> stripes over the first line of ``axis_name`` this
  process holds: ``blocks`` are its shards' (N/P, d) embedding rows, the
  result their (N/P, N) affinity stripes."""
  group = collectives.axis_groups(mesh, axis_name)[0]

  def fn(blocks):
    with fp32_precision():
      return ring_affinity_stripes(group, blocks)

  return fn


def ring_affinity(embeddings: torch.Tensor, mesh: mesh_lib.Mesh,
                  axis_name: str = "model") -> typing.List[torch.Tensor]:
  """Row-sharded cosine affinity by ring exchange.

  ``embeddings`` is the whole (N, d) array (every process passes the same
  one); N must split over the axis. Returns the affinity stripes this
  process holds, in shard order: all P in one process, this rank's one
  stripe under ``torch.distributed``.
  """
  group = collectives.axis_groups(mesh, axis_name)[0]
  n = embeddings.shape[0]
  if n % group.size:
    raise ValueError(f"{n} rows do not split over {group.size} shards")
  m = n // group.size
  blocks = [embeddings[s * m:(s + 1) * m].to(dev)
            for s, dev in zip(group.shards, group.devices)]
  return make_ring_affinity_fn(mesh, axis_name)(blocks)
