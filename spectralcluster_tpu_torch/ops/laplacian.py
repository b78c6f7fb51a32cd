"""Graph Laplacian variants, with symmetric-similarity forms for eigh.

Port of ``spectralcluster_tpu/ops/laplacian.py`` (reference laplacian.py:
24-60), with the reference's eps placement inside the two normalizations.

``laplacian_similarity`` returns, for each variant, a symmetric matrix with
the same spectrum plus the diagonal scaling that recovers the variant's own
eigenvectors, so the pipeline runs a symmetric eigensolver throughout:

  RandomWalk:  L_rw = D̃^{-1} L  with D̃ = diag(d + eps)
               = D̃^{-1/2} (D̃^{-1/2} L D̃^{-1/2}) D̃^{1/2}
               → eigh(D̃^{-1/2} L D̃^{-1/2}); eigvecs v = D̃^{-1/2} u. Exact.

Each function also takes a (B, N, N) batch with a (B,) ``n_valid``.
"""

from __future__ import annotations

import typing

import torch

from spectralcluster_tpu_torch.types import EPS, LaplacianType
from spectralcluster_tpu_torch.utils import valid_mask


def _degree(affinity: torch.Tensor, n_valid=None) -> torch.Tensor:
  """Row sums over the columns < n_valid (a (B,) n_valid for a batch)."""
  if n_valid is None:
    return torch.sum(affinity, dim=-1)
  v = valid_mask(affinity.shape[-1], n_valid, affinity.device)
  return torch.sum(torch.where(v[..., None, :], affinity, 0.0), dim=-1)


def _unnormalized(affinity: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
  return torch.diag_embed(d) - affinity


def compute_laplacian(affinity: torch.Tensor,
                      laplacian_type: LaplacianType = LaplacianType.GraphCut,
                      eps: float = EPS,
                      n_valid=None) -> torch.Tensor:
  """The reference semantics (laplacian.py:24-60)."""
  if not isinstance(laplacian_type, LaplacianType):
    raise TypeError("laplacian_type must be a LaplacianType")
  if laplacian_type == LaplacianType.Affinity:
    return affinity
  d = _degree(affinity, n_valid)
  lap = _unnormalized(affinity, d)
  if laplacian_type == LaplacianType.Unnormalized:
    return lap
  elif laplacian_type == LaplacianType.RandomWalk:
    scale = 1.0 / (d + eps)
    return scale[..., :, None] * lap
  elif laplacian_type == LaplacianType.GraphCut:
    scale = 1.0 / (torch.sqrt(d) + eps)
    return scale[..., :, None] * lap * scale[..., None, :]
  raise ValueError("Unsupported laplacian_type.")


def laplacian_similarity(
    affinity: torch.Tensor,
    laplacian_type: LaplacianType,
    eps: float = EPS,
    n_valid=None,
) -> typing.Tuple[torch.Tensor, typing.Optional[torch.Tensor]]:
  """Return (symmetric matrix M, eigvec scale s) for the requested variant.

  The variant's matrix has the same eigenvalues as M, and eigenvectors
  v = s[:, None] * u (u = eigenvectors of M); s None means v = u.
  Requires a symmetric ``affinity``.
  """
  if laplacian_type == LaplacianType.Affinity:
    return affinity, None
  d = _degree(affinity, n_valid)
  lap = _unnormalized(affinity, d)
  if laplacian_type == LaplacianType.Unnormalized:
    return lap, None
  elif laplacian_type == LaplacianType.GraphCut:
    scale = 1.0 / (torch.sqrt(d) + eps)
    return scale[..., :, None] * lap * scale[..., None, :], None
  elif laplacian_type == LaplacianType.RandomWalk:
    # Exact similarity including the reference's eps: D̃ = d + eps.
    inv_sqrt = 1.0 / torch.sqrt(d + eps)
    return inv_sqrt[..., :, None] * lap * inv_sqrt[..., None, :], inv_sqrt
  raise ValueError("Unsupported laplacian_type.")
