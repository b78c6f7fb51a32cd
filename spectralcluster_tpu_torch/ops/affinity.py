"""Affinity matrix construction and the pairwise distances the main path uses.

Port of ``spectralcluster_tpu/ops/affinity.py:20-52`` and ``:129-149``:
cosine affinity, and the cosine and squared-euclidean cdist kernels that
K-Means reads (k-means++ seeds with sqeuclidean, the icassp2018 Lloyd runs
cosine). The other metrics of the JAX registry are ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import typing

import torch

_ITEM_7 = "ROADMAP queue 1 item 7 (host API: the other cdist metrics)"


def compute_affinity_matrix(embeddings: torch.Tensor) -> torch.Tensor:
  """Cosine affinity in [0, 1]: ((x·y)/(|x||y|) + 1) / 2.

  Matches reference utils.py:20-41. Input (N, d) -> output (N, N).
  """
  norms = torch.linalg.norm(embeddings, dim=1, keepdim=True)
  normalized = embeddings / norms
  cosine = torch.matmul(normalized, normalized.T)
  return (cosine + 1.0) / 2.0


def cdist_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  xn = torch.linalg.norm(x, dim=1, keepdim=True)
  yn = torch.linalg.norm(y, dim=1, keepdim=True)
  return 1.0 - torch.matmul(x, y.T) / (xn * yn.T)


def cdist_sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  x2 = torch.sum(x * x, dim=1, keepdim=True)
  y2 = torch.sum(y * y, dim=1, keepdim=True)
  d2 = x2 + y2.T - 2.0 * torch.matmul(x, y.T)
  return torch.clamp_min(d2, 0.0)


_DISTANCE_REGISTRY = {
    "cosine": cdist_cosine,
    "sqeuclidean": cdist_sqeuclidean,
}


def get_distance_fn(
    custom_dist: typing.Union[str, typing.Callable],
) -> typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
  """Resolve a metric name to a batched (N,d),(K,d)->(N,K) function."""
  if isinstance(custom_dist, str):
    key = custom_dist.lower()
    if key in _DISTANCE_REGISTRY:
      return _DISTANCE_REGISTRY[key]
    raise NotImplementedError(
        f"distance {custom_dist!r} is not ported yet ({_ITEM_7}); the port "
        f"has {tuple(sorted(_DISTANCE_REGISTRY))}")
  if callable(custom_dist):
    raise NotImplementedError(f"callable custom_dist is not ported yet "
                              f"({_ITEM_7})")
  raise TypeError("custom_dist must be a string or callable")
