"""Affinity matrix construction and pairwise distance kernels.

Port of ``spectralcluster_tpu/ops/affinity.py``: cosine affinity, and the
scipy ``cdist`` metrics that K-Means reads (reference
custom_distance_kmeans.py:123-125). Each distance maps (N, d), (K, d) ->
(N, K) on the inputs' device, and all but mahalanobis map a batch (B, N, d),
(B, K, d) -> (B, N, K) too (``get_batched_distance_fn``).
"""

from __future__ import annotations

import typing

import torch


def _t(y: torch.Tensor) -> torch.Tensor:
  return y.transpose(-1, -2)


def compute_affinity_matrix(embeddings: torch.Tensor) -> torch.Tensor:
  """Cosine affinity in [0, 1]: ((x·y)/(|x||y|) + 1) / 2.

  Matches reference utils.py:20-41. Input (N, d) -> output (N, N), or
  (B, N, d) -> (B, N, N).
  """
  norms = torch.linalg.norm(embeddings, dim=-1, keepdim=True)
  normalized = embeddings / norms
  cosine = torch.matmul(normalized, _t(normalized))
  return (cosine + 1.0) / 2.0


def cdist_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  xn = torch.linalg.norm(x, dim=-1, keepdim=True)
  yn = torch.linalg.norm(y, dim=-1, keepdim=True)
  return 1.0 - torch.matmul(x, _t(y)) / (xn * _t(yn))


def cdist_sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  x2 = torch.sum(x * x, dim=-1, keepdim=True)
  y2 = torch.sum(y * y, dim=-1, keepdim=True)
  d2 = x2 + _t(y2) - 2.0 * torch.matmul(x, _t(y))
  return torch.clamp_min(d2, 0.0)


def cdist_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  return torch.sqrt(cdist_sqeuclidean(x, y))


def _abs_diff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  return torch.abs(x[..., :, None, :] - y[..., None, :, :])


def cdist_cityblock(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  return torch.sum(_abs_diff(x, y), dim=-1)


def cdist_chebyshev(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  return torch.amax(_abs_diff(x, y), dim=-1)


def cdist_correlation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  return cdist_cosine(x - torch.mean(x, dim=-1, keepdim=True),
                      y - torch.mean(y, dim=-1, keepdim=True))


def cdist_braycurtis(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  diff = torch.sum(_abs_diff(x, y), dim=-1)
  summ = torch.sum(torch.abs(x[..., :, None, :] + y[..., None, :, :]),
                   dim=-1)
  return diff / summ


def cdist_canberra(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  num = _abs_diff(x, y)
  den = torch.abs(x)[..., :, None, :] + torch.abs(y)[..., None, :, :]
  # scipy convention: terms with 0/0 contribute 0.
  terms = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
  return torch.sum(terms, dim=-1)


def cdist_mahalanobis(x: torch.Tensor, y: torch.Tensor,
                      vi: typing.Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
  """Mahalanobis distance.

  With ``vi`` (inverse covariance) None this follows scipy's cdist default:
  VI = inv(cov(vstack([XA, XB]).T)) (custom_distance_kmeans.py:123-125
  relies on it), so every row of both inputs moves VI.
  """
  if vi is None:
    cov = torch.atleast_2d(torch.cov(torch.cat([x, y], dim=0).T))
    vi = torch.linalg.inv(cov)
  diff = x[:, None, :] - y[None, :, :]           # (N, K, d)
  m = torch.einsum("nkd,de,nke->nk", diff, vi, diff)
  return torch.sqrt(torch.clamp_min(m, 0.0))


def cdist_minkowski(x: torch.Tensor, y: torch.Tensor,
                    p: float = 2.0) -> torch.Tensor:
  return torch.sum(_abs_diff(x, y) ** p, dim=-1) ** (1.0 / p)


_DISTANCE_REGISTRY = {
    "cosine": cdist_cosine,
    "euclidean": cdist_euclidean,
    "sqeuclidean": cdist_sqeuclidean,
    "cityblock": cdist_cityblock,
    "manhattan": cdist_cityblock,
    "chebyshev": cdist_chebyshev,
    "correlation": cdist_correlation,
    "braycurtis": cdist_braycurtis,
    "canberra": cdist_canberra,
    "mahalanobis": cdist_mahalanobis,
    "minkowski": cdist_minkowski,
}


def supported_distances() -> typing.Tuple[str, ...]:
  return tuple(sorted(_DISTANCE_REGISTRY))


def get_distance_fn(
    custom_dist: typing.Union[str, typing.Callable],
) -> typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
  """Resolve a distance spec to a batched (N,d),(K,d)->(N,K) function.

  Accepts the metric names of scipy.spatial.distance used by the reference
  (custom_distance_kmeans.py:13-16) or a callable ``f(u, v) -> tensor``
  over single vectors, which ``torch.vmap`` maps over all pairs.
  """
  if callable(custom_dist):
    return torch.vmap(torch.vmap(custom_dist, in_dims=(None, 0)),
                      in_dims=(0, None))
  if isinstance(custom_dist, str):
    key = custom_dist.lower()
    if key in _DISTANCE_REGISTRY:
      return _DISTANCE_REGISTRY[key]
    raise ValueError(
        f"Unsupported distance {custom_dist!r}; supported: "
        f"{supported_distances()} or a callable f(u, v) -> float.")
  raise TypeError("custom_dist must be a string or callable")


def get_batched_distance_fn(
    custom_dist: typing.Union[str, typing.Callable],
) -> typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
  """``get_distance_fn`` over a batch: (B, N, d), (B, K, d) -> (B, N, K).

  The named metrics broadcast over the batch axis. Mahalanobis estimates
  its covariance from each utterance's own rows, and a callable sees
  single vectors: both run utterance by utterance.
  """
  fn = get_distance_fn(custom_dist)
  if callable(custom_dist) or custom_dist.lower() == "mahalanobis":
    return lambda x, y: torch.stack([fn(xi, yi) for xi, yi in zip(x, y)])
  return fn
