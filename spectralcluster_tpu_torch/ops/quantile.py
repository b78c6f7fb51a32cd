"""Row-wise quantiles with numpy-compatible linear interpolation.

Port of ``spectralcluster_tpu/ops/quantile.py``: replaces
``np.percentile(..., axis=1)`` (reference refinement.py:192-197) by one row
sort followed by a linearly interpolated gather. The sorted rows are
exposed separately so that many candidate percentiles can be read from one
sort. A (B, N, N) batch reads one quantile per matrix: q and ``n_valid``
are then scalars or (B,), and the result is (B, N).
"""

from __future__ import annotations

import torch

from spectralcluster_tpu_torch.utils import valid_mask


def sort_rows(mat: torch.Tensor) -> torch.Tensor:
  return torch.sort(mat, dim=-1).values


def _as_q(q, like: torch.Tensor) -> torch.Tensor:
  return torch.as_tensor(q, dtype=like.dtype, device=like.device)


def _interpolate_batched(sorted_rows, h, last):
  """One virtual index h per matrix of a (B, N, N) batch of sorted rows."""
  b = sorted_rows.shape[0]
  last = torch.as_tensor(last, dtype=torch.int64, device=sorted_rows.device)
  lo = torch.minimum(torch.clamp_min(torch.floor(h).to(torch.int64), 0), last)
  hi = torch.minimum(lo + 1, last)
  frac = torch.broadcast_to(h - lo.to(sorted_rows.dtype), (b,))

  def column(i):
    i = torch.broadcast_to(i, (b,))[:, None, None]
    return torch.take_along_dim(sorted_rows, i, dim=-1)[..., 0]

  s_lo, s_hi = column(lo), column(hi)
  return s_lo + frac[:, None] * (s_hi - s_lo)


def _interpolate(sorted_rows, q, h, last):
  if sorted_rows.dim() == 3:
    return _interpolate_batched(sorted_rows, h, last)
  lo = torch.clamp(torch.floor(h).to(torch.int64), 0, last)
  hi = torch.clamp(lo + 1, 0, last)
  frac = h - lo.to(sorted_rows.dtype)
  s_lo = sorted_rows[:, lo]
  s_hi = sorted_rows[:, hi]
  if q.dim() == 0:
    return s_lo + frac * (s_hi - s_lo)
  return (s_lo + frac[None, :] * (s_hi - s_lo)).T


def quantile_from_sorted(sorted_rows: torch.Tensor, q) -> torch.Tensor:
  """Linear-interpolated quantile q in [0,1] of each pre-sorted row.

  Matches np.percentile's default "linear" method: virtual index
  h = q*(n-1); result = s[floor(h)] + frac(h) * (s[ceil(h)] - s[floor(h)]).
  Returns shape (N,) for scalar q, or (Q, N) for a vector of qs.
  """
  n = sorted_rows.shape[-1]
  q = _as_q(q, sorted_rows)
  return _interpolate(sorted_rows, q, q * (n - 1), n - 1)


def row_quantile(mat: torch.Tensor, q) -> torch.Tensor:
  return quantile_from_sorted(sort_rows(mat), q)


def sort_rows_masked(mat: torch.Tensor, n_valid) -> torch.Tensor:
  """Sort rows of a padded matrix so the first n_valid entries per row are the
  sorted valid values (padding is pushed to +inf at the tail)."""
  n = mat.shape[-1]
  col_valid = valid_mask(n, n_valid, mat.device)
  shifted = torch.where(col_valid[..., None, :], mat, torch.inf)
  return torch.sort(shifted, dim=-1).values


def quantile_from_sorted_masked(sorted_rows: torch.Tensor, q,
                                n_valid) -> torch.Tensor:
  """Quantile over only the first ``n_valid`` (valid) entries of sorted rows.

  Same linear interpolation as above with a dynamic effective length, so a
  padded pipeline reproduces the unpadded percentile bit for bit.
  """
  q = _as_q(q, sorted_rows)
  n_valid = torch.as_tensor(n_valid, device=sorted_rows.device)
  h = q * (n_valid - 1).to(sorted_rows.dtype)
  return _interpolate(sorted_rows, q, h, n_valid - 1)
