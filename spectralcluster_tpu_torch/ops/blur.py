"""Separable 2-D Gaussian blur with scipy-compatible semantics.

Port of ``spectralcluster_tpu/ops/blur.py``. The truncated 1-D Gaussian is
applied as a sum of (2r+1) shifted, weighted rows of a reflect-padded
matrix, once along rows and once along columns, in the same order as the
JAX version. Numerics match scipy ``gaussian_filter`` defaults:
  - truncate = 4.0, radius r = int(truncate * sigma + 0.5)
  - kernel w[k] ∝ exp(-k² / (2σ²)), normalized to sum 1
  - boundary mode "reflect" = (d c b a | a b c d), numpy's "symmetric"
    (torch's own "reflect" padding is numpy's "reflect", which differs, so
    the padding here is an index gather).
Plain torch: the JAX package never had a Pallas kernel for it. A (B, N, N)
batch takes a (B,) ``n_valid``: each matrix reflects about its own bound,
and the rows and columns are gathered per matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spectralcluster_tpu_torch.utils import valid_mask


@functools.lru_cache(maxsize=32)
def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> tuple:
  radius = int(truncate * float(sigma) + 0.5)
  x = np.arange(-radius, radius + 1, dtype=np.float64)
  w = np.exp(-0.5 * (x / float(sigma)) ** 2)
  # Python floats holding the float32 weights: tensor * float multiplies in
  # float32 by exactly these values, as jnp does with the float32 array.
  return tuple(float(v) for v in (w / w.sum()).astype(np.float32))


def _reflect(i: torch.Tensor, n_valid) -> torch.Tensor:
  """Reflect indices into [0, n_valid) — numpy "symmetric" — periodic with
  period 2*n_valid, so any radius works against any n_valid (an int, a
  0-dim tensor, or (B, 1) for a batch: then (B, N) indices)."""
  m = torch.remainder(i, 2 * n_valid)
  return torch.where(m >= n_valid, 2 * n_valid - 1 - m, m)


def _take(mat: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
  """``mat`` indexed by ``idx`` along ``dim`` (-2: rows, -1: columns): one
  index vector for every matrix, or (B, N) indices, one row per matrix of
  a batch."""
  if idx.dim() == 1:
    return mat.index_select(dim, idx)
  idx = idx[..., :, None] if dim == -2 else idx[..., None, :]
  return torch.take_along_dim(mat, idx, dim=dim)


def _blur_rows_then_cols(mat: torch.Tensor, w: tuple, n_valid) -> torch.Tensor:
  r = (len(w) - 1) // 2
  n = mat.shape[-1]
  idx = torch.arange(n, device=mat.device)
  if isinstance(n_valid, torch.Tensor) and n_valid.dim() > 0:
    n_valid = n_valid[:, None]
  src = [_reflect(idx + (k - r), n_valid) for k in range(len(w))]
  out = torch.zeros_like(mat)
  for k, wk in enumerate(w):
    out = out + wk * _take(mat, src[k], -2)
  out2 = torch.zeros_like(mat)
  for k, wk in enumerate(w):
    out2 = out2 + wk * _take(out, src[k], -1)
  return out2


def gaussian_blur(mat: torch.Tensor, sigma: float,
                  truncate: float = 4.0) -> torch.Tensor:
  """2-D Gaussian blur of a square matrix (scipy gaussian_filter parity)."""
  if sigma <= 0:
    return mat
  return _blur_rows_then_cols(mat, _gaussian_kernel(sigma, truncate),
                              mat.shape[-1])


def gaussian_blur_masked(mat: torch.Tensor, sigma: float, n_valid,
                         truncate: float = 4.0) -> torch.Tensor:
  """Blur only the top-left (n_valid, n_valid) block of a padded matrix.

  Reflect padding is emulated at the dynamic boundary by mirroring indices
  about ``n_valid``, so a padded run reproduces an unpadded one on the
  valid block; entries outside it are returned unchanged.
  """
  if sigma <= 0:
    return mat
  out = _blur_rows_then_cols(mat, _gaussian_kernel(sigma, truncate), n_valid)
  valid = valid_mask(mat.shape[-1], n_valid, mat.device)
  keep = valid[..., :, None] & valid[..., None, :]
  return torch.where(keep, out, mat)
