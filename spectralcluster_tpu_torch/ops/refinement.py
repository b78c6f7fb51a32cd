"""Affinity-refinement operations on tensors, masked, with kernel dispatch.

Port of ``spectralcluster_tpu/ops/refinement.py``. Each op maps (N,N) ->
(N,N) and takes an optional ``n_valid``, so a padded matrix reproduces the
unpadded semantics on its valid block (invariant: padded rows/cols are zero
on entry and re-zeroed on exit of every op). ``n_valid`` may be a Python int
or a 0-dim tensor. Every op also takes a (B, N, N) batch, the JAX package's
``vmap`` written out: ``n_valid`` is then None or a (B,) tensor, and a
``p_percentile`` a scalar or one value per matrix, (B,). Each matrix of a
batch gets the bits it gets alone, the product of Diffuse up to the
summation order of a batched matmul.

``apply_refinement_sequence(..., use_kernels=True)`` routes CropDiagonal,
the RowWiseThreshold+Symmetrize pair and RowWiseNormalize to the wrappers of
kernels/fused.py: the CUDA kernels for a tensor on the card, their plain
twins for a tensor on the CPU; a batch takes the batched wrappers, one
launch each. Diffuse stays ``torch.matmul`` (the JAX package left it
to XLA), a batched product for a batch.

``analyze_symmetry`` statically classifies the refined matrix so that a
symmetric eigensolver serves wherever the structure allows (see the JAX
module's docstring); GENERAL goes to the host general eig.
"""

from __future__ import annotations

import typing

import torch

from spectralcluster_tpu_torch.kernels import fused as fused_kernels
from spectralcluster_tpu_torch.ops import blur as blur_ops
from spectralcluster_tpu_torch.ops import quantile as quantile_ops
from spectralcluster_tpu_torch.types import (RefinementName, RefinementOptions,
                                             SymmetrizeType, ThresholdType)
from spectralcluster_tpu_torch.utils import per_matrix, valid_mask


def _eye(n: int, device) -> torch.Tensor:
  return torch.eye(n, dtype=torch.bool, device=device)


def mask_padding(mat: torch.Tensor, n_valid=None) -> torch.Tensor:
  """Zero out rows/cols beyond n_valid (no-op when n_valid is None)."""
  if n_valid is None:
    return mat
  v = valid_mask(mat.shape[-1], n_valid, mat.device)
  return torch.where(v[..., :, None] & v[..., None, :], mat, 0.0)


# The kernel wrappers for one matrix or a batch.
def _row_max_kernel(mat, exclude_diagonal=False, n_valid=None):
  if mat.dim() == 3:
    return fused_kernels.row_max_batched(mat, exclude_diagonal, n_valid)
  return fused_kernels.row_max(mat, exclude_diagonal, n_valid)


def _crop_diagonal_kernel(mat, n_valid, inplace):
  if mat.dim() == 3:
    return fused_kernels.crop_diagonal_batched(mat, n_valid, inplace)
  return fused_kernels.crop_diagonal(mat, n_valid, inplace)


def _threshold_symmetrize_kernel(mat, thr, *flags, average):
  if mat.dim() == 3:
    return fused_kernels.threshold_symmetrize_general_batched(
        mat, thr, *flags, average=average)
  return fused_kernels.threshold_symmetrize_general(mat, thr, *flags,
                                                    average=average)


def _row_wise_normalize_kernel(mat, n_valid):
  if mat.dim() == 3:
    return fused_kernels.row_wise_normalize_batched(mat, n_valid)
  return fused_kernels.row_wise_normalize(mat, n_valid)


def crop_diagonal(mat: torch.Tensor, n_valid=None) -> torch.Tensor:
  """Replace each diagonal element by the max off-diagonal value of its row.

  Reference refinement.py:136-151: the diagonal is zero-filled and counted
  in the max, so the result is >= 0 even for all-negative rows.
  """
  n = mat.shape[-1]
  eye = _eye(n, mat.device)
  off = torch.where(eye, 0.0, mat)
  if n_valid is not None:
    v = valid_mask(n, n_valid, mat.device)
    off = torch.where(v[..., None, :], off, -torch.inf)
  row_max = torch.amax(off, dim=-1)
  out = torch.where(eye, row_max[..., :, None], mat)
  return mask_padding(out, n_valid)


def gaussian_blur(mat: torch.Tensor, sigma: float,
                  n_valid=None) -> torch.Tensor:
  """scipy-compatible truncated Gaussian blur (reference refinement.py:154-162)."""
  if n_valid is None:
    return blur_ops.gaussian_blur(mat, sigma)
  return mask_padding(blur_ops.gaussian_blur_masked(mat, sigma, n_valid),
                      n_valid)


def _row_thresholds(a: torch.Tensor, p_percentile,
                    thresholding_type: ThresholdType, n_valid) -> torch.Tensor:
  """(N, 1) per-row thresholds of ``a`` for Percentile ((B, N, 1) for a
  batch)."""
  if thresholding_type == ThresholdType.Percentile:
    if n_valid is None:
      return quantile_ops.quantile_from_sorted(
          quantile_ops.sort_rows(a), p_percentile)[..., None]
    return quantile_ops.quantile_from_sorted_masked(
        quantile_ops.sort_rows_masked(a, n_valid), p_percentile,
        n_valid)[..., None]
  raise ValueError("Unsupported thresholding_type")


def row_wise_threshold(mat: torch.Tensor,
                       p_percentile,
                       soft_multiplier: float = 0.01,
                       thresholding_type: ThresholdType = ThresholdType.RowMax,
                       with_binarization: bool = False,
                       preserve_diagonal: bool = False,
                       n_valid=None) -> torch.Tensor:
  """Row-wise (soft) thresholding. Reference refinement.py:165-210."""
  n = mat.shape[-1]
  eye = _eye(n, mat.device)
  a = torch.where(eye, 0.0, mat) if preserve_diagonal else mat
  if thresholding_type == ThresholdType.RowMax:
    if n_valid is None:
      row_max = torch.amax(a, dim=-1)
    else:
      v = valid_mask(n, n_valid, mat.device)
      row_max = torch.amax(torch.where(v[..., None, :], a, -torch.inf),
                           dim=-1)
    threshold = row_max[..., :, None] * per_matrix(p_percentile, mat.dim())
  else:
    threshold = _row_thresholds(a, p_percentile, thresholding_type, n_valid)
  is_smaller = a < threshold
  if with_binarization:
    out = torch.where(is_smaller, a * soft_multiplier, 1.0)
  else:
    out = torch.where(is_smaller, a * soft_multiplier, a)
  if preserve_diagonal:
    out = torch.where(eye, 1.0, out)
  return mask_padding(out, n_valid)


def symmetrize(mat: torch.Tensor,
               symmetrize_type: SymmetrizeType = SymmetrizeType.Max,
               n_valid=None) -> torch.Tensor:
  """Reference refinement.py:213-226."""
  if symmetrize_type == SymmetrizeType.Max:
    return torch.maximum(mat, mat.transpose(-1, -2))
  elif symmetrize_type == SymmetrizeType.Average:
    return 0.5 * (mat + mat.transpose(-1, -2))
  raise ValueError("Unsupported symmetrize_type.")


def diffuse(mat: torch.Tensor, n_valid=None) -> torch.Tensor:
  """A @ A^T (reference refinement.py:229-234). Padded rows/cols stay zero."""
  return torch.matmul(mat, mat.transpose(-1, -2))


def row_wise_normalize(mat: torch.Tensor, n_valid=None) -> torch.Tensor:
  """Divide each row by its max (reference refinement.py:237-245)."""
  d = row_max_scale(mat, n_valid)
  out = mat / d[..., :, None]
  return mask_padding(out, n_valid)


def row_max_scale(mat: torch.Tensor, n_valid=None,
                  use_kernels: bool = False) -> torch.Tensor:
  """Row maxima used by RowWiseNormalize; padded rows get scale 1.

  With ``use_kernels`` the reduction is the row_max kernel (its twin on the
  CPU), which gives the same maxima on valid rows.
  """
  n = mat.shape[-1]
  if use_kernels:
    row_max = _row_max_kernel(mat, n_valid=n_valid)[..., 0]
  elif n_valid is None:
    return torch.amax(mat, dim=-1)
  else:
    v = valid_mask(n, n_valid, mat.device)
    row_max = torch.amax(torch.where(v[..., None, :], mat, -torch.inf),
                         dim=-1)
  if n_valid is None:
    return row_max
  return torch.where(valid_mask(n, n_valid, mat.device), row_max, 1.0)


def apply_refinement_op(mat: torch.Tensor,
                        name: RefinementName,
                        options: RefinementOptions,
                        p_percentile=None,
                        n_valid=None) -> torch.Tensor:
  """Apply one named refinement op (reference refinement.py:102-133 factory)."""
  if name == RefinementName.CropDiagonal:
    return crop_diagonal(mat, n_valid)
  elif name == RefinementName.GaussianBlur:
    return gaussian_blur(mat, options.gaussian_blur_sigma, n_valid)
  elif name == RefinementName.RowWiseThreshold:
    p = options.p_percentile if p_percentile is None else p_percentile
    return row_wise_threshold(
        mat, p, options.thresholding_soft_multiplier,
        options.thresholding_type, options.thresholding_with_binarization,
        options.thresholding_preserve_diagonal, n_valid)
  elif name == RefinementName.Symmetrize:
    return symmetrize(mat, options.symmetrize_type, n_valid)
  elif name == RefinementName.Diffuse:
    return diffuse(mat, n_valid)
  elif name == RefinementName.RowWiseNormalize:
    return row_wise_normalize(mat, n_valid)
  raise ValueError(f"Unknown refinement operation: {name}")


def apply_refinement_sequence(
    mat: torch.Tensor,
    options: RefinementOptions,
    sequence: typing.Optional[typing.Sequence[RefinementName]] = None,
    p_percentile=None,
    n_valid=None,
    use_kernels: bool = False,
    consume_input: bool = False) -> torch.Tensor:
  """Apply a full refinement sequence.

  With ``use_kernels``, CropDiagonal, a RowWiseThreshold directly followed
  by Symmetrize (both threshold types, both symmetrize types, binarization,
  preserve_diagonal) and RowWiseNormalize go through kernels/fused.py, as
  the JAX package's Pallas dispatch does. ``consume_input`` lets a leading
  CropDiagonal overwrite ``mat`` in place on the card; pass it only when the
  caller never reads ``mat`` again.

  Only the GENERAL-structure path applies RowWiseNormalize here: the
  symmetric pipelines absorb a trailing one into the eigh similarity
  transform (pipeline._symmetric_eig_operand). GENERAL is what
  EigenSolver.HostGeneral forces, and what ``analyze_symmetry`` gives for a
  sequence that leaves the matrix asymmetric before its last step (e.g. a
  RowWiseThreshold not followed by Symmetrize). An asymmetric user affinity
  with the icassp2018 sequence is ROWNORM_TAIL, not GENERAL: its Symmetrize
  and Diffuse restore symmetry before the RowWiseNormalize.
  """
  seq = tuple(options.refinement_sequence if sequence is None else sequence)
  if not seq:
    return mat
  i = 0
  while i < len(seq):
    name = seq[i]
    if (use_kernels and name == RefinementName.RowWiseThreshold
        and i + 1 < len(seq) and seq[i + 1] == RefinementName.Symmetrize):
      p = options.p_percentile if p_percentile is None else p_percentile
      preserve = options.thresholding_preserve_diagonal
      if options.thresholding_type == ThresholdType.RowMax:
        thr = _row_max_kernel(mat, exclude_diagonal=preserve,
                              n_valid=n_valid) * per_matrix(p, mat.dim())
      else:
        a = torch.where(_eye(mat.shape[-1], mat.device), 0.0,
                        mat) if preserve else mat
        thr = _row_thresholds(a, p, options.thresholding_type,
                              n_valid).contiguous()
      mat = _threshold_symmetrize_kernel(
          mat, thr, options.thresholding_soft_multiplier,
          options.thresholding_with_binarization, preserve,
          average=(options.symmetrize_type == SymmetrizeType.Average))
      mat = mask_padding(mat, n_valid)
      i += 2
      continue
    if use_kernels and name == RefinementName.CropDiagonal:
      mat = mask_padding(_crop_diagonal_kernel(
          mat, n_valid, inplace=(consume_input and i == 0)), n_valid)
      i += 1
      continue
    if use_kernels and name == RefinementName.RowWiseNormalize:
      mat = mask_padding(_row_wise_normalize_kernel(mat, n_valid), n_valid)
      i += 1
      continue
    mat = apply_refinement_op(mat, name, options, p_percentile, n_valid)
    i += 1
  return mat


# ---------------------------------------------------------------------------
# Static structure analysis for the eigensolver choice.
# ---------------------------------------------------------------------------

SYMMETRIC = "symmetric"          # final matrix is symmetric -> plain eigh
ROWNORM_TAIL = "rownorm_tail"    # A = D_r^{-1} S, S symmetric -> eigh + diag similarity
GENERAL = "general"              # no exploitable structure -> general eig


def analyze_symmetry(
    sequence: typing.Optional[typing.Sequence[RefinementName]],
    input_symmetric: bool = True) -> str:
  """Statically classify the symmetry structure of a refinement output.

  Symmetry propagation rules (for a symmetric input):
    CropDiagonal, GaussianBlur: preserve symmetry.
    Symmetrize, Diffuse: always produce a symmetric matrix.
    RowWiseThreshold, RowWiseNormalize: break symmetry.
  """
  sym = input_symmetric
  if not sequence:
    return SYMMETRIC if sym else GENERAL
  sym_before = sym
  for name in sequence:
    sym_before = sym
    if name in (RefinementName.CropDiagonal, RefinementName.GaussianBlur):
      pass
    elif name in (RefinementName.Symmetrize, RefinementName.Diffuse):
      sym = True
    else:  # RowWiseThreshold, RowWiseNormalize
      sym = False
  if sym:
    return SYMMETRIC
  if sequence[-1] == RefinementName.RowWiseNormalize and sym_before:
    return ROWNORM_TAIL
  return GENERAL


def split_at_threshold(
    sequence: typing.Sequence[RefinementName]
) -> typing.Tuple[typing.Tuple[RefinementName, ...],
                  typing.Tuple[RefinementName, ...]]:
  """Split a sequence into (prefix before RowWiseThreshold, suffix from it).

  Only RowWiseThreshold and what follows depend on p_percentile, so a sweep
  over candidates computes the prefix once.
  """
  seq = tuple(sequence)
  for i, name in enumerate(seq):
    if name == RefinementName.RowWiseThreshold:
      return seq[:i], seq[i:]
  return seq, ()
