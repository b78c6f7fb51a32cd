"""Constrained clustering operations (Turn-to-Diarize).

Port of ``spectralcluster_tpu/constraint.py`` (reference constraint.py):

  * ``affinity_integration`` (constraint.py:95-117): elementwise max/average.
  * ``constraint_propagation``, E2CP (constraint.py:120-164): the closed form
    F* = (1-α)² (I - α·Ā)⁻¹ Q (I - α·Ā)⁻¹ by two fixed-point (truncated
    Neumann) solves made of (N, N) products, as the JAX package computes
    it; α ≥ 0.95 takes the dense LU solve (``torch.linalg.solve``) there.
    The JAX package chose the fixed point to avoid a TPU compile wall; the
    port keeps it because parity with that package is the gate. The loop
    is a Python loop that reads one stop flag on the host per step.
  * ``ConstraintMatrix`` from speaker-turn scores (constraint.py:167-201),
    built on the host as a tri-diagonal ±1 numpy matrix.

Every product runs under ``precision.fp32_precision()`` (TF32 off).
``adjust_affinity`` also takes a (B, N, N) batch of affinities and
constraints with a (B,) ``n_valid``, for the batched step: batched
products, and the same fixed point, which freezes each matrix at its own
stop, as the JAX package's vmap of its while_loop does.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from spectralcluster_tpu_torch.precision import fp32_precision
from spectralcluster_tpu_torch.types import (EPS, ConstraintName,
                                             ConstraintOptions,
                                             IntegrationType)
from spectralcluster_tpu_torch.utils import valid_mask

# Relative fixed-point tolerance of the E2CP solves (the JAX package's).
_NEUMANN_TOL = 1e-6

# At and above this α the fixed point has no geometric-convergence margin:
# the dense LU solve runs instead, as in the JAX package.
_NEUMANN_ALPHA_MAX = 0.95


def affinity_integration(affinity: torch.Tensor,
                         constraint_matrix: torch.Tensor,
                         integration_type: IntegrationType) -> torch.Tensor:
  if integration_type == IntegrationType.Max:
    return torch.maximum(affinity, constraint_matrix)
  elif integration_type == IntegrationType.Average:
    return 0.5 * (affinity + constraint_matrix)
  raise ValueError(f"Unsupported integration type: {integration_type}")


def _neumann_cap(alpha: float, tol: float = _NEUMANN_TOL) -> int:
  """Step cap: the analytic J with α^{J+1}/(1−α) ≤ tol, doubled as margin,
  clamped to [8, 512] (32 at α=0.4)."""
  if alpha <= 0.0:
    return 1
  j = math.ceil((math.log(tol) + math.log(1.0 - alpha)) / math.log(alpha))
  return int(max(8, min(2 * j, 512)))


def _fixed_point_solve(q: torch.Tensor, mul: typing.Callable, alpha: float,
                       max_steps: int):
  """Solve (I − α·Op) X = Q by the fixed-point iteration X ← Q + α·Op(X).

  The step X_{k+1} − X_k is minus the linear-system residual of X_k, so
  the gate costs no extra product. Each matrix steps until its rel_res ≤
  1e-6 or ``max_steps``. Over a batch of matrices (any leading shape) it
  runs as the JAX package's vmap of its while_loop: every step computes
  the whole batch, and a matrix that has met its own stop rule keeps its
  X, residual and step count from then on. One host read per step, of
  whether any matrix still steps. Returns (X, rel_res, steps), rel_res
  and steps tensors shaped like the batch (0-dim for one matrix).
  """
  batch = q.shape[:-2]
  qn = torch.clamp_min(torch.linalg.vector_norm(q, dim=(-2, -1)), EPS)
  x = q
  res = torch.full(batch, torch.inf, dtype=q.dtype, device=q.device)
  steps = torch.zeros(batch, dtype=torch.int64, device=q.device)
  live = torch.ones(batch, dtype=torch.bool, device=q.device)
  while max_steps > 0:
    x_next = q + alpha * mul(x)
    step_res = torch.linalg.vector_norm(x_next - x, dim=(-2, -1)) / qn
    x = torch.where(live[..., None, None], x_next, x)
    res = torch.where(live, step_res, res)
    steps = steps + live.to(steps.dtype)
    live = live & (res > _NEUMANN_TOL) & (steps < max_steps)
    if not bool(live.any()):
      break
  return x, res, steps


def propagate(affinity: torch.Tensor,
              constraint_matrix: torch.Tensor,
              alpha: float = 0.6,
              n_valid=None):
  """E2CP's propagated constraints F* = (1−α)² (I−αĀ)⁻¹ Q (I−αĀ)⁻¹.

  Ā = D^{-1/2} A D^{-1/2} with the reference's 1/(sqrt(d)+eps). Returns
  (F*, rel_res, steps): the worse relative residual of the two solves (a
  0-dim tensor, 0 on the LU route) and the steps of each solve (two 0-dim
  tensors; (0, 0) on the LU route). A (B, N, N) batch with a (B,)
  ``n_valid`` solves each matrix as alone (the products batched); rel_res
  and the steps are then (B,) tensors.
  """
  n = affinity.shape[-1]
  batch = affinity.shape[:-2]
  if n_valid is None:
    d = torch.sum(affinity, dim=-1)
  else:
    v = valid_mask(n, n_valid, affinity.device)
    d = torch.sum(torch.where(v[..., None, :], affinity, 0.0), dim=-1)
  inv_sqrt = 1.0 / (torch.sqrt(d) + EPS)
  a_norm = inv_sqrt[..., :, None] * affinity * inv_sqrt[..., None, :]
  if n_valid is not None:
    # Padded coordinates: Ā = 0 there, so I − αĀ acts as the identity.
    a_norm = torch.where(v[..., :, None] & v[..., None, :], a_norm, 0.0)
  alpha = float(alpha)
  with fp32_precision():
    if alpha >= _NEUMANN_ALPHA_MAX:
      m = torch.eye(n, dtype=affinity.dtype, device=affinity.device) - (
          alpha * a_norm)
      b = torch.linalg.solve(m, constraint_matrix)
      f = (1.0 - alpha) ** 2 * torch.linalg.solve(
          m.transpose(-1, -2), b.transpose(-1, -2)).transpose(-1, -2)
      return f, torch.zeros(batch, dtype=affinity.dtype,
                            device=affinity.device), (0, 0)
    cap = _neumann_cap(alpha)
    b, res_l, steps_l = _fixed_point_solve(
        constraint_matrix, lambda x: torch.matmul(a_norm, x), alpha, cap)
    c, res_r, steps_r = _fixed_point_solve(
        b, lambda x: torch.matmul(x, a_norm), alpha, cap)
  return (1.0 - alpha) ** 2 * c, torch.maximum(res_l, res_r), (steps_l,
                                                               steps_r)


def constraint_propagation(affinity: torch.Tensor,
                           constraint_matrix: torch.Tensor,
                           alpha: float = 0.6,
                           n_valid=None,
                           with_residual: bool = False):
  """E2CP constraint propagation (Lu & Ip, ECCV 2010).

  Matches reference constraint.py:137-164: propagate F* (``propagate``),
  then adjust: F*>0: 1−(1−F*)(1−A);  F*≤0: (1+F*)·A. With
  ``with_residual=True`` also returns the worse relative linear-system
  residual of the two solves (a 0-dim tensor; ~1e-6 on success, 0 on the
  LU route).
  """
  f, res, _ = propagate(affinity, constraint_matrix, alpha, n_valid)
  is_positive = f > 0
  affinity1 = 1.0 - (1.0 - f * is_positive) * (1.0 - affinity * is_positive)
  affinity2 = (1.0 + f * (~is_positive)) * (affinity * (~is_positive))
  out = affinity1 + affinity2
  if with_residual:
    return out, res
  return out


def adjust_affinity(affinity: torch.Tensor,
                    constraint_matrix: torch.Tensor,
                    options: ConstraintOptions,
                    n_valid=None) -> torch.Tensor:
  """Dispatch on the constraint method (reference constraint.py:44-49),
  with the reference's shape checks (constraint.py:52-76)."""
  if affinity.dim() not in (2, 3) or affinity.shape[-1] != affinity.shape[-2]:
    raise ValueError("affinity must be a 2-D square matrix")
  if (constraint_matrix.dim() != affinity.dim()
      or constraint_matrix.shape[-1] != constraint_matrix.shape[-2]):
    raise ValueError("constraint matrix must be a 2-D square matrix")
  if affinity.shape != constraint_matrix.shape:
    raise ValueError(
        "affinity and constraint matrix must have the same shape")
  if options.constraint_name == ConstraintName.AffinityIntegration:
    out = affinity_integration(affinity, constraint_matrix,
                               options.integration_type)
  elif options.constraint_name == ConstraintName.ConstraintPropagation:
    out = constraint_propagation(affinity, constraint_matrix,
                                 options.constraint_propagation_alpha, n_valid)
  else:
    raise ValueError(f"Unsupported constraint: {options.constraint_name}")
  if n_valid is not None:
    v = valid_mask(affinity.shape[-1], n_valid, affinity.device)
    out = torch.where(v[..., :, None] & v[..., None, :], out, 0.0)
  return out


class ConstraintMatrix:
  """Build a pairwise constraint matrix from speaker-turn scores.

  Reference constraint.py:167-201: score 0 ⇒ must-link (+1) between
  neighboring turns; score > threshold ⇒ cannot-link (−1); otherwise no
  constraint. The first score is unused.
  """

  def __init__(self,
               speaker_turn_scores: typing.Sequence[float],
               threshold: float = 1):
    if any(score < 0 for score in speaker_turn_scores):
      raise ValueError("Speaker turn score must be larger or equal to 0.")
    self.speaker_turn_scores = list(speaker_turn_scores)
    self.threshold = threshold

  def compute_diagonals(self) -> np.ndarray:
    num_turns = len(self.speaker_turn_scores)
    scores = np.asarray(self.speaker_turn_scores[1:], dtype=np.float64)
    off = np.zeros(max(num_turns - 1, 0))
    off[scores == 0] = 1.0
    off[scores > self.threshold] = -1.0
    constraint_matrix = np.zeros((num_turns, num_turns))
    if num_turns > 1:
      idx = np.arange(num_turns - 1)
      constraint_matrix[idx, idx + 1] = off
      constraint_matrix[idx + 1, idx] = off
    return constraint_matrix
