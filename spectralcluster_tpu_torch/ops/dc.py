"""Exact top-k symmetric eigenpairs past ``dc_max_block``.

Port of the contract of ``spectralcluster_tpu/ops/dc.py``: ``eigh_topk_dc``
returns the t extreme eigenpairs of a symmetric matrix in scan order, a
residual certificate and the operand's norm estimate, which the caller's
snap and NormalizedDiff read in place of the full spectrum's max|w|.

Routes, in the JAX order:

  * n <= ``max_block``: full eigh (the dense branch), residual 0;
  * the certified-iterative route: a residual-gated subspace iteration on
    the positivized operand (``_subspace``), then the completeness probe
    (``_probe_next``: the t pairs deflated far past the scan end, a block
    power iteration for the largest remaining eigenvalue, and a power
    iteration for the norm estimate). It is accepted only when the absolute
    residual is within ``_ITER_ACCEPT_RES`` of the shift, the residual
    relative to the norm estimate within ``_ITER_ACCEPT_RES``, and no
    eigenvalue was missed beyond ``_MISS_MARGIN`` of that estimate;
  * when it declines (or with ``try_iterative_first=False``): one full
    ``torch.linalg.eigh`` of the operand, certified by its residual against
    the operand relative to the valid spectrum's max|w|.

The JAX package declines to a spectral divide-and-conquer (a matrix-sign
chain, range capture and Rayleigh–Ritz as several small programs) because
one XLA eigh at N=10240 needed 17.7 GB against a 16 GB TPU and its compile
helper ran out of memory. On an 80 GB card one float32 (N, N) is 1.68 GB at
N=20480, so the port takes the exact solve that fits the card; ROADMAP.md
lists the sign chain as later work, to port only if a size measured on the
card needs it.

Randomness comes from one ``torch.Generator`` (the pipeline seeds it with
17, as JAX uses ``PRNGKey(17)``). Two generators are derived from it, one
for the solve and one for the probe, as ``jax.random.split`` does. Start
panels are drawn on the CPU and moved to the matrix's device, so a card run
and a CPU run start from the same panels.
"""

from __future__ import annotations

import math
import typing

import torch

from spectralcluster_tpu_torch.ops import eigen as eigen_ops

# Residual level that indicates the solver actually failed (vs ordinary
# float32 noise, which sits around 1e-6..1e-5 relative).
_FAIL_RESIDUAL = 1e-2

# Residual acceptance of the iterative route: 1000x tighter than
# _FAIL_RESIDUAL, so the route delivers dense-eigensolver-class pairs or
# steps aside.
_ITER_ACCEPT_RES = 1e-5

# How far (relative to the operand's scale) the probe's estimate of the
# largest remaining eigenvalue may pass the t-th returned value before the
# route declines; inside the margin the two tie for the eigengap scan.
_MISS_MARGIN = 1e-3

# The subspace solve (JAX _subspace_jit) and the probe (JAX _probe_next_jit).
_SUBSPACE_ITERS = 32
_SUBSPACE_RESIDUAL_TOL = 1e-6
_SUBSPACE_MAX_ITERS = 2048
_PROBES = 8
_PROBE_STEPS = 14
_NORM_STEPS = 12


def _masked(m: torch.Tensor, n_valid):
  """(m with the padded rows and columns zeroed, the valid-row mask)."""
  n = m.shape[0]
  valid = torch.arange(n, device=m.device) < (n if n_valid is None
                                               else n_valid)
  if n_valid is None:
    return m, valid
  return torch.where(valid[:, None] & valid[None, :], m, 0.0), valid


def _shifted(mm: torch.Tensor, valid: torch.Tensor, b, descend: bool):
  """mm + b·I_valid (descending) or b·I_valid − mm (ascending): the scan's
  extreme end made dominant, padded coordinates exact zero modes."""
  op = mm.clone() if descend else -mm
  op.diagonal().add_(b * valid.to(mm.dtype))
  return op


def _unit_columns(q: torch.Tensor) -> torch.Tensor:
  return q / torch.clamp_min(torch.linalg.norm(q, dim=0, keepdim=True), 1e-30)


def _split(generator: torch.Generator) -> typing.Tuple[torch.Generator, ...]:
  """Two independent generators drawn from one (jax.random.split)."""
  seeds = torch.randint(0, 2**62, (2,), generator=generator)
  return tuple(torch.Generator().manual_seed(int(s)) for s in seeds)


def _subspace(m, t, generator, descend, n_valid, norm_bound=math.inf,
              stats=None):
  """Residual-gated subspace iteration on the shift-positivized operand.

  The shift b is the valid block's Gershgorin bound, capped by
  ``norm_bound``, + 1. Returns (w (t,), v (n, t), res_abs, b) with
  res_abs = max_j ‖m v_j − w_j v_j‖ over the valid block.
  """
  mm, valid = _masked(m, n_valid)
  b = torch.clamp_max(torch.amax(torch.sum(torch.abs(mm), dim=1)),
                      norm_bound) + 1.0
  op = _shifted(mm, valid, b, descend)
  w_s, v = eigen_ops.topk_eigh_subspace(
      op, t, generator, num_iters=_SUBSPACE_ITERS, largest=True,
      residual_tol=_SUBSPACE_RESIDUAL_TOL, max_iters=_SUBSPACE_MAX_ITERS,
      stats=stats)
  del op
  w = (w_s - b) if descend else (b - w_s)
  rt = torch.matmul(mm, v) - v * w[None, :]
  res_abs = torch.amax(torch.linalg.norm(rt, dim=0))
  return w, v, float(res_abs), float(b)


def _probe_next(m, v, w, n_valid, bnorm: float, generator, descend):
  """The most extreme eigenvalue remaining after deflating the t pairs
  (the completeness certificate), and a power-iteration ‖m‖₂ estimate.

  Rank-t deflation moves the found pairs to c_far = ∓2·bnorm, past the
  scan end; 8 probes × 14 power steps on the positivized deflated operator
  converge toward the largest remaining (shifted) eigenvalue from below.
  Then 12 power steps on the undeflated operand give ``norm_lo``, which
  converges to the largest |eigenvalue| from below. Returns
  (est_next, norm_lo) as floats.
  """
  n = m.shape[0]
  mm, valid = _masked(m, n_valid)
  c_far = -2.0 * bnorm if descend else 2.0 * bnorm
  md = mm - torch.matmul(v * (w - c_far)[None, :], v.T)
  op = _shifted(md, valid, bnorm, descend)
  del md
  g = eigen_ops.start_panel(n, _PROBES, generator, m.dtype, m.device)
  g = _unit_columns(torch.where(valid[:, None], g, 0.0))
  for _ in range(_PROBE_STEPS):
    g = _unit_columns(torch.matmul(op, g))
  rayleigh = torch.amax(torch.sum(g * torch.matmul(op, g), dim=0))
  del op
  est_next = (rayleigh - bnorm) if descend else (bnorm - rayleigh)
  pv = eigen_ops.start_panel(n, 1, generator, m.dtype, m.device)
  pv = _unit_columns(torch.where(valid[:, None], pv, 0.0))
  for _ in range(_NORM_STEPS):
    pv = _unit_columns(torch.matmul(mm, pv))
  norm_lo = torch.linalg.norm(torch.matmul(mm, pv))
  return float(est_next), float(norm_lo)


def _certified_iterative_topt(m, t, generator, descend, n_valid, info=None):
  """Certified subspace solve + completeness probe. Returns (w, v, res,
  scale) like eigh_topk_dc, or None to decline."""
  gen_solve, gen_probe = _split(generator)
  stats = {}
  w, v, res_abs, b = _subspace(m, t, gen_solve, descend, n_valid,
                               stats=stats)
  if info is not None:
    info.update(iters=stats["iters"], res_abs=res_abs, shift=b)
  if not math.isfinite(res_abs) or res_abs > _ITER_ACCEPT_RES * b:
    return None
  est_next, norm_lo = _probe_next(m, v, w, n_valid, b, gen_probe, descend)
  w_t = float(w[t - 1])
  scale = max(min(1.05 * norm_lo, b), 1e-30)
  res = res_abs / scale
  missed = (est_next > w_t + _MISS_MARGIN * scale if descend
            else est_next < w_t - _MISS_MARGIN * scale)
  if info is not None:
    info.update(est_next=est_next, w_t=w_t, norm_lo=norm_lo, res=res,
                scale=scale, missed=missed)
  if res > _ITER_ACCEPT_RES or missed:
    return None
  return w, v, res, scale


def _full_eigh_topt(m, t, descend, n_valid):
  """The exact solve: full eigh (padding sentinels sort past the scan
  end), the t extreme pairs, and their certified residual against m
  relative to the valid spectrum's max|w|."""
  w_all, u_all = eigen_ops.sorted_eigh(m, descend=descend)
  nv = m.shape[0] if n_valid is None else int(n_valid)
  # The valid eigenvalues are the first n_valid in scan order.
  scale = max(float(torch.amax(torch.abs(w_all[:nv]))), 1e-30)
  w, u = w_all[:t].clone(), u_all[:, :t].clone()
  del w_all, u_all
  rt = torch.matmul(m, u) - u * w[None, :]
  res = float(torch.amax(torch.linalg.norm(rt, dim=0))) / scale
  _check_residual(res)
  return w, u, res, scale


def eigh_topk_dc(
    m: torch.Tensor,
    t: int,
    generator: torch.Generator,
    descend: bool = True,
    n_valid: typing.Optional[int] = None,
    max_block: int = 8192,
    sign_precision: typing.Optional[str] = None,
    try_iterative_first: typing.Optional[bool] = None,
    info: typing.Optional[dict] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor, float, float]:
  """The t extreme eigenpairs of a symmetric m, certified.

  Returns (w (t,), u (n, t), res, scale) in scan order (descending for
  ``descend=True``): ``res`` is the worst residual ‖m u_j − w_j u_j‖ over
  ``scale``, and ``scale`` the operand's norm estimate, which callers use
  for the full-spectrum snap and NormalizedDiff. With ``n_valid``, m must
  already carry the padding sentinels (eigen_ops.apply_padding_sentinels).
  ``try_iterative_first=False`` skips the certified-iterative route.
  ``sign_precision`` is the JAX sign chain's matmul precision; the port
  has no sign chain and reads it nowhere. An ``info`` dict receives the
  route taken ("dense", "certified" or "full_eigh") and the certified
  route's diagnostics (iterations, residuals, est_next, w_t, norm_lo).
  Raises RuntimeError when the exact solve's residual exceeds
  ``_FAIL_RESIDUAL``.
  """
  del sign_precision
  n = m.shape[0]
  t = min(t, n if n_valid is None else int(n_valid))
  info = {} if info is None else info
  if n <= max_block:
    w, u = eigen_ops.sorted_eigh(m, descend=descend)
    w, u = w[:t], u[:, :t]
    info["route"] = "dense"
    return w, u, 0.0, float(torch.amax(torch.abs(w)))
  if try_iterative_first is not False:
    out = _certified_iterative_topt(m, t, generator, descend, n_valid, info)
    if out is not None:
      info["route"] = "certified"
      return out
  info["route"] = "full_eigh"
  return _full_eigh_topt(m, t, descend, n_valid)


def _check_residual(res: float) -> None:
  if not math.isfinite(res) or res > _FAIL_RESIDUAL:
    raise RuntimeError(
        f"eigh_topk_dc: certified eigenpair residual {res:.2e} exceeds "
        f"{_FAIL_RESIDUAL:.0e}: the eigensolver failed numerically. Use "
        "EigenSolver.SubspaceIteration.")
