"""Exact top-k symmetric eigenpairs past ``dc_max_block``.

Port of ``spectralcluster_tpu/ops/dc.py``: ``eigh_topk_dc`` returns the t
extreme eigenpairs of a symmetric matrix in scan order, a residual
certificate and the operand's norm estimate, which the caller's snap and
NormalizedDiff read in place of the full spectrum's max|w|.

Routes, in the JAX order (dc.py:703-939):

  * n <= ``max_block``: full eigh (the dense branch), residual 0;
  * the certified-iterative route: a residual-gated subspace iteration on
    the positivized operand (``_subspace``), then the completeness probe
    (``_probe_next``: the t pairs deflated far past the scan end, a block
    power iteration for the largest remaining eigenvalue, and a power
    iteration for the norm estimate). It is accepted only when the absolute
    residual is within ``_ITER_ACCEPT_RES`` of the shift, the residual
    relative to the norm estimate within ``_ITER_ACCEPT_RES``, and no
    eigenvalue was missed beyond ``_MISS_MARGIN`` of that estimate;
  * when it declines (or with ``try_iterative_first=False``): the spectral
    divide-and-conquer, route "split" (Nakatsukasa & Higham's polar-based
    splitting, as JAX runs it):
      1. sign: U = sign(A − σI), σ the mean eigenvalue, by an accelerated
         Newton–Schulz chain of matrix products (``matrix_sign``: up to 8
         quintic steps of 3 products, then up to 5 cubic steps of 2), its
         products at ``sign_precision`` (``precision.matmul``: "highest"
         IEEE float32, "high" 3×TF32, "default" one TF32 product);
      2. the projector P = (I ± U)/2 onto the kept side, its rank estimate
         trace(P) and boundary mass;
      3. range capture: subspace iteration on P from a random panel, thin
         QR (or shifted CholeskyQR2 for wide panels), one redraw when the
         capture comes up short;
      4. Rayleigh–Ritz on the captured block, recursing on blocks past
         ``max_block``, every lifted pair re-verified against this level's
         operand.
    When the kept side holds fewer than t pairs, the rest come from the
    spectral complement: a second projection below ``_PROJECT_SPLIT_K``,
    deflation of the solved pairs and a certified subspace solve above it.
    A zero block, a split that does not reduce, an empty capture or a
    degraded solve go to the certified subspace fallback, as in JAX.
    With ``split_on_decline=False`` a decline returns None instead, for
    the staged executor (``pipeline._dc_topk``), which then solves by
    Lanczos (``lanczos_topt``) or the full eigh. On a descending scan it
    asks ``lanczos_topt`` first and this route only where Lanczos cannot
    vouch for its pairs.

Differences from the JAX module, by design:

  * The sign chain is one eager loop that reads the update norm on the host
    after every step (microseconds against a step of ≥ 0.04 s at N=10240).
    It keeps the minimum-step rule of the schedule JAX takes for its own
    operand size: one quintic step before the first test up to
    ``_SIGN_SPLIT_N``, three above it (JAX's host-staged steps). At the top
    level that size is the caller's ``pad_bucket(N)`` (``_n_bucket``), as
    JAX is handed the bucket-padded operand; in a recursion it is k_pad.
  * ``_solve_tri_chunked`` (a TPU memory workaround) is one
    ``torch.linalg.solve_triangular``: its columns are independent.
  * ``torch.linalg.cholesky_ex`` reports a breakdown in ``info`` where
    ``jnp.linalg.cholesky`` returns a factor of NaN; ``_cholesky`` returns
    that NaN factor, so the CholeskyQR2 zeroes the same columns.
  * No per-shape program cache: every block program is a plain function.
  * The complement's rank estimate is read from P's diagonal; JAX forms the
    (N, N) complement projector first, and the port forms it only when it
    projects onto it.

Randomness comes from one ``torch.Generator`` (the pipeline seeds it with
17, as JAX uses ``PRNGKey(17)``). Generators derived from it stand for
JAX's split keys: two for the certified route (solve, probe), four per
split level (basis, complement, recursion, second recursion), two per range
capture (the draw and its redraw, ``fold_in(key, 1)``). The power-iteration
start of the sign stage is seeded 3 (JAX's ``PRNGKey(3)``). Panels are
drawn on the CPU and moved to the matrix's device, so a card run and a CPU
run take the same branches.

An ``info`` dict receives the route ("dense", "certified", "split" or
"declined"), the certified route's diagnostics and, for the split, one
record per level under "levels": depth, n, k_f, b_f, sigma, alpha, norm2,
the sign steps taken, the branch ("kept_covers_t", "complement_block",
"deflated_remainder", "zero_block", "subspace_fallback" with a "reason"),
k_pad, k_eff, redraws, residuals, the iterations of a subspace solve
(fallback or deflated remainder) and host seconds per stage.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import typing

import torch

from spectralcluster_tpu_torch import precision as precision_lib
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.ops import eigen as eigen_ops
from spectralcluster_tpu_torch.precision import fp32_precision

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

# Try the certified-iterative route before splitting, at the top level
# (JAX dc.py:1098).
_TRY_ITERATIVE_FIRST = True

# The staged executor's Lanczos (``lanczos_topt``): its step caps, at each of which
# it reads its residual, and the worst relative residual at which it stops.
_LANCZOS_CAPS = (160, 320, 640, 1280)
_LANCZOS_TOL = 1e-6

# The subspace solve (JAX _subspace_jit) and the probe (JAX _probe_next_jit).
_SUBSPACE_ITERS = 32
_SUBSPACE_RESIDUAL_TOL = 1e-6
_SUBSPACE_MAX_ITERS = 2048
_PROBES = 8
_PROBE_STEPS = 14
_NORM_STEPS = 12

# The split's constants, JAX dc.py:85-155 and :418-456.
# Relative distance from the split point below which an eigenvalue's side
# is ambiguous; the sign schedule is validated down to it.
_SIGN_L0 = 1e-4
# Relative Ritz residual above which a pair is a spurious oversampling
# artifact (genuine float32 pairs sit at 1e-6..5e-4, spurious ones at 0.1+).
_SPURIOUS_TOL = 3e-3
# Extra complement pairs, so the merge keeps t after the overlap dedup.
_MERGE_EXTRA = 4
# |v1 . v2| above which two unit Ritz vectors are one eigendirection.
_DEDUP_OVERLAP = 0.9
# Overshoot-bounded quintic coefficients, then cubic Newton–Schulz: 8 + 5
# steps take every |eigenvalue| in [_SIGN_L0, 1] to within 4e-12 of 1.
_QUINTIC = (3.4445, -4.7750, 2.0315)
_SIGN_QUINTIC_STEPS = 8
_SIGN_NS_STEPS = 5
# A phase of the chain stops once ||x_next - x||_F <= _SIGN_EXIT_TOL·√n.
_SIGN_EXIT_TOL = 1e-4
# Filtered subspace-iteration steps of the range capture.
_PROJECT_ITERS = 6
# Widest basis the split projects onto; above it the deflated remainder
# replaces the complement block and a kept side this wide goes to the
# subspace fallback. JAX chose 8192 for its remote compile helper's memory;
# the port keeps the number because it decides the branch.
_PROJECT_SPLIT_K = 8192
# Panels at most this wide orthonormalize by thin QR, wider ones by shifted
# CholeskyQR2.
_QR_PANEL_MAX = 512
# Above this operand size JAX runs the sign chain as host-staged steps,
# which take three quintic steps before the first exit test.
_SIGN_SPLIT_N = 12288


def _sign_precision() -> str:
  """The sign chain's default precision: JAX's "high", or the
  SCT_DC_SIGN_PRECISION override (JAX dc.py:122-141)."""
  return os.environ.get("SCT_DC_SIGN_PRECISION", "high")


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


def _split(generator: torch.Generator,
           count: int = 2) -> typing.Tuple[torch.Generator, ...]:
  """``count`` independent generators drawn from one (jax.random.split)."""
  seeds = torch.randint(0, 2**62, (count,), generator=generator)
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
  rt = fused.panel_matmul(mm, v) - v * w[None, :]
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
    g = _unit_columns(fused.panel_matmul(op, g))
  rayleigh = torch.amax(torch.sum(g * fused.panel_matmul(op, g), dim=0))
  del op
  est_next = (rayleigh - bnorm) if descend else (bnorm - rayleigh)
  pv = eigen_ops.start_panel(n, 1, generator, m.dtype, m.device)
  pv = _unit_columns(torch.where(valid[:, None], pv, 0.0))
  for _ in range(_NORM_STEPS):
    pv = _unit_columns(fused.panel_matmul(mm, pv))
  norm_lo = torch.linalg.norm(fused.panel_matmul(mm, pv))
  return float(est_next), float(norm_lo)


def _certified_iterative_topt(m, t, generator, descend, n_valid, info=None):
  """Certified subspace solve + completeness probe. Returns (w, v, res,
  scale) like eigh_topk_dc, or None to decline. ``info`` receives the
  iterations, res_abs, the shift and the solver's residual after each
  chunk ("res_trace", relative to the shifted operand's scale)."""
  gen_solve, gen_probe = _split(generator)
  stats = {}
  w, v, res_abs, b = _subspace(m, t, gen_solve, descend, n_valid,
                               stats=stats)
  if info is not None:
    info.update(iters=stats["iters"], res_abs=res_abs, shift=b,
                res_trace=stats["res"])
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


def _subspace_fallback(m, t, generator, descend, n_valid, scale=None,
                       norm_bound=None, check=True, stats=None):
  """Certified subspace-iteration solve of the whole block (JAX
  dc.py:1207-1227). ``check=False`` returns the raw residual instead of
  raising, for the deflated remainder, which re-certifies its pairs
  against the original operand itself. ``stats`` receives the iterations
  under "iters"."""
  w, v, res_abs, b = _subspace(
      m, t, generator, descend, n_valid,
      norm_bound=math.inf if norm_bound is None else norm_bound, stats=stats)
  scale = scale if scale is not None else max(b, 1e-30)
  res = res_abs / scale
  if check:
    _check_residual(res)
  return w, v, res, scale


# ---------------------------------------------------------------------------
# The sign chain (JAX dc.py:157-235, :248-415).
# ---------------------------------------------------------------------------


def quintic_step(x: torch.Tensor,
                 precision: typing.Optional[str] = None) -> torch.Tensor:
  """One overshoot-bounded quintic sign step: x <- x (aI + b x² + c x⁴),
  symmetrized."""
  a, b, c = _QUINTIC
  precision = precision or _sign_precision()
  x2 = precision_lib.matmul(x, x, precision)
  x4 = precision_lib.matmul(x2, x2, precision)
  poly = x2.mul_(b)
  poly.diagonal().add_(a)
  poly.add_(x4.mul_(c))
  del x2, x4
  y = precision_lib.matmul(x, poly, precision)
  del poly
  return 0.5 * (y + y.T)


def ns_step(x: torch.Tensor,
            precision: typing.Optional[str] = None) -> torch.Tensor:
  """One cubic Newton–Schulz polish step: x <- 1.5 x − 0.5 x³,
  symmetrized."""
  precision = precision or _sign_precision()
  x2 = precision_lib.matmul(x, x, precision)
  y = precision_lib.matmul(x, x2, precision)
  del x2
  y = 1.5 * x - y.mul_(0.5)
  return 0.5 * (y + y.T)


def _sign_chain(x: torch.Tensor, precision: str, min_quintic: int,
                n_tol: int, steps: typing.Optional[list] = None):
  """The quintic phase, then the cubic one, each stopping once its update
  norm is at most _SIGN_EXIT_TOL·√n_tol, the quintic phase not before
  ``min_quintic`` steps and the cubic one not before its first. ``steps``
  receives ("quintic" or "cubic", host seconds) per step."""
  tol = _SIGN_EXIT_TOL * math.sqrt(n_tol)
  for name, step, max_steps, min_steps in (
      ("quintic", quintic_step, _SIGN_QUINTIC_STEPS, min_quintic),
      ("cubic", ns_step, _SIGN_NS_STEPS, 1)):
    for j in range(max_steps):
      t0 = time.perf_counter()
      x_next = step(x, precision)
      delta = float(torch.linalg.norm(x_next - x))
      x = x_next
      if steps is not None:
        steps.append((name, time.perf_counter() - t0))
      if j + 1 >= min_steps and delta <= tol:
        break
  return x


def matrix_sign(x: torch.Tensor,
                precision: typing.Optional[str] = None) -> torch.Tensor:
  """Matrix sign of a symmetric x with ‖x‖₂ ≤ 1 (the caller pre-scales),
  by JAX's in-graph schedule (dc.py:187-235). Eigenvalues of magnitude
  below ~_SIGN_L0 may land on either side of zero."""
  return _sign_chain(x, precision or _sign_precision(), 1, x.shape[0])


def _sign_prep_math(m: torch.Tensor, n_valid, descend: bool):
  """Split point, scale bounds and the scaled, pad-pinned sign operand
  (JAX dc.py:258-297). Returns tensors (x0, sigma, alpha, norm2)."""
  n = m.shape[0]
  mm, valid = _masked(m, n_valid)
  vf = valid.to(m.dtype)
  nv = float(n if n_valid is None else n_valid)
  # Split at the mean eigenvalue (masked trace / count).
  sigma = torch.sum(torch.where(valid, torch.diagonal(mm), 0.0)) / nv
  h = mm.clone() if mm is m else mm
  del mm
  h.diagonal().sub_(sigma * vf)
  # Upper bound on ‖h‖₂: min(Gershgorin max row sum, Frobenius norm).
  alpha = torch.clamp_min(
      torch.minimum(torch.amax(torch.sum(torch.abs(h), dim=1)),
                    torch.linalg.norm(h)), 1e-30)
  # Tight estimate by 12 power steps from a fixed start (PRNGKey(3)), 1.05×
  # safety, capped by the bound.
  pv = eigen_ops.start_panel(n, 1, torch.Generator().manual_seed(3),
                             m.dtype, m.device)
  pv = torch.where(valid[:, None], pv, 0.0)
  pv = pv / torch.clamp_min(torch.linalg.norm(pv), 1e-30)
  for _ in range(12):
    pv = torch.matmul(h, pv)
    pv = pv / torch.clamp_min(torch.linalg.norm(pv), 1e-30)
  norm2 = torch.minimum(1.05 * torch.linalg.norm(torch.matmul(h, pv)), alpha)
  x0 = h.div_(alpha)
  # Padded coordinates: pinned to the sign of the discarded side, a fixed
  # point of the chain, so the kept-side projector excludes them.
  x0.diagonal().add_((-1.0 if descend else 1.0) * (1.0 - vf))
  return x0, sigma, alpha, norm2


def _sign_finish_math(u: torch.Tensor, n_valid, descend: bool):
  """Projector onto the kept side, its rank estimate trace(P) and the
  boundary mass (nv − ‖U‖²_F)/4 from the converged sign (JAX
  dc.py:300-314). Returns tensors (p, k_f, b_f)."""
  n = u.shape[0]
  nv = float(n if n_valid is None else n_valid)
  p = u * (0.5 if descend else -0.5)
  p.diagonal().add_(0.5)
  k_f = torch.trace(p)
  uu = u * u
  if n_valid is not None:
    valid = torch.arange(n, device=u.device) < n_valid
    uu = torch.where(valid[:, None] & valid[None, :], uu, 0.0)
  b_f = torch.clamp_min(nv - torch.sum(uu), 0.0) / 4.0
  return p, k_f, b_f


def _sign_project(m, n_valid, descend, precision, n_sched, rec):
  """Sign and projector stage (JAX _sign_project, dc.py:382-415), with
  the minimum-step rule of the schedule JAX takes at size ``n_sched``.
  Returns (p, k_f, b_f, sigma, alpha, norm2), the scalars as floats, and
  records them, the steps and the stage seconds in ``rec``."""
  seconds = rec["seconds"]
  t0 = time.perf_counter()
  prep = list(_sign_prep_math(m, n_valid, descend))
  sigma, alpha, norm2 = (float(v) for v in prep[1:])
  seconds["sign_prep"] = time.perf_counter() - t0
  steps = []
  # The chain gets the only reference to x0, which it frees after a step.
  u = _sign_chain(prep.pop(0), precision,
                  3 if n_sched > _SIGN_SPLIT_N else 1, n_sched, steps)
  t0 = time.perf_counter()
  p, k_f, b_f = _sign_finish_math(u, n_valid, descend)
  del u
  k_f, b_f = float(k_f), float(b_f)
  seconds["sign_finish"] = time.perf_counter() - t0
  seconds["sign_steps"] = [s for _, s in steps]
  rec.update(k_f=k_f, b_f=b_f, sigma=sigma, alpha=alpha, norm2=norm2,
             sign_steps=[name for name, _ in steps])
  return p, k_f, b_f, sigma, alpha, norm2


# ---------------------------------------------------------------------------
# Range capture (JAX dc.py:459-576, :942-961).
# ---------------------------------------------------------------------------


def _bucket(k: int) -> int:
  """Round a block size up to a multiple of 128 (JAX's shape bucket)."""
  return max(128, -(-k // 128) * 128)


def _orth_qr(y: torch.Tensor, col_ok: torch.Tensor) -> torch.Tensor:
  """Thin-QR orthonormalization; columns whose |r_ii| is at the float32
  noise floor, and padding columns, are zeroed exactly. Handles n < k_pad
  (the missing columns come back as zeros)."""
  k_pad = y.shape[1]
  q, r = torch.linalg.qr(y)
  rd = torch.abs(torch.diagonal(r))
  q = q * (rd > 1e-5 * torch.amax(rd))[None, :].to(q.dtype)
  if q.shape[1] < k_pad:
    q = torch.nn.functional.pad(q, (0, k_pad - q.shape[1]))
  return q * (col_ok > 0)[None, :].to(q.dtype)


def _cholesky(gram: torch.Tensor) -> torch.Tensor:
  """``jnp.linalg.cholesky`` as JAX computes it on the CPU: the lower
  factor, or, where the factorization breaks down (``info`` != 0) or its
  input holds a NaN, a factor of NaN. The CholeskyQR2 then zeroes every
  column, as JAX's does."""
  r, info = torch.linalg.cholesky_ex(gram)
  ok = (info == 0) & torch.all(torch.isfinite(r))
  return torch.where(ok, r, torch.nan)


def _cholqr2_shifted(y: torch.Tensor, col_ok: torch.Tensor) -> torch.Tensor:
  """Shift-stabilized CholeskyQR2 of a possibly rank-deficient panel (JAX
  dc.py:486-504): a breakdown's non-finite columns come out zero, so they
  fail the downstream norm > 0.5 keep test."""
  eye = torch.eye(y.shape[1], dtype=y.dtype, device=y.device)
  for _ in range(2):
    gram = torch.matmul(y.T, y)
    delta = 1e-6 * torch.clamp_min(torch.amax(torch.diagonal(gram)), 1e-30)
    r = _cholesky(gram + delta * eye)
    y = torch.linalg.solve_triangular(r, y.T, upper=False).T
    y = torch.where(torch.isfinite(y), y, 0.0)
    y = y * col_ok[None, :]
  return y


def _project_block(m, p, k: int, k_pad: int, generator, descend: bool):
  """Invariant-subspace basis of range(P) and the projected Ritz block
  (JAX _project_block_jit, dc.py:507-575).

  Subspace iteration on the projector from a (n, k_pad) random panel of k
  live columns; the kept columns (norm > 0.5) are compacted to the front.
  Returns (q (n, k_pad), m q, the sentinel-padded q^T m q, k_eff).
  """
  n = m.shape[0]
  g = eigen_ops.start_panel(n, k_pad, generator, m.dtype, m.device)
  col_ok = (torch.arange(k_pad, device=m.device) < k).to(m.dtype)
  y = torch.matmul(p, g) * col_ok[None, :]
  if k_pad <= _QR_PANEL_MAX:
    orth = lambda y: _orth_qr(y, col_ok)  # noqa: E731
  else:
    orth = lambda y: _cholqr2_shifted(y, col_ok)  # noqa: E731
  for _ in range(_PROJECT_ITERS):
    y = torch.matmul(p, orth(y))
  q = orth(y)
  keep = torch.linalg.norm(q, dim=0) > 0.5
  k_eff = int(torch.sum(keep))
  order = torch.argsort(torch.logical_not(keep).to(torch.int8), stable=True)
  q = (q * keep[None, :].to(q.dtype))[:, order]
  mq = torch.matmul(m, q)
  a1 = torch.matmul(q.T, mq)
  a1 = eigen_ops.apply_padding_sentinels(0.5 * (a1 + a1.T), k_eff, descend)
  return q, mq, a1, k_eff


def _project_with_retry(m, p, k_cover, k_pad, generator, descend, want,
                        rec):
  """Range capture with one redraw when it keeps fewer than ``want``
  columns (JAX dc.py:942-961); the better draw wins."""
  gen_draw, gen_redraw = _split(generator)
  out = _project_block(m, p, k_cover, k_pad, gen_draw, descend)
  if out[3] < want:
    rec["redraws"] += 1
    again = _project_block(m, p, k_cover, k_pad, gen_redraw, descend)
    if again[3] > out[3]:
      return again
  return out


# ---------------------------------------------------------------------------
# Block programs (JAX dc.py:579-700, :993-1045).
# ---------------------------------------------------------------------------


def _select_verified(w, v, mv, t: int, scale: float, big, descend: bool):
  """The t extreme pairs whose residual ‖mv − v w‖ is within
  _SPURIOUS_TOL·scale and whose vector has norm > 0.5, spurious ones
  pushed past the scan end by ``big``. Returns (w_t, v_t, res), res the
  worst selected residual over scale (inf for a zero vector)."""
  res_all = torch.linalg.norm(mv - v * w[None, :], dim=0)
  vnorm = torch.linalg.norm(v, dim=0)
  good = (res_all <= _SPURIOUS_TOL * scale) & (vnorm > 0.5)
  sort_val = torch.where(good, w, -big if descend else big)
  idx = torch.argsort(-sort_val if descend else sort_val, stable=True)[:t]
  res = torch.amax(torch.where(vnorm[idx] > 0.5, res_all[idx],
                               torch.inf)) / scale
  return w[idx], v[:, idx], float(res)


def _back_transform(w, u, q, mq, t, scale, descend):
  """Residual-filtered extreme-t Ritz pairs of a projected block, lifted
  by q (JAX _back_transform_jit)."""
  big = 10.0 * torch.amax(torch.abs(w)) + 1.0
  return _select_verified(w, torch.matmul(q, u), torch.matmul(mq, u), t,
                          scale, big, descend)


def _direct_verify(m, w, v, t, scale, descend):
  """Re-verify pairs (w, v) against this level's m (JAX
  _direct_verify_jit)."""
  big = 10.0 * torch.clamp_min(torch.amax(torch.abs(w)), scale) + 1.0
  return _select_verified(w, v, torch.matmul(m, v), t, scale, big, descend)


def _verify_select(m, q, wp, up, t, scale, descend):
  """Lift a pool of block pairs by q and keep the t extreme verified ones
  (JAX _verify_select_jit)."""
  return _direct_verify(m, wp, torch.matmul(q, up), t, scale, descend)


def _dense_topt(m, t, descend):
  """Full eigh of a (possibly sentinel-padded) block, t extreme pairs."""
  w, u = eigen_ops.sorted_eigh(m, descend=descend)
  return w[:t], u[:, :t]


def _zero_block(n, t, sigma, device):
  """A structurally zero block: σ t times and the first t unit vectors."""
  return (torch.full((t,), sigma, dtype=torch.float32, device=device),
          torch.eye(n, t, dtype=torch.float32, device=device))


def _complement(p, n_valid):
  """The spectral complement's projector, sentinel coordinates masked."""
  pc = -p
  pc.diagonal().add_(1.0)
  return _masked(pc, n_valid)[0]


def _deflate(m, v, w, c):
  """m − v diag(w − c) vᵀ: the solved pairs moved to ``c``, past the scan
  end (JAX _deflate_jit)."""
  return m - torch.matmul(v * (w - c)[None, :], v.T)


def _merge_dedup(w1, w2, v1, v2, t, descend):
  """The t extreme of the kept-side and remainder pairs, a remainder pair
  overlapping a kept-side eigenvector by more than _DEDUP_OVERLAP pushed
  past the scan end (JAX _merge_dedup_jit)."""
  dup2 = torch.amax(torch.abs(torch.matmul(v1.T, v2)), dim=0) > _DEDUP_OVERLAP
  big = 10.0 * torch.maximum(torch.amax(torch.abs(w1)),
                             torch.amax(torch.abs(w2))) + 1.0
  w2s = torch.where(dup2, -big if descend else big, w2)
  w = torch.cat([w1, w2s])
  order = torch.argsort(-w if descend else w, stable=True)[:t]
  return torch.cat([w1, w2])[order], torch.cat([v1, v2], dim=1)[:, order]


def _topt_of_block(a1, m, q, mq, t, generator, descend, k_use, k_pad,
                   max_block, depth, scale, precision, levels):
  """Extreme-t eigenpairs of m restricted to span(q) (JAX dc.py:964-990):
  eigh of the projected block up to ``max_block``, else the split on it,
  a pool of t+8 pairs re-verified against this level's m."""
  if k_pad <= max_block:
    w1, u1 = torch.linalg.eigh(a1)
    return _back_transform(w1, u1, q, mq, t, scale, descend)
  t_pool = min(t + 8, k_use)
  wp, up, _, _ = _split_level(a1, t_pool, generator, descend, k_use,
                              max_block, precision, levels, depth + 1, scale,
                              k_pad)
  return _verify_select(m, q, wp, up, t, scale, descend)


# ---------------------------------------------------------------------------
# The entry point.
# ---------------------------------------------------------------------------


def _split_level(m, t, generator, descend, n_valid, max_block, precision,
                 levels, depth, scale, n_sched):
  """One level of the spectral divide-and-conquer (JAX eigh_topk_dc past
  its dense and iterative branches, dc.py:758-939). Appends its record to
  ``levels`` and returns (w, v, res, scale)."""
  n = m.shape[0]
  nv = n if n_valid is None else int(n_valid)
  rec = {"depth": depth, "n": n, "nv": nv, "t": t, "k_pad": None,
         "k_eff": None, "redraws": 0, "seconds": {}}
  levels.append(rec)
  seconds = rec["seconds"]

  def fallback(reason, gen, scale):
    rec.update(branch="subspace_fallback", reason=reason)
    t0 = time.perf_counter()
    stats = {}
    out = _subspace_fallback(m, t, gen, descend, n_valid, scale, stats=stats)
    seconds["fallback"] = time.perf_counter() - t0
    rec.update(res=out[2], subspace_iters=stats["iters"])
    return out

  if depth > 8:
    return fallback("depth", generator, scale)
  p, k_f, b_f, sigma, alpha, norm2 = _sign_project(m, n_valid, descend,
                                                   precision, n_sched, rec)
  bound = abs(sigma) + alpha
  scale = scale if scale is not None else max(abs(sigma) + norm2, 1e-30)
  if bound <= 1e-6 * scale:
    # Every eigenvalue within float32 noise of 0 at the original scale.
    rec.update(branch="zero_block", res=bound / scale)
    w, v = _zero_block(n, t, sigma, m.device)
    return w, v, bound / scale, scale

  k_est = max(1, min(int(round(k_f)), nv - 1))
  # Basis margin: trace-rounding fuzz plus every boundary mode (each with p
  # in [0.15, 0.85] adds at least 0.1275 to the boundary mass).
  margin = 8 + int(math.ceil(8.0 * b_f))
  k_cover = min(k_est + margin, nv)
  if k_cover >= nv - 8:
    return fallback("no_reduction", generator, scale)
  gen_basis, gen_comp, gen_rec, gen_rec2 = _split(generator, 4)
  k_pad = _bucket(k_cover)
  rec.update(k_est=k_est, k_cover=k_cover, k_pad=k_pad)
  if k_pad > _PROJECT_SPLIT_K:
    return fallback("project_wall", gen_rec, scale)
  covers = k_est >= t + 8
  t0 = time.perf_counter()
  q, mq, a1, k_eff = _project_with_retry(
      m, p, k_cover, k_pad, gen_basis, descend, t if covers else min(k_est, t),
      rec)
  seconds["project"] = time.perf_counter() - t0
  rec["k_eff"] = k_eff

  if covers:
    # The kept side covers the t requested pairs.
    del p
    if k_eff < t:
      return fallback("capture_short", gen_rec, scale)
    t0 = time.perf_counter()
    w, v, res = _topt_of_block(a1, m, q, mq, t, gen_rec, descend, k_eff,
                               k_pad, max_block, depth, scale, precision,
                               levels)
    seconds["ritz"] = time.perf_counter() - t0
    rec.update(branch="kept_covers_t", res=res)
    _check_residual(res)
    return w, v, res, scale

  # The kept side holds fewer than t + 8: solve it, then take the rest from
  # the spectral complement.
  if k_eff == 0:
    return fallback("capture_short", gen_rec, scale)
  t1 = min(t, k_est, k_eff)
  t0 = time.perf_counter()
  wt1, vt1, res1 = _topt_of_block(a1, m, q, mq, t1, gen_rec, descend, k_eff,
                                  k_pad, max_block, depth, scale, precision,
                                  levels)
  seconds["ritz"] = time.perf_counter() - t0
  del q, mq, a1
  rec.update(t1=t1, res1=res1)
  if not math.isfinite(res1) or res1 > _FAIL_RESIDUAL:
    return fallback("kept_degraded", gen_rec2, scale)
  t_rem = t - t1
  if t_rem == 0:
    rec.update(branch="kept_covers_t", res=res1)
    return wt1, vt1, res1, scale

  # trace((I − P) masked), read from P's diagonal.
  p_diag = torch.diagonal(p)[:nv]
  kc_f = float(torch.sum(1.0 - p_diag))
  kc_est = max(t_rem, min(int(round(kc_f)), nv - 1))
  kc_pad = _bucket(min(kc_est + margin, nv))
  rec.update(kc_est=kc_est, kc_pad=kc_pad)
  t0 = time.perf_counter()
  if kc_pad > _PROJECT_SPLIT_K:
    # Deflate the solved pairs past the scan end and take the remainder
    # from a certified subspace solve on the deflated operator, re-verified
    # against the original m.
    del p
    rec["branch"] = "deflated_remainder"
    c_far = (sigma - alpha) if descend else (sigma + alpha)
    md = _deflate(m, vt1, wt1, c_far)
    t2 = t_rem + _MERGE_EXTRA
    stats = {}
    w2p, v2p, _, _ = _subspace_fallback(md, t2, gen_comp, descend, n_valid,
                                        scale, norm_bound=abs(sigma) + alpha,
                                        check=False, stats=stats)
    del md
    rec["subspace_iters"] = stats["iters"]
    w2, v2, res2 = _direct_verify(m, w2p, v2p, t2, scale, descend)
  else:
    # Orthonormal basis of the complement + Rayleigh–Ritz: exact separation
    # within its span.
    rec["branch"] = "complement_block"
    pc = _complement(p, n_valid)
    del p
    qc, mqc, a2, kc_eff = _project_block(m, pc, min(kc_est + margin, nv),
                                         kc_pad, gen_comp, descend)
    del pc
    rec["kc_eff"] = kc_eff
    if kc_eff == 0:
      return fallback("complement_empty", gen_rec2, scale)
    t2 = max(t_rem, min(t_rem + _MERGE_EXTRA, kc_eff))
    w2, v2, res2 = _topt_of_block(a2, m, qc, mqc, t2, gen_rec2, descend,
                                  kc_eff, kc_pad, max_block, depth, scale,
                                  precision, levels)
  seconds["remainder"] = time.perf_counter() - t0
  res = max(res1, res2)
  rec.update(res2=res2, res=res)
  if not math.isfinite(res) or res > _FAIL_RESIDUAL:
    return fallback("split_degraded", gen_rec2, scale)
  wt, vt = _merge_dedup(wt1, w2, vt1, v2, t, descend)
  _check_residual(res)
  return wt, vt, res, scale


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
    _n_bucket: typing.Optional[int] = None,
    timings=None,
    split_on_decline: bool = True,
) -> typing.Optional[typing.Tuple[torch.Tensor, torch.Tensor, float, float]]:
  """The t extreme eigenpairs of a symmetric m, certified.

  Returns (w (t,), u (n, t), res, scale) in scan order (descending for
  ``descend=True``): ``res`` is the worst residual ‖m u_j − w_j u_j‖ over
  ``scale``, and ``scale`` the operand's norm estimate, which callers use
  for the full-spectrum snap and NormalizedDiff. With ``n_valid``, m must
  already carry the padding sentinels (eigen_ops.apply_padding_sentinels).
  ``try_iterative_first=False`` skips the certified-iterative route
  (default ``_TRY_ITERATIVE_FIRST``). ``sign_precision`` is the sign
  chain's precision, "highest", "high" or "default" (default
  ``_sign_precision()``); every other product runs in IEEE float32.
  ``_n_bucket`` is the size of the operand JAX would be handed (the
  caller's ``pad_bucket(N)``): it decides the dense branch and the sign
  chain's schedule. ``info`` receives the route and its diagnostics (module
  docstring). ``timings`` (an ``observability.StageTimings``) records the
  spans "dc_certified" (the certified attempt, accepted or declined) and
  "dc_split" (the split's levels), and the counters "dc_certified" (1
  where the certified route answered) and "dc_subspace_iters"
  (``subspace_iterations``). With ``split_on_decline=False`` a declined
  certified attempt returns None (route "declined") in place of the
  split, for a caller that solves otherwise. Raises RuntimeError when the
  certified residual exceeds ``_FAIL_RESIDUAL``.
  """
  info = {} if info is None else info
  out = _route(m, t, generator, descend, n_valid, max_block, sign_precision,
               try_iterative_first, info, _n_bucket, timings,
               split_on_decline)
  if timings is not None:
    timings.count("dc_certified", int(info["route"] == "certified"))
    timings.count("dc_subspace_iters", subspace_iterations(info))
  return out


def _route(m, t, generator, descend, n_valid, max_block, sign_precision,
           try_iterative_first, info, n_bucket, timings, split_on_decline):
  """``eigh_topk_dc``'s routes, in order (module docstring)."""
  n = m.shape[0]
  t = min(t, n if n_valid is None else int(n_valid))
  n_route = n if n_bucket is None else n_bucket
  with fp32_precision():
    if n_route <= max_block:
      w, u = _dense_topt(m, t, descend)
      info["route"] = "dense"
      return w, u, 0.0, float(torch.amax(torch.abs(w)))
    if (_TRY_ITERATIVE_FIRST if try_iterative_first is None
        else try_iterative_first):
      with _span(timings, "dc_certified"):
        out = _certified_iterative_topt(m, t, generator, descend, n_valid,
                                        info)
      if out is not None:
        info["route"] = "certified"
        return out
      if not split_on_decline:
        info["route"] = "declined"
        return None
    precision = sign_precision or _sign_precision()
    info.update(route="split", sign_precision=precision, levels=[])
    with _span(timings, "dc_split"):
      return _split_level(m, t, generator, descend, n_valid, max_block,
                          precision, info["levels"], 0, None, n_route)


def _span(timings, name: str):
  return contextlib.nullcontext() if timings is None else timings.span(name)


def subspace_iterations(info: dict) -> int:
  """Subspace iterations across a route's ``info``: the certified
  attempt's and every split level's (fallback or deflated remainder)."""
  return int(info.get("iters", 0)) + sum(
      int(level.get("subspace_iters", 0)) for level in info.get("levels", ()))


def lanczos_topt(m: torch.Tensor, t: int, generator: torch.Generator,
                 descend: bool = True, n_valid=None,
                 stats: typing.Optional[dict] = None):
  """The t extreme eigenpairs of a symmetric m by Lanczos with full
  reorthogonalization (every step twice against the whole basis):
  ``pipeline._dc_topk``'s first solve on a descending scan, its re-solve
  after the certified attempt on an ascending one.

  On the icassp2018 operand at long sizes the spectrum past the few large
  eigenvalues decays from order 1 to a cluster at 0. A subspace iteration
  on m shifted by ‖m‖ separates those values at a rate of 1 − gap/‖m‖
  per step and does not in its cap; a Krylov basis separates them at the
  square root of that rate, and 160 steps gave every residual at 1e-7 of
  ‖m‖ on such operands. The basis grows to each of ``_LANCZOS_CAPS`` (at
  most n), then Rayleigh–Ritz in float64 reads the residual; it stops at
  ``_LANCZOS_TOL``. Every product is ``fused.panel_matmul`` (kernel 6, one
  column). The start vector, drawn from ``generator`` on the CPU, is zero
  on padded coordinates, so the basis stays in the valid block. A basis
  that lost its orthonormality (the Krylov space exhausted before a cap)
  reads res = inf. Returns (w (t,), u (n, t), res, scale) in scan order
  like ``eigh_topk_dc``: res the worst residual over scale, scale the
  largest |Ritz value|, the spectrum's max|w| from below. ``stats``
  receives "steps", the Krylov steps taken.
  """
  n = m.shape[0]
  nv = n if n_valid is None else int(n_valid)
  valid = torch.arange(n, device=m.device) < nv
  q = eigen_ops.start_panel(n, 1, generator, m.dtype, m.device)[:, 0]
  q = torch.where(valid, q, 0.0)
  q = q / torch.linalg.norm(q)
  caps = sorted({min(cap, nv) for cap in _LANCZOS_CAPS})
  # Rows are the basis vectors and their images under ±m.
  basis = m.new_empty((caps[-1], n))
  images = m.new_empty((caps[-1], n))
  steps = 0
  for cap in caps:
    while steps < cap:
      basis[steps] = q
      z = fused.panel_matmul(m, q[:, None])[:, 0]
      if not descend:
        z = z.neg_()
      images[steps] = z
      qs = basis[:steps + 1]
      for _ in range(2):
        z = z - qs.T @ (qs @ z)
      q = z / torch.clamp_min(torch.linalg.norm(z), 1e-30)
      steps += 1
    qs, zs = basis[:steps], images[:steps]
    drift = qs @ qs.T
    drift.diagonal().sub_(1.0)
    h = (qs @ zs.T).double()
    theta, s = torch.linalg.eigh(0.5 * (h + h.T))
    scale = max(float(torch.amax(torch.abs(theta))), 1e-30)
    theta = theta.flip(0)[:t].to(m.dtype)
    s = s.flip(1)[:, :t].to(m.dtype)
    u = qs.T @ s
    r = zs.T @ s - u * theta[None, :]
    res = float(torch.amax(torch.linalg.norm(r, dim=0))) / scale
    if float(torch.amax(torch.abs(drift))) > 1e-3:
      res = math.inf
      break
    if res <= _LANCZOS_TOL:
      break
  if stats is not None:
    stats["steps"] = steps
  return (theta if descend else -theta), u, res, scale


def complete_beyond(m: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    delta: float, descend: bool = True,
                    snap: float = 0.0) -> bool:
  """Whether every eigenvalue of m past the t returned pairs (w, v) lies on
  the far side of w_t ± ``delta``: the completeness certificate the
  residual alone cannot give. Where the scan's snap (|w| < ``snap`` reads
  0) takes w_t within ``delta``, the edge is the snap's instead: values
  that both read 0 need not be told apart.

  A residual bounds each returned value's distance to some eigenvalue of
  m, not that the values are the t extreme ones. Where m's spectrum past
  its few large eigenvalues is a dense cluster at 0 with a few isolated
  values of order 1 (the icassp2018 operand at long sizes, with thousands
  of segments per speaker), a subspace iteration on m shifted by ‖m‖ does
  not separate them in its iteration cap, and both the certified attempt
  and the split's deflated remainder can return pairs from the cluster
  with small residuals while missing the isolated values. Sylvester's law
  of inertia decides it: with the returned pairs moved ‖m‖ past the scan
  end, A = (w_t + delta)·I − m + v diag(w − c) vᵀ (descending; mirrored
  for an ascending scan) is positive definite exactly when no eigenvalue
  of m on v's orthogonal complement reaches w_t + delta (Courant–Fischer),
  which one float64 Cholesky factorization tells. A breakdown or a
  non-finite factor reads as incomplete. Padding sentinels, which lie past
  the scan end, do not disturb it.
  """
  sign = 1.0 if descend else -1.0
  ww = w.to(torch.float64) * sign
  vv = v.to(torch.float64)
  w_t = float(torch.amin(ww))
  edge = w_t + float(delta)
  if abs(w_t) + delta < snap:
    edge = max(edge, float(snap))
  far = edge - 2.0 * float(torch.amax(torch.sum(torch.abs(m), dim=1))) - 1.0
  a = m.to(torch.float64)
  if descend:
    a.neg_()
  a.addmm_(vv * (ww - far)[None, :], vv.T)
  a.diagonal().add_(edge)
  # Factored in place: the test holds m and one float64 copy.
  status = torch.empty((), dtype=torch.int32, device=a.device)
  torch.linalg.cholesky_ex(a, out=(a, status))
  return int(status) == 0 and bool(torch.all(torch.isfinite(
      torch.diagonal(a))))


def _check_residual(res: float) -> None:
  if not math.isfinite(res) or res > _FAIL_RESIDUAL:
    raise RuntimeError(
        f"eigh_topk_dc: certified eigenpair residual {res:.2e} exceeds "
        f"{_FAIL_RESIDUAL:.0e}: the eigensolver failed numerically. Use "
        "EigenSolver.SubspaceIteration.")
