"""Eigensolvers and eigengap cluster-count selection.

Port of ``spectralcluster_tpu/ops/eigen.py``:

  * ``sorted_eigh`` / ``sorted_eigh_similarity`` — full ``torch.linalg.eigh``
    with the diagonal-similarity eigenvector recovery;
  * ``sorted_eig_general_host`` — LAPACK's general eig on the host, for the
    GENERAL symmetry structure;
  * ``snap_small_eigenvalues`` and the masked eigengap scan
    ``compute_number_of_clusters`` (reference utils.py:74-130 semantics);
  * ``apply_padding_sentinels`` for padded eigenproblems;
  * ``topk_eigh_subspace(_masked)`` — block power iteration with CholeskyQR2
    for the top-k eigenpairs, with residual and drift escalation.

Differences from the JAX version, by design:
  * Start panels come from a ``torch.Generator`` drawn on the CPU and moved
    to the matrix's device, so a CPU run and a card run start from the same
    panel (they differ from ``jax.random``'s panel).
  * ``lax.while_loop`` becomes a Python loop that reads the residual once per
    chunk of iterations.
  * ``torch.linalg.cholesky`` raises where JAX's returned NaN, so
    CholeskyQR2 uses ``cholesky_ex`` and its ``info`` for the 1e-2 rescue.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from spectralcluster_tpu_torch.types import EPS, EigenGapType


def _sort_eigs(w: torch.Tensor, v: torch.Tensor,
               descend: bool) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  order = torch.argsort(-w if descend else w, stable=True)
  return w[order], v[:, order]


def sorted_eigh(mat: torch.Tensor,
                descend: bool = True) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric eigendecomposition with eigenvalues sorted as requested."""
  w, v = torch.linalg.eigh(mat)
  if descend:
    return torch.flip(w, (0,)), torch.flip(v, (1,))
  return w, v


def sorted_eigh_similarity(
    sym_mat: torch.Tensor,
    vec_scale: typing.Optional[torch.Tensor],
    descend: bool = True,
    n_valid=None) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """eigh of a symmetric similarity form; recover original eigenvectors.

  If A = S_d^{-1} M S_d (diagonal similarity), pass M and the per-row scale
  s = diag(S_d^{-1}): eigenvalues are shared, eigenvectors v = s * u, then
  renormalized to unit 2-norm columns (LAPACK eig convention, utils.py:59).
  """
  w, u = sorted_eigh(sym_mat, descend)
  return w, recover_similarity_eigenvectors(u, vec_scale, n_valid)


def recover_similarity_eigenvectors(
    u: torch.Tensor,
    vec_scale: typing.Optional[torch.Tensor],
    n_valid=None) -> torch.Tensor:
  """Map eigenvectors of the symmetric similarity form back to the original.

  v = s * u, renormalized to unit 2-norm columns; with ``n_valid``, norms
  are taken over valid rows only.
  """
  if vec_scale is None:
    return u
  v = vec_scale[:, None] * u
  if n_valid is None:
    norms = torch.linalg.norm(v, dim=0)
  else:
    valid = (torch.arange(v.shape[0], device=v.device) < n_valid)[:, None]
    norms = torch.linalg.norm(torch.where(valid, v, 0.0), dim=0)
  return v / torch.where(norms > 0, norms, 1.0)


def sorted_eig_general_host(
    mat: torch.Tensor,
    descend: bool = True) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """General (non-symmetric) eigendecomposition on the host.

  What the JAX host callback does (reference utils.py:44-71 with ``.real``):
  LAPACK's ``np.linalg.eig`` on a float64 host copy, real parts cast to the
  matrix's dtype, then a stable sort. The results go back to the matrix's
  device. This route is host LAPACK by contract, in both packages; its
  callers report its time on its own.
  """
  w, v = np.linalg.eig(mat.detach().cpu().numpy().astype(np.float64))
  w = torch.from_numpy(w.real.astype(np.float32)).to(mat.dtype)
  v = torch.from_numpy(v.real.astype(np.float32)).to(mat.dtype)
  w, v = _sort_eigs(w, v, descend)
  return w.to(mat.device), v.to(mat.device)


def snap_small_eigenvalues(w: torch.Tensor, n_valid=None,
                           tol: float = 1e-5,
                           wmax=None) -> torch.Tensor:
  """Snap eigenvalues below solver noise to exact zero.

  In float32 a structurally zero eigenvalue comes out ±1e-7 with random
  sign, and a negative one flips the Ratio eigengap's sign. Snapping
  |w| < tol·max|w| to 0 restores the exact-arithmetic semantics.
  ``n_valid`` keeps padded sentinel eigenvalues out of the max and
  untouched. ``wmax`` overrides the in-array max|w|: top-k solvers return
  only the extreme eigenvalues, and the snap must be relative to the full
  spectrum's scale.
  """
  if n_valid is None:
    valid = torch.ones(w.shape, dtype=torch.bool, device=w.device)
  else:
    valid = torch.arange(w.shape[0], device=w.device) < n_valid
  if wmax is None:
    wmax = torch.amax(torch.where(valid, torch.abs(w), 0.0))
  snap = valid & (torch.abs(w) < tol * wmax)
  return torch.where(snap, 0.0, w)


# ---------------------------------------------------------------------------
# Eigengap-based number-of-clusters selection (reference utils.py:74-130).
# ---------------------------------------------------------------------------


def compute_number_of_clusters(
    eigenvalues: torch.Tensor,
    max_clusters: typing.Optional[int] = None,
    stop_eigenvalue: float = 1e-2,
    eigengap_type: EigenGapType = EigenGapType.Ratio,
    descend: bool = True,
    eps: float = EPS,
    n_valid=None,
    wmax=None) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Masked, vectorized eigengap scan with the reference loop's semantics.

    descend (utils.py:117-128): for i in [1, range_end), stop at the first i
      with eigenvalues[i-1] < stop_eigenvalue; delta = w[i-1]/(w[i]+eps)
      (Ratio) or (w[i-1]-w[i])/max(w) (NormalizedDiff); first maximal delta
      wins; if no delta > 0, returns (0, 0).
    ascend (utils.py:106-115): for i in [1, range_end-1), delta uses
      (w[i+1], w[i]) and the winner index is i+1.

  ``n_valid`` restricts the scan and the NormalizedDiff max to the first
  n_valid eigenvalues. ``wmax`` overrides the NormalizedDiff denominator.
  Returns 0-dim tensors (n_clusters: int32, max_delta: float).
  """
  if not isinstance(eigengap_type, EigenGapType):
    raise TypeError("eigengap_type must be a EigenGapType")
  dev = eigenvalues.device
  n = eigenvalues.shape[0]
  range_end = n
  if max_clusters and max_clusters + 1 < range_end:
    range_end = max_clusters + 1
  zero = (torch.zeros((), dtype=torch.int32, device=dev),
          torch.zeros((), dtype=eigenvalues.dtype, device=dev))

  idx = torch.arange(n, device=dev)
  n_valid_arr = torch.as_tensor(n if n_valid is None else n_valid,
                                dtype=torch.int32, device=dev)

  def norm_max():
    if wmax is not None:
      return wmax
    return torch.amax(torch.where(idx < n_valid_arr, eigenvalues, -torch.inf))

  if descend:
    if n < 2:
      return zero
    lead = eigenvalues[:-1]      # w[i-1] for i = 1..n-1
    lag = eigenvalues[1:]        # w[i]
    # Break: iteration i runs only while all previous w[j-1] >= stop.
    alive = torch.cumprod((lead >= stop_eigenvalue).to(torch.int32), 0) > 0
    pos = idx[:-1] + 1           # the loop variable i
    in_range = (pos < range_end) & (pos < n_valid_arr)
    if eigengap_type == EigenGapType.Ratio:
      delta = lead / (lag + eps)
    else:
      delta = (lead - lag) / norm_max()
    masked = torch.where(alive & in_range, delta, -torch.inf)
    offset = 1
  else:
    if n < 3:
      return zero
    cur = eigenvalues[1:-1]      # w[i] for i = 1..n-2
    nxt = eigenvalues[2:]        # w[i+1]
    pos = idx[1:-1]              # the loop variable i
    in_range = (pos < range_end - 1) & (pos + 1 < n_valid_arr)
    if eigengap_type == EigenGapType.Ratio:
      delta = nxt / (cur + eps)
    else:
      delta = (nxt - cur) / norm_max()
    masked = torch.where(in_range, delta, -torch.inf)
    offset = 2                   # index i means i+1 clusters
  best = torch.amax(masked)
  # torch.argmax returns the first maximal index, as jnp.argmax does.
  best_i = torch.argmax(masked) + offset
  n_clusters = torch.where(best > 0, best_i, 0).to(torch.int32)
  return n_clusters, torch.clamp_min(best, 0.0)


# ---------------------------------------------------------------------------
# Sentinel handling for padded eigenproblems.
# ---------------------------------------------------------------------------


def apply_padding_sentinels(mat: torch.Tensor, n_valid,
                            descend: bool) -> torch.Tensor:
  """Make padded coordinates spectrally inert.

  Zeroes padded rows/cols and writes distinct sentinel values on the padded
  diagonal, so that the matrix stays block-diagonal and, after sorting,
  padded eigenvalues land past the end of the scan direction. Sentinel
  magnitude is scaled to the valid block's Gershgorin bound: eigensolver
  backward error is relative to ‖A‖, so fixed huge sentinels would inject
  error into the valid eigenvalues.
  """
  n = mat.shape[0]
  idx = torch.arange(n, device=mat.device)
  v = idx < n_valid
  keep = v[:, None] & v[None, :]
  out = torch.where(keep, mat, 0.0)
  bound = torch.amax(torch.sum(torch.where(keep, torch.abs(out), 0.0), dim=1))
  base = 1.25 * bound + 1.0
  step = 0.01 * bound + 0.01
  sign = -1.0 if descend else 1.0
  sentinels = sign * (base + idx.to(mat.dtype) * step)
  diag = torch.diagonal(out)
  diag_vals = torch.where(v, diag, sentinels)
  return out - torch.diag(diag) + torch.diag(diag_vals)


# ---------------------------------------------------------------------------
# Top-k eigensolver.
# ---------------------------------------------------------------------------


def cholqr2_shifted(y: torch.Tensor) -> torch.Tensor:
  """Orthonormalize a tall-skinny panel with shift-stabilized CholeskyQR2.

  Matmul-only apart from an O(b³) Cholesky and triangular solve on the
  (b, b) Gram. The 1e-6 shift keeps Cholesky from breaking down on an
  ill-conditioned panel; the second pass restores orthogonality. When a
  pass still fails (a rank-collapsed panel can push the shifted Gram
  indefinite), it is redone with a 1e-2 shift, which is always positive
  definite. ``cholesky_ex`` reports the failure in ``info`` instead of
  raising; both passes are computed and selected on the device, so no host
  sync is needed.
  """
  b = y.shape[1]
  eye = torch.eye(b, dtype=y.dtype, device=y.device)

  def one_pass(y, delta_rel):
    gram = torch.matmul(y.T, y)
    delta = delta_rel * torch.clamp_min(torch.amax(torch.diagonal(gram)),
                                        1e-30)
    r, info = torch.linalg.cholesky_ex(gram + delta * eye)
    q = torch.linalg.solve_triangular(r, y.T, upper=False).T
    return q, info

  for _ in range(2):
    y1, info = one_pass(y, 1e-6)
    ok = (info == 0) & torch.all(torch.isfinite(y1))
    y2, _ = one_pass(y, 1e-2)
    y = torch.where(ok, y1, y2)
  return y


def start_panel(n: int, b: int, generator: torch.Generator, dtype,
                device) -> torch.Tensor:
  """Standard-normal (n, b) start panel, drawn from a CPU ``generator``."""
  return torch.randn((n, b), generator=generator, dtype=dtype).to(device)


def topk_eigh_subspace_masked(
    mat: torch.Tensor,
    k: int,
    generator: torch.Generator,
    largest: bool,
    n_valid=None,
    num_iters: int = 24,
    residual_tol: typing.Optional[float] = None,
    max_iters: int = 384,
    drift_tol: typing.Optional[float] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """topk_eigh_subspace on the VALID block of a sentinel-padded matrix.

  The pad block is rebuilt as exact zeros, so padded coordinates are never
  amplified by the power iteration. For the ascending case its diagonal is
  set to the valid block's Gershgorin bound + 1 (just past the scan end) and
  the shift comes from that bound, so the valid spectrum keeps a healthy
  separation.
  """
  if n_valid is None:
    return topk_eigh_subspace(mat, k, generator, num_iters=num_iters,
                              largest=largest, residual_tol=residual_tol,
                              max_iters=max_iters, drift_tol=drift_tol)
  n = mat.shape[0]
  v = torch.arange(n, device=mat.device) < n_valid
  keep = v[:, None] & v[None, :]
  mm = torch.where(keep, mat, 0.0)
  if largest:
    return topk_eigh_subspace(mm, k, generator, num_iters=num_iters,
                              largest=True, residual_tol=residual_tol,
                              max_iters=max_iters, drift_tol=drift_tol)
  bound = torch.amax(torch.sum(torch.abs(mm), dim=1))
  shift = bound + 1.0
  op_m = mm + torch.diag(torch.where(v, 0.0, shift))
  return topk_eigh_subspace(op_m, k, generator, num_iters=num_iters,
                            largest=False, shift=shift,
                            residual_tol=residual_tol, max_iters=max_iters,
                            drift_tol=drift_tol)


def topk_eigh_subspace(
    mat: torch.Tensor,
    k: int,
    generator: torch.Generator,
    num_iters: int = 24,
    oversample: int = 8,
    largest: bool = True,
    shift=None,
    residual_tol: typing.Optional[float] = None,
    max_iters: int = 384,
    drift_tol: typing.Optional[float] = None,
    stats: typing.Optional[dict] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Randomized subspace (block power) iteration for extreme eigenpairs.

  Each iteration is one (N,N)x(N,b) matmul plus CholeskyQR2. For the
  smallest eigenpairs of a PSD matrix it iterates on (shift*I - M), with
  ``shift`` defaulting to a Gershgorin upper bound.

  With ``residual_tol`` set, after the initial ``num_iters`` the iteration
  escalates in ``num_iters``-sized chunks (up to ``max_iters`` in all) until
  the worst top-k residual max_i ‖M v_i − λ_i v_i‖ / max|λ| drops below the
  tolerance, or, with ``drift_tol``, until the Ritz values moved by at most
  drift_tol·max|λ| over the last chunk. The loop reads the residual and the
  drift on the host once per chunk. A ``stats`` dict receives the number of
  iterations run under "iters".
  """
  n = mat.shape[0]
  b = min(n, k + oversample)
  if not largest:
    if shift is None:
      shift = torch.amax(torch.sum(torch.abs(mat), dim=1))
    op = lambda x: shift * x - torch.matmul(mat, x)
  else:
    op = lambda x: torch.matmul(mat, x)

  def iterate(q, steps):
    for _ in range(steps):
      q = cholqr2_shifted(op(q))
    return q

  def rayleigh_ritz(q):
    """Ritz pairs of the ORIGINAL matrix + worst relative top-k residual."""
    mq = torch.matmul(mat, q)
    t = q.T @ mq
    t = 0.5 * (t + t.T)
    # The (b, b) Ritz problem is solved in float64: once the basis has
    # collapsed onto a low-rank top, t carries float32 denormals, on which
    # torch's float32 eigh fails to converge and raises (JAX's returns).
    w_small, u_small = torch.linalg.eigh(t.double())
    w_small, u_small = w_small.to(t.dtype), u_small.to(t.dtype)
    if largest:
      w_small, u_small = torch.flip(w_small, (0,)), torch.flip(u_small, (1,))
    v = q @ u_small[:, :k]
    mv = mq @ u_small[:, :k]
    res = torch.linalg.norm(mv - v * w_small[None, :k], dim=0)
    scale = torch.clamp_min(torch.amax(torch.abs(w_small)), 1e-30)
    return w_small[:k], v, torch.amax(res) / scale

  q = cholqr2_shifted(start_panel(n, b, generator, mat.dtype, mat.device))
  q = iterate(q, num_iters)
  it = num_iters

  if residual_tol is not None:
    dtol = -1.0 if drift_tol is None else drift_tol
    w_prev, _, res = rayleigh_ritz(q)
    drift = float("inf")
    while float(res) > residual_tol and drift > dtol and it < max_iters:
      q = iterate(q, num_iters)
      w_new, _, res = rayleigh_ritz(q)
      scale = torch.clamp_min(torch.amax(torch.abs(w_new)), 1e-30)
      drift = float(torch.amax(torch.abs(w_new - w_prev)) / scale)
      w_prev = w_new
      it += num_iters
  if stats is not None:
    stats["iters"] = it
  w, v, _ = rayleigh_ritz(q)
  return w, v
