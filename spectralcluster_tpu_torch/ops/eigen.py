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
    for the top-k eigenpairs, with residual and drift escalation, on one
    matrix or a (B, N, N) batch;
    ``topk_eigh_subspace_sharded`` — the masked form on a matrix held as
    row stripes over a shard group (``parallel/collectives.py``).

Differences from the JAX version, by design:
  * Start panels come from a ``torch.Generator`` drawn on the CPU and moved
    to the matrix's device, so a CPU run and a card run start from the same
    panel (they differ from ``jax.random``'s panel).
  * ``lax.while_loop`` becomes a Python loop that reads on the host once per
    chunk of iterations whether any matrix goes on; a batch of matrices
    (JAX's vmap of the loop) keeps each one's state with ``torch.where``.
  * ``torch.linalg.cholesky`` raises where JAX's returned NaN, so
    CholeskyQR2 uses ``cholesky_ex`` and its ``info`` for the 1e-2 rescue.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.types import EPS, EigenGapType
from spectralcluster_tpu_torch.utils import per_matrix, valid_mask


def _sort_eigs(w: torch.Tensor, v: torch.Tensor,
               descend: bool) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Stable sort of (…, N) eigenvalues and the (…, N, N) columns with
  them."""
  order = torch.argsort(-w if descend else w, dim=-1, stable=True)
  return (torch.take_along_dim(w, order, dim=-1),
          torch.take_along_dim(v, order[..., None, :], dim=-1))


def sorted_eigh(mat: torch.Tensor,
                descend: bool = True) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric eigendecomposition with eigenvalues sorted as requested."""
  w, v = torch.linalg.eigh(mat)
  if descend:
    return torch.flip(w, (-1,)), torch.flip(v, (-1,))
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
  v = vec_scale[..., :, None] * u
  if n_valid is None:
    norms = torch.linalg.norm(v, dim=-2, keepdim=True)
  else:
    valid = valid_mask(v.shape[-2], n_valid, v.device)[..., :, None]
    norms = torch.linalg.norm(torch.where(valid, v, 0.0), dim=-2,
                              keepdim=True)
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

  A (B, N, N) batch is copied to the host once, decomposed one matrix
  after another (JAX's ``vmap_method="sequential"``) and copied back once;
  each matrix gets what it gets alone.
  """
  host = mat.detach().cpu().numpy().astype(np.float64)
  pairs = [np.linalg.eig(m) for m in host.reshape((-1,) + host.shape[-2:])]
  w = np.stack([p[0].real for p in pairs]).astype(np.float32).reshape(
      host.shape[:-1])
  v = np.stack([p[1].real for p in pairs]).astype(np.float32).reshape(
      host.shape)
  w, v = _sort_eigs(torch.from_numpy(w).to(mat.dtype),
                    torch.from_numpy(v).to(mat.dtype), descend)
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
    valid = valid_mask(w.shape[-1], n_valid, w.device)
  if wmax is None:
    wmax = torch.amax(torch.where(valid, torch.abs(w), 0.0), dim=-1,
                      keepdim=True)
  else:
    wmax = per_matrix(wmax, 2)
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
  n = eigenvalues.shape[-1]
  batch = eigenvalues.shape[:-1]
  range_end = n
  if max_clusters and max_clusters + 1 < range_end:
    range_end = max_clusters + 1
  zero = (torch.zeros(batch, dtype=torch.int32, device=dev),
          torch.zeros(batch, dtype=eigenvalues.dtype, device=dev))

  idx = torch.arange(n, device=dev)
  n_valid_arr = per_matrix(torch.as_tensor(n if n_valid is None else n_valid,
                                           dtype=torch.int32, device=dev), 2)

  def norm_max():
    if wmax is not None:
      return per_matrix(wmax, 2)
    return torch.amax(torch.where(idx < n_valid_arr, eigenvalues, -torch.inf),
                      dim=-1, keepdim=True)

  if descend:
    if n < 2:
      return zero
    lead = eigenvalues[..., :-1]      # w[i-1] for i = 1..n-1
    lag = eigenvalues[..., 1:]        # w[i]
    # Break: iteration i runs only while all previous w[j-1] >= stop.
    alive = torch.cumprod((lead >= stop_eigenvalue).to(torch.int32), -1) > 0
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
    cur = eigenvalues[..., 1:-1]      # w[i] for i = 1..n-2
    nxt = eigenvalues[..., 2:]        # w[i+1]
    pos = idx[1:-1]              # the loop variable i
    in_range = (pos < range_end - 1) & (pos + 1 < n_valid_arr)
    if eigengap_type == EigenGapType.Ratio:
      delta = nxt / (cur + eps)
    else:
      delta = (nxt - cur) / norm_max()
    masked = torch.where(in_range, delta, -torch.inf)
    offset = 2                   # index i means i+1 clusters
  best = torch.amax(masked, dim=-1)
  # torch.argmax returns the first maximal index, as jnp.argmax does.
  best_i = torch.argmax(masked, dim=-1) + offset
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
  n = mat.shape[-1]
  idx = torch.arange(n, device=mat.device)
  v = valid_mask(n, n_valid, mat.device)
  keep = v[..., :, None] & v[..., None, :]
  out = torch.where(keep, mat, 0.0)
  bound = torch.amax(torch.sum(torch.where(keep, torch.abs(out), 0.0),
                               dim=-1), dim=-1, keepdim=True)
  base = 1.25 * bound + 1.0
  step = 0.01 * bound + 0.01
  sign = -1.0 if descend else 1.0
  sentinels = sign * (base + idx.to(mat.dtype) * step)
  diag = torch.diagonal(out, dim1=-2, dim2=-1)
  diag_vals = torch.where(v, diag, sentinels)
  return out - torch.diag_embed(diag) + torch.diag_embed(diag_vals)


# ---------------------------------------------------------------------------
# Top-k eigensolver.
# ---------------------------------------------------------------------------


def panel_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """aᵀ b of two float32 panels, (N, p) and (N, r) -> (p, r), or a (B, ·)
  batch of both: the subspace solver's Grams (CholeskyQR2's and the
  Rayleigh–Ritz matrix).

  On the card the float64 product of the float32 inputs, rounded once to
  float32: each product is exact and the sum float64, as in
  ``kernels.fused.panel_matmul``; cuBLAS's float32 sum is too coarse for
  the certified route's stop test. The casts move a few MB at b ≤ 16. On
  the CPU the float32 product, whose bits the CPU path keeps.
  """
  at = a.transpose(-1, -2)
  if a.is_cuda:
    return torch.matmul(at.double(), b.double()).float()
  return torch.matmul(at, b)


def cholqr2_shifted(y: torch.Tensor) -> torch.Tensor:
  """Orthonormalize a tall-skinny panel with shift-stabilized CholeskyQR2.

  Matmul-only apart from an O(b³) Cholesky and triangular solve on the
  (b, b) Gram. The 1e-6 shift keeps Cholesky from breaking down on an
  ill-conditioned panel; the second pass restores orthogonality. When a
  pass still fails (a rank-collapsed panel can push the shifted Gram
  indefinite), it is redone with a 1e-2 shift, which is always positive
  definite. ``cholesky_ex`` reports the failure in ``info`` instead of
  raising; both passes are computed and selected on the device, so no host
  sync is needed. A (B, N, b) stack of panels is orthonormalized panel by
  panel: each one's rescue is decided by its own ``info`` and values, as
  under JAX's vmap. The Gram is ``panel_gram`` and each pass
  ``kernels.fused.cholqr_pass``: its twin on the CPU, the kernel on the
  card.
  """
  for _ in range(2):
    gram = panel_gram(y, y)
    y1, info = fused.cholqr_pass(y, gram, 1e-6)
    ok = (info == 0) & torch.all(torch.isfinite(y1), dim=(-2, -1))
    y2, _ = fused.cholqr_pass(y, gram, 1e-2)
    y = torch.where(ok[..., None, None], y1, y2)
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
    stats: typing.Optional[dict] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """topk_eigh_subspace on the VALID block of a sentinel-padded matrix.

  The pad block is rebuilt as exact zeros, so padded coordinates are never
  amplified by the power iteration. For the ascending case its diagonal is
  set to the valid block's Gershgorin bound + 1 (just past the scan end) and
  the shift comes from that bound, so the valid spectrum keeps a healthy
  separation. A (B, N, N) batch takes a (B,) ``n_valid``, with a bound and
  a shift per matrix.
  """
  kw = dict(num_iters=num_iters, residual_tol=residual_tol,
            max_iters=max_iters, drift_tol=drift_tol, stats=stats)
  if n_valid is None:
    return topk_eigh_subspace(mat, k, generator, largest=largest, **kw)
  v = valid_mask(mat.shape[-1], n_valid, mat.device)
  keep = v[..., :, None] & v[..., None, :]
  mm = torch.where(keep, mat, 0.0)
  if largest:
    return topk_eigh_subspace(mm, k, generator, largest=True, **kw)
  bound = torch.amax(torch.sum(torch.abs(mm), dim=-1), dim=-1)
  shift = bound + 1.0
  op_m = mm + torch.diag_embed(torch.where(v, 0.0, shift[..., None]))
  return topk_eigh_subspace(op_m, k, generator, largest=False, shift=shift,
                            **kw)


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
  drift_tol·max|λ| over the last chunk. The host reads whether to go on
  once per chunk. A ``stats`` dict receives the number of iterations run
  under "iters" and, with ``residual_tol``, the residual after the first
  ``num_iters`` and after each chunk under "res" (floats; per chunk a list
  over the batch for a (B, N, N) batch).

  Every (N, N) by (N, b) product is ``kernels.fused.panel_matmul`` and
  every Gram of two panels ``panel_gram`` (CholeskyQR2's passes are
  ``kernels.fused.cholqr_pass``): on the CPU the kernels' twins and the
  float32 Gram, on the card the hand-written kernels and the float64
  Gram.

  A (B, N, N) batch (``shift`` then None or (B,)) is JAX's vmap of this
  solver: (B, N, b) panels from the one start panel, and each matrix keeps
  its own residual, drift and iteration count. The chunks go on while any
  matrix's condition holds; a matrix whose condition fails keeps its panel
  from then on, so each gets what it gets alone. Returns (B, k) and
  (B, N, k); "iters" is then a (B,) tensor.
  """
  n = mat.shape[-1]
  b = min(n, k + oversample)
  if not largest:
    if shift is None:
      shift = torch.amax(torch.sum(torch.abs(mat), dim=-1), dim=-1)
    s = shift[..., None, None] if isinstance(shift, torch.Tensor) else shift
    op = lambda x: s * x - fused.panel_matmul(mat, x)
  else:
    op = lambda x: fused.panel_matmul(mat, x)

  def iterate(q, steps):
    for _ in range(steps):
      q = cholqr2_shifted(op(q))
    return q

  def rayleigh_ritz(q):
    """Ritz pairs of the ORIGINAL matrix + worst relative top-k residual."""
    mq = fused.panel_matmul(mat, q)
    t = panel_gram(q, mq)
    t = 0.5 * (t + t.transpose(-1, -2))
    # The (b, b) Ritz problem is solved in float64: once the basis has
    # collapsed onto a low-rank top, t carries float32 denormals, on which
    # torch's float32 eigh fails to converge and raises (JAX's returns).
    w_small, u_small = torch.linalg.eigh(t.double())
    w_small, u_small = w_small.to(t.dtype), u_small.to(t.dtype)
    if largest:
      w_small, u_small = torch.flip(w_small, (-1,)), torch.flip(u_small,
                                                                (-1,))
    v = q @ u_small[..., :k]
    mv = mq @ u_small[..., :k]
    res = torch.linalg.norm(mv - v * w_small[..., None, :k], dim=-2)
    scale = torch.clamp_min(torch.amax(torch.abs(w_small), dim=-1), 1e-30)
    return w_small[..., :k], v, torch.amax(res, dim=-1) / scale

  q = cholqr2_shifted(start_panel(n, b, generator, mat.dtype, mat.device))
  q = iterate(q.expand(mat.shape[:-2] + q.shape), num_iters)
  it = torch.full(mat.shape[:-2], num_iters, device=mat.device)

  if residual_tol is not None:
    dtol = -1.0 if drift_tol is None else drift_tol
    w_prev, _, res = rayleigh_ritz(q)
    drift = torch.full_like(res, torch.inf)

    def going_on():
      # Compared in float64, as a host float would be.
      return ((res.double() > residual_tol) & (drift.double() > dtol)
              & (it < max_iters))

    trace = [res]
    going = going_on()
    while bool(torch.any(going)):
      q_new = iterate(q, num_iters)
      w_new, _, res_new = rayleigh_ritz(q_new)
      scale = torch.clamp_min(torch.amax(torch.abs(w_new), dim=-1), 1e-30)
      drift_new = torch.amax(torch.abs(w_new - w_prev), dim=-1) / scale
      # A matrix whose condition failed keeps its state.
      q = torch.where(going[..., None, None], q_new, q)
      w_prev = torch.where(going[..., None], w_new, w_prev)
      res = torch.where(going, res_new, res)
      drift = torch.where(going, drift_new, drift)
      it = torch.where(going, it + num_iters, it)
      trace.append(res)
      going = going_on()
    if stats is not None:
      stats["res"] = torch.stack(trace).cpu().tolist()
  if stats is not None:
    stats["iters"] = int(it) if mat.dim() == 2 else it
  w, v, _ = rayleigh_ritz(q)
  return w, v


def _cholqr2_sharded(group, ys):
  """``cholqr2_shifted`` on a panel split by rows over ``group``: the
  (b, b) Gram is all-reduced, and each shard factors it (the same factor
  on every shard) and solves its own rows (``kernels.fused.cholqr_pass``).
  The 1e-2 rescue is taken when any shard's rows of the 1e-6 pass are not
  finite."""

  def one_pass(ys, gram, delta_rel):
    out = [fused.cholqr_pass(y, gram.to(y.device), delta_rel) for y in ys]
    return [q for q, _ in out], out[0][1]

  for _ in range(2):
    gram = group.all_reduce([panel_gram(y, y) for y in ys])
    y1, info = one_pass(ys, gram, 1e-6)
    bad = group.all_reduce(
        [(~torch.all(torch.isfinite(y))).to(y.dtype) for y in y1], "max")
    ok = (info.to(bad.device) == 0) & (bad == 0)
    y2, _ = one_pass(ys, gram, 1e-2)
    ys = [torch.where(ok.to(a.device), a, c) for a, c in zip(y1, y2)]
  return ys


def topk_eigh_subspace_sharded(
    group,
    stripes: typing.List[torch.Tensor],
    k: int,
    generator: torch.Generator,
    largest: bool,
    n_valid=None,
    num_iters: int = 24,
    oversample: int = 8,
    residual_tol: typing.Optional[float] = None,
    max_iters: int = 384,
    stats: typing.Optional[dict] = None,
) -> typing.Tuple[torch.Tensor, typing.List[torch.Tensor]]:
  """``topk_eigh_subspace_masked`` on an (N, N) matrix held as row stripes.

  ``group`` is a shard group of ``parallel/collectives.py`` and
  ``stripes`` this process's (N/P, N) stripes, shard r holding rows
  [r·N/P, (r+1)·N/P). The pad block is rebuilt as exact zeros, and
  ascending its diagonal is the valid Gershgorin bound + 1, as in the
  masked solver. Each iteration multiplies every stripe by the
  all-gathered (N, b) panel and orthonormalizes with an all-reduced Gram
  (``_cholqr2_sharded``); the Rayleigh–Ritz matrix and the residual norms
  are all-reduced too, and the residual is read on the host once per
  chunk, as ``topk_eigh_subspace`` does. The start panel is the full
  ``start_panel(N, b, generator)``, each shard taking its rows, so any
  number of shards starts from the same panel. Returns (the k eigenvalues,
  replicated; this process's stripes of the (N, k) eigenvectors). A
  ``stats`` dict receives "iters" and the final "residual".
  """
  n = stripes[0].shape[1]
  m = n // group.size
  offsets = [s * m for s in group.shards]
  dtype = stripes[0].dtype

  def rows(i, dev):
    return torch.arange(offsets[i], offsets[i] + m, device=dev)

  def diagonal(i, x, values):
    eye = rows(i, x.device)[:, None] == torch.arange(n, device=x.device)
    return torch.where(eye, values[:, None], 0.0)

  mats = stripes
  if n_valid is not None:
    cols = [torch.arange(n, device=x.device) < n_valid for x in stripes]
    mats = [torch.where((rows(i, x.device) < n_valid)[:, None] & c[None, :],
                        x, 0.0) for i, (x, c) in enumerate(zip(stripes,
                                                                cols))]
  shift = None
  if not largest:
    shift = group.all_reduce(
        [torch.amax(torch.sum(torch.abs(x), dim=1)) for x in mats], "max")
    if n_valid is not None:
      shift = shift + 1.0
      mats = [x + diagonal(i, x, torch.where(rows(i, x.device) < n_valid,
                                             0.0, shift.to(x.device)))
              for i, x in enumerate(mats)]

  def matmul(q):
    panel = group.all_gather(q)
    return [fused.panel_matmul(x, panel.to(x.device)) for x in mats]

  def op(q):
    mq = matmul(q)
    if largest:
      return mq
    return [shift.to(a.device) * a - b for a, b in zip(q, mq)]

  def iterate(q, steps):
    for _ in range(steps):
      q = _cholqr2_sharded(group, op(q))
    return q

  def rayleigh_ritz(q):
    mq = matmul(q)
    t = group.all_reduce([panel_gram(a, b) for a, b in zip(q, mq)])
    t = 0.5 * (t + t.T)
    # float64, as in topk_eigh_subspace.
    w_small, u_small = torch.linalg.eigh(t.double())
    w_small, u_small = w_small.to(t.dtype), u_small.to(t.dtype)
    if largest:
      w_small, u_small = torch.flip(w_small, (0,)), torch.flip(u_small, (1,))
    v = [a @ u_small[:, :k].to(a.device) for a in q]
    sq = group.all_reduce([
        torch.sum((b @ u_small[:, :k].to(b.device)
                   - a * w_small[None, :k].to(a.device)) ** 2, dim=0)
        for a, b in zip(v, mq)])
    scale = torch.clamp_min(torch.amax(torch.abs(w_small)), 1e-30)
    return w_small[:k], v, torch.amax(torch.sqrt(sq)) / scale

  b = min(n, k + oversample)
  panel = start_panel(n, b, generator, dtype, "cpu")
  q = [panel[o:o + m].to(x.device) for o, x in zip(offsets, stripes)]
  q = iterate(_cholqr2_sharded(group, q), num_iters)
  it = num_iters
  if residual_tol is not None:
    _, _, res = rayleigh_ritz(q)
    while float(res) > residual_tol and it < max_iters:
      q = iterate(q, num_iters)
      _, _, res = rayleigh_ritz(q)
      it += num_iters
  w, v, res = rayleigh_ritz(q)
  if stats is not None:
    stats["iters"] = it
    stats["residual"] = float(res)
  return w, v
