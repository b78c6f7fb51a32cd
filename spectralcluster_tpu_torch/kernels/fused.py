"""The hand-written CUDA kernels of the refinement hot path, with their twins.

Five wrappers, one per Pallas kernel of the JAX package
(``spectralcluster_tpu/kernels/fused.py``):

  * ``affinity`` — cosine affinity ``(xn xnᵀ + 1) / 2`` (affinity_pallas);
  * ``row_max`` — row max over the first ``n_valid`` columns, optionally
    with the diagonal counted as 0 (row_max_pallas);
  * ``crop_diagonal`` — CropDiagonal, fused row max + diagonal write, in
    place when the caller allows it (crop_diagonal_pallas);
  * ``threshold_symmetrize_general`` — RowWiseThreshold + Symmetrize in one
    pass over tile pairs (threshold_symmetrize_general_pallas);
  * ``row_wise_normalize`` — RowWiseNormalize ``A / rowmax(A)``, row max
    and division fused (row_wise_normalize_pallas). Only the GENERAL
    symmetry structure reaches it (EigenSolver.HostGeneral, or a sequence
    that the symmetric eigensolvers cannot absorb).

and two kernels that replace no Pallas kernel, the subspace solver's
product and its orthonormalization, which the JAX package leaves to XLA:

  * ``panel_matmul`` — ``mat @ x`` of an (N, N) operand (or a row stripe
    of one) by its (N, b) panel, from float32 inputs, each output a
    float64 sum of exact products rounded once to float32;
  * ``cholqr_pass`` — one shifted CholeskyQR pass of a panel given its
    Gram: the (b, b) Cholesky of the shifted Gram and the triangular solve
    of every row, rounded as LAPACK's float32 routines round;
    ``cholqr_pass_pair`` the pass at two shifts in one launch, with a flag
    per panel for whether the first failed (what CholeskyQR2 runs);

and one that replaces the JAX package's whole ``kmeans_fit`` with the
cosine metric, which it leaves to XLA:

  * ``kmeans`` — k-means++ seeding from JAX's threefry stream, drawn on
    the card, and the cosine Lloyd loop with the reference's stop rule, one
    launch for one utterance or a batch, ending at the stopping round.

On the card cuBLAS's and cuSOLVER's float32 routines for these shapes
round so that the certified top-k route of ``ops/dc.py`` did not stop
where the same code stops on the CPU (``csrc/fused.cu`` says how; the
solver's Grams are ``ops.eigen.panel_gram``).

Each kernel also has a batched wrapper (``affinity_batched``,
``row_max_batched``, ``crop_diagonal_batched``,
``threshold_symmetrize_general_batched``, ``row_wise_normalize_batched``):
the JAX package's ``vmap`` of each ``pallas_call`` in its batched step, one
launch for a (B, N, ·) chunk, with ``n_valid`` a (B,) integer tensor that
the kernel reads on the device.

The kernels are in ``csrc/fused.cu``, whose comments give each one's bound on
the H100 and what its design does about it. Each wrapper has a plain
PyTorch twin (``*_plain``) in this module that defines its semantics; the
twins take an optional leading batch axis, with ``n_valid`` then one entry
per matrix, and serve the 2-D and the batched wrappers alike. A
wrapper takes the twin only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises, and never falls back. Each wrapper carries a
plain integer ``launches`` that it increments where it launches its kernel
and nowhere else, by the number of kernels launched (``panel_matmul``
launches one per 32 columns of its panel; ``reset_launch_counts`` /
``launch_counts``).
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from spectralcluster_tpu_torch import utils


def _lib():
  from spectralcluster_tpu_torch.kernels import build
  return build.load()


def _is_cpu(t: torch.Tensor) -> bool:
  if t.is_cuda:
    return False
  if t.device.type != "cpu":
    raise ValueError(f"unsupported device {t.device}: expected cpu or cuda")
  return True


def _check_f32(name: str, t: torch.Tensor, shape: typing.Tuple[int, ...]):
  if t.dtype != torch.float32:
    raise TypeError(f"{name}: expected float32, got {t.dtype}")
  if tuple(t.shape) != shape:
    raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name}: expected a contiguous tensor")


def _square(name: str, mat: torch.Tensor) -> int:
  if mat.dim() != 2 or mat.shape[0] != mat.shape[1]:
    raise ValueError(f"{name}: expected a square matrix, got "
                     f"{tuple(mat.shape)}")
  n = mat.shape[0]
  _check_f32(name, mat, (n, n))
  return n


def _n_valid(n: int, n_valid) -> int:
  return n if n_valid is None else max(0, min(n, int(n_valid)))


def _column_limit(n: int, n_valid):
  """The twins' column bound: an int for one matrix, or for a batch (B,)
  entries clamped to [0, n] and shaped (B, 1, 1) to broadcast over rows
  and columns."""
  if isinstance(n_valid, torch.Tensor) and n_valid.dim() > 0:
    return torch.clamp(n_valid, 0, n)[:, None, None]
  return _n_valid(n, n_valid)


def _batch_of_squares(name: str, mat: torch.Tensor) -> typing.Tuple[int, int]:
  if mat.dim() != 3 or mat.shape[1] != mat.shape[2]:
    raise ValueError(f"{name}: expected a (B, N, N) batch, got "
                     f"{tuple(mat.shape)}")
  b, n, _ = mat.shape
  _check_f32(name, mat, (b, n, n))
  return b, n


def _device_n_valid(name: str, b: int, n: int, n_valid,
                    device: torch.device) -> torch.Tensor:
  """(B,) int32 n_valid on ``device``, as the batched kernels read it;
  None means every row and column is valid. No value is read on the
  host."""
  if n_valid is None:
    return torch.full((b,), n, dtype=torch.int32, device=device)
  if not isinstance(n_valid, torch.Tensor) or tuple(n_valid.shape) != (b,):
    raise ValueError(f"{name}: n_valid must be a ({b},) tensor")
  if n_valid.dtype not in (torch.int32, torch.int64):
    raise TypeError(f"{name}: n_valid must be an integer tensor")
  return n_valid.to(device=device, dtype=torch.int32).contiguous()


def _vec(mat: torch.Tensor) -> int:
  """Whether rows can be read as float4: 16-byte aligned row starts."""
  return int(mat.shape[1] % 4 == 0 and mat.data_ptr() % 16 == 0)


# The library's entry points, looked up once: the solver's kernels run
# for a few microseconds, so the host's work per call counts.
_ENTRIES: typing.Dict[str, typing.Any] = {}


def _launch(fn_name: str, *args):
  fn = _ENTRIES.get(fn_name)
  if fn is None:
    fn = _ENTRIES.setdefault(fn_name, getattr(_lib(), fn_name))
  rc = fn(*args)
  if rc != 0:
    msg = _lib().sct_error_string(rc).decode()
    raise RuntimeError(f"{fn_name}: CUDA error {rc}: {msg}")


def _stream(t: torch.Tensor) -> int:
  """The current CUDA stream of t's card, as a pointer. The raw query
  takes a fraction of a microsecond where building a torch.cuda.Stream
  takes several: the batched kernels run for tens of microseconds, and
  back-to-back calls keep the card busy only while the host's work per
  call stays under that."""
  return torch._C._cuda_getCurrentRawStream(t.get_device())


# ---------------------------------------------------------------------------
# Plain twins (the semantics; the CPU path; the reference on the card).
# ---------------------------------------------------------------------------


def normalize_rows(embeddings: torch.Tensor) -> torch.Tensor:
  return embeddings / torch.linalg.norm(embeddings, dim=-1, keepdim=True)


def affinity_plain(embeddings: torch.Tensor) -> torch.Tensor:
  """(N, d) -> (N, N), or (B, N, d) -> (B, N, N)."""
  xn = normalize_rows(embeddings)
  return (torch.matmul(xn, xn.transpose(-1, -2)) + 1.0) * 0.5


def row_max_plain(mat: torch.Tensor, exclude_diagonal: bool = False,
                  n_valid=None) -> torch.Tensor:
  """(N, 1) row maxima over columns < n_valid; (B, N, 1) for a (B, N, N)
  batch, with n_valid None or (B,).

  With ``exclude_diagonal`` the diagonal counts as 0 — set after the column
  mask, so rows >= n_valid get max(0, their valid-column max), exactly as
  row_max_pallas computes it. Callers re-mask padded rows.
  """
  n = mat.shape[-1]
  idx = torch.arange(n, device=mat.device)
  a = torch.where(idx < _column_limit(n, n_valid), mat, -torch.inf)
  if exclude_diagonal:
    a = torch.where(idx[:, None] == idx[None, :], 0.0, a)
  return torch.amax(a, dim=-1, keepdim=True)


def crop_diagonal_plain(mat: torch.Tensor, n_valid=None) -> torch.Tensor:
  """diag <- off-diagonal row max (diagonal counted as 0); rest copied."""
  rmax = row_max_plain(mat, exclude_diagonal=True, n_valid=n_valid)
  out = mat.clone()
  out.diagonal(dim1=-2, dim2=-1).copy_(rmax[..., 0])
  return out


def threshold_symmetrize_general_plain(
    mat: torch.Tensor, thresholds: torch.Tensor, multiplier: float = 0.01,
    binarize: bool = False, preserve_diagonal: bool = False,
    average: bool = False) -> torch.Tensor:
  """Sym(T(A), T(A)ᵀ) with T the per-row soft threshold; ``thresholds``
  is (N, 1), or (B, N, 1) for a (B, N, N) batch."""
  a, at = mat, mat.transpose(-1, -2)
  if preserve_diagonal:
    eye = torch.eye(mat.shape[-1], dtype=torch.bool, device=mat.device)
    a = torch.where(eye, 0.0, a)
    at = torch.where(eye, 0.0, at)

  def thresh(x, m):
    return torch.where(x < m, x * multiplier, 1.0 if binarize else x)

  ta = thresh(a, thresholds)
  tat = thresh(at, thresholds.transpose(-1, -2))
  out = 0.5 * (ta + tat) if average else torch.maximum(ta, tat)
  if preserve_diagonal:
    out = torch.where(eye, 1.0, out)
  return out


def panel_matmul_plain(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """mat @ x: (M, K) by (K, b) -> (M, b), or a (B, ·) batch of both."""
  return torch.matmul(mat, x)


def cholqr_pass_plain(y: torch.Tensor, gram: torch.Tensor,
                      delta_rel: float) -> typing.Tuple[torch.Tensor,
                                                        torch.Tensor]:
  """One shifted CholeskyQR pass: (y L⁻ᵀ, info) for L Lᵀ = gram + δ·I,
  δ = delta_rel·max(diag gram); ``info`` is ``cholesky_ex``'s (0 where the
  factorization succeeded). A (B, N, b) batch takes (B, b, b) Grams."""
  eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
  delta = delta_rel * torch.clamp_min(
      torch.amax(torch.diagonal(gram, dim1=-2, dim2=-1), dim=-1), 1e-30)
  r, info = torch.linalg.cholesky_ex(gram + delta[..., None, None] * eye)
  q = torch.linalg.solve_triangular(r, y.transpose(-1, -2), upper=False)
  return q.transpose(-1, -2), info


def cholqr_pass_pair_plain(
    y: torch.Tensor, gram: torch.Tensor, delta_rel: float, rescue_rel: float
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """The pass at ``delta_rel`` and at ``rescue_rel`` (two
  ``cholqr_pass_plain`` calls): (q, q_rescue, info, bad), ``info`` the
  first pass's and ``bad`` True for a panel whose first pass failed or
  left a non-finite value ((B,) for a batch)."""
  q, info = cholqr_pass_plain(y, gram, delta_rel)
  q_rescue, _ = cholqr_pass_plain(y, gram, rescue_rel)
  bad = (info != 0) | ~torch.all(torch.isfinite(q), dim=(-2, -1))
  return q, q_rescue, info, bad


def row_wise_normalize_plain(mat: torch.Tensor, n_valid=None) -> torch.Tensor:
  """Every entry divided by its row's max over columns < n_valid.

  Rows >= n_valid are divided by their valid-column max too, as
  row_wise_normalize_pallas does; callers re-mask padding. A row whose
  valid max is 0 gives NaN, as the division does there. A (B, N, N) batch
  takes n_valid None or (B,).
  """
  return mat / row_max_plain(mat, n_valid=n_valid)


def kmeans_plain(x: torch.Tensor, n_clusters, keys, k_max: int,
                 sample_weight: typing.Optional[torch.Tensor] = None,
                 draw_rows: typing.Optional[int] = None, max_iter: int = 10,
                 tol: float = 0.001
                 ) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """K-Means with the cosine metric: ``ops.kmeans``' k-means++ of k_max
  centres, then its Lloyd loop. x (N, d) with one raw ``prng`` key (2,),
  or (B, N, d) with (B, 2) keys; n_clusters an int, a 0-dim or a (B,)
  tensor; sample_weight (N,) or (B, N), default ones; the draws over
  ``draw_rows`` rows, default ``utils.pad_bucket(N)``. Returns (labels
  int32, centroids (..., k_max, d), rounds int32 (...)): the labels of the
  stopping round, the centroids it stopped with, and its number of
  assignment rounds, the stopping one included."""
  from spectralcluster_tpu_torch.ops import affinity as affinity_ops
  from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops
  w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) if (
      sample_weight is None) else sample_weight
  rows = utils.pad_bucket(x.shape[-2]) if draw_rows is None else draw_rows
  keys = np.asarray(keys, np.uint32).reshape(-1, 2)
  centroids = kmeans_ops._plusplus(x, k_max, keys, w, rows)
  return kmeans_ops._lloyd(x, centroids, n_clusters, affinity_ops.cdist_cosine,
                           max_iter, tol, w)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


# The 2-D affinity kernel's operand units (kAffTile, kAffDepth in
# csrc/fused.cu): it takes xnᵀ zero-padded to whole 128-column tiles and
# 16-deep k slices, and refuses any other padding.
AFFINITY_TILE = 128
AFFINITY_DEPTH = 16
# The columns of one panel_matmul launch (kPanelCols in csrc/fused.cu).
PANEL_COLS = 32


def affinity_operand(xn: torch.Tensor) -> torch.Tensor:
  """xnᵀ, (d_pad, n_pad), zero-padded to the 2-D kernel's tile and k-slice
  units ((B, d_pad, n_pad) for a (B, N, d) batch).

  The padding adds exact zeros to each dot product, and rows past N are
  never stored, so the kernel needs no masks on its loads.
  """
  n, d = xn.shape[-2:]
  n_pad = -(-n // AFFINITY_TILE) * AFFINITY_TILE
  d_pad = -(-d // AFFINITY_DEPTH) * AFFINITY_DEPTH
  if (n_pad, d_pad) == (n, d):
    return xn.transpose(-1, -2).contiguous()
  xt = xn.new_zeros(xn.shape[:-2] + (d_pad, n_pad))
  xt[..., :d, :n] = xn.transpose(-1, -2)
  return xt


def row_major_operand(xn: torch.Tensor) -> torch.Tensor:
  """The batched kernel's operand: xn (B, N, d) as it is where d % 4 == 0,
  else zero-padded to whole float4s (its rows start 16-byte aligned)."""
  if xn.shape[-1] % 4:
    xn = torch.nn.functional.pad(xn, (0, -xn.shape[-1] % 4))
  return xn.contiguous()


def affinity(embeddings: torch.Tensor) -> torch.Tensor:
  """Cosine affinity in [0, 1] of (N, d) float32 embeddings -> (N, N).

  The row normalization and the transposed, padded operand stay plain torch
  (jnp outside the TPU kernel too); the product and the affine step are the
  kernel's, which computes one triangle of tiles and mirrors it.
  """
  if _is_cpu(embeddings):
    return affinity_plain(embeddings)
  if embeddings.dim() != 2:
    raise ValueError("affinity: expected (N, d) embeddings")
  n, d = embeddings.shape
  _check_f32("affinity", embeddings, (n, d))
  xt = affinity_operand(normalize_rows(embeddings))
  out = torch.empty((n, n), dtype=torch.float32, device=embeddings.device)
  if n:
    _launch("sct_affinity", xt.data_ptr(), out.data_ptr(), n, xt.shape[1],
            xt.shape[0], _stream(embeddings))
    affinity.launches += 1
  return out


def row_max(mat: torch.Tensor, exclude_diagonal: bool = False,
            n_valid=None) -> torch.Tensor:
  """(N, 1) row maxima over the first ``n_valid`` columns (see the twin)."""
  if _is_cpu(mat):
    return row_max_plain(mat, exclude_diagonal, n_valid)
  n = _square("row_max", mat)
  out = torch.empty((n, 1), dtype=torch.float32, device=mat.device)
  if n:
    _launch("sct_row_max", mat.data_ptr(), out.data_ptr(), n,
            _n_valid(n, n_valid), int(exclude_diagonal), _vec(mat),
            _stream(mat))
    row_max.launches += 1
  return out


def crop_diagonal(mat: torch.Tensor, n_valid=None,
                  inplace: bool = False) -> torch.Tensor:
  """CropDiagonal: diag <- max of the row's other valid entries (and 0).

  With ``inplace`` on the card, ``mat`` itself is overwritten (only its
  diagonal changes) and returned: the caller must not need its old
  diagonal. On the CPU a new tensor is always returned.
  """
  if _is_cpu(mat):
    return crop_diagonal_plain(mat, n_valid)
  n = _square("crop_diagonal", mat)
  out = mat if inplace else torch.empty_like(mat)
  if n:
    _launch("sct_crop_diagonal", mat.data_ptr(), out.data_ptr(), n,
            _n_valid(n, n_valid), _vec(mat) & _vec(out), _stream(mat))
    crop_diagonal.launches += 1
  return out


def threshold_symmetrize_general(
    mat: torch.Tensor, thresholds: torch.Tensor, multiplier: float = 0.01,
    binarize: bool = False, preserve_diagonal: bool = False,
    average: bool = False) -> torch.Tensor:
  """RowWiseThreshold + Symmetrize in one pass; ``thresholds`` is (N, 1)."""
  if _is_cpu(mat):
    return threshold_symmetrize_general_plain(
        mat, thresholds, multiplier, binarize, preserve_diagonal, average)
  n = _square("threshold_symmetrize_general", mat)
  _check_f32("threshold_symmetrize_general thresholds", thresholds, (n, 1))
  if thresholds.device != mat.device:
    raise ValueError("threshold_symmetrize_general: thresholds on "
                     f"{thresholds.device}, matrix on {mat.device}")
  out = torch.empty_like(mat)
  if n:
    _launch("sct_threshold_symmetrize", mat.data_ptr(), thresholds.data_ptr(),
            out.data_ptr(), n, float(multiplier), int(binarize),
            int(preserve_diagonal), int(average), _stream(mat))
    threshold_symmetrize_general.launches += 1
  return out


def row_wise_normalize(mat: torch.Tensor, n_valid=None) -> torch.Tensor:
  """RowWiseNormalize ``A / rowmax(A)`` (see the twin); callers re-mask."""
  if _is_cpu(mat):
    return row_wise_normalize_plain(mat, n_valid)
  n = _square("row_wise_normalize", mat)
  out = torch.empty_like(mat)
  if n:
    _launch("sct_row_wise_normalize", mat.data_ptr(), out.data_ptr(), n,
            _n_valid(n, n_valid), _vec(mat) & _vec(out), _stream(mat))
    row_wise_normalize.launches += 1
  return out


def affinity_batched(embeddings: torch.Tensor) -> torch.Tensor:
  """Cosine affinities of a (B, N, d) float32 batch -> (B, N, N), one launch
  for the batch (kernel 1b).

  The row normalization stays plain torch, as in ``affinity``; the kernel
  reads the normalized rows as they are, row-major, with no transposed
  operand. Where d % 4 != 0 they are zero-padded to whole float4s (exact
  zeros in each dot product).
  """
  if _is_cpu(embeddings):
    return affinity_plain(embeddings)
  if embeddings.dim() != 3:
    raise ValueError("affinity_batched: expected (B, N, d) embeddings")
  b, n, d = embeddings.shape
  _check_f32("affinity_batched", embeddings, (b, n, d))
  xn = row_major_operand(normalize_rows(embeddings))
  out = torch.empty((b, n, n), dtype=torch.float32, device=embeddings.device)
  if b and n:
    _launch("sct_affinity_batched", xn.data_ptr(), out.data_ptr(), b, n,
            xn.shape[2], _stream(embeddings))
    affinity_batched.launches += 1
  return out


def row_max_batched(mat: torch.Tensor, exclude_diagonal: bool = False,
                    n_valid=None) -> torch.Tensor:
  """(B, N, 1) row maxima of a (B, N, N) batch, each matrix over its first
  ``n_valid[b]`` columns; ``n_valid`` is None or a (B,) integer tensor.

  With ``n_valid`` None the kernel gets no n_valid array (every column is
  valid) and the wrapper launches nothing else: its host work per call
  stays under the kernel's 25 µs at (16, 1024), so back-to-back calls keep
  the card busy.
  """
  if _is_cpu(mat):
    return row_max_plain(mat, exclude_diagonal, n_valid)
  b, n = _batch_of_squares("row_max_batched", mat)
  nv = (None if n_valid is None else
        _device_n_valid("row_max_batched", b, n, n_valid, mat.device))
  out = mat.new_empty((b, n, 1))
  if b and n:
    _launch("sct_row_max_batched", mat.data_ptr(), out.data_ptr(), b, n,
            None if nv is None else nv.data_ptr(), int(exclude_diagonal),
            _vec(mat), _stream(mat))
    row_max_batched.launches += 1
  return out


def crop_diagonal_batched(mat: torch.Tensor, n_valid=None,
                          inplace: bool = False) -> torch.Tensor:
  """CropDiagonal of each matrix of a (B, N, N) batch (see
  ``crop_diagonal``; ``n_valid`` None or (B,))."""
  if _is_cpu(mat):
    return crop_diagonal_plain(mat, n_valid)
  b, n = _batch_of_squares("crop_diagonal_batched", mat)
  nv = _device_n_valid("crop_diagonal_batched", b, n, n_valid, mat.device)
  out = mat if inplace else torch.empty_like(mat)
  if b and n:
    _launch("sct_crop_diagonal_batched", mat.data_ptr(), out.data_ptr(), b,
            n, nv.data_ptr(), _vec(mat) & _vec(out), _stream(mat))
    crop_diagonal_batched.launches += 1
  return out


def threshold_symmetrize_general_batched(
    mat: torch.Tensor, thresholds: torch.Tensor, multiplier: float = 0.01,
    binarize: bool = False, preserve_diagonal: bool = False,
    average: bool = False) -> torch.Tensor:
  """RowWiseThreshold + Symmetrize of each matrix of a (B, N, N) batch;
  ``thresholds`` is (B, N, 1)."""
  if _is_cpu(mat):
    return threshold_symmetrize_general_plain(
        mat, thresholds, multiplier, binarize, preserve_diagonal, average)
  b, n = _batch_of_squares("threshold_symmetrize_general_batched", mat)
  _check_f32("threshold_symmetrize_general_batched thresholds", thresholds,
             (b, n, 1))
  if thresholds.device != mat.device:
    raise ValueError("threshold_symmetrize_general_batched: thresholds on "
                     f"{thresholds.device}, matrix on {mat.device}")
  out = torch.empty_like(mat)
  if b and n:
    _launch("sct_threshold_symmetrize_batched", mat.data_ptr(),
            thresholds.data_ptr(), out.data_ptr(), b, n, float(multiplier),
            int(binarize), int(preserve_diagonal), int(average), _stream(mat))
    threshold_symmetrize_general_batched.launches += 1
  return out


def row_wise_normalize_batched(mat: torch.Tensor,
                               n_valid=None) -> torch.Tensor:
  """RowWiseNormalize of each matrix of a (B, N, N) batch, each over its
  first ``n_valid[b]`` columns (None or a (B,) integer tensor); callers
  re-mask."""
  if _is_cpu(mat):
    return row_wise_normalize_plain(mat, n_valid)
  b, n = _batch_of_squares("row_wise_normalize_batched", mat)
  nv = _device_n_valid("row_wise_normalize_batched", b, n, n_valid,
                       mat.device)
  out = torch.empty_like(mat)
  if b and n:
    _launch("sct_row_wise_normalize_batched", mat.data_ptr(), out.data_ptr(),
            b, n, nv.data_ptr(), _vec(mat) & _vec(out), _stream(mat))
    row_wise_normalize_batched.launches += 1
  return out


def panel_matmul(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """mat @ x for a tall (M, K) float32 matrix and a narrow (K, b) panel ->
  (M, b); a (B, M, K) batch takes a (B, K, b) panel (see the twin).

  The matrix is read in place where its rows are contiguous (a row stripe
  of a larger matrix included), the panel in place at its own strides.
  Each output is the float64 sum of exact products, rounded once, so it
  lies within the float32 bound of the twin's sum. One launch per
  ``PANEL_COLS`` columns of the panel, each counted; no scratch.
  """
  if _is_cpu(mat):
    return panel_matmul_plain(mat, x)
  if mat.dim() not in (2, 3) or x.dim() != mat.dim():
    raise ValueError("panel_matmul: expected (M, K) @ (K, b) or (B, M, K) @ "
                     f"(B, K, b), got {tuple(mat.shape)} @ {tuple(x.shape)}")
  batch = mat.shape[0] if mat.dim() == 3 else 1
  m, k = mat.shape[-2:]
  b = x.shape[-1]
  if x.shape[-2] != k or (mat.dim() == 3 and x.shape[0] != batch):
    raise ValueError(f"panel_matmul: shapes {tuple(mat.shape)} @ "
                     f"{tuple(x.shape)} do not match")
  for name, t in (("matrix", mat), ("panel", x)):
    if t.dtype != torch.float32:
      raise TypeError(f"panel_matmul {name}: expected float32, got {t.dtype}")
  if x.device != mat.device:
    raise ValueError(f"panel_matmul: panel on {x.device}, matrix on "
                     f"{mat.device}")
  if mat.stride(-1) != 1 or (m > 1 and mat.stride(-2) < k):
    mat = mat.contiguous()
  lda = mat.stride(-2) if m > 1 else k
  stride_a = mat.stride(0) if mat.dim() == 3 else m * lda
  out = mat.new_empty(mat.shape[:-1] + (b,))
  if not (batch and m and k and b):
    return out.zero_()
  _launch("sct_panel_matmul", mat.data_ptr(), x.data_ptr(), out.data_ptr(),
          batch, m, k, lda, stride_a, b, x.stride(-2), x.stride(-1),
          x.stride(0) if x.dim() == 3 else 0, _stream(mat))
  panel_matmul.launches += -(-b // PANEL_COLS)
  return out


def _cholqr_args(name: str, y: torch.Tensor,
                 gram: torch.Tensor) -> typing.Tuple[int, int, int]:
  """(batch, N, b) of a CholeskyQR pass's panel and Gram on the card, or
  raises on what the kernel does not take."""
  if y.dim() not in (2, 3) or gram.dim() != y.dim():
    raise ValueError(f"{name}: expected (N, b) and (b, b) or (B, N, b) "
                     f"and (B, b, b), got {tuple(y.shape)}, "
                     f"{tuple(gram.shape)}")
  batch = y.shape[0] if y.dim() == 3 else 1
  k, b = y.shape[-2:]
  if tuple(gram.shape[-2:]) != (b, b) or (y.dim() == 3
                                          and gram.shape[0] != batch):
    raise ValueError(f"{name}: Gram {tuple(gram.shape)} for a panel "
                     f"{tuple(y.shape)}")
  if b > 64:
    raise ValueError(f"{name}: at most 64 columns, got {b}")
  for what, t in (("panel", y), ("Gram", gram)):
    if t.dtype != torch.float32:
      raise TypeError(f"{name} {what}: expected float32, got {t.dtype}")
  if gram.device != y.device:
    raise ValueError(f"{name}: Gram on {gram.device}, panel on {y.device}")
  return batch, k, b


def cholqr_pass(y: torch.Tensor, gram: torch.Tensor,
                delta_rel: float) -> typing.Tuple[torch.Tensor, torch.Tensor]:
  """One shifted CholeskyQR pass of a float32 (N, b) panel given its
  (b, b) Gram (see the twin); (B, N, b) and (B, b, b) for a batch.

  The panel is read in place, row-major or transposed; q is returned as
  the transpose of a contiguous (b, N) matrix, the layout of the twin's
  triangular solve, and ``info`` as int32 on the card. b ≤ 64.
  """
  if _is_cpu(y):
    return cholqr_pass_plain(y, gram, delta_rel)
  batch, k, b = _cholqr_args("cholqr_pass", y, gram)
  gram = gram.contiguous()
  qt = y.new_empty(y.shape[:-2] + (b, k))
  info = torch.empty(y.shape[:-2], dtype=torch.int32, device=y.device)
  if batch and k and b:
    _launch("sct_cholqr_pass", y.data_ptr(), gram.data_ptr(), qt.data_ptr(),
            info.data_ptr(), batch, k, b,
            y.stride(0) if y.dim() == 3 else 0, y.stride(-2), y.stride(-1),
            float(delta_rel), _stream(y))
    cholqr_pass.launches += 1
  else:
    info.zero_()
  return qt.transpose(-1, -2), info


# The pair's workspace on each card: 2 uint32 per panel (a counter and an
# OR) for the largest batch a launch takes (the grid's 65535), zero at rest:
# every launch leaves it as it found it.
_QR_TICKETS: typing.Dict[int, torch.Tensor] = {}


def _qr_tickets(device: torch.device) -> torch.Tensor:
  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  tickets = _QR_TICKETS.get(index)
  if tickets is None:
    tickets = _QR_TICKETS.setdefault(index, torch.zeros(
        2 * 65535, dtype=torch.int32, device=device))
  return tickets


def cholqr_pass_pair(
    y: torch.Tensor, gram: torch.Tensor, delta_rel: float, rescue_rel: float
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """The pass at ``delta_rel`` and at ``rescue_rel`` in one launch (see the
  twin): (q, q_rescue, info, bad), each q as ``cholqr_pass`` returns it,
  each equal bit for bit to that pass alone; ``info`` the first pass's
  (int32) and ``bad`` (bool) True for a panel whose first pass failed or
  left a non-finite value. The panel is read once, in place. b ≤ 64.
  """
  if _is_cpu(y):
    return cholqr_pass_pair_plain(y, gram, delta_rel, rescue_rel)
  batch, k, b = _cholqr_args("cholqr_pass_pair", y, gram)
  gram = gram.contiguous()
  lead = y.shape[:-2]
  qt = y.new_empty((2,) + lead + (b, k))
  info = torch.empty(lead, dtype=torch.int32, device=y.device)
  bad = torch.empty(lead, dtype=torch.bool, device=y.device)
  if batch and k and b:
    _launch("sct_cholqr_pass_pair", y.data_ptr(), gram.data_ptr(),
            qt.data_ptr(), info.data_ptr(), bad.data_ptr(),
            _qr_tickets(y.device).data_ptr(), batch, k, b,
            y.stride(0) if y.dim() == 3 else 0, y.stride(-2), y.stride(-1),
            float(delta_rel), float(rescue_rel), _stream(y))
    cholqr_pass_pair.launches += 1
  else:
    info.zero_()
    bad.zero_()
  return qt[0].transpose(-1, -2), qt[1].transpose(-1, -2), info, bad


# Kernel 8's bound on k_max and on the column count (kKmMaxWidth).
KMEANS_MAX_WIDTH = 32


def _kmeans_counts(n_clusters, batch: int, device: torch.device):
  """(int32 tensor or None, value) of n_clusters as kernel 8 reads it: one
  int32 count per utterance on the card, or one count by value (an int, or
  a 0-dim tensor on the CPU)."""
  if not isinstance(n_clusters, torch.Tensor):
    return None, int(n_clusters)
  if n_clusters.dim() > 1 or (n_clusters.dim() == 1
                              and n_clusters.shape[0] != batch):
    raise ValueError(f"kmeans: n_clusters of shape "
                     f"{tuple(n_clusters.shape)} for {batch} utterances")
  if n_clusters.device.type == "cpu" and n_clusters.dim() == 0:
    return None, int(n_clusters)
  counts = n_clusters.to(device=device, dtype=torch.int32).reshape(-1)
  return counts.expand(batch).contiguous(), 0


def kmeans(x: torch.Tensor, n_clusters, keys, k_max: int,
           sample_weight: typing.Optional[torch.Tensor] = None,
           draw_rows: typing.Optional[int] = None, max_iter: int = 10,
           tol: float = 0.001
           ) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Kernel 8: the twin's K-Means (see ``kmeans_plain``) in one launch,
  one block per utterance. k_max and d at most ``KMEANS_MAX_WIDTH``.

  Nothing is read on the host: a count tensor on the card is read there,
  and a batch's keys go over in a pinned copy that does not block. The
  round count stays on the card.
  """
  if _is_cpu(x):
    return kmeans_plain(x, n_clusters, keys, k_max, sample_weight,
                        draw_rows, max_iter, tol)
  if x.dim() not in (2, 3):
    raise ValueError(f"kmeans: expected (N, d) or (B, N, d), got "
                     f"{tuple(x.shape)}")
  if x.dtype != torch.float32:
    raise TypeError(f"kmeans: expected float32, got {x.dtype}")
  batch = x.shape[0] if x.dim() == 3 else 1
  n, d = x.shape[-2:]
  if not (1 <= k_max <= KMEANS_MAX_WIDTH and 1 <= d <= KMEANS_MAX_WIDTH):
    raise ValueError(f"kmeans: k_max {k_max} and {d} columns must lie in "
                     f"[1, {KMEANS_MAX_WIDTH}]")
  if n < 1:
    raise ValueError("kmeans: no rows")
  rows = utils.pad_bucket(n) if draw_rows is None else int(draw_rows)
  trials = 2 + int(math.log(max(k_max, 1)))
  if rows < n or trials * rows >= 2**32:
    raise ValueError(f"kmeans: {rows} draw rows for {n} rows")
  x = x.contiguous()
  lead = x.shape[:-2]
  w_ptr = 0
  if sample_weight is not None:
    _check_f32("kmeans sample_weight", sample_weight, tuple(x.shape[:-1]))
    if sample_weight.device != x.device:
      raise ValueError(f"kmeans: weights on {sample_weight.device}, rows on "
                       f"{x.device}")
    w_ptr = sample_weight.data_ptr()
  counts, value = _kmeans_counts(n_clusters, batch, x.device)
  keys = np.asarray(keys, np.uint32).reshape(batch, 2)
  keys_dev = None
  if batch > 1:
    # A pinned copy sent without blocking: no sync.
    keys_dev = torch.from_numpy(keys.view(np.int32)).pin_memory().to(
        x.device, non_blocking=True)
  labels = torch.empty(x.shape[:-1], dtype=torch.int32, device=x.device)
  centroids = x.new_empty(lead + (k_max, d))
  rounds = torch.empty(lead, dtype=torch.int32, device=x.device)
  scratch = x.new_empty(x.shape[:-1])
  _launch("sct_kmeans", x.data_ptr(), w_ptr,
          0 if counts is None else counts.data_ptr(), value,
          0 if keys_dev is None else keys_dev.data_ptr(),
          int(keys[0, 0]), int(keys[0, 1]), batch, n, d, k_max, rows, trials,
          int(max_iter), float(np.float32(1.0 - tol)), labels.data_ptr(),
          centroids.data_ptr(), rounds.data_ptr(), scratch.data_ptr(),
          _stream(x))
  kmeans.launches += 1
  return labels, centroids, rounds


WRAPPERS = (affinity, row_max, crop_diagonal, threshold_symmetrize_general,
            row_wise_normalize, affinity_batched, row_max_batched,
            crop_diagonal_batched, threshold_symmetrize_general_batched,
            row_wise_normalize_batched, panel_matmul, cholqr_pass,
            cholqr_pass_pair, kmeans)


def reset_launch_counts():
  for fn in WRAPPERS:
    fn.launches = 0


def launch_counts() -> typing.Dict[str, int]:
  return {fn.__name__: fn.launches for fn in WRAPPERS}


reset_launch_counts()
