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
and nowhere else (``reset_launch_counts`` / ``launch_counts``).
"""

from __future__ import annotations

import typing

import torch


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


def _launch(fn_name: str, *args):
  lib = _lib()
  rc = getattr(lib, fn_name)(*args)
  if rc != 0:
    msg = lib.sct_error_string(rc).decode()
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


def row_wise_normalize_plain(mat: torch.Tensor, n_valid=None) -> torch.Tensor:
  """Every entry divided by its row's max over columns < n_valid.

  Rows >= n_valid are divided by their valid-column max too, as
  row_wise_normalize_pallas does; callers re-mask padding. A row whose
  valid max is 0 gives NaN, as the division does there. A (B, N, N) batch
  takes n_valid None or (B,).
  """
  return mat / row_max_plain(mat, n_valid=n_valid)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


# The 2-D affinity kernel's operand units (kAffTile, kAffDepth in
# csrc/fused.cu): it takes xnᵀ zero-padded to whole 128-column tiles and
# 16-deep k slices, and refuses any other padding.
AFFINITY_TILE = 128
AFFINITY_DEPTH = 16


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


WRAPPERS = (affinity, row_max, crop_diagonal, threshold_symmetrize_general,
            row_wise_normalize, affinity_batched, row_max_batched,
            crop_diagonal_batched, threshold_symmetrize_general_batched,
            row_wise_normalize_batched)


def reset_launch_counts():
  for fn in WRAPPERS:
    fn.launches = 0


def launch_counts() -> typing.Dict[str, int]:
  return {fn.__name__: fn.launches for fn in WRAPPERS}


reset_launch_counts()
