"""Row-stripe forms of the refinement, the Laplacians and the eigen operand.

An (n, n) matrix of the row-sharded path (``sharded.py``) lives only as
row stripes: shard r of a group (``collectives.py``) holds rows
[r·n/P, (r+1)·n/P) as an (n/P, n) tensor; no shard holds the whole matrix.
Each function here takes the list of this process's stripes and returns
the list of their results, with the single-device op's arithmetic element
for element (``ops/refinement.py``, ``ops/laplacian.py``,
``ops/eigen.apply_padding_sentinels``, ``pipeline._symmetric_eig_operand``
with ``use_kernels=False``):

  * masks, CropDiagonal, RowWiseThreshold, RowWiseNormalize and row
    degrees are row-local, with global row indices (the diagonal of stripe
    r sits at column offset r·n/P);
  * GaussianBlur mixes rows: each stripe first receives a halo of
    R = int(4σ+0.5) rows on either side (one ``all_to_all``; the halo may
    span several shards when n/P < R), reflected at the global ``n_valid``
    as the single-device blur does, then runs the same row pass and column
    pass with the same weights;
  * Symmetrize needs the transpose's stripe: one ``all_to_all`` of
    (n/P, n/P) blocks, each transposed on arrival;
  * Diffuse ``AAᵀ``: column block j of stripe r is ``A_r A_jᵀ``, the
    ``A_j`` passed around the ring (P−1 ``ring_shift`` hops), never
    gathered;
  * a column scale (the RowWiseNormalize tail's D^-1/2, the normalized
    Laplacians') is an ``all_gather`` of an n-vector; the sentinels'
    Gershgorin bound an ``all_reduce`` max.

Up to Diffuse every element is computed by the same float operations as
on one device, so the stripes equal the single-device matrix bit for bit;
Diffuse's block products reorder its sums.
"""

from __future__ import annotations

import typing

import torch

from spectralcluster_tpu_torch.ops import blur as blur_ops
from spectralcluster_tpu_torch.ops import refinement as refinement_ops
from spectralcluster_tpu_torch.types import (EPS, LaplacianType,
                                             RefinementName,
                                             RefinementOptions,
                                             SymmetrizeType, ThresholdType)

Stripes = typing.List[torch.Tensor]


class Layout:
  """Where this process's stripes sit in an (n, n) matrix over ``group``,
  and which of its rows and columns are valid (< ``n_valid``)."""

  def __init__(self, group, n: int, n_valid: typing.Optional[int] = None):
    if n % group.size:
      raise ValueError(f"{n} rows do not split over {group.size} shards")
    self.group = group
    self.n = n
    self.n_valid = n_valid
    self.m = n // group.size

  def offset(self, i: int) -> int:
    """The first global row of local stripe i."""
    return self.group.shards[i] * self.m

  def rows(self, i: int, device) -> torch.Tensor:
    lo = self.offset(i)
    return torch.arange(lo, lo + self.m, device=device)

  def eye(self, i: int, device) -> torch.Tensor:
    """The stripe's part of the identity: (m, n) bool."""
    return (self.rows(i, device)[:, None]
            == torch.arange(self.n, device=device)[None, :])

  def valid_rows(self, i: int, device) -> torch.Tensor:
    return self.rows(i, device) < self.n_valid

  def valid_cols(self, device) -> torch.Tensor:
    return torch.arange(self.n, device=device) < self.n_valid

  def keep(self, i: int, device) -> torch.Tensor:
    return (self.valid_rows(i, device)[:, None]
            & self.valid_cols(device)[None, :])

  def diagonal(self, i: int, x: torch.Tensor) -> torch.Tensor:
    """The diagonal elements held by stripe i: (m,)."""
    return torch.diagonal(x, offset=self.offset(i))


def mask_padding(layout: Layout, xs: Stripes) -> Stripes:
  """Zero rows and columns past n_valid."""
  if layout.n_valid is None:
    return xs
  return [torch.where(layout.keep(i, x.device), x, 0.0)
          for i, x in enumerate(xs)]


def crop_diagonal(layout: Layout, xs: Stripes) -> Stripes:
  """Each diagonal element <- the max off-diagonal value of its row."""
  out = []
  for i, x in enumerate(xs):
    eye = layout.eye(i, x.device)
    off = torch.where(eye, 0.0, x)
    if layout.n_valid is not None:
      off = torch.where(layout.valid_cols(x.device)[None, :], off, -torch.inf)
    row_max = torch.amax(off, dim=1)
    out.append(torch.where(eye, row_max[:, None], x))
  return mask_padding(layout, out)


def _halo_windows(layout: Layout, radius: int, n_valid: int):
  """The global rows [a, b) each shard's blur reads: its rows widened by
  ``radius`` on either side, within [0, n_valid). Every reflected source
  row of a valid output row lies there; a stripe with no valid row reads
  nothing."""
  windows = []
  for s in range(layout.group.size):
    lo, hi = s * layout.m, (s + 1) * layout.m
    if lo >= n_valid:
      windows.append((0, 0))
    else:
      windows.append((max(0, lo - radius), min(n_valid, hi + radius)))
  return windows


def gaussian_blur(layout: Layout, xs: Stripes, sigma: float) -> Stripes:
  """scipy-compatible truncated Gaussian blur of the valid block."""
  if sigma <= 0:
    return xs
  w = blur_ops._gaussian_kernel(sigma)
  radius = (len(w) - 1) // 2
  nv = layout.n if layout.n_valid is None else layout.n_valid
  windows = _halo_windows(layout, radius, nv)
  group = layout.group
  # Shard s sends shard t the rows of its stripe inside t's window.
  sends = []
  for i, x in enumerate(xs):
    lo = layout.offset(i)
    blocks = []
    for a, b in windows:
      a_, b_ = max(a, lo), min(b, lo + layout.m)
      blocks.append(x[a_ - lo:max(a_, b_) - lo])
    sends.append(blocks)
  received = group.all_to_all(sends)
  out = []
  for i, x in enumerate(xs):
    dev = x.device
    a, b = windows[group.shards[i]]
    if a == b:   # no valid row: the blur keeps the stripe as it is
      out.append(x)
      continue
    window = torch.cat(received[i])
    rows = layout.rows(i, dev)
    cols = torch.arange(layout.n, device=dev)
    # Rows past n_valid read any window row: the result keeps x there.
    live = rows < nv
    row_pass = torch.zeros_like(x)
    for k, wk in enumerate(w):
      src = blur_ops._reflect(rows + (k - radius), nv)
      src = torch.where(live, src - a, 0)
      row_pass = row_pass + wk * window[src, :]
    col_pass = torch.zeros_like(x)
    for k, wk in enumerate(w):
      col_pass = col_pass + wk * row_pass[:, blur_ops._reflect(
          cols + (k - radius), nv)]
    if layout.n_valid is not None:
      col_pass = torch.where(layout.keep(i, dev), col_pass, x)
    out.append(col_pass)
  return mask_padding(layout, out)


def row_wise_threshold(layout: Layout, xs: Stripes, p_percentile,
                       soft_multiplier: float = 0.01,
                       thresholding_type: ThresholdType = ThresholdType.RowMax,
                       with_binarization: bool = False,
                       preserve_diagonal: bool = False) -> Stripes:
  """Row-wise (soft) thresholding."""
  out = []
  for i, x in enumerate(xs):
    eye = layout.eye(i, x.device)
    a = torch.where(eye, 0.0, x) if preserve_diagonal else x
    if thresholding_type == ThresholdType.RowMax:
      if layout.n_valid is None:
        row_max = torch.amax(a, dim=1)
      else:
        row_max = torch.amax(torch.where(
            layout.valid_cols(x.device)[None, :], a, -torch.inf), dim=1)
      threshold = row_max[:, None] * p_percentile
    else:
      threshold = refinement_ops._row_thresholds(
          a, p_percentile, thresholding_type, layout.n_valid)
    is_smaller = a < threshold
    if with_binarization:
      y = torch.where(is_smaller, a * soft_multiplier, 1.0)
    else:
      y = torch.where(is_smaller, a * soft_multiplier, a)
    if preserve_diagonal:
      y = torch.where(eye, 1.0, y)
    out.append(y)
  return mask_padding(layout, out)


def transpose(layout: Layout, xs: Stripes) -> Stripes:
  """The stripes of the transpose: one all_to_all of (m, m) blocks."""
  m = layout.m
  sends = [[x[:, j * m:(j + 1) * m] for j in range(layout.group.size)]
           for x in xs]
  received = layout.group.all_to_all(sends)
  return [torch.cat([blk.T for blk in blocks], dim=1) for blocks in received]


def symmetrize(layout: Layout, xs: Stripes,
               symmetrize_type: SymmetrizeType = SymmetrizeType.Max
               ) -> Stripes:
  if symmetrize_type not in (SymmetrizeType.Max, SymmetrizeType.Average):
    raise ValueError("Unsupported symmetrize_type.")
  xts = transpose(layout, xs)
  if symmetrize_type == SymmetrizeType.Max:
    return [torch.maximum(x, xt) for x, xt in zip(xs, xts)]
  return [0.5 * (x + xt) for x, xt in zip(xs, xts)]


def diffuse(layout: Layout, xs: Stripes) -> Stripes:
  """A Aᵀ: column block j of stripe r is A_r A_jᵀ, A_j moved around the
  ring; each stripe holds its own rows, the block in flight and its
  output."""
  group, m = layout.group, layout.m
  out = [torch.zeros_like(x) for x in xs]
  circ = list(xs)
  for hop in range(group.size):
    for i, x in enumerate(xs):
      src = (group.shards[i] - hop) % group.size
      out[i][:, src * m:(src + 1) * m] = torch.matmul(x, circ[i].T)
    if hop + 1 < group.size:
      circ = group.ring_shift(circ)
  return out


def row_max_scale(layout: Layout, xs: Stripes) -> Stripes:
  """Row maxima over the valid columns; padded rows get scale 1."""
  if layout.n_valid is None:
    return [torch.amax(x, dim=1) for x in xs]
  return [torch.where(
      layout.valid_rows(i, x.device),
      torch.amax(torch.where(layout.valid_cols(x.device)[None, :], x,
                             -torch.inf), dim=1), 1.0)
          for i, x in enumerate(xs)]


def row_wise_normalize(layout: Layout, xs: Stripes) -> Stripes:
  ds = row_max_scale(layout, xs)
  return mask_padding(layout, [x / d[:, None] for x, d in zip(xs, ds)])


def apply_refinement_sequence(
    layout: Layout, xs: Stripes, options: RefinementOptions,
    sequence: typing.Sequence[RefinementName]) -> Stripes:
  """``refinement.apply_refinement_sequence`` (use_kernels=False) on
  stripes."""
  for name in sequence:
    if name == RefinementName.CropDiagonal:
      xs = crop_diagonal(layout, xs)
    elif name == RefinementName.GaussianBlur:
      xs = gaussian_blur(layout, xs, options.gaussian_blur_sigma)
    elif name == RefinementName.RowWiseThreshold:
      xs = row_wise_threshold(
          layout, xs, options.p_percentile,
          options.thresholding_soft_multiplier, options.thresholding_type,
          options.thresholding_with_binarization,
          options.thresholding_preserve_diagonal)
    elif name == RefinementName.Symmetrize:
      xs = symmetrize(layout, xs, options.symmetrize_type)
    elif name == RefinementName.Diffuse:
      xs = diffuse(layout, xs)
    elif name == RefinementName.RowWiseNormalize:
      xs = row_wise_normalize(layout, xs)
    else:
      raise ValueError(f"Unknown refinement operation: {name}")
  return xs


def _with_diagonal(layout: Layout, i: int, x: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
  """The stripe's part of diag(values): (m, n), zero off the diagonal."""
  return torch.where(layout.eye(i, x.device), values[:, None], 0.0)


def laplacian_similarity(
    layout: Layout, xs: Stripes, laplacian_type: LaplacianType,
    eps: float = EPS) -> typing.Tuple[Stripes, typing.Optional[Stripes]]:
  """``laplacian.laplacian_similarity`` on stripes: (M stripes, the rows
  of the eigenvector scale or None)."""
  if laplacian_type == LaplacianType.Affinity:
    return xs, None
  if layout.n_valid is None:
    ds = [torch.sum(x, dim=1) for x in xs]
  else:
    ds = [torch.sum(torch.where(layout.valid_cols(x.device)[None, :], x, 0.0),
                    dim=1) for x in xs]
  laps = [_with_diagonal(layout, i, x, d) - x
          for i, (x, d) in enumerate(zip(xs, ds))]
  if laplacian_type == LaplacianType.Unnormalized:
    return laps, None
  if laplacian_type == LaplacianType.GraphCut:
    scales = [1.0 / (torch.sqrt(d) + eps) for d in ds]
  elif laplacian_type == LaplacianType.RandomWalk:
    scales = [1.0 / torch.sqrt(d + eps) for d in ds]
  else:
    raise ValueError("Unsupported laplacian_type.")
  full = layout.group.all_gather(scales)
  out = [s[:, None] * lap * full.to(lap.device)[None, :]
         for s, lap in zip(scales, laps)]
  return out, (scales if laplacian_type == LaplacianType.RandomWalk
               else None)


def valid_gershgorin(layout: Layout, xs: Stripes) -> torch.Tensor:
  """Max absolute row sum of the valid block (replicated, 0-dim)."""
  if layout.n_valid is None:
    sums = [torch.amax(torch.sum(torch.abs(x), dim=1)) for x in xs]
  else:
    sums = [torch.amax(torch.sum(torch.where(layout.keep(i, x.device),
                                             torch.abs(x), 0.0), dim=1))
            for i, x in enumerate(xs)]
  return layout.group.all_reduce(sums, "max")


def apply_padding_sentinels(layout: Layout, xs: Stripes,
                            descend: bool) -> Stripes:
  """``eigen.apply_padding_sentinels`` on stripes: padded rows and columns
  zeroed, distinct sentinels past the scan end on the padded diagonal,
  scaled to the valid block's Gershgorin bound."""
  xs = mask_padding(layout, xs)
  bound = valid_gershgorin(layout, xs)
  out = []
  for i, x in enumerate(xs):
    b = bound.to(x.device)
    base = 1.25 * b + 1.0
    step = 0.01 * b + 0.01
    sign = -1.0 if descend else 1.0
    sentinels = sign * (base + layout.rows(i, x.device).to(x.dtype) * step)
    diag = layout.diagonal(i, x)
    diag_vals = torch.where(layout.valid_rows(i, x.device), diag, sentinels)
    out.append(x - _with_diagonal(layout, i, x, diag)
               + _with_diagonal(layout, i, x, diag_vals))
  return out


def symmetric_eig_operand(layout: Layout, xs: Stripes, cfg, structure: str,
                          descend: bool):
  """``pipeline._symmetric_eig_operand`` (no constraint, no kernels) on
  stripes: (M stripes with sentinels, the rows of the eigenvector scale or
  None)."""
  ropts = cfg.refinement_options
  seq = tuple(ropts.refinement_sequence or ())
  if structure == refinement_ops.ROWNORM_TAIL:
    s = apply_refinement_sequence(layout, xs, ropts, seq[:-1])
    inv_sqrt = [1.0 / torch.sqrt(d) for d in row_max_scale(layout, s)]
    full = layout.group.all_gather(inv_sqrt)
    m = [a[:, None] * x * full.to(x.device)[None, :]
         for a, x in zip(inv_sqrt, s)]
    scale = inv_sqrt
  else:
    refined = apply_refinement_sequence(layout, xs, ropts, seq)
    if descend:
      m, scale = refined, None
    else:
      m, scale = laplacian_similarity(layout, refined, cfg.laplacian_type)
  if layout.n_valid is not None:
    m = apply_padding_sentinels(layout, m, descend)
  return m, scale


def recover_similarity_eigenvectors(layout: Layout, us: Stripes,
                                    scale: typing.Optional[Stripes]
                                    ) -> Stripes:
  """``eigen.recover_similarity_eigenvectors`` on stripes: v = s·u, its
  columns renormalized over the valid rows (an all-reduced sum of
  squares)."""
  if scale is None:
    return us
  vs = [s[:, None] * u for s, u in zip(scale, us)]
  if layout.n_valid is None:
    valid = vs
  else:
    valid = [torch.where(layout.valid_rows(i, v.device)[:, None], v, 0.0)
             for i, v in enumerate(vs)]
  norms = torch.sqrt(layout.group.all_reduce(
      [torch.sum(v * v, dim=0) for v in valid]))
  norms = torch.where(norms > 0, norms, 1.0)
  return [v / norms.to(v.device) for v in vs]
