"""The spectral-clustering pipeline on tensors.

Port of ``spectralcluster_tpu/pipeline.py``:
embeddings -> cosine affinity (-> constraint before refinement) ->
refinement sequence (-> constraint after refinement) (-> Laplacian) ->
eigen operand -> eigenpairs -> snapped eigengap count -> masked K-Means.

  * ``prepare_affinity`` / ``refine_and_eigendecompose`` /
    ``spectral_cluster_fixed_k`` — the staged-free entry points. With
    ``cfg.autotune`` (an ``AutoTuneStatic``), ``spectral_cluster_fixed_k``
    runs the level-1 p_percentile sweep, one candidate after another, and
    keeps the argmin of the proxy, as the JAX package's vmapped sweep does;
  * ``spectral_cluster_fixed_k_staged`` — the same computation split at the
    eigensolver boundary, with per-stage timings. The JAX package split its
    program there to get past a TPU compile wall; PyTorch runs eagerly and
    has no such wall, so here the split only gives the stage timings and the
    route past ``dc_max_block`` (below). Configurations it cannot split (the
    GENERAL structure, in-graph autotune) run as
    ``spectral_cluster_fixed_k``, as in JAX;
  * ``eig_topk_staged`` — the per-candidate refine -> top-k eig -> gap
    evaluator that the clusterer's host flow uses at large N;
  * ``spectral_cluster_fixed_k_batched`` — the JAX package's ``vmap`` of
    ``spectral_cluster_fixed_k`` (its batched step, parallel/batch.py):
    a (B, N, d) chunk of padded utterances as one program, see below.

Constraints (constraint.py) enter as ``constraint_matrix``, a keyword
argument of every entry point, and apply where ``cfg.constraint_options``
says: on the affinity before refinement (``prepare_affinity``), or on the
refined matrix after it. A Laplacian ``laplacian_type`` (ops/laplacian.py)
scans eigenvalues ascending, through the symmetric similarity form of
``laplacian_similarity``, or, on the GENERAL structure, through
``compute_laplacian`` before the host eig.

Symmetry structures (``refinement_ops.analyze_symmetry``, then
``_eig_structure`` for constraints and Laplacians): SYMMETRIC and
ROWNORM_TAIL take ``torch.linalg.eigh`` (or the top-k subspace iteration)
on the card. GENERAL — forced by ``EigenSolver.HostGeneral``, or a
configuration with no symmetric form under ``Auto`` (an asymmetric
constraint, a constraint after a RowWiseNormalize tail, a sequence that
ends asymmetric) — applies the whole refinement sequence, RowWiseNormalize
included (kernel 5), and hands the result to LAPACK's general eig on the
host (``sorted_eig_general_host``), as the JAX package does. That host eig
is recorded as the ``host_eig`` stage when the caller passes ``timings``.

Eager PyTorch does not recompile per shape, so callers may run unpadded
(``n_valid=None``); every op still honours ``n_valid``.

Past ``dc_max_block`` the route for ``Auto`` in the staged executor, and
for ``Eigh`` in ``eig_topk_staged``, is the exact top-k route of
``ops/dc.py`` (``eigh_topk_dc``, stage "staged_dc"): the max_clusters+1
extreme eigenpairs in scan order with a residual certificate, snapped
against the solver's norm estimate; on a descending scan
``_warn_near_stop`` warns when the cluster count depends on digits that
certificate cannot vouch for, as in JAX.

The batched step. ``prepare_affinity``, ``refine_and_eigendecompose`` and
the ops under them take a leading batch axis, with ``n_valid`` a (B,)
tensor on the device: the affinity, CropDiagonal, the row maxima and the
RowWiseThreshold+Symmetrize pair are one launch of a batched kernel per
chunk, Diffuse and the E2CP products are batched matmuls, Auto and Eigh
one batched ``torch.linalg.eigh``, SubspaceIteration one batched solve
(``topk_eigh_subspace_masked`` on (B, N, b) panels, each utterance frozen
at its own convergence, as JAX's vmapped ``while_loop`` does), and the
eigengap count, the snap and the Lloyd stop flags are (B,) tensors on the
device. The GENERAL structure runs the whole chunk too: its
RowWiseNormalize is one launch of kernel 5's batched form, and its host
eig copies the chunk to the host once and decomposes one matrix after
another (JAX's ``vmap_method="sequential"``). Each utterance gets what the
2-D functions give it alone. ``cfg.autotune``'s sweep evaluates its C
candidates of B utterances as one (B·C, N, N) batch.

Each entry point runs under ``precision.fp32_precision()`` (TF32 off).
Randomness: the K-Means seeding takes a CPU ``torch.Generator`` where JAX
took a PRNG key, and draws the JAX stream of ``PRNGKey`` of its seed
(``ops/kmeans.py``); the subspace start panel comes from a generator seeded
42 and the dc route's from one seeded 17, as JAX used ``PRNGKey(42)`` and
``PRNGKey(17)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import typing
import warnings

import numpy as np
import torch

from spectralcluster_tpu_torch import constraint as constraint_lib
from spectralcluster_tpu_torch.kernels import fused as fused_kernels
from spectralcluster_tpu_torch.ops import affinity as affinity_ops
from spectralcluster_tpu_torch.ops import dc as dc_ops
from spectralcluster_tpu_torch.ops import eigen as eigen_ops
from spectralcluster_tpu_torch.ops import kmeans as kmeans_ops
from spectralcluster_tpu_torch.ops import laplacian as laplacian_ops
from spectralcluster_tpu_torch.ops import refinement as refinement_ops
from spectralcluster_tpu_torch.precision import fp32_precision
from spectralcluster_tpu_torch.types import (AutoTuneProxy, ConstraintOptions,
                                             EigenGapType, EigenSolver,
                                             LaplacianType, RefinementName,
                                             RefinementOptions)
from spectralcluster_tpu_torch.utils import pad_bucket, valid_mask

_SUBSPACE_SEED = 42
_DC_SEED = 17


@dataclasses.dataclass(frozen=True)
class AutoTuneStatic:
  """Static auto-tune spec for the pipeline entry points (JAX
  pipeline.py:72-108).

  A level-1 search (the Turn-to-Diarize preset) is one sweep over a fixed
  candidate grid, which ``spectral_cluster_fixed_k`` evaluates before it
  keeps the argmin of the proxy. Deeper levels narrow the grid from data;
  as in the JAX package, ``search_level`` other than 1 is refused: use
  ``autotune.AutoTune`` through ``SpectralClusterer`` for those.
  """
  p_percentile_min: float = 0.60
  p_percentile_max: float = 0.95
  init_search_step: float = 0.01
  proxy: AutoTuneProxy = AutoTuneProxy.PercentileSqrtOverNME
  search_level: int = 1

  def __post_init__(self):
    if self.search_level != 1:
      raise ValueError(
          f"AutoTuneStatic supports search_level=1 only (got "
          f"{self.search_level}): deeper levels narrow the grid from data. "
          "Use autotune.AutoTune through SpectralClusterer.")

  def candidates(self) -> np.ndarray:
    num = int(np.ceil((self.p_percentile_max - self.p_percentile_min)
                      / self.init_search_step))
    return np.linspace(self.p_percentile_min, self.p_percentile_max, num)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
  """Configuration of the pipeline; the JAX package's fields, by name.

  ``use_kernels`` is the JAX ``use_pallas``: route the refinement hot path
  (all five kernels of kernels/fused.py) through the wrappers.
  ``dc_sign_precision`` is the precision of ``ops/dc.py``'s sign-chain
  products ("highest", "high" or "default"; None: its default, "high").
  ``matmul_precision`` must stay "highest": every other product runs in
  IEEE float32.
  """
  refinement_options: RefinementOptions = RefinementOptions()
  constraint_options: typing.Optional[ConstraintOptions] = None
  laplacian_type: typing.Optional[LaplacianType] = None
  min_clusters: typing.Optional[int] = None
  max_clusters: typing.Optional[int] = None
  stop_eigenvalue: float = 1e-2
  eigengap_type: EigenGapType = EigenGapType.Ratio
  row_wise_renorm: bool = False
  custom_dist: typing.Union[str, typing.Callable, None] = "cosine"
  max_iter: int = 300
  eigensolver: EigenSolver = EigenSolver.Auto
  # Whether the (possibly user-injected) affinity is symmetric.
  affinity_symmetric: bool = True
  # Whether the user's constraint matrix is symmetric; SpectralClusterer
  # checks it on the host and clears this to route an asymmetric one to the
  # general eigensolver.
  constraint_symmetric: bool = True
  eigenvalue_snap_tol: float = 1e-5
  use_kernels: bool = True
  matmul_precision: str = "highest"
  subspace_iters: int = 24
  subspace_residual_tol: typing.Optional[float] = 2e-3
  subspace_max_iters: int = 384
  subspace_drift_tol: typing.Optional[float] = 1e-4
  dc_max_block: int = 8192
  dc_sign_precision: typing.Optional[str] = None
  autotune: typing.Optional[AutoTuneStatic] = None

  def replace(self, **kw) -> "PipelineConfig":
    return dataclasses.replace(self, **kw)


def _check_supported(cfg: PipelineConfig):
  if cfg.matmul_precision != "highest":
    raise ValueError("the port runs every matmul in IEEE float32; "
                     f"matmul_precision={cfg.matmul_precision!r} is refused")


def _descend(cfg: PipelineConfig) -> bool:
  """Affinity path scans eigenvalues descending; Laplacians ascending
  (reference spectral_clusterer.py:144-167)."""
  return cfg.laplacian_type in (None, LaplacianType.Affinity)


def _constraint_before(cfg: PipelineConfig, with_constraint: bool) -> bool:
  return (with_constraint and cfg.constraint_options is not None
          and cfg.constraint_options.apply_before_refinement)


def _constraint_after(cfg: PipelineConfig, with_constraint: bool) -> bool:
  return (with_constraint and cfg.constraint_options is not None
          and not cfg.constraint_options.apply_before_refinement)


def _eig_structure(cfg: PipelineConfig, with_constraint: bool = False) -> str:
  """Statically classify which eigensolver path applies."""
  # An asymmetric constraint before refinement makes the refinement input
  # asymmetric; analyze_symmetry decides whether the sequence restores it.
  input_symmetric = cfg.affinity_symmetric and not (
      _constraint_before(cfg, with_constraint)
      and not cfg.constraint_symmetric)
  structure = refinement_ops.analyze_symmetry(
      cfg.refinement_options.refinement_sequence, input_symmetric)
  if _constraint_after(cfg, with_constraint) and (
      structure == refinement_ops.ROWNORM_TAIL
      or not cfg.constraint_symmetric):
    # A constraint on the final matrix breaks the D_r^{-1} S structure; an
    # asymmetric one breaks symmetry outright.
    structure = refinement_ops.GENERAL
  if not _descend(cfg):
    # Laplacians need a symmetric affinity; laplacian_similarity then covers
    # RandomWalk too.
    if structure == refinement_ops.SYMMETRIC:
      return structure
    return refinement_ops.GENERAL
  return structure


def _solver_structure(cfg: PipelineConfig,
                      with_constraint: bool = False) -> str:
  """The structure the eigensolver sees, with the JAX package's refusals."""
  structure = _eig_structure(cfg, with_constraint)
  if cfg.eigensolver == EigenSolver.HostGeneral:
    structure = refinement_ops.GENERAL
  elif (cfg.eigensolver in (EigenSolver.Eigh, EigenSolver.SubspaceIteration)
        and structure == refinement_ops.GENERAL):
    raise ValueError(
        f"EigenSolver.{cfg.eigensolver.name} requested but the pipeline "
        "structure is not symmetric / diagonal-similar; use Auto or "
        "HostGeneral.")
  if (cfg.eigensolver == EigenSolver.SubspaceIteration
      and cfg.max_clusters is None):
    raise ValueError("SubspaceIteration requires max_clusters (the top-k).")
  return structure


def _stage(timings, name: str):
  return contextlib.nullcontext() if timings is None else timings.stage(name)


def _symmetric_eig_operand(affinity, cfg: PipelineConfig, p_percentile,
                           n_valid, structure, consume_input=False,
                           constraint_matrix=None):
  """Refinement (-> constraint after) -> the symmetric matrix handed to
  eigh, plus its scale.

  Returns (m, vec_scale) such that ``eigh(m)`` followed by
  ``recover_similarity_eigenvectors(u, vec_scale)`` reproduces the
  eigendecomposition of the (possibly non-symmetric) refined matrix, or of
  its Laplacian. Padding sentinels are applied. ``consume_input`` lets the
  refinement overwrite ``affinity``.
  """
  ropts = cfg.refinement_options
  seq = ropts.refinement_sequence or ()
  descend = _descend(cfg)

  def apply_seq(mat, names):
    return refinement_ops.apply_refinement_sequence(
        mat, ropts, sequence=names, p_percentile=p_percentile, n_valid=n_valid,
        use_kernels=cfg.use_kernels, consume_input=consume_input)

  if structure == refinement_ops.ROWNORM_TAIL:
    # A = D_r^{-1} S with S symmetric: eigh on D_r^{-1/2} S D_r^{-1/2}.
    s = apply_seq(affinity, seq[:-1])
    d = refinement_ops.row_max_scale(s, n_valid, use_kernels=cfg.use_kernels)
    inv_sqrt = 1.0 / torch.sqrt(d)
    m = inv_sqrt[..., :, None] * s * inv_sqrt[..., None, :]
    scale = inv_sqrt
  else:
    refined = apply_seq(affinity, seq)
    if _constraint_after(cfg, constraint_matrix is not None):
      refined = constraint_lib.adjust_affinity(
          refined, constraint_matrix, cfg.constraint_options, n_valid)
    if descend:
      m, scale = refined, None
    else:
      m, scale = laplacian_ops.laplacian_similarity(
          refined, cfg.laplacian_type, n_valid=n_valid)
  if n_valid is not None:
    m = eigen_ops.apply_padding_sentinels(m, n_valid, descend)
  return m, scale


def _subspace(m: torch.Tensor, cfg: PipelineConfig, n_valid, descend: bool,
              stats=None):
  """The max_clusters+1 extreme eigenpairs by subspace iteration; for a
  (B, N, N) batch one batched solve, each matrix frozen at its own
  convergence (stacked (B, k), (B, N, k)). ``stats`` receives "iters"."""
  return eigen_ops.topk_eigh_subspace_masked(
      m, cfg.max_clusters + 1, torch.Generator().manual_seed(_SUBSPACE_SEED),
      largest=descend, n_valid=n_valid, num_iters=cfg.subspace_iters,
      residual_tol=cfg.subspace_residual_tol, max_iters=cfg.subspace_max_iters,
      drift_tol=cfg.subspace_drift_tol, stats=stats)


def _dc_topk(m: torch.Tensor, cfg: PipelineConfig, n_valid, descend: bool):
  """The exact top-k route past ``dc_max_block`` (JAX pipeline.py:815-830,
  :970-991): ``ops/dc.eigh_topk_dc`` for the max_clusters+1 extreme
  eigenpairs, then ``_warn_near_stop`` on a descending scan. Returns (w, u,
  wscale), wscale being the solver's norm estimate as a 0-dim tensor.

  The JAX executor hands the solver its bucket-padded m; the port's m is
  unpadded, so the solver is told the bucket (``_n_bucket``), which decides
  its dense branch and its sign chain's schedule as JAX's size does, while
  ``dc_max_block`` bounds its recursion's blocks.
  """
  w, u, res, wscale = dc_ops.eigh_topk_dc(
      m, cfg.max_clusters + 1, torch.Generator().manual_seed(_DC_SEED),
      descend=descend, n_valid=None if n_valid is None else int(n_valid),
      max_block=cfg.dc_max_block, sign_precision=cfg.dc_sign_precision,
      _n_bucket=pad_bucket(m.shape[0]))
  if descend:
    _warn_near_stop(w.cpu().numpy(), res, wscale, cfg, "spectral D&C top-k")
  return w, u, torch.tensor(wscale, dtype=m.dtype, device=m.device)


def _count_topk_descend_np(w, wscale, cfg: PipelineConfig) -> int:
  """Numpy mirror of the descending eigengap scan on t extreme values
  (reference utils.py:117-128 semantics, snap included), for the
  count-sensitivity guard below (JAX pipeline.py:840-860)."""
  w = np.asarray(w, np.float64).copy()
  w[np.abs(w) < cfg.eigenvalue_snap_tol * wscale] = 0.0
  t = w.shape[0]
  range_end = min(t, (cfg.max_clusters + 1) if cfg.max_clusters else t)
  best, n = 0.0, 0
  for i in range(1, range_end):
    if w[i - 1] < cfg.stop_eigenvalue:
      break
    if cfg.eigengap_type == EigenGapType.Ratio:
      delta = w[i - 1] / (w[i] + 1e-10)
    else:
      delta = (w[i - 1] - w[i]) / max(float(np.max(w)), 1e-30)
    if delta > best:
      best, n = delta, i
  return n


def _warn_near_stop(w, res: float, wscale: float, cfg: PipelineConfig,
                    where: str) -> bool:
  """Warn when the cluster count depends on digits the residual
  certificate cannot vouch for (JAX pipeline.py:863-902).

  The certificate bounds each returned eigenvalue's error by res·wscale
  (Weyl). The scan is re-run with the values inside that band around
  stop_eigenvalue pushed to both extremes; only if the counts disagree is
  there a warning. Returns whether it warned.
  """
  wh = np.asarray(w, np.float64)
  unc = max(res, 1e-6) * wscale
  near = np.abs(wh - cfg.stop_eigenvalue) <= unc
  if not bool(near.any()):
    return False
  n0 = _count_topk_descend_np(wh, wscale, cfg)
  w_hi = wh.copy()
  w_hi[near] = wh[near] + unc
  w_lo = wh.copy()
  w_lo[near] = wh[near] - unc
  n_hi = _count_topk_descend_np(w_hi, wscale, cfg)
  n_lo = _count_topk_descend_np(w_lo, wscale, cfg)
  if n_hi == n0 == n_lo:
    return False
  vals = ", ".join(f"{v:.4e}" for v in wh[near][:4])
  warnings.warn(
      f"{where}: eigenvalue(s) [{vals}] lie within the solver's "
      f"certified uncertainty ({unc:.2e}) of stop_eigenvalue="
      f"{cfg.stop_eigenvalue:g} AND the cluster count depends on them "
      f"(count range [{min(n_lo, n_hi, n0)}, {max(n_lo, n_hi, n0)}]); the "
      "break decision may differ from an exact solver. Consider a tighter "
      "subspace_residual_tol, EigenSolver.Eigh, or float64 verification.",
      UserWarning, stacklevel=3)
  return True


def _valid_gershgorin(m: torch.Tensor, n_valid) -> torch.Tensor:
  """Max absolute row sum of the valid block (>= every |eigenvalue|)."""
  if n_valid is None:
    return torch.amax(torch.sum(torch.abs(m), dim=1))
  valid = torch.arange(m.shape[0], device=m.device) < n_valid
  keep = valid[:, None] & valid[None, :]
  return torch.amax(torch.sum(torch.where(keep, torch.abs(m), 0.0), dim=1))


def _gap(w: torch.Tensor, cfg: PipelineConfig, descend: bool, n_valid,
         wmax=None):
  """Snap, then the eigengap scan. ``wmax`` is the full spectrum's scale
  on the top-k routes (whose eigenvalues are all valid: pass n_valid=None)."""
  eigenvalues = eigen_ops.snap_small_eigenvalues(
      w, n_valid=n_valid, tol=cfg.eigenvalue_snap_tol, wmax=wmax)
  n_gap, max_delta = eigen_ops.compute_number_of_clusters(
      eigenvalues, max_clusters=cfg.max_clusters,
      stop_eigenvalue=cfg.stop_eigenvalue, eigengap_type=cfg.eigengap_type,
      descend=descend, n_valid=n_valid, wmax=wmax)
  return eigenvalues, n_gap, max_delta


def prepare_affinity(
    embeddings: torch.Tensor,
    cfg: PipelineConfig,
    n_valid=None,
    constraint_matrix: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Cosine affinity of (N, d) embeddings, masked to n_valid, then the
  constraint when ``cfg.constraint_options`` applies it before refinement.
  A (B, N, d) batch takes a (B,) n_valid and (B, N, N) constraints."""
  with fp32_precision():
    if cfg.use_kernels and embeddings.dim() == 3:
      affinity = fused_kernels.affinity_batched(embeddings)
    elif cfg.use_kernels:
      affinity = fused_kernels.affinity(embeddings)
    else:
      affinity = affinity_ops.compute_affinity_matrix(embeddings)
    affinity = refinement_ops.mask_padding(affinity, n_valid)
    if _constraint_before(cfg, constraint_matrix is not None):
      affinity = constraint_lib.adjust_affinity(
          affinity, constraint_matrix, cfg.constraint_options, n_valid)
    return affinity


def refine_and_eigendecompose(
    affinity: torch.Tensor,
    cfg: PipelineConfig,
    p_percentile=None,
    n_valid=None,
    consume_input: bool = False,
    timings=None,
    constraint_matrix: typing.Optional[torch.Tensor] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """Refinement -> (constraint after) -> (Laplacian) -> eigendecomposition
  -> snapped eigengap count.

  Returns (eigenvalues, eigenvectors, n_clusters, max_delta_norm) as
  tensors. ``consume_input`` lets the refinement overwrite ``affinity``.
  ``constraint_matrix`` applies here only after refinement
  (``prepare_affinity`` applies it before). With ``timings`` (an
  observability.StageTimings), the GENERAL route's host eig is recorded as
  the stage "host_eig".

  A (B, N, N) batch, with (B,) ``n_valid`` and ``p_percentile`` a scalar or
  (B,), returns each result with a leading batch axis, each utterance's
  equal to this function's on it alone (see the module docstring).
  """
  _check_supported(cfg)
  with_constraint = constraint_matrix is not None
  descend = _descend(cfg)
  structure = _solver_structure(cfg, with_constraint)
  with fp32_precision():
    if structure == refinement_ops.GENERAL:
      ropts = cfg.refinement_options
      mat = refinement_ops.apply_refinement_sequence(
          affinity, ropts, sequence=ropts.refinement_sequence or (),
          p_percentile=p_percentile, n_valid=n_valid,
          use_kernels=cfg.use_kernels, consume_input=consume_input)
      if _constraint_after(cfg, with_constraint):
        mat = constraint_lib.adjust_affinity(
            mat, constraint_matrix, cfg.constraint_options, n_valid)
      if not descend:
        mat = laplacian_ops.compute_laplacian(mat, cfg.laplacian_type,
                                              n_valid=n_valid)
      if n_valid is not None:
        mat = eigen_ops.apply_padding_sentinels(mat, n_valid, descend)
      with _stage(timings, "host_eig"):
        w, eigenvectors = eigen_ops.sorted_eig_general_host(mat, descend)
      gap_n_valid = n_valid
    else:
      m, scale = _symmetric_eig_operand(affinity, cfg, p_percentile, n_valid,
                                        structure, consume_input,
                                        constraint_matrix)
      if cfg.eigensolver == EigenSolver.SubspaceIteration:
        w, u = _subspace(m, cfg, n_valid, descend)
        eigenvectors = eigen_ops.recover_similarity_eigenvectors(u, scale,
                                                                 n_valid)
        # The k extreme eigenpairs are all valid: no sentinels among them.
        gap_n_valid = None
      else:
        w, eigenvectors = eigen_ops.sorted_eigh_similarity(
            m, scale, descend=descend, n_valid=n_valid)
        gap_n_valid = n_valid
    eigenvalues, n_clusters, max_delta = _gap(w, cfg, descend, gap_n_valid)
  return eigenvalues, eigenvectors, n_clusters, max_delta


def spectral_embeddings_from_eigs(
    eigenvectors: torch.Tensor,
    n_clusters,
    k_max: int,
    row_wise_renorm: bool,
    n_valid=None) -> torch.Tensor:
  """First-k eigenvector columns with n_clusters masking + optional renorm.

  Columns >= n_clusters are zeroed: for the metrics used downstream zero
  coordinates are inert, so this equals the reference's slice
  eigenvectors[:, :n] (spectral_clusterer.py:299-305). A (B, N, K) batch
  takes (B,) n_clusters and n_valid.
  """
  emb = eigenvectors[..., :k_max]
  col_ok = valid_mask(emb.shape[-1], n_clusters, emb.device)
  emb = torch.where(col_ok[..., None, :], emb, 0.0)
  if row_wise_renorm:
    norms = torch.linalg.norm(emb, dim=-1, keepdim=True)
    emb = emb / torch.where(norms > 0, norms, 1.0)
  if n_valid is not None:
    row_ok = valid_mask(emb.shape[-2], n_valid, emb.device)
    emb = torch.where(row_ok[..., :, None], emb, 0.0)
  return emb


def _cluster_from_eigs(eigenvectors, n_gap, cfg: PipelineConfig,
                       generator: torch.Generator, n_valid, kmeans_tol):
  """Eigengap count -> spectral embeddings -> masked K-Means -> labels."""
  n = eigenvectors.shape[0]
  dev = eigenvectors.device
  n_clusters = n_gap
  if cfg.min_clusters is not None:
    n_clusters = torch.clamp_min(n_clusters, cfg.min_clusters)
  emb = spectral_embeddings_from_eigs(
      eigenvectors, n_clusters, cfg.max_clusters, cfg.row_wise_renorm,
      n_valid)
  rows = torch.arange(n, device=dev)
  if n_valid is None:
    weight = torch.ones((n,), dtype=emb.dtype, device=dev)
  else:
    weight = (rows < n_valid).to(emb.dtype)
  labels = kmeans_ops.kmeans_fit(
      emb, n_clusters, generator, custom_dist=cfg.custom_dist,
      max_iter=cfg.max_iter, tol=kmeans_tol, k_max=cfg.max_clusters,
      sample_weight=weight)
  labels = torch.where(rows < (n if n_valid is None else n_valid), labels, 0)
  return labels, n_clusters


def _cluster_from_eigs_batched(eigenvectors, n_gap, cfg: PipelineConfig,
                               keys, n_valid, kmeans_tol):
  """``_cluster_from_eigs`` of B utterances: (B, N, K) eigenvectors, (B,)
  counts and n_valid, (B, 2) JAX key data. One batched K-Means."""
  n_clusters = n_gap
  if cfg.min_clusters is not None:
    n_clusters = torch.clamp_min(n_clusters, cfg.min_clusters)
  emb = spectral_embeddings_from_eigs(
      eigenvectors, n_clusters, cfg.max_clusters, cfg.row_wise_renorm,
      n_valid)
  valid = valid_mask(emb.shape[-2], n_valid, emb.device)
  labels = kmeans_ops.kmeans_fit_batched(
      emb, n_clusters, keys, custom_dist=cfg.custom_dist,
      max_iter=cfg.max_iter, tol=kmeans_tol, k_max=cfg.max_clusters,
      sample_weight=valid.to(emb.dtype))
  return torch.where(valid, labels, 0), n_clusters


def _require_max_clusters(cfg: PipelineConfig):
  if cfg.max_clusters is None:
    raise ValueError(
        "spectral_cluster_fixed_k requires max_clusters (the k cap); use "
        "SpectralClusterer for unbounded k.")


def _autotune_sweep(affinity: torch.Tensor, cfg: PipelineConfig, n_valid,
                    timings, constraint_matrix):
  """cfg.autotune's level-1 sweep (JAX pipeline.py:451-479): every
  candidate's refine -> eig -> gap, eigenvectors trimmed to the
  max_clusters columns K-Means reads, then the argmin of the proxy, all on
  the device. ``affinity`` is not modified."""
  if RefinementName.RowWiseThreshold not in (
      cfg.refinement_options.refinement_sequence or ()):
    raise ValueError(
        "AutoTune is only effective when the refinement sequence "
        "contains RowWiseThreshold")
  ps = torch.as_tensor(cfg.autotune.candidates(), dtype=torch.float32,
                       device=affinity.device)
  outs = []
  for p in ps:
    w, v, n_c, delta = refine_and_eigendecompose(
        affinity, cfg, p_percentile=p, n_valid=n_valid, timings=timings,
        constraint_matrix=constraint_matrix)
    outs.append((w, v[:, :cfg.max_clusters], n_c, delta))
  ws, vs, ns, deltas = (torch.stack(t) for t in zip(*outs))
  best = torch.argmin(_proxy_ratios(cfg.autotune.proxy, ps, deltas))
  return ws[best], vs[best], ns[best], deltas[best]


def _proxy_ratios(proxy: AutoTuneProxy, ps: torch.Tensor,
                  deltas: torch.Tensor) -> torch.Tensor:
  """The AutoTune proxy of each candidate, minimized by the search."""
  if proxy == AutoTuneProxy.PercentileSqrtOverNME:
    return torch.sqrt(1.0 - ps) / deltas
  elif proxy == AutoTuneProxy.PercentileOverNME:
    return (1.0 - ps) / deltas
  raise ValueError("Unsupported value of AutoTuneProxy")


def evaluate_candidates_batched(affinity: torch.Tensor, cfg: PipelineConfig,
                                ps: torch.Tensor, n_valid,
                                constraint_matrices, k_cols: int):
  """refine -> eig -> gap for C candidate p_percentiles of each of B
  utterances, as one (B·C, N, N) batch: the JAX package's vmap over
  candidates inside its vmap over utterances. ``affinity`` (B, N, N) is
  not modified; ``ps`` is (B, C). Returns (eigenvalues (B, C, ·),
  eigenvectors[..., :k_cols] (B, C, N, k_cols), n_clusters (B, C),
  max_delta (B, C))."""
  b, c = ps.shape

  def repeat(t):
    return None if t is None else t.repeat_interleave(c, dim=0)

  w, v, n_c, delta = refine_and_eigendecompose(
      repeat(affinity), cfg, p_percentile=ps.reshape(-1),
      n_valid=repeat(n_valid), consume_input=True,
      constraint_matrix=repeat(constraint_matrices))
  v = v[..., :k_cols]
  return (w.reshape((b, c) + w.shape[1:]), v.reshape((b, c) + v.shape[1:]),
          n_c.reshape(b, c), delta.reshape(b, c))


def spectral_cluster_fixed_k(
    embeddings: torch.Tensor,
    generator: torch.Generator,
    cfg: PipelineConfig,
    n_valid=None,
    kmeans_tol: float = 0.001,
    timings=None,
    constraint_matrix: typing.Optional[torch.Tensor] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """End-to-end clustering (embeddings -> labels) on the embeddings' device.

  Requires cfg.max_clusters. Padded rows (index >= n_valid) receive label 0.
  ``generator`` is a CPU generator for the K-Means seeding. With
  ``cfg.autotune`` the level-1 p_percentile sweep picks the refinement.
  Returns tensors (labels, n_clusters, eigenvalues, max_delta_norm).
  ``timings`` records the GENERAL route's host eig (see
  refine_and_eigendecompose).
  """
  _require_max_clusters(cfg)
  with fp32_precision():
    affinity = prepare_affinity(embeddings, cfg, n_valid, constraint_matrix)
    if cfg.autotune is not None:
      eigenvalues, eigenvectors, n_gap, max_delta = _autotune_sweep(
          affinity, cfg, n_valid, timings, constraint_matrix)
    else:
      eigenvalues, eigenvectors, n_gap, max_delta = refine_and_eigendecompose(
          affinity, cfg, n_valid=n_valid, consume_input=True, timings=timings,
          constraint_matrix=constraint_matrix)
    del affinity
    labels, n_clusters = _cluster_from_eigs(eigenvectors, n_gap, cfg,
                                            generator, n_valid, kmeans_tol)
  return labels, n_clusters, eigenvalues, max_delta


def spectral_cluster_fixed_k_batched(
    embeddings: torch.Tensor,
    keys,
    cfg: PipelineConfig,
    constraint_matrices: typing.Optional[torch.Tensor] = None,
    n_valid: typing.Optional[torch.Tensor] = None,
    kmeans_tol: float = 0.001,
    timings=None,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """The JAX package's vmap of ``spectral_cluster_fixed_k``
  (pipeline.py:422-486) over a chunk of padded utterances, as one program.

  ``embeddings`` (B, N, d) on the device that runs the chunk; ``keys``
  (B, 2) uint32 JAX key data (``prng.key(seed + i)`` for JAX's
  ``PRNGKey(seed + i)``), host data; ``constraint_matrices`` (B, N, N) or
  None; ``n_valid`` (B,) integer tensor or None (every row valid). Returns
  tensors (labels (B, N), n_clusters (B,), eigenvalues, max_delta (B,)),
  utterance b's those of ``spectral_cluster_fixed_k`` on it alone with the
  generator of its key's seed. With ``cfg.autotune`` every utterance's
  level-1 sweep runs as one (B·C, N, N) batch. Without it, ``timings``
  records the GENERAL route's host eig of the chunk as the stage
  "host_eig".
  """
  _require_max_clusters(cfg)
  _check_supported(cfg)
  b, n = embeddings.shape[:2]
  dev = embeddings.device
  n_valid = (torch.full((b,), n, dtype=torch.int32, device=dev)
             if n_valid is None else
             torch.as_tensor(n_valid).to(device=dev, dtype=torch.int32))
  with fp32_precision():
    affinity = prepare_affinity(embeddings, cfg, n_valid, constraint_matrices)
    if cfg.autotune is not None:
      if RefinementName.RowWiseThreshold not in (
          cfg.refinement_options.refinement_sequence or ()):
        raise ValueError(
            "AutoTune is only effective when the refinement sequence "
            "contains RowWiseThreshold")
      ps = torch.as_tensor(cfg.autotune.candidates(), dtype=torch.float32,
                           device=dev).expand(b, -1)
      ws, vs, ns, deltas = evaluate_candidates_batched(
          affinity, cfg, ps, n_valid, constraint_matrices, cfg.max_clusters)
      best = torch.argmin(_proxy_ratios(cfg.autotune.proxy, ps, deltas),
                          dim=1)

      def pick(t):
        idx = best.reshape((b, 1) + (1,) * (t.dim() - 2))
        return torch.take_along_dim(t, idx, dim=1)[:, 0]

      eigenvalues, eigenvectors, n_gap, max_delta = (
          pick(ws), pick(vs), pick(ns), pick(deltas))
    else:
      eigenvalues, eigenvectors, n_gap, max_delta = refine_and_eigendecompose(
          affinity, cfg, n_valid=n_valid, consume_input=True, timings=timings,
          constraint_matrix=constraint_matrices)
    del affinity
    labels, n_clusters = _cluster_from_eigs_batched(
        eigenvectors, n_gap, cfg, keys, n_valid, kmeans_tol)
  return labels, n_clusters, eigenvalues, max_delta


def _staged_applicable(cfg: PipelineConfig,
                       with_constraint: bool = False) -> bool:
  """Whether the staged executor can split this configuration (JAX
  pipeline.py:522-532): a symmetric or diagonal-similar structure, a
  symmetric solver, no in-graph autotune."""
  if cfg.autotune is not None:
    return False
  if cfg.eigensolver == EigenSolver.SubspaceIteration:
    if cfg.max_clusters is None:
      return False
  elif cfg.eigensolver not in (EigenSolver.Auto, EigenSolver.Eigh):
    return False
  return _eig_structure(cfg, with_constraint) != refinement_ops.GENERAL


def _staged_eig_applicable(cfg: PipelineConfig,
                           with_constraint: bool = False) -> bool:
  """Whether eig_topk_staged can run this configuration (JAX
  pipeline.py:651-660): a symmetric or diagonal-similar structure, a
  symmetric solver and max_clusters."""
  if _eig_structure(cfg, with_constraint) == refinement_ops.GENERAL:
    return False
  if cfg.eigensolver not in (EigenSolver.Auto, EigenSolver.Eigh,
                             EigenSolver.SubspaceIteration):
    return False
  return cfg.max_clusters is not None


def eig_topk_staged(
    affinity: torch.Tensor,
    cfg: PipelineConfig,
    constraint_matrix: typing.Optional[torch.Tensor] = None,
    n_valid=None,
    p_percentile=None,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """Refine (-> constraint after) -> top-k eig -> gap for one p_percentile,
  at large N.

  Port of the JAX evaluator (pipeline.py:766-837). ``affinity`` already
  carries a constraint applied before refinement; ``constraint_matrix``
  applies here only after it. The middle stage is the subspace iteration
  for Auto and SubspaceIteration (ascending on a Laplacian); the full eigh
  for Eigh, and past ``dc_max_block`` the exact top-k route
  (``_dc_topk``). Returns tensors (eigenvalues, eigenvectors[:, :k_cap],
  n_gap, max_delta), k_cap = max(max_clusters, min_clusters): the columns
  downstream K-Means can read. ``affinity`` is not modified.
  """
  _check_supported(cfg)
  with_constraint = constraint_matrix is not None
  if not _staged_eig_applicable(cfg, with_constraint):
    raise ValueError("eig_topk_staged: config requires the general-eig or "
                     "unbounded-k path; use refine_and_eigendecompose.")
  descend = _descend(cfg)
  k_cap = max(cfg.max_clusters, cfg.min_clusters or 0)
  with fp32_precision():
    m, scale = _symmetric_eig_operand(affinity, cfg, p_percentile, n_valid,
                                      _eig_structure(cfg, with_constraint),
                                      constraint_matrix=constraint_matrix)
    wmax = None
    if cfg.eigensolver != EigenSolver.Eigh:
      w, u = _subspace(m, cfg, n_valid, descend)
      wmax = _valid_gershgorin(m, n_valid)
    elif pad_bucket(m.shape[0]) > cfg.dc_max_block:
      w, u, wmax = _dc_topk(m, cfg, n_valid, descend)
    else:
      w, u = eigen_ops.sorted_eigh(m, descend=descend)
    del m
    eigenvectors = eigen_ops.recover_similarity_eigenvectors(u, scale, n_valid)
    eigenvalues, n_gap, max_delta = _gap(
        w, cfg, descend, n_valid if wmax is None else None, wmax)
  return eigenvalues, eigenvectors[:, :k_cap], n_gap, max_delta


def spectral_cluster_fixed_k_staged(
    embeddings: torch.Tensor,
    generator: torch.Generator,
    cfg: PipelineConfig,
    n_valid=None,
    timings=None,
    constraint_matrix: typing.Optional[torch.Tensor] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """``spectral_cluster_fixed_k`` split at the eigensolver boundary.

  Stages: "staged_prep" (affinity + constraint + refinement + eigen
  operand), then "staged_subspace" (SubspaceIteration), "staged_dc" (the
  exact top-k route) or "staged_eigh" (full eigh), then "staged_finish"
  (snap, eigengap, K-Means). With
  ``timings`` (an observability.StageTimings) each stage's duration is
  recorded. A configuration the executor cannot split
  (``_staged_applicable``: the GENERAL structure, HostGeneral, in-graph
  autotune) runs as ``spectral_cluster_fixed_k``.

  Routes, as in the JAX executor:
    * SubspaceIteration: top-k subspace iteration; the snap and the
      NormalizedDiff denominator use the operand's valid Gershgorin bound
      as the full-spectrum scale.
    * Auto with pad_bucket(N) > dc_max_block: the exact top-k route
      (``ops/dc.eigh_topk_dc``); only the max_clusters+1 extreme
      eigenpairs in scan order go on, snapped against its norm estimate.
    * otherwise: full eigh, all N eigenvalues.
  """
  _require_max_clusters(cfg)
  with_constraint = constraint_matrix is not None
  if not _staged_applicable(cfg, with_constraint):
    return spectral_cluster_fixed_k(embeddings, generator, cfg, n_valid,
                                    timings=timings,
                                    constraint_matrix=constraint_matrix)
  _check_supported(cfg)
  structure = _eig_structure(cfg, with_constraint)
  descend = _descend(cfg)

  with fp32_precision():
    with _stage(timings, "staged_prep"):
      affinity = prepare_affinity(embeddings, cfg, n_valid, constraint_matrix)
      m, scale = _symmetric_eig_operand(affinity, cfg, None, n_valid,
                                        structure, consume_input=True,
                                        constraint_matrix=constraint_matrix)
      del affinity
    wmax = None
    if cfg.eigensolver == EigenSolver.SubspaceIteration:
      with _stage(timings, "staged_subspace"):
        w, u = _subspace(m, cfg, n_valid, descend)
        wmax = _valid_gershgorin(m, n_valid)
    elif (cfg.eigensolver == EigenSolver.Auto
          and pad_bucket(m.shape[0]) > cfg.dc_max_block):
      with _stage(timings, "staged_dc"):
        w, u, wmax = _dc_topk(m, cfg, n_valid, descend)
    else:
      with _stage(timings, "staged_eigh"):
        w, u = eigen_ops.sorted_eigh(m, descend=descend)
    del m
    with _stage(timings, "staged_finish"):
      eigenvectors = eigen_ops.recover_similarity_eigenvectors(u, scale,
                                                               n_valid)
      eigenvalues, n_gap, max_delta = _gap(
          w, cfg, descend, n_valid if wmax is None else None, wmax)
      labels, n_clusters = _cluster_from_eigs(eigenvectors, n_gap, cfg,
                                              generator, n_valid, 0.001)
  return labels, n_clusters, eigenvalues, max_delta
