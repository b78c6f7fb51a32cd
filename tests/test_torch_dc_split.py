"""The port's spectral divide-and-conquer (``ops/dc.py``'s route "split")
against the JAX package and numpy (CPU).

Live against the JAX package, at n ≤ 256 and "highest" precision, on the
same numpy inputs: ``matrix_sign`` (allclose 1e-5) and both sign-chain
schedules, ``_sign_prep_math`` / ``_sign_finish_math`` (sigma and alpha to
float32 rounding of their sums, rtol 1e-5; k_f and b_f within 1e-3),
``_orth_qr`` / ``_cholqr2_shifted`` (equal spans; the Cholesky breakdown
zeroes the same columns), the block programs (the same selected pairs,
values allclose 1e-5). The JAX sign chain itself is not run end to end
here: ``tests/data/reference_dc.npz`` holds its results, written by
``tools/record_dc_reference.py``.

On ``fixtures.DC_SPECTRA`` (the spectra of ``tests/test_eigen_dc.py``) the
port's split is held to a float64 numpy eigh with that file's ``_check``
tolerances (eigenvalues 5e-4·λmax, residuals 5e-3·λmax, Gram 5e-3, norm
estimate within 0.3–3.2× of ‖A‖₂) and to the recorded JAX run: eigenvalues
within 5e-4·scale and the same branch at every level. The staged pipeline
with the split forced gives the recorded JAX labels.
"""

import contextlib
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import pipeline as j_pipeline
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu.ops import dc as j_dc
from spectralcluster_tpu.ops import eigen as j_eigen
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import pipeline
from spectralcluster_tpu_torch import precision
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.fixtures import DC_SPECTRA, make_dc_spectrum
from spectralcluster_tpu_torch.ops import dc
from spectralcluster_tpu_torch.ops import eigen as eigen_ops

torch.set_num_threads(1)

REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "reference_dc.npz")
T = 8


@pytest.fixture(scope="module")
def ref():
  with np.load(REFERENCE) as f:
    return dict(f)


def _sym(n, eigs, seed):
  q, _ = np.linalg.qr(np.random.RandomState(seed).randn(n, n))
  return ((q * np.asarray(eigs)[None, :]) @ q.T).astype(np.float32)


def _branches(info):
  return [f"{lv['depth']}:{lv['branch']}" for lv in info["levels"]]


# ---------------------------------------------------------------------------
# The sign chain against the live JAX pieces.
# ---------------------------------------------------------------------------


def _sign_operand(n=192):
  # test_eigen_dc.py:49-59: a split spectrum, pre-scaled by its Gershgorin
  # bound.
  h = _sym(n, np.concatenate([np.linspace(-3, -0.01, 90),
                              np.linspace(0.02, 5, n - 90)]), seed=1)
  return h / np.abs(h).sum(1).max()


def test_matrix_sign_matches_jax():
  x = _sign_operand()
  got = dc.matrix_sign(torch.as_tensor(x), "highest").numpy()
  want = np.asarray(j_dc.matrix_sign(jnp.asarray(x), "highest"))
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
  assert np.abs(got @ got - np.eye(x.shape[0])).max() < 2e-3


@pytest.mark.parametrize("schedule", ["in_graph", "host_staged"])
@pytest.mark.parametrize("n_valid", [None, 200])
def test_sign_project_matches_jax(schedule, n_valid, monkeypatch):
  # Both schedules of JAX's _sign_project (dc.py:382-415): the in-graph
  # loops, and past _SIGN_SPLIT_N (patched to 64) the host-staged steps.
  n = 256
  a = _sym(n, np.concatenate([np.linspace(2.0, 3.0, 40),
                              np.linspace(-1.0, 0.2, n - 40)]), seed=2)
  m_j, m_t = jnp.asarray(a), torch.as_tensor(a)
  if n_valid is not None:
    m_j = j_eigen.apply_padding_sentinels(m_j, n_valid, True)
    m_t = eigen_ops.apply_padding_sentinels(m_t, n_valid, True)
  if schedule == "host_staged":
    monkeypatch.setattr(j_dc, "_SIGN_SPLIT_N", 64)
    monkeypatch.setattr(dc, "_SIGN_SPLIT_N", 64)
  want = jax.device_get(j_dc._sign_project(m_j, n_valid, n, True,
                                           n_valid is not None, "highest"))
  rec = {"seconds": {}}
  got = dc._sign_project(m_t, n_valid, True, "highest", n, rec)
  np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5, rtol=0)
  for g, w in zip(got[1:3], want[1:3]):          # k_f, b_f
    assert abs(g - float(w)) <= 1e-3
  np.testing.assert_allclose(got[3:5], np.asarray(want[3:5], np.float64),
                             rtol=1e-5)          # sigma, alpha
  _check_norm2(a, n_valid, got[3], got[5], float(want[5]))
  assert len(rec["sign_steps"]) == len(rec["seconds"]["sign_steps"])


def _check_norm2(a, n_valid, sigma, *estimates):
  """norm2 is 12 power steps from a fixed start vector, ×1.05, capped by
  alpha; the two packages start from other vectors, so each is held to
  ‖a − σI‖₂ over the valid block instead of to the other."""
  nv = a.shape[0] if n_valid is None else n_valid
  h = a[:nv, :nv].astype(np.float64) - sigma * np.eye(nv)
  hnorm = np.abs(np.linalg.eigvalsh(h)).max()
  for norm2 in estimates:
    assert 0.8 * hnorm <= norm2 <= 1.05 * hnorm * (1 + 1e-5)


@pytest.mark.parametrize("staged", [False, True])
def test_sign_chain_minimum_steps(staged, monkeypatch):
  # A zero operand stops moving at once: the in-graph schedule runs one
  # quintic and one cubic step, the host-staged one three quintic steps
  # before its first exit test. JAX's staged trace reports its count.
  n = 128
  monkeypatch.setattr(j_dc, "_SIGN_SPLIT_N", 64 if staged else 12288)
  steps = []
  dc._sign_chain(torch.zeros(n, n), "highest", 3 if staged else 1, n, steps)
  assert [s for s, _ in steps] == (["quintic"] * (3 if staged else 1)
                                   + ["cubic"])
  if staged:
    monkeypatch.setenv("SCT_DC_DEBUG", "1")
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
      j_dc._sign_project(jnp.zeros((n, n)), None, n, True, False, "highest")
    assert f"ran {len(steps)} steps" in buf.getvalue()


@pytest.mark.parametrize("descend", [True, False])
@pytest.mark.parametrize("n_valid", [None, 200])
def test_sign_prep_and_finish_match_jax(descend, n_valid):
  n = 256
  a = _sym(n, np.linspace(-2, 7, n), seed=3)
  m_j, m_t = jnp.asarray(a), torch.as_tensor(a)
  if n_valid is not None:
    m_j = j_eigen.apply_padding_sentinels(m_j, n_valid, descend)
    m_t = eigen_ops.apply_padding_sentinels(m_t, n_valid, descend)
  nv_j = None if n_valid is None else jnp.int32(n_valid)
  x0, sigma, alpha, norm2 = jax.device_get(j_dc._sign_prep_math(
      n, descend, n_valid is not None, m_j, nv_j))
  got = dc._sign_prep_math(m_t, n_valid, descend)
  np.testing.assert_allclose(got[0].numpy(), x0, atol=1e-6, rtol=1e-5)
  np.testing.assert_allclose([float(got[1]), float(got[2])],
                             [float(sigma), float(alpha)], rtol=1e-5)
  _check_norm2(a, n_valid, float(got[1]), float(got[3]), float(norm2))
  # The finish on one sign matrix (JAX's, at "highest").
  u = np.asarray(j_dc.matrix_sign(jnp.asarray(x0), "highest"))
  p, k_f, b_f = jax.device_get(j_dc._sign_finish_math(
      n, descend, n_valid is not None, jnp.asarray(u), jnp.float32, nv_j))
  gp, gk, gb = dc._sign_finish_math(torch.from_numpy(u.copy()), n_valid,
                                    descend)
  np.testing.assert_allclose(gp.numpy(), p, atol=1e-6, rtol=0)
  assert abs(float(gk) - float(k_f)) <= 1e-3
  assert abs(float(gb) - float(b_f)) <= 1e-3


# ---------------------------------------------------------------------------
# Orthonormalization and the block programs against the live JAX pieces.
# ---------------------------------------------------------------------------


def _projector(q):
  return q @ q.T


@pytest.mark.parametrize("orth", ["qr", "cholqr2"])
def test_orthonormalizers_match_jax_by_span(orth):
  # A panel of rank 12 in 16 live columns of 24: both keep an orthonormal
  # basis of the same span (column signs may differ between LAPACKs).
  rng = np.random.RandomState(4)
  y = rng.randn(256, 24).astype(np.float32)
  y[:, 12:16] = y[:, :4]
  col_ok = (np.arange(24) < 16).astype(np.float32)
  y *= col_ok[None, :]
  if orth == "qr":
    got = dc._orth_qr(torch.as_tensor(y), torch.as_tensor(col_ok)).numpy()
    want = np.asarray(j_dc._orth_qr(jnp.asarray(y), jnp.asarray(col_ok)))
  else:
    got = dc._cholqr2_shifted(torch.as_tensor(y),
                              torch.as_tensor(col_ok)).numpy()
    want = np.asarray(j_dc._cholqr2_shifted(jnp.asarray(y), 24,
                                            jnp.asarray(col_ok)))
  keep_g = np.linalg.norm(got, axis=0) > 0.5
  keep_w = np.linalg.norm(want, axis=0) > 0.5
  np.testing.assert_array_equal(keep_g, keep_w)
  assert keep_g.sum() == 12
  np.testing.assert_allclose(_projector(got[:, keep_g]),
                             _projector(want[:, keep_w]), atol=1e-5)
  # The 1e-6 Cholesky shift leaves the second pass ~1e-5 from orthonormal.
  np.testing.assert_allclose(got[:, keep_g].T @ got[:, keep_g],
                             np.eye(12), atol=1e-4)


def test_cholesky_breakdown_matches_jax():
  # test_eigen_dc.py:258-267: a NaN panel column poisons the shifted Gram
  # (its max diagonal is NaN); JAX's Cholesky then returns NaN and the
  # isfinite mask zeroes every column. An indefinite Gram gives a factor
  # of NaN in both.
  y = np.asarray(np.random.RandomState(5).randn(64, 8), np.float32)
  y[:, 3] = np.nan
  col_ok = np.ones((8,), np.float32)
  got = dc._cholqr2_shifted(torch.as_tensor(y), torch.as_tensor(col_ok))
  want = np.asarray(j_dc._cholqr2_shifted(jnp.asarray(y), 8,
                                          jnp.asarray(col_ok)))
  assert np.isfinite(got.numpy()).all()
  np.testing.assert_array_equal(got.numpy(), want)
  assert np.linalg.norm(want, axis=0).max() < 0.5
  indefinite = np.diag([1.0, 2.0, -1.0, 3.0]).astype(np.float32)
  lower = np.tril(np.ones((4, 4), bool))
  assert np.isnan(dc._cholesky(torch.as_tensor(indefinite)).numpy()[lower]).all()
  assert np.isnan(np.asarray(jnp.linalg.cholesky(indefinite))[lower]).all()


def _block_inputs(n=128, k_pad=32, k_eff=28, descend=True):
  """An operand, a basis with zeroed trailing columns, its Ritz block and
  that block's eigenpairs, as float32 numpy arrays."""
  a = _sym(n, np.concatenate([[9.0, 8.0, 7.5, 7.0, 6.0],
                              np.linspace(-1.0, 1.0, n - 5)]), seed=6)
  rng = np.random.RandomState(7)
  q = np.linalg.qr(rng.randn(n, k_pad))[0].astype(np.float32)
  q[:, k_eff:] = 0.0
  mq = a @ q
  a1 = np.asarray(j_eigen.apply_padding_sentinels(
      jnp.asarray(0.5 * (q.T @ mq + (q.T @ mq).T)), k_eff, descend))
  w, u = np.linalg.eigh(a1.astype(np.float64))
  return a, q, mq, w.astype(np.float32), u.astype(np.float32)


def _same(got, want):
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5,
                             rtol=1e-6)
  np.testing.assert_allclose(np.abs(got[1].numpy()),
                             np.abs(np.asarray(want[1])), atol=1e-5)
  np.testing.assert_allclose(got[2], float(want[2]), rtol=1e-4)


@pytest.mark.parametrize("descend", [True, False])
def test_block_programs_match_jax(descend):
  n, k_pad, t = 128, 32, 8
  a, q, mq, w, u = _block_inputs(descend=descend)
  scale = float(np.abs(np.linalg.eigvalsh(a.astype(np.float64))).max())
  T_ = torch.as_tensor
  _same(dc._back_transform(T_(w), T_(u), T_(q), T_(mq), t, scale, descend),
        j_dc._back_transform_jit(n, k_pad, t, descend)(
            w, u, q, mq, jnp.float32(scale)))
  _same(dc._verify_select(T_(a), T_(q), T_(w), T_(u), t, scale, descend),
        j_dc._verify_select_jit(n, k_pad, k_pad, t, descend)(
            a, q, w, u, jnp.float32(scale)))
  v = q @ u
  _same(dc._direct_verify(T_(a), T_(w), T_(v), t, scale, descend),
        j_dc._direct_verify_jit(n, k_pad, t, descend)(
            a, w, v, jnp.float32(scale)))
  # The merge: a remainder set duplicating one kept pair (dedup) beside
  # genuine ones.
  w64, v64 = np.linalg.eigh(a.astype(np.float64))
  order = np.argsort(-w64 if descend else w64)
  w64, v64 = w64[order].astype(np.float32), v64[:, order].astype(np.float32)
  w1, v1 = w64[:3], v64[:, :3]
  w2, v2 = w64[2:9], v64[:, 2:9]
  got = dc._merge_dedup(T_(w1), T_(w2), T_(v1), T_(v2), t, descend)
  want = j_dc._merge_dedup_jit(n, t, 3, 7, descend)(w1, w2, v1, v2)
  np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
  np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
  # The deflation.
  c = -20.0 if descend else 20.0
  np.testing.assert_allclose(
      dc._deflate(T_(a), T_(v1), T_(w1), c).numpy(),
      np.asarray(j_dc._deflate_jit(n, 3)(a, v1, w1, jnp.float32(c))),
      atol=1e-5)


# ---------------------------------------------------------------------------
# The whole split against numpy and the recorded JAX run.
# ---------------------------------------------------------------------------


def _degraded_capture(monkeypatch, stub):
  """Degrade the range capture as test_eigen_dc.py:219-240 and :285-312
  do: the first draw (or every draw) loses all its columns."""
  real = dc._project_block
  calls = {"n": 0}

  def degraded(*a, **kw):
    calls["n"] += 1
    q, mq, a1, k_eff = real(*a, **kw)
    if stub == "all" or calls["n"] == 1:
      return torch.zeros_like(q), torch.zeros_like(mq), a1, 0
    return q, mq, a1, k_eff

  monkeypatch.setattr(dc, "_project_block", degraded)
  return calls


@pytest.mark.parametrize("case", list(DC_SPECTRA))
def test_split_matches_numpy_and_jax(case, ref, monkeypatch):
  a, options = make_dc_spectrum(case)
  descend = options.get("descend", True)
  n_valid = options.get("n_valid")
  for name, value in options.get("patch", {}).items():
    monkeypatch.setattr(dc, name, value)
  calls = (_degraded_capture(monkeypatch, options["stub"])
           if "stub" in options else None)
  m = torch.as_tensor(a.astype(np.float32))
  if n_valid is not None:
    m = eigen_ops.apply_padding_sentinels(m, n_valid, descend)
  info = {}
  w, v, res, scale = dc.eigh_topk_dc(
      m, T, torch.Generator().manual_seed(0), descend=descend,
      n_valid=n_valid, max_block=options.get("max_block", 128),
      try_iterative_first=False, info=info)
  assert info["route"] == "split"
  w, v = w.numpy(), v.numpy()
  # numpy's float64 eigh, with test_eigen_dc.py's _check tolerances.
  nv = a.shape[0] if n_valid is None else n_valid
  w64 = np.linalg.eigh(a[:nv, :nv])[0]
  want = w64[::-1][:T] if descend else w64[:T]
  lam = np.abs(want).max()
  np.testing.assert_allclose(w, want, atol=5e-4 * lam, rtol=0)
  vres = np.linalg.norm(a[:nv, :nv] @ v[:nv] - v[:nv] * w[None, :], axis=0)
  assert vres.max() / lam < 5e-3
  np.testing.assert_allclose(v[:nv].T @ v[:nv], np.eye(T), atol=5e-3)
  anorm = np.abs(w64).max()
  assert 0.3 * anorm <= scale <= 3.2 * anorm
  # The recorded JAX run: eigenvalues, and the branch of every level.
  np.testing.assert_allclose(w, ref[f"{case}_w"],
                             atol=5e-4 * float(ref[f"{case}_scale"]))
  assert _branches(info) == list(ref[f"{case}_branches"])
  if calls is not None:
    # The forced redraw happened in both packages.
    assert [lv["redraws"] for lv in info["levels"]] == list(
        ref[f"{case}_redraws"])
    assert calls["n"] >= 2


def _icassp_cfg():
  return j_pipeline.PipelineConfig(
      refinement_options=j_configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, dc_max_block=48)


def _laplacian_cfg():
  return j_pipeline.PipelineConfig(
      refinement_options=j_types.RefinementOptions(
          thresholding_type=j_types.ThresholdType.Percentile,
          p_percentile=0.9,
          refinement_sequence=(j_types.RefinementName.RowWiseThreshold,
                               j_types.RefinementName.Symmetrize)),
      laplacian_type=j_types.LaplacianType.GraphCut,
      eigengap_type=j_types.EigenGapType.NormalizedDiff,
      min_clusters=1, max_clusters=5, row_wise_renorm=True, dc_max_block=48)


def _staged_embeddings(n=96, d=16, k=3, seed=0):
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  labels = np.repeat(np.arange(k), n // k)
  return (centers[labels] + rng.randn(n, d) * 0.3).astype(np.float32)


@pytest.mark.parametrize("case", ["icassp2018", "padded", "laplacian_ascend"])
def test_staged_split_labels_match_jax(case, ref, monkeypatch):
  # test_eigen_dc.py:341-419 with the certified route off in both
  # packages: the split answers at dc_max_block=48 (recursing past it).
  # The port's staged executor asks Lanczos first on a descending scan;
  # here it declines, so that the split answers as in JAX.
  n_valid = None
  if case == "laplacian_ascend":
    jcfg, x = _laplacian_cfg(), _staged_embeddings(seed=1)
  else:
    jcfg, x = _icassp_cfg(), _staged_embeddings()
  if case == "padded":
    x = np.concatenate([_staged_embeddings(n=90),
                        np.zeros((38, 16), np.float32)])
    n_valid = 90
  monkeypatch.setattr(dc, "_TRY_ITERATIVE_FIRST", False)
  monkeypatch.setattr(dc, "lanczos_topt",
                      lambda *a, **kw: (None, None, math.inf, None))
  infos, solve = [], dc.eigh_topk_dc

  def recording(*a, **kw):
    infos.append({})
    return solve(*a, info=infos[-1], **kw)

  monkeypatch.setattr(dc, "eigh_topk_dc", recording)
  labels, n_c, w, _ = pipeline.spectral_cluster_fixed_k_staged(
      torch.as_tensor(x), torch.Generator().manual_seed(0),
      convert.pipeline_config_from(jcfg), n_valid=n_valid)
  key = f"staged_{case}"
  assert [i["route"] for i in infos] == ["split"]
  assert _branches(infos[0]) == list(ref[f"{key}_branches"])
  assert int(n_c) == int(ref[f"{key}_n_clusters"])
  nv = x.shape[0] if n_valid is None else n_valid
  np.testing.assert_array_equal(
      utils.enforce_ordered_labels(labels[:nv].numpy()),
      utils.enforce_ordered_labels(ref[f"{key}_labels"][:nv]))
  want = ref[f"{key}_eigenvalues"]
  np.testing.assert_allclose(w.numpy(), want,
                             atol=5e-4 * float(np.abs(want).max()))


def test_pipeline_hands_the_solver_its_bucket_and_precision(monkeypatch):
  # _dc_topk passes dc_max_block for the recursion, the bucket JAX's
  # operand would have, and dc_sign_precision.
  seen = {}

  def fake(m, t, generator, **kw):
    seen.update(kw)
    return torch.ones(t), torch.eye(m.shape[0], t), 0.0, 1.0

  monkeypatch.setattr(dc, "eigh_topk_dc", fake)
  cfg = convert.pipeline_config_from(_icassp_cfg()).replace(
      dc_sign_precision="highest")
  pipeline._dc_topk(torch.eye(100), cfg, None, True)
  assert seen["max_block"] == 48 and seen["_n_bucket"] == 128
  assert seen["sign_precision"] == "highest"


# ---------------------------------------------------------------------------
# The precision mapping.
# ---------------------------------------------------------------------------


def test_tf32_split_is_exact():
  x = torch.as_tensor(np.random.RandomState(8).randn(64, 64).astype(
      np.float32) * 1e3)
  hi, lo = precision.tf32_split(x)
  assert torch.equal(hi + lo, x)
  assert int(torch.amax(hi.view(torch.int32) & 0x1FFF)) == 0
  assert float(torch.amax(torch.abs(lo) / torch.abs(x))) <= 2.0 ** -10


def test_three_pass_product_is_float32_accurate():
  # On the CPU each of the three products is IEEE float32: the split sum
  # must stay within a few float32 roundings of the float64 product.
  rng = np.random.RandomState(9)
  a = rng.randn(256, 192).astype(np.float32)
  b = rng.randn(192, 128).astype(np.float32)
  exact = a.astype(np.float64) @ b.astype(np.float64)
  ieee = precision.matmul(torch.as_tensor(a), torch.as_tensor(b), "highest")
  high = precision.matmul(torch.as_tensor(a), torch.as_tensor(b), "high")
  sq = precision.matmul(torch.as_tensor(a), torch.as_tensor(a.T.copy()),
                        "high")
  err = lambda c, e: float(np.abs(c.numpy() - e).max() / np.abs(e).max())  # noqa
  assert err(ieee, exact) < 1e-6
  assert err(high, exact) < 4 * err(ieee, exact) + 1e-7
  sq_exact = a.astype(np.float64) @ a.T.astype(np.float64)
  assert err(sq, sq_exact) < 1e-6


@pytest.mark.parametrize("name", ["bf16", "HIGH", "fastest"])
def test_unknown_precision_raises(name):
  with pytest.raises(ValueError, match="precision"):
    precision.matmul(torch.eye(4), torch.eye(4), name)
  a, _ = make_dc_spectrum("two_dominant_bulk")
  with pytest.raises(ValueError, match="precision"):
    dc.eigh_topk_dc(torch.as_tensor(a.astype(np.float32)), T,
                    torch.Generator().manual_seed(0), max_block=128,
                    try_iterative_first=False, sign_precision=name)


def test_flags_restored_and_default_precision(monkeypatch):
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
  try:
    torch.backends.cuda.matmul.allow_tf32 = True
    for p in precision.PRECISIONS:
      precision.matmul(torch.eye(8), torch.eye(8), p)
      assert torch.backends.cuda.matmul.allow_tf32
      assert torch.get_float32_matmul_precision() == "high"
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])
  assert dc._sign_precision() == j_dc._sign_precision() == "high"
  monkeypatch.setenv("SCT_DC_SIGN_PRECISION", "highest")
  assert dc._sign_precision() == j_dc._sign_precision() == "highest"
  info = {}
  a, _ = make_dc_spectrum("two_dominant_bulk")
  dc.eigh_topk_dc(torch.as_tensor(a.astype(np.float32)), T,
                  torch.Generator().manual_seed(0), max_block=128,
                  try_iterative_first=False, info=info)
  assert info["sign_precision"] == "highest"
