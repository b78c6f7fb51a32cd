"""The port's kernel wrappers (plain twins on the CPU) vs the Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as tests/test_kernels.py
runs them. Inputs are made with numpy from a seed and handed to both.
The CUDA kernels themselves are held against the same twins on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralcluster_tpu.kernels import fused as jax_fused
from spectralcluster_tpu.ops import quantile as jax_quantile
from spectralcluster_tpu.ops import refinement as jax_ref
from spectralcluster_tpu_torch.kernels import build
from spectralcluster_tpu_torch.kernels import fused
from spectralcluster_tpu_torch.ops import quantile as quantile_ops
from spectralcluster_tpu_torch.ops import refinement as t_ref

torch.set_num_threads(1)


def _mat(n, seed, shift=0.0):
  rng = np.random.RandomState(seed)
  return rng.rand(n, n).astype(np.float32) + np.float32(shift)


def _t(a):
  return torch.as_tensor(np.array(a))


@pytest.fixture(autouse=True)
def _counts():
  fused.reset_launch_counts()
  yield
  # A CPU tensor takes the plain twin: no kernel is ever launched here.
  assert all(v == 0 for v in fused.launch_counts().values())


@pytest.mark.parametrize("n,d", [(256, 64), (128, 32), (100, 20)])
def test_affinity_matches_pallas(n, d):
  x = np.random.RandomState(0).randn(n, d).astype(np.float32)
  ours = fused.affinity(_t(x))
  ref = jax_fused.affinity_pallas(jnp.asarray(x), interpret=True)
  # The float32 sums of the product run in another order.
  np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-6)


@pytest.mark.parametrize("n,d", [(1, 1), (127, 33), (129, 257), (100, 20)])
def test_affinity_operand_feeds_the_pallas_product(n, d):
  # The CUDA kernel's operand: xnᵀ zero-padded to whole tiles and k slices.
  # Its padded product, cut to (N, N), is the Pallas kernel's affinity.
  x = np.random.RandomState(1).randn(n, d).astype(np.float32)
  xn = fused.normalize_rows(_t(x))
  xt = fused.affinity_operand(xn)
  d_pad, n_pad = xt.shape
  assert n_pad % fused.AFFINITY_TILE == 0 and n <= n_pad < n + 128
  assert d_pad % fused.AFFINITY_DEPTH == 0 and d <= d_pad < d + 16
  assert xt.is_contiguous()
  assert torch.equal(xt[:d, :n], xn.T)
  assert not xt[d:].any() and not xt[:, n:].any()
  ours = (torch.matmul(xt.T, xt)[:n, :n] + 1.0) * 0.5
  ref = jax_fused.affinity_pallas(jnp.asarray(x), interpret=True)
  np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-6)


@pytest.mark.parametrize("b,n,d", [(2, 100, 33), (1, 64, 256), (3, 7, 1)])
def test_row_major_operand_feeds_the_pallas_product(b, n, d):
  # The batched CUDA kernel's operand: the normalized rows as they are,
  # zero-padded to whole float4s only where d % 4 != 0. Its product is the
  # Pallas kernel's affinity on each utterance.
  x = np.random.RandomState(2).randn(b, n, d).astype(np.float32)
  xn = fused.normalize_rows(_t(x))
  op = fused.row_major_operand(xn)
  d4 = -(-d // 4) * 4
  assert tuple(op.shape) == (b, n, d4) and op.is_contiguous()
  assert torch.equal(op[..., :d], xn) and not op[..., d:].any()
  if d == d4:
    assert op.data_ptr() == xn.data_ptr()
  ours = (torch.matmul(op, op.transpose(1, 2)) + 1.0) * 0.5
  for i in range(b):
    ref = jax_fused.affinity_pallas(jnp.asarray(x[i]), interpret=True)
    np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_ptxas_report_reads_each_kernel(tmp_path):
  log = tmp_path / "libsct_fused_x.so.log"
  log.write_text(
      "nvcc -Xptxas -v ...\n"
      "ptxas info    : Compiling entry function "
      "'_ZN12_GLOBAL__N_115affinity_kernelEPKfPfiii' for 'sm_90a'\n"
      "ptxas info    : Function properties for "
      "_ZN12_GLOBAL__N_115affinity_kernelEPKfPfiii\n"
      "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
      "ptxas info    : Used 128 registers, used 1 barriers, 384 bytes cmem[0]\n"
      "ptxas info    : Compiling entry function "
      "'_ZN12_GLOBAL__N_114row_max_kernelEPKfPfiiii' for 'sm_90a'\n"
      "ptxas info    : Function properties for "
      "_ZN12_GLOBAL__N_114row_max_kernelEPKfPfiiii\n"
      "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
      "ptxas info    : Used 32 registers, 8448 bytes smem, 384 bytes cmem[0]\n"
      "ptxas info    : Compiling entry function "
      "'_ZN12_GLOBAL__N_114row_max_kernelILb1EEEvPKfPfiii' for 'sm_90a'\n"
      "ptxas info    : Function properties for "
      "_ZN12_GLOBAL__N_114row_max_kernelILb1EEEvPKfPfiii\n"
      "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
      "ptxas info    : Used 40 registers, used 0 barriers\n"
      "ptxas info    : Compiling entry function "
      "'_ZN12_GLOBAL__N_114row_max_kernelILb0ELb1EEEvPKfPfiiiPKii' for "
      "'sm_90a'\n"
      "ptxas info    : Function properties for "
      "_ZN12_GLOBAL__N_114row_max_kernelILb0ELb1EEEvPKfPfiiiPKii\n"
      "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
      "ptxas info    : Used 32 registers, used 0 barriers\n")
  report = build.ptxas_report(str(log)[:-len(".log")])
  assert report == {
      "affinity_kernel": {"registers": 128, "static_smem": 0,
                          "spill_stores": 0, "spill_loads": 0},
      "row_max_kernel": {"registers": 32, "static_smem": 8448,
                         "spill_stores": 4, "spill_loads": 8},
      "row_max_kernel<true>": {"registers": 40, "static_smem": 0,
                               "spill_stores": 0, "spill_loads": 0},
      "row_max_kernel<false,true>": {"registers": 32, "static_smem": 0,
                                     "spill_stores": 8, "spill_loads": 8},
  }


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("n_valid", [None, 200])
def test_row_max_matches_pallas(exclude, n_valid):
  a = _mat(256, 3, shift=-0.7)
  ours = fused.row_max(_t(a), exclude_diagonal=exclude, n_valid=n_valid)
  ref = jax_fused.row_max_pallas(jnp.asarray(a), exclude_diagonal=exclude,
                                 n_valid=n_valid, interpret=True)
  assert ours.shape == (256, 1)
  np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shift", [0.0, -10.0])
@pytest.mark.parametrize("n_valid", [None, 100])
def test_crop_diagonal_matches_pallas(shift, n_valid):
  a = _mat(128, 4, shift)
  ours = fused.crop_diagonal(_t(a), n_valid=n_valid)
  ref = jax_fused.crop_diagonal_pallas(jnp.asarray(a), n_valid=n_valid,
                                       interpret=True)
  np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_crop_diagonal_in_place_flag_keeps_cpu_input():
  a = _t(_mat(64, 5))
  before = a.clone()
  out = fused.crop_diagonal(a, inplace=True)
  assert torch.equal(a, before)
  assert torch.equal(out, fused.crop_diagonal_plain(before))


@pytest.mark.parametrize("percentile", [False, True])
@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("binarize,preserve", [(False, False), (True, True),
                                               (True, False)])
def test_threshold_symmetrize_matches_pallas(percentile, average, binarize,
                                             preserve):
  a = _mat(128, 6)
  p = 0.7
  base = a.copy()
  if preserve:
    np.fill_diagonal(base, 0.0)
  if percentile:
    thr = np.asarray(jax_quantile.quantile_from_sorted(
        jax_quantile.sort_rows(jnp.asarray(base)), p))[:, None]
    ours_thr = quantile_ops.quantile_from_sorted(
        quantile_ops.sort_rows(_t(base)), p)[:, None]
    np.testing.assert_array_equal(ours_thr.numpy(), thr)
  else:
    thr = np.asarray(jax_fused.row_max_pallas(
        jnp.asarray(a), exclude_diagonal=preserve, interpret=True)) * p
  ours = fused.threshold_symmetrize_general(
      _t(a), _t(thr), multiplier=0.01, binarize=binarize,
      preserve_diagonal=preserve, average=average)
  ref = jax_fused.threshold_symmetrize_general_pallas(
      jnp.asarray(a), jnp.asarray(thr), multiplier=0.01, binarize=binarize,
      preserve_diagonal=preserve, average=average, interpret=True)
  np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
  np.testing.assert_array_equal(ours.numpy(), ours.numpy().T)


@pytest.mark.parametrize("shift", [0.0, -0.3])
@pytest.mark.parametrize("n_valid", [None, 200])
def test_row_wise_normalize_matches_pallas(shift, n_valid):
  # The contract is mask_padding(row_wise_normalize_pallas(...)): callers
  # re-mask padding. Both divide in IEEE float32, so the match is exact.
  a = _mat(256, 7, shift)
  ours = t_ref.mask_padding(fused.row_wise_normalize(_t(a), n_valid), n_valid)
  ref = jax_ref.mask_padding(jax_fused.row_wise_normalize_pallas(
      jnp.asarray(a), n_valid=n_valid, interpret=True), n_valid)
  np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_wrappers_refuse_other_devices():
  # Neither CPU nor CUDA: the wrapper raises instead of taking the twin.
  meta = torch.empty((8, 8), device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    fused.row_max(meta)
  with pytest.raises(ValueError, match="unsupported device"):
    fused.affinity(torch.empty((8, 4), device="meta"))


def test_launch_counters_are_plain_integers():
  for fn in fused.WRAPPERS:
    assert isinstance(fn.launches, int)
  assert set(fused.launch_counts()) == {
      "affinity", "row_max", "crop_diagonal", "threshold_symmetrize_general",
      "row_wise_normalize", "affinity_batched", "row_max_batched",
      "crop_diagonal_batched", "threshold_symmetrize_general_batched",
      "row_wise_normalize_batched", "panel_matmul", "cholqr_pass"}
