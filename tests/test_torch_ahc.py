"""The port's AHC chains: the C++ nn-chain (``native/``) against the port's
numpy chain and the JAX package's ``ahc``, on the same distances (CPU).

Native and numpy must give allclose merges and equal raw labels (both
first-appearance relabel), in the style of ``tests/test_ahc.py``; the
native chain must give the JAX package's labels id for id. A stream with
the native chain active must equal the JAX package's, step for step. The
native tests skip only where no g++ is present.
"""

import contextlib
import os
import shutil

import numpy as np
import pytest
import torch

from spectralcluster_tpu import ahc as j_ahc
from spectralcluster_tpu import clusterer as j_clusterer
from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import streaming as j_streaming
from spectralcluster_tpu_torch import ahc
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch.fixtures import make_stream
from spectralcluster_tpu_torch.kernels import build as build_lib
from spectralcluster_tpu_torch.native import ahc_native

torch.set_num_threads(1)



@pytest.fixture
def gxx():
  if shutil.which(os.environ.get("CXX") or "g++") is None:
    pytest.skip("no g++: the native chain cannot be built here")


def _dist(n=50, seed=0):
  rng = np.random.RandomState(seed)
  return ahc.cosine_distance_matrix(rng.randn(n, 6))


@contextlib.contextmanager
def _numpy_chain():
  orig = ahc._native_ok
  ahc._native_ok = lambda: False
  try:
    yield
  finally:
    ahc._native_ok = orig


def test_native_builds_into_the_port_build_dir(gxx):
  assert ahc.backend() == "native"
  path = ahc_native.library_path()
  assert os.path.exists(path)
  assert os.path.dirname(path) == build_lib.build_dir()
  assert os.path.basename(path).startswith("libsct_ahc_")
  assert "-march=native" not in ahc_native.CXX_FLAGS
  assert "-std=c++17" in ahc_native.CXX_FLAGS
  with _numpy_chain():
    assert ahc.backend() == "numpy"


@pytest.mark.parametrize("linkage", ["complete", "average", "single"])
def test_linkage_native_matches_numpy_and_jax(gxx, linkage):
  d = _dist()
  native = ahc.nn_chain_linkage(d, linkage)
  with _numpy_chain():
    ref = ahc.nn_chain_linkage(d, linkage)
  np.testing.assert_allclose(native, ref)
  np.testing.assert_allclose(native, j_ahc.nn_chain_linkage(d, linkage))


@pytest.mark.parametrize("cut", [("complete", 5, None), ("average", None, 0.4),
                                 ("complete", 100, None)])
def test_labels_native_matches_numpy_and_jax(gxx, cut):
  linkage, k, thr = cut
  d = _dist(n=120, seed=3)
  native = ahc.ahc_labels(d, linkage, k, thr)
  with _numpy_chain():
    ref = ahc.ahc_labels(d, linkage, k, thr)
  # Raw equality, not just the same partition.
  np.testing.assert_array_equal(native, ref)
  np.testing.assert_array_equal(native, j_ahc.ahc_labels(d, linkage, k, thr))


def test_raw_labels_agree_fuzz(gxx):
  rng = np.random.RandomState(7)
  for _ in range(25):
    n = rng.randint(2, 30)
    d = ahc.cosine_distance_matrix(rng.randn(n, 5))
    for linkage in ("complete", "average"):
      kw = ({"n_clusters": int(rng.randint(1, n + 1))} if rng.rand() < 0.5
            else {"distance_threshold": float(rng.uniform(0, 2))})
      native = ahc.ahc_labels(d, linkage, **kw)
      with _numpy_chain():
        ref = ahc.ahc_labels(d, linkage, **kw)
      np.testing.assert_array_equal(native, ref)
      np.testing.assert_array_equal(native, j_ahc.ahc_labels(d, linkage, **kw))


def test_bad_args_raise_on_either_chain():
  for chain in (contextlib.nullcontext, _numpy_chain):
    with chain():
      with pytest.raises(ValueError):
        ahc.ahc_labels(np.zeros((3, 3)), "complete", None, None)
      with pytest.raises(ValueError):
        ahc.nn_chain_linkage(np.zeros((3, 3)), "ward")


def test_stream_with_native_chain_matches_jax(gxx):
  # A stream past U1 with two compressions, no deflicker: every step's raw
  # label history equals the JAX package's (whose pre-clustering also runs
  # its native chain), and the port's pre-clustering went through the C++
  # chain. The recorded 1,500-step histories are held on the card
  # (chip_smoke.py): on this CPU the JAX package itself leaves them at a
  # K-Means near tie of step 50.
  stream, _ = make_stream(120, d=16)
  jax_ms = j_streaming.MultiStageClusterer(
      main_clusterer=j_clusterer.SpectralClusterer(
          min_clusters=2, max_clusters=7,
          refinement_options=j_configs.icassp2018_refinement_options()),
      fallback_threshold=0.5, L=10, U1=20, U2=60)
  ms = convert.multi_stage_from(jax_ms, device="cpu")
  calls = []
  native_labels = ahc_native.ahc_labels
  ahc_native.ahc_labels = lambda *a: calls.append(a[2]) or native_labels(*a)
  try:
    for step, e in enumerate(stream, start=1):
      np.testing.assert_array_equal(ms.streaming_predict(e),
                                    jax_ms.streaming_predict(e),
                                    err_msg=f"step {step}")
  finally:
    ahc_native.ahc_labels = native_labels
  np.testing.assert_array_equal(ms.compression_labels,
                                jax_ms.compression_labels)
  assert calls.count(20) == len(stream) - 20
