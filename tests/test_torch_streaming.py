"""The port's streaming (``MultiStageClusterer``, ``match_labels``,
``hungarian``) vs the JAX package's, on the same numpy inputs (CPU).

Streams run through both packages with the same configuration (the JAX
clusterer carried across with ``convert.multi_stage_from``). Label
histories must be equal at every step, label ids included: the port's
k-means++ draws are the JAX package's (``prng.py``). The host-numpy pieces
(``match_labels``, ``linear_sum_assignment``, the fixture) must agree
exactly. Sizes are the JAX tests' own: ``SCRIPT`` with L=3, U1=5, U2=7
(``tests/test_multi_stage.py``) and one 240-step stream with L=10, U1=20,
U2=60.
"""

import ast
import functools
import os

import numpy as np
import pytest
import torch

from spectralcluster_tpu import clusterer as j_clusterer
from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import hungarian as j_hungarian
from spectralcluster_tpu import streaming as j_streaming
from spectralcluster_tpu import types as j_types
from spectralcluster_tpu_torch import convert
from spectralcluster_tpu_torch import hungarian
from spectralcluster_tpu_torch import streaming
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.fixtures import make_stream
from spectralcluster_tpu_torch.types import Deflicker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_order = utils.enforce_ordered_labels
DEFLICKERS = ("NoDeflicker", "OrderBased", "Hungarian")

# tests/test_multi_stage.py's SCRIPT.
SCRIPT = [
    [1, 2], [3, -1], [1, 1], [-2, -1], [0, 1], [-2, 0], [1, 2], [3, -1],
    [1, 1], [-2, -1], [0, 1], [-2, 0], [1, 2], [3, -1], [1, 1], [-2, -1],
]

# tests/test_multi_stage.py's TestMatchLabels: (current, previous, expected).
MATCH_CASES = {
    "short": ([1, 0], [0], [0, 1]),
    "current_more": ([0, 1, 2, 3, 4, 5], [0, 0, 0, 1, 2], [0, 3, 4, 1, 2, 5]),
    "previous_more": ([0, 0, 0, 1, 1, 1, 2, 2], [0, 0, 1, 2, 2, 3, 4],
                      [0, 0, 0, 2, 2, 2, 4, 4]),
    "medium": ([1, 1, 1, 0, 0, 1], [0, 0, 0, 1, 1], [0, 0, 0, 1, 1, 0]),
    "medium_new_speaker": ([1, 1, 1, 0, 0, 2], [0, 0, 0, 1, 1],
                           [0, 0, 0, 1, 1, 2]),
    "medium_no_order_based": ([0, 1, 1, 0, 0, 2], [0, 0, 0, 1, 1],
                              [1, 0, 0, 1, 1, 2]),
    "long": ([0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5],
             [0, 0, 3, 3, 1, 1, 4, 4, 5, 5, 2],
             [0, 0, 3, 3, 1, 1, 4, 4, 5, 5, 2, 2]),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_labels_matches_jax(case):
  current, previous, expected = (np.array(a) for a in MATCH_CASES[case])
  ours = streaming.match_labels(current, previous)
  np.testing.assert_array_equal(ours, expected)
  np.testing.assert_array_equal(
      ours, j_streaming.match_labels(current, previous))


def test_match_labels_shape_mismatch():
  for match in (streaming.match_labels, j_streaming.match_labels):
    with pytest.raises(ValueError):
      match(np.array([0, 1, 1]), np.array([0]))


def _script_pair(deflicker: str):
  """The JAX test's multi-stage clusterer (L=3, U1=5, U2=7) and the port's
  counterpart on the CPU."""
  jax_ms = j_streaming.MultiStageClusterer(
      main_clusterer=j_clusterer.SpectralClusterer(
          refinement_options=j_types.RefinementOptions(
              gaussian_blur_sigma=0, p_percentile=0.95,
              refinement_sequence=j_configs.ICASSP2018_REFINEMENT_SEQUENCE)),
      fallback_threshold=0.5, L=3, U1=5, U2=7,
      deflicker=j_types.Deflicker[deflicker])
  return jax_ms, convert.multi_stage_from(jax_ms, device="cpu")


@functools.lru_cache(maxsize=None)
def _script_outputs(deflicker: str):
  """Both packages' outputs after each of the 16 SCRIPT steps."""
  jax_ms, ms = _script_pair(deflicker)
  return [(ms.streaming_predict(np.array(e)),
           jax_ms.streaming_predict(np.array(e))) for e in SCRIPT]


@pytest.mark.parametrize("steps", range(1, len(SCRIPT) + 1))
@pytest.mark.parametrize("deflicker", DEFLICKERS)
def test_script_matches_jax(deflicker, steps):
  ours, theirs = _script_outputs(deflicker)[steps - 1]
  assert ours.shape == theirs.shape == (steps,)
  np.testing.assert_array_equal(ours, theirs)


def test_chain_dtype_quirk_preserved():
  # chain_labels returns float64 once a compression chain exists (the
  # reference's quirk, kept by the JAX package).
  ours, theirs = _script_outputs("NoDeflicker")[-1]
  assert ours.dtype == theirs.dtype == np.float64


def test_stream_matches_jax():
  # The JAX streaming bench's main clusterer at small L/U1/U2: four
  # compressions (at steps 60, 100, 140, ...) and the Hungarian deflicker
  # over the factored history.
  stream, _ = make_stream(240, d=16)
  jax_ms = j_streaming.MultiStageClusterer(
      main_clusterer=j_clusterer.SpectralClusterer(
          min_clusters=2, max_clusters=7,
          refinement_options=j_configs.icassp2018_refinement_options()),
      fallback_threshold=0.5, L=10, U1=20, U2=60,
      deflicker=j_types.Deflicker.Hungarian)
  ms = convert.multi_stage_from(jax_ms, device="cpu")
  for step, e in enumerate(stream, start=1):
    ours, theirs = ms.streaming_predict(e), jax_ms.streaming_predict(e)
    np.testing.assert_array_equal(ours, theirs, err_msg=f"step {step}")
  np.testing.assert_array_equal(ms.compression_labels,
                                jax_ms.compression_labels)
  assert ms.cache.shape == jax_ms.cache.shape


def test_stride1_equals_per_step():
  _, per = _script_pair("NoDeflicker")
  _, batched = _script_pair("NoDeflicker")
  out = None
  for e in SCRIPT[:10]:
    out = per.streaming_predict(np.array(e))
  np.testing.assert_array_equal(
      out, batched.streaming_predict_batch(np.array(SCRIPT[:10]), stride=1))


@pytest.mark.parametrize("steps,stride", [(9, 2), (13, 3)])
def test_stride_matches_final_output(steps, stride):
  jax_ms, ms = _script_pair("NoDeflicker")
  _, per = _script_pair("NoDeflicker")
  out = None
  for e in SCRIPT[:steps]:
    out = per.streaming_predict(np.array(e))
  ours = ms.streaming_predict_batch(np.array(SCRIPT[:steps]), stride=stride)
  theirs = jax_ms.streaming_predict_batch(np.array(SCRIPT[:steps]),
                                          stride=stride)
  np.testing.assert_array_equal(_order(ours), _order(out))
  np.testing.assert_array_equal(_order(ours), _order(theirs))


def test_hungarian_stride_rejected():
  _, ms = _script_pair("Hungarian")
  with pytest.raises(ValueError, match="consecutive"):
    ms.streaming_predict_batch(np.array(SCRIPT[:4]), stride=2)


def test_max_spectral_size_rejected():
  with pytest.raises(ValueError, match="max_spectral_size"):
    streaming.MultiStageClusterer(
        main_clusterer=convert.clusterer_from(
            j_clusterer.SpectralClusterer(max_spectral_size=50),
            device="cpu"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_state_crosses_packages(tmp_path, writer):
  # A state file written by one package continues the stream in the other
  # with the labels the writer would have given.
  jax_ms, ms = _script_pair("Hungarian")
  for e in SCRIPT[:8]:
    ms.streaming_predict(np.array(e))
    jax_ms.streaming_predict(np.array(e))
  path = str(tmp_path / "state.npz")
  (jax_ms if writer == "jax" else ms).state.save(path)
  loaded_jax, loaded = _script_pair("Hungarian")
  loaded.state = streaming.MultiStageState.load(path)
  loaded_jax.state = j_streaming.MultiStageState.load(path)
  with np.load(path) as z:
    assert sorted(z.files) == ["cache", "compression_labels",
                               "num_embeddings", "previous_output"]
  for e in SCRIPT[8:12]:
    want = (jax_ms if writer == "jax" else ms).streaming_predict(np.array(e))
    np.testing.assert_array_equal(loaded.streaming_predict(np.array(e)), want)
    np.testing.assert_array_equal(
        loaded_jax.streaming_predict(np.array(e)), want)


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("shape", [(1, 1), (3, 3), (4, 6), (6, 4), (7, 7)])
def test_linear_sum_assignment_matches_jax(shape, maximize):
  # Small integer costs: many ties, which both solvers must break alike.
  rng = np.random.RandomState(sum(shape) + maximize)
  for _ in range(20):
    cost = rng.randint(0, 3, size=shape)
    rows, cols = hungarian.linear_sum_assignment(cost, maximize=maximize)
    j_rows, j_cols = j_hungarian.linear_sum_assignment(cost,
                                                       maximize=maximize)
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(cols, j_cols)


def _bench_stream_lines():
  """The stream-making statements of benchmarks/bench_streaming.py's
  main(), read from the file (importing the bench would configure JAX)."""
  path = os.path.join(REPO, "benchmarks", "bench_streaming.py")
  with open(path) as f:
    tree = ast.parse(f.read())
  main = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "main")
  return ast.Module(body=main.body[:4], type_ignores=[])


@pytest.mark.parametrize("n_steps", [1, 1500])
def test_make_stream_is_the_bench_stream(n_steps):
  scope = {"np": np, "n_steps": n_steps}
  exec(compile(_bench_stream_lines(), "bench_streaming", "exec"), scope)
  stream, speakers = make_stream(n_steps)
  np.testing.assert_array_equal(stream, scope["stream"])
  np.testing.assert_array_equal(speakers, scope["speakers"])
