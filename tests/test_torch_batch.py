"""The port's batch drivers (``parallel/mesh.py``, ``parallel/batch.py``)
against the JAX package's, on the same numpy inputs (CPU).

The scenarios and sizes are ``tests/test_parallel.py``'s (N <= 32, d=8,
``gaussian_blur_sigma=0``), plus one mixed-length batch whose short
utterance pads into a larger bucket. The port runs on a mesh of CPU
devices; the JAX side runs on its CPU devices, eight when the tests run
with them (``tests/conftest.py``), else one: a vmapped batch gives each
utterance the same labels on any mesh. Labels must be equal id for id:
the port's K-Means draws are the JAX package's (``prng.py``).
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from spectralcluster_tpu import configs as j_configs
from spectralcluster_tpu import pipeline as j_pipeline
from spectralcluster_tpu.autotune import AutoTune as JAutoTune
from spectralcluster_tpu.parallel import batch as j_batch
from spectralcluster_tpu.parallel import mesh as j_mesh
from spectralcluster_tpu_torch import configs, constraint, convert, pipeline
from spectralcluster_tpu_torch import utils
from spectralcluster_tpu_torch.autotune import AutoTune
from spectralcluster_tpu_torch.fixtures import make_batch
from spectralcluster_tpu_torch.parallel import batch
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = [torch.device("cpu")] * 8


def _mesh(dp, mp):
  return mesh_lib.make_mesh(dp=dp, mp=mp, devices=CPUS)


def _jax_mesh(dp, mp):
  devices = jax.devices()
  if len(devices) >= dp * mp:
    return j_mesh.make_mesh(dp=dp, mp=mp, devices=devices[:dp * mp])
  return j_mesh.make_mesh(dp=1, mp=1, devices=devices[:1])


def _jcfg(max_clusters=4):
  # gaussian_blur_sigma=0, as in tests/test_parallel.py.
  return j_pipeline.PipelineConfig(
      refinement_options=j_configs.icassp2018_refinement_options().replace(
          gaussian_blur_sigma=0),
      min_clusters=2, max_clusters=max_clusters,
      custom_dist="cosine", max_iter=30)


def _cfg(max_clusters=4):
  return convert.pipeline_config_from(_jcfg(max_clusters))


def _utterance(rng, n, d=8, k=2, noise=0.05):
  centers = np.eye(k, d) * 4.0
  labels = np.repeat(np.arange(k), -(-n // k))[:n]
  return centers[labels] + rng.randn(n, d) * noise, labels


def _assert_same_ids(ours, theirs):
  assert len(ours) == len(theirs)
  for a, b in zip(ours, theirs):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, np.asarray(b))


def test_make_mesh_shapes():
  mesh = _mesh(4, 2)
  assert mesh.shape == {"batch": 4, "model": 2}
  assert mesh.devices.shape == (4, 2)
  assert _mesh(None, None).shape == {"batch": 8, "model": 1}
  assert mesh_lib.make_mesh(mp=4, devices=CPUS).shape == {"batch": 2,
                                                          "model": 4}
  with pytest.raises(ValueError):
    _mesh(3, 2)
  with pytest.raises(ValueError):
    j_mesh.make_mesh(dp=3, mp=2)
  if len(jax.devices()) >= 8:
    assert dict(j_mesh.make_mesh(dp=4, mp=2).shape) == mesh.shape


def test_make_mesh_defaults_to_the_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present: the no-card refusal cannot be shown")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    mesh_lib.make_mesh()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    batch.cluster_batch([np.zeros((8, 4), np.float32)], _cfg())


def test_cluster_batch_matches_single():
  rng = np.random.RandomState(0)
  cfg = _cfg()
  utts, trues = zip(*[_utterance(rng, 24) for _ in range(16)])
  ours = batch.cluster_batch(list(utts), cfg, mesh=_mesh(8, 1))
  theirs = j_batch.cluster_batch(list(utts), _jcfg(), mesh=_jax_mesh(8, 1))
  _assert_same_ids(ours, theirs)
  for got, true in zip(ours, trues):
    np.testing.assert_array_equal(utils.enforce_ordered_labels(got),
                                  utils.enforce_ordered_labels(true))
  # The first utterance alone, padded to the same bucket with the same
  # seed, through the pipeline: the batch changes nothing.
  padded = np.zeros((pipeline.pad_bucket(24), 8), np.float32)
  padded[:24] = utts[0]
  single = pipeline.spectral_cluster_fixed_k(
      torch.from_numpy(padded), torch.Generator().manual_seed(0), cfg,
      n_valid=24)[0].numpy()[:24]
  np.testing.assert_array_equal(single, ours[0])


# test_parallel.py's ragged batch, and a mixed one whose 12-row utterance
# pads into the 128-row bucket of its 100-row neighbour.
@pytest.mark.parametrize("lengths,k,noise,seed", [
    ((16, 24, 32, 24, 16), 2, 0.05, 1),
    ((12, 100, 40), 3, 0.3, 8),
])
def test_variable_lengths(lengths, k, noise, seed):
  rng = np.random.RandomState(seed)
  cfg = _cfg()
  utts = [_utterance(rng, n, k=k, noise=noise)[0] for n in lengths]
  ours = batch.cluster_batch(utts, cfg, mesh=_mesh(4, 2), seed=seed)
  theirs = j_batch.cluster_batch(utts, _jcfg(), mesh=_jax_mesh(4, 2),
                                 seed=seed)
  assert [r.shape[0] for r in ours] == list(lengths)
  _assert_same_ids(ours, theirs)
  if lengths[0] == 12:
    # Alone, the short utterance runs in its own 16-row bucket: its
    # k-means++ draws differ, and so do its label ids.
    alone = pipeline.spectral_cluster_fixed_k(
        torch.as_tensor(utts[0], dtype=torch.float32),
        torch.Generator().manual_seed(seed), cfg)[0].numpy()
    assert not np.array_equal(alone, ours[0])


def test_cluster_batch_streamed_matches_serial():
  # Batch sizes that do and do not divide the chunk, with a ragged tail:
  # the windowed driver returns the serial chunked loop's labels, and the
  # JAX package's streamed driver's.
  rng = np.random.RandomState(2)
  mesh = _mesh(4, 2)
  cfg = _cfg()
  utts = [_utterance(rng, n)[0] for n in (24, 16, 32, 24, 16, 24, 32,
                                          24, 16, 24)]
  serial = []
  for i in range(0, len(utts), 4):
    serial.extend(batch.cluster_batch(utts[i:i + 4], cfg, mesh=mesh, seed=i))
  streamed = batch.cluster_batch_streamed(utts, cfg, mesh=mesh, chunk=4,
                                          window=2)
  theirs = j_batch.cluster_batch_streamed(utts, _jcfg(),
                                          mesh=_jax_mesh(4, 2), chunk=4,
                                          window=2)
  _assert_same_ids(streamed, theirs)
  for a, b in zip(serial, streamed):
    np.testing.assert_array_equal(utils.enforce_ordered_labels(a),
                                  utils.enforce_ordered_labels(b))


def test_streamed_half_width_transfer():
  # bf16 transfer, float32 compute: separated speakers keep their labels.
  rng = np.random.RandomState(3)
  utts = [_utterance(rng, 24)[0] for _ in range(6)]
  f32 = batch.cluster_batch_streamed(utts, _cfg(), mesh=_mesh(2, 4), chunk=4)
  bf16 = batch.cluster_batch_streamed(utts, _cfg(), mesh=_mesh(2, 4),
                                      chunk=4, transfer_dtype=torch.bfloat16)
  for a, b in zip(f32, bf16):
    np.testing.assert_array_equal(utils.enforce_ordered_labels(a),
                                  utils.enforce_ordered_labels(b))


def test_autotuned_level2_constrained_matches_jax():
  from spectralcluster_tpu import types as j_types
  copts = j_types.ConstraintOptions(
      constraint_name=j_types.ConstraintName.ConstraintPropagation,
      apply_before_refinement=True, constraint_propagation_alpha=0.4)
  jcfg = j_pipeline.PipelineConfig(
      refinement_options=j_configs.turntodiarize_refinement_options(),
      constraint_options=copts, laplacian_type=j_types.LaplacianType.GraphCut,
      eigengap_type=j_types.EigenGapType.NormalizedDiff,
      min_clusters=1, max_clusters=5, row_wise_renorm=True,
      custom_dist="cosine", max_iter=300)
  jautotune = JAutoTune(
      p_percentile_min=0.60, p_percentile_max=0.95, init_search_step=0.05,
      search_level=2, proxy=j_types.AutoTuneProxy.PercentileSqrtOverNME)
  cfg = convert.pipeline_config_from(jcfg)
  autotune = convert.convert_value(jautotune)
  rng = np.random.RandomState(5)
  utts, cms = [], []
  for i in range(4):
    x, _ = _utterance(rng, 24 + 8 * (i % 2), d=8, k=2, noise=0.05)
    utts.append(x.astype(np.float32))
    n = x.shape[0]
    cm = np.zeros((n, n), np.float32)
    for j in range(n - 1):
      cm[j, j + 1] = cm[j + 1, j] = 1.0 if (j % 3) else -1.0
    cms.append(cm)
  ours = batch.cluster_batch_autotuned(utts, cfg, autotune, mesh=_mesh(4, 2),
                                       constraint_matrices=cms)
  theirs = j_batch.cluster_batch_autotuned(
      utts, jcfg, jautotune, mesh=_jax_mesh(4, 2), constraint_matrices=cms)
  _assert_same_ids(ours, theirs)
  # The template is not consumed: a second call gives the same labels.
  again = batch.cluster_batch_autotuned(utts, cfg, autotune,
                                        mesh=_mesh(4, 2),
                                        constraint_matrices=cms)
  _assert_same_ids(again, ours)


def test_autotuned_refusals():
  x = [np.zeros((8, 4), np.float32)]
  for cfg in (_cfg().replace(autotune=pipeline.AutoTuneStatic()),
              _cfg().replace(max_clusters=None)):
    with pytest.raises(ValueError):
      batch.cluster_batch_autotuned(x, cfg, AutoTune(), mesh=_mesh(8, 1))
  for cfg in (_jcfg().replace(autotune=j_pipeline.AutoTuneStatic()),
              _jcfg().replace(max_clusters=None)):
    with pytest.raises(ValueError):
      j_batch.cluster_batch_autotuned(x, cfg, JAutoTune(),
                                      mesh=_jax_mesh(1, 1))
  with pytest.raises(ValueError, match="one constraint matrix"):
    batch.cluster_batch_autotuned(x * 2, _cfg(), AutoTune(), mesh=_mesh(8, 1),
                                  constraint_matrices=[np.zeros((8, 8))])


def test_constrained_batch_matches_jax_and_host_predict():
  x = np.array([[1.0, 0.0], [1.1, 0.1], [0.0, 1.0], [0.1, 1.0],
                [0.9, -0.1], [0.0, 1.2]], dtype=np.float32)
  cm = constraint.ConstraintMatrix(
      [0, 0, 1.5, 0, 1.5, 1.5], threshold=1).compute_diagonals()
  from spectralcluster_tpu import types as j_types
  jcfg = j_pipeline.PipelineConfig(
      refinement_options=j_configs.turntodiarize_refinement_options(),
      constraint_options=j_configs.turntodiarize_constraint_options(),
      laplacian_type=j_types.LaplacianType.GraphCut,
      min_clusters=2, max_clusters=7, row_wise_renorm=True,
      autotune=j_pipeline.AutoTuneStatic(0.40, 0.95, 0.05))
  cfg = convert.pipeline_config_from(jcfg)
  ours = batch.cluster_batch([x] * 4, cfg, mesh=_mesh(4, 2),
                             constraint_matrices=[cm] * 4)
  theirs = j_batch.cluster_batch([x] * 4, jcfg, mesh=_jax_mesh(4, 2),
                                 constraint_matrices=[cm] * 4)
  _assert_same_ids(ours, theirs)
  expected = utils.enforce_ordered_labels(
      configs.make_turntodiarize_clusterer(device="cpu").predict(x, cm))
  for r in ours:
    np.testing.assert_array_equal(expected, utils.enforce_ordered_labels(r))
  with pytest.raises(ValueError, match="one constraint matrix"):
    batch.cluster_batch([x] * 4, cfg, mesh=_mesh(4, 2),
                        constraint_matrices=[cm] * 3)


def _bench_batch_lines():
  """The utterance-making statements of benchmarks/bench_batch.py's main(),
  read from the file (importing the bench would configure JAX)."""
  with open(os.path.join(REPO, "benchmarks", "bench_batch.py")) as f:
    tree = ast.parse(f.read())
  main = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "main")
  start = next(i for i, node in enumerate(main.body)
               if "RandomState" in ast.unparse(node))
  return ast.Module(body=main.body[start:start + 3], type_ignores=[])


@pytest.mark.parametrize("size", [(3, 40, 8), (16, 1024, 256)])
def test_make_batch_is_the_bench_batch(size):
  b, n, d = size
  scope = {"np": np, "batch": b, "n": n, "d": d}
  exec(compile(_bench_batch_lines(), "bench_batch", "exec"), scope)
  utts, truths = make_batch(b, n, d)
  for ours, theirs in zip(utts + truths, scope["utts"] + scope["truths"]):
    np.testing.assert_array_equal(ours, theirs)
  assert len(utts) == len(scope["utts"]) == b


def test_reference_batch_file():
  # tools/record_batch_reference.py's record: the JAX package's labels of
  # the bench batch recover every ground truth, and its Turn-to-Diarize
  # batch gives the recorded Turn-to-Diarize labels at N=1024.
  with np.load(os.path.join(REPO, "tests", "data",
                            "reference_batch.npz")) as ref:
    assert ref["batch_labels"].shape == (16, 1024)
    assert ref["t2d_labels"].shape == (4, 1024)
    _, truths = make_batch(16)
    for labels, truth in zip(ref["batch_labels"], truths):
      np.testing.assert_array_equal(utils.enforce_ordered_labels(labels),
                                    truth)
    np.testing.assert_array_equal(ref["batch_truth"], np.stack(truths))
    with np.load(os.path.join(REPO, "benchmarks",
                              "reference_labels_t2d.npz")) as t2d:
      for labels in ref["t2d_labels"]:
        np.testing.assert_array_equal(utils.enforce_ordered_labels(labels),
                                      t2d["labels_1024"])
