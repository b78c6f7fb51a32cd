"""Record the JAX package's spectral divide-and-conquer for the port's tests.

Runs the JAX package on the CPU and writes ``tests/data/reference_dc.npz``:

  * for every case of ``spectralcluster_tpu_torch.fixtures.DC_SPECTRA``
    (the spectra of ``tests/test_eigen_dc.py``): JAX's
    ``ops.dc.eigh_topk_dc(..., t=8, PRNGKey(0), try_iterative_first=False)``
    on the float32 matrix (sentinel-padded where the case has n_valid),
    with the case's patched constants and degraded range capture, as the
    JAX tests patch and stub them: ``{case}_w``, ``{case}_res``,
    ``{case}_scale``; the solver's own SCT_DC_DEBUG=1 lines
    (``{case}_trace``) and the branch of each split level parsed from them
    (``{case}_branches``, "depth:branch"; ``{case}_redraws``);
  * the staged pipeline with the split forced (``_TRY_ITERATIVE_FIRST`` off)
    on the three cases of ``tests/test_eigen_dc.py:341-419`` at
    dc_max_block=48: ``staged_{case}_labels``, ``_n_clusters``,
    ``_eigenvalues``, ``_branches``.

Nothing in the JAX package changes: the trace is its stderr. Prints the
seconds each case took.

Usage: ./run_cpu.sh python tools/record_dc_reference.py
"""

import contextlib
import io
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectralcluster_tpu import configs, pipeline  # noqa: E402
from spectralcluster_tpu import types as j_types  # noqa: E402
from spectralcluster_tpu.ops import dc  # noqa: E402
from spectralcluster_tpu.ops import eigen as eigen_ops  # noqa: E402
from spectralcluster_tpu_torch.fixtures import (DC_SPECTRA,  # noqa: E402
                                                make_dc_spectrum)

OUT = os.path.join(REPO, "tests", "data", "reference_dc.npz")
T = 8

_LEVEL = re.compile(r"depth=(\d+) n=\d+ nv=\d+ t=(\d+) k_f=\S+ b_f=\S+ "
                    r"sigma=(\S+) alpha=(\S+) norm2=(\S+)$")
_EVENT = re.compile(r"depth=(\d+) (.*)$")


def parse_branches(lines):
  """The branch of every split level, in the order the levels began, from
  the solver's debug lines (JAX dc.py:775-937): "kept_covers_t",
  "complement_block", "deflated_remainder", "zero_block" or
  "subspace_fallback". Returns (["depth:branch", ...], [redraws, ...])."""
  levels, current = [], {}
  for line in lines:
    found = _LEVEL.search(line)
    if found:
      level = {"depth": int(found[1]), "t": int(found[2]),
               "bound": abs(float(found[3])) + float(found[4]),
               "scale": abs(float(found[3])) + float(found[5]),
               "branch": None, "redraws": 0}
      levels.append(level)
      current[level["depth"]] = level
      continue
    found = _EVENT.search(line)
    if not found:
      continue
    level, event = current[int(found[1])], found[2]
    number = lambda key: int(re.search(key + r"=(\d+)", event)[1])  # noqa
    if event.startswith("capture degraded"):
      level["redraws"] += 1
    elif event.startswith("kept-covers-t"):
      level["branch"] = ("kept_covers_t" if number("k_eff") >= level["t"]
                         else "subspace_fallback")
    elif event.startswith("complement-split"):
      # The kept side covered t (t_rem = 0) unless a remainder line follows.
      level["branch"] = ("kept_covers_t" if number("k_eff") > 0
                         else "subspace_fallback")
    elif event.startswith("deflated-remainder"):
      level["branch"] = "deflated_remainder"
    elif event.startswith("complement-block"):
      level["branch"] = ("complement_block" if number("kc_eff") > 0
                         else "subspace_fallback")
    elif "degraded" in event:  # kept side / split degraded
      level["branch"] = "subspace_fallback"
  top_scale = levels[0]["scale"] if levels else 1.0
  for level in levels:
    if level["branch"] is None:
      # No line after the level's own: a zero block or the fallback.
      level["branch"] = ("zero_block" if level["bound"] <= 1e-6 * top_scale
                         else "subspace_fallback")
  return ([f"{lv['depth']}:{lv['branch']}" for lv in levels],
          [lv["redraws"] for lv in levels])


@contextlib.contextmanager
def traced():
  """Collect the solver's SCT_DC_DEBUG=1 lines."""
  os.environ["SCT_DC_DEBUG"] = "1"
  buf = io.StringIO()
  try:
    with contextlib.redirect_stderr(buf):
      yield buf
  finally:
    del os.environ["SCT_DC_DEBUG"]


@contextlib.contextmanager
def patched(options):
  """The case's constants patched and its range capture degraded, as
  tests/test_eigen_dc.py does."""
  saved = {k: getattr(dc, k) for k in options.get("patch", {})}
  orig = dc._project_block_jit
  stub = options.get("stub")
  calls = {"n": 0}

  def degraded(n, k_pad, descend):
    real = orig(n, k_pad, descend)

    def run(mm, p, k, key):
      calls["n"] += 1
      q, mq, a1, k_eff = real(mm, p, k, key)
      if stub == "all" or calls["n"] == 1:
        return jnp.zeros_like(q), jnp.zeros_like(mq), a1, jnp.int32(0)
      return q, mq, a1, k_eff

    return run

  for k, v in options.get("patch", {}).items():
    setattr(dc, k, v)
  if stub:
    dc._project_block_jit = degraded
  # The orth branch is baked into the cached programs at trace time.
  qr_patched = "_QR_PANEL_MAX" in saved
  if qr_patched:
    orig.cache_clear()
  try:
    yield
  finally:
    for k, v in saved.items():
      setattr(dc, k, v)
    dc._project_block_jit = orig
    if qr_patched:
      orig.cache_clear()


def record_case(name):
  a, options = make_dc_spectrum(name)
  descend = options.get("descend", True)
  n_valid = options.get("n_valid")
  m = jnp.asarray(a.astype(np.float32))
  if n_valid is not None:
    m = eigen_ops.apply_padding_sentinels(m, n_valid, descend)
  with patched(options), traced() as buf:
    w, _, res, scale = dc.eigh_topk_dc(
        m, T, jax.random.PRNGKey(0), descend=descend, n_valid=n_valid,
        max_block=options.get("max_block", 128), try_iterative_first=False)
  lines = [ln[len("# dc: "):] for ln in buf.getvalue().splitlines()
           if ln.startswith("# dc: ")]
  branches, redraws = parse_branches(lines)
  return {f"{name}_w": np.asarray(w), f"{name}_res": np.float64(res),
          f"{name}_scale": np.float64(scale),
          f"{name}_trace": np.array(lines),
          f"{name}_branches": np.array(branches),
          f"{name}_redraws": np.array(redraws, np.int32)}


def staged_embeddings(n=96, d=16, k=3, seed=0):
  """tests/test_eigen_dc.py's TestStagedPipelineDC._embeddings."""
  rng = np.random.RandomState(seed)
  centers = rng.randn(k, d) * 3
  labels = np.repeat(np.arange(k), n // k)
  return (centers[labels] + rng.randn(n, d) * 0.3).astype(np.float32)


def staged_cases():
  """(name, config, embeddings, n_valid) of test_eigen_dc.py:341-419."""
  icassp = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7, dc_max_block=48)
  laplacian = pipeline.PipelineConfig(
      refinement_options=j_types.RefinementOptions(
          thresholding_type=j_types.ThresholdType.Percentile,
          p_percentile=0.9,
          refinement_sequence=(j_types.RefinementName.RowWiseThreshold,
                               j_types.RefinementName.Symmetrize)),
      laplacian_type=j_types.LaplacianType.GraphCut,
      eigengap_type=j_types.EigenGapType.NormalizedDiff,
      min_clusters=1, max_clusters=5, row_wise_renorm=True, dc_max_block=48)
  padded = np.concatenate([staged_embeddings(n=90),
                           np.zeros((38, 16), np.float32)])
  return [("icassp2018", icassp, staged_embeddings(), None),
          ("padded", icassp, padded, 90),
          ("laplacian_ascend", laplacian, staged_embeddings(seed=1), None)]


def record_staged(name, cfg, x, n_valid):
  saved = dc._TRY_ITERATIVE_FIRST
  dc._TRY_ITERATIVE_FIRST = False
  try:
    with traced() as buf:
      labels, n_c, w, _ = jax.device_get(
          pipeline.spectral_cluster_fixed_k_staged(
              jnp.asarray(x), jax.random.PRNGKey(0), cfg,
              n_valid=None if n_valid is None else jnp.int32(n_valid)))
  finally:
    dc._TRY_ITERATIVE_FIRST = saved
  lines = [ln[len("# dc: "):] for ln in buf.getvalue().splitlines()
           if ln.startswith("# dc: ")]
  key = f"staged_{name}"
  return {f"{key}_labels": np.asarray(labels),
          f"{key}_n_clusters": np.int32(n_c),
          f"{key}_eigenvalues": np.asarray(w),
          f"{key}_branches": np.array(parse_branches(lines)[0])}


def main():
  out = {}
  for name in DC_SPECTRA:
    t0 = time.perf_counter()
    out.update(record_case(name))
    print(f"{name}: {time.perf_counter() - t0:.1f} s, branches "
          f"{list(out[f'{name}_branches'])}, res {out[f'{name}_res']:.2e}",
          flush=True)
  for name, cfg, x, n_valid in staged_cases():
    t0 = time.perf_counter()
    out.update(record_staged(name, cfg, x, n_valid))
    print(f"staged {name}: {time.perf_counter() - t0:.1f} s, n_clusters "
          f"{out[f'staged_{name}_n_clusters']}, branches "
          f"{list(out[f'staged_{name}_branches'])}", flush=True)
  np.savez_compressed(OUT, **out)
  print(f"wrote {OUT}")


if __name__ == "__main__":
  main()
