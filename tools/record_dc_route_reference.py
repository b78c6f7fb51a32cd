"""Record the certified top-k route of both packages on the smoke's operands.

Runs on the CPU and writes ``tests/data/reference_dc_route.json``: for each
case of ``chip_smoke.py``'s route gate (``make_embeddings(10240)`` and
``(20480)``, ``make_embeddings_k(10240, 4)`` and ``(10240, 7)``) the
icassp2018 Auto operand is built as the smoke builds it, on the CPU
(``fused.affinity``, whose twin runs there, then
``pipeline._symmetric_eig_operand`` with the ROWNORM_TAIL structure), and
the float32 operand goes to both packages' ``_certified_iterative_topt``
(t=8, descending, no n_valid), each seeded as its own pipeline seeds the
exact top-k route: the port's generator with ``pipeline._DC_SEED``, the
JAX package's ``PRNGKey(17)``. Recorded per case:

  * ``port``: accepted, iterations, res_abs, the shift b, the residual
    after each 32-iteration chunk (``res_trace``), and res, scale and
    missed where the route reached its probe;
  * ``jax``: accepted and res (``None`` where the route declined before
    computing it; then res_abs and the shift from its debug line), and the
    solver's own SCT_DC_DEBUG=1 lines (``trace``).

Nothing in the JAX package changes: the trace is its stderr. Prints the
seconds each case took. Takes minutes and several GB of host memory at
N=20480, so it is no tier-1 test.

Usage: ./run_cpu.sh python tools/record_dc_route_reference.py
"""

import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from spectralcluster_tpu.ops import dc as jax_dc  # noqa: E402
from spectralcluster_tpu_torch import configs, pipeline  # noqa: E402
from spectralcluster_tpu_torch.fixtures import (make_embeddings,  # noqa: E402
                                                make_embeddings_k)
from spectralcluster_tpu_torch.kernels import fused  # noqa: E402
from spectralcluster_tpu_torch.ops import dc as dc_ops  # noqa: E402
from spectralcluster_tpu_torch.ops import refinement as ref_ops  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "reference_dc_route.json")
T = 8
JAX_DC_KEY = 17      # spectralcluster_tpu/pipeline.py:822, :980
CASES = {
    "n10240_k2": lambda: make_embeddings(10240),
    "n20480_k2": lambda: make_embeddings(20480),
    "n10240_k4": lambda: make_embeddings_k(10240, 4)[0],
    "n10240_k7": lambda: make_embeddings_k(10240, 7)[0],
}


def operand(x):
  """The smoke's Auto operand (chip_smoke.py's dc_breakdown), on the CPU."""
  cfg = pipeline.PipelineConfig(
      refinement_options=configs.icassp2018_refinement_options(),
      min_clusters=2, max_clusters=7)
  aff = fused.affinity(torch.as_tensor(x))
  m, _ = pipeline._symmetric_eig_operand(aff, cfg, None, None,
                                         ref_ops.ROWNORM_TAIL,
                                         consume_input=True)
  return m


def port_route(m):
  info = {}
  out = dc_ops._certified_iterative_topt(
      m, T, torch.Generator().manual_seed(pipeline._DC_SEED), True, None,
      info)
  keep = ("iters", "res_abs", "shift", "res_trace", "res", "scale", "missed",
          "est_next", "w_t")
  return {"accepted": out is not None,
          **{k: info[k] for k in keep if k in info}}


def jax_route(m):
  os.environ["SCT_DC_DEBUG"] = "1"
  buf = io.StringIO()
  try:
    with contextlib.redirect_stderr(buf):
      out = jax_dc._certified_iterative_topt(
          jnp.asarray(m), T, jax.random.PRNGKey(JAX_DC_KEY), True, None)
  finally:
    del os.environ["SCT_DC_DEBUG"]
  trace = [ln for ln in buf.getvalue().splitlines() if "iterative" in ln]
  row = {"accepted": out is not None, "res": None, "trace": trace}
  if out is not None:
    row["res"] = float(out[2])
  elif trace:
    # JAX dc.py:1185 (res_abs against the bound b), or :1193 (res).
    bound = re.search(r"residual ([0-9.e+-]+) vs bound ([0-9.e+-]+)",
                      trace[-1])
    over = re.search(r"residual ([0-9.e+-]+) >", trace[-1])
    if bound:
      row["res_abs"], row["shift"] = float(bound[1]), float(bound[2])
    elif over:
      row["res"] = float(over[1])
  return row


def main():
  torch.set_num_threads(os.cpu_count())
  record = {"t": T, "port_seed": pipeline._DC_SEED, "jax_key": JAX_DC_KEY,
            "constants": {
                "iter_accept_res": dc_ops._ITER_ACCEPT_RES,
                "subspace_iters": dc_ops._SUBSPACE_ITERS,
                "subspace_residual_tol": dc_ops._SUBSPACE_RESIDUAL_TOL,
                "subspace_max_iters": dc_ops._SUBSPACE_MAX_ITERS},
            "cases": {}}
  for name, make in CASES.items():
    t0 = time.perf_counter()
    m = operand(make())
    port = port_route(m)
    m_np = m.numpy()
    del m
    jax_side = jax_route(m_np)
    del m_np
    record["cases"][name] = {"port": port, "jax": jax_side}
    print(f"{name}: port {port['accepted']} after {port['iters']} "
          f"iterations (res_abs {port['res_abs']:.3e}), jax "
          f"{jax_side['accepted']} (res {jax_side['res']}), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
  with open(OUT, "w") as f:
    json.dump(record, f, indent=1)
    f.write("\n")
  print("wrote", OUT)


if __name__ == "__main__":
  main()
