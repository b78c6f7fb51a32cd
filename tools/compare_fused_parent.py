#!/usr/bin/env python3
"""Hold the port's CUDA kernels against an earlier version of fused.cu.

Run from the root of a checkout on a machine with a CUDA card, giving the
earlier source file (for example from `git show <commit>:<path>`):

    python3 tools/compare_fused_parent.py --parent OLD_fused.cu [--out FILE]

The earlier version's `sct_affinity` may be the one before the symmetric
kernel,
`sct_affinity(xn, out, n, d, stream)` on the normalized embeddings
row-major, or `sct_affinity(xt, out, n, ld, d_pad, stream)` on the padded
transpose; its `sct_affinity_batched` may take that padded transpose per
utterance (`xt, out, b, n, ld, d_pad, stream`) or the normalized rows
(`xn, out, b, n, d, stream`). The tool reads which from its source. Its
other entry points take what the current ones take. Both libraries build
with the same nvcc flags (`kernels/build.py`).

The 2-D kernels run on the bench fixture (`make_embeddings(N)`, d=256) and
on the blurred, cropped affinity, as `chip_smoke.py` feeds the row max. The
batched ones run at (B, 1024, 256) for B in BATCHES on `make_batch(B)`, as
`chip_smoke.py` feeds them. One JSON line per kernel and shape:

  * the max abs difference between the two versions' outputs, and whether
    they are equal bit for bit (the affinity too: both sum each element's d
    products in k order);
  * each version's time in turns, parent, current, current, parent
    (`chip_smoke.time_ms`: CUDA events around 10 back-to-back C calls of
    the kernel alone, the median of 20 such means per turn), on the same
    inputs. The batched affinity also in turns with its wrapper's torch
    prologue (row normalization, and the padded transpose where that
    version takes one), and each prologue op alone; the batched row max
    also with the L2 flushed (`chip_smoke.time_flushed_ms`: a 128 MB write
    before each single timed call, median of 20), beside one `torch.amax`
    over the last axis timed both ways in the same turns;
  * ptxas's registers and spill bytes of each version's kernel;
  * for the batched affinity, the launch's blocks and waves in each version.

Then the subspace solver's kernels, on random operands at its shapes:
the panel product (6) by PANEL_WIDTHS columns on each of PANEL_CASES,
both versions alone in turns with cuBLAS's float32 product, with the
count of outputs whose bits differ, each version's share of the float64
gate's bound and the current k split; and the CholeskyQR pass (7) on the
panels of QR_CASES, the parent's two single-pass launches (1e-6, then the
1e-2 rescue; from a parent without the pair) against the current pair's
one, in turns, their q and info compared bit for bit. Whether the
earlier `sct_panel_matmul` takes a float64 scratch for its k split is
read from its source too.

Then the card's SM clock, power draw and throttle reasons (nvidia-smi,
every 200 ms) while the current batched affinity runs back to back for
LOAD_SECONDS at the last batch size; whether each kernel both versions
have, other than the two batched kernels with a design of their own,
compiled to the same SASS up to the offsets of its parameters
(`cuobjdump -sass`); then the card's name and power limit, as nvidia-smi
gives them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 10240
D = 256
N_BATCH = 1024
BATCHES = (16, 64)
FLUSH_BYTES = 128 << 20
LOAD_SECONDS = 3.0
TURNS = ("parent", "current", "current", "parent")

# Kernel 6's operands: (batch, N, rows of the N x N operand or None), each
# by PANEL_WIDTHS columns; kernel 7's panels: (batch, N), b=16.
PANEL_CASES = (((), 10240, None), ((), 20480, None), ((), 20480, (5120, 10240)),
               ((16,), 1024, None))
PANEL_WIDTHS = (16, 8, 1)
QR_CASES = (((), 10240), ((), 20480), ((16,), 1024))

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The earlier version's C interface: the affinity's before the symmetric
# kernel, the batched affinity's on the padded transpose, the panel
# product's with the float64 scratch of its k split (and the query of its
# size).
_PARENT_SIGNATURES = {
    "sct_panel_matmul": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _L, _L, _L,
                         _P),
    "sct_panel_matmul_splits": (_I, _I, _I),
    "sct_affinity": (_P, _P, _I, _I, _P),
    "sct_affinity_batched": (_P, _P, _I, _I, _I, _I, _P),
    "sct_row_max": (_P, _P, _I, _I, _I, _I, _P),
    "sct_row_max_batched": (_P, _P, _I, _I, _P, _I, _I, _P),
    "sct_crop_diagonal": (_P, _P, _I, _I, _I, _P),
    "sct_crop_diagonal_batched": (_P, _P, _I, _I, _P, _I, _P),
}
_SYMMETRIC_AFFINITY = "int sct_affinity(const float* xt"
_ROW_MAJOR_BATCHED = "int sct_affinity_batched(const float* xn"
# Kernels with a design of their own in the current version: no SASS check.
_REDESIGNED = ("affinity_batched_kernel", "row_max_batched_kernel",
               "panel_matmul_kernel", "panel_finish_kernel",
               "cholqr_pass_kernel")


def _current_key(parent_key: str) -> str:
  """The current kernel that an earlier one became: the 2-D affinity and
  row max lost their batch template argument (false in their 2-D form)."""
  if parent_key == "affinity_kernel<false>":
    return "affinity_kernel"
  m = re.fullmatch(r"row_max_kernel<(true|false),false>", parent_key)
  return f"row_max_kernel<{m.group(1)}>" if m else parent_key


def _sass(build, cuobjdump: str, lib: str):
  """{kernel key: its SASS instructions, constant-bank offsets masked}."""
  out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                       text=True, check=True).stdout
  funcs = {}
  for block in re.split(r"\n\s*Function : ", out)[1:]:
    name, body = block.split("\n", 1)
    ops = []
    for line in body.split("\n"):
      m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
      if m:
        ops.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[.]", m.group(1)))
    funcs[build.kernel_key(name.strip())] = ops
  return funcs


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--parent", required=True,
                      help="the earlier version of csrc/fused.cu")
  parser.add_argument("--out", help="also write the results to this JSON")
  args = parser.parse_args()

  import torch
  if not torch.cuda.is_available():
    print("compare_fused_parent: no CUDA device", file=sys.stderr)
    return 2
  torch.backends.cuda.matmul.allow_tf32 = False
  sys.path.insert(0, ROOT)
  import numpy as np
  from chip_smoke import card_peaks, time_flushed_ms, time_ms
  from spectralcluster_tpu_torch.fixtures import make_batch, make_embeddings
  from spectralcluster_tpu_torch.kernels import build, fused
  from spectralcluster_tpu_torch.ops import eigen as eigen_ops
  from spectralcluster_tpu_torch.ops import refinement as ref_ops

  parent_src = os.path.abspath(args.parent)
  with open(parent_src) as f:
    parent_text = f.read()
  parent_symmetric = _SYMMETRIC_AFFINITY in parent_text
  parent_row_major = _ROW_MAJOR_BATCHED in parent_text
  parent_split_panel = "sct_panel_matmul_splits" in parent_text
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    cur_path, par_path = pool.map(build.build, (build.SOURCES, (parent_src,)))
  libs = {"parent": ctypes.CDLL(par_path), "current": ctypes.CDLL(cur_path)}
  for version, lib in libs.items():
    for name in {**build._SIGNATURES, **_PARENT_SIGNATURES}:
      argtypes = build._SIGNATURES.get(name)
      if version == "parent" and name in _PARENT_SIGNATURES:
        argtypes = _PARENT_SIGNATURES[name]
        if ((name == "sct_affinity" and parent_symmetric)
            or (name == "sct_affinity_batched" and parent_row_major)
            or (name == "sct_panel_matmul" and not parent_split_panel)):
          argtypes = build._SIGNATURES[name]
      elif argtypes is None:
        continue
      fn = getattr(lib, name, None)
      if fn is not None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
  ptxas = {"parent": build.ptxas_report(par_path),
           "current": build.ptxas_report(cur_path)}

  def call(lib, fn, *fn_args):
    rc = getattr(lib, fn)(*fn_args)
    if rc != 0:
      raise RuntimeError(f"{fn}: CUDA error {rc}")

  def resident(lib, kernel):
    blocks = ctypes.c_int(0)
    call(lib, "sct_resident_blocks", kernel, ctypes.byref(blocks))
    return blocks.value

  def fused_schedule(b, t, slots, blocks=None, split=0):
    """Blocks and waves of a batched affinity launch over `slots` resident
    blocks, in 128x128 tiles' work: the tile grid's b·T(T+1)/2 tiles
    (blocks None), or the piece grid's off-diagonal tiles, diagonal tiles
    at 3/4 and `split` of these as a half and a quad."""
    if blocks is None:
      return {"blocks": b * t * (t + 1) // 2, "resident_blocks": slots,
              "waves": b * t * (t + 1) / 2 / slots}
    return {"blocks": blocks, "split_diagonal_tiles": split,
            "resident_blocks": slots,
            "waves": (b * t * (t - 1) / 2 + 0.75 * b * t) / slots}

  dev = torch.device("cuda")
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  stream = torch.cuda.current_stream(dev).cuda_stream
  flush = torch.empty(FLUSH_BYTES // 4, device=dev)
  results = []

  # The kernels behind a compared name where they are named otherwise.
  kernels_of = {"panel_matmul": ("panel_matmul_kernel", "panel_finish_kernel"),
                "cholqr_pass_pair": ("cholqr_pass_kernel",)}

  def ptxas_of(kernel):
    prefixes = kernels_of.get(kernel, (f"{kernel}_kernel",))
    return {f"ptxas_{v}": {k: r for k, r in ptxas[v].items()
                           if k.startswith(prefixes)}
            for v in ("parent", "current")}

  def under_load(fn, shape):
    """nvidia-smi's samples while fn runs back to back: whether the card
    holds its clock under the kernel's load."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
         "clocks_throttle_reasons.active", "--format=csv,noheader",
         "-lms", "200"], stdout=subprocess.PIPE, text=True)
    try:
      start = time.monotonic()
      while time.monotonic() - start < LOAD_SECONDS:
        for _ in range(20):
          fn()
        torch.cuda.synchronize()
    finally:
      smi.terminate()
    samples = smi.communicate()[0].strip().splitlines()
    # The first and last samples straddle the load's start and end.
    row = {"kernel": "affinity_batched", "shape": shape,
           "under_load_nvidia_smi": samples[2:-2]}
    results.append(row)
    print(json.dumps(row), flush=True)

  def compare(kernel, shape, fns, outputs, extra_turns=(), extra=None):
    """Turns of the kernels alone, then of `extra_turns` (name, {version:
    fn}, flushed?), then the outputs compared."""
    row = {"kernel": kernel, "shape": shape}
    for label, by_version, flushed in (("", fns, False),) + tuple(extra_turns):
      times = {"parent": [], "current": []}
      for v in TURNS:
        times[v].append(time_flushed_ms(torch, by_version[v], flush)
                        if flushed else time_ms(torch, by_version[v]))
      for v in ("parent", "current"):
        row[f"{v}{label}_ms"] = times[v]
    torch.cuda.synchronize()
    got, want = outputs["current"], outputs["parent"]
    row.update({"max_abs_diff": float(torch.max(torch.abs(got - want))),
                "bit_equal": bool(torch.equal(got, want)),
                "elements_differing": int(torch.sum(got != want)),
                **ptxas_of(kernel), **(extra or {})})
    results.append(row)
    print(json.dumps(row), flush=True)

  with torch.no_grad():
    # The 2-D kernels at N=10240.
    x = torch.as_tensor(make_embeddings(N, D)).to(dev)
    xn = fused.normalize_rows(x).contiguous()
    xt = fused.affinity_operand(xn)
    aff = {v: torch.empty((N, N), device=dev) for v in libs}

    def affinity_2d(v):
      if v == "current" or parent_symmetric:
        return lambda: call(libs[v], "sct_affinity", xt.data_ptr(),
                            aff[v].data_ptr(), N, xt.shape[1], xt.shape[0],
                            stream)
      return lambda: call(libs[v], "sct_affinity", xn.data_ptr(),
                          aff[v].data_ptr(), N, D, stream)

    compare("affinity", f"N={N},d={D}", {v: affinity_2d(v) for v in libs},
            aff)
    blurred = ref_ops.gaussian_blur(
        fused.crop_diagonal_plain(aff["current"]), 1.0).contiguous()
    rmax = {v: torch.empty((N, 1), device=dev) for v in libs}
    compare("row_max", f"N={N}", {
        v: (lambda v=v: call(libs[v], "sct_row_max", blurred.data_ptr(),
                             rmax[v].data_ptr(), N, N, 0, 1, stream))
        for v in libs}, rmax)
    crop = {v: aff["current"].clone() for v in libs}
    compare("crop_diagonal", f"N={N}", {
        v: (lambda v=v: call(libs[v], "sct_crop_diagonal", crop[v].data_ptr(),
                             crop[v].data_ptr(), N, N, 1, stream))
        for v in libs}, crop)
    del x, xn, xt, aff, blurred, rmax, crop

    # The batched kernels at (B, N_BATCH, D).
    t = -(-N_BATCH // fused.AFFINITY_TILE)
    for b in BATCHES:
      shape = f"B={b},N={N_BATCH},d={D}"
      xb = torch.as_tensor(np.stack(make_batch(b, N_BATCH, D)[0])).to(dev)
      xnb = fused.normalize_rows(xb).contiguous()
      xtb = fused.affinity_operand(xnb)
      affb = {v: torch.empty((b, N_BATCH, N_BATCH), device=dev) for v in libs}

      def affinity_b(v, prologue=False):
        if v == "current" or parent_row_major:
          def run():
            src = fused.normalize_rows(xb).contiguous() if prologue else xnb
            call(libs[v], "sct_affinity_batched", src.data_ptr(),
                 affb[v].data_ptr(), b, N_BATCH, D, stream)
        else:
          def run():
            src = (fused.affinity_operand(fused.normalize_rows(xb))
                   if prologue else xtb)
            call(libs[v], "sct_affinity_batched", src.data_ptr(),
                 affb[v].data_ptr(), b, N_BATCH, src.shape[2], src.shape[1],
                 stream)
        return run

      schedule = {"parent_schedule": fused_schedule(
          b, t, sms * resident(libs["parent"], 0))}
      blocks, split, slots = (ctypes.c_longlong(0), ctypes.c_int(0),
                              ctypes.c_int(0))
      call(libs["current"], "sct_affinity_batched_schedule", b, N_BATCH,
           ctypes.byref(blocks), ctypes.byref(split), ctypes.byref(slots))
      schedule["current_schedule"] = fused_schedule(
          b, t, slots.value, blocks.value, split.value)
      prologue = {
          "normalize_rows_ms": time_ms(torch,
                                       lambda: fused.normalize_rows(xb)),
          "affinity_operand_ms": time_ms(
              torch, lambda: fused.affinity_operand(xnb))}
      compare("affinity_batched", shape, {v: affinity_b(v) for v in libs},
              affb, [("_wrapper", {v: affinity_b(v, True) for v in libs},
                      False)], {**schedule, **prologue})
      blurred_b = ref_ops.gaussian_blur(
          fused.crop_diagonal_plain(affb["current"]), 1.0).contiguous()
      nv = torch.full((b,), N_BATCH, dtype=torch.int32, device=dev)
      rmb = {v: torch.empty((b, N_BATCH, 1), device=dev) for v in libs}
      row_max_b = {
          v: (lambda v=v: call(libs[v], "sct_row_max_batched",
                               blurred_b.data_ptr(), rmb[v].data_ptr(), b,
                               N_BATCH, nv.data_ptr(), 0, 1, stream))
          for v in libs}
      amax = lambda: torch.amax(blurred_b, dim=-1, keepdim=True)  # noqa: E731
      compare("row_max_batched", shape, row_max_b, rmb, [
          ("_l2_flushed", row_max_b, True),
          ("_amax", {v: amax for v in libs}, False),
          ("_amax_l2_flushed", {v: amax for v in libs}, True)])
      cropb = {v: affb["current"].clone() for v in libs}
      compare("crop_diagonal_batched", shape, {
          v: (lambda v=v: call(libs[v], "sct_crop_diagonal_batched",
                               cropb[v].data_ptr(), cropb[v].data_ptr(), b,
                               N_BATCH, nv.data_ptr(), 1, stream))
          for v in libs}, cropb)
      if b == BATCHES[-1]:
        under_load(affinity_b("current"), shape)
      del xb, xnb, xtb, affb, blurred_b, rmb, cropb

    # Kernel 6: both versions alone (the parent's float64 scratch for its k
    # split made beforehand) in turns with cuBLAS's float32 product, on
    # random operands at the solver's shapes, each by a panel that is the
    # transpose of a contiguous (b, K) matrix, as the solver gives it; how
    # many outputs differ in their bits, and each version's largest share
    # of the float64 gate's bound (2^-24·|exact| + K·2^-52·(|a|·|x|)).
    bw = card_peaks(torch.cuda.get_device_name(dev))[0]
    gen = torch.Generator(dev).manual_seed(0)
    for lead, n_op, rows in PANEL_CASES:
      full = torch.randn((*lead, n_op, n_op), generator=gen, device=dev)
      a = full if rows is None else full[rows[0]:rows[1]]
      batch = lead[0] if lead else 1
      m, k = a.shape[-2:]
      for b in PANEL_WIDTHS:
        x = torch.randn((*lead, b, k), generator=gen,
                        device=dev).transpose(-1, -2)
        ys = {v: torch.empty((*lead, m, b), device=dev) for v in libs}
        tail = (batch, m, k, a.stride(-2), a.stride(0) if lead else 0, b,
                x.stride(-2), x.stride(-1), x.stride(0) if lead else 0,
                stream)
        fns = {"current": (lambda ys=ys, tail=tail: call(
            libs["current"], "sct_panel_matmul", a.data_ptr(), x.data_ptr(),
            ys["current"].data_ptr(), *tail))}
        if parent_split_panel:
          partial = torch.empty(
              (libs["parent"].sct_panel_matmul_splits(batch, m, k), batch, m,
               b), dtype=torch.float64, device=dev)
          fns["parent"] = (lambda ys=ys, tail=tail, partial=partial: call(
              libs["parent"], "sct_panel_matmul", a.data_ptr(), x.data_ptr(),
              partial.data_ptr(), ys["parent"].data_ptr(), *tail))
        else:
          fns["parent"] = (lambda ys=ys, tail=tail: call(
              libs["parent"], "sct_panel_matmul", a.data_ptr(), x.data_ptr(),
              ys["parent"].data_ptr(), *tail))
        for fn in fns.values():
          fn()
        exact = torch.matmul(a.double(), x.double())
        magnitude = torch.matmul(torch.abs(a).double(), torch.abs(x).double())
        bound64 = 2.0**-24 * torch.abs(exact) + k * 2.0**-52 * magnitude
        shares = {v: float(torch.max(torch.abs(ys[v].double() - exact)
                                     / bound64)) for v in libs}
        splits, resident = ctypes.c_int(0), ctypes.c_int(0)
        call(libs["current"], "sct_panel_matmul_schedule", batch, m, k, b,
             int(a.data_ptr() % 16 == 0 and a.stride(-2) % 4 == 0),
             ctypes.byref(splits), ctypes.byref(resident))
        cublas = lambda x=x: torch.matmul(a, x)  # noqa: E731
        compare("panel_matmul",
                f"{'B=%d,' % batch if lead else ''}M={m},K={k},b={b}", fns,
                ys, [("_cublas", {v: cublas for v in libs}, False)],
                {"bound_ms": batch * (m * k + (m + k) * b) * 4 / bw * 1e3,
                 "float64_bound_share": shares,
                 "current_k_split": splits.value,
                 "current_resident_blocks": resident.value})
        del exact, magnitude, bound64, ys
      del full, a
      torch.cuda.empty_cache()

    # Kernel 7: the parent's two single-pass launches (1e-6, then the 1e-2
    # rescue) against the current pair's one, in turns, on the same panel
    # (columns scaled over three decades) and its float64 Gram: q of both
    # passes and info must be equal bit for bit.
    for lead, k in QR_CASES:
      y = torch.randn((*lead, k, 16), generator=gen, device=dev) * (
          torch.logspace(0, 3, 16, device=dev))
      gram = eigen_ops.panel_gram(y, y)
      batch = lead[0] if lead else 1
      qts = {v: torch.empty((2, *lead, 16, k), device=dev) for v in libs}
      infos = {v: torch.empty(lead, dtype=torch.int32, device=dev)
               for v in libs}
      bad = torch.empty(lead, dtype=torch.bool, device=dev)
      spare = torch.empty(lead, dtype=torch.int32, device=dev)
      tickets = fused._qr_tickets(dev)
      ystr = (y.stride(0) if lead else 0, y.stride(-2), y.stride(-1))

      def parent_pair(qts=qts, infos=infos, ystr=ystr, y=y, gram=gram,
                      batch=batch, k=k, spare=spare):
        for i, rel in enumerate((1e-6, 1e-2)):
          call(libs["parent"], "sct_cholqr_pass", y.data_ptr(),
               gram.data_ptr(), qts["parent"][i].data_ptr(),
               (infos["parent"] if i == 0 else spare).data_ptr(), batch, k,
               16, *ystr, rel, stream)

      def current_pair(qts=qts, infos=infos, ystr=ystr, y=y, gram=gram,
                       batch=batch, k=k, bad=bad):
        call(libs["current"], "sct_cholqr_pass_pair", y.data_ptr(),
             gram.data_ptr(), qts["current"].data_ptr(),
             infos["current"].data_ptr(), bad.data_ptr(), tickets.data_ptr(),
             batch, k, 16, *ystr, 1e-6, 1e-2, stream)

      compare("cholqr_pass_pair",
              f"{'B=%d,' % batch if lead else ''}N={k},b=16",
              {"parent": parent_pair, "current": current_pair}, qts)
      results[-1]["info_equal"] = bool(torch.equal(infos["parent"],
                                                   infos["current"]))
      results[-1]["workspace_zero"] = not bool(tickets.any())
      print(json.dumps({"kernel": "cholqr_pass_pair", "shape": results[-1][
          "shape"], "info_equal": results[-1]["info_equal"],
                        "workspace_zero": results[-1]["workspace_zero"]}),
            flush=True)

  cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
  sass = {v: _sass(build, cuobjdump, p) for v, p in (("parent", par_path),
                                                      ("current", cur_path))}
  same_code = {}
  for key, ops in sorted(sass["parent"].items()):
    cur = _current_key(key)
    if cur in sass["current"] and not cur.startswith(_REDESIGNED):
      same_code[cur] = {"parent": key, "instructions": len(ops),
                        "sass_equal": ops == sass["current"][cur]}
  print(json.dumps({"sass_equal_up_to_parameter_offsets": same_code}),
        flush=True)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  print(smi)
  if args.out:
    with open(args.out, "w") as f:
      json.dump({"kernels": results, "sass": same_code, "nvidia_smi": smi},
                f, indent=1)
  return 0


if __name__ == "__main__":
  sys.exit(main())
