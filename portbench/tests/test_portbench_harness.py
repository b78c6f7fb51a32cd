"""CPU tests of the port's benchmark harness (``portbench/``).

    python -m pytest portbench/tests -q             # on the CPU
    python -m pytest portbench/tests -q -m gpu      # the card's test

The cells run here at tiny sizes on the CPU, where the port's kernels are
its plain twins: generator, reference, comparison, readers and the result's
line are checked, not speed.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

from portbench import compare, control, generator, roofline, run  # noqa: E402
from portbench import trace as trace_lib  # noqa: E402
from portbench.reference import common  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]

# Tiny sizes of each traffic for the CPU.
TINY = {"long": (300, 500, 2), "calls": (200, 400, 3)}


@pytest.fixture
def tiny(monkeypatch):
  """run.cell with each traffic's pool cut to a few tiny recordings."""
  orig = run.cell

  def small(workload):
    bench, wl, config, traffic, limits = orig(workload)
    lo, hi, pool = TINY[wl["traffic"]]
    traffic = dict(traffic, pool=pool, sizes={"kind": "uniform", "lo": lo,
                                              "hi": hi})
    return bench, wl, config, traffic, limits

  monkeypatch.setattr(run, "cell", small)
  return small


# --- the generator ----------------------------------------------------------


def _traffic(name):
  return json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                     name + ".json")))


@pytest.mark.parametrize("name", ["long", "calls"])
def test_generator_deterministic_by_seed(name):
  t = dict(_traffic(name), pool=4, sizes={"kind": "uniform", "lo": 256,
                                          "hi": 512})
  a, b = generator.make_pool(t, 2**31 + 17), generator.make_pool(t, 2**31 + 17)
  c = generator.make_pool(t, 5)
  for ra, rb in zip(a, b):
    np.testing.assert_array_equal(ra.embeddings, rb.embeddings)
    np.testing.assert_array_equal(ra.speakers, rb.speakers)
  # Other seeds: the same sizes and speaker counts, other recordings.
  assert sorted(r.embeddings.shape[0] for r in a) == sorted(
      r.embeddings.shape[0] for r in c)
  assert sorted(r.n_speakers for r in a) == sorted(r.n_speakers for r in c)
  assert not np.array_equal(a[0].embeddings[:8], c[0].embeddings[:8])


def test_generator_turns_and_speakers():
  t = dict(_traffic("long"), pool=6, sizes={"kind": "uniform",
                                            "lo": 2000, "hi": 4000})
  lengths = []
  for rec in generator.make_pool(t, 9):
    x, spk = rec.embeddings, rec.speakers
    assert x.dtype == np.float32 and x.shape[1] == 256
    assert spk.max() < rec.n_speakers
    change = np.flatnonzero(spk[1:] != spk[:-1]) + 1
    bounds = np.concatenate([[0], change, [spk.size]])
    lengths.extend(np.diff(bounds)[:-1])
    # Segments of one speaker sit together, of two speakers apart.
    a = x[spk == spk[0]][:2]
    assert np.dot(a[0], a[1]) / np.linalg.norm(a[0]) / np.linalg.norm(
        a[1]) > 0.9
  # Geometric turns of mean 12 (the last turn of each recording is cut).
  assert 10.0 < np.mean(lengths) < 14.0


def test_pool_sizes_and_speaker_split():
  t = _traffic("calls")
  sizes = generator.pool_sizes(t)
  assert sizes.size == t["pool"] and sizes.min() >= 256 and sizes.max() <= 1024
  counts = np.bincount(generator.pool_speakers(t), minlength=8)[2:]
  assert counts.sum() == t["pool"]
  # CALLHOME's 303/136/43/10/6/2 of 500 calls, split over 64.
  np.testing.assert_array_equal(counts, [39, 17, 6, 1, 1, 0])


# --- the reference against the port's CPU path ------------------------------


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [3, 4])
def test_reference_agrees_with_port_cpu(tiny, workload, seed):
  r = control.readings(workload, seed, "float64", "cpu")
  prog = r["program"]
  assert prog["label_error"] == 0 and prog["n_clusters_diff"] == 0
  assert prog["eig_err_median"] < 1e-4
  # The float64 reference against itself: exact.
  assert r["control_numbers"]["eig_err_median"] == 0


def test_reference_dense_and_krylov_agree():
  rng = np.random.default_rng(0)
  q, _ = np.linalg.qr(rng.standard_normal((600, 600)))
  w = np.concatenate([[50.0, 40.0, 30.0], rng.uniform(0, 1, 597)])
  m = (q * w) @ q.T
  import torch
  mt = torch.as_tensor(m)
  wd, _, _ = common.symmetric_top_eig(mt, 8, 1e-10, dense_max=4096)
  wk, uk, res = common.symmetric_top_eig(mt, 8, 1e-10, dense_max=100)
  assert res <= 1e-10
  np.testing.assert_allclose(wk.numpy(), wd.numpy(), rtol=1e-9)


def test_admissible_counts_cover_a_threshold_within_rounding():
  # A two-speaker call (calls seed 4100000104, recording 38, on an H100):
  # the reference's 8th eigenvalue lies 0.4% under the snap threshold
  # (1e-5 of the largest), the program's float32 one just over it; the
  # rule counts 7 on the first and 4 on the second.
  ref = [531.181, 435.686, 6.49087, 5.62166, 0.0593916, 0.0432033,
         0.0161666, 0.00529046]
  prog = [531.181, 435.686, 6.49135, 5.62165, 0.0593785, 0.0432126,
          0.0161748, 0.00531379]
  assert common.eigengap_descend(np.array(ref), 7, 0.01, 531.181) == 7
  assert common.eigengap_descend(np.array(prog), 7, 0.01, 531.181) == 4
  assert common.admissible_counts(ref, 7, 2, 0.01, 0.0) == [7]
  assert common.admissible_counts(ref, 7, 2, 0.01, 5e-6) == [4, 7]
  # Far from every threshold, one count only.
  clear = [500.0, 400.0, 1.0, 0.9, 0.5, 0.4, 0.3, 0.2]
  assert common.admissible_counts(clear, 7, 2, 0.01, 5e-6) == [2]


def test_label_errors_judge_a_partition_not_its_names():
  rng = np.random.default_rng(1)
  centres = np.eye(3)
  truth = np.repeat(np.arange(3), 20)
  emb = centres[truth] + rng.standard_normal((60, 3)) * 0.05
  assert common.label_errors(emb, truth, 1e-2) == 0
  assert common.label_errors(emb, (truth + 1) % 3, 1e-2) == 0
  moved = truth.copy()
  moved[:2] = 1
  assert common.label_errors(emb, moved, 1e-2) == 2


# --- the trace's arithmetic -------------------------------------------------


class _Ev:

  def __init__(self, name, start, dur, device, annotation=False):
    self._n, self._s, self._d, self._dev = name, start, dur, device
    self._a = annotation

  def is_user_annotation(self):
    return self._a

  def name(self):
    return self._n

  def start_ns(self):
    return self._s

  def duration_ns(self):
    return self._d

  def device_type(self):
    import torch
    return (torch.autograd.DeviceType.CUDA if self._dev
            else torch.autograd.DeviceType.CPU)


def test_idle_share_is_a_union_of_intervals():
  # Window [0, 1000). Stream 1: kernels [100, 300) and [500, 600); stream
  # 2: a copy [200, 450) overlapping the first kernel. Union: [100, 450)
  # and [500, 600) = 450 busy; gaps [0,100), [450,500), [600,1000).
  events = [
      _Ev("k1", 100, 200, True), _Ev("memcpy", 200, 250, True),
      _Ev("k2", 500, 100, True), _Ev("aten::item", 620, 300, False),
      _Ev("portbench:call", 0, 1000, False), _Ev("late", 1200, 50, True),
      # The profiler's copy of a record_function span on the card's
      # timeline is no device work.
      _Ev("portbench:call", 0, 1000, True, annotation=True),
      _Ev("some annotation", 0, 1000, True, annotation=True)]
  s = trace_lib.summarize(events, 0, 1000)
  assert s["busy_s"] == pytest.approx(450e-9)
  assert s["window_s"] == pytest.approx(1000e-9)
  assert s["device_events"] == 3
  assert s["device_s_by_name"]["memcpy"] == pytest.approx(250e-9)
  gaps = dict(s["idle_gaps"])
  # The longest gap's midpoint (800) lies in aten::item, the innermost.
  assert gaps["aten::item"] == pytest.approx(400e-9)
  assert gaps["portbench:call"] == pytest.approx(150e-9)
  ctx = {"trace": s, "calls": []}
  from portbench.metrics import device_idle_pct
  assert device_idle_pct.read(ctx) == pytest.approx(55.0)


def test_roofline_bounds_match_the_kernel_table():
  peaks = roofline.card_peaks("NVIDIA H100 80GB HBM3")
  assert roofline.bound_s(roofline.affinity_work(10240, 256),
                          peaks) * 1e3 == pytest.approx(0.401, abs=5e-4)
  with pytest.raises(KeyError):
    roofline.card_peaks("cpu")


def test_roofline_reader_reads_its_kernels_only():
  from portbench.metrics import affinity_roofline_pct
  ctx = {"card": "NVIDIA H100 80GB HBM3", "config": {"embedding_dim": 256},
         "calls": [{"segments": 1024, "error": None,
                    "launches": {"affinity": 1}}],
         "trace": {"device_s_by_name": {"void affinity_kernel<1>": 1e-5}}}
  share = affinity_roofline_pct.read(ctx)
  bound = roofline.bound_s(roofline.affinity_work(1024, 256),
                           roofline.card_peaks(ctx["card"]))
  assert share == pytest.approx(100 * bound / 1e-5)
  # A trace without the kernel: no reading, not 0.
  ctx["trace"] = {"device_s_by_name": {"volta_sgemm": 1e-5}}
  assert affinity_roofline_pct.read(ctx) is None


def test_window_shape_reads_a_first_pass_that_warms_up():
  # Two items replayed three times; item 0's first call takes twice its
  # later ones.
  lat = [0.2, 0.1, 0.1, 0.1, 0.1, 0.1]
  calls = [{"latency_s": t, "segments": 100} for t in lat]
  line = run.window_shape(calls, 2)
  assert "max 2.0000" in line and "median 1.5000" in line
  assert line.startswith("window quarters, segments/s: ")


def test_window_runs_whole_passes():
  class _Entry:
    def call(self, item):
      time.sleep(1e-3)
      return item

    def segments(self, item):
      return 1

  # The clock runs out during the first call; the pass is finished.
  calls, window_s, _ = run.run_window(_Entry(), [1, 2, 3], 1e-4, False,
                                      lambda: None)
  assert [c["item"] for c in calls] == [1, 2, 3] and window_s >= 3e-3


# --- the result's line ------------------------------------------------------


def _check_line(result, workload, trace):
  assert list(result)[-1] == "checks"
  for key in ("correct", "attempted", "failed", "metrics", "device"):
    assert key in result
  wanted = run.metrics_for(BENCH, workload, trace)
  for name, m in result["metrics"].items():
    assert NAME.match(name) and UNIT.match(m["unit"])
    assert isinstance(m["value"], float)
  if not trace:
    assert set(result["metrics"]) == {m["name"] for m in wanted}
  for name, c in result["checks"].items():
    assert NAME.match(name) and "value" in c and "limit" in c


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(tiny, workload, trace):
  result = run.execute(workload, 11, 0.3, trace, "cpu")
  assert result["correct"] and result["failed"] == 0
  assert result["attempted"] >= 1
  _check_line(result, workload, trace)
  if trace:
    assert "breakdown" in result
    json.dumps(result)


def test_benchmark_json_names_its_files():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  for c in BENCH["configs"]:
    assert NAME.match(c["name"]) and os.path.exists(os.path.join(ROOT,
                                                                 c["file"]))
    cfg = json.load(open(os.path.join(ROOT, c["file"])))
    assert os.path.exists(os.path.join(ROOT, "portbench", "reference",
                                       cfg["reference"] + ".py"))
  for w in BENCH["workloads"]:
    assert NAME.match(w["name"]) and len(w["why"]) <= 200
    traffic = _traffic(w["traffic"])
    assert os.path.exists(os.path.join(ROOT, "portbench", "entries",
                                       traffic["entry"] + ".py"))
    assert os.path.exists(os.path.join(ROOT, "portbench", "limits",
                                       w["name"] + ".json"))
  for m in BENCH["end_to_end"] + BENCH["per_layer"]:
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
  for m in BENCH["per_layer"]:
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                       run.quantity(m) + ".py"))
  # Each per-layer metric moves an end-to-end metric that each of its
  # cells reports.
  for m in BENCH["per_layer"]:
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    assert set(m["workloads"]) <= set(moved.get("workloads", WORKLOADS))


# --- what the check catches -------------------------------------------------


def _alter(field):
  def wrap(call):
    state = {"n": 0}

    def broken(item):
      # Every other call of the window, its first included, is broken.
      out = call(item)
      state["n"] += 1
      if state["n"] % 2 == 0:
        return out
      out = dict(out)
      if field == "labels":
        # One segment moved to another cluster where it is produced.
        labels = out["labels"].copy()
        labels[0] = (labels[0] + 1) % max(2, int(labels.max()) + 1)
        out["labels"] = labels
      elif field == "n_clusters":
        out["n_clusters"] += 1
      elif field == "eigenvalues":
        out["eigenvalues"] = out["eigenvalues"] * (1 + 1e-2)
      elif field == "raise":
        raise RuntimeError("planted")
      return out
    return broken
  return wrap


@pytest.mark.parametrize("field", ["labels", "n_clusters", "eigenvalues",
                                   "raise"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_altered_answers_are_not_correct(tiny, workload, field):
  result = run.execute(workload, 12, 0.3, False, "cpu",
                       break_answer=_alter(field))
  assert result["correct"] is False


def _control_verdicts(workload, seed, device):
  limits = json.load(open(os.path.join(ROOT, "portbench", "limits",
                                       workload + ".json")))["limits"]
  r = control.readings(workload, seed, "tf32", device)
  return (compare.judge(r["program"], limits)[0],
          compare.judge(r["control_numbers"], limits)[0])


def test_control_fails_where_the_program_passes(tiny):
  """The reference in TF32 (its products' inputs rounded to TF32 on the
  CPU) in the program's place fails a limit of the calls cell; the
  program, at the same tiny sizes, passes them."""
  ok_prog, ok_ctrl = _control_verdicts("icassp2018.calls", 21, "cpu")
  assert ok_prog and not ok_ctrl


@pytest.mark.gpu
def test_control_fails_on_the_card():
  """The same on the card, for every cell, at the cell's own sizes and
  pool: the card's TF32 products, not an emulation. On the CPU the long
  cell's float32 solve rounds worse than the card's, and a pool of a few
  recordings makes the median a tail, so only this shows it there."""
  if not _has_card():
    pytest.skip("needs a CUDA card")
  for workload in WORKLOADS:
    ok_prog, ok_ctrl = _control_verdicts(workload, 2147483999, "cuda")
    assert ok_prog and not ok_ctrl, workload


# --- imports ----------------------------------------------------------------

_TINY_RUN = """
import sys, json
sys.path.insert(0, {root!r})
from portbench import run
orig = run.cell
def small(w):
  b, wl, c, t, l = orig(w)
  return b, wl, c, dict(t, pool=1, sizes={{"kind": "uniform", "lo": 200,
                                          "hi": 200}}), l
run.cell = small
result = run.execute({workload!r}, 1, 0.2, False, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("workload", WORKLOADS)
def test_no_jax_in_a_cell_process(workload):
  out = subprocess.run(
      [sys.executable, "-c", _TINY_RUN.format(root=ROOT, workload=workload)],
      capture_output=True, text=True, check=True, cwd=ROOT,
      env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
  top = set(json.loads(out.stdout.strip().splitlines()[-1]))
  assert not top & {"jax", "jaxlib", "flax", "spectralcluster_tpu"}
  assert "spectralcluster_tpu_torch" in top


def test_reference_imports_nothing_of_the_program():
  code = f"""
import sys, json
sys.path.insert(0, {ROOT!r})
import numpy as np
from portbench import generator
from portbench.reference import icassp2018
cfg = lambda n: json.load(open({ROOT!r} + "/portbench/configs/" + n + ".json"))
t = json.load(open({ROOT!r} + "/portbench/traffic/calls.json"))
t = dict(t, pool=1, sizes={{"kind": "uniform", "lo": 200, "hi": 200}})
rec = generator.make_pool(t, 1)[0]
icassp2018.solve(rec, cfg("icassp2018"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True, cwd=ROOT)
  top = set(json.loads(out.stdout.strip().splitlines()[-1]))
  assert not top & {"spectralcluster_tpu_torch", "spectralcluster_tpu",
                    "jax", "jaxlib"}
  for name in os.listdir(os.path.join(ROOT, "portbench", "reference")):
    if name.endswith(".py"):
      src = open(os.path.join(ROOT, "portbench", "reference", name)).read()
      assert "spectralcluster_tpu" not in src.replace(
          "spectralcluster_tpu_torch", "")
      assert not re.search(r"^\s*(from|import)\s+spectralcluster", src, re.M)


def test_run_refuses_without_a_card():
  if _has_card():
    pytest.skip("a CUDA card is present")
  out = subprocess.run(
      [sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
       "--seed", "1", "--seconds", "1", "--trace", "0"],
      capture_output=True, text=True, cwd=ROOT)
  assert out.returncode != 0 and out.stdout.strip() == ""


def _has_card() -> bool:
  import torch
  return torch.cuda.is_available()


@pytest.mark.gpu
def test_a_cell_on_the_card():
  if not _has_card():
    pytest.skip("needs a CUDA card")
  out = subprocess.run(
      [sys.executable, "portbench/run.py", "--workload", "icassp2018.calls",
       "--seed", "4242424242", "--seconds", "2", "--trace", "0"],
      capture_output=True, text=True, cwd=ROOT, check=True)
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result["correct"] and result["device"]["platform"] == "gpu"
  _check_line(result, "icassp2018.calls", False)


