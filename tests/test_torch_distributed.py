"""The port's row-sharded path and batch drivers across torch.distributed
ranks (gloo, CPU).

Launches ``tools/torch_distributed_validate.py``: 2 and 4 local processes
join one gloo world and run ``cluster_large_sharded`` with one shard per
rank, each rank holding its labels against the same path with as many
shards in one process, checking the ring order and replica consistency
across processes, and bounding the largest tensor any op makes on it
(no rank holds an (N, N) matrix). The same launch runs the batch leg:
``cluster_batch`` (Auto, SubspaceIteration and HostGeneral),
``cluster_batch_streamed`` and ``cluster_batch_autotuned`` on a mesh of
the ranks give every rank the single-process drivers' labels on 7 ragged
utterances (uneven shards).
Each launch runs under its own timeout, as ``tests/test_multihost.py``
does, so a hang fails fast.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("ranks", [2, 4])
def test_gloo_ranks_match_in_process_shards(ranks):
  script = os.path.join(REPO, "tools", "torch_distributed_validate.py")
  proc = subprocess.run(
      [sys.executable, script, "--ranks", str(ranks)], capture_output=True,
      timeout=120, text=True)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert proc.stdout.strip().splitlines()[-1] == (
      '{"ok": true, "ranks": %d}' % ranks)
  assert proc.stdout.count('"labels_equal_in_process": true') == 2 * ranks
  assert proc.stdout.count('"batch_equal_single_process": true') == 5 * ranks
  assert proc.stdout.count('"batch_mismatch_caught": true') == ranks
