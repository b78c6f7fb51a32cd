"""Distributed sanity checks.

Port of ``spectralcluster_tpu/parallel/sanity.py``: checks that make the
failure modes of a sharded run loud, on a mesh of one process or across
``torch.distributed`` ranks (``collectives.py``):

  * ``check_replica_consistency`` — every device (or rank) of the mesh
    holds the same bits of a nominally replicated value;
  * ``check_deterministic`` — a function gives the same bits on identical
    inputs across runs;
  * ``debug_nans`` — a ``TorchDispatchMode`` that raises
    ``FloatingPointError`` at the first op whose floating output holds a
    NaN, as ``jax_debug_nans`` does (an infinity passes: log(0) = −inf is
    not trapped). Torch's anomaly mode covers backward passes only;
  * ``check_ring_order`` — one ``ring_shift`` over a mesh axis moves shard
    i's value to shard i+1 (mod P), and P shifts bring every value home:
    the order ``ring.py`` and Diffuse's ring assume. Between processes, a
    mesh whose ranks are ordered differently on another process breaks it.
"""

from __future__ import annotations

import contextlib
import typing

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from spectralcluster_tpu_torch.parallel import collectives
from spectralcluster_tpu_torch.parallel import mesh as mesh_lib


def check_replica_consistency(mesh: mesh_lib.Mesh, value) -> None:
  """Assert every device of the mesh holds the same bits of ``value``.

  In one process, ``value`` is one tensor (copied to every device) or a
  sequence of one copy per device in ``mesh.replicated`` order; across
  ranks, this rank's copy. The copies are all-gathered over both axes.
  Raises AssertionError with the worst absolute deviation if any copy
  differs.
  """
  group = collectives.mesh_group(mesh)
  if isinstance(value, (list, tuple)):
    copies = [torch.as_tensor(v) for v in value]
  else:
    copies = [torch.as_tensor(value)] * len(group.devices)
  if len(copies) != len(group.devices):
    raise ValueError(f"expected {len(group.devices)} copies, got "
                     f"{len(copies)}")
  flat = [c.reshape(1, -1).to(device=d, dtype=torch.float32)
          for c, d in zip(copies, group.devices)]
  sizes = group.all_gather([torch.tensor([f.shape[1]], device=f.device)
                            for f in flat])
  if int(sizes.min()) != int(sizes.max()):
    raise AssertionError(
        f"replica consistency violated: copies hold {sizes.tolist()} "
        "elements")
  gathered = group.all_gather(flat)
  worst = float(torch.amax(torch.amax(gathered, dim=0)
                           - torch.amin(gathered, dim=0)))
  assert worst == 0.0, (
      f"replica consistency violated: max cross-device deviation {worst:g} "
      "(a nominally replicated value differs between devices)")


def _host_leaves(out) -> typing.List[np.ndarray]:
  return [np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor)
          else np.asarray(x) for x in tree_leaves(out)]


def check_deterministic(fn, *args, runs: int = 2) -> None:
  """Assert ``fn(*args)`` is bitwise reproducible across ``runs`` calls."""
  ref = _host_leaves(fn(*args))
  for _ in range(runs - 1):
    again = _host_leaves(fn(*args))
    if len(again) != len(ref) or not all(
        np.array_equal(a, b) for a, b in zip(ref, again)):
      raise AssertionError(
          "nondeterministic output: identical inputs produced different "
          "bits across runs (unsafe host state, a stateful op, or "
          "reduction-order leakage)")


# Allocations: their memory is not yet written, and may hold any bits.
_UNWRITTEN = frozenset(("empty", "empty_like", "new_empty", "empty_strided",
                        "new_empty_strided"))


class _NanTrap(TorchDispatchMode):
  """Raise at the first op whose floating output holds a NaN."""

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    if func.overloadpacket.__name__ in _UNWRITTEN:
      return out
    for t in tree_leaves(out):
      if (isinstance(t, torch.Tensor)
          and (t.is_floating_point() or t.is_complex())
          and bool(torch.isnan(t).any())):
        raise FloatingPointError(f"NaN produced by {func}")
    return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
  """Trap the first NaN produced by any tensor op in the block.

  Each op's output is checked on the host as it is made, which waits for
  the device at every op: use around tests and debugging sessions only.
  The trap ends with the block; ``enable=False`` runs the block without
  it.
  """
  if not enable:
    yield
    return
  with _NanTrap():
    yield


def check_ring_order(mesh: mesh_lib.Mesh, axis_name: str = "model") -> None:
  """Assert the ring over ``axis_name`` is ordered as assumed.

  Probes every line of the axis this process holds with one value per
  shard, its index: after ONE ``ring_shift`` shard j must hold (j−1) mod
  P, and after P shifts every value must be home. The line's values are
  all-gathered, so every rank raises alike.
  """
  for group in collectives.axis_groups(mesh, axis_name):
    p = group.size
    iota = [torch.tensor([float(s)], device=d)
            for s, d in zip(group.shards, group.devices)]
    one = group.ring_shift(iota)
    full = iota
    for _ in range(p):
      full = group.ring_shift(full)
    one = group.all_gather(one).cpu().numpy()
    full = group.all_gather(full).cpu().numpy()
    expect = np.arange(p, dtype=np.float32)
    if not np.array_equal(one, np.roll(expect, 1)):
      raise AssertionError(
          f"ring order violated: one ring shift produced {one!r}, expected "
          f"{np.roll(expect, 1)!r} — mesh axis '{axis_name}' is not in the "
          "logical ring order the sharded paths assume")
    if not np.array_equal(full, expect):
      raise AssertionError(
          f"ring round-trip violated: {p} shifts produced {full!r}, "
          f"expected {expect!r}")
