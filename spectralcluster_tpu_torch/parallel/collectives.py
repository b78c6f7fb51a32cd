"""The collectives of the row-sharded path, over one line of a mesh.

The JAX package writes its sharded path as ordinary jnp with sharding
annotations and lets GSPMD insert the collectives. Eager PyTorch has no
such compiler, so the port writes one SPMD algorithm against a small
shard-group interface, with the collectives explicit:

  * ``all_gather(xs)`` — the shards' row blocks concatenated in shard
    order, one replicated tensor;
  * ``all_reduce(xs, op)`` — the elementwise "sum" or "max" over shards,
    one replicated tensor;
  * ``all_to_all(sends)`` — ``sends[i][j]`` goes from local shard i to
    shard j; returns, for each local shard, the blocks received from every
    shard in shard order. Blocks share their trailing shape; their row
    counts may differ;
  * ``ring_shift(xs)`` — shard r receives shard r−1's value (mod P).

A group holds the shards ``shards`` of one mesh line in this process, on
``devices``: the algorithm keeps a list with one tensor per local shard
and maps its local work over that list. A replicated result is held once
per process, on ``devices[0]``; each shard reads it with ``.to(device)``,
a no-op on the same device.

Two backends:

  * ``InProcessGroup`` — every shard of the line lives in this process,
    possibly all on one device; the collectives are tensor copies. This is
    the only way to run P > 1 shards on one card (NCCL refuses two ranks
    on one GPU).
  * ``DistributedGroup`` — one shard per ``torch.distributed`` rank; the
    collectives are ``all_gather_into_tensor``, ``all_reduce``,
    ``all_to_all_single`` and ``batch_isend_irecv`` on the world's backend
    (NCCL on cards, gloo on the CPU).

Which one a mesh gets is fixed by how it was made (``mesh.make_mesh``):
there is no switch between them.
"""

from __future__ import annotations

import typing

import torch
import torch.distributed as dist

from spectralcluster_tpu_torch.parallel import mesh as mesh_lib

# ``all_gather_into_tensor`` under its newer name, where torch has it.
_all_gather_single = getattr(dist, "all_gather_single",
                             getattr(dist, "all_gather_into_tensor", None))


def _reduce(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
  if op == "sum":
    return a + b
  if op == "max":
    return torch.maximum(a, b)
  raise ValueError(f"unknown reduction {op!r}")


class InProcessGroup:
  """Every shard of the line in this process: collectives are copies."""

  def __init__(self, devices: typing.Sequence[torch.device]):
    self.devices = list(devices)
    self.size = len(self.devices)
    self.shards = list(range(self.size))

  def all_gather(self, xs: typing.Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([x.to(self.devices[0]) for x in xs])

  def all_reduce(self, xs: typing.Sequence[torch.Tensor],
                 op: str = "sum") -> torch.Tensor:
    acc = xs[0].to(self.devices[0])
    for x in xs[1:]:
      acc = _reduce(acc, x.to(acc.device), op)
    return acc

  def all_to_all(self, sends):
    return [[sends[i][j].to(self.devices[j]) for i in range(self.size)]
            for j in range(self.size)]

  def ring_shift(self, xs: typing.Sequence[torch.Tensor]):
    return [xs[(r - 1) % self.size].to(self.devices[r])
            for r in range(self.size)]


class DistributedGroup:
  """One shard per rank: ``ranks`` (global ranks in line order), this
  rank's position in it, and the process group (None for the world)."""

  def __init__(self, ranks: typing.Sequence[int], group,
               device: torch.device):
    self.ranks = [int(r) for r in ranks]
    self.size = len(self.ranks)
    self.group = group
    self.position = self.ranks.index(dist.get_rank())
    self.shards = [self.position]
    self.devices = [device]

  def all_gather(self, xs) -> torch.Tensor:
    (x,) = xs
    x = x.contiguous()
    out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x, group=self.group)
    return out

  def all_reduce(self, xs, op: str = "sum") -> torch.Tensor:
    (x,) = xs
    out = x.clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=self.group)
    return out

  def all_to_all(self, sends):
    (blocks,) = sends
    send_rows = [int(b.shape[0]) for b in blocks]
    counts = torch.tensor(send_rows, dtype=torch.int64,
                          device=self.devices[0])
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv_counts, counts, group=self.group)
    recv_rows = recv_counts.tolist()
    out = blocks[0].new_empty((sum(recv_rows),) + tuple(blocks[0].shape[1:]))
    dist.all_to_all_single(out, torch.cat(blocks).contiguous(), recv_rows,
                           send_rows, group=self.group)
    return [list(torch.split(out, recv_rows))]

  def ring_shift(self, xs):
    (x,) = xs
    if self.size == 1:
      return [x]
    x = x.contiguous()
    recv = torch.empty_like(x)
    nxt = self.ranks[(self.position + 1) % self.size]
    prv = self.ranks[(self.position - 1) % self.size]
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, nxt, self.group),
        dist.P2POp(dist.irecv, recv, prv, self.group)])
    for req in reqs:
      req.wait()
    return [recv]


def _distributed_group(mesh: mesh_lib.Mesh, key: str, lines_ranks,
                       lines_devices) -> DistributedGroup:
  """The group of the line through this rank, among ``lines_ranks``. Every
  rank makes the process groups of all lines, in the same order, on the
  first call; the mesh keeps them under ``key``."""
  if key not in mesh.groups:
    me, world = dist.get_rank(), dist.get_world_size()
    for line_ranks, line_devices in zip(lines_ranks, lines_devices):
      line = [int(r) for r in line_ranks]
      group = None if len(line) == world else dist.new_group(line)
      if me in line:
        mesh.groups[key] = DistributedGroup(line, group,
                                            line_devices[line.index(me)])
  return mesh.groups[key]


def axis_groups(mesh: mesh_lib.Mesh, axis: str) -> typing.List:
  """The groups of the mesh lines along ``axis`` that this process holds:
  every line of a mesh of one process (for "model", one per row of the
  grid), or the one line through this rank of a distributed mesh."""
  ax = mesh_lib.AXIS_NAMES.index(axis)
  devices = mesh.devices if ax == 1 else mesh.devices.T
  if mesh.ranks is None:
    return [InProcessGroup(list(line)) for line in devices]
  ranks = mesh.ranks if ax == 1 else mesh.ranks.T
  return [_distributed_group(mesh, axis, ranks, devices)]


def model_group(mesh: mesh_lib.Mesh):
  """The ``model`` line the row-sharded path runs on: the first row of a
  mesh of one process (further rows would compute the same replicas), or
  the line through this rank."""
  return axis_groups(mesh, "model")[0]


def mesh_group(mesh: mesh_lib.Mesh):
  """One group over every entry of the mesh, in row-major order."""
  if mesh.ranks is None:
    return InProcessGroup(mesh_lib.replicated(mesh))
  return _distributed_group(mesh, "mesh", [mesh.ranks.flat],
                            [mesh_lib.replicated(mesh)])
