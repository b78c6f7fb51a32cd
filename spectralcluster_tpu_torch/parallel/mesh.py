"""Device-mesh helpers.

Port of ``spectralcluster_tpu/parallel/mesh.py``. The mesh is a 2-D grid
of devices with the JAX package's axis names:

  * ``batch`` — data parallelism: independent utterances spread over
    devices. The batch drivers (``parallel/batch.py``) shard only this
    axis, as the JAX package's DP driver does: shard k (``batch_rows``)
    on ``devices[k, 0]`` in one process (``batch_sharding``), or on the
    ranks of batch index k
    of a distributed mesh, whose labels are gathered over each ``batch``
    line;
  * ``model`` — matrix sharding of one large affinity: the row-sharded path
    (``parallel/sharded.py``) splits its N×N work over one ``model`` line of
    the mesh, rows ``row_sharding(mesh, n)[r]`` on shard r.

The mesh only names devices: eager PyTorch places each tensor itself. It
comes in two forms. In one process, ``make_mesh(devices=...)`` names any
devices, repeats allowed (``[torch.device("cpu")] * 8`` runs eight shards
on the CPU). Once ``initialize_distributed`` has joined a
``torch.distributed`` world, ``make_mesh()`` names one entry per rank,
each holding that rank's device, and ``Mesh.ranks`` gives the rank of each
entry; the collectives then run between processes
(``parallel/collectives.py``).

The JAX module's ``NamedSharding`` helpers become what the port's drivers
read: ``batch_rows`` the utterances of each batch shard,
``batch_sharding`` the device of each utterance of a batch,
``row_sharding`` the row range of each ``model`` shard, ``replicated``
every device that holds a replicated value.
"""

from __future__ import annotations

import os
import typing

import numpy as np
import torch
import torch.distributed as dist

from spectralcluster_tpu_torch import utils

AXIS_NAMES = ("batch", "model")


class Mesh:
  """A (dp, mp) grid of ``torch.device``s named ("batch", "model").

  ``ranks`` is None for a mesh of one process, else the (dp, mp) grid of
  the ``torch.distributed`` rank of each entry. The process groups of its
  lines are made once, on first use, and kept here (``groups``).
  """

  def __init__(self, devices: np.ndarray,
               ranks: typing.Optional[np.ndarray] = None):
    if devices.ndim != 2:
      raise ValueError(f"expected a (dp, mp) device grid, got shape "
                       f"{devices.shape}")
    if ranks is not None and ranks.shape != devices.shape:
      raise ValueError("ranks and devices must have the same grid shape")
    self.devices = devices
    self.ranks = ranks
    self.groups: typing.Dict[str, typing.Any] = {}

  @property
  def shape(self) -> typing.Dict[str, int]:
    return dict(zip(AXIS_NAMES, self.devices.shape))


def _rank_device(rank: int) -> torch.device:
  """The device of ``rank`` in the joined world: its card under NCCL, the
  CPU under gloo."""
  if dist.get_backend() == "nccl":
    return torch.device("cuda", rank % torch.cuda.device_count())
  return torch.device("cpu")


def make_mesh(dp: typing.Optional[int] = None,
              mp: typing.Optional[int] = None,
              devices: typing.Optional[typing.Sequence] = None) -> Mesh:
  """Create a (batch=dp, model=mp) mesh.

  ``devices`` names the devices of a mesh in this process. Without it the
  mesh covers the ``torch.distributed`` world when one is initialized (one
  entry per rank, in rank order, so every process builds the same grid),
  else every CUDA device, and raises when there is none; pass e.g.
  ``[torch.device("cpu")] * 8`` to run on the CPU. Without dp and mp the
  mesh is all data parallel, as in the JAX package.
  """
  ranks = None
  if devices is None and dist.is_available() and dist.is_initialized():
    world = dist.get_world_size()
    devices = [_rank_device(r) for r in range(world)]
    ranks = np.arange(world)
  elif devices is None:
    if not torch.cuda.is_available():
      raise RuntimeError("no CUDA device is available; pass devices (e.g. "
                         "[torch.device('cpu')]) to run on the CPU")
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
  devices = [torch.device(d) for d in devices]
  n = len(devices)
  if dp is None and mp is None:
    dp, mp = n, 1
  elif dp is None:
    dp = n // mp
  elif mp is None:
    mp = n // dp
  if dp * mp != n:
    raise ValueError(f"dp*mp = {dp}*{mp} != {n} devices")
  arr = np.empty((n,), dtype=object)
  arr[:] = devices
  return Mesh(arr.reshape(dp, mp),
              None if ranks is None else ranks.reshape(dp, mp))


def batch_rows(mesh: Mesh, count: int) -> typing.List[typing.List[int]]:
  """The rows each ``batch`` shard holds of a batch of ``count``
  utterances: the batch axis padded to a multiple of dp, shard k holding
  rows [k·⌈count/dp⌉, (k+1)·⌈count/dp⌉) less the padding (possibly
  none)."""
  dp = mesh.shape["batch"]
  per_shard = -(-count // dp)
  return [list(range(k * per_shard, min((k + 1) * per_shard, count)))
          for k in range(dp)]


def batch_sharding(mesh: Mesh, count: int) -> typing.List[torch.device]:
  """The device of each of ``count`` utterances: the rows of batch shard k
  (``batch_rows``) on ``mesh.devices[k, 0]``. On a mesh of
  ``torch.distributed`` ranks that is the device of rank
  ``mesh.ranks[k, 0]``; a rank computes the shard of its own batch index
  (``batch.py``)."""
  return [mesh.devices[k, 0]
          for k, rows in enumerate(batch_rows(mesh, count)) for _ in rows]


def row_sharding(mesh: Mesh, n: int) -> typing.List[slice]:
  """The rows of an (n, ...) array held by each shard of the ``model``
  axis: contiguous stripes of n/mp rows, shard r holding stripe r."""
  mp = mesh.shape["model"]
  if n % mp:
    raise ValueError(f"{n} rows do not split over {mp} model shards")
  m = n // mp
  return [slice(r * m, (r + 1) * m) for r in range(mp)]


def replicated(mesh: Mesh) -> typing.List[torch.device]:
  """Every device of the mesh, in row-major order: where a replicated
  value has one copy each."""
  return list(mesh.devices.flat)


def initialize_distributed(coordinator_address: typing.Optional[str] = None,
                           num_processes: typing.Optional[int] = None,
                           process_id: typing.Optional[int] = None,
                           device: typing.Union[str, torch.device,
                                                None] = None) -> None:
  """Join this process to a ``torch.distributed`` world.

  Wraps ``torch.distributed.init_process_group``: ``coordinator_address``
  is the "host:port" of rank 0's store (``init_method="tcp://..."``), or
  None to read ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
  from the environment. ``device`` is this rank's device type: "cuda"
  (the default) joins with NCCL on card ``rank % device_count``, "cpu"
  with gloo. A CUDA world whose NCCL setup fails raises; nothing falls
  back to gloo or to the CPU. Does nothing when a world is already
  initialized, as the JAX function does.
  """
  if dist.is_initialized():
    return
  dev = utils.resolve_device("cuda" if device is None else device)
  rank = (process_id if process_id is not None
          else int(os.environ.get("RANK", "0")))
  kwargs = {}
  if dev.type == "cuda":
    card = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(card)
    # Eager NCCL setup: a failure raises here, not at the first collective.
    kwargs["device_id"] = card
    backend = "nccl"
  else:
    backend = "gloo"
  init_method = ("env://" if coordinator_address is None
                 else f"tcp://{coordinator_address}")
  dist.init_process_group(
      backend, init_method=init_method,
      world_size=-1 if num_processes is None else num_processes,
      rank=-1 if process_id is None else process_id, **kwargs)
