"""Device-mesh helpers.

Port of ``spectralcluster_tpu/parallel/mesh.py``'s ``make_mesh``. The mesh
is a 2-D grid of devices with the JAX package's axis names:

  * ``batch`` — data parallelism: independent utterances spread over
    devices (``parallel/batch.py`` runs shard k of the batch axis on
    ``devices[k, 0]``);
  * ``model`` — matrix sharding of one large affinity; nothing in the port
    reads it yet, so the batch drivers use only column 0 and a mesh with
    mp > 1 leaves its other columns idle.

The mesh only names devices: eager PyTorch places each tensor itself. The
rest of the JAX module (``row_sharding``, ``replicated``,
``initialize_distributed``) belongs with the row-sharded pipeline on
``torch.distributed``, which is not ported yet (ROADMAP).
"""

from __future__ import annotations

import typing

import numpy as np
import torch

AXIS_NAMES = ("batch", "model")


class Mesh:
  """A (dp, mp) grid of ``torch.device``s named ("batch", "model")."""

  def __init__(self, devices: np.ndarray):
    if devices.ndim != 2:
      raise ValueError(f"expected a (dp, mp) device grid, got shape "
                       f"{devices.shape}")
    self.devices = devices

  @property
  def shape(self) -> typing.Dict[str, int]:
    return dict(zip(AXIS_NAMES, self.devices.shape))


def make_mesh(dp: typing.Optional[int] = None,
              mp: typing.Optional[int] = None,
              devices: typing.Optional[typing.Sequence] = None) -> Mesh:
  """Create a (batch=dp, model=mp) mesh over the devices.

  ``devices`` defaults to every CUDA device and raises when there is none;
  pass e.g. ``[torch.device("cpu")] * 8`` to run on the CPU. Without dp and
  mp the mesh is all data parallel, as in the JAX package. ``mp`` is kept
  for the JAX signature; until the row-sharded pipeline reads the ``model``
  axis, the batch drivers run on ``devices[:, 0]`` only.
  """
  if devices is None:
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
  return Mesh(arr.reshape(dp, mp))
