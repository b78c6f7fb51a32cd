"""Carry a configuration of the JAX package across to the port.

The system has no learned weights: what carries across is configuration —
enum values, ``RefinementOptions``, ``ConstraintOptions``,
``FallbackOptions``, ``PipelineConfig`` and a whole ``SpectralClusterer``
(``clusterer_from``). Objects are read by attribute
and enums by ``.name``, and matched to the port's classes by class name, so
nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
import typing

from spectralcluster_tpu_torch import clusterer as clusterer_lib
from spectralcluster_tpu_torch import pipeline as pipeline_lib
from spectralcluster_tpu_torch import types

# Options dataclasses that exist under the same name in both packages.
_OPTION_CLASSES = ("RefinementOptions", "ConstraintOptions",
                   "FallbackOptions")
# PipelineConfig fields renamed in the port: JAX name -> port name.
_RENAMED = {"use_pallas": "use_kernels"}


def convert_value(value: typing.Any) -> typing.Any:
  """One value: enums by class name and member name, option dataclasses
  field by field, tuples element by element; anything else as is."""
  if isinstance(value, enum.Enum):
    return getattr(types, type(value).__name__)[value.name]
  if isinstance(value, tuple):
    return tuple(convert_value(v) for v in value)
  if (dataclasses.is_dataclass(value)
      and type(value).__name__ in _OPTION_CLASSES):
    cls = getattr(types, type(value).__name__)
    return cls(**{f.name: convert_value(getattr(value, f.name))
                  for f in dataclasses.fields(cls)})
  return value


def pipeline_config_from(cfg: typing.Any) -> pipeline_lib.PipelineConfig:
  """The port's PipelineConfig for a JAX ``PipelineConfig``, field by field.

  An in-graph ``autotune`` spec is refused: its port is ROADMAP queue 1
  item 8.
  """
  if getattr(cfg, "autotune", None) is not None:
    raise NotImplementedError("autotune is not ported yet (ROADMAP queue 1 "
                              "item 8)")
  port_names = {f.name for f in dataclasses.fields(pipeline_lib.PipelineConfig)}
  kwargs = {}
  for f in dataclasses.fields(cfg):
    name = _RENAMED.get(f.name, f.name)
    if name not in port_names:
      raise ValueError(f"PipelineConfig field {f.name!r} has no counterpart "
                       "in the port")
    kwargs[name] = convert_value(getattr(cfg, f.name))
  return pipeline_lib.PipelineConfig(**kwargs)


def clusterer_from(clusterer: typing.Any,
                   device="cuda") -> clusterer_lib.SpectralClusterer:
  """The port's SpectralClusterer with every constructor knob of a JAX
  ``SpectralClusterer`` (options converted, callables as they are), on
  ``device``. A set ``autotune`` carries across as it is and is refused at
  predict (ROADMAP queue 1 item 8)."""
  knobs = [name for name in inspect.signature(
      clusterer_lib.SpectralClusterer).parameters if name != "device"]
  return clusterer_lib.SpectralClusterer(
      device=device,
      **{name: convert_value(getattr(clusterer, name)) for name in knobs})
