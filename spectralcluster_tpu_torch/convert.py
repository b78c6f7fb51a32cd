"""Carry a configuration of the JAX package across to the port.

The system has no learned weights: what carries across is configuration —
enum values, ``RefinementOptions``, ``ConstraintOptions``,
``FallbackOptions``, ``AutoTuneStatic``, an ``AutoTune`` (its search
state as it stands), ``PipelineConfig``, a whole ``SpectralClusterer``
(``clusterer_from``) and a ``MultiStageClusterer`` with its streaming state
(``multi_stage_from``). Objects are read by attribute and enums by
``.name``, and matched to the port's classes by class name, so nothing
here imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
import typing

import numpy as np

from spectralcluster_tpu_torch import autotune
from spectralcluster_tpu_torch import clusterer as clusterer_lib
from spectralcluster_tpu_torch import pipeline as pipeline_lib
from spectralcluster_tpu_torch import streaming
from spectralcluster_tpu_torch import types

# Options dataclasses that exist under the same name in both packages.
_OPTION_CLASSES = {
    "RefinementOptions": types.RefinementOptions,
    "ConstraintOptions": types.ConstraintOptions,
    "FallbackOptions": types.FallbackOptions,
    "AutoTuneStatic": pipeline_lib.AutoTuneStatic,
}
# PipelineConfig fields renamed in the port: JAX name -> port name.
_RENAMED = {"use_pallas": "use_kernels"}


def convert_value(value: typing.Any) -> typing.Any:
  """One value: enums by class name and member name, option dataclasses
  field by field, an ``AutoTune`` by its five attributes, tuples element by
  element; anything else as is."""
  if isinstance(value, enum.Enum):
    return getattr(types, type(value).__name__)[value.name]
  if isinstance(value, tuple):
    return tuple(convert_value(v) for v in value)
  name = type(value).__name__
  if dataclasses.is_dataclass(value) and name in _OPTION_CLASSES:
    cls = _OPTION_CLASSES[name]
    return cls(**{f.name: convert_value(getattr(value, f.name))
                  for f in dataclasses.fields(cls)})
  if name == "AutoTune":
    return autotune.AutoTune(
        p_percentile_min=value.p_percentile_min,
        p_percentile_max=value.p_percentile_max,
        init_search_step=value.search_step,
        search_level=value.search_level,
        proxy=convert_value(value.proxy))
  return value


def pipeline_config_from(cfg: typing.Any) -> pipeline_lib.PipelineConfig:
  """The port's PipelineConfig for a JAX ``PipelineConfig``, field by
  field."""
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
  ``SpectralClusterer`` (options converted, an ``AutoTune`` rebuilt,
  callables as they are), on ``device``."""
  knobs = [name for name in inspect.signature(
      clusterer_lib.SpectralClusterer).parameters if name != "device"]
  return clusterer_lib.SpectralClusterer(
      device=device,
      **{name: convert_value(getattr(clusterer, name)) for name in knobs})


def multi_stage_from(multi_stage: typing.Any,
                     device="cuda") -> streaming.MultiStageClusterer:
  """The port's MultiStageClusterer for a JAX one: its main clusterer
  through ``clusterer_from`` (L and the fallback threshold live in that
  clusterer's fallback options), U1, U2, the deflicker and a copy of its
  streaming state as it stands."""
  fallback = multi_stage.main.fallback_options
  out = streaming.MultiStageClusterer(
      clusterer_from(multi_stage.main, device=device),
      fallback_threshold=fallback.agglomerative_threshold,
      L=fallback.spectral_min_embeddings, U1=multi_stage.U1,
      U2=multi_stage.U2, deflicker=convert_value(multi_stage.deflicker))
  out.state = streaming.MultiStageState.from_dict({
      k: np.array(v) if isinstance(v, np.ndarray) else v
      for k, v in multi_stage.state.to_dict().items()})
  return out
