"""Auto-tuning of p_percentile (NME-SC): a hierarchical grid search.

A copy of ``spectralcluster_tpu/autotune.py`` (reference autotune.py), kept
in the port so that it never imports the JAX package. ``tune`` replicates
the reference loop exactly, including its memoization: a level with no
un-searched candidates keeps the previous level's winner, and the winner
index is taken within the full candidate range. ``tune_batched`` hands all
un-searched candidates of a level to one callback; the clusterer and the
batch driver (``parallel/batch.py``) evaluate them one after another on the
card, and the winner's eigenvectors come back as the callback gave them.

AutoTune keeps state: each level after the first halves ``search_step`` and
narrows the range, so build a fresh one (``configs.make_turntodiarize_
auto_tune``) for every independent search.
"""

from __future__ import annotations

import typing

import numpy as np

from spectralcluster_tpu_torch.types import AutoTuneProxy

MIN_SEARCH_STEP = 1e-04


class AutoTune:
  """Hierarchical p_percentile search (reference autotune.py:26-132)."""

  def __init__(self,
               p_percentile_min: float = 0.60,
               p_percentile_max: float = 0.95,
               init_search_step: float = 0.01,
               search_level: int = 1,
               proxy: AutoTuneProxy = AutoTuneProxy.PercentileSqrtOverNME):
    self.p_percentile_min = p_percentile_min
    self.p_percentile_max = p_percentile_max
    self.search_step = init_search_step
    self.search_level = search_level
    if not isinstance(proxy, AutoTuneProxy):
      raise TypeError("proxy must be an instance of AutoTuneProxy")
    self.proxy = proxy

  def get_percentile_range(self) -> typing.List[float]:
    """np.linspace grid (the effective step differs slightly from the
    nominal one, as in reference autotune.py:58-64)."""
    num_steps = int(
        np.ceil(
            (self.p_percentile_max - self.p_percentile_min) / self.search_step))
    return list(
        np.linspace(self.p_percentile_min, self.p_percentile_max, num_steps))

  def update_percentile_range(self, p_percentile_min: float,
                              p_percentile_max: float,
                              search_step: float) -> typing.List[float]:
    self.p_percentile_min = p_percentile_min
    self.p_percentile_max = p_percentile_max
    self.search_step = search_step
    return self.get_percentile_range()

  def ratio_from_proxy(self, p_percentile: float, max_delta_norm: float):
    """The proxy value minimized by the search (spectral_clusterer.py:281-
    287). Numpy division: a zero ``max_delta_norm`` gives inf."""
    if self.proxy == AutoTuneProxy.PercentileSqrtOverNME:
      return np.sqrt(1 - p_percentile) / max_delta_norm
    elif self.proxy == AutoTuneProxy.PercentileOverNME:
      return np.float64(1 - p_percentile) / max_delta_norm
    raise ValueError("Unsupported value of AutoTuneProxy")

  def tune_batched(self, batch_eval: typing.Callable):
    """Hierarchical search with one ``batch_eval`` call per level.

    Args:
      batch_eval: callable taking a float array of candidate p_percentiles
        and returning (ratios (B,), eigenvectors (B, N, K), n_clusters (B,)).

    Returns:
      (eigenvectors, n_clusters, best_p_percentile), with the semantics of
      reference AutoTune.tune; eigenvectors is the callback's own row
      (a numpy array or a tensor).
    """
    p_range = self.get_percentile_range()
    searched: typing.Dict[float, float] = {}
    eigenvectors = None
    n_clusters = None
    best_p = None
    best_index = None
    for _ in range(self.search_level):
      new = [(i, p) for i, p in enumerate(p_range) if p not in searched]
      if new:
        ps = np.array([p for _, p in new], dtype=np.float64)
        ratios, eigvecs_b, ncs_b = batch_eval(ps)
        ratios = np.asarray(ratios)
        for p, r in zip(ps, ratios):
          searched[float(p)] = float(r)
        w = int(np.argmin(ratios))
        eigenvectors = eigvecs_b[w]
        n_clusters = int(ncs_b[w])
        best_p = float(ps[w])
        best_index = new[w][0]
      if (not p_range or len(p_range) == 1
          or self.search_step < MIN_SEARCH_STEP):
        break
      local = max(2, len(p_range) // 8)
      start = max(0, best_index - local)
      end = min(len(p_range) - 1, best_index + local)
      self.search_step = self.search_step / 2
      p_range = self.update_percentile_range(p_range[start], p_range[end],
                                             self.search_step)
    if eigenvectors is None:
      raise ValueError("AutoTune search range is empty; check "
                       "p_percentile_min/max/init_search_step.")
    return eigenvectors, n_clusters, best_p

  def tune(self, p_percentile_to_ratio: typing.Callable):
    """Sequential-callback API, for parity with reference autotune.py:76-132.

    The callback maps p_percentile -> (ratio, eigenvectors, n_clusters).
    """

    def batch_eval(ps):
      ratios, eigvecs, ncs = [], [], []
      for p in ps:
        r, v, n = p_percentile_to_ratio(float(p))
        ratios.append(r)
        eigvecs.append(v)
        ncs.append(n)
      return np.array(ratios), eigvecs, np.array(ncs)

    return self.tune_batched(batch_eval)
