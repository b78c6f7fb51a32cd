"""1-D Gaussian Mixture fitting + BIC, for the single-cluster test.

Port of ``spectralcluster_tpu/ops/gmm.py``, which replaces
sklearn.mixture.GaussianMixture as used at reference
fallback_clusterer.py:158-178: fit 1- and 2-component GMMs on the scalar
upper-triangular affinity values and compare BICs. A tiny float32 EM on the
values' device, with the JAX module's deterministic init (k-means on the
scalars from evenly spaced quantiles); ``lax.scan`` with a frozen-on-
convergence carry becomes a loop that stops there. BIC follows sklearn:
-2·LL + p·ln(n) with p = 3k - 1 parameters for a k-component 1-D mixture.
"""

from __future__ import annotations

import math
import typing

import torch

from spectralcluster_tpu_torch.ops import quantile as quantile_ops

_REG_COVAR = 1e-6
_LOG2PI = 1.8378770664093453


def fit_gmm_1d(values: torch.Tensor,
               n_components: int = 2,
               max_iter: int = 100,
               tol: float = 1e-3) -> typing.Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor, torch.Tensor]:
  """EM fit of a k-component 1-D GMM.

  Returns (weights, means, variances, mean_log_likelihood).
  """
  x = torch.as_tensor(values).reshape(-1).to(torch.float32)
  n = x.shape[0]
  k = n_components
  comps = torch.arange(k, device=x.device)

  def onehot_of(centers):
    assign = torch.argmin(torch.abs(x[:, None] - centers[None, :]), dim=1)
    return (assign[:, None] == comps[None, :]).to(torch.float32)

  qs = (torch.arange(k, dtype=torch.float32, device=x.device) + 0.5) / k
  means = quantile_ops.quantile_from_sorted(torch.sort(x).values[None, :],
                                            qs)[:, 0]
  for _ in range(25):
    onehot = onehot_of(means)
    counts = torch.sum(onehot, dim=0)
    sums = torch.sum(onehot * x[:, None], dim=0)
    means = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0), means)
  onehot = onehot_of(means)
  counts = torch.sum(onehot, dim=0)
  d0 = x[:, None] - means[None, :]
  variances = torch.where(
      counts > 0,
      torch.sum(onehot * d0 * d0, dim=0) / torch.clamp_min(counts, 1.0),
      torch.var(x, correction=0)) + _REG_COVAR
  weights = torch.clamp_min(counts / n, 1e-6)
  weights = weights / torch.sum(weights)

  def log_prob(means, variances, weights):
    # (n, k) component log densities + log weights
    d = x[:, None] - means[None, :]
    lp = -0.5 * (_LOG2PI + torch.log(variances)[None, :]
                 + d * d / variances[None, :])
    return lp + torch.log(weights)[None, :]

  tiny = 10 * torch.finfo(torch.float32).tiny
  prev_ll = -math.inf
  for _ in range(max_iter):
    lp = log_prob(means, variances, weights)
    norm = torch.logsumexp(lp, dim=1, keepdim=True)
    ll = float(torch.mean(norm))
    resp = torch.exp(lp - norm)                          # (n, k)
    nk = torch.sum(resp, dim=0) + tiny
    means = torch.sum(resp * x[:, None], dim=0) / nk
    diff = x[:, None] - means[None, :]
    variances = torch.sum(resp * diff * diff, dim=0) / nk + _REG_COVAR
    weights = nk / n
    # The JAX scan applies the converging step's update, then freezes.
    if abs(ll - prev_ll) < tol:
      break
    prev_ll = ll
  lp = log_prob(means, variances, weights)
  mean_ll = torch.mean(torch.logsumexp(lp, dim=1))
  return weights, means, variances, mean_ll


def gmm_bic_1d(values, n_components: int) -> float:
  """BIC of a fitted k-component 1-D GMM (sklearn formula)."""
  x = torch.as_tensor(values).reshape(-1)
  n = x.shape[0]
  _, _, _, mean_ll = fit_gmm_1d(x, n_components=n_components)
  n_params = 3 * n_components - 1
  return float(-2.0 * mean_ll * n
               + n_params * torch.log(torch.tensor(n, dtype=torch.float32)))
