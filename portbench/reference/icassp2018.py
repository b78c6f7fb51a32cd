"""Plain reference of the ICASSP 2018 configuration.

wq2012/SpectralCluster ``configs.icassp2018_clusterer``: cosine affinity;
CropDiagonal, GaussianBlur (sigma 1), RowWiseThreshold (row max, p 0.95,
soft multiplier 0.01), Symmetrize (max), Diffuse, RowWiseNormalize; no
Laplacian; the ratio eigengap on the descending eigenvalues with stop
eigenvalue 1e-2 and 2 to 7 clusters; K-Means with cosine distance on the
first n_clusters eigenvectors.

RowWiseNormalize makes A = D⁻¹ S with S = Diffuse(...) symmetric, so A's
eigenvalues are those of the symmetric D^{-1/2} S D^{-1/2} and its unit
eigenvectors D^{-1/2} u, renormalized. Eigenvalues are compared over the
max_clusters + 1 largest, which is what the program returns at every size.
"""

from __future__ import annotations

import torch

from portbench.reference import common


def solve(rec, config: dict, precision: str = "float64",
          device: str = "cpu") -> dict:
  """Cluster one recording (``rec.embeddings``). Returns n_clusters,
  labels, the admissible counts (``common.admissible_counts`` with the
  configuration's ``count_band``), the spectral embedding of all
  max_clusters + 1 columns, eigenvalues (the max_clusters + 1 largest,
  descending) and the solver's residual."""
  opts = config["options"]
  dtype = common.dtype_of(precision)
  t = opts["max_clusters"] + 1
  with torch.no_grad(), common.matmul_precision(precision):
    x = torch.as_tensor(rec.embeddings).to(device, dtype)
    a = common.cosine_affinity(x, precision)
    a = common.crop_diagonal(a)
    a = common.gaussian_blur(a, opts["gaussian_blur_sigma"])
    a = common.row_wise_threshold_rowmax(a, opts["p_percentile"],
                                         opts["soft_multiplier"])
    a = torch.maximum(a, a.T)
    s = common.mm(a, a.T, precision)
    del a
    s = 0.5 * (s + s.T)
    inv_sqrt = 1.0 / torch.sqrt(s.amax(dim=1))
    s.mul_(inv_sqrt[:, None]).mul_(inv_sqrt[None, :])
    tol = 1e-10 if precision == "float64" else 1e-5
    w, u, res = common.symmetric_top_eig(s, t, tol=tol)
    del s
    wmax = float(torch.abs(w).amax())
    w_np = w.double().cpu().numpy()
    n = max(int(common.eigengap_descend(w_np, opts["max_clusters"],
                                        opts["stop_eigenvalue"], wmax)),
            opts["min_clusters"])
    counts = common.admissible_counts(w_np, opts["max_clusters"],
                                      opts["min_clusters"],
                                      opts["stop_eigenvalue"],
                                      config["count_band"])
    v = inv_sqrt[:, None] * u
    v = v / torch.linalg.norm(v, dim=0, keepdim=True)
    labels = common.kmeans_cosine(v[:, :n], n)
  return {"n_clusters": n, "labels": labels, "counts": counts,
          "embedding": v.double().cpu().numpy(),
          "eigenvalues": w_np, "residual": res}
