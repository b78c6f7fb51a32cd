"""Plain numerics shared by the configurations' references.

Written from the semantics of the published library (wq2012/SpectralCluster:
utils.py, refinement.py), in plain
PyTorch, for any floating type and device. Nothing here imports the program
under test.

``precision`` is "float64" (the reference) or "tf32" (the control: float32
with every matrix product in TF32; on the CPU the products' inputs are
rounded to TF32's 10-bit mantissa, as the card's tensor cores take them).
"""

from __future__ import annotations

import contextlib
import itertools
import math

import numpy as np
import torch

EPS = 1e-10


def dtype_of(precision: str) -> torch.dtype:
  return torch.float64 if precision == "float64" else torch.float32


@contextlib.contextmanager
def matmul_precision(precision: str):
  """TF32 on for the card's products when ``precision`` is "tf32", off
  otherwise."""
  if not torch.cuda.is_available():
    yield
    return
  before = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = before


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
  """float32 rounded to nearest at TF32's 10 explicit mantissa bits."""
  bits = x.contiguous().view(torch.int32)
  bits = (bits + 0x1000) & ~0x1FFF
  return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
  if precision == "tf32" and a.device.type == "cpu":
    return torch.matmul(_round_tf32(a), _round_tf32(b))
  return torch.matmul(a, b)


def cosine_affinity(x: torch.Tensor, precision: str) -> torch.Tensor:
  """((x·y)/(|x||y|) + 1) / 2 (utils.compute_affinity_matrix)."""
  xn = x / torch.linalg.norm(x, dim=1, keepdim=True)
  return (mm(xn, xn.T, precision) + 1.0) / 2.0


def crop_diagonal(a: torch.Tensor) -> torch.Tensor:
  """Each diagonal entry becomes its row's largest off-diagonal entry,
  the diagonal counted as 0."""
  n = a.shape[0]
  idx = torch.arange(n, device=a.device)
  off = a.clone()
  off[idx, idx] = 0.0
  out = a.clone()
  out[idx, idx] = off.amax(dim=1)
  return out


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
  i = torch.arange(-r, n + r, device=device)
  m = torch.remainder(i, 2 * n)
  return torch.where(m >= n, 2 * n - 1 - m, m)


def gaussian_blur(a: torch.Tensor, sigma: float,
                  truncate: float = 4.0) -> torch.Tensor:
  """scipy.ndimage.gaussian_filter with its defaults: mode "reflect"
  (d c b a | a b c d), radius int(truncate·sigma + 0.5)."""
  r = int(truncate * sigma + 0.5)
  x = np.arange(-r, r + 1, dtype=np.float64)
  w = np.exp(-0.5 * (x / sigma) ** 2)
  w = (w / w.sum()).tolist()
  n = a.shape[0]
  idx = _reflect_index(n, r, a.device)
  padded = a.index_select(0, idx)
  rows = sum(wk * padded[k:k + n] for k, wk in enumerate(w))
  padded = rows.index_select(1, idx)
  return sum(wk * padded[:, k:k + n] for k, wk in enumerate(w))


def row_wise_threshold_rowmax(a: torch.Tensor, p: float,
                              multiplier: float) -> torch.Tensor:
  """Entries under p · (row max) are multiplied by ``multiplier``."""
  thr = a.amax(dim=1, keepdim=True) * p
  return torch.where(a < thr, a * multiplier, a)


def symmetric_top_eig(m: torch.Tensor, t: int, tol: float,
                      dense_max: int = 4096):
  """The t largest eigenpairs of the symmetric ``m``: ``eigh`` up to
  ``dense_max``, past it Rayleigh–Ritz on a Krylov basis (Lanczos with full
  reorthogonalization) grown until every pair's residual is under
  ``tol`` times the spectral radius. Returns (w (t,), u (n, t), worst
  relative residual), in descending order."""
  n = m.shape[0]
  if n <= dense_max:
    w, u = torch.linalg.eigh(m)
    w, u = w.flip(0), u.flip(1)
    return w[:t], u[:, :t], 0.0
  g = torch.Generator(device="cpu").manual_seed(7)
  q = torch.randn(n, generator=g, dtype=torch.float64).to(m.device, m.dtype)
  q = q / torch.linalg.norm(q)
  basis, images = [], []
  steps, worst = 0, math.inf
  for cap in (160, 320, 640, 1280):
    while steps < cap:
      basis.append(q)
      z = m @ q
      images.append(z)
      qs = torch.stack(basis, 1)
      for _ in range(2):
        z = z - qs @ (qs.T @ z)
      q = z / torch.linalg.norm(z)
      steps += 1
    qs, zs = torch.stack(basis, 1), torch.stack(images, 1)
    h = qs.T @ zs
    theta, s = torch.linalg.eigh(0.5 * (h + h.T))
    order = torch.argsort(theta, descending=True)[:t]
    theta, s = theta[order], s[:, order]
    u = qs @ s
    res = torch.linalg.norm(zs @ s - u * theta, dim=0)
    radius = torch.abs(theta).amax()
    worst = float((res / radius).amax())
    if worst <= tol:
      break
  return theta, u, worst


def eigengap_descend(w: np.ndarray, max_clusters: int, stop: float,
                     wmax: float, snap: float = 1e-5) -> np.ndarray:
  """Snap |w| < snap·wmax to 0, then the ratio eigengap scan of
  utils.compute_number_of_clusters on descending eigenvalues: the count
  for each row of ``w`` (..., t)."""
  w = np.asarray(w, np.float64)
  w = np.where(np.abs(w) < snap * wmax, 0.0, w)
  range_end = min(w.shape[-1], max_clusters + 1)
  best = np.zeros(w.shape[:-1])
  n = np.zeros(w.shape[:-1], np.int64)
  scanning = np.ones(w.shape[:-1], bool)
  for i in range(1, range_end):
    scanning &= w[..., i - 1] >= stop
    delta = w[..., i - 1] / (w[..., i] + EPS)
    better = scanning & (delta > best)
    best = np.where(better, delta, best)
    n = np.where(better, i, n)
  return n


def admissible_counts(w: np.ndarray, max_clusters: int, min_clusters: int,
                      stop: float, band: float) -> list:
  """The counts the eigengap rule gives on every corner of the box of
  eigenvalues within ``band``·max|w| of ``w``: the counts that a program
  whose eigenvalues round by up to that much may soundly return, where a
  snapped, stopped or tied eigenvalue lies that close to its threshold."""
  w = np.asarray(w, np.float64)
  wmax = float(np.abs(w).max())
  corners = np.array(list(itertools.product((-1.0, 0.0, 1.0),
                                            repeat=w.shape[0])))
  counts = eigengap_descend(w + corners * band * wmax, max_clusters, stop,
                            wmax)
  return sorted({max(int(c), min_clusters) for c in counts})


def kmeans_cosine(x: torch.Tensor, k: int, seed: int = 0, restarts: int = 4,
                  max_iter: int = 300):
  """K-Means with cosine distance and mean centroids, k-means++ starts,
  the restart with the least total distance kept. Returns (n,) labels."""
  rng = np.random.default_rng(seed)
  n = x.shape[0]
  xn = x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True), EPS)
  best, best_cost = None, math.inf
  for _ in range(restarts):
    first = int(rng.integers(n))
    centres = [x[first]]
    d2 = torch.sum((x - x[first]) ** 2, dim=1)
    for _ in range(1, k):
      p = d2.double().cpu().numpy()
      p = p / p.sum() if p.sum() > 0 else np.full(n, 1.0 / n)
      nxt = int(rng.choice(n, p=p))
      centres.append(x[nxt])
      d2 = torch.minimum(d2, torch.sum((x - x[nxt]) ** 2, dim=1))
    c = torch.stack(centres)
    labels = None
    for _ in range(max_iter):
      cn = c / torch.clamp_min(torch.linalg.norm(c, dim=1, keepdim=True), EPS)
      dist = 1.0 - xn @ cn.T
      new = torch.argmin(dist, dim=1)
      if labels is not None and torch.equal(new, labels):
        break
      labels = new
      for j in range(k):
        members = labels == j
        if bool(members.any()):
          c[j] = x[members].mean(dim=0)
    cost = float(dist.gather(1, labels[:, None]).sum())
    if cost < best_cost:
      best, best_cost = labels, cost
  return best.cpu().numpy()


def label_errors(embedding: np.ndarray, labels: np.ndarray,
                 margin: float) -> int:
  """Segments whose label is not their nearest cluster mean, by cosine
  distance in ``embedding`` (the rows K-Means clusters), by ``margin`` or
  more: zero for any converged K-Means partition of these rows, whatever
  its start, up to rounding near a boundary."""
  x = np.asarray(embedding, np.float64)
  _, lab = np.unique(np.asarray(labels).ravel(), return_inverse=True)
  lab = lab.ravel()
  k = int(lab.max()) + 1
  means = np.stack([x[lab == j].mean(axis=0) for j in range(k)])
  xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), EPS)
  mn = means / np.maximum(np.linalg.norm(means, axis=1, keepdims=True), EPS)
  dist = 1.0 - xn @ mn.T
  own = dist[np.arange(x.shape[0]), lab]
  return int(np.sum(own - dist.min(axis=1) >= margin))
