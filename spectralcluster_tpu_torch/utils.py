"""Utility functions: device choice, affinity/eigen helpers, label utilities.

Port of ``spectralcluster_tpu/utils.py``, which mirrors the reference's
``utils`` module (numpy in, numpy out). The numerical helpers run on
``device`` (default the card; pass "cpu" explicitly); the label utilities
are host numpy. The JAX module's ``*_jnp`` variants have no caller in the
port yet and are not ported.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from spectralcluster_tpu_torch.types import EPS, EigenGapType


# Geometric bucket growth factor above 512 (snapped up to multiples of 256).
_BUCKET_GROWTH = 1.25


def pad_bucket(n: int) -> int:
  """Round a problem size up to the JAX package's shape bucket.

  Powers of two up to 512, then a geometric ladder (×1.25, snapped up to
  multiples of 256). A bucket maps to itself. The port does not pad, but
  routes by the bucket so that it picks the same solver route (and returns
  eigenvalues of the same shape) as the JAX package for the same N, and
  draws its k-means++ samples over the bucket's rows, as JAX does.
  """
  if n <= 8:
    return 8
  if n <= 512:
    return 1 << (n - 1).bit_length()
  b = 512
  while b < n:
    b = -(-int(b * _BUCKET_GROWTH) // 256) * 256
  return b


def valid_mask(n: int, n_valid, device) -> torch.Tensor:
  """``arange(n) < n_valid``: (n,) for an int or 0-dim n_valid, (B, n) for
  a (B,) tensor, one count per matrix of a batch."""
  if isinstance(n_valid, torch.Tensor) and n_valid.dim() > 0:
    n_valid = n_valid[..., None]
  return torch.arange(n, device=device) < n_valid


def per_matrix(value, ndim: int):
  """A per-matrix value of a batch, (B,), shaped (B, 1, ...) to broadcast
  against (B, ...) tensors of ``ndim`` dims; a scalar or 0-dim value as
  is."""
  if isinstance(value, torch.Tensor) and value.dim() > 0:
    return value.reshape(value.shape + (1,) * (ndim - 1))
  return value


def resolve_device(device) -> torch.device:
  """The torch device to run on; a CUDA device must exist."""
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                       "run on the CPU")
  return dev


def compute_affinity_matrix(embeddings: np.ndarray,
                            device="cuda") -> np.ndarray:
  """Cosine affinity in [0,1] (reference utils.py:20-41) on ``device``
  (the affinity kernel on the card)."""
  from spectralcluster_tpu_torch.kernels import fused as fused_kernels
  x = torch.as_tensor(np.asarray(embeddings, np.float32)).to(
      resolve_device(device))
  return fused_kernels.affinity(x).cpu().numpy()


def compute_sorted_eigenvectors(
    input_matrix: np.ndarray,
    descend: bool = True,
    device="cuda") -> typing.Tuple[np.ndarray, np.ndarray]:
  """Sorted eigendecomposition (reference utils.py:44-71).

  Symmetric inputs use float32 eigh on ``device``; asymmetric ones LAPACK's
  general eig on the host, as in the JAX package.
  """
  from spectralcluster_tpu_torch.ops import eigen as eigen_ops
  m = np.asarray(input_matrix, dtype=np.float64)
  if np.allclose(m, m.T, atol=1e-12):
    w, v = eigen_ops.sorted_eigh(
        torch.as_tensor(m.astype(np.float32)).to(resolve_device(device)),
        descend=descend)
    return w.cpu().numpy(), v.cpu().numpy()
  w, v = np.linalg.eig(m)
  w, v = w.real, v.real
  order = np.argsort(-w if descend else w)
  return w[order], v[:, order]


def compute_number_of_clusters(
    eigenvalues: np.ndarray,
    max_clusters: typing.Optional[int] = None,
    stop_eigenvalue: float = 1e-2,
    eigengap_type: EigenGapType = EigenGapType.Ratio,
    descend: bool = True,
    eps: float = EPS) -> typing.Tuple[int, float]:
  """Eigengap cluster-count selection (reference utils.py:74-130), on the
  host: the scan reads max_clusters+1 values."""
  from spectralcluster_tpu_torch.ops import eigen as eigen_ops
  n, gap = eigen_ops.compute_number_of_clusters(
      torch.as_tensor(np.asarray(eigenvalues, np.float32)),
      max_clusters=max_clusters,
      stop_eigenvalue=stop_eigenvalue, eigengap_type=eigengap_type,
      descend=descend, eps=eps)
  return int(n), float(gap)


def enforce_ordered_labels(labels: np.ndarray) -> np.ndarray:
  """First-appearance relabeling -> permutation-invariant label sequences.

  Reference utils.py:133-156.
  """
  labels = np.asarray(labels)
  new_labels = labels.copy()
  label_map = {}
  for element in labels.tolist():
    if element not in label_map:
      label_map[element] = len(label_map)
  for key, val in label_map.items():
    new_labels[labels == key] = val
  return new_labels


def get_cluster_centroids(embeddings: np.ndarray,
                          labels: np.ndarray) -> np.ndarray:
  """Per-label mean embeddings. Reference utils.py:159-177."""
  embeddings = np.asarray(embeddings)
  labels = np.asarray(labels)
  n_clusters = int(labels.max()) + 1
  centroids = [
      embeddings[labels == i, :].mean(axis=0) for i in range(n_clusters)
  ]
  return np.stack(centroids)


def chain_labels(pre_labels: typing.Optional[np.ndarray],
                 main_labels: np.ndarray) -> np.ndarray:
  """Compose pre-clusterer labels with main-clusterer labels.

  Reference utils.py:180-206 (including the shape-mismatch ValueError).
  """
  if pre_labels is None:
    return main_labels
  pre_labels = np.asarray(pre_labels)
  main_labels = np.asarray(main_labels)
  u1 = int(pre_labels.max()) + 1
  if u1 != main_labels.shape[0]:
    raise ValueError(
        "pre_labels has {} values while main_labels has {} rows.".format(
            u1, main_labels.shape[0]))
  return main_labels[pre_labels.astype(np.int64)].astype(np.float64)
