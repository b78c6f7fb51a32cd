"""ctypes bindings for the C++ nearest-neighbor-chain AHC (``ahc.cc``).

The port's counterpart of ``spectralcluster_tpu/native/ahc_native.py``.
``ahc.cc`` is compiled with g++ at first use into the port's build
directory (``kernels/build.build_dir()``, git-ignored), named by a hash of
the source and the flags, and loaded from there; the JAX package's library
and Makefile are never touched. Without a compiler ``available()`` is
False and ``ahc.py`` runs its numpy chain.

The flags keep ISO C++17 and leave out ``-march=native``: the build
directory may be copied to another host, whose CPU must run the library
too, and under ISO C++ g++ does not contract a*b+c into an FMA, so the
merge heights are the numpy chain's bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import typing

import numpy as np

from spectralcluster_tpu_torch.kernels import build as build_lib

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ahc.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_LINKAGE_CODES = {"complete": 0, "average": 1, "single": 2}

_LOCK = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
  h = hashlib.sha256()
  with open(SOURCE, "rb") as f:
    h.update(f.read())
  h.update(" ".join(CXX_FLAGS).encode())
  return os.path.join(build_lib.build_dir(),
                      f"libsct_ahc_{h.hexdigest()[:16]}.so")


def build() -> str:
  """Compile ``ahc.cc`` if this source hash has no library yet; returns the
  library's path. Raises RuntimeError when there is no g++ or it fails."""
  path = library_path()
  if os.path.exists(path):
    return path
  cxx = os.environ.get("CXX") or shutil.which("g++")
  if not cxx:
    raise RuntimeError("g++ not found: set CXX or put g++ on PATH")
  os.makedirs(build_lib.build_dir(), exist_ok=True)
  tmp = f"{path}.{os.getpid()}.tmp"
  proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                        capture_output=True, text=True, timeout=120,
                        check=False)
  if proc.returncode != 0:
    raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
  os.replace(tmp, path)
  return path


def _load():
  global _lib, _tried
  with _LOCK:
    if _lib is not None or _tried:
      return _lib
    _tried = True
    try:
      lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError):
      return None
    lib.sct_nn_chain_linkage.restype = ctypes.c_int
    lib.sct_nn_chain_linkage.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double)
    ]
    lib.sct_ahc_labels.restype = ctypes.c_int
    lib.sct_ahc_labels.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64)
    ]
    _lib = lib
    return _lib


def available() -> bool:
  """Whether the library is built and loaded (the first call may build it)."""
  return _load() is not None


def _as_c(dist: np.ndarray):
  """A C-contiguous float64 copy of a square matrix (the library reads
  n*n values) and its pointer; the caller keeps the copy alive."""
  d = np.ascontiguousarray(dist, dtype=np.float64)
  if d.ndim != 2 or d.shape[0] != d.shape[1]:
    raise ValueError(f"expected a square distance matrix, got {d.shape}")
  return d, d.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def nn_chain_linkage(dist: np.ndarray, linkage: str) -> np.ndarray:
  lib = _load()
  n = dist.shape[0]
  d, dptr = _as_c(dist)
  merges = np.empty((n - 1, 3), dtype=np.float64)
  rc = lib.sct_nn_chain_linkage(
      dptr, n, _LINKAGE_CODES[linkage],
      merges.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
  if rc != 0:
    raise RuntimeError(f"sct_nn_chain_linkage failed with code {rc}")
  return merges


def ahc_labels(dist: np.ndarray, linkage: str,
               n_clusters: typing.Optional[int],
               distance_threshold: typing.Optional[float]) -> np.ndarray:
  lib = _load()
  n = dist.shape[0]
  d, dptr = _as_c(dist)
  labels = np.empty(n, dtype=np.int64)
  rc = lib.sct_ahc_labels(
      dptr, n, _LINKAGE_CODES[linkage],
      n_clusters if n_clusters is not None else -1,
      distance_threshold if distance_threshold is not None else 0.0,
      1 if distance_threshold is not None else 0,
      labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
  if rc != 0:
    raise RuntimeError(f"sct_ahc_labels failed with code {rc}")
  return labels
