"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

``csrc/fused.cu`` has a plain C interface, so it compiles in seconds into
one shared library without PyTorch's headers. The library goes into
``build/spectralcluster_tpu_torch/`` beside the package (or into
``$SCT_TORCH_BUILD_DIR``), named by a hash of the sources and the flags, at
first use. Nothing here runs when the module is imported: the CPU tests
import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import typing

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG_DIR, "csrc", "fused.cu"),)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: typing.Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# Every pointer and the stream are c_void_p: an undeclared argument would be
# passed as a 32-bit int and cut the pointer.
_SIGNATURES = {
    "sct_affinity": (_P, _P, _I, _I, _I, _P),
    "sct_affinity_batched": (_P, _P, _I, _I, _I, _P),
    "sct_row_max": (_P, _P, _I, _I, _I, _I, _P),
    "sct_row_max_batched": (_P, _P, _I, _I, _P, _I, _I, _P),
    "sct_crop_diagonal": (_P, _P, _I, _I, _I, _P),
    "sct_crop_diagonal_batched": (_P, _P, _I, _I, _P, _I, _P),
    "sct_threshold_symmetrize": (_P, _P, _P, _I, _F, _I, _I, _I, _P),
    "sct_threshold_symmetrize_batched": (_P, _P, _P, _I, _I, _F, _I, _I, _I,
                                         _P),
    "sct_row_wise_normalize": (_P, _P, _I, _I, _I, _P),
    "sct_row_wise_normalize_batched": (_P, _P, _I, _I, _P, _I, _P),
    "sct_panel_matmul": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _L, _L, _L,
                         _P),
    "sct_panel_matmul_splits": (_I, _I, _I),
    "sct_cholqr_pass": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _F, _P),
    "sct_resident_blocks": (_I, _P),
    "sct_affinity_batched_schedule": (_I, _I, _P, _P, _P),
}


def build_dir() -> str:
  default = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "spectralcluster_tpu_torch")
  return os.environ.get("SCT_TORCH_BUILD_DIR", default)


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
  if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
    return os.path.join(cuda_home, "bin", "nvcc")
  found = shutil.which("nvcc")
  if found:
    return found
  default = "/usr/local/cuda/bin/nvcc"
  if os.path.exists(default):
    return default
  raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(sources: typing.Sequence[str] = SOURCES) -> str:
  h = hashlib.sha256()
  for src in sources:
    with open(src, "rb") as f:
      h.update(f.read())
  h.update(" ".join(NVCC_FLAGS).encode())
  return os.path.join(build_dir(), f"libsct_fused_{h.hexdigest()[:16]}.so")


def build(sources: typing.Sequence[str] = SOURCES) -> str:
  """Compile the kernels if this source hash has no library yet.

  Returns the library's path. nvcc's resource report (-Xptxas -v) is kept
  beside it as ``<library>.log``. Other ``sources`` (another version of
  ``fused.cu``, for a comparison) build with the same flags into their own
  library.
  """
  path = library_path(sources)
  if os.path.exists(path):
    return path
  os.makedirs(build_dir(), exist_ok=True)
  tmp = f"{path}.{os.getpid()}.tmp"
  cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  with open(path + ".log", "w") as f:
    f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
  os.replace(tmp, path)
  return path


def ptxas_report(lib_path: str) -> typing.Dict[str, typing.Dict[str, int]]:
  """Registers, static shared memory and spill bytes per kernel.

  Read from the ``-Xptxas -v`` lines that ``build`` keeps in
  ``<library>.log``; kernels are keyed by their unmangled names, bool
  template arguments included (``row_max_kernel<true,false>``).
  """
  report: typing.Dict[str, typing.Dict[str, int]] = {}
  current = None
  with open(lib_path + ".log") as f:
    for line in f:
      entry = re.search(r"(?:entry function '|properties for )(\S+?)'?$",
                        line.strip())
      if entry:
        # e.g. ..._14row_max_kernelILb1ELb0EEEv... ->
        # row_max_kernel<true,false>
        name = re.search(r"\d+([a-z_]+_kernel)(?:I((?:Lb[01]E)+)E)?E",
                         entry.group(1))
        key = entry.group(1)
        if name:
          flags = re.findall(r"Lb([01])E", name.group(2) or "")
          key = name.group(1) + (
              "<" + ",".join("true" if f == "1" else "false" for f in flags)
              + ">" if flags else "")
        current = report.setdefault(key, {})
        continue
      if current is None:
        continue
      spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
      if spill:
        current["spill_stores"] = int(spill.group(1))
        current["spill_loads"] = int(spill.group(2))
      used = re.search(r"Used (\d+) registers", line)
      if used:
        current["registers"] = int(used.group(1))
        smem = re.search(r"(\d+) bytes smem", line)
        current["static_smem"] = int(smem.group(1)) if smem else 0
  return report


def load() -> ctypes.CDLL:
  """Build (at first use) and load the kernel library, once per process."""
  global _LIB
  with _LOCK:
    if _LIB is None:
      lib = ctypes.CDLL(build())
      for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
      lib.sct_error_string.argtypes = [ctypes.c_int]
      lib.sct_error_string.restype = ctypes.c_char_p
      _LIB = lib
    return _LIB
