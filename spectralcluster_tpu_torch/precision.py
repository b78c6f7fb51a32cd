"""Full-float32 matmul precision for every entry point of the port.

Spectral clustering is not tolerant of reduced-precision products: the
affinity loses digits, Diffuse (A Aᵀ) compounds the loss, and the eigengap
scan then reads noise. The JAX package measured label parity breaking at
N=10240 under 3-pass bf16 products. TF32 keeps fewer mantissa bits than
that, so on the card every float32 matmul and convolution must run in IEEE
float32 on the CUDA cores, never on TF32 tensor cores.

``fp32_precision()`` pins that for the duration of a call and restores the
caller's settings afterwards; the pipeline and the clusterer wrap their
work in it. The hand-written kernels (kernels/fused.py) are float32 by
construction and do not read these flags.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_precision():
  """Run the enclosed block with TF32 off and "highest" matmul precision."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision("highest")
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])
