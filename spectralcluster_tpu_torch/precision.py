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

One caller may ask for less: the spectral divide-and-conquer's sign chain
(ops/dc.py), whose products JAX runs at a precision it names. ``matmul``
takes that name and maps it onto the card: "highest" is IEEE float32,
"high" (XLA's 3-pass bf16) is 3×TF32, "default" (1-pass bf16) one TF32
product. TF32 is allowed only inside ``matmul``, and only for tensors on
the card; the CPU has no TF32 and computes each product in IEEE float32.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("highest", "high", "default")

# Float32 bits below TF32's 10-bit mantissa.
_TF32_DROPPED_BITS = 0x1FFF


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


@contextlib.contextmanager
def _tf32_products(on_card: bool):
  """cuBLAS float32 products on the TF32 tensor cores, on the card only."""
  if not on_card:
    yield
    return
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])


def tf32_split(x: torch.Tensor):
  """(hi, lo): hi keeps x's sign, exponent and top 10 mantissa bits, so a
  TF32 product reads it exactly, and lo = x − hi exactly."""
  hi = (x.view(torch.int32) & ~_TF32_DROPPED_BITS).view(torch.float32)
  return hi, x - hi


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str = "highest") -> torch.Tensor:
  """a @ b of two float32 matrices at a JAX matmul precision name.

  "high" splits each operand into its TF32 part and the remainder and sums
  hi·hi + (hi·lo + lo·hi), three products on the card's TF32 tensor cores
  (the remainder's own product, below float32 rounding, is dropped).
  Raises ValueError for any other name than those of ``PRECISIONS``.
  """
  if precision not in PRECISIONS:
    raise ValueError(f"unknown matmul precision {precision!r}; expected one "
                     f"of {PRECISIONS}")
  with fp32_precision():
    if precision == "highest":
      return torch.matmul(a, b)
    with _tf32_products(a.is_cuda):
      if precision == "default":
        return torch.matmul(a, b)
      a_hi, a_lo = tf32_split(a)
      b_hi, b_lo = (a_hi, a_lo) if b is a else tf32_split(b)
      out = torch.matmul(a_hi, b_lo)
      out.addmm_(a_lo, b_hi)
      return out.addmm_(a_hi, b_hi)
