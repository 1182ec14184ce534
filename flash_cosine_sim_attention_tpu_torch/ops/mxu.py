"""Split float32 products: the plain versions of what the kernels' float32
instances compute.

Counterpart of ``flash_cosine_sim_attention_tpu/ops/mxu.py``.  A float32
product on a unit that multiplies in fewer bits is formed from a split of
each operand, x = hi + lo, and the three significant cross products
(lo.lo dropped).  Each product of two split parts is exact in float32, so
the plain versions below are float32 matmuls of the rounded parts.

- ``dot_f32x3``: the JAX package's split, hi and lo in bfloat16 (8
  significant bits each).  Mosaic has no TF32 tier, so the TPU kernels use
  it; it reaches ~1e-5 relative, and at 8 l2norm groups and scale 8 it
  breaks the 1e-4 float32 bar.
- ``dot_tf32x3``: the Hopper kernels' split (``csrc/mma_common.cuh``
  ``split_tf32``, 3xTF32 on the tensor cores), hi and lo in TF32 (11
  significant bits each, rounded to nearest with ties to even as
  ``cvt.rn.tf32.f32`` does), ~2^-21 relative per operand.

``flash_attention_forward_plain`` and ``flash_attention_backward_plain``
take either as ``mm=`` to show what the split costs against their exact
float32 products.
"""

from __future__ import annotations

import torch


def _split_bf16(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def dot_f32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on float32 as three bfloat16 products (JAX's split):
    hi.hi + (hi.lo + lo.hi), each summed in float32."""
    a_hi, a_lo = _split_bf16(a.float())
    b_hi, b_lo = _split_bf16(b.float())
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rn.tf32.f32`` rounds it: 10
    explicit mantissa bits, to nearest with ties to even, the low 13 bits
    cleared.  Adding 0x0FFF, plus the lowest kept bit, to the bit pattern
    rounds the magnitude whatever the sign (a carry moves into the
    exponent); ±0 and subnormals round like any other pattern.  A
    non-finite word skips the add, which would carry out of its exponent
    (0x7fffffff into -0): an infinity stays, and a NaN keeps its sign and
    sets its quiet bit, so it stays a NaN with its low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    exponent, mantissa = bits & 0x7F800000, bits & 0x007FFFFF
    nan = (bits | 0x00400000) & ~0x1FFF
    kept = torch.where(mantissa != 0, nan, bits)
    return torch.where(exponent == 0x7F800000, kept,
                       rounded).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo), both TF32: hi = tf32_round(x), lo = tf32_round(x - hi);
    x - hi is exact in float32, and hi + lo holds x to 2^-21 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def dot_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on float32 as three TF32 products (the kernels' split):
    (lo.hi + hi.lo) + hi.hi, each summed in float32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
