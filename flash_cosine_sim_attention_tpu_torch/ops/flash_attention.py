"""Public fused cosine-sim flash attention op.

Counterpart of ``flash_cosine_sim_attention_tpu/ops/flash_attention.py``
with its signature and shape rules: 3-D q means merged batch-heads
(forces ``attn_bias_batch_dim=True``), 3-D k/v means single-headed KV,
grouped-query KV works by index.  float16 inputs compute in bfloat16 and
cast back, as in the JAX op.  The JAX ``custom_vjp`` becomes a
``torch.autograd.Function``: its forward calls ``flash_attention_forward``
and saves (o, inv_l, q, k, v, mask, bias), its backward calls
``flash_attention_backward``.  Both take the Hopper kernels for CUDA
tensors and their plain versions for CPU tensors.  ``qk_int8`` and
``qk_fp8`` quantize q and k for the forward only; the backward is
straight-through, on the unquantized q and k, as the JAX code does it.
The l2norm, the float16 casts and the 3-D reshapes sit outside the
Function, so autograd differentiates them as plain tensor code, as JAX
does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import span
from .blocks import ALLOWED_DIM_HEADS
from .bwd_kernel import backward_route, flash_attention_backward
from .fwd_kernel import flash_attention_forward
from .reference import canonicalize_qkv, l2norm_tensors


def quantize_qk(q, k, qk_quant):
    """(q, k, s_dequant) as the forward of JAX's ``_make_fused`` arms sees
    them: int8 codes of the l2-normalized values at the fixed scale 127
    (f32, clip to +-127, round half to even) with the 1/127^2 dequant,
    e4m3-rounded values, or the float inputs as they are (``qk_quant``
    None)."""
    if qk_quant == "int8":
        q, k = (torch.round((t.float() * 127.0).clamp(-127, 127)
                            ).to(torch.int8) for t in (q, k))
        return q, k, 1.0 / (127.0 * 127.0)
    if qk_quant == "fp8":
        q, k = (t.to(torch.float8_e4m3fn).to(t.dtype) for t in (q, k))
    return q, k, 1.0


class _FusedAttention(torch.autograd.Function):
    """The fused op on canonical 4-D l2-normalized inputs; differentiable
    in q, k, v and the bias.  With ``qk_quant`` the forward sees quantized
    q and k and the backward the saved unquantized ones (straight-through,
    as JAX's ``fused_fwd`` saves them)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, bias_batch_dim, scale, causal,
                qk_quant):
        ctx.kw = dict(bias_batch_dim=bias_batch_dim, scale=scale,
                      causal=causal)
        with span("attention.fwd"):
            qq, kq, s_dequant = quantize_qk(q, k, qk_quant)
            o, inv_l = flash_attention_forward(qq, kq, v, mask, bias,
                                               s_dequant=s_dequant, **ctx.kw)
        ctx.save_for_backward(o, inv_l, q, k, v, mask, bias)
        return o

    @staticmethod
    def backward(ctx, do):
        o, inv_l, q, k, v, mask, bias = ctx.saved_tensors
        with span("attention.bwd", route=backward_route(q, bias)):
            dq, dk, dv, db = flash_attention_backward(
                do, o, inv_l, q, k, v, mask, bias, **ctx.kw)
        return dq, dk, dv, None, db, None, None, None, None


def flash_cosine_sim_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    scale: float = 8.0,
    groups: int = 1,
    causal: bool = False,
    l2norm_qk: bool = True,
    attn_bias_batch_dim: bool = False,
    *,
    qk_int8: bool = False,
    qk_fp8: bool = False,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Fused cosine-sim attention; returns q's shape and dtype.

    Args as in the JAX op: q (b, h, i, d) or (b*h, i, d); k, v
    (b, kvh, j, d) with kvh dividing h, or (b, j, d); mask (b, j) bool,
    True = attend, exclusive with ``causal``; attn_bias (b, i, j) if
    ``attn_bias_batch_dim`` else (h, i, j).

    Differentiable in q, k, v and ``attn_bias``.  ``qk_int8`` runs QK on
    int8 codes of the normalized q/k at the fixed scale 127 (the forward
    kernel's int8 arm, exact integer dots, dequant 1/127^2); ``qk_fp8``
    rounds q and k through e4m3 before the float forward.  Either way the
    backward is straight-through: the standard backward on the unquantized
    q and k with the quantized forward's o and inv_l.  Past +-448 torch's
    e4m3 cast saturates where JAX's gives NaN; with ``l2norm_qk`` every
    value lies in [-1, 1] and the two agree.  ``block_q``, ``block_k`` and
    ``interpret`` are kept for signature parity and must stay None: the
    Hopper tiles are fixed (``ops/blocks.py``) and the device of the
    inputs alone picks kernel or plain version.
    """
    if causal and mask is not None:
        raise ValueError("mask should not be supplied if causality is needed")
    if qk_int8 and qk_fp8:
        raise ValueError("qk_int8 and qk_fp8 exclude each other")
    qk_quant = "int8" if qk_int8 else ("fp8" if qk_fp8 else None)
    if block_q is not None or block_k is not None or interpret is not None:
        raise ValueError(
            "block_q, block_k and interpret have no meaning for the Hopper "
            "kernel; leave them None")
    d = q.shape[-1]
    if d not in ALLOWED_DIM_HEADS and d % 8:
        raise ValueError(
            f"dim_head {d} not supported: must be one of {ALLOWED_DIM_HEADS} "
            f"or a multiple of 8")

    if l2norm_qk:
        q, k = l2norm_tensors(q, k, groups=groups)
    q4, k4, v4, merged, _, bias_batch_dim = canonicalize_qkv(
        q, k, v, attn_bias_batch_dim)

    in_dtype = q4.dtype
    if in_dtype == torch.float16:
        q4, k4, v4 = (t.to(torch.bfloat16) for t in (q4, k4, v4))
        if attn_bias is not None and attn_bias.dtype == torch.float16:
            attn_bias = attn_bias.to(torch.bfloat16)

    o = _FusedAttention.apply(q4, k4, v4, mask, attn_bias, bias_batch_dim,
                              float(scale), bool(causal), qk_quant)
    o = o.to(in_dtype)
    return o[:, 0] if merged else o


def debug():
    """No-op debug hook, kept for API parity with the JAX package."""
    return None
