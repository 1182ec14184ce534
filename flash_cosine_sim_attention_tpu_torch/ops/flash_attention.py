"""Public fused cosine-sim flash attention op.

Counterpart of ``flash_cosine_sim_attention_tpu/ops/flash_attention.py``
with its signature and shape rules: 3-D q means merged batch-heads
(forces ``attn_bias_batch_dim=True``), 3-D k/v means single-headed KV,
grouped-query KV works by index.  float16 inputs compute in bfloat16 and
cast back, as in the JAX op.  The JAX ``custom_vjp`` becomes a
``torch.autograd.Function``: its forward calls ``flash_attention_forward``
and saves (o, inv_l, q, k, v, mask, bias), its backward calls
``flash_attention_backward``.  Both take the Hopper kernels for CUDA
tensors and their plain versions for CPU tensors.  The l2norm, the
float16 casts and the 3-D reshapes sit outside the Function, so autograd
differentiates them as plain tensor code, as JAX does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .blocks import ALLOWED_DIM_HEADS
from .bwd_kernel import flash_attention_backward
from .fwd_kernel import flash_attention_forward
from .reference import canonicalize_qkv, l2norm_tensors


class _FusedAttention(torch.autograd.Function):
    """The fused op on canonical 4-D l2-normalized inputs; differentiable
    in q, k, v and the bias."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, bias_batch_dim, scale, causal):
        ctx.kw = dict(bias_batch_dim=bias_batch_dim, scale=scale,
                      causal=causal)
        o, inv_l = flash_attention_forward(q, k, v, mask, bias, **ctx.kw)
        ctx.save_for_backward(o, inv_l, q, k, v, mask, bias)
        return o

    @staticmethod
    def backward(ctx, do):
        o, inv_l, q, k, v, mask, bias = ctx.saved_tensors
        dq, dk, dv, db = flash_attention_backward(
            do, o, inv_l, q, k, v, mask, bias, **ctx.kw)
        return dq, dk, dv, None, db, None, None, None


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

    Differentiable in q, k, v and ``attn_bias``.  Not in this port yet:
    ``qk_int8`` / ``qk_fp8`` (raise ``NotImplementedError``).  ``block_q``,
    ``block_k`` and ``interpret`` are kept for signature parity and must
    stay None: the Hopper tiles are fixed (``ops/blocks.py``) and the
    device of the inputs alone picks kernel or plain version.
    """
    if causal and mask is not None:
        raise ValueError("mask should not be supplied if causality is needed")
    if qk_int8 or qk_fp8:
        raise NotImplementedError(
            "qk_int8 / qk_fp8 are not ported to the PyTorch package yet")
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
                              float(scale), bool(causal))
    o = o.to(in_dtype)
    return o[:, 0] if merged else o
