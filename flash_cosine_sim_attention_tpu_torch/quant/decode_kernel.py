"""Decode path: one-token cosine-sim attention over the quantized KV cache.

Counterpart of ``flash_cosine_sim_attention_tpu/quant/decode_kernel.py``.
A CUDA query goes to the hand-written Hopper kernel
``csrc/decode_kernel.cu`` (one kernel for both TPU forms,
``_decode_kernel`` and ``_decode_kernel_packed``, with an int8 and an
e4m3 instance); a CPU query goes to ``decode_attention_plain``, the same
maths in plain PyTorch, including the JAX kernel's bf16 roundings of q
and of the (V-scaled, for int8) exp weights.  JAX sends an e4m3 cache to
an XLA einsum by default, for a Mosaic limit the card does not have; here
it takes the kernel like int8.  ``reference_decode_attention`` is the
dequantize-everything oracle.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, current_stream, load_kernel
from ..ops.blocks import EPS, kernel_head_dim
from ..ops.reference import l2norm_tensors
from .kv_cache import KV_DTYPES, QuantKVCache, dequantize_k, dequantize_v


def _live(cache: QuantKVCache) -> torch.Tensor:
    """(b, 1, 1, cap) bool: token t of slot b is below its length."""
    cap = cache.capacity
    return (torch.arange(cap, device=cache.k8.device)[None, None, None, :]
            < cache.length[:, None, None, None])


def decode_attention_plain(qg: torch.Tensor, cache: QuantKVCache,
                           scale: float) -> torch.Tensor:
    """Plain version of the decode kernel: qg (b, kvh, g, d) normalized
    queries -> (b, kvh, g, d) f32."""
    q = qg.to(torch.bfloat16).float()
    s = q @ cache.k8.float().transpose(-1, -2)           # (b, kvh, g, cap)
    e = torch.exp(s * (scale * cache.k_dequant_scale) - scale)
    e = torch.where(_live(cache), e, torch.zeros((), device=e.device))
    lsum = e.sum(-1, keepdim=True)                       # unscaled weights
    if not cache.is_fp8:  # fold int8 V's per-token scale into the weights
        e = e * cache.v_scale[..., 0][:, :, None, :]
    e = e.to(torch.bfloat16)
    o = e.float() @ cache.v8.float()
    return o / lsum.clamp_min(EPS)


def check_decode_args(qg: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                      kernel: str) -> None:
    """What both CUDA decode kernels (contiguous and paged) take: qg
    (b, kvh, g, d) with any group g and d a multiple of 8 up to 128 (read
    in place as d-byte code rows), K and V codes both int8 or both e4m3."""
    kernel_head_dim(qg.shape[-1], kernel)
    if k8.dtype not in KV_DTYPES or v8.dtype != k8.dtype:
        raise TypeError(f"the CUDA {kernel} kernel takes int8 or e4m3 codes, "
                        f"got {k8.dtype} / {v8.dtype}")


def _decode_cuda(qg: torch.Tensor, cache: QuantKVCache,
                 scale: float) -> torch.Tensor:
    b, kvh, g, d = qg.shape
    cap = cache.capacity
    check_decode_args(qg, cache.k8, cache.v8, "decode")
    if tuple(cache.k8.shape) != (b, kvh, cap, d) or (
            cache.v8.shape != cache.k8.shape):
        raise ValueError(f"cache shape {tuple(cache.k8.shape)} does not fit "
                         f"queries {tuple(qg.shape)}")
    parts = (qg, cache.k8, cache.v8, cache.v_scale, cache.length)
    if any(t.device != qg.device for t in parts):
        raise ValueError("queries and cache must lie on the same CUDA device")
    q = qg.to(torch.bfloat16).contiguous()
    k8, v8 = cache.k8.contiguous(), cache.v8.contiguous()
    vs = cache.v_scale.float().contiguous()
    length = cache.length.to(torch.int32).contiguous()
    out = torch.empty((b, kvh, g, d), device=qg.device, dtype=torch.float32)
    lib = load_kernel("decode_kernel")
    lib.fcsa_decode.restype = ctypes.c_int
    lib.fcsa_decode.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    code = lib.fcsa_decode(
        q.data_ptr(), k8.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        length.data_ptr(), out.data_ptr(), b, kvh, g, cap, d,
        int(cache.is_fp8), float(scale * cache.k_dequant_scale),
        float(scale), current_stream())
    check_launch(code, "fcsa_decode")
    quantized_decode_attention.launches += 1
    return out


def quantized_decode_attention(
    q: torch.Tensor,            # (b, h, d) or (b, h, 1, d), one new token
    cache: QuantKVCache,
    scale: float = 8.0,
    groups: int = 1,
    l2norm_qk: bool = True,
) -> torch.Tensor:
    """Attention of one new query token per slot against its quantized cache,
    over the slot's live tokens only; returns q's shape and dtype.

    CUDA queries launch the Hopper kernel (counted in
    ``quantized_decode_attention.launches``); CPU queries take the plain
    version.  Any other device raises.
    """
    squeeze = q.ndim == 4
    if squeeze:
        if q.shape[2] != 1:
            raise ValueError(f"one query token per slot, got {q.shape[2]}")
        q = q[:, :, 0]
    if l2norm_qk:
        q = l2norm_tensors(q, groups=groups)
    b, h, d = q.shape
    kvh = cache.k8.shape[1]
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    qg = q.reshape(b, kvh, h // kvh, d)
    if q.device.type == "cuda":
        out = _decode_cuda(qg, cache, float(scale))
    elif q.device.type == "cpu":
        out = decode_attention_plain(qg, cache, float(scale))
    else:
        raise ValueError(f"no decode attention for device {q.device}")
    out = out.reshape(b, h, d).to(q.dtype)
    return out[:, :, None, :] if squeeze else out


quantized_decode_attention.launches = 0


def reference_decode_attention(q: torch.Tensor, cache: QuantKVCache,
                               scale: float = 8.0, groups: int = 1,
                               l2norm_qk: bool = True) -> torch.Tensor:
    """Dequantize-everything oracle for the decode kernel (f32 maths, no
    bf16 roundings)."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, :, 0]
    if l2norm_qk:
        q = l2norm_tensors(q, groups=groups)
    b, h, d = q.shape
    kvh = cache.k8.shape[1]
    k = dequantize_k(cache.k8)
    v = dequantize_v(cache.v8, cache.v_scale)
    qg = q.reshape(b, kvh, h // kvh, d).float()
    e = torch.exp(qg @ k.transpose(-1, -2) * scale - scale)
    e = torch.where(_live(cache), e, torch.zeros((), device=e.device))
    o = (e @ v) / e.sum(-1, keepdim=True).clamp_min(EPS)
    o = o.reshape(b, h, d).to(q.dtype)
    return o[:, :, None, :] if squeeze else o
