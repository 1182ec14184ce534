"""Quantized KV cache for cosine-sim attention decode.

Counterpart of ``flash_cosine_sim_attention_tpu/quant/kv_cache.py``, with
its two storage formats, selected by ``kv_dtype``:

  * ``torch.int8`` (default): K is l2-normalized, so its components lie in
    [-1, 1] and int8 at the FIXED scale 127 loses no range and needs no
    per-row scale; V is unbounded and carries one f32 scale per (slot,
    kv head, token).
  * ``torch.float8_e4m3fn``: K and V stored as e4m3 directly, with no
    scale (``v_scale`` is an all-ones placeholder).  Values are clipped to
    e4m3's finite range +-448 before the cast: past it torch saturates
    while JAX gives NaN, and inside it the two frameworks' bytes agree.

The cache is a fixed-capacity append buffer (b, kvh, capacity, d) plus a
per-slot length.  Unlike the JAX arrays, the buffers are written IN PLACE
by ``append`` (a returned cache shares them with the one passed in); only
``length`` is a new tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import span

K_SCALE = 127.0  # fixed: K components are in [-1, 1] after l2norm
FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0  # e4m3's largest finite value
KV_DTYPES = (torch.int8, FP8_DTYPE)


class QuantKVCache(NamedTuple):
    k8: torch.Tensor        # (b, kvh, cap, d) int8 (K * 127) or e4m3 (K)
    v8: torch.Tensor        # (b, kvh, cap, d) int8 or e4m3
    v_scale: torch.Tensor   # (b, kvh, cap, 1) f32 per-token V scale (int8;
                            # all ones for e4m3)
    length: torch.Tensor    # (b,) int32 valid tokens per slot

    @property
    def capacity(self) -> int:
        return self.k8.shape[2]

    @property
    def is_fp8(self) -> bool:
        return self.k8.dtype == FP8_DTYPE

    @property
    def k_dequant_scale(self) -> float:
        return kdq(self.k8.dtype)


def kdq(kv_dtype) -> float:
    """Multiply raw K storage values of ``kv_dtype`` by this to recover
    cos-sim units: 1/127 for int8, 1 for e4m3."""
    return 1.0 if kv_dtype == FP8_DTYPE else 1.0 / K_SCALE


def check_kv_dtype(kv_dtype) -> None:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype}")


def init_cache(batch: int, kv_heads: int, capacity: int, dim_head: int,
               device, kv_dtype=torch.int8) -> QuantKVCache:
    """An empty cache on ``device`` (zero codes, lengths 0; V scales 0 for
    int8 and 1 for e4m3, as in JAX)."""
    check_kv_dtype(kv_dtype)
    shape = (batch, kv_heads, capacity, dim_head)
    fill = torch.zeros if kv_dtype == torch.int8 else torch.ones
    return QuantKVCache(
        k8=torch.zeros(shape, dtype=kv_dtype, device=device),
        v8=torch.zeros(shape, dtype=kv_dtype, device=device),
        v_scale=fill((*shape[:3], 1), dtype=torch.float32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 tensor viewed as its uint8 bytes (other dtypes as they are),
    so that indexing and scatters need no float8 support."""
    return t.view(torch.uint8) if t.dtype == FP8_DTYPE else t


def quantize_k(k_norm: torch.Tensor, kv_dtype=torch.int8) -> torch.Tensor:
    """l2-normalized K -> storage codes: int8 at the fixed scale 127 (round
    half to even, as ``jnp.round``) or e4m3."""
    if kv_dtype == FP8_DTYPE:
        return k_norm.float().clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    return torch.round(
        (k_norm.float() * K_SCALE).clamp(-127, 127)).to(torch.int8)


def quantize_v(v: torch.Tensor, kv_dtype=torch.int8
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """V -> (codes, per-token f32 scale (..., 1)): int8 with an absmax
    scale, or e4m3 with an all-ones scale."""
    vf = v.float()
    if kv_dtype == FP8_DTYPE:
        return (vf.clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE),
                torch.ones((*v.shape[:-1], 1), dtype=torch.float32,
                           device=v.device))
    scale = vf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    v8 = torch.round((vf / scale).clamp(-127, 127)).to(torch.int8)
    return v8, scale


def dequantize_k(k8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (k8.float() * kdq(k8.dtype)).to(dtype)


def dequantize_v(v8: torch.Tensor, v_scale: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    if v8.dtype == FP8_DTYPE:
        return v8.to(dtype)
    return (v8.float() * v_scale).to(dtype)


def append(cache: QuantKVCache, k_norm: torch.Tensor, v: torch.Tensor,
           active: Optional[torch.Tensor] = None) -> QuantKVCache:
    """Write a (b, kvh, t, d) chunk of NEW tokens at each slot's own offset
    (its length) into the cache buffers, in place; return the cache with
    the advanced lengths.

    ``k_norm`` must already be l2-normalized.  ``active`` ((b,) bool,
    optional) supports continuous batching: an inactive slot's length does
    not advance and its buffers are left as they are.  The offsets stay on
    the device (no host sync).  The caller guarantees
    length + t <= capacity for every active slot.
    """
    b, _, t, _ = k_norm.shape
    with span("kv_append", t=t):
        dev = cache.k8.device
        kv_dtype = cache.k8.dtype
        k8_new = quantize_k(k_norm, kv_dtype)
        v8_new, vs_new = quantize_v(v, kv_dtype)
        if active is not None:
            # inactive slots rewrite what they hold at a clamped offset: a
            # slot at capacity must not index past the buffer
            pos = cache.length.clamp(max=cache.capacity - t)
        else:
            pos = cache.length
        rows = torch.arange(b, device=dev)[:, None]                 # (b, 1)
        cols = pos.long()[:, None] + torch.arange(t, device=dev)    # (b, t)
        for buf, new in ((cache.k8, k8_new), (cache.v8, v8_new),
                         (cache.v_scale, vs_new)):
            # (b, t, kvh, .)
            buf, new = as_bytes(buf), as_bytes(new).transpose(1, 2)
            if active is not None:
                keep = active.view(b, 1, 1, 1)
                new = torch.where(keep, new, buf[rows, :, cols])
            buf[rows, :, cols] = new
        step = t if active is None else t * active.to(torch.int32)
        return cache._replace(length=cache.length + step)
