"""INT8 KV cache for cosine-sim attention decode.

Counterpart of ``flash_cosine_sim_attention_tpu/quant/kv_cache.py``, int8
format only:

  * K is l2-normalized, so its components lie in [-1, 1] and int8 at the
    FIXED scale 127 loses no range and needs no per-row scale.
  * V is unbounded and carries one f32 scale per (slot, kv head, token).

The cache is a fixed-capacity append buffer (b, kvh, capacity, d) plus a
per-slot length.  Unlike the JAX arrays, the buffers are written IN PLACE
by ``append`` (a returned cache shares them with the one passed in); only
``length`` is a new tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

K_SCALE = 127.0  # fixed: K components are in [-1, 1] after l2norm


class QuantKVCache(NamedTuple):
    k8: torch.Tensor        # (b, kvh, cap, d) int8, K * 127
    v8: torch.Tensor        # (b, kvh, cap, d) int8
    v_scale: torch.Tensor   # (b, kvh, cap, 1) f32 per-token V scale
    length: torch.Tensor    # (b,) int32 valid tokens per slot

    @property
    def capacity(self) -> int:
        return self.k8.shape[2]

    @property
    def k_dequant_scale(self) -> float:
        """Multiply raw K storage values by this to recover cos-sim units."""
        return 1.0 / K_SCALE


def init_cache(batch: int, kv_heads: int, capacity: int, dim_head: int,
               device) -> QuantKVCache:
    """An empty cache on ``device`` (zeros everywhere, lengths 0)."""
    shape = (batch, kv_heads, capacity, dim_head)
    return QuantKVCache(
        k8=torch.zeros(shape, dtype=torch.int8, device=device),
        v8=torch.zeros(shape, dtype=torch.int8, device=device),
        v_scale=torch.zeros((*shape[:3], 1), dtype=torch.float32,
                            device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def quantize_k(k_norm: torch.Tensor) -> torch.Tensor:
    """l2-normalized K -> int8 at the fixed scale 127 (round half to even,
    as ``jnp.round``)."""
    return torch.round(
        (k_norm.float() * K_SCALE).clamp(-127, 127)).to(torch.int8)


def quantize_v(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """V -> (int8 values, per-token f32 absmax scale (..., 1))."""
    vf = v.float()
    scale = vf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    v8 = torch.round((vf / scale).clamp(-127, 127)).to(torch.int8)
    return v8, scale


def dequantize_k(k8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (k8.float() * (1.0 / K_SCALE)).to(dtype)


def dequantize_v(v8: torch.Tensor, v_scale: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
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
    dev = cache.k8.device
    k8_new = quantize_k(k_norm)
    v8_new, vs_new = quantize_v(v)
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
        new = new.transpose(1, 2)                               # (b, t, kvh, .)
        if active is not None:
            keep = active.view(b, 1, 1, 1)
            new = torch.where(keep, new, buf[rows, :, cols])
        buf[rows, :, cols] = new
    step = t if active is None else t * active.to(torch.int32)
    return cache._replace(length=cache.length + step)
