"""Head-sharded quantized decode: tensor-parallel serving of the KV cache.

Counterpart of ``flash_cosine_sim_attention_tpu/parallel/sharded_decode.py``:
the quantized cache shards batch slots over ``data`` and KV heads over
``model``, and every rank decodes its local head group against its local
cache through ``quantized_decode_attention`` (K4 on the card, its plain
version on the CPU, as the queries' device decides: JAX's ``use_kernel``
has no counterpart).  Heads are independent, so the op needs no
collective; the row-parallel output projection that follows it in the
model sums over the model axis.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..quant import QuantKVCache
from ..quant.decode_kernel import quantized_decode_attention
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
    gather,
    local_shard,
    sharding,
)


def cache_shardings(mesh: DeviceMesh, kv_heads: int | None = None
                    ) -> QuantKVCache:
    """The placements of a ``QuantKVCache``'s fields: slots over ``data``,
    KV heads over ``model``.  A cache whose KV heads the TP size divides
    shards them; an MQA cache (1 head) is replicated over ``model``; any
    other grouped cache is refused, since replicating it would remap query
    groups to the wrong KV head inside each shard."""
    tp = axis_size(mesh, MODEL_AXIS)
    kvh = kv_heads if kv_heads is not None else tp  # default: divisible
    if kvh % tp == 0:
        kv = sharding(mesh, DATA_AXIS, MODEL_AXIS, None, None)
    elif kvh == 1:
        kv = sharding(mesh, DATA_AXIS, None, None, None)
    else:
        raise ValueError(
            f"kv_heads={kvh} must be 1 or a multiple of the TP size "
            f"({tp}) to shard the decode cache: replicating a grouped "
            f"cache would remap query groups to the wrong KV head")
    return QuantKVCache(k8=kv, v8=kv, v_scale=kv,
                        length=sharding(mesh, DATA_AXIS))


def local_kv_heads(mesh: DeviceMesh, kv_heads: int) -> int:
    """The KV heads of one rank's cache under ``cache_shardings``."""
    tp = axis_size(mesh, MODEL_AXIS)
    cache_shardings(mesh, kv_heads)   # raises for a misaligned grouped cache
    return kv_heads // tp if kv_heads % tp == 0 else kv_heads


def shard_cache(cache: QuantKVCache, mesh: DeviceMesh) -> QuantKVCache:
    """This rank's local cache (contiguous copies of its slices)."""
    specs = cache_shardings(mesh, kv_heads=cache.k8.shape[1])
    return QuantKVCache(*(local_shard(t, mesh, s).contiguous()
                          for t, s in zip(cache, specs)))


def head_sharded_decode_attention_local(
        q: torch.Tensor, cache: QuantKVCache, scale: float = 8.0,
        groups: int = 1, l2norm_qk: bool = True) -> torch.Tensor:
    """Decode on one rank's shard: q (b_local, h / tp, d) or
    (b_local, h / tp, 1, d) against its local cache.  What the
    tensor-parallel model calls."""
    return quantized_decode_attention(q, cache, scale=scale, groups=groups,
                                      l2norm_qk=l2norm_qk)


def head_sharded_decode_attention(
    q: torch.Tensor,            # (b, h, d) one new token per slot
    cache: QuantKVCache,        # this rank's cache, as shard_cache gives it
    mesh: DeviceMesh,
    scale: float = 8.0,
    groups: int = 1,
    l2norm_qk: bool = True,
) -> torch.Tensor:
    """Decode attention with slots sharded over ``data`` and heads and
    cache over ``model``: every rank passes the full queries and its local
    cache, runs the decode on its shard, and gets the full (b, h, d)
    output back."""
    q_spec = sharding(mesh, DATA_AXIS, MODEL_AXIS, None)
    o = head_sharded_decode_attention_local(
        local_shard(q, mesh, q_spec), cache, scale=scale, groups=groups,
        l2norm_qk=l2norm_qk)
    return gather(o, q.shape, mesh, q_spec)
