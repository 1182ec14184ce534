"""Head-sharded fused attention.

Counterpart of ``flash_cosine_sim_attention_tpu/parallel/sharded_attention.py``:
batch shards over ``data`` and heads over ``model``; each rank runs the
fused op (K1, and in the backward K2 or K3a/K3b) on its local shard at its
local head count, with no collective inside attention.

KV follows JAX's rules (``shard_kv``): single-head (3-D) and MQA KV are
replicated, since the kernel maps every local query head to KV head 0;
grouped KV whose head count the TP size divides shards like q (contiguous
head blocks keep the kernel's local ``hi // q_per_kv`` mapping right);
any other grouped KV is repeated to the full head count before it is
sharded, since replicating 1 < kvh < h KV heads would remap query groups
to the wrong KV head inside a shard (the kernel recomputes ``q_per_kv``
from the LOCAL counts).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import flash_cosine_sim_attention
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_rank,
    axis_size,
    gather,
    local_shard,
    scatter,
    sharding,
)


def shard_kv(k: torch.Tensor, v: torch.Tensor, heads: int,
             mesh: DeviceMesh, axis: str = MODEL_AXIS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's KV for its block of ``heads`` query heads sharded over
    mesh dim ``axis``, from the full (b, kvh, n, d) or single-head
    (b, n, d) KV (batch and sequence untouched)."""
    if k.ndim == 3 or k.shape[1] == 1:
        return k, v
    tp = axis_size(mesh, axis)
    if k.shape[1] % tp:
        k = k.repeat_interleave(heads // k.shape[1], dim=1)
        v = v.repeat_interleave(heads // v.shape[1], dim=1)
    n = k.shape[1] // tp
    r = axis_rank(mesh, axis)
    return k.narrow(1, r * n, n), v.narrow(1, r * n, n)


def head_sharded_flash_attention_local(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
    """The fused op on one rank's shard, the body JAX's ``shard_map`` runs:
    q (b_local, h / tp, n, d), k and v as ``shard_kv`` gives them, mask
    (b_local, n).  What the tensor-parallel model calls."""
    return flash_cosine_sim_attention(q, k, v, mask=mask, **kwargs)


def head_sharded_flash_attention(
    q: torch.Tensor,   # (b, h, n, d)
    k: torch.Tensor,   # (b, kvh, n, d) with kvh | h, or (b, n, d)
    v: torch.Tensor,
    mesh: DeviceMesh,
    mask: Optional[torch.Tensor] = None,
    **kwargs,
) -> torch.Tensor:
    """``flash_cosine_sim_attention`` sharded (batch -> data, heads ->
    model): every rank passes the full tensors and gets the full output
    back.  Differentiable in q, k and v (each rank's gradients are the full
    ones when every rank takes the same loss of the output)."""
    q_spec = sharding(mesh, DATA_AXIS, MODEL_AXIS, None, None)
    batch = sharding(mesh, DATA_AXIS)
    ql = scatter(q, mesh, q_spec)
    kl, vl = shard_kv(scatter(k, mesh, batch), scatter(v, mesh, batch),
                      q.shape[1], mesh)
    if mask is not None:
        mask = local_shard(mask, mesh, batch)
    o = head_sharded_flash_attention_local(ql, kl, vl, mask=mask, **kwargs)
    return gather(o, q.shape, mesh, q_spec)
