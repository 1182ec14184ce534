"""Ring attention: sequence parallelism over a mesh dim.

Counterpart of ``flash_cosine_sim_attention_tpu/parallel/ring_attention.py``.
The sequence is sharded over ``axis_name``; each rank keeps its Q shard
and the K/V shards (with the key mask) rotate around the ring by
``ppermute`` (``parallel/mesh.py``) while partial attention accumulates
locally.  Cosine-sim logits are bounded, so there is no running row max:
each pair of shards contributes its un-normalized ``exp-weights @ V`` and
its row sum, merged by plain addition, and one divide at the end.

Causality across shards is static: at step s rank ``me`` holds shard
``g = (me - s) % size``, which is earlier (one forward call, K1,
non-causal), the diagonal (one K1 call, causal and key-masked together:
the wrappers take both, only the public op forbids it) or later (no
launch: it contributes zero).  A causal ring of n ranks launches
n (n + 1) / 2 pair forwards in all, rank r r + 1 of them.

The backward runs the same ring.  The forward's global ``inv_l`` makes
each pair's softmax partial exact, so each pair calls the standard
backward (``ops/bwd_kernel.py::flash_attention_backward``: K2 at a local
length up to ``ONEPASS_BWD_MAX_SEQ``, K3a/K3b past it) with the global
dO, o and inv_l.  dQ accumulates in float32 on its rank; dK and dV
accumulate in the input dtype, rounded at every hop as JAX rounds them,
and travel the ring with their K/V shard, home after ``size`` hops.  The
forward moves K/V ``size - 1`` times (JAX's loop also makes a last,
unused rotation); the backward hops once a step, K/V with dK/dV.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.blocks import EPS
from ..ops.bwd_kernel import flash_attention_backward
from ..ops.fwd_kernel import flash_attention_forward
from ..ops.reference import l2norm_tensors
from .mesh import axis_rank, axis_size, gather, local_shard, ppermute, \
    scatter, sharding
from .sharded_attention import shard_kv


def _ring(mesh: DeviceMesh, axis: str):
    """(size, this rank's index, the perm i -> i + 1) of the ring."""
    size = axis_size(mesh, axis)
    return size, axis_rank(mesh, axis), [(i, (i + 1) % size)
                                         for i in range(size)]


class _RingAttention(torch.autograd.Function):
    """The ring on l2-normalized local shards; differentiable in q, k, v
    (JAX's ``custom_vjp`` of ``_make_ring``)."""

    @staticmethod
    def forward(ctx, qn, kn, v, mask, mesh, axis, scale, causal):
        size, me, perm = _ring(mesh, axis)
        kw = dict(bias_batch_dim=False, scale=scale)
        o_acc = torch.zeros(qn.shape, device=qn.device, dtype=torch.float32)
        l_acc = torch.zeros((*qn.shape[:3], 1), device=qn.device,
                            dtype=torch.float32)
        cur = (kn, v) if mask is None else (kn, v, mask)
        for s in range(size):
            g = (me - s) % size
            if not causal or g <= me:
                o, inv_l = flash_attention_forward(
                    qn, cur[0], cur[1], None if mask is None else cur[2],
                    None, causal=causal and g == me, **kw)
                lsum = 1.0 / inv_l                  # exact: no row max
                # o rounded to the input dtype first, as JAX's pair does
                o_acc += o.float() * lsum
                l_acc += lsum
            if s < size - 1:
                cur = ppermute(cur, mesh, axis, perm)
        inv_l = 1.0 / l_acc.clamp_min(EPS)
        o = (o_acc * inv_l).to(qn.dtype)
        ctx.save_for_backward(qn, kn, v, mask, o, inv_l)
        ctx.ring = (mesh, axis, scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        qn, kn, v, mask, o, inv_l = ctx.saved_tensors
        mesh, axis, scale, causal = ctx.ring
        size, me, perm = _ring(mesh, axis)
        do = do.to(o.dtype).contiguous()
        dq_acc = torch.zeros(qn.shape, device=qn.device, dtype=torch.float32)
        # dK/dV travel in the input dtype: half the bytes a hop for bf16
        dk_acc, dv_acc = torch.zeros_like(kn), torch.zeros_like(v)
        cur = (kn, v) if mask is None else (kn, v, mask)
        for s in range(size):
            g = (me - s) % size
            if not causal or g <= me:
                dq, dk, dv, _ = flash_attention_backward(
                    do, o, inv_l, qn, cur[0], cur[1],
                    None if mask is None else cur[2], None,
                    bias_batch_dim=False, scale=scale,
                    causal=causal and g == me)
                dq_acc += dq.float()
                dk_acc = (dk_acc.float() + dk.float()).to(kn.dtype)
                dv_acc = (dv_acc.float() + dv.float()).to(v.dtype)
            # the accumulators go with their shard; K/V need no last hop
            moving = (cur if s < size - 1 else ()) + (dk_acc, dv_acc)
            moved = ppermute(moving, mesh, axis, perm)
            if s < size - 1:
                cur = moved[:len(cur)]
            dk_acc, dv_acc = moved[-2:]
        return (dq_acc.to(qn.dtype), dk_acc, dv_acc, None, None, None, None,
                None)


def ring_flash_cosine_sim_attention_local(
    q: torch.Tensor,   # (b, h, n_local, d): this rank's sequence shard
    k: torch.Tensor,   # (b, kvh, n_local, d) with kvh dividing h
    v: torch.Tensor,
    mesh: DeviceMesh,
    mask: Optional[torch.Tensor] = None,   # (b, n_local) bool key mask
    axis_name: str = "seq",
    scale: float = 8.0,
    groups: int = 1,
    causal: bool = True,
    l2norm_qk: bool = True,
) -> torch.Tensor:
    """Ring attention on this rank's shards, the body JAX's ``shard_map``
    runs: rank r of ``axis_name`` holds positions [r n_local, (r + 1)
    n_local) of q, k, v and the mask.  Every rank of the axis calls it
    together (``ppermute``'s lockstep rule), forward and backward.  What
    a long-context caller runs."""
    if l2norm_qk:
        q, k = l2norm_tensors(q, k, groups=groups)
    return _RingAttention.apply(q, k, v, mask, mesh, axis_name, float(scale),
                                bool(causal))


def ring_flash_cosine_sim_attention(
    q: torch.Tensor,   # (b, h, n, d), n sharded over ``axis_name``
    k: torch.Tensor,   # (b, kvh, n, d) with kvh dividing h (GQA / MQA ok)
    v: torch.Tensor,
    mesh: DeviceMesh,
    mask: Optional[torch.Tensor] = None,   # (b, n) bool key mask
    axis_name: str = "seq",
    scale: float = 8.0,
    groups: int = 1,
    causal: bool = True,
    l2norm_qk: bool = True,
    model_axis: Optional[str] = None,
    data_axis: Optional[str] = None,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Sequence-parallel attention over ``axis_name``, composed with head
    TP (``model_axis``) and batch DP (``data_axis``): every rank passes
    the full tensors, takes its (data, model, seq) shard, runs its ring
    and gets the full output back.  Differentiable in q, k and v (each
    rank's gradients are the full ones when every rank takes the same
    loss of the output).

    ``mask`` shards like K and rotates with its shard; it composes with
    ``causal`` (the diagonal shard applies both).  KV follows JAX's rules
    (``shard_kv``): MQA KV is replicated over ``model_axis``, grouped KV
    whose heads the TP size does not divide is repeated to the full head
    count.  A mesh dim of size > 1 that none of the three axes names would
    repeat the whole ring, and raises.  ``interpret`` is kept for signature
    parity and must stay None."""
    if interpret is not None:
        raise ValueError("interpret has no meaning for the Hopper kernels; "
                         "leave it None")
    named = (data_axis, model_axis, axis_name)
    idle = [n for n in mesh.mesh_dim_names
            if n not in named and axis_size(mesh, n) > 1]
    if idle:
        raise ValueError(f"mesh dims {idle} are named by none of data_axis, "
                         f"model_axis, axis_name")
    q_spec = sharding(mesh, data_axis, model_axis, axis_name, None)
    kv_spec = sharding(mesh, data_axis, None, axis_name, None)
    kl, vl = scatter(k, mesh, kv_spec), scatter(v, mesh, kv_spec)
    if model_axis is not None:
        kl, vl = shard_kv(kl, vl, q.shape[1], mesh, axis=model_axis)
    if mask is not None:
        mask = local_shard(mask, mesh, sharding(mesh, data_axis, axis_name))
    o = ring_flash_cosine_sim_attention_local(
        scatter(q, mesh, q_spec), kl, vl, mesh, mask=mask,
        axis_name=axis_name, scale=scale, groups=groups, causal=causal,
        l2norm_qk=l2norm_qk)
    return gather(o, q.shape, mesh, q_spec)
