"""Device-mesh helpers, the tensor-parallel collectives and the
point-to-point transport.

Counterpart of ``flash_cosine_sim_attention_tpu/parallel/mesh.py``: a 2-D
(data, model) mesh where the model axis shards attention heads and the
MLP hidden and the data axis shards the batch.  JAX's GSPMD inserts the
collectives from sharding annotations; here every process is one rank
that owns one device and holds plain local tensors, and every collective
is explicit, over ``mesh.get_group(axis)`` of any ``DeviceMesh`` with
named dims (ring attention takes ("seq",) or ("model", "seq") meshes,
the pipeline ("pipe",) or ("data", "pipe")):

  * ``copy_to_model``: identity forward, ``all_reduce`` backward (the
    input of a column-parallel layer);
  * ``reduce_from_model``: ``all_reduce`` forward, identity backward
    (the output of a row-parallel layer);
  * ``scatter``: this rank's slice forward; backward, each rank's
    gradient zero-padded to the full shape and summed over the mesh;
  * ``gather``: a local slice written into a zero buffer and
    ``all_reduce``-summed, exact since it adds zeros;
  * ``ppermute``: JAX's ``lax.ppermute`` over one mesh dim, point to
    point (``batch_isend_irecv``); its gradient travels the inverse
    permutation.  Ring attention rotates K/V (and dK/dV) with it, the
    pipeline hops activations (and their gradients) from stage to stage.

Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``, so a world
of several ranks can share one card; its ``send`` and ``recv`` take CPU
tensors only, so ``ppermute`` stages a CUDA tensor through pinned host
memory when the group's backend is gloo.  NCCL (a card a rank) moves
device tensors directly.  Sums of floating-point partials are taken in
float32 and cast back.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.placement_types import Placement, Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model) mesh over the first ``n_devices`` ranks of the
    process group (default: all of them), rank r at (r // mp, r % mp).

    ``model_parallel`` defaults to min(n, 8), lowered until it divides n,
    as in JAX.  ``device_type`` defaults to ``cuda``.  The caller sets up
    the process group (``torchrun``, or ``init_process_group``); without
    one this raises rather than build a world of one."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: run under "
            "torchrun or call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"{n} devices asked for, the world has {world}")
    if model_parallel is None:
        model_parallel = min(n, 8)
        while n % model_parallel:
            model_parallel -= 1
    if n % model_parallel:
        raise ValueError(
            f"model_parallel {model_parallel} does not divide {n} devices")
    ranks = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(device_type or "cuda", ranks,
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def sharding(mesh: DeviceMesh, *spec) -> Tuple[Placement, ...]:
    """The placements, one per mesh dim, that the JAX ``PartitionSpec(*spec)``
    means: ``Shard(i)`` where entry i names the mesh dim, else
    ``Replicate()``."""
    return tuple(
        Shard(spec.index(name)) if name in spec else Replicate()
        for name in mesh.mesh_dim_names)


def _slices(shape: Sequence[int], mesh: DeviceMesh,
            placements: Sequence[Placement]):
    """This rank's (dim, start, length) along every sharded tensor dim."""
    out = []
    for name, p in zip(mesh.mesh_dim_names, placements):
        if not isinstance(p, Shard):
            continue
        n, r = axis_size(mesh, name), axis_rank(mesh, name)
        if shape[p.dim] % n:
            raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split "
                             f"over {n} ranks of mesh axis {name!r}")
        size = shape[p.dim] // n
        out.append((p.dim, r * size, size))
    return out


def local_shard(x: torch.Tensor, mesh: DeviceMesh,
                placements: Sequence[Placement]) -> torch.Tensor:
    """This rank's slice of the full tensor ``x`` (a view)."""
    for dim, start, size in _slices(x.shape, mesh, placements):
        x = x.narrow(dim, start, size)
    return x


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor; float32 sums)."""
    out = x.to(torch.float32 if x.is_floating_point() else x.dtype,
               copy=True)
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Identity; the gradient is summed over the model axis."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return x
    return _CopyToRegion.apply(x, mesh.get_group(MODEL_AXIS))


def reduce_from_model(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` summed over the model axis; the gradient passes unchanged."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return x
    return _ReduceFromRegion.apply(x, mesh.get_group(MODEL_AXIS))


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements, ctx.shape = mesh, placements, x.shape
        return local_shard(x, mesh, placements).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        local_shard(full, ctx.mesh, ctx.placements).copy_(g)
        for name in ctx.mesh.mesh_dim_names:
            if axis_size(ctx.mesh, name) > 1:
                full = _sum(full, ctx.mesh.get_group(name))
        return full, None, None


def scatter(x: torch.Tensor, mesh: DeviceMesh,
            placements: Sequence[Placement]) -> torch.Tensor:
    """This rank's slice of the full tensor ``x``, which every rank passes
    and whose slices (along its ``Shard`` dims; the whole along its
    ``Replicate`` dims) each rank uses for its own part of the work.
    Differentiable: the gradient of ``x`` is the sum over the mesh of each
    rank's gradient, zero-padded to the full shape, on every rank."""
    return _Scatter.apply(x, mesh, tuple(placements))


def gather(x: torch.Tensor, shape: Sequence[int], mesh: DeviceMesh,
           placements: Sequence[Placement]) -> torch.Tensor:
    """The full tensor of ``shape`` on every rank from each rank's slice
    ``x`` (laid out as ``local_shard`` cuts it).  Differentiable: the
    gradient of each slice is the full gradient's slice."""
    full = x.new_zeros(shape)
    local_shard(full, mesh, placements).copy_(x)
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard) and axis_size(mesh, name) > 1:
            full = _ReduceFromRegion.apply(full, mesh.get_group(name))
    return full


Perm = Sequence[Tuple[int, int]]
Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _check_perm(perm: Perm, n: int) -> None:
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts)
            or any(not 0 <= r < n for r in srcs + dsts)):
        raise ValueError(f"perm {list(perm)} is not a partial permutation "
                         f"of {n} axis ranks")


def _stages_through_host(group, x: torch.Tensor) -> bool:
    """Whether ``x`` goes through host memory: a CUDA tensor over a group
    whose backend for CUDA is gloo.  Read from ``dist.get_backend``
    alone (a multi-backend group names one a device type, as
    "cpu:gloo,cuda:nccl"), never from a failed send."""
    backend = dist.get_backend(group)
    if ":" in backend:
        backend = dict(b.split(":") for b in backend.split(","))[
            x.device.type]
    return x.device.type == "cuda" and backend == "gloo"


def _transfer(xs: List[torch.Tensor], group, rank: int, perm: Perm
              ) -> List[torch.Tensor]:
    """The raw hop: every (src, dst) pair of axis ranks sends src's
    tensors to dst; a rank no pair sends to gets zeros.  Counted in
    ``ppermute.calls`` (hops) and ``ppermute.bytes`` (bytes this rank
    sent)."""
    send_to = [d for s, d in perm if s == rank]
    recv_from = [s for s, d in perm if d == rank]
    if send_to and send_to[0] == rank:          # a rank's pair to itself
        return [x.clone() for x in xs]
    host = _stages_through_host(group, xs[0])

    def buffer(x):
        if host:
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    # gloo sends CPU tensors only: the blocking copies leave each pinned
    # buffer complete before gloo reads it and after it writes it
    wire = [buffer(x).copy_(x) if host else x.contiguous() for x in xs] \
        if send_to else []
    got = [buffer(x) for x in xs] if recv_from else []
    ops = [dist.P2POp(dist.isend, w, dist.get_global_rank(group, d), group)
           for d in send_to for w in wire]
    ops += [dist.P2POp(dist.irecv, w, dist.get_global_rank(group, s), group)
            for s in recv_from for w in got]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    ppermute.calls += 1
    ppermute.bytes += sum(w.numel() * w.element_size() for w in wire)
    if not recv_from:
        return [torch.zeros_like(x) for x in xs]
    return [w.to(x.device) for w, x in zip(got, xs)] if host else got


class _PPermute(torch.autograd.Function):
    """``_transfer`` forward; the incoming gradients travel the inverse
    permutation backward (JAX's transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, group, rank, perm, *xs):
        ctx.group, ctx.rank = group, rank
        ctx.inverse = tuple((d, s) for s, d in perm)
        return tuple(_transfer(list(xs), group, rank, perm))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None,
                *_transfer(list(gs), ctx.group, ctx.rank, ctx.inverse))


def ppermute(x: Tensors, mesh: DeviceMesh, axis: str, perm: Perm
             ) -> Tensors:
    """JAX's ``lax.ppermute`` over mesh dim ``axis``: ``perm`` lists
    (source, destination) pairs of axis-local ranks; each source's ``x``
    (a tensor, or a tuple or list of tensors sent together) arrives at
    its destination, and a rank that no pair sends to gets zeros.  An
    axis of size 1 returns ``x`` and moves nothing.

    Differentiable: the gradient arriving at each destination travels
    back along the inverse permutation (JAX's transpose of ``ppermute``).

    Lockstep rule: every rank of the axis must reach every ``ppermute``,
    forward and backward, in the same order and with tensors of the same
    shapes and dtypes, including ranks that send or receive nothing: the
    sends and receives of one call are posted together
    (``dist.batch_isend_irecv``), so no ring order can deadlock, but a
    rank that skips a call leaves its peers waiting.

    Transport: the group's backend alone decides (``dist.get_backend``,
    never a failed send).  Over NCCL device tensors go directly; over
    gloo a CUDA tensor is copied to pinned host memory, sent, received
    and copied back onto its device.  Counts hops in ``ppermute.calls``
    and the bytes this rank sends in ``ppermute.bytes``."""
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    if axis_size(mesh, axis) == 1:
        return x
    _check_perm(perm, axis_size(mesh, axis))
    out = _PPermute.apply(mesh.get_group(axis), axis_rank(mesh, axis),
                          tuple(map(tuple, perm)), *xs)
    return out[0] if single else type(x)(out)


ppermute.calls = 0
ppermute.bytes = 0
