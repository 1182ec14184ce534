"""Device-mesh helpers and the tensor-parallel collectives.

Counterpart of ``flash_cosine_sim_attention_tpu/parallel/mesh.py``: a 2-D
(data, model) mesh where the model axis shards attention heads and the
MLP hidden and the data axis shards the batch.  JAX's GSPMD inserts the
collectives from sharding annotations; here every process is one rank
that owns one device and holds plain local tensors, and every collective
is explicit, over ``mesh.get_group(axis)``:

  * ``copy_to_model``: identity forward, ``all_reduce`` backward (the
    input of a column-parallel layer);
  * ``reduce_from_model``: ``all_reduce`` forward, identity backward
    (the output of a row-parallel layer);
  * ``scatter``: this rank's slice forward; backward, each rank's
    gradient zero-padded to the full shape and summed over the mesh;
  * ``gather``: a local slice written into a zero buffer and
    ``all_reduce``-summed, exact since it adds zeros.

Only ``all_reduce`` and ``broadcast`` are used: gloo takes CUDA tensors
for those two, so a world of several ranks can share one card.  Sums of
floating-point partials are taken in float32 and cast back.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
