"""Sharded training step: TP over heads and the MLP hidden, DP over batch.

Counterpart of ``flash_cosine_sim_attention_tpu/parallel/train.py``, with
JAX's Megatron layout (``_spec_for_path``) stated in the port's own axes.
The port's ``Dense`` stores ``weight`` as (out, in), as ``F.linear`` wants,
where the flax kernel is (in, out); a ``QuantDense`` keeps JAX's (in, out)
int8 codes and (1, out) scales:

  to_q/to_k/to_v   JAX P(None, "model")  column: Dense weight dim 0,
                                          QuantDense codes and scales dim 1
  to_out, FF out   JAX P("model", None)  row: Dense weight dim 1,
                                          QuantDense codes dim 0, scales
                                          replicated
  FF in            as to_q               column
  embeddings, norms, to_logits           replicated

Grouped to_k/to_v are replicated when the TP size does not divide their
KV heads: an explicit slice must hold whole heads (JAX's rule looks at the
output width, whose pieces GSPMD reshards).  A fused ``to_qkv`` is split
piece by piece, q, k and v each on its own, so that each rank holds its
own heads of all three; JAX's contiguous split is right only because
GSPMD reshards.

Every rank is one process holding its own slices (``shard_params``).
Each column-parallel layer reads its input through ``copy_to_model`` and
each row-parallel output is summed by ``reduce_from_model``
(``parallel/mesh.py``), so every rank holds the full activations between
blocks and the full gradients of its replicated parameters.  Data
parallelism: the step slices its ``data`` rows of the global batch, and
the gradients and the loss are averaged over ``data``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Placement, Shard

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    _sum,
    axis_rank,
    axis_size,
    gather,
    local_shard,
    sharding,
)

COLUMN = ("to_q", "to_k", "to_v", "to_qkv", "proj_in")
ROW = ("to_out", "proj_out")


def _module_and_leaf(name: str) -> Tuple[str, str]:
    module, leaf = name.split(".")[-2:]
    return module, leaf


def param_shardings(model, mesh: DeviceMesh
                    ) -> Dict[str, Tuple[Placement, ...]]:
    """``model.state_dict()`` names -> placements (one per mesh dim) by the
    rules above.  The placement of a fused ``to_qkv`` names its split axis;
    ``shard_params`` cuts it piece by piece along that axis."""
    tp = axis_size(mesh, MODEL_AXIS)
    if model.heads % tp:
        raise ValueError(f"heads={model.heads} do not shard over the TP "
                         f"size {tp}")
    kv_sharded = model.kv_heads % tp == 0
    out = {}
    for name in model.state_dict():
        module, leaf = _module_and_leaf(name)
        dense = leaf == "weight"              # Dense (out, in)
        axis = None
        if module in COLUMN and (kv_sharded or module not in ("to_k",
                                                              "to_v")):
            axis = 0 if dense else 1
        elif module in ROW and leaf != "weight_scale":
            axis = 1 if dense else 0
        spec = [None, None]
        if axis is not None:
            spec[axis] = MODEL_AXIS
        out[name] = sharding(mesh, *spec)
    return out


def _split_axis(placements: Sequence[Placement]) -> Optional[int]:
    """The tensor dim sharded over ``model`` (parameters are replicated
    over ``data``), or None."""
    p = placements[1]
    return p.dim if isinstance(p, Shard) else None


def _pieces(name: str, model, tp: int, full: int) -> List[Tuple[int, bool]]:
    """(full size, sharded) of each piece of a split axis of ``full``
    entries: a fused to_qkv's q, k and v, or one sharded piece."""
    if _module_and_leaf(name)[0] != "to_qkv":
        return [(full, True)]
    q, kv = model.heads * model.dim_head, model.kv_heads * model.dim_head
    kv_sharded = model.kv_heads % tp == 0
    return [(q, True), (kv, kv_sharded), (kv, kv_sharded)]


def _to_local(name, t, model, mesh, placements) -> torch.Tensor:
    """This rank's slice of the full parameter-shaped tensor ``t``."""
    axis = _split_axis(placements)
    tp, r = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    out, start = [], 0
    for size, sharded in _pieces(name, model, tp, t.shape[axis]):
        piece = t.narrow(axis, start, size)
        start += size
        n = size // tp
        out.append(piece.narrow(axis, r * n, n) if sharded else piece)
    return torch.cat(out, dim=axis)


def _to_full(name, t, model, mesh, placements) -> torch.Tensor:
    """The full tensor on every rank from each rank's slice ``t``."""
    axis = _split_axis(placements)
    tp = axis_size(mesh, MODEL_AXIS)
    spec = sharding(mesh, *[MODEL_AXIS if i == axis else None
                            for i in range(t.ndim)])
    out, start = [], 0
    for size, sharded in _pieces(name, model, tp, t.shape[axis] * tp):
        n = size // tp if sharded else size
        piece = t.narrow(axis, start, n)
        start += n
        if sharded:
            shape = list(piece.shape)
            shape[axis] = size
            piece = gather(piece, shape, mesh, spec)
        out.append(piece)
    return torch.cat(out, dim=axis)


def _set_mesh(model, mesh: Optional[DeviceMesh]) -> None:
    """Point the model's blocks at ``mesh`` (None: unsharded) and set their
    local head counts."""
    tp = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
    for attn in model.attn:
        attn.mesh = mesh
        attn.heads = model.heads // tp
        attn.kv_replicated = model.kv_heads % tp != 0
        attn.kv_heads = (model.kv_heads if attn.kv_replicated
                         else model.kv_heads // tp)
    for ff in model.ff:
        ff.mesh = mesh
    model.mesh = mesh


def _sharded_items(model, mesh, tensors):
    specs = param_shardings(model, mesh)
    return [(name, t, specs[name]) for name, t in tensors
            if _split_axis(specs[name]) is not None]


@torch.no_grad()
def shard_params(model, mesh: DeviceMesh):
    """Swap the model's sharded weights (parameters and ``QuantDense``
    buffers) for this rank's slices, in place (each ``Parameter`` object
    stays, so an optimizer built before keeps them), and set its blocks'
    local head counts.  Returns ``model``."""
    if model.mesh is not None:
        raise ValueError("the model is sharded already")
    for name, t, spec in _sharded_items(
            model, mesh, model.state_dict(keep_vars=True).items()):
        t.data = _to_local(name, t.data, model, mesh, spec).contiguous()
    _set_mesh(model, mesh)
    return model


@torch.no_grad()
def unshard_params(model):
    """The inverse of ``shard_params``: every rank gets the full weights
    back (gathered over the model axis), in place.  Returns ``model``."""
    mesh = model.mesh
    if mesh is None:
        raise ValueError("the model is not sharded")
    for name, t, spec in _sharded_items(
            model, mesh, model.state_dict(keep_vars=True).items()):
        t.data = _to_full(name, t.data, model, mesh, spec)
    _set_mesh(model, None)
    return model


def _param_states(optimizer, model, mesh):
    """(name, state dict, key, tensor) of every parameter-shaped optimizer
    state tensor (Adam's moments; not its step counts) of a sharded
    parameter."""
    for name, p, _ in _sharded_items(model, mesh, model.named_parameters()):
        state = optimizer.state.get(p, {})
        for key, val in state.items():
            if torch.is_tensor(val) and val.ndim == p.ndim:
                yield name, state, key, val


@torch.no_grad()
def shard_opt_state(optimizer, model, mesh: DeviceMesh):
    """Lay an EXISTING optimizer state onto the mesh after
    ``shard_params(model, mesh)``: every parameter-shaped state tensor
    (Adam's moments) takes its parameter's slice; step counts stay.  The
    resume-safe counterpart of building the optimizer after sharding,
    which would drop restored moments.  Returns ``optimizer``."""
    if model.mesh is not mesh:
        raise ValueError("shard_params(model, mesh) comes first")
    specs = param_shardings(model, mesh)
    for name, state, key, val in list(_param_states(optimizer, model, mesh)):
        state[key] = _to_local(name, val, model, mesh,
                               specs[name]).contiguous()
    return optimizer


@torch.no_grad()
def unshard_opt_state(optimizer, model):
    """The inverse of ``shard_opt_state``, before ``unshard_params``:
    every rank gets the full moments back.  Returns ``optimizer``."""
    mesh = model.mesh
    if mesh is None:
        raise ValueError("the model is not sharded")
    specs = param_shardings(model, mesh)
    for name, state, key, val in list(_param_states(optimizer, model, mesh)):
        state[key] = _to_full(name, val, model, mesh, specs[name])
    return optimizer


def make_sharded_train_step(model, optimizer, mesh: DeviceMesh,
                            max_grad_norm: Optional[float] = None):
    """``step(batch) -> loss`` for a model sharded over ``mesh``.

    Every rank passes the same global batch, (b, n + 1) tokens or
    (n_micro, b, n + 1) microbatches, and the step slices its ``data``
    rows; or a DTensor already sharded over ``data`` along its batch dim
    (``local_batch_to_global``, multi-host feeding), whose local rows the
    step takes as they are.  It averages the loss and the gradients over
    the microbatches and over ``data``, clips them by their global norm
    when ``max_grad_norm`` is given (as the trainer's
    ``clip_by_global_norm_``, counting each sharded slice once), takes the
    optimizer step and returns the global mean loss.  The parameters keep
    their dtype policy (f32 master weights, compute in the model's
    dtype)."""
    if model.mesh is not mesh:
        raise ValueError("shard_params(model, mesh) comes first")
    if any(a.to_qkv is not None and a.kv_replicated for a in model.attn):
        raise ValueError(
            "a fused to_qkv with replicated k/v has no sharded training "
            "step: train the unfused projections")
    dp, tp = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    specs = param_shardings(model, mesh)
    sharded = {p for name, p in model.named_parameters()
               if _split_axis(specs[name]) is not None}

    def clip_(params: List[torch.nn.Parameter]) -> None:
        """The trainer's clip_by_global_norm_ over the whole model: the
        squares of the sharded slices summed over the model axis, those
        of the replicated parameters counted once."""
        zero = torch.zeros((), device=params[0].device)
        sq = {p: p.grad.float().square().sum() for p in params}
        sharded_sq = sum((x for p, x in sq.items() if p in sharded), zero)
        if tp > 1:
            sharded_sq = _sum(sharded_sq, mesh.get_group(MODEL_AXIS))
        norm = (sharded_sq + sum((x for p, x in sq.items()
                                  if p not in sharded), zero)).sqrt()
        keep = norm < max_grad_norm
        for p in params:
            p.grad.copy_(torch.where(keep, p.grad, p.grad / norm.to(
                p.grad.dtype) * max_grad_norm))

    def step(batch: torch.Tensor) -> torch.Tensor:
        rows = sharding(mesh, *([None] * (batch.ndim - 2)), DATA_AXIS, None)
        if isinstance(batch, DTensor):
            if tuple(batch.placements) != rows:
                raise ValueError(f"a batch placed {batch.placements}: the "
                                 f"step takes {rows}")
            local = batch.to_local()
        else:
            local = local_shard(batch, mesh, rows)
        micro = local if local.ndim == 3 else local[None]
        optimizer.zero_grad(set_to_none=True)
        losses = []
        for mb in micro:
            loss = model(mb, return_loss=True)
            loss.backward()
            losses.append(loss.detach())
        with torch.no_grad():
            grads = [p for p in model.parameters() if p.grad is not None]
            for p in grads:
                g = _sum(p.grad, mesh.get_group(DATA_AXIS)) if dp > 1 \
                    else p.grad
                p.grad.copy_(g / (dp * len(micro)))
            if max_grad_norm is not None:
                clip_(grads)
        optimizer.step()
        loss = torch.stack(losses).mean()
        return _sum(loss, mesh.get_group(DATA_AXIS)) / dp if dp > 1 else loss

    return step
