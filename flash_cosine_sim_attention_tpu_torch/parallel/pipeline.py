"""Pipeline parallelism: GPipe-style microbatched stages over a mesh dim.

Counterpart of ``flash_cosine_sim_attention_tpu/parallel/pipeline.py``:

  * the transformer's ``depth`` layers split into ``S = |pipe|``
    contiguous stages; rank p of ``pipe`` holds only stage p's layers, as
    the port's own ``Attention`` and ``FeedForward`` modules in a
    ``PipelineStage`` (JAX stacks them on a leading layer axis; a module
    list is the PyTorch idiom).  ``split_pipeline_params`` and
    ``merge_pipeline_params`` still give JAX's ``(stacked, aux)`` tree, as
    tensors, for checkpoints and tests.  The embeddings, final norm and
    logits (``aux``) are replicated on every rank.
  * a batch splits into ``M`` microbatches and the schedule runs
    ``T = M + S - 1`` steps: at step t rank p works on microbatch t - p,
    and one ``ppermute`` a step (``parallel/mesh.py``) hops activations
    from stage p to p + 1.  Stage 0 embeds its microbatch; the last stage
    takes the shifted-label cross-entropy of the microbatch it finishes.
  * the backward is autograd through the hops: a hop's gradient travels
    the inverse permutation, which is the GPipe backward, exact.

Bubbles.  Eager PyTorch skips a bubble step's compute (no K1 or K2
launch; a rank's launches a step are its layers on a real microbatch, 0
in a bubble).  The hop still runs on every rank at every step, as
``ppermute``'s lockstep rule asks, and a bubble passes on what it
received (zeros at first), which no stage reads: no zero activation ever
reaches the l2norm, whose derivative is NaN at 0.  Forward order alone
does not order the backward hops on a rank where a hop's output is not
read (stage 0, a bubble), so each hop also carries a one-element token
from the previous hop, and the last token joins the loss times zero:
every rank's backward then runs every hop, from the last to the first.

The loss on every rank is the sum over ``pipe`` (every stage but the
last contributes 0) and the mean over ``data``.  Gradients of the
replicated parameters are summed over ``pipe`` and ``data``, those of the
layers over ``data``, as JAX's ``shard_map`` transpose sums them; the
loss is already divided by the data size, so the sums are JAX's means.

Restrictions (checked): pre-norm models, ``depth % S == 0``,
``batch % (M * data) == 0``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from .mesh import (
    DATA_AXIS,
    _ReduceFromRegion,
    _sum,
    axis_rank,
    axis_size,
    local_shard,
    ppermute,
    sharding,
)

PIPE_AXIS = "pipe"
AUX = ("token_emb", "pos_emb", "final_norm", "to_logits")


def make_pipeline_mesh(n_devices: Optional[int] = None,
                       pipeline_parallel: Optional[int] = None,
                       device_type: Optional[str] = None) -> DeviceMesh:
    """A ("pipe",) mesh over the first ``n_devices`` ranks (default: all),
    or ("data", "pipe") when ``pipeline_parallel`` is smaller: rank r at
    (r // pp, r % pp), each data replica its own pipeline ring.
    ``device_type`` defaults to ``cuda``; the caller sets up the process
    group, as for ``make_mesh``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_pipeline_mesh needs a torch.distributed process group: "
            "run under torchrun or call torch.distributed.init_process_group "
            "first")
    n = n_devices or dist.get_world_size()
    if pipeline_parallel is None or pipeline_parallel == n:
        return DeviceMesh(device_type or "cuda", torch.arange(n),
                          mesh_dim_names=(PIPE_AXIS,))
    if n % pipeline_parallel:
        raise ValueError(f"pipeline_parallel {pipeline_parallel} does not "
                         f"divide {n} devices")
    return DeviceMesh(device_type or "cuda",
                      torch.arange(n).reshape(-1, pipeline_parallel),
                      mesh_dim_names=(DATA_AXIS, PIPE_AXIS))


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _check(model, n_stages: int) -> int:
    """Layers a stage (JAX's asserts, raised)."""
    if not model.pre_norm:
        raise ValueError("pipeline stages assume the pre-norm recipe")
    if model.depth % n_stages:
        raise ValueError(f"depth {model.depth} does not split into "
                         f"{n_stages} stages")
    return model.depth // n_stages


def split_pipeline_params(model, params: dict, n_stages: int
                          ) -> Tuple[dict, dict]:
    """Regroup a flax parameter tree (nested dicts of arrays or tensors,
    ``params_to_flax``'s layout, optionally under ``"params"``) into
    JAX's ``(stacked, aux)`` of tensors: ``stacked`` = {"attn": tree,
    "ff": tree} with leading axes (n_stages, depth // n_stages) on every
    leaf, ``aux`` = {"params": the embeddings, final norm and logits}.
    ``merge_pipeline_params`` inverts it exactly."""
    lp = _check(model, n_stages)
    tree = params.get("params", params)
    as_tensor = lambda x: torch.as_tensor(np.asarray(x)) \
        if not torch.is_tensor(x) else x  # noqa: E731

    def stack(prefix):
        def leaf(*xs):
            x = torch.stack([as_tensor(x) for x in xs])
            return x.reshape(n_stages, lp, *x.shape[1:])
        return _map(leaf, *[tree[f"{prefix}_{i}"] for i in range(model.depth)])

    aux = {k: _map(as_tensor, v) for k, v in tree.items()
           if not k.startswith(("attn_", "ff_"))}
    return {"attn": stack("attn"), "ff": stack("ff")}, {"params": aux}


def merge_pipeline_params(model, stacked: dict, aux: dict) -> dict:
    """Inverse of ``split_pipeline_params``: the flax tree of the plain
    model (``params_from_flax`` loads it), leaves as given."""
    out = dict(aux["params"])
    for name in ("attn", "ff"):
        n_stages, per = next(iter(_leaves(stacked[name]))).shape[:2]
        for s in range(n_stages):
            for j in range(per):
                out[f"{name}_{s * per + j}"] = _map(
                    lambda x, s=s, j=j: x[s, j], stacked[name])
    return {"params": out}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class PipelineStage(nn.Module):
    """Rank ``stage``'s share of a pipelined model: its ``depth // S``
    layers, built as the model builds them (JAX's ``_layer_modules``),
    and the replicated ``token_emb``, ``pos_emb``, ``final_norm`` and
    ``to_logits``.  It keeps the attribute names of
    ``CosineSimCausalTransformer`` (a pre-norm model of ``depth`` layers),
    so ``models/convert.py`` maps it to and from the flax layout."""

    def __init__(self, model, stage: int, n_stages: int):
        from ..models.transformer import (
            Attention, Dense, Embed, FeedForward, LayerNorm)
        super().__init__()
        if model.mesh is not None:
            raise ValueError("a tensor-parallel model has no pipeline stages")
        self.depth = _check(model, n_stages)
        self.stage, self.n_stages = stage, n_stages
        self.layer0 = stage * self.depth      # the model's index of layer 0
        self.pre_norm, self.dtype, self.dim = True, model.dtype, model.dim
        a = model.attn[0]
        kw = dict(dtype=model.dtype, param_dtype=model.token_emb.weight.dtype,
                  device=model.device)
        self.token_emb = Embed(model.num_tokens, model.dim, 0.02, **kw)
        self.pos_emb = Embed(model.max_seq_len, model.dim, 0.02, **kw)
        self.attn = nn.ModuleList(
            Attention(model.dim, model.dim_head, model.heads, model.kv_heads,
                      model.attn_scale, model.attn_l2norm_groups, True,
                      a.use_fused, a.non_cosine_sim_attn, 1.0, **kw)
            for _ in range(self.depth))
        self.ff = nn.ModuleList(FeedForward(model.dim, pre_norm=True, **kw)
                                for _ in range(self.depth))
        self.final_norm = LayerNorm(model.dim, **kw)
        self.to_logits = Dense(model.dim, model.num_tokens, 1.0, **kw)

    @property
    def device(self) -> torch.device:
        return self.token_emb.weight.device

    def full_name(self, name: str, layer0: Optional[int] = None) -> str:
        """A parameter's name in the full model's ``state_dict``, for this
        stage's layers or, with ``layer0``, those of the stage whose first
        layer is the model's ``layer0``."""
        parts = name.split(".")
        if parts[0] in ("attn", "ff"):
            first = self.layer0 if layer0 is None else layer0
            parts[1] = str(first + int(parts[1]))
        return ".".join(parts)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return self.token_emb(tokens) + self.pos_emb(pos)[None]

    @staticmethod
    def _layer(attn, ff, h):
        h = attn(h) + h
        return ff(h) + h

    def layers(self, h: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """This stage's layers; ``remat`` checkpoints each one."""
        for attn, ff in zip(self.attn, self.ff):
            h = checkpoint(self._layer, attn, ff, h, use_reentrant=False) \
                if remat else self._layer(attn, ff, h)
        return h

    def head_loss(self, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(self.to_logits(self.final_norm(h)).float(), -1)
        return -logp.gather(-1, labels[..., None].long()).mean()


def shard_pipeline_params(model, stacked: dict, aux: dict,
                          mesh: DeviceMesh) -> PipelineStage:
    """This rank's ``PipelineStage`` of ``model`` (its configuration; its
    weights are not read) holding stage p of ``stacked`` and the whole
    ``aux``, loaded through ``models/convert.py``'s flax mapping.  JAX
    places the trees on the mesh; here each rank builds only its own
    layers."""
    from ..models.convert import params_from_flax
    n_stages, p = axis_size(mesh, PIPE_AXIS), axis_rank(mesh, PIPE_AXIS)
    stage = PipelineStage(model, p, n_stages)
    host = lambda x: torch.as_tensor(x).detach().cpu()  # noqa: E731
    tree = _map(host, dict(aux["params"]))
    for name in ("attn", "ff"):
        for j in range(stage.depth):
            tree[f"{name}_{j}"] = _map(lambda x, j=j: host(x[p, j]),
                                       stacked[name])
    return params_from_flax(tree, stage)


@torch.no_grad()
def unshard_pipeline_params(
        stage: PipelineStage, mesh: DeviceMesh,
        read: Callable[[nn.Parameter], Optional[torch.Tensor]] = None
) -> Dict[str, torch.Tensor]:
    """``read(p)`` of every stage's parameters on every rank, under the
    full model's ``state_dict`` names: each layer summed over ``pipe``
    from zeros on the ranks that do not hold it, the replicated ones from
    this rank.  ``read`` defaults to the weights; pass ``lambda p:
    p.grad`` for the gradients, or an optimizer's moment for a
    checkpoint (None reads as zeros).  Every rank of the mesh calls it
    together."""
    read = read or (lambda p: p)
    n_stages, lp = stage.n_stages, stage.depth
    group = mesh.get_group(PIPE_AXIS)
    out = {}
    for name, p in stage.named_parameters():
        t = read(p)
        t = torch.zeros_like(p) if t is None else t.detach()
        if name.split(".")[0] in AUX:
            out[name] = t.clone()
            continue
        for s in range(n_stages):
            mine = t if s == stage.stage else torch.zeros_like(t)
            out[stage.full_name(name, s * lp)] = (
                _sum(mine, group) if n_stages > 1 else mine.clone())
    return out


def make_pipeline_loss_fn(model, mesh: DeviceMesh, n_micro: int,
                          remat: bool = False):
    """``loss_fn(stage, tokens)`` over tokens (b, n + 1), the same global
    batch on every rank: the plain model's mean next-token loss of the
    merged parameters (GPipe is exact), computed through the schedule over
    ``pipe``, the same scalar on every rank.  ``model`` (the model or a
    stage) gives the activations' width and dtype.  Its backward leaves
    each rank's own share of the gradients: ``make_pipeline_train_step``
    sums them.  ``remat=True`` checkpoints each layer (the GPipe backward
    holds T = M + S - 1 steps of residuals)."""
    n_stages, p = axis_size(mesh, PIPE_AXIS), axis_rank(mesh, PIPE_AXIS)
    has_data = DATA_AXIS in mesh.mesh_dim_names
    n_data = axis_size(mesh, DATA_AXIS) if has_data else 1
    perm = [(i, i + 1) for i in range(n_stages - 1)]

    def loss_fn(stage: PipelineStage, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.shape[0] % (n_micro * n_data):
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{n_micro} microbatches on {n_data} replicas")
        if n_data > 1:
            tokens = local_shard(tokens, mesh, sharding(mesh, DATA_AXIS))
        x, labels = tokens[:, :-1], tokens[:, 1:]
        xm = x.reshape(n_micro, -1, x.shape[1])
        lm = labels.reshape(n_micro, -1, labels.shape[1])
        dev = tokens.device
        h = torch.zeros(*xm.shape[1:], model.dim, dtype=model.dtype,
                        device=dev)
        token = torch.zeros(1, device=dev, requires_grad=True)
        loss_sum = torch.zeros((), device=dev)
        for t in range(n_micro + n_stages - 1):
            recv = h
            if n_stages > 1:
                recv, token = ppermute((h, token), mesh, PIPE_AXIS, perm)
            m = t - p
            if 0 <= m < n_micro:
                h = stage.layers(stage.embed(xm[m]) if p == 0 else recv,
                                 remat)
                if p == n_stages - 1:
                    loss_sum = loss_sum + stage.head_loss(h, lm[m])
            else:
                h = recv     # a bubble: what travels on is never read
        loss = loss_sum / n_micro
        if n_stages > 1:
            loss = loss + token.sum() * 0
            loss = _ReduceFromRegion.apply(loss, mesh.get_group(PIPE_AXIS))
        if n_data > 1:
            loss = _ReduceFromRegion.apply(
                loss, mesh.get_group(DATA_AXIS)) / n_data
        return loss

    return loss_fn


def make_pipeline_train_step(stage: PipelineStage, optimizer, mesh: DeviceMesh,
                             n_micro: int, remat: bool = False,
                             max_grad_norm: Optional[float] = None):
    """``step(tokens) -> loss`` for this rank's ``stage``: the pipelined
    loss and backward, the gradients summed as the module docstring says
    (JAX's gradients, on every rank), clipped by their global norm when
    ``max_grad_norm`` is given (the trainer's ``clip_by_global_norm_``,
    each layer counted once), then the optimizer step.  Every rank passes
    the same global batch (b, n + 1) and gets the global mean loss; the
    summed gradients stay in ``.grad``."""
    loss_fn = make_pipeline_loss_fn(stage, mesh, n_micro, remat=remat)
    groups = [mesh.get_group(n) for n in mesh.mesh_dim_names
              if axis_size(mesh, n) > 1]
    data_groups = [mesh.get_group(DATA_AXIS)] \
        if DATA_AXIS in mesh.mesh_dim_names \
        and axis_size(mesh, DATA_AXIS) > 1 else []
    pipe = mesh.get_group(PIPE_AXIS) if axis_size(mesh, PIPE_AXIS) > 1 \
        else None

    def step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(stage, tokens)
        loss.backward()
        with torch.no_grad():
            sq = {True: [], False: []}
            for name, p in stage.named_parameters():
                aux = name.split(".")[0] in AUX
                g = torch.zeros_like(p) if p.grad is None else p.grad
                for group in (groups if aux else data_groups):
                    g = _sum(g, group)
                p.grad = g
                sq[aux].append(g.float().square().sum())
            if max_grad_norm is not None:
                layers = torch.stack(sq[False]).sum()
                if pipe is not None:
                    layers = _sum(layers, pipe)
                norm = (layers + torch.stack(sq[True]).sum()).sqrt()
                keep = norm < max_grad_norm
                for p in stage.parameters():
                    p.grad.copy_(torch.where(keep, p.grad, p.grad / norm.to(
                        p.grad.dtype) * max_grad_norm))
        optimizer.step()
        return loss.detach()

    return step
