"""The rank body of tests/test_torch_distributed.py's multi-host world.

Each rank of 2 nodes x 2 local ranks (gloo on the CPU) joins the world
through ``initialize_distributed`` at a localhost coordinator, builds the
(data 2, model 2) mesh of ``make_multihost_mesh(2)`` and trains the
test's model 2 float32 steps, its node feeding only its own rows through
``process_local_rows`` and ``local_batch_to_global``.  Then, in the same
world read as one node of 4 ranks, it takes its share of a node's rows on
a (data 2, model 2) mesh.  Each rank writes its results as numpy, with
the first step's gradients and the weights after it, gathered.
Imports no JAX: the test process computes the JAX side.
"""

from __future__ import annotations

import os
import pickle
import traceback

import torch
import torch.distributed as dist

from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    params_from_flax,
    params_to_flax,
)
from flash_cosine_sim_attention_tpu_torch.parallel import (
    DATA_AXIS,
    initialize_distributed,
    local_batch_to_global,
    make_multihost_mesh,
    make_sharded_train_step,
    param_shardings,
    process_local_rows,
    shard_params,
)
from flash_cosine_sim_attention_tpu_torch.parallel.train import (
    _split_axis,
    _to_full,
)
from flash_cosine_sim_attention_tpu_torch.train import (
    MAX_GRAD_NORM,
    make_optimizer,
)


def _full_tree(model, mesh, cfg, grads: bool):
    """The full weights (or their gradients), gathered over the model
    axis, as a flax tree."""
    specs = param_shardings(model, mesh)
    ref = CosineSimCausalTransformer(**cfg, device="cpu")
    full = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        t = p.grad if grads else p.detach()
        if _split_axis(specs[name]) is not None:
            t = _to_full(name, t, model, mesh, specs[name])
        if grads:
            full[name].grad = t.clone()
        else:
            full[name].data = t.clone()
    return params_to_flax(ref, grads=grads)


def run(node: int, local_rank: int, port: int, workdir: str) -> None:
    rank = 2 * node + local_rank
    try:
        torch.set_num_threads(1)
        os.environ.update(LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE="2")
        initialize_distributed(f"localhost:{port}", 2, node, device="cpu")
        with open(f"{workdir}/inputs.pkl", "rb") as f:
            inp = pickle.load(f)
        cfg = inp["cfg"]
        mesh = make_multihost_mesh(2, device_type="cpu")
        model = CosineSimCausalTransformer(**cfg, device="cpu")
        shard_params(params_from_flax(inp["params"], model), mesh)
        step = make_sharded_train_step(model, make_optimizer(model), mesh,
                                       max_grad_norm=MAX_GRAD_NORM)
        out = dict(rank=rank, local_rows=process_local_rows(
            inp["global_rows"]), losses=[], shares=[],
            data_rank=mesh.get_local_rank(DATA_AXIS))
        for s, rows in enumerate(inp["rows"]):
            batch = local_batch_to_global(mesh, rows[node])
            out["global_shape"] = tuple(batch.shape)
            out["shares"].append(batch.to_local().numpy().copy())
            out["losses"].append(step(batch).item())
            if s == 0:   # the clipped gradients and the weights after
                out["grads"] = _full_tree(model, mesh, cfg, True)
                out["params"] = _full_tree(model, mesh, cfg, False)
        # the same world as one node of 4 ranks: a node of two data ranks
        os.environ["LOCAL_WORLD_SIZE"] = "4"
        mesh4 = make_multihost_mesh(2, device_type="cpu")
        out["share4"] = local_batch_to_global(
            mesh4, inp["rows4"]).to_local().numpy().copy()
        out["data_rank4"] = mesh4.get_local_rank(DATA_AXIS)
        with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        with open(f"{workdir}/error-{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise
