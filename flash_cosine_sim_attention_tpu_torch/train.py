"""enwik8 char-LM training driver for the PyTorch port.

Counterpart of the repository's ``train.py`` (the JAX trainer) with its
constants, CLI and schedule: batch 4, grad-accum 4, Adam lr 2e-4 after a
global-norm clip at 0.5, validate every 100 steps, generate every 500,
model dim 512 / depth 8 / attn scale 1 with 8 l2norm groups, pre-norm,
bf16 compute with float32 parameters.  If ``data/enwik8.gz`` is absent a
deterministic synthetic byte corpus stands in, as in the JAX trainer.
Runs on ``cuda`` unless ``--device cpu`` is given.

``--model-parallel N`` shards the model over a (data W / N, model N) mesh
(``parallel/``): run it under ``torchrun --nproc-per-node W``, one process
a rank and a device (NCCL on the card, gloo with ``--device cpu``).  Every
rank draws the same global batch and takes its data rows; only rank 0
prints and checkpoints.  Checkpoints hold the full weights: they are
gathered before saving and sharded again after restoring, so a
tensor-parallel checkpoint restores into a single-device run and back.
``--pipeline-parallel N`` (exclusive with ``--model-parallel``, as in the
JAX trainer) runs the GPipe pipeline over a (data W / N, pipe N) mesh
under torchrun the same way: rank p holds stage p's layers, and the
GRAD_ACCUM microbatches of a step drive the schedule.  Its checkpoints
hold the merged full weights and Adam moments too.

Multi-host (``--num-processes N``, ``--process-id p``, ``--coordinator
host:port``; ``parallel/distributed.py``): N nodes of L ranks each, one
torchrun a node, form a world of N * L ranks at the coordinator (node 0's
address and a free port) on a (data, model) mesh whose model axis stays
inside a node (``--model-parallel`` dividing L; default min(L, 8)).  Each
node samples its own rows (seed + 1009 p), its ranks split them, and only
the data-axis gradient sum crosses nodes; global rank 0 alone prints and
saves the gathered full weights, so the checkpoint directory must be
shared by the nodes or lie on node 0 (a resume reads it on every node).
No sampling runs under multi-host, and ``--pipeline-parallel`` excludes it,
as in the JAX trainer.

Usage:
  python -m flash_cosine_sim_attention_tpu_torch.train --seq-len 1024 \\
      --steps 1000 [--use-float32] [--no-fused] [--device cpu]
  torchrun --nproc-per-node 2 -m flash_cosine_sim_attention_tpu_torch.train \\
      --model-parallel 2 [--device cpu]
  torchrun --nproc-per-node 2 -m flash_cosine_sim_attention_tpu_torch.train \\
      --pipeline-parallel 2 [--device cpu]
  # on each node p of N (L ranks a node):
  torchrun --standalone --nproc-per-node L \\
      -m flash_cosine_sim_attention_tpu_torch.train --num-processes N \\
      --process-id p --coordinator host:port [--model-parallel mp]
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from ._build import resolve_device
from .data import TextSampler, synthetic_corpus
from .models import CosineSimCausalTransformer, generate, params_to_flax
from .parallel import (
    DATA_AXIS,
    initialize_distributed,
    local_batch_to_global,
    make_mesh,
    make_multihost_mesh,
    make_pipeline_mesh,
    make_pipeline_train_step,
    make_sharded_train_step,
    process_local_rows,
    shard_opt_state,
    shard_params,
    shard_pipeline_params,
    split_pipeline_params,
    unshard_opt_state,
    unshard_params,
    unshard_pipeline_params,
)
from .parallel.distributed import process_count, process_index
from .parallel.mesh import _sum
from .utils import restore_checkpoint, save_checkpoint
from .utils.profiling import span

# the JAX trainer's constants (train.py:40-45)
BATCH_SIZE = 4
GRAD_ACCUM = 4
LEARNING_RATE = 2e-4
MAX_GRAD_NORM = 0.5
VALIDATE_EVERY = 100
GENERATE_EVERY = 500
GENERATE_LENGTH = 512


def make_sampler(path="data/enwik8.gz", seed=0, log=print) -> TextSampler:
    """enwik8 90M/5M split through the native sampler; the deterministic
    synthetic corpus (written once to data/synthetic.raw, the JAX
    trainer's file) when enwik8 is absent."""
    if not os.path.exists(path):
        synth = "data/synthetic.raw"
        if not os.path.exists(synth):
            log("data/enwik8.gz not found - generating deterministic "
                "synthetic byte corpus (drop enwik8.gz into data/ for the "
                "real benchmark)")
            os.makedirs("data", exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir="data")
            with os.fdopen(fd, "wb") as f:
                f.write(synthetic_corpus().tobytes())
            os.replace(tmp, synth)  # atomic: ranks may write it together
        path = synth
    sampler = TextSampler(path, train_frac=90 / 95, seed=seed)
    log(f"data: {path}  loader backend: {sampler.backend}  "
        f"bytes: {sampler.size:,}")
    return sampler


def init_model_parallel(n: int, device=None, pipeline: bool = False):
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on
    the card with each rank on device ``LOCAL_RANK``, gloo on the CPU; and
    return a (data W / N, model N) mesh over it, or with ``pipeline`` a
    (data W / N, pipe N) one.  Raises outside torchrun or when N does not
    divide W."""
    flag = "--pipeline-parallel" if pipeline else "--model-parallel"
    if "RANK" not in os.environ:
        raise RuntimeError(f"{flag} runs under torchrun --nproc-per-node W, "
                           f"one process a rank")
    on_card = resolve_device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if on_card else "gloo")
    if dist.get_world_size() % n:
        raise ValueError(f"{flag} {n} does not divide the world size "
                         f"{dist.get_world_size()}")
    device_type = "cuda" if on_card else "cpu"
    if pipeline:
        return make_pipeline_mesh(pipeline_parallel=n,
                                  device_type=device_type)
    return make_mesh(model_parallel=n, device_type=device_type)


def shard_pipeline(model, optimizer, mesh):
    """This rank's ``PipelineStage`` of ``model`` and an Adam over it that
    carries ``optimizer``'s moments of its parameters (a restored
    checkpoint's)."""
    n_stages = mesh.size(mesh.mesh_dim_names.index("pipe"))
    stage = shard_pipeline_params(model, *split_pipeline_params(
        model, params_to_flax(model), n_stages), mesh)
    stage_opt = make_optimizer(stage)
    full = dict(model.named_parameters())
    for name, p in stage.named_parameters():
        state = optimizer.state.get(full[stage.full_name(name)])
        if state:
            stage_opt.state[p] = {k: v.clone() for k, v in state.items()}
    return stage, stage_opt


def merge_pipeline(stage, optimizer, mesh, build):
    """The full model (``build()``) holding every stage's weights, and an
    Adam over it holding every stage's moments, on every rank (which all
    call it together): the inverse of ``shard_pipeline``."""
    model = build()
    full = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in unshard_pipeline_params(stage, mesh).items():
            full[name].copy_(t)
    full_opt = make_optimizer(model)
    first = optimizer.state.get(next(stage.parameters()))
    if first:   # after a step every parameter has its moments
        moments = {key: unshard_pipeline_params(
            stage, mesh, lambda p, key=key: optimizer.state[p][key])
            for key in ("exp_avg", "exp_avg_sq")}
        for name, p in full.items():
            full_opt.state[p] = dict(
                step=first["step"].clone(),
                **{key: moments[key][name] for key in moments})
    return model, full_opt


def decode_bytes(tokens) -> str:
    return "".join(chr(max(32, int(t))) for t in tokens)


def make_optimizer(model: torch.nn.Module) -> torch.optim.Adam:
    """optax.adam(2e-4)'s counterpart: betas (0.9, 0.999), eps 1e-8."""
    return torch.optim.Adam(model.parameters(), lr=LEARNING_RATE,
                            betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the ``.grad``s in place: each becomes
    g / ||g|| * max_norm unless ||g|| < max_norm (no epsilon, unlike
    ``clip_grad_norm_``).  Returns the global norm; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def train_step(model: CosineSimCausalTransformer,
               optimizer: torch.optim.Optimizer,
               batches: torch.Tensor) -> torch.Tensor:
    """One optimizer step over the microbatches ``batches``
    (n_micro, batch, seq_len + 1): the mean of their losses and of their
    gradients (train.py:255-267), clipped, then Adam.  Returns the mean
    loss as a device tensor."""
    with span("train.step", micro=len(batches)):
        optimizer.zero_grad(set_to_none=True)
        losses = []
        for i, batch in enumerate(batches):
            with span("train.micro", i=i):
                loss = model(batch, return_loss=True)
                loss.backward()
                losses.append(loss.detach())
        with span("train.update"):
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(len(batches))
            clip_by_global_norm_(model.parameters(), MAX_GRAD_NORM)
            optimizer.step()
        return torch.stack(losses).mean()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--use-float32", action="store_true",
                    help="f32 compute (default bf16 with f32 parameters)")
    ap.add_argument("--no-fused", action="store_true",
                    help="use the plain attention instead of the kernels")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=int(1e5))
    ap.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--checkpoint-dir", type=str, default="",
                    help="save/resume checkpoints here (torch.save)")
    ap.add_argument("--checkpoint-every", type=int, default=1000)
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="shard over a (data, model) mesh (0 = single "
                         "device): heads and the MLP hidden over `model`, "
                         "batch over `data`; run under torchrun")
    ap.add_argument("--pipeline-parallel", type=int, default=0,
                    help="GPipe pipeline over a (data, pipe) mesh (0 = "
                         "none): stage p's layers on rank p of `pipe`, "
                         "GRAD_ACCUM microbatches a step; run under "
                         "torchrun")
    ap.add_argument("--coordinator", type=str, default="",
                    help="multi-host: coordinator address host:port (node "
                         "0's address and a free port; required with "
                         "--num-processes > 1)")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="multi-host: node count (1 = single node)")
    ap.add_argument("--process-id", type=int, default=-1,
                    help="multi-host: this node's rank, 0..N-1 (required "
                         "with --num-processes > 1)")
    args = ap.parse_args(argv)
    multihost = args.num_processes > 1
    if args.pipeline_parallel > 1 and (args.model_parallel > 1 or multihost):
        raise ValueError("--pipeline-parallel is exclusive with "
                         "--model-parallel / multi-host")

    mesh = pipe = None
    if multihost:
        initialize_distributed(
            args.coordinator or None, args.num_processes,
            args.process_id if args.process_id >= 0 else None,
            device=args.device)
        mesh = make_multihost_mesh(
            args.model_parallel or None,
            device_type=resolve_device(args.device).type)
    elif args.model_parallel > 1:
        mesh = init_model_parallel(args.model_parallel, args.device)
    if args.pipeline_parallel > 1:
        pipe = init_model_parallel(args.pipeline_parallel, args.device,
                                   pipeline=True)
    is_main = (mesh is None and pipe is None) or dist.get_rank() == 0
    log = print if is_main else (lambda *a, **k: None)
    device = resolve_device(args.device)
    dtype = torch.float32 if args.use_float32 else torch.bfloat16
    torch.manual_seed(args.seed)
    build = functools.partial(
        CosineSimCausalTransformer, num_tokens=256, dim=args.dim,
        depth=args.depth, max_seq_len=args.seq_len, attn_scale=1.0,
        attn_l2norm_groups=8, use_fused=not args.no_fused, pre_norm=True,
        dtype=dtype, device=device)
    model = build()
    # multi-host: each node draws its own rows (its ranks alike); else
    # every rank draws the whole batch
    node = process_index() if multihost else 0
    sampler = make_sampler(seed=args.seed + 1009 * node, log=log)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"params: {n_params / 1e6:.1f}M  dtype: {str(dtype)[6:]}  "
        f"fused: {not args.no_fused}  device: {device}")
    optimizer = make_optimizer(model)

    start_step = 0
    if args.checkpoint_dir:
        ck_step = restore_checkpoint(args.checkpoint_dir, model, optimizer)
        if ck_step is not None:
            start_step = ck_step + 1
            log(f"resumed from step {ck_step}")
    step_fn = functools.partial(train_step, model, optimizer)
    if mesh is not None:
        # shard after restoring: the checkpoint holds the full weights,
        # and the restored moments are sliced, not dropped
        shard_params(model, mesh)
        shard_opt_state(optimizer, model, mesh)
        step_fn = make_sharded_train_step(model, optimizer, mesh,
                                          max_grad_norm=MAX_GRAD_NORM)
        log((f"processes: {process_count()}  " if multihost else "")
            + f"mesh: data={mesh.size(0)} model={mesh.size(1)}")
    if pipe is not None:
        # as for the mesh: the stages are cut after restoring
        stage, optimizer = shard_pipeline(model, optimizer, pipe)
        del model        # rank p holds stage p's layers only
        pipe_step = make_pipeline_train_step(
            stage, optimizer, pipe, GRAD_ACCUM, max_grad_norm=MAX_GRAD_NORM)
        step_fn = lambda b: pipe_step(b.reshape(-1, b.shape[-1]))  # noqa: E731
        log(f"pipeline mesh: data={pipe.size() // args.pipeline_parallel} "
            f"pipe={args.pipeline_parallel} (n_micro={GRAD_ACCUM})")

    def full_model():
        """The model with every stage's weights (all ranks call it
        together under the pipeline), and its optimizer."""
        if pipe is None:
            return model, optimizer
        return merge_pipeline(stage, optimizer, pipe, build)

    def feed(rows, *shape):
        """The rows drawn, as ``shape``; under multi-host this rank's data
        share of its node's rows (batch dim second to last)."""
        if not multihost:
            return torch.from_numpy(rows).to(device).view(*shape)
        return local_batch_to_global(mesh, rows.reshape(shape),
                                     batch_axis=len(shape) - 2)

    local_bs = (process_local_rows(args.batch_size) if multihost
                else args.batch_size)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t_start = time.time()
    train_stream = sampler.stream(
        "train", GRAD_ACCUM * local_bs, args.seq_len)
    for step in range(start_step, args.steps):
        loss = step_fn(feed(next(train_stream), GRAD_ACCUM, local_bs,
                            args.seq_len + 1))

        if step % 10 == 0 and is_main:
            loss = loss.item()
            toks = ((step - start_step + 1) * GRAD_ACCUM * args.batch_size
                    * args.seq_len)
            rate = toks / (time.time() - t_start)
            print(f"step {step}  loss {loss:.4f}  bpb {loss / np.log(2):.4f}"
                  f"  tok/s {rate:,.0f}", flush=True)

        if step % VALIDATE_EVERY == 0 and step > 0:
            vb = feed(sampler.sample("valid", local_bs, args.seq_len),
                      local_bs, args.seq_len + 1)
            with torch.no_grad():
                if not multihost:
                    vl = full_model()[0](vb, return_loss=True).item()
                else:   # the mean over the data ranks' shares
                    vl = _sum(model(vb.to_local(), return_loss=True),
                              mesh.get_group(DATA_AXIS)).item() / mesh.size(0)
            log(f"valid loss {vl:.4f}  valid bpb {vl / np.log(2):.4f}",
                flush=True)

        if (args.checkpoint_dir and step > 0
                and step % args.checkpoint_every == 0):
            if mesh is None:
                full, full_opt = full_model()
                if is_main:
                    save_checkpoint(args.checkpoint_dir, step, full,
                                    full_opt)
            else:
                # the full weights, gathered over the model axis
                unshard_opt_state(optimizer, model)
                unshard_params(model)
                if is_main:
                    save_checkpoint(args.checkpoint_dir, step, model,
                                    optimizer)
                shard_params(model, mesh)
                shard_opt_state(optimizer, model, mesh)
            log(f"checkpoint saved at step {step}", flush=True)

        # sampling is a data-dependent host loop: under tensor
        # parallelism and multi-host every rank would have to run it in
        # lockstep; under the pipeline rank 0 samples from the merged model
        if step % GENERATE_EVERY == 0 and step > 0 and mesh is None:
            prime = torch.from_numpy(
                sampler.sample("valid", 1, args.seq_len)[:, :128]).to(device)
            full = full_model()[0]
            if not is_main:
                continue
            out = generate(full, prime, GENERATE_LENGTH, generator=gen)
            print("prime:", decode_bytes(prime[0, -64:].tolist()))
            print("generated:", decode_bytes(out[0, :256].tolist()),
                  flush=True)
    if mesh is not None or pipe is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
