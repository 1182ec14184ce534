"""enwik8 char-LM training driver for the PyTorch port.

Counterpart of the repository's ``train.py`` (the JAX trainer) with its
constants, CLI and schedule: batch 4, grad-accum 4, Adam lr 2e-4 after a
global-norm clip at 0.5, validate every 100 steps, generate every 500,
model dim 512 / depth 8 / attn scale 1 with 8 l2norm groups, pre-norm,
bf16 compute with float32 parameters.  If ``data/enwik8.gz`` is absent a
deterministic synthetic byte corpus stands in, as in the JAX trainer.
Runs on ``cuda`` unless ``--device cpu`` is given.

Usage:
  python -m flash_cosine_sim_attention_tpu_torch.train --seq-len 1024 \\
      --steps 1000 [--use-float32] [--no-fused] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterable

import numpy as np
import torch

from ._build import resolve_device
from .data import TextSampler, synthetic_corpus
from .models import CosineSimCausalTransformer, generate
from .utils import restore_checkpoint, save_checkpoint

# the JAX trainer's constants (train.py:40-45)
BATCH_SIZE = 4
GRAD_ACCUM = 4
LEARNING_RATE = 2e-4
MAX_GRAD_NORM = 0.5
VALIDATE_EVERY = 100
GENERATE_EVERY = 500
GENERATE_LENGTH = 512


def make_sampler(path="data/enwik8.gz", seed=0) -> TextSampler:
    """enwik8 90M/5M split through the native sampler; the deterministic
    synthetic corpus (written once to data/synthetic.raw, the JAX
    trainer's file) when enwik8 is absent."""
    if not os.path.exists(path):
        synth = "data/synthetic.raw"
        if not os.path.exists(synth):
            print("data/enwik8.gz not found - generating deterministic "
                  "synthetic byte corpus (drop enwik8.gz into data/ for the "
                  "real benchmark)")
            os.makedirs("data", exist_ok=True)
            with open(synth, "wb") as f:
                f.write(synthetic_corpus().tobytes())
        path = synth
    sampler = TextSampler(path, train_frac=90 / 95, seed=seed)
    print(f"data: {path}  loader backend: {sampler.backend}  "
          f"bytes: {sampler.size:,}")
    return sampler


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
    optimizer.zero_grad(set_to_none=True)
    losses = []
    for batch in batches:
        loss = model(batch, return_loss=True)
        loss.backward()
        losses.append(loss.detach())
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
                    help="not ported: tensor parallelism")
    ap.add_argument("--pipeline-parallel", type=int, default=0,
                    help="not ported: GPipe pipeline")
    ap.add_argument("--coordinator", type=str, default="",
                    help="not ported: multi-host coordinator address")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="not ported: multi-host process count")
    ap.add_argument("--process-id", type=int, default=-1,
                    help="not ported: multi-host process id")
    args = ap.parse_args(argv)
    if (args.model_parallel > 1 or args.pipeline_parallel > 1
            or args.coordinator or args.num_processes > 1
            or args.process_id >= 0):
        raise NotImplementedError(
            "model, pipeline and multi-host parallelism are not ported to "
            "the PyTorch package yet")

    device = resolve_device(args.device)
    dtype = torch.float32 if args.use_float32 else torch.bfloat16
    torch.manual_seed(args.seed)
    model = CosineSimCausalTransformer(
        num_tokens=256, dim=args.dim, depth=args.depth,
        max_seq_len=args.seq_len, attn_scale=1.0, attn_l2norm_groups=8,
        use_fused=not args.no_fused, pre_norm=True, dtype=dtype,
        device=device)
    sampler = make_sampler(seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.1f}M  dtype: {str(dtype)[6:]}  "
          f"fused: {not args.no_fused}  device: {device}")
    optimizer = make_optimizer(model)

    start_step = 0
    if args.checkpoint_dir:
        ck_step = restore_checkpoint(args.checkpoint_dir, model, optimizer)
        if ck_step is not None:
            start_step = ck_step + 1
            print(f"resumed from step {ck_step}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    t_start = time.time()
    train_stream = sampler.stream(
        "train", GRAD_ACCUM * args.batch_size, args.seq_len)
    for step in range(start_step, args.steps):
        batches = torch.from_numpy(next(train_stream)).to(device).view(
            GRAD_ACCUM, args.batch_size, args.seq_len + 1)
        loss = train_step(model, optimizer, batches)

        if step % 10 == 0:
            loss = loss.item()
            toks = ((step - start_step + 1) * GRAD_ACCUM * args.batch_size
                    * args.seq_len)
            rate = toks / (time.time() - t_start)
            print(f"step {step}  loss {loss:.4f}  bpb {loss / np.log(2):.4f}"
                  f"  tok/s {rate:,.0f}", flush=True)

        if step % VALIDATE_EVERY == 0 and step > 0:
            vb = torch.from_numpy(sampler.sample(
                "valid", args.batch_size, args.seq_len)).to(device)
            with torch.no_grad():
                vl = model(vb, return_loss=True).item()
            print(f"valid loss {vl:.4f}  valid bpb {vl / np.log(2):.4f}",
                  flush=True)

        if (args.checkpoint_dir and step > 0
                and step % args.checkpoint_every == 0):
            save_checkpoint(args.checkpoint_dir, step, model, optimizer)
            print(f"checkpoint saved at step {step}", flush=True)

        if step % GENERATE_EVERY == 0 and step > 0:
            prime = torch.from_numpy(
                sampler.sample("valid", 1, args.seq_len)[:, :128]).to(device)
            out = generate(model, prime, GENERATE_LENGTH, generator=gen)
            print("prime:", decode_bytes(prime[0, -64:].tolist()))
            print("generated:", decode_bytes(out[0, :256].tolist()),
                  flush=True)


if __name__ == "__main__":
    main()
