"""Training cells: ``train.train_step`` back to back on batches drawn from
the seed.

Set-up builds the model and Adam once, with the benchmark's weights, and
drives that same pair through its first three steps by the window's own
call and feed; those steps warm every shape.  Their losses, the first
step's clipped gradient (read back from Adam's first moment) and the
leaves' change over the three are what the reference is held to once the
window has closed.  The window then runs the same pair on.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench import core, generator
from perfbench import trace as tracing
from perfbench.reference import compare
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train

HELD_STEPS = 3


def build(cfg: dict, mix: dict, seed: int, device):
    """The model with the benchmark's weights, and the trainer's Adam."""
    from flash_cosine_sim_attention_tpu_torch import train as port_train

    model = core.arch(cfg).build(cfg, mix["seq_len"], seed, device,
                                 serving=False)
    return model, port_train.make_optimizer(model)


def first_steps(model, optimizer, batches, cfg, steps=HELD_STEPS):
    """Drive the pair through its first steps; returns what the reference
    is held to: the losses, the first clipped gradient's leaf norms and
    the leaves' change norms."""
    from flash_cosine_sim_attention_tpu_torch import train as port_train

    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    b1 = cfg["optimizer"]["betas"][0]
    losses, grads = [], None
    for t in range(steps):
        losses.append(port_train.train_step(model, optimizer,
                                            batches.next()).item())
        if t == 0:   # Adam's first moment after one step is (1 - b1) g
            grads = {n: first_moment(optimizer, p) / (1 - b1)
                     for n, p in model.named_parameters()}
    changes = {n: (p.detach() - start[n]).norm().item()
               for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads, "changes": changes}


def first_moment(optimizer, p) -> float:
    """The norm of Adam's first moment of leaf ``p``; 0 where the step
    left it no state."""
    state = optimizer.state.get(p, {})
    return state["exp_avg"].norm().item() if "exp_avg" in state else 0.0


def reference(cfg, mix, seed, device, rnd=ref.identity, half_batch=False,
              steps=HELD_STEPS):
    """The reference's readings over the same weights and batches."""
    arch = core.arch(cfg)
    W0 = arch.reference_weights(cfg, mix["seq_len"], generator.derive_seed(
        seed, "weights"), device, serving=False)
    feed = generator.Batches(mix, seed, cfg["num_tokens"], device)
    batches = [feed.next() for _ in range(steps)]
    with ref.exact_matmuls():
        return ref_train.steps(arch.reference_loss, cfg, cfg["optimizer"],
                               W0, batches, rnd, half_batch)


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> core.Outcome:
    from flash_cosine_sim_attention_tpu_torch import train as port_train

    cfg, mix = cell.config, cell.traffic
    arch = core.arch(cfg)
    log(f"set-up: program imported at {time.perf_counter() - t_start:.1f} s")
    model, optimizer = build(cfg, mix, generator.derive_seed(seed, "weights"),
                             device)
    feed = generator.Batches(mix, seed, cfg["num_tokens"], device)
    prog = first_steps(model, optimizer, feed, cfg)
    log(f"set-up: {HELD_STEPS} steps at {time.perf_counter() - t_start:.1f} s")
    spans = core.Spans()

    def step(sync=False):
        with spans.span("train_step"):
            losses.append(port_train.train_step(model, optimizer, feed.next()))
            if sync:    # the traced window's range holds the whole step
                torch.cuda.synchronize()

    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() < t0 + seconds:
        step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum().item())
    work = {"model_flops": n_steps * arch.train_step_flops(
                cfg, mix["batch"], mix["seq_len"], mix["grad_accum"]),
            "steps": n_steps}
    context = None
    if trace:
        spans.profiling = True

        def traced():
            for _ in range(mix["profile_steps"]):
                step(sync=True)
        prof = tracing.profile_window(traced, arch.COUNTED, log=log)
        spans.profiling = False
        context = core.Context(cell, spans, (t0, t1), work, *prof)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del model, optimizer, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = compare.train_numbers(prog, reference(cfg, mix, seed, device))
    log(f"reference: {HELD_STEPS} steps held in {time.perf_counter() - t:.1f} s")
    limits = cell.check["limits"]
    return core.Outcome(
        metrics={"train_tokens_per_s": n_steps * feed.tokens / (t1 - t0),
                 "setup_s": setup_s},
        checks={k: (numbers[k], limits[k]) for k in limits},
        attempted=n_steps, failed=failed, memory_peak_bytes=peak,
        context=context)
