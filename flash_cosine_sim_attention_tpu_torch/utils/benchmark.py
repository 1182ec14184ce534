"""Timing harness and the naive baseline of the benchmark CLI.

Counterpart of ``flash_cosine_sim_attention_tpu/utils/benchmark.py``,
with its three modes:

  * forwards:            iterate fn
  * forwards+backwards:  iterate the gradients of sum(fn)
  * backwards only:      the forwards+backwards time minus the forwards

Each mode runs ``num_times`` iterations with a data dependence between
them, as JAX's loop has: the output (in backward mode its dQ, plus the
sums of the other gradients) becomes the next iteration's first argument.
On the card the iterations are timed with a pair of CUDA events after a
warm-up; on the CPU with ``time.perf_counter``.  JAX's two-point slope
cancels the latency of a remote-attached TPU; a local card needs none.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from ..ops.reference import l2norm_tensors


def _time_ms(step: Callable, x0: torch.Tensor, num_times: int,
             warmup: int) -> float:
    """Mean ms of one ``x = step(x)`` over ``num_times`` chained calls."""
    x = x0
    for _ in range(warmup):
        x = step(x)
    if x0.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(num_times):
            x = step(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / num_times
    t0 = time.perf_counter()
    for _ in range(num_times):
        x = step(x)
    float(x.float().sum())
    return (time.perf_counter() - t0) * 1e3 / num_times


def benchmark(
    fn: Callable,
    *args,
    forwards: bool = True,
    backwards: bool = False,
    num_times: int = 20,
    warmup: int = 2,
    grad_argnums: Sequence[int] = (0, 1, 2),
) -> float:
    """Mean ms per ``fn(*args)`` call in the requested mode."""
    rest = args[1:]

    def fwd_step(x):
        with torch.no_grad():
            return fn(x, *rest).to(x.dtype)

    def fwdbwd_step(x):
        leaves = [t.detach().requires_grad_(i in grad_argnums)
                  if t.is_floating_point() else t
                  for i, t in enumerate((x, *rest))]
        wrt = [leaves[i] for i in grad_argnums]
        grads = torch.autograd.grad(fn(*leaves).float().sum(), wrt)
        # every gradient feeds the next iteration, as in JAX's loop
        extra = sum(g.float().sum() for g in grads[1:])
        return (grads[0].float() + extra).to(x.dtype)

    if forwards and not backwards:
        return _time_ms(fwd_step, args[0], num_times, warmup)
    t_total = _time_ms(fwdbwd_step, args[0], num_times, warmup)
    if forwards:
        return t_total
    t_fwd = _time_ms(fwd_step, args[0], num_times, warmup)
    return max(t_total - t_fwd, 0.0)


def naive_cosine_sim_attention(q, k, v, mask=None, scale=8.0, causal=False):
    """The naive eager baseline: what a user writes without a fused kernel.
    l2norm, one logits matmul in the input dtype scaled in f32, the
    causal (col > row + j - i) and key masks, softmax in f32 cast back to
    the input dtype, then the product with v.  q, k, v (b, h, n, d)."""
    q, k = l2norm_tensors(q, k)
    s = (q @ k.transpose(-1, -2)).float() * scale
    mask_value = -torch.finfo(torch.float32).max
    if causal:
        i, j = s.shape[-2:]
        row = torch.arange(i, device=s.device)[:, None]
        col = torch.arange(j, device=s.device)[None, :]
        s = s.masked_fill(col > row + (j - i), mask_value)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], mask_value)
    return s.softmax(dim=-1).to(q.dtype) @ v


# the JAX package's name for the same baseline
xla_naive_cosine_sim_attention = naive_cosine_sim_attention
