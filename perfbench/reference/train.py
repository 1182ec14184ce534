"""The reference training step: the loss and gradients of the model
family's reference (``loss``) over every microbatch, their mean, a clip
by global norm and Adam, all in plain float32 PyTorch.  Rows are taken
one at a time, so a 16384-token row's activations are all that is
held."""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from . import model as ref


def steps(loss: Callable, cfg: dict, opt: dict, W0: Dict[str, torch.Tensor],
          batches: List[torch.Tensor], rnd=ref.identity,
          half_batch: bool = False) -> dict:
    """Run ``len(batches)`` optimizer steps from the float32 leaves ``W0``
    on batches (micro, b, n + 1); ``loss(W, cfg, tokens, rnd)`` is the
    family's reference loss.  Returns each step's mean loss, each
    leaf's norm of the first step's clipped gradient (``grads``) and of
    its change over all the steps (``changes``).  ``half_batch`` plants
    a fault: each microbatch's second half of rows left out, the mean
    taken over the rest."""
    names = list(W0)
    W = {n: W0[n].detach().clone().requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(W0[n]) for n in names}
    v = {n: torch.zeros_like(W0[n]) for n in names}
    b1, b2 = opt["betas"]
    losses, grads = [], None
    for t, batch in enumerate(batches, 1):
        g = {n: torch.zeros_like(W0[n]) for n in names}
        micro_losses = []
        for micro in batch:
            rows = micro[:micro.shape[0] // 2] if half_batch else micro
            total = 0.0
            for r in range(rows.shape[0]):
                l = loss(W, cfg, rows[r:r + 1], rnd) / rows.shape[0]
                for n, gr in zip(names, torch.autograd.grad(
                        l, [W[n] for n in names])):
                    g[n] += gr
                total += l.item()
            micro_losses.append(total)
        losses.append(sum(micro_losses) / len(batch))
        with torch.no_grad():
            for n in names:
                g[n] /= len(batch)
            norm = torch.sqrt(sum(g[n].square().sum() for n in names))
            if norm >= opt["clip_global_norm"]:
                for n in names:
                    g[n] = g[n] / norm * opt["clip_global_norm"]
            if t == 1:
                grads = {n: g[n].norm().item() for n in names}
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            for n in names:
                m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                denom = v[n].sqrt() / math.sqrt(bc2) + opt["eps"]
                W[n].addcdiv_(m[n], denom, value=-opt["lr"] / bc1)
    changes = {n: (W[n].detach() - W0[n]).norm().item() for n in names}
    return {"losses": losses, "grads": grads, "changes": changes}
