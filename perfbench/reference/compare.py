"""The numbers that decide ``correct``, each the gap between what the
program produced and what the reference gives."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable

import torch

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam: its change is not compared
STILL_LEAF = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Iterable[str]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``: the largest gap of a step's loss (nats);
    ``grad_gap``: of the first gradient's leaf norms; ``change_gap``: of
    the leaves' change over the steps, still leaves left out."""
    loss_gap = max(abs(p - r) for p, r in zip(prog["losses"], ref["losses"]))
    grads = ref["grads"]
    med = statistics.median(grads.values())
    moving = [n for n in grads if grads[n] >= STILL_LEAF * med]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grads"], grads, grads),
            "change_gap": leaf_gap(prog["changes"], ref["changes"], moving)}


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each served token's reference logit lies below the
    reference's best at its position: ref_logits (m, vocab), tokens (m,)."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens[:, None].long())[:, 0]
