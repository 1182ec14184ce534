"""Checkpoint / resume with ``torch.save``.

Counterpart of ``flash_cosine_sim_attention_tpu/utils/checkpoint.py``
(orbax there): a checkpoint holds the step, the model's ``state_dict``
and the optimizer's; the latest ``max_to_keep`` stay on disk and restore
takes the latest, onto the model's device.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step}.pt")


def save_checkpoint(ckpt_dir: str, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    max_to_keep: int = 3) -> None:
    """Write step ``step`` (atomically), then drop all but the latest
    ``max_to_keep`` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = _path(ckpt_dir, step) + ".tmp"
    torch.save({"step": step, "model": model.state_dict(),
                "optimizer": optimizer.state_dict()}, tmp)
    os.replace(tmp, _path(ckpt_dir, step))
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))


def restore_checkpoint(ckpt_dir: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> Optional[int]:
    """Load the latest checkpoint into ``model`` and ``optimizer`` in
    place and return its step; None (and nothing loaded) if there is
    none."""
    steps = _steps(ckpt_dir)
    if not steps:
        return None
    device = next(model.parameters()).device
    state = torch.load(_path(ckpt_dir, steps[-1]), map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return state["step"]
