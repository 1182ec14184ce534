"""Speculative continuous-batching engine: per-slot draft + verify rounds.

Counterpart of ``flash_cosine_sim_attention_tpu/serving/spec_engine.py``:
every active slot advances by its OWN accepted-token count each round,
through the multi-slot round of ``models/speculative.py`` (``gamma`` draft
decode steps, then one batched verify pass of the target).

Layout mirrors ``InferenceEngine``: a fixed pool of slots, each backed by
TWO per-layer int8 KV caches (target and draft, kept at equal lengths),
bucketed prefill admission and host-mirrored positions.  A prompt is
prefilled straight into the slot's rows of both caches (views of the
buffers, as ``InferenceEngine`` does; JAX prefills a batch-1 state and
copies it in).  ``step_round()`` returns the ragged {slot: [accepted
tokens...]} of one round with one device->host copy; ``temperature=0``
emits each slot's target-greedy choices.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .._build import resolve_device
from ..models.decoding import init_decode_state, prefill
from ..models.speculative import (
    _softmax_probs,
    make_batched_speculative_decoder,
)
from .engine import _bucket, _padded, _set_slot, _slot_view, _true_len


class SpeculativeEngine:
    def __init__(
        self,
        target,
        draft,
        num_slots: int = 8,
        capacity: int = 2048,
        gamma: int = 4,
        temperature: float = 0.0,
        prompt_buckets: Tuple[int, ...] = (128, 256, 512, 1024),
        seed: int = 0,
        device=None,
    ):
        """Serve ``target`` with proposals from ``draft`` (both
        ``CosineSimCausalTransformer``s holding their weights; the same
        object for a self-draft) on ``device`` (default ``cuda``; raises
        when no card is present and the CPU was not asked for)."""
        self.device = resolve_device(device)
        for m in (target, draft):
            if m.device != self.device:
                raise ValueError(f"model lies on {m.device}, engine on "
                                 f"{self.device}")
        self.target, self.draft = target, draft
        self.num_slots = num_slots
        self.capacity = capacity
        self.gamma = gamma
        self.temperature = temperature
        self.buckets = tuple(b for b in prompt_buckets if b <= capacity)
        self.tstate = init_decode_state(target, num_slots, capacity,
                                        device=self.device)
        self.dstate = init_decode_state(draft, num_slots, capacity,
                                        device=self.device)
        self.active = np.zeros(num_slots, bool)
        self.host_pos = np.zeros(num_slots, np.int64)
        self._pending = torch.zeros(num_slots, dtype=torch.long,
                                    device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._round = make_batched_speculative_decoder(
            target, draft, gamma=gamma, temperature=temperature)

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if not self.active[i]]

    def add_request(self, prompt: np.ndarray) -> Tuple[int, int]:
        """Prefill ``prompt`` (1-D int array) into a free slot of both
        caches; returns (slot, first token, from the target's logits)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        slot = free[0]
        n = len(prompt)
        if n > self.capacity:
            raise ValueError(
                f"prompt length {n} exceeds capacity {self.capacity}")
        tokens = _padded(prompt, _bucket(n, self.buckets), self.device)
        true_len = _true_len(n, self.device)
        t_logits, _ = prefill(self.target, _slot_view(self.tstate, slot),
                              tokens, true_len=true_len)
        prefill(self.draft, _slot_view(self.dstate, slot), tokens,
                true_len=true_len)
        _set_slot(self.tstate, slot, n)
        _set_slot(self.dstate, slot, n)
        if self.temperature == 0.0:
            tok = t_logits.argmax(-1)
        else:
            tok = torch.multinomial(
                _softmax_probs(t_logits, self.temperature), 1,
                generator=self._gen)[:, 0]
        self._pending[slot] = tok[0]
        self.host_pos[slot] = n
        self.active[slot] = True
        return slot, int(tok[0])

    def step_round(self) -> Dict[int, List[int]]:
        """One speculative round for every active slot ->
        {slot: [accepted tokens...]} (1..gamma tokens a slot)."""
        if not self.active.any():
            return {}
        # active slots must fit a whole round: past capacity the append
        # would write past the buffer.  Inactive slots ride along too, but
        # their writes (at a clamped offset) touch only dead rows, which
        # add_request prefills anew, so a finished slot parked near
        # capacity must NOT wedge the engine
        over = [s for s in range(self.num_slots)
                if self.active[s]
                and self.host_pos[s] + self.gamma > self.capacity]
        if over:
            raise RuntimeError(
                f"slots {over} would exceed capacity {self.capacity} "
                f"within one round (gamma={self.gamma}); finish() them")
        active = torch.from_numpy(self.active.copy()).to(self.device)
        (self.tstate, self.dstate, self._pending, emitted,
         n_emitted) = self._round(self.tstate, self.dstate, self._pending,
                                  active, self._gen)
        # the ONE device->host copy of the round
        host = torch.cat([emitted, n_emitted[:, None]], 1).cpu().numpy()
        out = {}
        for s in range(self.num_slots):
            n = int(host[s, -1])
            if self.active[s] and n > 0:
                out[s] = [int(t) for t in host[s, :n]]
                self.host_pos[s] += n
        return out

    def finish(self, slot: int) -> None:
        self.active[slot] = False
