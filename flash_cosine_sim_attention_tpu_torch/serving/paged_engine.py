"""Continuous-batching engine over the PAGED quantized KV cache.

Counterpart of ``flash_cosine_sim_attention_tpu/serving/paged_engine.py``,
with the contiguous engine's interface (``engine.py``, whose host policy
it shares through ``SlotEngine``): all slots draw pages from one pool per
layer, so device memory scales with the tokens in flight.  A request holds
ceil(len / page_size) pages and returns them to the free list the moment
it finishes.

Host policy, device mechanism: the engine owns the ``PageAllocator`` and a
host mirror of the page table, grows a slot's pages before any prefill,
chunk or decode step writes there, and uploads the table (one tensor that
every layer shares) only when it changes.  The device functions only read
the table.  A finished slot's row goes back to the null page, so its
masked ride-along writes cannot reach pages reallocated to another
request.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.decoding import (
    decode_step_paged,
    init_paged_decode_state,
    prefill_continue_paged,
    prefill_paged,
)
from ..quant.paged import PageAllocator
from .engine import SlotEngine, _bucket, _padded, _true_len


class PagedInferenceEngine(SlotEngine):
    _decode_step = staticmethod(decode_step_paged)

    def __init__(
        self,
        model,
        num_slots: int = 8,
        page_size: int = 128,
        num_pages: int = 256,
        max_pages_per_slot: int = 16,
        reserve_tokens: int = 512,
        temperature: float = 1.0,
        filter_thres: float = 0.9,
        prompt_buckets: Tuple[int, ...] = (128, 256, 512, 1024),
        seed: int = 0,
        kv_dtype=torch.int8,
        device=None,
    ):
        """Serve ``model`` (a ``CosineSimCausalTransformer`` holding its
        weights) on ``device`` (default ``cuda``; raises when no card is
        present and the CPU was not asked for) from ``kv_dtype`` (int8 or
        float8_e4m3fn) page pools of ``num_pages`` pages (page 0 is the
        null page).  A prompt admitted in one shot reserves pages for
        ``reserve_tokens`` more tokens, as far as its slot's
        ``max_pages_per_slot`` pages allow."""
        super().__init__(model, num_slots, max_pages_per_slot * page_size,
                         temperature, filter_thres, prompt_buckets, seed,
                         device)
        self.page_size = page_size
        self.max_pages = max_pages_per_slot
        self.reserve_tokens = reserve_tokens
        self.state = init_paged_decode_state(
            model, num_slots, num_pages, page_size, max_pages_per_slot,
            kv_dtype=kv_dtype, device=self.device)
        self.allocator = PageAllocator(num_pages)
        self.slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self.table = np.zeros((num_slots, max_pages_per_slot), np.int32)

    # ------------------------------------------------------------------
    def _sync_table(self) -> None:
        """Upload the host table into the device table every layer shares;
        called only when the table changes."""
        self.state.caches[0].page_table.copy_(torch.from_numpy(self.table))

    def _ensure_pages(self, slot: int, tokens_needed: int) -> None:
        """Grow the slot's page run to cover ``tokens_needed`` tokens."""
        need = (tokens_needed + self.page_size - 1) // self.page_size
        have = len(self.slot_pages[slot])
        if need > self.max_pages:
            raise RuntimeError(f"slot {slot} exceeds max pages")
        if need > have:
            new = self.allocator.alloc(need - have)
            self.table[slot, have:need] = new
            self.slot_pages[slot].extend(new)
            self._sync_table()

    def _reset_slot(self, slot: int) -> None:
        """Positions of a newly admitted slot restart from zero, in every
        layer (engine-owned state, updated in place)."""
        for c in self.state.caches:
            c.length[slot] = 0
        self.state.pos[slot] = 0
        self.host_pos[slot] = 0
        self.table[slot, :] = 0
        self.slot_pages[slot] = []

    def add_request(self, prompt: np.ndarray,
                    chunk_tokens: Optional[int] = None) -> int:
        """Admit ``prompt`` (1-D int array) into a free slot; returns it.
        With ``chunk_tokens``, admission is chunked: the prompt streams in
        across ``step()`` calls while the other slots keep decoding."""
        slot = self._free_slot()
        n = len(prompt)
        if n > self.max_pages * self.page_size:
            raise ValueError(
                f"prompt length {n} exceeds slot capacity "
                f"{self.max_pages * self.page_size}")
        self._reset_slot(slot)
        if chunk_tokens is not None:
            self._queue_chunks(slot, np.asarray(prompt), chunk_tokens)
            self._sync_table()
            return slot

        width = _bucket(n, self.buckets)
        # the reserve is best-effort: capped at the slot's capacity, so a
        # prompt that fits is never refused for its reserve
        self._ensure_pages(slot, min(n + self.reserve_tokens,
                                     self.max_pages * self.page_size))
        logits, self.state = prefill_paged(
            self.model, self.state, slot, _padded(prompt, width, self.device),
            true_len=_true_len(n, self.device))
        self._land_chunk(slot, self._sample(logits), n, True)
        return slot

    def _run_chunk(self, slot: int, tokens: np.ndarray, n: int,
                   is_last: bool) -> None:
        width = _bucket(n, self.buckets)
        self._ensure_pages(slot, int(self.host_pos[slot]) + n)
        # a fresh slot's first chunk has no history: plain prefill
        fn = (prefill_paged
              if self.host_pos[slot] == 0 and not self.active[slot]
              else prefill_continue_paged)
        logits, self.state = fn(self.model, self.state, slot,
                                _padded(tokens, width, self.device),
                                true_len=_true_len(n, self.device))
        self._land_chunk(slot, self._sample(logits), n, is_last)

    def _make_room(self, decode_active: np.ndarray, n: int) -> None:
        # grow any slot about to cross a page boundary (host mirror: no
        # device fetch); inactive slots ride along on the null page
        for s in np.flatnonzero(decode_active):
            self._ensure_pages(int(s), int(self.host_pos[s]) + n)

    def finish(self, slot: int) -> None:
        """End the slot's request: its pages go back to the pool and its
        table row to the null page."""
        super().finish(slot)
        self.allocator.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.table[slot, :] = 0
        self._sync_table()

    def pages_in_use(self) -> int:
        return sum(len(p) for p in self.slot_pages)
