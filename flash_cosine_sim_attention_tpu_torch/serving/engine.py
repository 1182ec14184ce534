"""Continuous-batching inference engine over the quantized-KV decode path.

Counterpart of ``flash_cosine_sim_attention_tpu/serving/engine.py``:

  * a fixed pool of batch slots, each with its own per-layer int8 (or
    e4m3) cache rows and position;
  * ``add_request`` prefills a prompt, right-padded to a length bucket
    (exact under causal attention), straight into a free slot's cache rows
    while the other slots keep their state; with ``chunk_tokens`` the
    prompt is instead admitted in chunks, one per ``step()``, through the
    continuation prefill, so a long prompt never stalls the batch;
  * ``step`` advances every active slot one token (inactive and
    mid-prefill slots ride along masked).

The port runs eagerly: no jit, and ``step_many`` is a Python loop.
Positions are mirrored on the host so the capacity guards need no device
fetch; the last-token vector and the sampling generator live on the
device, so a steady-state ``step()`` makes exactly one device->host copy,
the sampled tokens.  Sampling is top-k filter -> softmax(logits /
temperature) -> ``torch.multinomial`` with the engine's own generator.
``SlotEngine`` holds the host policy this engine shares with the paged
one (``paged_engine.py``).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._build import resolve_device
from ..models.decoding import (
    DecodeState,
    decode_step,
    init_decode_state,
    prefill,
    prefill_continue,
)
from ..models.transformer import top_k_filter
from ..parallel import DATA_AXIS, MODEL_AXIS, shard_params
from ..parallel.mesh import axis_size
from ..utils.profiling import recording, span


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def _padded(tokens: np.ndarray, width: int, device) -> torch.Tensor:
    """``tokens`` as a (1, width) batch, right-padded with 0."""
    padded = np.zeros((1, width), np.int64)
    padded[0, :len(tokens)] = tokens
    return torch.from_numpy(padded).to(device)


def _true_len(n: int, device) -> torch.Tensor:
    return torch.tensor([n], dtype=torch.int32, device=device)


def _slot_view(state: DecodeState, slot: int) -> DecodeState:
    """``slot``'s cache rows as an empty batch-1 state (views of the
    buffers), so that a prefill writes straight into them."""
    return DecodeState(
        tuple(c._replace(k8=c.k8[slot:slot + 1], v8=c.v8[slot:slot + 1],
                         v_scale=c.v_scale[slot:slot + 1],
                         length=torch.zeros_like(c.length[:1]))
              for c in state.caches),
        torch.zeros_like(state.pos[:1]))


def _set_slot(state: DecodeState, slot: int, pos: int) -> None:
    """Set one slot's cache lengths and position, in place."""
    for c in state.caches:
        c.length[slot] = pos
    state.pos[slot] = pos


def _same_on_every_rank(tokens: torch.Tensor, mesh) -> None:
    """Raise unless ``tokens`` equal the model axis's rank 0's."""
    group = mesh.get_group(MODEL_AXIS)
    first = tokens.clone()
    dist.broadcast(first, src=dist.get_process_group_ranks(group)[0],
                   group=group)
    if not torch.equal(first, tokens):
        raise RuntimeError("tensor-parallel ranks sampled different tokens")


class SlotEngine:
    """Host policy shared by the contiguous and the paged engine: slot
    flags, the host mirror of positions, sampling with the engine's own
    generator, the FIFO of pending prefill chunks, ``step``,
    ``continue_request`` and ``generate``.  A subclass owns the device
    state and supplies ``add_request``, ``_run_chunk``, ``_make_room``
    (what must hold before ``n`` more decode steps) and ``_decode_step``
    (its cache's decode function)."""

    def __init__(self, model, num_slots: int, max_tokens: int,
                 temperature: float, filter_thres: float,
                 prompt_buckets: Tuple[int, ...], seed: int, device):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lies on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.num_slots = num_slots
        self.buckets = tuple(b for b in prompt_buckets if b <= max_tokens)
        self.temperature = temperature
        self.filter_thres = filter_thres
        self.active = np.zeros(num_slots, bool)
        self.prefilling = np.zeros(num_slots, bool)
        self.host_pos = np.zeros(num_slots, np.int64)  # device-pos mirror
        self.last_token = np.zeros(num_slots, np.int32)
        self._last_dev = torch.zeros(num_slots, dtype=torch.long,
                                     device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # pending prefill chunks: (slot, tokens, true_len, is_last) FIFO
        self._pending: Deque[Tuple[int, np.ndarray, int, bool]] = deque()

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        with span("engine.sample"):
            filtered = top_k_filter(logits.float(), self.filter_thres)
            probs = torch.softmax(filtered / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots)
                if not (self.active[i] or self.prefilling[i])]

    def _free_slot(self) -> int:
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        return free[0]

    def _queue_chunks(self, slot: int, prompt: np.ndarray,
                      chunk_tokens: int) -> None:
        """Reserve ``slot`` for a chunked admission: the prompt streams in
        across the following ``step()`` calls, one chunk each."""
        _bucket(min(len(prompt), chunk_tokens), self.buckets)  # validate early
        self.host_pos[slot] = 0
        self.prefilling[slot] = True
        n = len(prompt)
        for start in range(0, n, chunk_tokens):
            piece = prompt[start:start + chunk_tokens]
            self._pending.append(
                (slot, np.asarray(piece, np.int32), len(piece),
                 start + chunk_tokens >= n))

    def _land_chunk(self, slot: int, tok: torch.Tensor, n: int,
                    is_last: bool) -> None:
        """Host bookkeeping after a prefill chunk sampled ``tok``."""
        self._last_dev[slot] = tok[0]
        self.host_pos[slot] += n
        if is_last:
            self.last_token[slot] = int(tok[0])
            self.prefilling[slot] = False
            self.active[slot] = True

    def _decode(self, active: torch.Tensor) -> torch.Tensor:
        logits, self.state = self._decode_step(self.model, self.state,
                                               self._last_dev, active)
        # inactive / mid-prefill slots keep their last token
        self._last_dev = torch.where(active, self._sample(logits),
                                     self._last_dev)
        return self._last_dev

    def continue_request(self, slot: int, new_tokens: np.ndarray) -> int:
        """Multi-turn: extend an ACTIVE slot's context with a new chunk of
        prompt tokens in one prefill pass.  Returns the token sampled
        after the chunk."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        self._run_chunk(slot, np.asarray(new_tokens, np.int32),
                        len(new_tokens), True)
        return int(self.last_token[slot])

    def step(self) -> Dict[int, int]:
        """One step: lands ONE pending prefill chunk (if any), then decodes
        every active slot -> {slot: token}."""
        # snapshot BEFORE landing a chunk: a slot that finishes its
        # prefill this step starts decoding next step
        decode_active = self.active & ~self.prefilling
        # counted only while a profiler records: the slots decoding, the
        # tokens they attend (the new ones included), a chunk landing
        counts = {}
        if recording():
            slots = int(decode_active.sum())
            counts = dict(slots=slots, chunk=bool(self._pending),
                          live=int(self.host_pos[decode_active].sum()) + slots)
        with span("engine.step", **counts):
            if self._pending:
                self._run_chunk(*self._pending.popleft())
            if not decode_active.any():
                return {}
            self._make_room(decode_active, 1)
            toks = self._decode(
                torch.from_numpy(decode_active).to(self.device))
            self.host_pos[decode_active] += 1
            with span("engine.sync"):
                toks = toks.cpu()                   # the ONE copy
            self.last_token = toks.numpy().astype(np.int32)
            return {i: int(self.last_token[i])
                    for i in range(self.num_slots) if decode_active[i]}

    def finish(self, slot: int) -> None:
        self.active[slot] = False
        if self.prefilling[slot]:
            self.prefilling[slot] = False
            self._pending = deque(
                p for p in self._pending if p[0] != slot)

    def generate(self, prompt: np.ndarray, max_tokens: int) -> List[int]:
        """Convenience single-request path (prefill token + decode steps)."""
        slot = self.add_request(prompt)
        out = [int(self.last_token[slot])]
        for _ in range(max_tokens - 1):
            out.append(self.step()[slot])
        self.finish(slot)
        return out


class InferenceEngine(SlotEngine):
    def __init__(
        self,
        model,
        num_slots: int = 8,
        capacity: int = 2048,
        temperature: float = 1.0,
        filter_thres: float = 0.9,
        prompt_buckets: Tuple[int, ...] = (128, 256, 512, 1024),
        seed: int = 0,
        kv_dtype=torch.int8,
        mesh=None,
        device=None,
    ):
        """Serve ``model`` (a ``CosineSimCausalTransformer`` holding its
        weights) on ``device`` (default ``cuda``; raises when no card is
        present and the CPU was not asked for) from ``kv_dtype`` caches
        (int8 or float8_e4m3fn).

        ``mesh`` enables serving tensor parallelism: use a (data 1, model
        N) mesh, as in JAX (prefill runs one request at a time), with one
        engine on every rank, each fed the same requests.  The model is
        sharded over it in place (``parallel.shard_params``) unless it is
        already; every rank's caches hold its local KV heads and attention
        runs on its local heads.  The logits after the last all-reduce are
        the same on every rank, so every rank's generator, seeded alike,
        samples the same tokens; under ``__debug__`` the first decode step
        checks that against rank 0's tokens."""
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh "
                                f"(parallel.make_mesh), not {type(mesh)}")
            if axis_size(mesh, DATA_AXIS) != 1:
                raise ValueError("serving tensor parallelism takes a (data "
                                 "1, model N) mesh")
            if model.mesh is None:
                shard_params(model, mesh)
            elif model.mesh is not mesh:
                raise ValueError("the model is sharded over another mesh")
        self.mesh = mesh
        self._check_ranks = mesh is not None and __debug__
        super().__init__(model, num_slots, capacity, temperature,
                         filter_thres, prompt_buckets, seed, device)
        self.capacity = capacity
        self.state = init_decode_state(model, num_slots, capacity,
                                       device=self.device, kv_dtype=kv_dtype)

    def _decode_step(self, model, state, last, active):
        return decode_step(model, state, last, mesh=self.mesh, active=active)

    def _decode(self, active: torch.Tensor) -> torch.Tensor:
        toks = super()._decode(active)
        if self._check_ranks:
            self._check_ranks = False
            _same_on_every_rank(toks, self.mesh)
        return toks

    def add_request(self, prompt: np.ndarray,
                    chunk_tokens: Optional[int] = None) -> int:
        """Prefill ``prompt`` (1-D int array) into a free slot; returns it.

        With ``chunk_tokens`` set, admission is CHUNKED: the slot is
        reserved now and the prompt streams in across the following
        ``step()`` calls (one chunk each) while the other slots keep
        decoding; the slot turns active when its last chunk lands.
        """
        slot = self._free_slot()
        n = len(prompt)
        if n > self.capacity:
            raise ValueError(
                f"prompt length {n} exceeds capacity {self.capacity}")

        if chunk_tokens is not None:
            self._queue_chunks(slot, np.asarray(prompt), chunk_tokens)
            _set_slot(self.state, slot, 0)
            return slot

        width = _bucket(n, self.buckets)
        with span("engine.add_request", slot=slot, rows=n, width=width):
            logits, _ = prefill(self.model, _slot_view(self.state, slot),
                                _padded(prompt, width, self.device),
                                true_len=_true_len(n, self.device),
                                mesh=self.mesh)
            _set_slot(self.state, slot, n)
            self.host_pos[slot] = 0
            self._land_chunk(slot, self._sample(logits), n, True)
        return slot

    def _run_chunk(self, slot: int, tokens: np.ndarray, n: int,
                   is_last: bool) -> None:
        width = _bucket(n, self.buckets)
        # guard on the PADDED width: the whole bucket-padded chunk is written
        if self.host_pos[slot] + width > self.capacity:
            raise RuntimeError(
                f"slot {slot}: prefill chunk (bucket-padded to {width}) "
                f"would exceed capacity {self.capacity}")
        logits, self.state = prefill_continue(
            self.model, self.state, slot,
            _padded(tokens, width, self.device),
            true_len=_true_len(n, self.device))
        self._land_chunk(slot, self._sample(logits), n, is_last)

    def _make_room(self, decode_active: np.ndarray, n: int) -> None:
        # a slot at capacity must not decode further: its append would
        # write past the buffer.  host_pos mirror: no device fetch.
        over = [s for s in range(self.num_slots)
                if decode_active[s] and self.host_pos[s] + n > self.capacity]
        if over:
            raise RuntimeError(
                f"slots {over} would exceed cache capacity {self.capacity} "
                f"within {n} steps; finish() them first")

    def step_many(self, n: int) -> Dict[int, List[int]]:
        """Advance every active slot ``n`` tokens -> {slot: [tokens...]},
        with one device->host copy at the end.  Token streams equal those
        of n ``step()`` calls.  Pending prefill chunks are NOT landed."""
        decode_active = self.active & ~self.prefilling
        if not decode_active.any():
            return {}
        self._make_room(decode_active, n)
        active = torch.from_numpy(decode_active).to(self.device)
        toks = torch.stack([self._decode(active) for _ in range(n)])
        self.host_pos[decode_active] += n
        toks = toks.cpu().numpy().astype(np.int32)  # (n, slots): the ONE copy
        self.last_token = toks[-1].copy()
        return {s: [int(t) for t in toks[:, s]]
                for s in range(self.num_slots) if decode_active[s]}
