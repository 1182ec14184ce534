"""Cached autoregressive decoding: prefill + INT8-KV decode steps.

Counterpart of ``flash_cosine_sim_attention_tpu/models/decoding.py``:

  * ``prefill`` runs the prompt through the fused forward kernel and fills
    the per-layer int8 caches;
  * ``decode_step`` feeds one token per slot; each layer attends its new
    query against its cache through the decode kernel;
  * ``prefill_continue`` runs a new chunk for a slot that already has
    history (multi-turn, chunked admission): the chunk attends the
    dequantized history (key-masked) and itself (causal), and the two
    partials merge by their row sums, which the no-row-max exp convention
    makes a plain sum.

The parameters live in the model, so these functions take no ``params``.
They run eagerly under ``torch.no_grad`` and write the cache buffers in
place (see ``quant/kv_cache.py``); the returned ``DecodeState`` carries
the new lengths and positions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._build import resolve_device
from ..ops import flash_attention_forward, flash_cosine_sim_attention
from ..quant import (
    QuantKVCache,
    append,
    dequantize_k,
    dequantize_v,
    init_cache,
    quantized_decode_attention,
)
from .transformer import CosineSimCausalTransformer


class DecodeState(NamedTuple):
    caches: Tuple[QuantKVCache, ...]   # one per layer
    pos: torch.Tensor                  # (b,) int32 tokens consumed per slot


def init_decode_state(model: CosineSimCausalTransformer, batch: int,
                      capacity: int, device=None) -> DecodeState:
    """Empty caches for ``batch`` slots on ``device`` (default ``cuda``;
    raises when no card is present and the CPU was not asked for)."""
    device = resolve_device(device)
    caches = tuple(
        init_cache(batch, model.kv_heads, capacity, model.dim_head, device)
        for _ in range(model.depth))
    return DecodeState(caches, torch.zeros(batch, dtype=torch.int32,
                                           device=device))


def _last_real(logits: torch.Tensor, true_len: Optional[torch.Tensor]):
    if true_len is None:
        return logits[:, -1]
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, true_len.long() - 1]


@torch.no_grad()
def prefill(model: CosineSimCausalTransformer, state: DecodeState,
            tokens: torch.Tensor, true_len: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Run the prompt (b, n) through full fused attention, filling the
    caches from empty.  Returns (logits of the last REAL prompt token,
    new state).  ``true_len`` ((b,), optional) supports right-padded,
    length-bucketed prompts: causal attention never attends positions to
    the right, and the cache lengths are cut to the true lengths so later
    steps never attend the pads."""
    caches = list(state.caches)

    def attn(layer, q, k, v):
        caches[layer] = append(caches[layer], k, v)
        return flash_cosine_sim_attention(
            q, k, v, causal=True, scale=model.attn_scale, l2norm_qk=False)

    logits = model.trunk(model.embed(tokens, state.pos), attn)
    if true_len is None:
        new_pos = state.pos + tokens.shape[1]
    else:
        new_pos = state.pos + true_len.to(torch.int32)
        caches = [c._replace(length=new_pos) for c in caches]
    return _last_real(logits, true_len), DecodeState(tuple(caches), new_pos)


@torch.no_grad()
def decode_step(model: CosineSimCausalTransformer, state: DecodeState,
                token: torch.Tensor, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step: (b,) tokens in, (b, vocab) logits out.  ``active``
    ((b,) bool, optional) freezes inactive slots' caches and positions, so
    slots mid-prefill or finished ride along."""
    caches = list(state.caches)

    def attn(layer, q, k, v):
        caches[layer] = append(caches[layer], k, v, active=active)
        return quantized_decode_attention(
            q, caches[layer], scale=model.attn_scale, l2norm_qk=False)

    logits = model.trunk(model.embed(token[:, None], state.pos), attn)
    step = 1 if active is None else active.to(torch.int32)
    return logits[:, 0], DecodeState(tuple(caches), state.pos + step)


@torch.no_grad()
def prefill_continue(model: CosineSimCausalTransformer, state: DecodeState,
                     slot: int, tokens: torch.Tensor,
                     true_len: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, DecodeState]:
    """Continuation prefill of a (1, t) chunk, optionally right-padded with
    ``true_len`` ((1,)), for ``slot``, which may already hold history.
    Returns (last real token's logits (1, vocab), new state)."""
    caches = list(state.caches)
    pos0 = state.pos[slot:slot + 1]
    n_new = (torch.full((1,), tokens.shape[1], dtype=torch.int32,
                        device=tokens.device)
             if true_len is None else true_len.to(torch.int32))

    def attn(layer, q, k, v):
        c = caches[layer]
        view = QuantKVCache(c.k8[slot:slot + 1], c.v8[slot:slot + 1],
                            c.v_scale[slot:slot + 1], c.length[slot:slot + 1])
        hist_len = view.length
        # chunk vs itself: causal
        o_new, inv_new = flash_attention_forward(
            q, k, v, None, None, bias_batch_dim=False,
            scale=model.attn_scale, causal=True)
        # chunk vs the dequantized history: key-masked, non-causal
        keep = (torch.arange(view.capacity, device=q.device)[None, :]
                < hist_len[:, None])
        o_hist, inv_hist = flash_attention_forward(
            q, dequantize_k(view.k8, q.dtype),
            dequantize_v(view.v8, view.v_scale, q.dtype), keep, None,
            bias_batch_dim=False, scale=model.attn_scale, causal=False)
        # merge the partials by plain sums of their row sums
        l_new, l_hist = 1.0 / inv_new, 1.0 / inv_hist
        o = ((o_new.float() * l_new + o_hist.float() * l_hist)
             / (l_new + l_hist).clamp_min(1e-10))
        # write the whole (padded) chunk; the corrected length excludes pads
        append(view, k, v)
        length = c.length.clone()
        length[slot:slot + 1] = hist_len + n_new
        caches[layer] = c._replace(length=length)
        return o.to(q.dtype)

    logits = model.trunk(model.embed(tokens, pos0), attn)
    pos = state.pos.clone()
    pos[slot:slot + 1] = pos0 + n_new
    return _last_real(logits, true_len), DecodeState(tuple(caches), pos)
