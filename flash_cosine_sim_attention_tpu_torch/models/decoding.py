"""Cached autoregressive decoding: prefill + quantized-KV decode steps.

Counterpart of ``flash_cosine_sim_attention_tpu/models/decoding.py``:

  * ``prefill`` runs the prompt through the fused forward kernel and fills
    the per-layer int8 (or e4m3) caches;
  * ``decode_step`` feeds one token per slot; each layer attends its new
    query against its cache through the decode kernel;
  * ``prefill_continue`` runs a new chunk for a slot that already has
    history (multi-turn, chunked admission): the chunk attends the
    dequantized history (key-masked) and itself (causal), and the two
    partials merge by their row sums, which the no-row-max exp convention
    makes a plain sum;
  * ``prefill_paged``, ``decode_step_paged`` and ``prefill_continue_paged``
    do the same over per-layer page pools shared by all slots
    (``quant/paged.py``), through the paged decode kernel;
  * ``generate_cached`` samples top-k through ``prefill`` and
    ``decode_step`` (``models/speculative.py`` builds on the same pieces);
  * ``quantize_params`` turns every dense layer into an int8 one
    (``QuantDense``, ``quant/weights.py``), and ``fuse_qkv_params`` fuses
    each layer's q/k/v projections into one, plain or int8; all of the
    above serve the fused, quantized model unchanged.

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
from ..parallel.sharded_attention import head_sharded_flash_attention_local
from ..parallel.sharded_decode import (
    head_sharded_decode_attention_local,
    local_kv_heads,
)
from ..quant import (
    PagedKVCache,
    QuantKVCache,
    append,
    append_paged,
    dequantize_k,
    dequantize_v,
    gather_pages,
    init_cache,
    init_paged_cache,
    paged_decode_attention,
    quantized_decode_attention,
)
from ..utils.profiling import span
from .transformer import (
    CosineSimCausalTransformer,
    Dense,
    QuantDense,
    top_k_filter,
)


class DecodeState(NamedTuple):
    caches: Tuple[QuantKVCache, ...]   # one per layer
    pos: torch.Tensor                  # (b,) int32 tokens consumed per slot


class PagedDecodeState(NamedTuple):
    caches: Tuple[PagedKVCache, ...]   # one per layer (shared page pools)
    pos: torch.Tensor                  # (num_slots,) int32


@torch.no_grad()
def quantize_params(model: CosineSimCausalTransformer
                    ) -> CosineSimCausalTransformer:
    """Replace every ``Dense`` of ``model`` (``to_logits`` included, as JAX
    quantizes every 2-D kernel) by a ``QuantDense`` holding its int8 codes
    and scales (``quant/weights.py``); embeddings and LayerNorms stay.
    Counterpart of JAX's ``quant.weights.quantize_params``, on the model
    since the port keeps parameters in modules.  In place, dropping the
    full-precision weights; returns ``model``."""
    targets = [(parent, name, child)
               for parent in model.modules()
               for name, child in parent.named_children()
               if isinstance(child, Dense)]
    for parent, name, child in targets:
        setattr(parent, name, QuantDense.from_dense(child))
    return model


@torch.no_grad()
def fuse_qkv_params(model: CosineSimCausalTransformer
                    ) -> CosineSimCausalTransformer:
    """Concatenate each attention layer's ``to_q`` / ``to_k`` / ``to_v``
    column-wise into one ``to_qkv`` ([q | k | v], the split
    ``Attention.project`` takes), so a decode step streams one weight
    matrix per layer instead of three.  Works on plain and int8
    (``quantize_params``) layers; apply it after quantizing, as JAX does.
    In place; returns ``model``."""
    for attn in model.attn:
        if attn.to_qkv is not None:
            continue
        parts = (attn.to_q, attn.to_k, attn.to_v)
        if all(isinstance(p, QuantDense) for p in parts):
            fused = QuantDense(
                torch.cat([p.weight_q for p in parts], dim=1),
                torch.cat([p.weight_scale for p in parts], dim=1),
                parts[0].dtype)
        elif all(isinstance(p, Dense) for p in parts):
            w = torch.cat([p.weight for p in parts], dim=0)  # (out, in)
            fused = Dense(w.shape[1], w.shape[0], dtype=parts[0].dtype,
                          param_dtype=w.dtype, device=w.device)
            fused.weight.copy_(w)
        else:
            raise ValueError("to_q, to_k and to_v must be all plain or all "
                             "quantized")
        del attn.to_q, attn.to_k, attn.to_v
        attn.to_qkv = fused
    return model


def init_decode_state(model: CosineSimCausalTransformer, batch: int,
                      capacity: int, device=None,
                      kv_dtype=torch.int8) -> DecodeState:
    """Empty ``kv_dtype`` (int8 or float8_e4m3fn) caches for ``batch``
    slots on ``device`` (default ``cuda``; raises when no card is present
    and the CPU was not asked for).  For a model sharded over a mesh, each
    rank's caches hold its local KV heads (``cache_shardings``' rule; a
    grouped cache the TP size does not divide raises)."""
    device = resolve_device(device)
    kvh = (model.kv_heads if model.mesh is None
           else local_kv_heads(model.mesh, model.kv_heads))
    caches = tuple(
        init_cache(batch, kvh, capacity, model.dim_head, device,
                   kv_dtype=kv_dtype)
        for _ in range(model.depth))
    return DecodeState(caches, torch.zeros(batch, dtype=torch.int32,
                                           device=device))


def _check_mesh(model: CosineSimCausalTransformer, mesh) -> None:
    if mesh is not model.mesh:
        raise ValueError(
            "mesh= must be the mesh the model is sharded over (None for an "
            "unsharded model): parallel.shard_params(model, mesh) first")


def _last_real(logits: torch.Tensor, true_len: Optional[torch.Tensor]):
    if true_len is None:
        return logits[:, -1]
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, true_len.long() - 1]


@torch.no_grad()
def prefill(model: CosineSimCausalTransformer, state: DecodeState,
            tokens: torch.Tensor, true_len: Optional[torch.Tensor] = None,
            mesh=None) -> Tuple[torch.Tensor, DecodeState]:
    """Run the prompt (b, n) through full fused attention, filling the
    caches from empty.  Returns (logits of the last REAL prompt token,
    new state).  ``true_len`` ((b,), optional) supports right-padded,
    length-bucketed prompts: causal attention never attends positions to
    the right, and the cache lengths are cut to the true lengths so later
    steps never attend the pads.  ``mesh`` (serving TP; the mesh the model
    is sharded over) routes attention through the head-sharded path:
    every rank attends and caches its local heads."""
    _check_mesh(model, mesh)
    with span("prefill", batch=tokens.shape[0], width=tokens.shape[1]):
        attend = (flash_cosine_sim_attention if mesh is None
                  else head_sharded_flash_attention_local)
        caches = list(state.caches)

        def attn(layer, q, k, v):
            caches[layer] = append(caches[layer], k, v)
            return attend(q, k, v, causal=True, scale=model.attn_scale,
                          l2norm_qk=False)

        logits = model.trunk(model.embed(tokens, state.pos), attn)
        if true_len is None:
            new_pos = state.pos + tokens.shape[1]
        else:
            new_pos = state.pos + true_len.to(torch.int32)
            caches = [c._replace(length=new_pos) for c in caches]
        return (_last_real(logits, true_len),
                DecodeState(tuple(caches), new_pos))


@torch.no_grad()
def decode_step(model: CosineSimCausalTransformer, state: DecodeState,
                token: torch.Tensor, mesh=None,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step: (b,) tokens in, (b, vocab) logits out.  ``mesh``
    routes attention through the head-sharded path (serving TP: each
    rank's cache holds its local KV heads).  ``active`` ((b,) bool,
    optional) freezes inactive slots' caches and positions, so slots
    mid-prefill or finished ride along."""
    _check_mesh(model, mesh)
    with span("decode_step", slots=token.shape[0]):
        attend = (quantized_decode_attention if mesh is None
                  else head_sharded_decode_attention_local)
        caches = list(state.caches)

        def attn(layer, q, k, v):
            caches[layer] = append(caches[layer], k, v, active=active)
            return attend(q, caches[layer], scale=model.attn_scale,
                          l2norm_qk=False)

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
    with span("prefill_continue", batch=tokens.shape[0],
              width=tokens.shape[1]):
        caches = list(state.caches)
        pos0 = state.pos[slot:slot + 1]
        n_new = (torch.full((1,), tokens.shape[1], dtype=torch.int32,
                            device=tokens.device)
                 if true_len is None else true_len.to(torch.int32))

        def attn(layer, q, k, v):
            c = caches[layer]
            view = QuantKVCache(c.k8[slot:slot + 1], c.v8[slot:slot + 1],
                                c.v_scale[slot:slot + 1],
                                c.length[slot:slot + 1])
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
            # write the whole (padded) chunk; the corrected length excludes
            # pads
            append(view, k, v)
            length = c.length.clone()
            length[slot:slot + 1] = hist_len + n_new
            caches[layer] = c._replace(length=length)
            return o.to(q.dtype)

        logits = model.trunk(model.embed(tokens, pos0), attn)
        pos = state.pos.clone()
        pos[slot:slot + 1] = pos0 + n_new
        return _last_real(logits, true_len), DecodeState(tuple(caches), pos)


@torch.no_grad()
def generate_cached(model: CosineSimCausalTransformer, prime: torch.Tensor,
                    seq_len: int, capacity: int, temperature: float = 1.0,
                    filter_thres: float = 0.9,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """Top-k sampling through the cached decode path: ``prefill`` of the
    prompt ``prime`` (b, n), then ``seq_len - 1`` decode steps.  Returns
    (b, seq_len) int64 tokens, each drawn from softmax(top_k_filter(logits)
    / temperature) with ``generator``.  Runs on ``device`` (default
    ``cuda``; raises when no card is present and the CPU was not asked
    for), where ``model`` must lie.  Raises ``ValueError`` before any work
    when the prompt and the ``seq_len - 1`` decoded tokens do not fit in
    ``capacity`` cache rows (JAX's append would overwrite the newest
    history there; the port's would index past the buffer)."""
    need = prime.shape[1] + seq_len - 1
    if need > capacity:
        raise ValueError(
            f"capacity {capacity} too small: cached decoding needs prime "
            f"({prime.shape[1]}) + seq_len ({seq_len}) - 1 = {need} cache "
            f"rows")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model lies on {model.device}, not on {device}")
    state = init_decode_state(model, prime.shape[0], capacity, device=device)
    logits, state = prefill(model, state, prime.to(device))

    def sample(logits):
        filtered = top_k_filter(logits.float(), filter_thres)
        probs = torch.softmax(filtered / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    toks = [sample(logits)]
    for _ in range(seq_len - 1):
        logits, state = decode_step(model, state, toks[-1])
        toks.append(sample(logits))
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# paged variants: per-layer page pools shared by all slots (quant/paged.py)
# ---------------------------------------------------------------------------


def init_paged_decode_state(model: CosineSimCausalTransformer,
                            num_slots: int, num_pages: int, page_size: int,
                            max_pages_per_slot: int, kv_dtype=torch.int8,
                            device=None) -> PagedDecodeState:
    """Empty per-layer pools on ``device`` (default ``cuda``; raises when no
    card is present and the CPU was not asked for).

    Every layer's cache holds the SAME ``page_table`` tensor (JAX keeps
    equal per-layer copies): a slot's pages are the same ids in every
    layer's pool, so the engine uploads one table when it changes.
    Paged serving has no tensor parallelism (JAX's paged engine takes no
    mesh): a sharded model raises.
    """
    if model.mesh is not None:
        raise ValueError("paged decoding of a tensor-parallel model is not "
                         "supported: serve it with InferenceEngine(mesh=)")
    device = resolve_device(device)
    caches = [init_paged_cache(num_pages, model.kv_heads, page_size,
                               model.dim_head, num_slots, max_pages_per_slot,
                               kv_dtype=kv_dtype, device=device)
              for _ in range(model.depth)]
    table = caches[0].page_table
    return PagedDecodeState(
        tuple(c._replace(page_table=table) for c in caches),
        torch.zeros(num_slots, dtype=torch.int32, device=device))


def _slot_view(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """b=1 view of one slot over the shared pool (pool, table row and
    length are views)."""
    return cache._replace(page_table=cache.page_table[slot:slot + 1],
                          length=cache.length[slot:slot + 1])


def _with_slot_length(cache: PagedKVCache, slot: int,
                      n: torch.Tensor) -> PagedKVCache:
    length = cache.length.clone()
    length[slot:slot + 1] = n
    return cache._replace(length=length)


@torch.no_grad()
def prefill_paged(model: CosineSimCausalTransformer, state: PagedDecodeState,
                  slot: int, tokens: torch.Tensor,
                  true_len: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, PagedDecodeState]:
    """Prefill ONE request (tokens (1, n), optionally right-padded with
    ``true_len`` (1,)) into ``slot`` of the shared pools, from position 0;
    other slots keep their pages untouched.  The slot's table row must
    already hold its pages (pad positions past them land on the null page).
    Returns (last real token's logits (1, vocab), new state)."""
    caches = list(state.caches)

    def attn(layer, q, k, v):
        append_paged(_slot_view(caches[layer], slot), k, v)
        return flash_cosine_sim_attention(
            q, k, v, causal=True, scale=model.attn_scale, l2norm_qk=False)

    pos0 = torch.zeros(1, dtype=torch.int32, device=tokens.device)
    logits = model.trunk(model.embed(tokens, pos0), attn)
    n_new = (torch.full((1,), tokens.shape[1], dtype=torch.int32,
                        device=tokens.device)
             if true_len is None else true_len.to(torch.int32))
    # the slot's length is the TRUE prompt length: pad positions are
    # never attended, and the next real append overwrites them
    caches = [_with_slot_length(c, slot, n_new) for c in caches]
    pos = state.pos.clone()
    pos[slot:slot + 1] = n_new
    return (_last_real(logits, true_len),
            PagedDecodeState(tuple(caches), pos))


@torch.no_grad()
def decode_step_paged(model: CosineSimCausalTransformer,
                      state: PagedDecodeState, token: torch.Tensor,
                      active: torch.Tensor
                      ) -> Tuple[torch.Tensor, PagedDecodeState]:
    """One decode step for every slot: (num_slots,) tokens in,
    (num_slots, vocab) logits out.  ``active`` ((num_slots,) bool) masks
    finished and empty slots: their writes go to the null page and their
    lengths and positions do not advance."""
    caches = list(state.caches)

    def attn(layer, q, k, v):
        caches[layer] = append_paged(caches[layer], k, v, active=active)
        return paged_decode_attention(
            q, caches[layer], scale=model.attn_scale, l2norm_qk=False)

    logits = model.trunk(model.embed(token[:, None], state.pos), attn)
    pos = state.pos + active.to(torch.int32)
    return logits[:, 0], PagedDecodeState(tuple(caches), pos)


@torch.no_grad()
def prefill_continue_paged(model: CosineSimCausalTransformer,
                           state: PagedDecodeState, slot: int,
                           tokens: torch.Tensor,
                           true_len: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, PagedDecodeState]:
    """Continuation prefill of a (1, t) chunk for ``slot`` against the
    paged cache (see ``prefill_continue``): the chunk attends itself
    (causal) and the slot's gathered, dequantized history pages
    (key-masked), and the partials merge by their row sums.  The slot's
    table must already hold pages covering the chunk."""
    caches = list(state.caches)
    pos0 = state.pos[slot:slot + 1]
    n_new = (torch.full((1,), tokens.shape[1], dtype=torch.int32,
                        device=tokens.device)
             if true_len is None else true_len.to(torch.int32))

    def attn(layer, q, k, v):
        c = caches[layer]
        view = _slot_view(c, slot)
        hist_len = view.length
        o_new, inv_new = flash_attention_forward(
            q, k, v, None, None, bias_batch_dim=False,
            scale=model.attn_scale, causal=True)
        # (1, kvh, d, mp * ps) codes -> (1, kvh, mp * ps, d) values
        k_hist = dequantize_k(gather_pages(c.k8, view.page_table), q.dtype)
        v_hist = dequantize_v(gather_pages(c.v8, view.page_table),
                              gather_pages(c.v_scale, view.page_table),
                              q.dtype)
        keep = (torch.arange(k_hist.shape[-1], device=q.device)[None, :]
                < hist_len[:, None])
        o_hist, inv_hist = flash_attention_forward(
            q, k_hist.transpose(-1, -2), v_hist.transpose(-1, -2), keep,
            None, bias_batch_dim=False, scale=model.attn_scale, causal=False)
        l_new, l_hist = 1.0 / inv_new, 1.0 / inv_hist
        o = ((o_new.float() * l_new + o_hist.float() * l_hist)
             / (l_new + l_hist).clamp_min(1e-10))
        # write the whole (padded) chunk; the corrected length excludes pads
        append_paged(view, k, v)
        caches[layer] = _with_slot_length(c, slot, hist_len + n_new)
        return o.to(q.dtype)

    logits = model.trunk(model.embed(tokens, pos0), attn)
    pos = state.pos.clone()
    pos[slot:slot + 1] = pos0 + n_new
    return (_last_real(logits, true_len),
            PagedDecodeState(tuple(caches), pos))
