"""Speculative decoding: draft-model proposals, one-pass target verify.

Counterpart of ``flash_cosine_sim_attention_tpu/models/speculative.py``,
built from the cached decode path (``models/decoding.py``):

  * the DRAFT model decodes ``gamma`` tokens through its own int8 cache
    (``decode_step``, the decode kernel K4);
  * the TARGET verifies all ``gamma`` proposals in ONE continuation pass
    that keeps every chunk row's logits (``_verify_rows_batched``): per
    layer the chunk attends itself causally and the dequantized history
    key-masked by each slot's length (two launches of the forward kernel
    K1), and the two partials merge by their row sums, which the no-row-max
    exp convention makes a plain sum;
  * rejected suffixes roll back by SETTING the caches' ``length`` and the
    state's ``pos`` (``_rollback``).  The port's caches are written in
    place, so the stale rows past the accepted prefix stay in the buffers,
    are never attended, and are overwritten by the next append.

Greedy acceptance emits the target's greedy choice at every verified row;
sampled acceptance is the speculative rejection rule (Leviathan et al.)
with the residual distribution max(p_t - p_d, 0).  The verify's chunk
attends its own k and v unquantized, while ``decode_step`` attends the new
token through the int8 cache, so the two paths' logits for one token
differ by the int8 KV error, as in the JAX package.

The JAX rng becomes an explicit ``torch.Generator``; the functions run
eagerly under ``torch.no_grad`` on the models' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._build import resolve_device
from ..ops import flash_attention_forward
from ..quant import append, dequantize_k, dequantize_v
from .decoding import DecodeState, decode_step, init_decode_state, prefill
from .transformer import CosineSimCausalTransformer


class SpecState(NamedTuple):
    target: DecodeState
    draft: DecodeState
    pending: torch.Tensor                   # (1,) int64, sampled, not yet fed
    generator: Optional[torch.Generator]


def _rollback(state: DecodeState, new_len: torch.Tensor) -> DecodeState:
    """Truncate every layer's cache, and the position, to ``new_len``
    tokens ((b,) or one value for every slot)."""
    new_len = new_len.to(torch.int32).expand(state.pos.shape)
    return DecodeState(tuple(c._replace(length=new_len) for c in state.caches),
                       new_len)


def _softmax_probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return torch.softmax(logits.float() / temperature, dim=-1)


def _first_reject(ok: torch.Tensor) -> torch.Tensor:
    """The number of leading True entries of each row of ``ok`` (.., g)."""
    pad = torch.zeros((*ok.shape[:-1], 1), dtype=torch.bool, device=ok.device)
    return torch.argmin(torch.cat([ok, pad], -1).to(torch.int32), dim=-1)


@torch.no_grad()
def _verify_rows_batched(target: CosineSimCausalTransformer,
                         tstate: DecodeState, chunk: torch.Tensor,
                         active: Optional[torch.Tensor]
                         ) -> Tuple[torch.Tensor, DecodeState]:
    """One continuation pass over (slots, gamma) chunks returning EVERY
    row's logits (slots, gamma, vocab), and the state with the chunk
    appended.  Each slot's history length comes from its cache's
    ``length``; ``active`` ((slots,) bool, or None for all) masks the
    append, so frozen slots' lengths and positions do not advance."""
    caches = list(tstate.caches)
    pos0 = tstate.pos

    def attn(layer, q, k, v):
        c = caches[layer]
        kw = dict(bias_batch_dim=False, scale=target.attn_scale)
        # chunk vs itself: causal
        o_new, inv_new = flash_attention_forward(q, k, v, None, None,
                                                 causal=True, **kw)
        # chunk vs the dequantized history: key-masked, non-causal
        keep = (torch.arange(c.capacity, device=q.device)[None, :]
                < c.length[:, None])
        o_hist, inv_hist = flash_attention_forward(
            q, dequantize_k(c.k8, q.dtype),
            dequantize_v(c.v8, c.v_scale, q.dtype), keep, None,
            causal=False, **kw)
        # merge the partials by plain sums of their row sums
        l_new, l_hist = 1.0 / inv_new, 1.0 / inv_hist
        o = ((o_new.float() * l_new + o_hist.float() * l_hist)
             / (l_new + l_hist).clamp_min(1e-10))
        caches[layer] = append(c, k, v, active=active)
        return o.to(q.dtype)

    logits = target.trunk(target.embed(chunk, pos0), attn)
    gamma = chunk.shape[1]
    step = gamma if active is None else gamma * active.to(torch.int32)
    return logits, DecodeState(tuple(caches), pos0 + step)


def _accept(rows, drafts, dprobs, gamma, temperature, generator):
    """The acceptance rule over (slots, gamma) verify rows: (j, the number
    of leading accepted drafts (slots,), and the replacement token drawn
    at row min(j, gamma - 1) (slots,))."""
    if temperature == 0.0:
        t_choice = rows.argmax(-1)                            # (slots, g)
        j = _first_reject(t_choice == drafts)
        jr = j.clamp(max=gamma - 1)
        return j, t_choice.gather(1, jr[:, None])[:, 0]
    tprobs = _softmax_probs(rows, temperature)                # (slots, g, V)
    u = torch.rand(drafts.shape, generator=generator, device=rows.device)
    pt = tprobs.gather(2, drafts[..., None])[..., 0]
    pd = dprobs.gather(2, drafts[..., None])[..., 0]
    j = _first_reject(u < torch.clamp(pt / pd.clamp_min(1e-20), max=1.0))
    jr = j.clamp(max=gamma - 1)
    pick = jr[:, None, None].expand(-1, 1, tprobs.shape[-1])
    # the residual distribution max(p_t - p_d, 0) at the rejected row
    resid = (tprobs.gather(1, pick) - dprobs.gather(1, pick))[:, 0]
    resid = resid.clamp_min(0.0)
    resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-20)
    return j, torch.multinomial(resid.clamp_min(1e-30), 1,
                                generator=generator)[:, 0]


def _propose(draft, dstate, pending, gamma, temperature, generator,
             active=None):
    """``gamma`` draft decode steps from ``pending`` (slots,): returns the
    draft state, the proposals (slots, gamma) and, when sampling, their
    draft probabilities (slots, gamma, vocab).  Inactive slots ride along
    frozen, proposing their pending token again."""
    tok, toks, probs = pending, [], []
    for _ in range(gamma):
        logits, dstate = decode_step(draft, dstate, tok, active=active)
        if temperature == 0.0:
            nxt = logits.argmax(-1)
        else:
            p = _softmax_probs(logits, temperature)
            probs.append(p)
            nxt = torch.multinomial(p, 1, generator=generator)[:, 0]
        tok = nxt if active is None else torch.where(active, nxt, tok)
        toks.append(tok)
    return (dstate, torch.stack(toks, 1),
            torch.stack(probs, 1) if probs else None)


def make_speculative_decoder(target: CosineSimCausalTransformer,
                             draft: CosineSimCausalTransformer,
                             gamma: int = 4, temperature: float = 0.0):
    """Build a one-round speculative step for one stream (b = 1).

    Returns ``round_fn(state: SpecState) -> (state, tokens, n_emitted)``
    where ``tokens`` is (gamma,) int64 with the first ``n_emitted`` (a 0-d
    tensor) entries valid and -1 past them.  ``temperature == 0`` gives
    greedy acceptance; otherwise the speculative rejection rule at that
    temperature.  It is the batched round with every slot active (JAX
    writes the two out; they differ only in the active masks)."""
    round_b = make_batched_speculative_decoder(target, draft, gamma,
                                               temperature)

    def round_fn(state: SpecState):
        tstate, dstate, pending, emitted, n = round_b(
            state.target, state.draft, state.pending, None, state.generator)
        return (SpecState(tstate, dstate, pending, state.generator),
                emitted[0], n[0])

    return round_fn


def make_batched_speculative_decoder(target: CosineSimCausalTransformer,
                                     draft: CosineSimCausalTransformer,
                                     gamma: int = 4,
                                     temperature: float = 0.0):
    """Multi-slot speculative round for the continuous-batching engine.

    Returns ``round_fn(tstate, dstate, pending, active, generator) ->
    (tstate, dstate, pending, emitted, n_emitted)``: every active slot
    (``active`` (slots,) bool, or None for all) advances by its OWN
    accepted count.  ``emitted`` is (slots, gamma) int64 with each row's
    first ``n_emitted[slot]`` entries valid and -1 past them (inactive
    slots emit nothing: n_emitted 0).  ``temperature == 0`` gives greedy
    acceptance per slot; otherwise the speculative rejection rule applies
    per slot."""

    @torch.no_grad()
    def round_fn(tstate, dstate, pending, active, generator=None):
        n0 = tstate.pos                                       # (slots,)
        dstate, drafts, dprobs = _propose(draft, dstate, pending, gamma,
                                          temperature, generator, active)
        chunk = torch.cat([pending[:, None], drafts[:, :-1]], 1)
        rows, tstate = _verify_rows_batched(target, tstate, chunk, active)
        j, replacement = _accept(rows, drafts, dprobs, gamma, temperature,
                                 generator)
        full = j == gamma
        n_emitted = torch.where(full, gamma, j + 1)
        new_pending = torch.where(full, drafts[:, -1], replacement)
        if active is not None:
            n_emitted = n_emitted * active
            new_pending = torch.where(active, new_pending, pending)
        # per-slot rollback: inactive slots consume 0, so stay where they are
        new_len = n0 + n_emitted
        tstate = _rollback(tstate, new_len)
        dstate = _rollback(dstate, new_len)
        idx = torch.arange(gamma, device=drafts.device)[None, :]
        emitted = torch.where(
            idx < j[:, None], drafts,
            torch.where(idx == j[:, None], new_pending[:, None], -1))
        return tstate, dstate, new_pending, emitted, n_emitted

    return round_fn


@torch.no_grad()
def speculative_generate(target: CosineSimCausalTransformer,
                         draft: CosineSimCausalTransformer,
                         prime: torch.Tensor, seq_len: int, capacity: int,
                         gamma: int = 4, temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> Tuple[torch.Tensor, float]:
    """Generate ``seq_len`` tokens after the (1, n) prompt ``prime``;
    returns (tokens (1, seq_len) int64, mean accepted per round).  b = 1.
    Runs on ``device`` (default ``cuda``; raises when no card is present
    and the CPU was not asked for), where both models must lie."""
    if prime.shape[0] != 1:
        raise ValueError("speculative decoding is single-stream")
    # every round appends up to gamma tokens to both caches BEFORE rolling
    # back, so the high-water mark is prompt + generated + gamma
    need = prime.shape[1] + seq_len + gamma
    if capacity < need:
        raise ValueError(
            f"capacity {capacity} too small: speculative decoding needs "
            f"prime ({prime.shape[1]}) + seq_len ({seq_len}) + gamma "
            f"({gamma}) = {need} cache rows")
    device = resolve_device(device)
    for m in (target, draft):
        if m.device != device:
            raise ValueError(f"model lies on {m.device}, not on {device}")
    prime = prime.to(device)
    tstate = init_decode_state(target, 1, capacity, device=device)
    dstate = init_decode_state(draft, 1, capacity, device=device)
    t_logits, tstate = prefill(target, tstate, prime)
    _, dstate = prefill(draft, dstate, prime)
    if temperature == 0.0:
        pending = t_logits.argmax(-1)
    else:
        pending = torch.multinomial(_softmax_probs(t_logits, temperature), 1,
                                    generator=generator)[:, 0]

    round_fn = make_speculative_decoder(target, draft, gamma, temperature)
    state = SpecState(tstate, dstate, pending, generator)
    out = [int(pending[0])]
    rounds = 0
    while len(out) < seq_len:
        state, emitted, n = round_fn(state)
        rounds += 1
        out.extend(emitted[:int(n)].tolist())
    toks = torch.tensor(out[:seq_len], dtype=torch.int64)[None]
    return toks, (len(out) - 1) / max(rounds, 1)
