"""The port's paged engine on the CPU: page accounting equal to the JAX
paged engine's under the scripts of tests/test_paged_engine.py, the
port's own serving invariants, and the contiguous engine's e4m3 cache
against JAX.

The JAX engine's page accounting (allocator, table, host positions) is
host code that reads nothing the device computes, so it runs here with
its device steps stubbed out, at no compile cost; the port's engine runs
in full.  Token streams are not compared across frameworks (their random
generators differ); within the port, near-greedy sampling (temperature
1e-4) makes a stream depend on the logits' argmax alone.  e4m3 decode
logits are held to JAX's within 1e-2 (decode's bf16 roundings), as in
tests/test_torch_decode.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_cosine_sim_attention_tpu.models import (
    CosineSimCausalTransformer as JaxModel,
)
from flash_cosine_sim_attention_tpu.models import decoding as jdec
from flash_cosine_sim_attention_tpu.serving import (
    PagedInferenceEngine as JaxPagedEngine,
)
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    params_from_flax,
)
from flash_cosine_sim_attention_tpu_torch.serving import (
    InferenceEngine,
    PagedInferenceEngine,
)

MODEL = dict(num_tokens=64, dim=64, depth=2, max_seq_len=512, heads=4,
             dim_head=16, pre_norm=True, attn_scale=1.0)
PAGED = dict(num_slots=4, page_size=128, num_pages=32, max_pages_per_slot=4,
             reserve_tokens=128, prompt_buckets=(32, 64, 256))
GREEDY = dict(temperature=1e-4, seed=42)
LOGITS_CACHED_TOL = 1e-2


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxModel(**MODEL, dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    params = jmodel.init(rng, jax.random.randint(rng, (1, 16), 0, 64))
    model = CosineSimCausalTransformer(**MODEL, device="cpu")
    params_from_flax(jax.tree.map(np.asarray, params), model)
    return jmodel, params, model


def _paged(model, **kw):
    return PagedInferenceEngine(model, **{**PAGED, "device": "cpu", **kw})


def _jax_host_only(jmodel, params, **kw):
    """The JAX paged engine with its jitted device steps replaced by ones
    that return the state unchanged and token 0."""
    eng = JaxPagedEngine(jmodel, params, **{**PAGED, **kw})

    def prefill(params, state, slot, tokens, true_len, last, rng):
        return jnp.zeros((1,), jnp.int32), last, state, rng

    eng._prefill = eng._continue = prefill
    eng._decode = lambda params, state, last, active, rng: (last, state, rng)
    eng._reset_slot = lambda state, slot: state
    return eng


def _accounting(eng):
    return dict(pages=eng.pages_in_use(), free=list(eng.allocator.free),
                table=eng.table.tolist(), pos=eng.host_pos.tolist(),
                active=eng.active.tolist(),
                prefilling=eng.prefilling.tolist(),
                slot_pages=[[int(p) for p in s] for s in eng.slot_pages])


def _prompt(n):
    return (np.arange(n) * 3) % 64


# engine options, then (op, args) in order: add (length, chunk_tokens),
# step (count), continue (slot, length), finish (slot)
SCRIPTS = {
    "lifecycle": ({}, [("add", 20, None), ("step", 4), ("finish", 0)]),
    "page-boundary": ({"reserve_tokens": 0},
                      [("add", 126, None), ("step", 5)]),
    "exhaustion": ({"num_pages": 4, "reserve_tokens": 256},
                   [("add", 8, None), ("add", 8, None)]),
    "continue": ({"reserve_tokens": 0},
                 [("add", 20, None), ("step", 3), ("continue", 0, 150),
                  ("step", 1)]),
    "chunked": ({"reserve_tokens": 0, "prompt_buckets": (16, 32, 64, 128)},
                [("add", 9, None), ("step", 1), ("add", 40, 16), ("step", 3),
                 ("step", 3), ("finish", 1), ("add", 5, None),
                 ("finish", 0), ("finish", 1)]),
}


def _run(eng, op, *args):
    if op == "add":
        eng.add_request(_prompt(args[0]), chunk_tokens=args[1])
    elif op == "step":
        for _ in range(args[0]):
            eng.step()
    elif op == "continue":
        eng.continue_request(args[0], _prompt(args[1]))
    else:
        eng.finish(args[0])


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_page_accounting_matches_jax_engine(setup, script):
    jmodel, params, model = setup
    kw, ops = SCRIPTS[script]
    ours, theirs = _paged(model, seed=3, **kw), _jax_host_only(
        jmodel, params, seed=3, **kw)
    for op, *args in ops:
        outcomes = []
        for eng in (ours, theirs):
            try:
                _run(eng, op, *args)
                outcomes.append(None)
            except RuntimeError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1], (op, args, outcomes)
        assert _accounting(ours) == _accounting(theirs), (op, args)
        # the device lengths and positions follow the host mirror
        for s in np.flatnonzero(ours.active | ours.prefilling):
            assert int(ours.state.pos[s]) == ours.host_pos[s]
            assert all(int(c.length[s]) == ours.host_pos[s]
                       for c in ours.state.caches)
        table = ours.state.caches[0].page_table
        assert all(c.page_table is table for c in ours.state.caches)
        np.testing.assert_array_equal(table.numpy(), ours.table)
    if script == "chunked":
        assert ours.pages_in_use() == 0 and len(ours.allocator.free) == 31


def _solo(model, prompt, steps, **kw):
    e = _paged(model, **GREEDY, **kw)
    s = e.add_request(prompt)
    return [int(e.last_token[s])] + [e.step()[s] for _ in range(steps - 1)]


@pytest.mark.parametrize("kv_dtype", [torch.int8, torch.float8_e4m3fn])
def test_interleaved_requests_keep_slots_isolated(setup, kv_dtype):
    """A request admitted mid-stream, and another admitted into the pages
    of a finished one, do not disturb an in-flight request."""
    _, _, model = setup
    pa, pb = _prompt(9), _prompt(17)
    ref = _solo(model, pa, 8, kv_dtype=kv_dtype)
    eng = _paged(model, **GREEDY, kv_dtype=kv_dtype)
    sa = eng.add_request(pa)
    got = [int(eng.last_token[sa]), eng.step()[sa]]
    sb = eng.add_request(pb)
    for _ in range(3):
        out = eng.step()
        got.append(out[sa])
        assert sb in out
    used = eng.pages_in_use()
    eng.finish(sb)
    assert eng.pages_in_use() < used
    assert eng.add_request(_prompt(5)) == sb   # reuses the freed pages
    got += [eng.step()[sa] for _ in range(3)]
    assert got == ref


def test_chunked_prefill_matches_one_shot(setup):
    """Chunked admission gives the one-shot continuation, leaves the
    in-flight request alone, and holds ceil(pos / 128) pages per slot."""
    _, _, model = setup
    kw = dict(reserve_tokens=0, prompt_buckets=(16, 32, 64, 128))
    pa, pb = _prompt(9), (np.arange(40) * 5) % 64
    ref_b, ref_a = _solo(model, pb, 4, **kw), _solo(model, pa, 9, **kw)
    eng = _paged(model, **GREEDY, **kw)
    sa = eng.add_request(pa)
    got_a = [int(eng.last_token[sa]), eng.step()[sa]]
    sb = eng.add_request(pb, chunk_tokens=16)
    for _ in range(3):
        out = eng.step()
        got_a.append(out[sa])
        assert sb not in out
    assert eng.active[sb] and not eng.prefilling[sb]
    got_b = [int(eng.last_token[sb])]
    for _ in range(3):
        out = eng.step()
        got_a.append(out[sa])
        got_b.append(out[sb])
    assert (got_a, got_b) == (ref_a[:len(got_a)], ref_b)
    assert eng.pages_in_use() == sum(
        (int(eng.host_pos[s]) + 127) // 128 for s in (sa, sb))


def test_fp8_engine_decode_matches_jax(setup):
    """InferenceEngine over an e4m3 cache: its prefill and decode logits
    against JAX's e4m3 prefill and decode_step, fed the same tokens."""
    jmodel, params, model = setup
    eng = InferenceEngine(model, num_slots=1, capacity=64,
                          prompt_buckets=(32,), kv_dtype=torch.float8_e4m3fn,
                          device="cpu")
    seen = []

    def argmax(logits):   # record the logits, sample greedily
        seen.append(logits.float().numpy())
        return logits.argmax(-1)

    eng._sample = argmax
    prompt = _prompt(13)
    slot = eng.add_request(prompt)
    toks = [int(eng.last_token[slot])] + [eng.step()[slot] for _ in range(3)]

    state = jdec.init_decode_state(jmodel, 1, 64,
                                   kv_dtype=jnp.float8_e4m3fn)
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, :13] = prompt
    want, state = jdec.prefill(jmodel, params, state, jnp.asarray(tokens),
                               true_len=jnp.asarray([13], jnp.int32))
    wants = [want]
    jdecode = jax.jit(lambda s, t: jdec.decode_step(jmodel, params, s, t))
    for tok in toks[:3]:
        want, state = jdecode(state, jnp.asarray([tok], jnp.int32))
        wants.append(want)
    assert len(seen) == len(wants) == 4
    for got, want in zip(seen, wants):
        assert np.abs(got - np.asarray(want)).max() <= LOGITS_CACHED_TOL
