"""The port's speculative decoding against the JAX package, on the CPU:
greedy tokens and accepted counts (b = 1 and in the engine), the batched
verify's logits, the capacity guards, sampled mode, and
``generate_cached``.

The models are the JAX test's (tests/test_speculative.py): a target of
dim 64, depth 2, 4 heads of 16 and a draft of dim 32, depth 1, 2 heads of
16, in float32, weights carried across with ``params_from_flax``.  The
JAX side's model calls run jitted where the test calls them (its
interpret-mode kernels cost seconds a call un-jitted).  Tolerances:
tokens and accepted counts equal; verify logits within 1e-4 of
max|logit| (the verify reads the int8 history dequantized to float32, so
no bf16 rounding enters it).  Sampled mode draws from torch's generator,
not JAX's, so its tokens are not compared.
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
from flash_cosine_sim_attention_tpu.models import speculative as jspec
from flash_cosine_sim_attention_tpu.serving import (
    SpeculativeEngine as JaxSpeculativeEngine,
)
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    decode_step,
    generate_cached,
    init_decode_state,
    make_speculative_decoder,
    params_from_flax,
    prefill,
    speculative_generate,
)
from flash_cosine_sim_attention_tpu_torch.models.speculative import (
    SpecState,
    _accept,
    _verify_rows_batched,
)
from flash_cosine_sim_attention_tpu_torch.serving import SpeculativeEngine

TARGET = dict(num_tokens=64, dim=64, depth=2, max_seq_len=256, heads=4,
              dim_head=16, pre_norm=True, attn_scale=1.0)
DRAFT = dict(num_tokens=64, dim=32, depth=1, max_seq_len=256, heads=2,
             dim_head=16, pre_norm=True, attn_scale=1.0)
VERIFY_TOL = 1e-4
CAP = 128


@pytest.fixture(scope="module")
def models():
    rng = jax.random.PRNGKey(0)
    x = jax.random.randint(rng, (1, 16), 0, 64)
    out = {}
    for name, cfg, key in (("target", TARGET, rng),
                           ("draft", DRAFT, jax.random.PRNGKey(1))):
        jmodel = JaxModel(**cfg, dtype=jnp.float32)
        params = jmodel.init(key, x)
        model = CosineSimCausalTransformer(**cfg, device="cpu")
        params_from_flax(jax.tree.map(np.asarray, params), model)
        out[name] = (jmodel, params, model)
    return out


def _greedy_reference(model, prime, n):
    """The port's target-only greedy decode: prefill + decode_step argmax."""
    st = init_decode_state(model, 1, CAP, device="cpu")
    logits, st = prefill(model, st, torch.as_tensor(prime)[None])
    tok = logits.argmax(-1)
    out = [int(tok[0])]
    for _ in range(n - 1):
        logits, st = decode_step(model, st, tok)
        tok = logits.argmax(-1)
        out.append(int(tok[0]))
    return out


@pytest.mark.parametrize("which", ["draft", "self"])
def test_greedy_speculative_generate_matches_jax(models, which):
    """Greedy tokens and the mean accepted count a round equal JAX's, with
    a distinct draft and with the target as its own draft; the tokens
    equal the port's own greedy decode, and a self-draft accepts all
    gamma proposals a round."""
    jt, tp, target = models["target"]
    jd, dp, draft = models[which] if which == "draft" else models["target"]
    prime = (np.arange(12) * 5 + 3) % 64
    n = 17
    want, want_acc = jspec.speculative_generate(
        jt, tp, jd, dp, jax.random.PRNGKey(5),
        jnp.asarray(prime[None], jnp.int32), n, capacity=CAP, gamma=4,
        temperature=0.0)
    got, acc = speculative_generate(target, draft,
                                    torch.as_tensor(prime)[None], n, CAP,
                                    gamma=4, device="cpu")
    assert got.shape == (1, n)
    assert got[0].tolist() == np.asarray(want)[0].tolist()
    assert acc == want_acc
    assert got[0].tolist() == _greedy_reference(target, prime, n)
    if which == "self":
        assert acc == 4.0


def _prefilled(jt, tp, target, prompts):
    """JAX and port states over len(prompts) slots, each slot prefilled
    with its prompt (right-padded to 16, true lengths kept); an empty
    prompt leaves its slot with no history."""
    b = len(prompts)
    tokens = np.zeros((b, 16), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    true_len = np.maximum(lens, 1)
    jstate = jdec.init_decode_state(jt, b, CAP)
    _, jstate = jax.jit(lambda s, t, n: jdec.prefill(jt, tp, s, t,
                                                     true_len=n))(
        jstate, jnp.asarray(tokens), jnp.asarray(true_len))
    state = init_decode_state(target, b, CAP, device="cpu")
    _, state = prefill(target, state, torch.as_tensor(tokens).long(),
                       true_len=torch.as_tensor(true_len))
    # a slot with an empty prompt: length and position back to 0
    jlen = jnp.asarray(lens)
    jstate = jdec.DecodeState(
        tuple(c._replace(length=jlen) for c in jstate.caches), jlen)
    tlen = torch.as_tensor(lens)
    state = type(state)(tuple(c._replace(length=tlen) for c in state.caches),
                        tlen)
    return jstate, state


def test_batched_verify_rows_match_jax(models):
    """Every chunk row's logits of the batched verify equal JAX's
    ``_verify_rows_batched`` within 1e-4 of max|logit|, over a slot with
    history, one with an empty history and one inactive slot; the
    lengths and positions advance for the active slots only."""
    jt, tp, target = models["target"]
    prompts = [(np.arange(12) * 7) % 64, np.zeros(0, np.int64),
               (np.arange(9) * 3 + 1) % 64]
    jstate, state = _prefilled(jt, tp, target, prompts)
    chunk = np.random.default_rng(0).integers(0, 64, (3, 4)).astype(np.int32)
    active = np.array([True, True, False])
    want, jnew = jax.jit(lambda s, c, a: jspec._verify_rows_batched(
        jt, tp, s, c, a))(jstate, jnp.asarray(chunk), jnp.asarray(active))
    got, new = _verify_rows_batched(target, state, torch.as_tensor(chunk).long(),
                                    torch.as_tensor(active))
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 4, 64)
    assert torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= VERIFY_TOL, err
    assert new.pos.tolist() == np.asarray(jnew.pos).tolist() == [16, 4, 9]
    for c, jc in zip(new.caches, jnew.caches):
        assert c.length.tolist() == np.asarray(jc.length).tolist()


def _run_staggered(engine, prompts, n):
    """The JAX test's scenario: one slot decodes alone for a round, then
    two more join; rounds run until every stream holds n tokens.  Returns
    the streams and the accepted counts of every round, slot by slot."""
    streams, counts = {}, []
    sa, tok = engine.add_request(prompts[0])
    streams[sa] = [tok]
    out = engine.step_round()
    counts.append({s: len(t) for s, t in out.items()})
    for s, toks in out.items():
        streams[s].extend(toks)
    for p in prompts[1:]:
        s, tok = engine.add_request(p)
        streams[s] = [tok]
    while min(len(v) for v in streams.values()) < n:
        out = engine.step_round()
        assert out, "no progress"
        counts.append({s: len(t) for s, t in out.items()})
        for s, toks in out.items():
            streams[s].extend(toks)
    return [streams[s][:n] for s in sorted(streams)], counts


def test_engine_staggered_slots_match_jax(models):
    """Three slots with different prompts and staggered admission give the
    JAX engine's streams and accepted counts round by round, and each
    stream equals the port's greedy decode of its prompt."""
    jt, tp, target = models["target"]
    jd, dp, draft = models["draft"]
    prompts = [np.arange(12) % 64, (np.arange(9) * 5) % 64,
               (np.arange(15) * 3 + 1) % 64]
    n = 16
    kw = dict(num_slots=4, capacity=CAP, gamma=4, temperature=0.0,
              prompt_buckets=(16, 32))
    want, want_counts = _run_staggered(
        JaxSpeculativeEngine(jt, tp, jd, dp, **kw), prompts, n)
    got, counts = _run_staggered(
        SpeculativeEngine(target, draft, device="cpu", **kw), prompts, n)
    assert got == want
    assert counts == want_counts
    assert got == [_greedy_reference(target, p, n) for p in prompts]


def test_capacity_guards(models):
    """speculative_generate refuses a capacity below prompt + tokens +
    gamma, as JAX's does; the engine refuses a round that would take an
    active slot past capacity, while a finished slot parked there rides
    along without wedging it."""
    jt, tp, target = models["target"]
    jd, dp, draft = models["draft"]
    prime = np.arange(8) % 64
    with pytest.raises(ValueError, match="capacity"):
        jspec.speculative_generate(jt, tp, jd, dp, jax.random.PRNGKey(0),
                                   jnp.asarray(prime[None], jnp.int32), 30,
                                   capacity=32, gamma=4)
    with pytest.raises(ValueError, match="capacity"):
        speculative_generate(target, draft, torch.as_tensor(prime)[None], 30,
                             32, gamma=4, device="cpu")

    eng = SpeculativeEngine(target, draft, num_slots=2, capacity=32,
                            gamma=4, prompt_buckets=(16,), device="cpu")
    eng.add_request(np.arange(14) % 64)
    with pytest.raises(RuntimeError, match="capacity"):
        for _ in range(32):          # each round emits one token at least
            eng.step_round()
    assert eng.host_pos[0] + 4 > 32
    slot1, _ = eng.add_request(np.arange(10) % 64)
    assert slot1 == 1
    eng.finish(0)
    out = eng.step_round()
    assert slot1 in out and len(out[slot1]) >= 1
    assert 0 not in out


def test_sampled_mode(models):
    """Sampled mode emits in-vocabulary tokens; with the target as its own
    draft every proposal is accepted (u < min(1, p_t / p_d), p_t = p_d
    up to the int8 KV error), gamma tokens a round."""
    _, _, target = models["target"]
    _, _, draft = models["draft"]
    prime = torch.as_tensor(np.arange(8) % 64)[None]
    gen = torch.Generator().manual_seed(7)
    toks, acc = speculative_generate(target, draft, prime, 16, CAP, gamma=3,
                                     temperature=0.8, generator=gen,
                                     device="cpu")
    assert toks.shape == (1, 16)
    assert ((toks >= 0) & (toks < 64)).all() and acc > 0

    st = init_decode_state(target, 1, CAP, device="cpu")
    logits, st = prefill(target, st, prime)
    st2 = init_decode_state(target, 1, CAP, device="cpu")
    _, st2 = prefill(target, st2, prime)
    state = SpecState(st, st2, logits.argmax(-1), gen)
    round_fn = make_speculative_decoder(target, target, gamma=3,
                                        temperature=0.8)
    for _ in range(5):
        state, emitted, n = round_fn(state)
        assert int(n) == 3
        assert ((emitted >= 0) & (emitted < 64)).all()
    assert state.target.pos.tolist() == [8 + 15]


def _np_softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_acceptance_rule(monkeypatch, seed):
    """``_accept``'s sampled rule against a direct numpy computation: j is
    the number of leading drafts with u < min(1, p_t / p_d), u being the
    generator's first draw, and the replacement is drawn from the
    normalized max(p_t - p_d, 0) at row min(j, gamma - 1).  Slot 0's
    target equals its draft (every draft accepted); slot 1's target gives
    its third draft p_t = 0 (rejected there at the latest)."""
    slots, gamma, vocab, temp = 16, 4, 8, 0.7
    rng = np.random.default_rng(seed)
    rows = (2 * rng.standard_normal((slots, gamma, vocab))).astype(np.float32)
    dprobs = _np_softmax(2 * rng.standard_normal((slots, gamma, vocab)))
    dprobs = dprobs.astype(np.float32)
    drafts = np.stack([[rng.choice(vocab, p=p / p.sum()) for p in slot]
                       for slot in dprobs])
    rows[0] = temp * np.log(dprobs[0])
    rows[1, 2, drafts[1, 2]] = -np.inf

    tprobs = _np_softmax(rows.astype(np.float64) / temp)
    pick = (np.arange(slots)[:, None], np.arange(gamma)[None, :], drafts)
    ratio = np.minimum(1.0, tprobs[pick] / dprobs[pick])
    u = torch.rand((slots, gamma),
                   generator=torch.Generator().manual_seed(seed)).numpy()
    ok = np.concatenate([u < ratio, np.zeros((slots, 1), bool)], 1)
    want_j = ok.argmin(1)
    assert want_j[0] == gamma and want_j[1] <= 2

    seen = []
    real = torch.multinomial

    def spy(probs, *args, **kwargs):
        seen.append(probs.clone())
        return real(probs, *args, **kwargs)

    monkeypatch.setattr(torch, "multinomial", spy)
    j, repl = _accept(torch.from_numpy(rows), torch.from_numpy(drafts),
                      torch.from_numpy(dprobs), gamma, temp,
                      torch.Generator().manual_seed(seed))
    assert j.tolist() == want_j.tolist()
    (probs,) = seen
    jr = np.minimum(want_j, gamma - 1)
    resid = np.maximum(tprobs[np.arange(slots), jr]
                       - dprobs[np.arange(slots), jr], 0.0)
    rejected = want_j < gamma
    resid = resid[rejected] / resid[rejected].sum(-1, keepdims=True)
    np.testing.assert_allclose(probs.numpy()[rejected], resid, atol=1e-6)
    assert (resid[np.arange(rejected.sum()), repl.numpy()[rejected]]
            > 0).all()


def test_generate_cached_matches_jax(models):
    """Top-k of 1 (filter_thres 0.999 over 64 tokens) makes sampling
    deterministic: the port's tokens equal JAX's, two prompts at once."""
    jt, tp, target = models["target"]
    prime = ((np.arange(20) * 7) % 64).reshape(2, 10)
    want = jax.jit(lambda p, r, x: jdec.generate_cached(
        jt, p, r, x, 12, 64, temperature=1.0, filter_thres=0.999))(
        tp, jax.random.PRNGKey(3), jnp.asarray(prime, jnp.int32))
    got = generate_cached(target, torch.as_tensor(prime), 12, 64,
                          filter_thres=0.999,
                          generator=torch.Generator().manual_seed(3),
                          device="cpu")
    assert got.shape == (2, 12)
    assert got.tolist() == np.asarray(want).tolist()
