"""The port's continuous-batching engine on the CPU: greedy output equal
to the JAX engine's, slot isolation, chunked admission, step_many and the
capacity guards (the JAX engine's own checks in tests/test_serving.py).

Near-greedy sampling (temperature 1e-4) makes the token streams depend on
the logits' argmax alone, so the two engines' different random generators
do not matter; the models' logits agree to ~1e-5 (tests/test_torch_decode.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_cosine_sim_attention_tpu.models import (
    CosineSimCausalTransformer as JaxModel,
)
from flash_cosine_sim_attention_tpu.serving import (
    InferenceEngine as JaxEngine,
)
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    params_from_flax,
)
from flash_cosine_sim_attention_tpu_torch.serving import InferenceEngine

MODEL = dict(num_tokens=64, dim=64, depth=2, max_seq_len=256, heads=4,
             dim_head=16, pre_norm=True, attn_scale=1.0)
GREEDY = dict(temperature=1e-4, seed=42)


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxModel(**MODEL, dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    params = jmodel.init(rng, jax.random.randint(rng, (1, 16), 0, 64))
    model = CosineSimCausalTransformer(**MODEL, device="cpu")
    params_from_flax(jax.tree.map(np.asarray, params), model)
    return jmodel, params, model


def _engine(model, **kw):
    kw = {"num_slots": 4, "capacity": 256, "prompt_buckets": (16, 32, 64),
          "device": "cpu", **kw}
    return InferenceEngine(model, **kw)


def _solo(model, prompt, steps):
    e = _engine(model, **GREEDY)
    s = e.add_request(prompt)
    return [int(e.last_token[s])] + [e.step()[s] for _ in range(steps - 1)]


def test_greedy_stream_matches_jax_engine(setup):
    jmodel, params, model = setup
    prompt = (np.arange(13) * 7) % 64
    jeng = JaxEngine(jmodel, params, num_slots=4, capacity=256,
                     prompt_buckets=(16, 32, 64), **GREEDY)
    s = jeng.add_request(prompt)
    want = [int(jeng.last_token[s])] + [jeng.step()[s] for _ in range(5)]
    assert _solo(model, prompt, 6) == want


def test_interleaved_requests_keep_slots_isolated(setup):
    """A request added mid-stream must not disturb an in-flight one."""
    _, _, model = setup
    pa, pb = np.arange(9) % 64, (np.arange(17) * 3) % 64
    ref_a = _solo(model, pa, 6)
    eng = _engine(model, **GREEDY)
    sa = eng.add_request(pa)
    got_a = [int(eng.last_token[sa]), eng.step()[sa], eng.step()[sa]]
    sb = eng.add_request(pb)
    assert sb != sa
    for _ in range(3):
        out = eng.step()
        got_a.append(out[sa])
        assert sb in out
    assert got_a == ref_a
    eng.finish(sa)
    assert sa in eng.free_slots()
    assert eng.add_request(pa) == sa  # slot reuse


def test_chunked_prefill_matches_one_shot(setup):
    """Chunked admission gives the one-shot greedy continuation and leaves
    the in-flight request alone."""
    _, _, model = setup
    pa, pb = np.arange(9) % 64, (np.arange(40) * 5) % 64  # 3 chunks of 16
    ref_b, ref_a = _solo(model, pb, 4), _solo(model, pa, 9)
    eng = _engine(model, **GREEDY)
    sa = eng.add_request(pa)
    got_a = [int(eng.last_token[sa]), eng.step()[sa]]
    sb = eng.add_request(pb, chunk_tokens=16)
    assert eng.prefilling[sb] and not eng.active[sb]
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
    assert got_b == ref_b
    assert got_a == ref_a[:len(got_a)]


def test_step_many_matches_step(setup):
    _, _, model = setup
    prompt = np.arange(10) % 64
    e1 = _engine(model, num_slots=2, temperature=1.0, seed=11)
    s1 = e1.add_request(prompt)
    ref = [e1.step()[s1] for _ in range(4)]
    e2 = _engine(model, num_slots=2, temperature=1.0, seed=11)
    s2 = e2.add_request(prompt)
    assert e2.step_many(4)[s2] == ref
    assert e2.host_pos[s2] == e1.host_pos[s1]
    assert e2.step()[s2] == e1.step()[s1]


def test_continue_request_and_generate(setup):
    _, _, model = setup
    eng = _engine(model, seed=3)
    s = eng.add_request(np.arange(20) % 64)
    eng.step()
    tok = eng.continue_request(s, np.arange(9) % 64)
    assert 0 <= tok < 64 and eng.host_pos[s] == 30
    assert int(eng.state.pos[s]) == 30
    assert int(eng.state.caches[0].length[s]) == 30
    toks = eng.generate(np.arange(5), max_tokens=5)
    assert len(toks) == 5 and all(0 <= t < 64 for t in toks)


def test_capacity_and_admission_guards(setup):
    _, _, model = setup
    eng = _engine(model, num_slots=1, capacity=36, prompt_buckets=(32,))
    eng.add_request(np.arange(30))
    with pytest.raises(RuntimeError, match="capacity"):
        eng.step_many(7)
    assert len(eng.step_many(6)[0]) == 6  # exactly to capacity is fine
    with pytest.raises(RuntimeError, match="capacity"):
        eng.step()
    with pytest.raises(RuntimeError, match="no free slots"):
        eng.add_request(np.arange(4))

    eng = _engine(model, num_slots=1, capacity=160, prompt_buckets=(32, 128))
    with pytest.raises(ValueError):
        eng.add_request(np.arange(200))
    eng.add_request(np.arange(100) % 64)
    # 100 + 50 fits raw, but the chunk pads to 128: 100 + 128 > 160
    with pytest.raises(RuntimeError, match="capacity"):
        eng.continue_request(0, np.arange(50) % 64)


def test_unported_engine_options_raise(setup):
    """Serving tensor parallelism takes a DeviceMesh (served in
    tests/test_torch_parallel.py); a cache format that neither package
    has is refused (int8 and e4m3 are both served)."""
    _, _, model = setup
    with pytest.raises(TypeError, match="DeviceMesh"):
        _engine(model, mesh=object())
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(model, kv_dtype=torch.float16)
