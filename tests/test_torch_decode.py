"""The port's INT8 KV cache, decode attention and cached decoding against
the JAX package, on the CPU.

Inputs are made with numpy from a seed; the JAX side runs its Pallas
kernels in interpret mode, the port its kernels' plain versions.
Tolerances: int8 codes bit-equal; decode attention 2e-3 (both sides round
q and the V-scaled exp weights to bf16; a rounding tie can fall either
way when the two exps differ in the last bit); f32 logits 1e-4 where no
int8 cache is read and 1e-2 where one is (decode's bf16 roundings).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_cosine_sim_attention_tpu.models import (
    CosineSimCausalTransformer as JaxModel,
)
from flash_cosine_sim_attention_tpu.models import decoding as jdec
from flash_cosine_sim_attention_tpu.ops.reference import (
    l2norm_tensors as jax_l2norm_tensors,
)
from flash_cosine_sim_attention_tpu.quant import decode_kernel as jdk
from flash_cosine_sim_attention_tpu.quant import kv_cache as jkv
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    decode_step,
    init_decode_state,
    params_from_flax,
    prefill,
    prefill_continue,
)
from flash_cosine_sim_attention_tpu_torch.quant import (
    append,
    init_cache,
    quantize_k,
    quantize_v,
    quantized_decode_attention,
    reference_decode_attention,
)

DECODE_TOL = 2e-3
LOGITS_EXACT_TOL = 1e-4
LOGITS_CACHED_TOL = 1e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.dtype in (torch.int8, torch.int32) else (
            x.float().numpy())
    return np.asarray(x)


def _normed(rng, shape, groups=1):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jax_l2norm_tensors(jnp.asarray(x), groups=groups))


def test_quantize_bit_equal():
    rng = np.random.default_rng(0)
    k = _normed(rng, (2, 3, 40, 16), groups=2)
    # exact half-way codes: round half to even on both sides
    k[0, 0, 0, :4] = np.array([0.5, 1.5, -2.5, 3.5], np.float32) / 127
    v = (rng.standard_normal((2, 3, 40, 16)) * 3).astype(np.float32)
    v[0, 0, 0] = 0  # the 1e-8 scale clamp
    np.testing.assert_array_equal(_np(quantize_k(_t(k))),
                                  np.asarray(jkv.quantize_k(jnp.asarray(k))))
    v8, vs = quantize_v(_t(v))
    jv8, jvs = jkv.quantize_v(jnp.asarray(v))
    np.testing.assert_array_equal(_np(v8), np.asarray(jv8))
    np.testing.assert_array_equal(_np(vs), np.asarray(jvs))


def test_append_matches_jax():
    """A 5-token chunk, then two decode appends with an inactive slot."""
    rng = np.random.default_rng(1)
    b, kvh, cap, d = 3, 2, 16, 16
    cache = init_cache(b, kvh, cap, d, "cpu")
    jcache = jkv.init_cache(b, kvh, cap, d)
    steps = [(5, None), (1, np.array([True, False, True])),
             (1, np.array([False, True, True]))]
    for t, active in steps:
        k = _normed(rng, (b, kvh, t, d))
        v = rng.standard_normal((b, kvh, t, d)).astype(np.float32)
        cache = append(cache, _t(k), _t(v),
                       None if active is None else _t(active))
        jcache = jkv.append(jcache, jnp.asarray(k), jnp.asarray(v),
                            None if active is None else jnp.asarray(active))
    np.testing.assert_array_equal(_np(cache.length), np.asarray(jcache.length))
    for slot, n in enumerate(np.asarray(jcache.length)):
        for got, want in zip(cache[:3], jcache[:3]):
            np.testing.assert_array_equal(_np(got)[slot, :, :n],
                                          np.asarray(want)[slot, :, :n])


@pytest.mark.parametrize("kvh,g,d", [(2, 1, 32), (1, 2, 24)])
def test_quantized_decode_matches_jax(kvh, g, d):
    """d=32 takes the JAX lane-packed kernel, d=24 the plain one."""
    rng = np.random.default_rng(2)
    b, cap = 4, 64
    k = _normed(rng, (b, kvh, cap, d))
    v = rng.standard_normal((b, kvh, cap, d)).astype(np.float32)
    lengths = np.array([0, 1, 37, 64], np.int32)
    cache = append(init_cache(b, kvh, cap, d, "cpu"), _t(k), _t(v))
    cache = cache._replace(length=_t(lengths))
    jcache = jkv.append(jkv.init_cache(b, kvh, cap, d), jnp.asarray(k),
                        jnp.asarray(v))._replace(length=jnp.asarray(lengths))
    q = rng.standard_normal((b, kvh * g, d)).astype(np.float32)
    kw = dict(scale=8.0, groups=2)

    got = quantized_decode_attention(_t(q), cache, **kw)
    want = jdk.quantized_decode_attention(jnp.asarray(q), jcache, **kw)
    assert got.shape == (b, kvh * g, d)
    assert np.abs(_np(got) - np.asarray(want)).max() <= DECODE_TOL
    assert np.all(_np(got)[0] == 0)  # an empty slot returns 0
    oracle = reference_decode_attention(_t(q), cache, **kw)
    joracle = jdk.reference_decode_attention(jnp.asarray(q), jcache, **kw)
    assert np.abs(_np(oracle) - np.asarray(joracle)).max() <= 1e-5


MODEL = dict(num_tokens=64, dim=64, depth=2, max_seq_len=128, heads=4,
             dim_head=16, attn_scale=1.0, attn_l2norm_groups=2)


def _models(pre_norm=True):
    import jax

    jmodel = JaxModel(**MODEL, pre_norm=pre_norm, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = CosineSimCausalTransformer(**MODEL, pre_norm=pre_norm,
                                        device="cpu")
    params_from_flax(jax.tree.map(np.asarray, params), tmodel)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("pre_norm", [True, False])
def test_full_forward_matches_jax(pre_norm):
    """params_from_flax + the full causal forward, pre- and post-norm."""
    jmodel, params, tmodel = _models(pre_norm)
    tokens = np.random.default_rng(3).integers(0, 64, (2, 20))
    want = jmodel.apply(params, jnp.asarray(tokens))
    with torch.no_grad():
        got = tmodel(_t(tokens))
    assert np.abs(_np(got) - np.asarray(want)).max() <= LOGITS_EXACT_TOL


def test_prefill_and_decode_match_jax(models):
    """Prefill logits (no cache read) and 4 teacher-forced decode steps
    (int8 cache read)."""
    jmodel, params, tmodel = models
    tokens = np.random.default_rng(4).integers(0, 64, (2, 14))
    jstate = jdec.init_decode_state(jmodel, 2, 32)
    state = init_decode_state(tmodel, 2, 32, device="cpu")
    want, jstate = jdec.prefill(jmodel, params, jstate,
                                jnp.asarray(tokens[:, :10]))
    got, state = prefill(tmodel, state, _t(tokens[:, :10]))
    assert np.abs(_np(got) - np.asarray(want)).max() <= LOGITS_EXACT_TOL
    for t in range(10, 14):
        want, jstate = jdec.decode_step(jmodel, params, jstate,
                                        jnp.asarray(tokens[:, t]))
        got, state = decode_step(tmodel, state, _t(tokens[:, t]))
        assert np.abs(_np(got) - np.asarray(want)).max() <= LOGITS_CACHED_TOL
    np.testing.assert_array_equal(_np(state.pos), np.asarray(jstate.pos))


def test_bucketed_prefill_matches_jax(models):
    """Right-padded prompts with per-slot true lengths."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(5)
    true_len = np.array([11, 7], np.int32)
    tokens = np.zeros((2, 16), np.int64)
    for i, n in enumerate(true_len):
        tokens[i, :n] = rng.integers(0, 64, n)
    want, jstate = jdec.prefill(
        jmodel, params, jdec.init_decode_state(jmodel, 2, 32),
        jnp.asarray(tokens), true_len=jnp.asarray(true_len))
    got, state = prefill(tmodel, init_decode_state(tmodel, 2, 32, "cpu"),
                         _t(tokens), true_len=_t(true_len))
    assert np.abs(_np(got) - np.asarray(want)).max() <= LOGITS_EXACT_TOL
    np.testing.assert_array_equal(_np(state.pos), true_len)
    np.testing.assert_array_equal(_np(state.caches[1].length), true_len)


def test_prefill_continue_matches_jax(models):
    """Two chunks for slot 1: the first over a zero-length history (every
    history key masked), the second over the first's int8 history."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(6)
    jstate = jdec.init_decode_state(jmodel, 2, 48)
    state = init_decode_state(tmodel, 2, 48, device="cpu")
    for n, width in ((12, 16), (5, 16)):
        tokens = np.zeros((1, width), np.int64)
        tokens[0, :n] = rng.integers(0, 64, n)
        true_len = np.array([n], np.int32)
        want, jstate = jdec.prefill_continue(
            jmodel, params, jstate, 1, jnp.asarray(tokens),
            true_len=jnp.asarray(true_len))
        got, state = prefill_continue(tmodel, state, 1, _t(tokens),
                                      true_len=_t(true_len))
        assert np.abs(_np(got) - np.asarray(want)).max() <= LOGITS_CACHED_TOL
        np.testing.assert_array_equal(_np(state.pos), np.asarray(jstate.pos))
        np.testing.assert_array_equal(_np(state.caches[0].length),
                                      np.asarray(jstate.caches[0].length))
