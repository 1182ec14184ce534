"""The port's e4m3 cache format, paged KV cache, paged decode and paged
model functions against the JAX package, on the CPU.

Inputs are made with numpy from a seed; the JAX side runs its Pallas
kernels in interpret mode (or its XLA path where named), the port its
kernels' plain versions.  Tolerances: quantized codes and pools equal
byte for byte; decode attention 2e-3 (both sides round q and the exp
weights to bf16, and a rounding tie can fall either way when the two
exps differ in the last bit); the port's paged against its contiguous
decode 1e-6 (the same plain maths after the gather, summed in another
order); f32 logits 1e-4 where no quantized cache is read and 1e-2 where
one is (decode's bf16 roundings).
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
from flash_cosine_sim_attention_tpu.ops.reference import (
    l2norm_tensors as jax_l2norm_tensors,
)
from flash_cosine_sim_attention_tpu.quant import kv_cache as jkv
from flash_cosine_sim_attention_tpu.quant import paged as jpg
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    decode_step_paged,
    init_paged_decode_state,
    params_from_flax,
    prefill_continue_paged,
    prefill_paged,
)
from flash_cosine_sim_attention_tpu_torch.quant import (
    FP8_DTYPE,
    PageAllocator,
    append,
    append_paged,
    init_cache,
    init_paged_cache,
    paged_decode_attention,
    quantize_k,
    quantize_v,
    quantized_decode_attention,
)

DECODE_TOL = 2e-3
PAGED_VS_CONTIGUOUS_TOL = 1e-6
LOGITS_EXACT_TOL = 1e-4
LOGITS_CACHED_TOL = 1e-2
KV = {"int8": (torch.int8, jnp.int8),
      "e4m3": (FP8_DTYPE, jnp.float8_e4m3fn)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _bytes(x):
    """Codes of either framework as numpy, e4m3 viewed as its uint8 bytes."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.dtype == FP8_DTYPE else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype == jnp.float8_e4m3fn else x


def _normed(rng, shape, groups=1):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jax_l2norm_tensors(jnp.asarray(x), groups=groups))


def test_fp8_quantize_bytes_equal_jax():
    rng = np.random.default_rng(0)
    k = _normed(rng, (2, 3, 40, 16), groups=2)
    v = (rng.standard_normal((2, 3, 40, 16)) * 60).astype(np.float32)
    # the +-448 clip, and exact ties of e4m3 (round half to even)
    v[0, 0, 0, :8] = [447.9, -448.0, 600.0, -1e4, 1.0625, 1.1875, -0.0, 3e-4]
    want_k = jkv.quantize_k(jnp.asarray(k), jnp.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(quantize_k(_t(k), FP8_DTYPE)),
                                  _bytes(want_k))
    v8, vs = quantize_v(_t(v), FP8_DTYPE)
    jv8, jvs = jkv.quantize_v(jnp.asarray(v), jnp.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(v8), _bytes(jv8))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))


# slots, max pages, table rows, appends (tokens, active mask or None)
APPENDS = {
    "one-write": (2, 2, [[5, 2], [3, 6]], [(128, None)]),
    "chunks": (2, 2, [[5, 2], [3, 6]], [(5, None), (59, None), (64, None)]),
    # 250 tokens, then 20: positions 256..269 lie past the table
    "past-table": (1, 2, [[1, 2]], [(250, None), (20, None)]),
    "inactive": (3, 2, [[4, 1], [6, 2], [3, 5]],
                 [(70, None), (1, [True, False, True]),
                  (1, [False, True, True])]),
}


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("case", sorted(APPENDS))
def test_append_paged_matches_jax(case, kv):
    """Whole pools, null page included: no two writes of one append share
    a cell here (colliding null-page writes have no defined order)."""
    slots, mp, table, steps = APPENDS[case]
    tdt, jdt = KV[kv]
    rng = np.random.default_rng(1)
    kvh, d, ps, pages = 2, 16, 128, 7
    cache = init_paged_cache(pages, kvh, ps, d, slots, mp, kv_dtype=tdt,
                             device="cpu")
    cache = cache._replace(page_table=_t(np.int32(table)))
    jcache = jpg.init_paged_cache(pages, kvh, ps, d, slots, mp, kv_dtype=jdt)
    jcache = jcache._replace(page_table=jnp.asarray(table, jnp.int32))
    for t, active in steps:
        k = _normed(rng, (slots, kvh, t, d))
        v = (rng.standard_normal((slots, kvh, t, d)) * 3).astype(np.float32)
        cache = append_paged(cache, _t(k), _t(v),
                             None if active is None else _t(active))
        jcache = jpg.append_paged(
            jcache, jnp.asarray(k), jnp.asarray(v),
            None if active is None else jnp.asarray(active))
    for name in ("k8", "v8", "v_scale", "length"):
        np.testing.assert_array_equal(_bytes(getattr(cache, name)),
                                      _bytes(getattr(jcache, name)), name)


def _paged_pair(rng, kv, b, kvh, n, d, lengths, ps=128, with_jax=True):
    """The same tokens appended into the port's and (``with_jax``) JAX's
    paged caches on a shuffled page table; returns (port cache, JAX cache
    or None, (k, v))."""
    tdt, jdt = KV[kv]
    mp = -(-n // ps)
    pages = b * mp + 3
    table = rng.permutation(np.arange(1, pages))[:b * mp].reshape(b, mp)
    k = _normed(rng, (b, kvh, n, d))
    v = (rng.standard_normal((b, kvh, n, d)) * 2).astype(np.float32)
    cache = init_paged_cache(pages, kvh, ps, d, b, mp, kv_dtype=tdt,
                             device="cpu")
    cache = append_paged(cache._replace(page_table=_t(table.astype(np.int32))),
                         _t(k), _t(v))._replace(length=_t(lengths))
    if not with_jax:
        return cache, None, (k, v)
    jcache = jpg.init_paged_cache(pages, kvh, ps, d, b, mp, kv_dtype=jdt)
    jcache = jpg.append_paged(
        jcache._replace(page_table=jnp.asarray(table, jnp.int32)),
        jnp.asarray(k), jnp.asarray(v))._replace(length=jnp.asarray(lengths))
    return cache, jcache, (k, v)


@pytest.mark.parametrize("n", [100, 256])
@pytest.mark.parametrize("kv", sorted(KV))
def test_paged_decode_matches_jax(kv, n):
    """GQA 8/2 against JAX's XLA gather path, and at the two-page length
    also against its Pallas kernel (interpret mode, the slow part)."""
    rng = np.random.default_rng(2)
    b, kvh, h, d = 2, 2, 8, 32
    lengths = np.array([n, n - 37], np.int32)
    cache, jcache, _ = _paged_pair(rng, kv, b, kvh, n, d, lengths)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kw = dict(scale=8.0, groups=2)
    got = paged_decode_attention(_t(q), cache, **kw).numpy()
    assert got.shape == (b, h, d)
    for use_kernel in (False, True) if n > 128 else (False,):
        want = jpg.paged_decode_attention(jnp.asarray(q), jcache,
                                          use_kernel=use_kernel, **kw)
        assert np.abs(got - np.asarray(want)).max() <= DECODE_TOL, use_kernel


@pytest.mark.parametrize("kv", sorted(KV))
def test_paged_decode_matches_contiguous(kv):
    """The same tokens in a contiguous cache and in shuffled pages give the
    same plain decode; an empty slot returns exactly 0."""
    rng = np.random.default_rng(3)
    b, kvh, g, d, n = 3, 2, 4, 16, 300
    lengths = np.array([0, 129, 300], np.int32)
    paged, _, (k, v) = _paged_pair(rng, kv, b, kvh, n, d, lengths,
                                   with_jax=False)
    cont = append(init_cache(b, kvh, n, d, "cpu", kv_dtype=KV[kv][0]),
                  _t(k), _t(v))._replace(length=_t(lengths))
    q = _t(rng.standard_normal((b, kvh * g, d)).astype(np.float32))
    got = paged_decode_attention(q, paged, scale=8.0)
    want = quantized_decode_attention(q, cont, scale=8.0)
    assert (got - want).abs().max().item() <= PAGED_VS_CONTIGUOUS_TOL
    assert got[0].abs().max().item() == 0


def test_page_allocator_matches_jax():
    ours, theirs = PageAllocator(10), jpg.PageAllocator(10)
    script = [("alloc", 3), ("alloc", 2), ("release", [2, 0, 5]),
              ("alloc", 4), ("release", [1, 7]), ("alloc", 3)]
    for op, arg in script:
        assert getattr(ours, op)(arg) == getattr(theirs, op)(arg), (op, arg)
        assert ours.free == theirs.free
    for alloc in (ours, theirs):
        with pytest.raises(RuntimeError, match="exhausted"):
            alloc.alloc(len(alloc.free) + 1)


MODEL = dict(num_tokens=64, dim=64, depth=2, max_seq_len=512, heads=4,
             dim_head=16, attn_scale=1.0, attn_l2norm_groups=2,
             pre_norm=True)


def test_paged_model_functions_match_jax():
    """Teacher-forced through shuffled pages of three slots: two bucketed
    prefills, decode steps with an idle slot, a continuation chunk that
    crosses a page boundary, one more decode step.  The JAX prefill and
    decode steps and the continuation are jitted, each compiled once."""
    jmodel = JaxModel(**MODEL, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    model = CosineSimCausalTransformer(**MODEL, device="cpu")
    params_from_flax(jax.tree.map(np.asarray, params), model)
    jprefill = jax.jit(lambda s, slot, t, n: jdec.prefill_paged(
        jmodel, params, s, slot, t, true_len=n))
    jdecode = jax.jit(lambda s, t, a: jdec.decode_step_paged(
        jmodel, params, s, t, a))
    rng = np.random.default_rng(4)
    table = np.array([[7, 3, 0], [2, 9, 5], [0, 0, 0]], np.int32)
    state = init_paged_decode_state(model, 3, 10, 128, 3, device="cpu")
    state.caches[0].page_table.copy_(_t(table))
    jstate = jdec.init_paged_decode_state(jmodel, 3, 10, 128, 3)
    jstate = jstate._replace(caches=tuple(
        c._replace(page_table=jnp.asarray(table)) for c in jstate.caches))

    def check(got, want, tol):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= tol

    for slot, n in ((1, 20), (0, 10)):
        tokens = np.zeros((1, 32), np.int64)
        tokens[0, :n] = rng.integers(0, 64, n)
        true_len = np.array([n], np.int32)
        got, state = prefill_paged(model, state, slot, _t(tokens),
                                   true_len=_t(true_len))
        want, jstate = jprefill(jstate, jnp.int32(slot),
                                jnp.asarray(tokens, jnp.int32),
                                jnp.asarray(true_len))
        check(got, want, LOGITS_EXACT_TOL)

    active = np.array([True, True, False])

    def decode():
        nonlocal state, jstate
        tok = rng.integers(0, 64, 3)
        got, state = decode_step_paged(model, state, _t(tok), _t(active))
        want, jstate = jdecode(jstate, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(active))
        check(got[active], np.asarray(want)[active], LOGITS_CACHED_TOL)

    decode()
    decode()
    tokens = np.zeros((1, 160), np.int64)
    tokens[0, :140] = rng.integers(0, 64, 140)   # 22 + 140 tokens: 2 pages
    got, state = prefill_continue_paged(model, state, 1, _t(tokens),
                                        true_len=_t([140]))
    want, jstate = jax.jit(lambda s, t, n: jdec.prefill_continue_paged(
        jmodel, params, s, jnp.int32(1), t, true_len=n))(
            jstate, jnp.asarray(tokens), jnp.asarray([140], jnp.int32))
    check(got, want, LOGITS_CACHED_TOL)
    decode()
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(state.pos.numpy(), [13, 163, 0])
    for c, jc in zip(state.caches, jstate.caches):
        np.testing.assert_array_equal(c.length.numpy(), np.asarray(jc.length))
