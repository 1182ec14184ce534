"""Head widths that are not kernel widths, and query-head groups past 8,
on the CPU: the port against itself (padding) and against the JAX package.

On the card a head dim d that is a multiple of 8 up to 128 runs the kernel
built for the next of (16, 32, 64, 96, 128): the forward and backward
wrappers zero-pad q, k, v and dO' and slice the outputs back, the decode
kernels read d-byte code rows in place, and a kv head's group of query
heads of any size is served in chunks of 8.  Here the padding is held
exact on the plain path, and the port's op, decode and both engines at
such widths and groups are held against JAX (its Pallas kernels in
interpret mode, as the JAX suite runs them; its model functions jitted).

Tolerances: padded against unpadded 1e-6 of max(1, max|y|) (f32: zero
lanes add exact zeros, but the CPU's matrix products block a wider
contraction differently, so the f32 sums come in another order); the op against JAX's
at the JAX suite's bars (f32 1e-4 of max(1, max|g|), bf16 0.15); decode
2e-3 and f32 logits through a quantized cache 1e-2, as in
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
from flash_cosine_sim_attention_tpu.ops import (
    flash_cosine_sim_attention as jax_flash,
)
from flash_cosine_sim_attention_tpu.ops.reference import (
    l2norm_tensors as jax_l2norm_tensors,
)
from flash_cosine_sim_attention_tpu.quant import decode_kernel as jdk
from flash_cosine_sim_attention_tpu.quant import kv_cache as jkv
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    flax_param_shapes,
    params_from_flax,
)
from flash_cosine_sim_attention_tpu_torch.ops import (
    flash_attention_backward_plain,
    flash_attention_forward_plain,
    flash_cosine_sim_attention,
    l2norm_tensors,
)
from flash_cosine_sim_attention_tpu_torch.ops.blocks import (
    ALLOWED_DIM_HEADS,
    kernel_head_dim,
)
from flash_cosine_sim_attention_tpu_torch.ops.reference import pad_head_dim
from flash_cosine_sim_attention_tpu_torch.quant import (
    FP8_DTYPE,
    append,
    init_cache,
    quantized_decode_attention,
)
from flash_cosine_sim_attention_tpu_torch.serving import (
    InferenceEngine,
    PagedInferenceEngine,
)

PAD_TOL = 1e-6
TOL = {"float32": 1e-4, "bfloat16": 0.15}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DECODE_TOL = 2e-3
LOGITS_CACHED_TOL = 1e-2
KV = {"int8": (torch.int8, jnp.int8), "e4m3": (FP8_DTYPE, jnp.float8_e4m3fn)}


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(TORCH[dtype])


def _j(x, dtype="float32"):
    return jnp.asarray(np.asarray(x, np.float32), JNP[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("d,want", [(8, 16), (16, 16), (48, 64), (80, 96),
                                    (104, 128), (128, 128)])
def test_kernel_head_dim_is_the_next_width(d, want):
    assert kernel_head_dim(d, "forward") == want


@pytest.mark.parametrize("d", [136, 256, 12, 0])
def test_kernel_head_dim_refuses_and_names_the_widths(d):
    with pytest.raises(ValueError, match="multiples of 8 up to 128") as err:
        kernel_head_dim(d, "backward")
    assert str(ALLOWED_DIM_HEADS) in str(err.value)
    assert "backward" in str(err.value)


# b, h, kvh, seq_q, seq_k, causal, key mask
PAD_CASES = {"causal-gqa": (1, 4, 2, 70, 90, True, False),
             "key-mask": (2, 2, 2, 33, 65, False, True)}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
@pytest.mark.parametrize("d", [8, 48, 80])
def test_padding_is_exact_on_the_plain_path(d, case):
    """The wrappers' zero padding, run through the plain versions: forward
    o and inv_l, and backward dq, dk, dv, sliced back, equal the unpadded
    ones in f32."""
    b, h, kvh, sq, sk, causal, has_mask = PAD_CASES[case]
    rng = np.random.default_rng(d)
    q, k = l2norm_tensors(_t(rng.standard_normal((b, h, sq, d))),
                          _t(rng.standard_normal((b, kvh, sk, d))))
    v = _t(rng.standard_normal((b, kvh, sk, d)))
    do = _t(rng.standard_normal((b, h, sq, d)))
    mask = torch.from_numpy(rng.random((b, sk)) > 0.3) if has_mask else None
    mask = None if mask is None else mask.index_fill(1, torch.tensor([0]),
                                                     False)
    bias = _t(0.5 * rng.standard_normal((h, sq, sk)))
    kw = dict(bias_batch_dim=False, scale=8.0, causal=causal)
    width = kernel_head_dim(d, "forward")
    pad = lambda t: pad_head_dim(t, width)  # noqa: E731

    o, inv_l = flash_attention_forward_plain(q, k, v, mask, bias, **kw)
    o_p, inv_p = flash_attention_forward_plain(pad(q), pad(k), pad(v), mask,
                                               bias, **kw)
    assert o_p.shape[-1] == width and o_p[..., d:].abs().max().item() == 0
    assert (o_p[..., :d] - o).abs().max().item() <= PAD_TOL
    assert ((inv_p - inv_l) / inv_l).abs().max().item() <= PAD_TOL

    want = flash_attention_backward_plain(do, o, inv_l, q, k, v, mask, bias,
                                          **kw)
    got = flash_attention_backward_plain(pad(do), o_p, inv_p, pad(q), pad(k),
                                         pad(v), mask, bias, **kw)
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        if name != "db":
            assert x[..., d:].abs().max().item() == 0, name
            x = x[..., :d]
        err = (x - y).abs().max().item() / max(1.0, y.abs().max().item())
        assert err <= PAD_TOL, (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_at_d48_matches_jax_fused(dtype):
    """The port's op at d 48 (zero-padded to 64 on the card) against JAX's
    fused op, as tests/test_fused_parity.py runs it at d 48: forward and
    the gradients of q, k, v and the bias, GQA and causal."""
    rng = np.random.default_rng(48)
    b, h, kvh, s, d = 2, 4, 2, 63, 48
    q = rng.standard_normal((b, h, s, d))
    k, v = (rng.standard_normal((b, kvh, s, d)) for _ in range(2))
    bias = 0.5 * rng.standard_normal((h, s, s))
    do = rng.standard_normal((b, h, s, d))
    kw = dict(causal=True, scale=8.0)

    o_j, vjp = jax.vjp(lambda q, k, v, bias: jax_flash(q, k, v, attn_bias=bias,
                                                       **kw),
                       *(_j(x, dtype) for x in (q, k, v, bias)))
    want = vjp(_j(do, dtype))
    tin = [_t(x, dtype).requires_grad_() for x in (q, k, v, bias)]
    o_t = flash_cosine_sim_attention(*tin[:3], attn_bias=tin[3], **kw)
    got = torch.autograd.grad(o_t, tin, _t(do, dtype))

    def err(x, y):
        e = np.abs(_np(x) - _np(y)).max()
        return e / max(1.0, np.abs(_np(y)).max()) if dtype == "float32" else e

    assert o_t.dtype == TORCH[dtype] and err(o_t, o_j) <= TOL[dtype]
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        assert tuple(x.shape) == tuple(y.shape), name
        assert err(x, y) <= TOL[dtype], (name, err(x, y))


@pytest.mark.parametrize("kv", sorted(KV))
def test_decode_group16_d8_matches_jax(kv):
    """16 query heads on one kv head at d 8: the port's decode (two chunks
    of 8 heads on the card, d-byte rows read in place) against JAX's
    quantized_decode_attention, int8 and e4m3, with an empty slot."""
    tdt, jdt = KV[kv]
    rng = np.random.default_rng(16)
    b, kvh, g, cap, d = 3, 1, 16, 40, 8
    k = np.array(jax_l2norm_tensors(jnp.asarray(
        rng.standard_normal((b, kvh, cap, d)).astype(np.float32))))
    v = (3 * rng.standard_normal((b, kvh, cap, d))).astype(np.float32)
    lengths = np.array([0, 1, 37], np.int32)
    cache = append(init_cache(b, kvh, cap, d, "cpu", kv_dtype=tdt),
                   torch.from_numpy(k), torch.from_numpy(v))
    cache = cache._replace(length=torch.from_numpy(lengths))
    jcache = jkv.append(jkv.init_cache(b, kvh, cap, d, kv_dtype=jdt),
                        jnp.asarray(k), jnp.asarray(v))
    jcache = jcache._replace(length=jnp.asarray(lengths))
    q = rng.standard_normal((b, kvh * g, d)).astype(np.float32)

    got = quantized_decode_attention(torch.from_numpy(q), cache, scale=8.0)
    want = jdk.quantized_decode_attention(jnp.asarray(q), jcache, scale=8.0)
    assert got.shape == (b, kvh * g, d)
    assert np.abs(_np(got) - np.asarray(want)).max() <= DECODE_TOL
    assert np.all(_np(got)[0] == 0)


# depth 2, dim 128, 16 query heads of 8 lanes on one kv head: d 8, g 16
MQA_MODEL = dict(num_tokens=64, dim=128, depth=2, max_seq_len=256, heads=16,
                 kv_heads=1, dim_head=8, pre_norm=True, attn_scale=1.0)


def _random_flax_params(model, seed):
    """Random weights in the flax layout, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "kernel":
            return rng.standard_normal(shape, np.float32) / np.sqrt(shape[0])
        if name == "embedding":
            return 0.02 * rng.standard_normal(shape, np.float32)
        return (np.ones if name == "scale" else np.zeros)(shape, np.float32)

    def walk(node):
        return {k: leaf(k, v) if isinstance(v, tuple) else walk(v)
                for k, v in node.items()}
    return walk(flax_param_shapes(model))


@pytest.fixture(scope="module")
def mqa_models():
    """Both models on one set of numpy seed weights, carried to the port's
    by models/convert.py; the JAX prefill and decode step jitted once."""
    model = CosineSimCausalTransformer(**MQA_MODEL, device="cpu")
    flax = _random_flax_params(model, 128)
    params_from_flax(flax, model)
    jmodel = JaxModel(**MQA_MODEL, dtype=jnp.float32)
    params = {"params": jax.tree.map(jnp.asarray, flax)}
    jprefill = jax.jit(lambda s, t, n: jdec.prefill(jmodel, params, s, t,
                                                    true_len=n))
    jdecode = jax.jit(lambda s, t: jdec.decode_step(jmodel, params, s, t))
    return jmodel, model, jprefill, jdecode


@pytest.mark.parametrize("engine", ["contiguous", "paged"])
def test_mqa_d8_engines_match_jax(mqa_models, engine):
    """Both engines prefill a 13-token prompt and decode 3 tokens through
    the heads-16, kv_heads=1 model; every logits row they sample from is
    held against the jitted JAX prefill and decode_step fed the same
    tokens."""
    jmodel, model, jprefill, jdecode = mqa_models
    if engine == "paged":
        eng = PagedInferenceEngine(
            model, num_slots=1, page_size=128, num_pages=4,
            max_pages_per_slot=2, prompt_buckets=(32,), device="cpu")
    else:
        eng = InferenceEngine(model, num_slots=1, capacity=64,
                              prompt_buckets=(32,), device="cpu")
    seen = []

    def argmax(logits):   # record the logits, sample greedily
        seen.append(logits.float().numpy())
        return logits.argmax(-1)

    eng._sample = argmax
    prompt = (np.arange(13) * 5) % 64
    slot = eng.add_request(prompt)
    toks = [int(eng.last_token[slot])] + [eng.step()[slot] for _ in range(3)]

    state = jdec.init_decode_state(jmodel, 1, 64)
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, :13] = prompt
    want, state = jprefill(state, jnp.asarray(tokens),
                           jnp.asarray([13], jnp.int32))
    wants = [want]
    for tok in toks[:3]:
        want, state = jdecode(state, jnp.asarray([tok], jnp.int32))
        wants.append(want)
    assert len(seen) == len(wants) == 4
    for got, want in zip(seen, wants):
        assert np.abs(got - np.asarray(want)).max() <= LOGITS_CACHED_TOL
