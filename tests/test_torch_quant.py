"""The port's int8 weights, fused QKV and quantized-QK attention against the
JAX package, on the CPU.

Inputs are made with numpy from a seed (or are the JAX model's own init,
carried across with ``params_from_flax``); the JAX side runs its Pallas
kernels in interpret mode, the port its kernels' plain versions.
Tolerances: int8 codes and f32 scales bit-equal; the dequant matmul 1e-5
relative L2 (JAX's own bar for its kernel); fused vs unfused 1e-5 (JAX's
bar; a wider matrix sums in another order); quantized-model f32 logits vs
JAX 1e-4 where no int8 cache is read and 1e-2 where one is, as in
``test_torch_decode.py`` (both sides compute x @ w8 in f32 and scale it
after); ``qk_int8`` f32 forward 1e-5 of max(1, max|v|) (the int8 dot
is exact on both sides; JAX's P.V is a 3-pass bf16 split, good to about
2^-17 of |v|: 3.6e-5 where a causal row sees one key and |v| is 4.4),
``qk_fp8`` f32 forward 1e-4 of it (QK too is JAX's 3-pass split); the
STE gradients 1e-4 of max(1, max|g|), as ``test_torch_backward.py``;
the float32 K7's 2xTF32 split (``dot_tf32x3`` of x and the codes) 1e-5
of max|y| against JAX's kernel at 8192 inputs offset from zero (3.4e-7
read: both sum f32 products of the same codes); a float32 int8-weight
model at head width 128 1e-4 of max|logit| at prefill and at each decode
step (4.1e-6 and under 1e-6 read: both read the same int8 cache).
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
from flash_cosine_sim_attention_tpu.quant import weights as jw
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    decode_step,
    fuse_qkv_params,
    init_decode_state,
    params_from_flax,
    params_to_flax,
    prefill,
)
from flash_cosine_sim_attention_tpu_torch.ops import flash_cosine_sim_attention
from flash_cosine_sim_attention_tpu_torch.quant import (
    dense_apply,
    dequantize_dense_kernel,
    quantize_dense_kernel,
    quantize_params,
    quantized_matmul,
    quantized_matmul_plain,
)
from flash_cosine_sim_attention_tpu_torch.serving import (
    InferenceEngine,
    PagedInferenceEngine,
)

LOGITS_EXACT_TOL = 1e-4
LOGITS_CACHED_TOL = 1e-2
MODEL = dict(num_tokens=64, dim=64, depth=2, max_seq_len=128, heads=4,
             dim_head=16, pre_norm=True, attn_scale=1.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.numpy() if x.dtype == torch.int8 else x.float().numpy()
    return np.asarray(x)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _models(kv_heads=None):
    jmodel = JaxModel(**MODEL, kv_heads=kv_heads, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    tmodel = CosineSimCausalTransformer(**MODEL, kv_heads=kv_heads,
                                        device="cpu")
    return jmodel, params, params_from_flax(params, tmodel)


def test_quantize_dense_kernel_bytes_equal_jax():
    """Random columns, a zero column (the 1e-8 clamp) and one whose absmax
    127 makes the scale exactly 1, so its codes land on .5 ties: both sides
    round them half to even."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((48, 40)) * 0.3).astype(np.float32)
    w[:, 0] = 0
    w[:8, 1] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -2.5]
    w8, scale = quantize_dense_kernel(_t(w))
    jw8, jscale = jw.quantize_dense_kernel(jnp.asarray(w))
    assert w8.dtype == torch.int8 and tuple(scale.shape) == (1, 40)
    np.testing.assert_array_equal(_np(w8), np.asarray(jw8))
    np.testing.assert_array_equal(_np(scale), np.asarray(jscale))
    assert _np(w8)[1:8, 1].tolist() == [2, -4, 0, 0, 2, 126, -2]
    np.testing.assert_array_equal(
        _np(dequantize_dense_kernel(w8, scale)),
        np.asarray(jw.dequantize_dense_kernel(jw8, jscale)))


@pytest.mark.parametrize("fused", [False, True])
def test_quantized_tree_equals_jax(fused):
    """params_to_flax of the quantized (and fused) port model equals JAX's
    quantize_params (and fuse_qkv_params) of the same tree, leaf for leaf;
    params_from_flax loads JAX's tree into another such model."""
    _, params, tmodel = _models()
    jtree = jw.quantize_params(params)
    quantize_params(tmodel)
    if fused:
        jtree = jdec.fuse_qkv_params(jtree)
        fuse_qkv_params(tmodel)
    # K7 reads the codes in place: quantizing a transposed nn.Linear
    # weight must still store them contiguous
    assert all(m.weight_q.is_contiguous() for m in tmodel.modules()
               if hasattr(m, "weight_q"))
    want = dict(_leaves(jtree["params"]))
    got = dict(_leaves(params_to_flax(tmodel)))
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))

    torch.manual_seed(1)
    other = CosineSimCausalTransformer(**MODEL, device="cpu")
    quantize_params(other)
    if fused:
        fuse_qkv_params(other)
    params_from_flax(jax.tree.map(np.asarray, jtree), other)
    for path, arr in _leaves(params_to_flax(other)):
        np.testing.assert_array_equal(arr, want[path], err_msg=str(path))


def test_quantized_matmul_plain_matches_jax_kernel():
    """At tests/test_quant.py's shape, against JAX's Pallas kernel in
    interpret mode; the CPU wrapper takes the plain version."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 512)) * 0.1).astype(np.float32)
    jw8, jscale = jw.quantize_dense_kernel(jnp.asarray(w))
    want = np.asarray(jw.quantized_matmul(
        jnp.asarray(x), jw8, jscale, block_out=256, block_in=128,
        interpret=True))
    w8, scale = quantize_dense_kernel(_t(w))
    before = quantized_matmul.launches
    for got in (quantized_matmul_plain(_t(x), w8, scale),
                quantized_matmul(_t(x), w8, scale)):
        rel = np.linalg.norm(_np(got) - want) / np.linalg.norm(want)
        assert rel < 1e-5, rel
    assert quantized_matmul.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_dense_apply_matches_jax(dtype, use_kernel):
    """Both arms on (2, 5, 64) x (64, 96): the XLA arm rounds x @ w8 to x's
    dtype before scaling, the kernel arm scales the f32 sums (a bf16 ulp
    apart); float kernels and the plain dict as well."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) * 0.2).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = dict(zip(("kernel_q", "kernel_scale"),
                  jw.quantize_dense_kernel(jnp.asarray(w))))
    tp = dict(zip(("kernel_q", "kernel_scale"), quantize_dense_kernel(_t(w))))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for jparams, tparams in ((jp, tp), ({"kernel": jnp.asarray(w)},
                                        {"kernel": _t(w)})):
        want = np.asarray(jw.dense_apply(
            jparams, jnp.asarray(x, jdt), use_kernel=use_kernel
        ).astype(jnp.float32))
        got = dense_apply(tparams, _t(x).to(tdt), use_kernel=use_kernel)
        assert got.dtype == tdt and got.shape == (2, 5, 96)
        assert np.abs(_np(got) - want).max() <= tol * max(
            1.0, np.abs(want).max())


def _prefill_decode(model, tokens, steps=3):
    """Prefill tokens[:, :-steps], then teacher-forced decode steps."""
    n = tokens.shape[1] - steps
    state = init_decode_state(model, tokens.shape[0], 64, device="cpu")
    out, state = prefill(model, state, _t(tokens[:, :n]))
    logits = [out]
    for t in range(n, tokens.shape[1]):
        out, state = decode_step(model, state, _t(tokens[:, t]))
        logits.append(out)
    return [_np(x) for x in logits]


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "kvh2"])
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_fused_qkv_matches_unfused(kv_heads, quant):
    """tests/test_decoding.py:203-241 for the port: one [q | k | v]
    matmul per layer gives the separate projections' prefill and decode
    logits within 1e-5."""
    _, _, model = _models(kv_heads)
    if quant:
        quantize_params(model)
    tokens = np.random.default_rng(7).integers(0, 64, (2, 15))
    base = _prefill_decode(model, tokens)
    fuse_qkv_params(model)
    attn = model.attn[0]
    assert attn.to_qkv is not None and not hasattr(attn, "to_q")
    w = attn.to_qkv.weight_q if quant else attn.to_qkv.weight.T
    assert tuple(w.shape) == (64, (4 + 2 * (kv_heads or 4)) * 16)
    for a, b in zip(base, _prefill_decode(model, tokens)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_quantized_fused_model_matches_jax():
    """Quantized, fused prefill (no cache read) and 3 decode steps (int8
    cache read): the port on the CPU against JAX's jitted model functions
    on the same tree, grouped-query heads."""
    jmodel, params, model = _models(kv_heads=2)
    jtree = jdec.fuse_qkv_params(jw.quantize_params(params))
    fuse_qkv_params(quantize_params(model))
    tokens = np.random.default_rng(8).integers(0, 64, (2, 15))
    got = _prefill_decode(model, tokens)
    jprefill = jax.jit(lambda p, s, t: jdec.prefill(jmodel, p, s, t))
    jstep = jax.jit(lambda p, s, t: jdec.decode_step(jmodel, p, s, t))
    out, state = jprefill(jtree, jdec.init_decode_state(jmodel, 2, 64),
                          jnp.asarray(tokens[:, :12]))
    assert np.abs(got[0] - np.asarray(out)).max() <= LOGITS_EXACT_TOL
    for i, t in enumerate(range(12, 15)):
        out, state = jstep(jtree, state, jnp.asarray(tokens[:, t]))
        err = np.abs(got[i + 1] - np.asarray(out)).max()
        assert err <= LOGITS_CACHED_TOL, (i, err)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engines_serve_quantized_fused_model(paged):
    """Both engines serve the quantized, fused model unchanged: near-greedy
    tokens (temperature 1e-4) equal the argmax of the port's own prefill /
    decode_step logits on the same tokens."""
    _, _, model = _models()
    fuse_qkv_params(quantize_params(model))
    prompt = (np.arange(13) * 5) % 64
    kw = dict(num_slots=2, prompt_buckets=(16, 32), temperature=1e-4,
              seed=3, device="cpu")
    engine = (PagedInferenceEngine(model, page_size=128, num_pages=3,
                                   max_pages_per_slot=1, **kw) if paged
              else InferenceEngine(model, capacity=64, **kw))
    slot = engine.add_request(prompt)
    got = [int(engine.last_token[slot])]
    got += [engine.step()[slot] for _ in range(5)]

    state = init_decode_state(model, 1, 64, device="cpu")
    logits, state = prefill(model, state, _t(prompt[None]))
    want = [int(logits.argmax(-1))]
    for _ in range(5):
        logits, state = decode_step(model, state,
                                    torch.tensor([want[-1]]))
        want.append(int(logits.argmax(-1)))
    assert got == want


def _qk_inputs(shape=(2, 4, 192, 64)):
    rng = np.random.default_rng(13)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


# tests/test_fused_parity.py:192-230's shape for both flags, and qk_int8 at
# d 128 (the 0.81B model's heads) and d 512 (the kernels' wide route)
QK_CASES = [pytest.param(flag, causal, (2, 4, 192, 64),
                         id=f"{flag}-{causal}")
            for flag in ("qk_int8", "qk_fp8") for causal in (False, True)]
QK_CASES += [pytest.param("qk_int8", True, (1, 2, 128, d),
                          id=f"qk_int8-True-d{d}") for d in (128, 512)]


@pytest.mark.parametrize("flag,causal,shape", QK_CASES)
def test_quantized_qk_matches_jax(flag, causal, shape):
    """Forward and straight-through gradients in q, k and v against the
    JAX op in interpret mode."""
    q, k, v = _qk_inputs(shape)
    kw = {"causal": causal, flag: True}
    do = np.random.default_rng(14).standard_normal(q.shape).astype(np.float32)
    o_j, vjp = jax.vjp(lambda *a: jax_flash(*a, **kw),
                       *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))

    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    o_t = flash_cosine_sim_attention(qt, kt, vt, **kw)
    grads_t = torch.autograd.grad(o_t, (qt, kt, vt), _t(do))

    tol = 1e-5 if flag == "qk_int8" else 1e-4
    # o mixes v's rows: its error is taken in units of max(1, max|v|)
    err = np.abs(_np(o_t) - np.asarray(o_j)).max() / max(1.0, np.abs(v).max())
    assert err <= tol, err
    for name, x, y in zip("qkv", grads_t, grads_j):
        y = np.asarray(y)
        assert np.isfinite(_np(x)).all(), name
        err = np.abs(_np(x) - y).max() / max(1.0, np.abs(y).max())
        assert err <= 1e-4, (name, err)


def test_float32_quantized_matmul_split_matches_jax_kernel():
    """K7's float32 arithmetic on the card, 2xTF32 (``dot_tf32x3`` of x and
    the codes, which are exact in TF32, times the scale), at ff_out's 8192
    inputs with x and the weights offset from zero, against JAX's Pallas
    kernel in interpret mode in float32: 1e-5 of max|y|."""
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3

    rng = np.random.default_rng(20)
    x = (rng.standard_normal((8, 8192)) + 1.0).astype(np.float32)
    w = (rng.standard_normal((8192, 256)) * 0.02 + 0.01).astype(np.float32)
    jw8, jscale = jw.quantize_dense_kernel(jnp.asarray(w))
    want = np.asarray(jw.quantized_matmul(
        jnp.asarray(x), jw8, jscale, interpret=True))
    w8, scale = quantize_dense_kernel(_t(w))
    got = _np(dot_tf32x3(_t(x), w8.float()) * scale)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_float32_quantized_fused_model_at_head_width_128_matches_jax():
    """The 0.81B model's head width served in float32 with int8 weights
    and fused QKV, cut to depth 2, dim 256 and 2 heads of 128: the port's
    prefill and 3 decode steps on the CPU against JAX's jitted model
    functions on the same tree, at 1e-4 of max|logit|."""
    cfg = dict(num_tokens=64, dim=256, depth=2, max_seq_len=128, heads=2,
               dim_head=128, pre_norm=True, attn_scale=1.0)
    jmodel = JaxModel(**cfg, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(20), jnp.zeros((1, 8), jnp.int32)))
    model = params_from_flax(params, CosineSimCausalTransformer(
        **cfg, device="cpu"))
    jtree = jdec.fuse_qkv_params(jw.quantize_params(params))
    fuse_qkv_params(quantize_params(model))
    tokens = np.random.default_rng(21).integers(0, 64, (2, 15))
    got = _prefill_decode(model, tokens)
    jprefill = jax.jit(lambda p, s, t: jdec.prefill(jmodel, p, s, t))
    jstep = jax.jit(lambda p, s, t: jdec.decode_step(jmodel, p, s, t))
    out, state = jprefill(jtree, jdec.init_decode_state(jmodel, 2, 64),
                          jnp.asarray(tokens[:, :12]))
    want = [np.asarray(out)]
    for t in range(12, 15):
        out, state = jstep(jtree, state, jnp.asarray(tokens[:, t]))
        want.append(np.asarray(out))
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= 1e-4, (i, err)
