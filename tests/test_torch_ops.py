"""The port's forward op and plain oracles against the JAX package, on
the CPU.

Inputs are made with numpy from a seed and go through the JAX function
(its Pallas kernel in interpret mode, as the JAX suite runs it) and
through the port's counterpart, whose CPU path is the plain version of
the Hopper kernel.  Tolerances: float32 1e-4 (the JAX suite's bar; both
sides sum in f32), bfloat16 0.15 (the JAX suite's bar: the JAX kernel
rounds the scaled q tile and the exp weights to bf16, the port keeps them
in f32), float16 0.1 (upstream's f16 bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_cosine_sim_attention_tpu.ops import (
    flash_cosine_sim_attention as jax_flash,
    plain_cosine_sim_attention as jax_plain,
)
from flash_cosine_sim_attention_tpu.ops.fwd_kernel import (
    flash_attention_forward as jax_forward,
)
from flash_cosine_sim_attention_tpu.ops.reference import (
    l2norm_tensors as jax_l2norm_tensors,
    non_cosine_sim_attention as jax_non_cosine,
    streaming_cosine_sim_attention as jax_streaming,
)
from flash_cosine_sim_attention_tpu_torch.ops import (
    flash_attention_forward,
    flash_cosine_sim_attention,
    l2norm_tensors,
    non_cosine_sim_attention,
    plain_cosine_sim_attention,
    streaming_cosine_sim_attention,
)


TOL = {"float32": 1e-4, "bfloat16": 0.15, "float16": 0.1}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


def _normed(rng, shape, groups=1):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jax_l2norm_tensors(jnp.asarray(x), groups=groups))


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(TORCH[dtype])


def _j(x, dtype="float32"):
    return jnp.asarray(np.asarray(x, np.float32), JNP[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# b, h, kvh, seq_q, seq_k, d, causal, mask, bias ("h" / "b" leading dim)
FWD_CASES = {
    "causal-63": (2, 2, 2, 63, 63, 16, True, False, None),
    "causal-128-gqa": (1, 4, 2, 128, 128, 32, True, False, None),
    "mask-fully-masked-row": (2, 2, 2, 63, 128, 16, False, True, None),
    "bias-heads": (1, 2, 2, 63, 63, 16, True, False, "h"),
    "bias-batch-gqa": (2, 4, 1, 63, 63, 16, False, False, "b"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_matches_jax(case, dtype):
    b, h, kvh, sq, sk, d, causal, has_mask, bias_kind = FWD_CASES[case]
    rng = np.random.default_rng(0)
    q = _normed(rng, (b, h, sq, d))
    k = _normed(rng, (b, kvh, sk, d))
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    mask = bias = None
    if has_mask:
        mask = rng.random((b, sk)) > 0.3
        mask[1] = False                       # batch 1: every row sees nothing
    if bias_kind is not None:
        bias = rng.standard_normal(
            (b if bias_kind == "b" else h, sq, sk)).astype(np.float32)
    kw = dict(bias_batch_dim=bias_kind == "b", scale=8.0, causal=causal)

    o_j, l_j = jax_forward(
        _j(q, dtype), _j(k, dtype), _j(v, dtype),
        None if mask is None else jnp.asarray(mask),
        None if bias is None else _j(bias), interpret=True, **kw)
    o_t, l_t = flash_attention_forward(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        None if mask is None else torch.from_numpy(mask),
        None if bias is None else _t(bias), **kw)

    assert o_t.dtype == TORCH[dtype] and tuple(l_t.shape) == (b, h, sq, 1)
    assert np.abs(_np(o_t) - _np(o_j)).max() <= TOL[dtype]
    rel = np.abs(_np(l_t) / _np(l_j) - 1).max()
    assert rel <= (1e-4 if dtype == "float32" else 0.05), rel
    if has_mask:  # fully masked rows: o = 0, inv_l = 1 / EPS
        assert np.all(_np(o_t)[1] == 0)
        np.testing.assert_allclose(_np(l_t)[1], 1e10, rtol=1e-6)


@pytest.mark.parametrize("layout", ["merged-batch-heads", "single-head-kv",
                                    "float16"])
def test_flash_cosine_sim_attention_matches_jax(layout):
    rng = np.random.default_rng(1)
    dtype = "float16" if layout == "float16" else "float32"
    if layout == "merged-batch-heads":
        q, k, v = (rng.standard_normal((4, 40, 16)) for _ in range(3))
        kw = dict(causal=True)
    elif layout == "single-head-kv":
        q = rng.standard_normal((2, 3, 40, 16))
        k, v = (rng.standard_normal((2, 40, 16)) for _ in range(2))
        kw = dict(causal=True, groups=2)
    else:
        q, k, v = (rng.standard_normal((1, 2, 40, 32)) for _ in range(3))
        kw = dict(causal=False, scale=4.0)
    o_j = jax_flash(_j(q, dtype), _j(k, dtype), _j(v, dtype), **kw)
    o_t = flash_cosine_sim_attention(_t(q, dtype), _t(k, dtype),
                                     _t(v, dtype), **kw)
    assert o_t.shape == tuple(o_j.shape) and o_t.dtype == TORCH[dtype]
    assert np.abs(_np(o_t) - _np(o_j)).max() <= TOL[dtype]


def test_plain_oracle_matches_jax():
    """The port's plain oracle with key mask, head bias and groups."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 2, 24, 16)) for _ in range(3))
    mask = rng.random((2, 24)) > 0.2
    bias = rng.standard_normal((2, 24, 24))
    kw = dict(scale=6.0, groups=4)
    o_j = jax_plain(_j(q), _j(k), _j(v), mask=jnp.asarray(mask),
                    attn_bias=_j(bias), **kw)
    o_t = plain_cosine_sim_attention(_t(q), _t(k), _t(v),
                                     mask=torch.from_numpy(mask),
                                     attn_bias=_t(bias), **kw)
    assert np.abs(_np(o_t) - _np(o_j)).max() <= 1e-5


@pytest.mark.parametrize("case", ["causal-gqa-ragged-tiles",
                                  "key-mask-all-masked-row", "batch-bias"])
def test_streaming_oracle_matches_jax(case):
    """The streaming oracle over key tiles (tile 16 of 40 keys: a ragged
    last tile), with its "- scale" shift and its 1e-12 row-sum clamp."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 24, 16))
    k, v = (rng.standard_normal((2, 2, 40, 16)) for _ in range(2))
    kw = dict(scale=6.0, groups=2, col_tile_size=16)
    jkw, tkw = dict(kw), dict(kw)
    if case == "causal-gqa-ragged-tiles":
        jkw["causal"] = tkw["causal"] = True
    elif case == "key-mask-all-masked-row":
        mask = rng.random((2, 40)) > 0.3
        mask[1] = False
        jkw["mask"], tkw["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    else:
        bias = rng.standard_normal((2, 24, 40))
        jkw["attn_bias"], tkw["attn_bias"] = _j(bias), _t(bias)
        jkw["attn_bias_batch_dim"] = tkw["attn_bias_batch_dim"] = True
    o_j = jax_streaming(_j(q), _j(k), _j(v), **jkw)
    o_t = streaming_cosine_sim_attention(_t(q), _t(k), _t(v), **tkw)
    assert np.abs(_np(o_t) - _np(o_j)).max() <= 1e-5


def test_non_cosine_baseline_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 2, 20, 16)) for _ in range(3))
    o_j = jax_non_cosine(_j(q), _j(k), _j(v))
    o_t = non_cosine_sim_attention(_t(q), _t(k), _t(v))
    assert np.abs(_np(o_t) - _np(o_j)).max() <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2norm_tensors_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 32)) * 10
    x[0, 0] = 0  # the dtype-dependent eps clamp
    got = l2norm_tensors(_t(x, dtype), groups=4)
    want = jax_l2norm_tensors(_j(x, dtype), groups=4)
    assert got.dtype == TORCH[dtype]
    assert np.abs(_np(got) - _np(want)).max() <= (
        1e-6 if dtype == "float32" else 1e-2)


def test_forward_only_and_unported_flags_raise():
    """The op is no longer forward-only: a gradient flows.  The flags that
    are not ported still raise, with or without a gradient."""
    q = torch.randn(1, 1, 8, 16, requires_grad=True)
    (grad,) = torch.autograd.grad(
        flash_cosine_sim_attention(q, q, q).square().sum(), q)
    assert grad.shape == q.shape and torch.isfinite(grad).all()
    for flag in ("qk_int8", "qk_fp8"):
        with pytest.raises(NotImplementedError):
            flash_cosine_sim_attention(q, q, q, **{flag: True})
    with torch.no_grad():
        for flag in ("qk_int8", "qk_fp8"):
            with pytest.raises(NotImplementedError):
                flash_cosine_sim_attention(q, q, q, **{flag: True})
        with pytest.raises(ValueError):
            flash_cosine_sim_attention(q, q, q, block_q=64)
        with pytest.raises(ValueError):
            flash_cosine_sim_attention(q, q, q, causal=True,
                                       mask=torch.ones(1, 8, dtype=bool))
