"""The port's backward against the JAX package's, on the CPU.

Inputs are made with numpy from a seed.  The JAX forward (its Pallas
kernel in interpret mode) gives (o, inv_l); the same (dO, o, inv_l, q, k,
v, mask, bias) then go through JAX's ``flash_attention_backward`` in
interpret mode, pinned to one of its two routes (the one-pass kernel with
``blocks_f``, the two-pass kernels with ``blocks_t`` / ``blocks_t_kv``),
and through the port's, whose CPU path is the plain version of the Hopper
kernels.  The autograd op is held against ``jax.vjp`` of the JAX op.

Tolerances on dq, dk, dv, db: float32 1e-4 (the JAX suite's bar) on
max |difference| / max(1, max |g|): at scale 8 the gradients reach
|g| ~ 30, and the JAX kernels' f32 products are three bf16 passes
(``ops/mxu.py``) good to ~2e-5 of the value, so an absolute 1e-4 would
measure JAX's rounding, not the port's; the port sums in exact f32.
bfloat16 0.15 and float16 0.1, absolute (the JAX suite's and upstream's
bars: the JAX kernels round the scaled q tile, e and dS to bf16 before
their products, the port keeps them in f32; f16 computes through bf16 on
both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_cosine_sim_attention_tpu.ops import (
    flash_cosine_sim_attention as jax_flash,
)
from flash_cosine_sim_attention_tpu.ops.bwd_kernel import (
    flash_attention_backward as jax_backward,
)
from flash_cosine_sim_attention_tpu.ops.fwd_kernel import (
    flash_attention_forward as jax_forward,
)
from flash_cosine_sim_attention_tpu.ops.reference import (
    l2norm_tensors as jax_l2norm_tensors,
)
from flash_cosine_sim_attention_tpu_torch.ops import (
    flash_attention_backward,
    flash_cosine_sim_attention,
)
from flash_cosine_sim_attention_tpu_torch.ops.blocks import onepass_backward
from flash_cosine_sim_attention_tpu_torch.ops.bwd_kernel import backward_route

TOL = {"float32": 1e-4, "bfloat16": 0.15, "float16": 0.1}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
ROUTES = {"onepass": dict(blocks_f=(128, 128)),
          "twopass": dict(blocks_t=(128, 128, 128),
                          blocks_t_kv=(128, 128, 128))}


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(TORCH[dtype])


def _j(x, dtype="float32"):
    return jnp.asarray(np.asarray(x, np.float32), JNP[dtype])


def _err(x, y, dtype):
    """max |x - y|, relative to max(1, max |y|) in float32."""
    err = np.abs(_np(x) - _np(y)).max()
    return err / max(1.0, np.abs(_np(y)).max()) if dtype == "float32" else err


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# b, h, kvh, seq_q, seq_k, d, causal, key mask, bias leading dim
CASES = {
    "causal": (1, 2, 2, 128, 128, 16, True, False, None),
    "cross-causal": (1, 2, 2, 70, 130, 16, True, False, None),
    "ragged-key-mask-all-masked-row": (2, 2, 2, 130, 257, 16, False, True,
                                       None),
    "gqa-causal": (1, 4, 2, 128, 128, 16, True, False, None),
    "mqa": (2, 4, 1, 96, 96, 32, False, False, None),
    "bias-heads": (2, 4, 2, 100, 100, 16, True, False, "h"),
    "bias-batch-key-mask": (2, 4, 4, 63, 63, 16, False, True, "b"),
}
# (case, dtype, JAX route): both routes on two cases, one route on the
# rest (the two JAX routes agree to rounding); a bias takes the two-pass
# route only
GRID = [
    ("causal", "float32", "onepass"), ("causal", "float32", "twopass"),
    ("gqa-causal", "float32", "onepass"), ("gqa-causal", "float32", "twopass"),
    ("cross-causal", "float32", "onepass"),
    ("ragged-key-mask-all-masked-row", "float32", "twopass"),
    ("mqa", "float32", "onepass"),
    ("bias-heads", "float32", "twopass"),
    ("bias-batch-key-mask", "float32", "twopass"),
    ("causal", "bfloat16", "onepass"), ("bias-heads", "bfloat16", "twopass"),
]


@pytest.mark.parametrize("case,dtype,route", GRID)
def test_backward_matches_jax(case, dtype, route):
    b, h, kvh, sq, sk, d, causal, has_mask, bias_kind = CASES[case]
    rng = np.random.default_rng(10)
    q, k = (np.array(jax_l2norm_tensors(jnp.asarray(
        rng.standard_normal(s), jnp.float32)))
        for s in ((b, h, sq, d), (b, kvh, sk, d)))
    v = rng.standard_normal((b, kvh, sk, d))
    do = rng.standard_normal((b, h, sq, d))
    mask = bias = None
    if has_mask:
        mask = rng.random((b, sk)) > 0.3
        mask[-1] = False              # the last batch: every row sees nothing
    if bias_kind is not None:
        bias = 0.5 * rng.standard_normal((b if bias_kind == "b" else h, sq, sk))
    kw = dict(bias_batch_dim=bias_kind == "b", scale=8.0, causal=causal)

    jq, jk, jv, jdo = (_j(x, dtype) for x in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    jbias = None if bias is None else _j(bias)
    o, inv_l = jax_forward(jq, jk, jv, jmask, jbias, interpret=True, **kw)
    want = jax_backward(jdo, o, inv_l, jq, jk, jv, jmask, jbias,
                        interpret=True, **ROUTES[route], **kw)
    got = flash_attention_backward(
        _t(do, dtype), _t(_np(o), dtype), _t(_np(inv_l)),
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        None if mask is None else torch.from_numpy(mask),
        None if bias is None else _t(bias), **kw)

    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        if y is None:
            assert x is None, name
            continue
        assert tuple(x.shape) == tuple(y.shape), name
        err = _err(x, y, dtype)
        assert err <= TOL[dtype], (name, err)
    if has_mask:                      # rows that see no key get no gradient
        assert np.all(_np(got[0])[-1] == 0)


@pytest.mark.parametrize("layout", ["groups-gqa-causal", "merged-batch-heads",
                                    "single-head-kv", "bias-grad", "float16"])
def test_autograd_matches_jax_vjp(layout):
    rng = np.random.default_rng(11)
    dtype, bias, kw = "float32", None, dict(causal=True)
    if layout == "groups-gqa-causal":
        q = rng.standard_normal((1, 4, 64, 32))
        k, v = (rng.standard_normal((1, 2, 64, 32)) for _ in range(2))
        kw["groups"] = 2
    elif layout == "merged-batch-heads":
        q, k, v = (rng.standard_normal((4, 40, 16)) for _ in range(3))
    elif layout == "single-head-kv":
        q = rng.standard_normal((2, 3, 40, 16))
        k, v = (rng.standard_normal((2, 40, 16)) for _ in range(2))
    elif layout == "bias-grad":
        q, k, v = (rng.standard_normal((2, 2, 48, 16)) for _ in range(3))
        bias = 0.5 * rng.standard_normal((2, 48, 48))
        kw = dict(mask=rng.random((2, 48)) > 0.2)
    else:
        dtype = "float16"
        q, k, v = (rng.standard_normal((1, 2, 40, 32)) for _ in range(3))
        kw = dict(causal=False, scale=4.0)
    do = rng.standard_normal(q.shape)

    jkw = dict(kw, mask=None if "mask" not in kw else jnp.asarray(kw["mask"]))
    tkw = dict(kw, mask=None if "mask" not in kw else torch.from_numpy(
        kw["mask"]))
    inputs = [q, k, v] + ([bias] if bias is not None else [])

    def jax_fn(*args):
        return jax_flash(*args[:3], attn_bias=args[3] if bias is not None
                         else None, **jkw)

    o_j, vjp = jax.vjp(jax_fn, *(_j(x, dtype) for x in inputs))
    want = vjp(_j(do, dtype))
    tin = [_t(x, dtype).requires_grad_() for x in inputs]
    o_t = flash_cosine_sim_attention(
        *tin[:3], attn_bias=tin[3] if bias is not None else None, **tkw)
    got = torch.autograd.grad(o_t, tin, _t(do, dtype))

    assert _err(o_t, o_j, dtype) <= TOL[dtype]
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        assert x.dtype == TORCH[dtype] and tuple(x.shape) == tuple(y.shape)
        err = _err(x, y, dtype)
        assert err <= TOL[dtype], (name, err)


@pytest.mark.parametrize("seq_q", [8192, 8193, 16384])
@pytest.mark.parametrize("d", [64, 256, 512])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
def test_onepass_backward_rule(bias, dtype, d, seq_q):
    """The card's backward route: a bias always takes K3a then K3b (only
    K3a forms dB); without one, bfloat16 up to d 256 takes the one-pass
    K2 at any length, and float32 and the wide route past d 256 keep the
    two passes past 8192 query rows."""
    want = not bias and (seq_q <= 8192
                         or (dtype == "bfloat16" and d <= 256))
    assert onepass_backward(bias, TORCH[dtype], d, seq_q) is want


def test_cpu_backward_route_is_plain():
    """CPU tensors take the plain version on either route's inputs."""
    q = torch.zeros(1, 1, 8193, 8, dtype=torch.bfloat16)
    assert backward_route(q, None) == "plain"
    assert backward_route(q, torch.zeros(1, 8193, 16)) == "plain"
