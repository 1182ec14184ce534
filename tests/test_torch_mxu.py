"""The port's split float32 products (``ops/mxu.py``) on the CPU.

The float32 instances of the forward (K1) and backward (K2, K3a, K3b)
kernels up to d 256, and of K1 and K2 past it (the wide route), form
every product as three TF32 tensor-core products of a hi / lo split
(3xTF32); ``dot_tf32x3`` is their plain version.  These tests hold its
error budget without a card:

- ``dot_f32x3``, JAX's bfloat16 split, against the JAX package's own, at
  1e-6 of the largest value (both sum exact products in float32, in
  another order);
- ``tf32_round`` on hand-picked bit patterns (ties to even and their
  neighbours, a carry into the exponent, ±0, subnormals, 448,
  infinities, NaNs), a
  NaN operand of ``dot_tf32x3`` giving NaN where the exact product does,
  and hi + lo reconstructing x to 2^-21 relative;
- the plain forward and backward with ``mm=dot_tf32x3`` against the same
  plain versions with each product correctly rounded from float64 (the
  exact products), at l2norm groups 1 and 8 and scale 1 and 8, causal and
  key-masked, and the backward (the float32 K2, K3a and K3b's plain
  version) also with an (h, i, j) and a (b, i, j) bias at 8 groups and
  scale 8, dB included (the bias cases also at d 256 and 192; the
  bias-free ones at 8 groups and scale 8 also at d 256 and 512): o and
  the gradients at the float32 bar 1e-4
  (gradients in units of max(1, max|g|), as the card tests hold them),
  inv_l at 1e-5 relative.  At 8 groups and scale 8 a logit reaches 64, and float32's
  own rounding of it moves inv_l by ~1e-5: there inv_l is held to twice
  the exact float32 plain version's own distance from the exact
  products, if that is larger than 1e-5;
- the same forward against the JAX package's float32 forward (its Pallas
  kernel in interpret mode, as the JAX suite runs it on the CPU) at 1e-4,
  and at d 256 and 512 the forward and one-pass backward against JAX's
  float32 forward and one-pass backward (``_fused_bwd_kernel_t``),
  and the backward with a bias against JAX's float32 backward pinned to
  its two-pass kernels (``_dq_kernel_t``, ``_dkdv_kernel_t``), whose
  counterparts K3a and K3b take every float32 backward with a bias, at d
  64 and at d 256;
- at 8 groups and scale 8, ``mm=dot_f32x3`` (the bfloat16 split) missing
  the float32 bars that ``mm=dot_tf32x3`` holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_cosine_sim_attention_tpu.ops.bwd_kernel import (
    flash_attention_backward as jax_backward,
)
from flash_cosine_sim_attention_tpu.ops.fwd_kernel import (
    flash_attention_forward as jax_forward,
)
from flash_cosine_sim_attention_tpu.ops.mxu import dot_f32x3 as jax_dot_f32x3
from flash_cosine_sim_attention_tpu_torch.ops import (
    flash_attention_backward_plain,
    flash_attention_forward_plain,
    l2norm_tensors,
)
from flash_cosine_sim_attention_tpu_torch.ops.mxu import (
    dot_f32x3,
    dot_tf32x3,
    split_tf32,
    tf32_round,
)

F32_BAR = 1e-4
INV_L_BAR = 1e-5


def exact_mm(a, b):
    """a @ b with each entry correctly rounded from float64 to float32."""
    return (a.double() @ b.double()).float()


def _grad_err(x, y):
    return (x - y).abs().max().item() / max(1.0, y.abs().max().item())


def _rel(x, y):
    return ((x - y) / y).abs().max().item()


@pytest.mark.parametrize("a_shape,b_shape", [((5, 64), (64, 7)),
                                             ((2, 3, 33, 16), (2, 3, 16, 40))])
def test_dot_f32x3_matches_jax(a_shape, b_shape):
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(a_shape) * 3).astype(np.float32)
    b = rng.standard_normal(b_shape).astype(np.float32)
    nd = len(a_shape)
    batch = tuple(range(nd - 2))
    want = np.asarray(jax_dot_f32x3(
        jnp.asarray(a), jnp.asarray(b),
        (((nd - 1,), (nd - 2,)), (batch, batch))))
    got = dot_f32x3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _f32(bits: int) -> torch.Tensor:
    return torch.from_numpy(
        np.array([bits], np.uint32).view(np.int32)).view(torch.float32)


# (input bits, TF32 bits: 10 mantissa bits, to nearest, ties to even)
TF32_PATTERNS = {
    "tie": (0x3F801000, 0x3F800000),             # 1 + 2^-11: to even
    "tie-up": (0x3F803000, 0x3F804000),          # 1 + 3 * 2^-11
    "negative-tie": (0xBF801000, 0xBF800000),
    "negative-tie-up": (0xBF803000, 0xBF804000),
    "below-tie": (0x3F800FFF, 0x3F800000),
    "above-tie": (0x3F801001, 0x3F802000),
    "exact": (0x3F802000, 0x3F802000),
    "carry-into-exponent": (0x3FFFFFFF, 0x40000000),
    "plus-zero": (0x00000000, 0x00000000),
    "minus-zero": (0x80000000, 0x80000000),
    "subnormal-tie": (0x00001000, 0x00000000),
    "subnormal-tie-up": (0x00003000, 0x00004000),
    "subnormal-below-tie": (0x00000FFF, 0x00000000),
    "448": (0x43E00000, 0x43E00000),
    "infinity": (0x7F800000, 0x7F800000),
    "minus-infinity": (0xFF800000, 0xFF800000),
    "largest-finite": (0x7F7FFFFF, 0x7F800000),
    # NaNs skip the add, which would carry out of the exponent (the card's
    # NaN 0x7FFFFFFF into -0): the sign stays, the quiet bit is set
    "nan-card": (0x7FFFFFFF, 0x7FFFE000),
    "negative-nan": (0xFFFFFFFF, 0xFFFFE000),
    "nan-low-payload": (0x7F800001, 0x7FC00000),
    "nan-quiet": (0x7FC00000, 0x7FC00000),
}


@pytest.mark.parametrize("case", sorted(TF32_PATTERNS))
def test_tf32_round_bit_patterns(case):
    x_bits, want_bits = TF32_PATTERNS[case]
    got = tf32_round(_f32(x_bits))
    assert got.view(torch.int32).item() == _f32(want_bits).view(
        torch.int32).item()


def test_tf32_split_keeps_nans():
    """A NaN operand (the card's 0x7FFFFFFF among them) leaves dot_tf32x3
    NaN wherever the exact product is, and nowhere else."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 16)).astype(np.float32)
    b = rng.standard_normal((16, 5)).astype(np.float32)
    a.view(np.uint32)[1, 3] = 0x7FFFFFFF
    a.view(np.uint32)[4, 0] = 0xFFFFFFFF
    b.view(np.uint32)[7, 2] = 0x7F800001
    a_t, b_t = torch.from_numpy(a), torch.from_numpy(b)
    want = (a_t @ b_t).isnan()
    assert want.any() and not want.all()
    assert torch.equal(dot_tf32x3(a_t, b_t).isnan(), want)
    hi, lo = split_tf32(a_t)
    assert torch.equal(hi.isnan(), a_t.isnan())


def test_split_tf32_reconstructs_x():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(4096)
         * 2.0 ** rng.integers(-40, 40, 4096)).astype(np.float32)
    hi, lo = split_tf32(torch.from_numpy(x))
    for part in (hi, lo):  # TF32 words: the low 13 bits are clear
        assert (part.view(torch.int32) & 0x1FFF).abs().max().item() == 0
    recon = hi.double() + lo.double()
    xd = torch.from_numpy(x).double()
    assert ((recon - xd).abs() <= 2.0 ** -21 * xd.abs()).all()
    assert ((hi.double() - xd).abs() <= 2.0 ** -11 * xd.abs()).all()


def _inputs(groups, kind, seed=3, d=64):
    """b1 h2 at head dim ``d``: causal at s 256, or 96 queries x 200 keys
    with a key mask; q, k l2-normalized in ``groups`` groups.  A ``kind``
    ending in "-bias-heads" or "-bias-batch" adds an (h, i, j) or (b, i, j)
    bias of 0.5 x a standard normal (the sixth value; None otherwise)."""
    rng = np.random.default_rng(seed)
    causal = kind.startswith("causal")
    sq, sk = (256, 256) if causal else (96, 200)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k = l2norm_tensors(randn(1, 2, sq, d), randn(1, 2, sk, d),
                          groups=groups)
    mask = None
    if not causal:
        mask = torch.from_numpy(rng.random((1, sk)) > 0.3)
    v, do = randn(1, 2, sk, d), randn(1, 2, sq, d)
    bias = None
    if kind.endswith("-bias-heads"):
        bias = 0.5 * randn(2, sq, sk)
    elif kind.endswith("-bias-batch"):
        bias = 0.5 * randn(1, sq, sk)
    return q, k, v, mask, do, bias


def _case(groups, scale, kind, d=64):
    return pytest.param(groups, scale, kind, d,
                        id=f"{groups}-{scale}-{kind}"
                        + ("" if d == 64 else f"-d{d}"))


SPLIT_CASES = [(groups, scale, kind) for groups in (1, 8) for scale in (1, 8)
               for kind in ("causal", "key-mask")]
# d 256, the widest kernel width, whose float32 K1 and K2 run 3xTF32 too:
# sums over 4 times as many lanes
D256_CASES = [(1, 1, "causal", 256), (8, 8, "causal", 256),
              (8, 8, "key-mask", 256)]
# d 512, the heads-512 model's width, whose float32 K1 and K2 run 3xTF32
# on the wide route: sums over twice d 256's lanes
D512_CASES = [(8, 8, "causal", 512), (8, 8, "key-mask", 512)]
# the backward also with a bias (the two-pass kernels K3a and K3b), at 8
# groups and scale 8, where logits reach 64
BIAS_CASES = [(8, 8, "causal-bias-heads"), (8, 8, "key-mask-bias-batch")]
BWD_SPLIT_CASES = SPLIT_CASES + BIAS_CASES
# ... and at d 256 and 192, whose float32 K3a and K3b run 3xTF32 too, and
# at d 512, where they run 3xTF32 on the wide route
WIDE_BIAS_CASES = [c + (d,) for d in (256, 192, 512) for c in BIAS_CASES]


@pytest.mark.parametrize("groups,scale,kind,d",
                         [_case(*c) for c in SPLIT_CASES + D256_CASES
                          + D512_CASES])
def test_forward_with_tf32_split_matches_exact_products(groups, scale, kind,
                                                        d):
    q, k, v, mask, _, _ = _inputs(groups, kind, d=d)
    kw = dict(bias_batch_dim=False, scale=float(scale),
              causal=kind == "causal")
    o_x, l_x = flash_attention_forward_plain(q, k, v, mask, None,
                                             mm=exact_mm, **kw)
    o_s, l_s = flash_attention_forward_plain(q, k, v, mask, None,
                                             mm=dot_tf32x3, **kw)
    _, l_f = flash_attention_forward_plain(q, k, v, mask, None, **kw)
    inv_l_bar = max(INV_L_BAR, 2 * _rel(l_f, l_x))
    assert (o_s - o_x).abs().max().item() <= F32_BAR
    assert _rel(l_s, l_x) <= inv_l_bar, (_rel(l_s, l_x), inv_l_bar)
    if groups == 1 or scale == 1:  # float32's own floor is far below
        assert inv_l_bar == INV_L_BAR


@pytest.mark.parametrize("groups,scale,kind,d",
                         [_case(*c) for c in BWD_SPLIT_CASES + D256_CASES
                          + WIDE_BIAS_CASES + D512_CASES])
def test_backward_with_tf32_split_matches_exact_products(groups, scale,
                                                         kind, d):
    q, k, v, mask, do, bias = _inputs(groups, kind, d=d)
    kw = dict(bias_batch_dim=kind.endswith("-bias-batch"),
              scale=float(scale), causal=kind.startswith("causal"))
    o, inv_l = flash_attention_forward_plain(q, k, v, mask, bias,
                                             mm=exact_mm, **kw)
    args = (do, o, inv_l, q, k, v, mask, bias)
    want = flash_attention_backward_plain(*args, mm=exact_mm, **kw)
    got = flash_attention_backward_plain(*args, mm=dot_tf32x3, **kw)
    assert (got[3] is None) == (bias is None)
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        if y is not None:
            assert _grad_err(x, y) <= F32_BAR, (name, _grad_err(x, y))


def test_forward_with_tf32_split_matches_jax_f32_forward():
    q, k, v, mask, _, _ = _inputs(1, "key-mask")
    rng = np.random.default_rng(4)
    bias = rng.standard_normal((2, 96, 200)).astype(np.float32)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o_j, l_j = jax_forward(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, mask)),
        jnp.asarray(bias), interpret=True, **kw)
    o_s, l_s = flash_attention_forward_plain(
        q, k, v, mask, torch.from_numpy(bias), mm=dot_tf32x3, **kw)
    assert np.abs(o_s.numpy() - np.asarray(o_j)).max() <= F32_BAR
    assert np.abs(l_s.numpy() / np.asarray(l_j) - 1).max() <= F32_BAR


@pytest.mark.parametrize("d", [256, 512])
def test_tf32_split_at_d256_matches_jax_f32_forward_and_one_pass(d):
    """The plain forward and backward with ``mm=dot_tf32x3`` at d 256 and
    512, the plain versions of the float32 K1 and one-pass K2 at those
    widths (the d 256 instances and the wide route's; b1 h1 s128 causal, 8
    l2norm groups, scale 8), against the JAX package's float32 forward and
    its one-pass backward (``_fused_bwd_kernel_t``, interpret mode): o,
    dq, dk and dv at 1e-4 of max(1, max|g|), inv_l at 1e-4 relative, from
    JAX's own forward."""
    rng = np.random.default_rng(6)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k = l2norm_tensors(randn(1, 1, 128, d), randn(1, 1, 128, d),
                          groups=8)
    v, do = randn(1, 1, 128, d), randn(1, 1, 128, d)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    o_j, l_j = jax_forward(jq, jk, jv, None, None, interpret=True, **kw)
    o_s, l_s = flash_attention_forward_plain(q, k, v, None, None,
                                             mm=dot_tf32x3, **kw)
    assert _grad_err(o_s, torch.from_numpy(np.array(o_j))) <= F32_BAR
    assert np.abs(l_s.numpy() / np.asarray(l_j) - 1).max() <= F32_BAR
    want = jax_backward(jnp.asarray(do.numpy()), o_j, l_j, jq, jk, jv, None,
                        None, interpret=True, **kw)
    assert want[3] is None
    got = flash_attention_backward_plain(
        do, torch.from_numpy(np.array(o_j)), torch.from_numpy(np.array(l_j)),
        q, k, v, None, None, mm=dot_tf32x3, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        y = torch.from_numpy(np.array(y))
        assert x.shape == y.shape, name
        assert _grad_err(x, y) <= F32_BAR, (name, _grad_err(x, y))


def test_backward_with_tf32_split_matches_jax_f32_two_pass():
    """The plain backward with ``mm=dot_tf32x3`` and an (h, i, j) bias, the
    plain version of the float32 K3a and K3b, against the JAX package's
    float32 backward pinned to its two-pass kernels (interpret mode), dq,
    dk, dv and db at 1e-4 of max(1, max|g|), from JAX's own forward."""
    q, k, v, mask, do, _ = _inputs(1, "key-mask")
    rng = np.random.default_rng(4)
    bias = rng.standard_normal((2, 96, 200)).astype(np.float32)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    jq, jk, jv, jmask = (jnp.asarray(t.numpy()) for t in (q, k, v, mask))
    o_j, l_j = jax_forward(jq, jk, jv, jmask, jnp.asarray(bias),
                           interpret=True, **kw)
    want = jax_backward(jnp.asarray(do.numpy()), o_j, l_j, jq, jk, jv, jmask,
                        jnp.asarray(bias), interpret=True,
                        blocks_t=(128, 128, 128),
                        blocks_t_kv=(128, 128, 128), **kw)
    got = flash_attention_backward_plain(
        do, torch.from_numpy(np.array(o_j)),
        torch.from_numpy(np.array(l_j)), q, k, v, mask,
        torch.from_numpy(bias), mm=dot_tf32x3, **kw)
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        y = torch.from_numpy(np.array(y))
        assert x.shape == y.shape, name
        assert _grad_err(x, y) <= F32_BAR, (name, _grad_err(x, y))


@pytest.mark.parametrize("d", [256, 512])
def test_tf32_split_at_d256_matches_jax_f32_two_pass(d):
    """The plain backward with ``mm=dot_tf32x3`` and an (h, i, j) bias at d
    256 and 512, the plain version of the float32 K3a and K3b at those
    widths (the d 256 instances and the wide route's; b1 h2 s128 causal, 8
    l2norm groups, scale 8), against the JAX package's float32 backward
    pinned to its two-pass kernels (``_dq_kernel_t``, ``_dkdv_kernel_t``,
    interpret mode): dq, dk, dv and db at 1e-4 of max(1, max|g|), from
    JAX's own forward."""
    rng = np.random.default_rng(7)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k = l2norm_tensors(torch.from_numpy(randn(1, 2, 128, d)),
                          torch.from_numpy(randn(1, 2, 128, d)), groups=8)
    v, do = randn(1, 2, 128, d), randn(1, 2, 128, d)
    bias = 0.5 * randn(2, 128, 128)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    jq, jk = jnp.asarray(q.numpy()), jnp.asarray(k.numpy())
    jv, jbias = jnp.asarray(v), jnp.asarray(bias)
    o_j, l_j = jax_forward(jq, jk, jv, None, jbias, interpret=True, **kw)
    want = jax_backward(jnp.asarray(do), o_j, l_j, jq, jk, jv, None, jbias,
                        interpret=True, blocks_t=(128, 128, 128),
                        blocks_t_kv=(128, 128, 128), **kw)
    got = flash_attention_backward_plain(
        torch.from_numpy(do), torch.from_numpy(np.array(o_j)),
        torch.from_numpy(np.array(l_j)), q, k, torch.from_numpy(v), None,
        torch.from_numpy(bias), mm=dot_tf32x3, **kw)
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        y = torch.from_numpy(np.array(y))
        assert x.shape == y.shape, name
        assert _grad_err(x, y) <= F32_BAR, (name, _grad_err(x, y))


def test_bf16_split_misses_the_f32_bar_where_tf32_holds():
    """Why the kernels split into TF32 and not into JAX's bfloat16: at 8
    l2norm groups and scale 8 (b1 h8 s1024 d64 causal, logits to 64) the
    plain forward with ``mm=dot_f32x3`` misses the float32 bar on o and the
    inv_l bar, while ``mm=dot_tf32x3`` holds both, against exact
    products."""
    rng = np.random.default_rng(3)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k = l2norm_tensors(randn(1, 8, 1024, 64), randn(1, 8, 1024, 64),
                          groups=8)
    v = randn(1, 8, 1024, 64)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o_x, l_x = flash_attention_forward_plain(q, k, v, None, None,
                                             mm=exact_mm, **kw)
    _, l_f = flash_attention_forward_plain(q, k, v, None, None, **kw)
    inv_l_bar = max(INV_L_BAR, 2 * _rel(l_f, l_x))
    o_b, l_b = flash_attention_forward_plain(q, k, v, None, None,
                                             mm=dot_f32x3, **kw)
    o_t, l_t = flash_attention_forward_plain(q, k, v, None, None,
                                             mm=dot_tf32x3, **kw)
    assert (o_b - o_x).abs().max().item() > F32_BAR
    assert _rel(l_b, l_x) > inv_l_bar
    assert (o_t - o_x).abs().max().item() <= F32_BAR
    assert _rel(l_t, l_x) <= inv_l_bar
