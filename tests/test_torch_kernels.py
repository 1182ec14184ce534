"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests carry the ``cuda`` marker and skip where no card is
present: a CUDA kernel has no CPU mode.  The file imports nothing of the
JAX package, so it also runs where flax is not installed:

    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerances: float32 1e-4 (same maths, other sum order; K1, K2, K3a and
K3b in float32 at every width, K1 also on int8 codes with float32 v,
form each float product as three TF32 products of a hi / lo split of
its operands, 3xTF32, good to ~2^-21 of each; K7 on float32 x takes
x's hi and lo times the codes, exact in TF32, 2xTF32, and is also held
at 1e-5 to that split's plain version); bf16
outputs 2e-2 (a few bf16 ulps at |o| <= 2); inv_l 1e-5 relative; the
contiguous decode kernel 2e-3 on f32 output; the int8-weight matmul
1e-4 (f32) and 2e-2 (bf16) of max(1, max|y|).  The
backward's gradients reach |g| ~ 30 at scale 8: float32 errors are taken
relative to max(1, max|g|), bar 1e-4 (K2 adds dQ with atomics whose order
varies from run to run); bf16 errors per entry, relative to |g| + rms(g),
bar 2^-7 (kernel and plain version round the same f32 sums, added in
another order, to bf16: one bf16 ulp is at most 2^-7 of the value; the
tensor-core dK/dV kernel feeds e and dS to its products as bf16 hi + lo
pairs, so its sums stay those of f32 operands to ~16 bits; so does the
tensor-core dQ kernel with dS).  Head dims between the kernel widths (8,
48, 80, 136, 200) run zero-padded to the next one; past 256 (264, 384,
512, 1032) the wide route runs zero-padded to the next multiple of 128
(bf16, and f32 K1 and K2, on the tensor cores, in column blocks of 256
with a 128-column remainder at 384 and 1152); d that is not a multiple
of 8 is refused.
The decode kernels take any multiple of 8 (past 1024, as at 1032, 2048
and 4096, their output columns are split over column blocks); they split
each slot's tokens over several blocks and merge their partial sums in
the same launch: the split edges (lengths 0, 1, 127, 128, 129, a split's end and
the capacity) and a finished paged slot are held against plain, and two
calls in a row must agree bit for bit (the merge's ticket counters are
left at zero); splits of several tiles run at the 0.81B decode step's
shape, and calls on two streams at once each keep their own counters.
"""

import pytest
import torch

from flash_cosine_sim_attention_tpu_torch.ops import (
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_forward_plain,
    l2norm_tensors,
)
from flash_cosine_sim_attention_tpu_torch.ops import bwd_kernel
from flash_cosine_sim_attention_tpu_torch.quant import (
    append,
    append_paged,
    decode_attention_plain,
    init_cache,
    init_paged_cache,
    paged_decode_attention,
    paged_decode_plain,
    quantized_decode_attention,
    quantize_dense_kernel,
    quantized_matmul,
    quantized_matmul_plain,
)
from flash_cosine_sim_attention_tpu_torch.quant.weights import qmm_plan

BARS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GRAD_BARS = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}


def _grad_err(x, y, dtype):
    x, y = x.float(), y.float()
    if dtype == torch.float32:
        return (x - y).abs().max().item() / max(1.0, y.abs().max().item())
    floor = y.square().mean().sqrt()
    return ((x - y).abs() / (y.abs() + floor).clamp_min(1e-30)).max().item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no plain fallback)")
    return torch.device("cuda")


# b, h, kvh, seq_q, seq_k, d, causal, key mask ("some" / "none" / "all"),
# bias leading dim ("h" / "b" / None)
FWD_CASES = {
    "causal-ragged-gqa": (2, 4, 2, 200, 200, 64, True, None, None),
    "cross-causal-d32": (1, 2, 2, 70, 130, 32, True, None, None),
    "key-mask": (2, 2, 2, 96, 300, 128, False, "some", None),
    "all-keys-masked": (1, 2, 2, 64, 128, 64, False, "all", None),
    "bias-heads-d16": (1, 4, 4, 100, 100, 16, True, None, "h"),
    "bias-batch-d96": (2, 2, 1, 65, 65, 96, False, None, "b"),
    "one-query-row-d128": (2, 4, 4, 1, 300, 128, True, None, None),
    "gqa-16-2-d64": (1, 16, 2, 130, 130, 64, True, None, None),
    "prefill-h16-s1024-d128": (1, 16, 16, 1024, 1024, 128, True, None, None),
    # head dims between the kernel widths: zero-padded to 16, 64 and 96
    "causal-d8": (1, 2, 2, 100, 100, 8, True, None, None),
    "key-mask-gqa-d48": (2, 4, 1, 70, 150, 48, False, "some", None),
    "causal-bias-d80": (1, 4, 2, 130, 130, 80, True, None, "h"),
    # the widest instances (192, 256) and widths padded to them
    "causal-gqa-d136": (1, 4, 2, 150, 150, 136, True, None, None),
    "key-mask-bias-d192": (2, 2, 2, 100, 170, 192, False, "some", "h"),
    "causal-bias-batch-d200": (2, 4, 2, 130, 130, 200, True, None, "b"),
    "causal-ragged-mqa-d256": (2, 2, 1, 200, 200, 256, True, None, None),
    # past 256: the wide route (zero-padded to 384, 384 and 512)
    "causal-gqa-d264": (1, 4, 2, 130, 130, 264, True, None, None),
    "key-mask-bias-d384": (2, 2, 2, 70, 150, 384, False, "some", "h"),
    "causal-bias-batch-d512": (2, 2, 1, 100, 100, 512, True, None, "b"),
    "all-keys-masked-d512": (1, 2, 2, 64, 100, 512, False, "all", None),
    # the wide route's edges on the tensor cores: a 128-column remainder
    # block (384, 1152), GQA with a key mask, and d 1032 (padded to 1152)
    "causal-key-mask-gqa-d384": (1, 4, 2, 130, 130, 384, True, "some", None),
    "causal-key-mask-gqa-d512": (2, 4, 2, 150, 150, 512, True, "some", None),
    "causal-key-mask-bias-gqa-d1032": (1, 4, 2, 100, 130, 1032, True, "some",
                                       "h"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_kernel_matches_plain(cuda_device, case, dtype):
    b, h, kvh, sq, sk, d, causal, mask_kind, bias_kind = FWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    q, k = l2norm_tensors(randn(b, h, sq, d), randn(b, kvh, sk, d))
    q, k, v = q.to(dtype), k.to(dtype), randn(b, kvh, sk, d).to(dtype)
    mask = None
    if mask_kind == "some":
        mask = torch.rand(b, sk, device=cuda_device, generator=g) > 0.4
    elif mask_kind == "all":
        mask = torch.zeros(b, sk, dtype=torch.bool, device=cuda_device)
    bias = None if bias_kind is None else randn(
        b if bias_kind == "b" else h, sq, sk)
    kw = dict(bias_batch_dim=bias_kind == "b", scale=8.0, causal=causal)

    before = flash_attention_forward.launches
    o, inv_l = flash_attention_forward(q, k, v, mask, bias, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, mask, bias, **kw)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == before + 1
    assert o.dtype == dtype and torch.isfinite(o.float()).all()
    assert (o.float() - o_p.float()).abs().max().item() <= BARS[dtype]
    assert ((inv_l - inv_p) / inv_p).abs().max().item() <= 1e-5
    if mask_kind == "all":
        assert o.abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_kernel_int8_arm_matches_plain(cuda_device, case, v_dtype):
    """int8 q/k codes at the fixed scale 127 (the op's qk_int8), v and o in
    v_dtype: masks, bias and GQA as in the float arms, at every width; on
    the tensor-core instances by profiler name (float32 v: the 3xTF32
    kernels' int8 instances, fwd_tf32_kernel<D, signed char> and past 256
    fwd_wide_tf32_kernel<signed char>; bfloat16 v: fwd_mma_kernel<signed
    char, D> and fwd_wide_mma_kernel<signed char>), no FMA instance."""
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import (
        kernel_head_dim)
    from flash_cosine_sim_attention_tpu_torch.ops.flash_attention import (
        quantize_qk)

    b, h, kvh, sq, sk, d, causal, mask_kind, bias_kind = FWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    q, k = l2norm_tensors(randn(b, h, sq, d), randn(b, kvh, sk, d))
    q8, k8, s_dequant = quantize_qk(q, k, "int8")
    v = randn(b, kvh, sk, d).to(v_dtype)
    mask = None
    if mask_kind == "some":
        mask = torch.rand(b, sk, device=cuda_device, generator=g) > 0.4
    elif mask_kind == "all":
        mask = torch.zeros(b, sk, dtype=torch.bool, device=cuda_device)
    bias = None if bias_kind is None else randn(
        b if bias_kind == "b" else h, sq, sk)
    kw = dict(bias_batch_dim=bias_kind == "b", scale=8.0, causal=causal,
              s_dequant=s_dequant)

    before = flash_attention_forward.launches
    o, inv_l = flash_attention_forward(q8, k8, v, mask, bias, **kw)
    o_p, inv_p = flash_attention_forward_plain(q8, k8, v, mask, bias, **kw)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == before + 1
    assert o.dtype == v_dtype and torch.isfinite(o.float()).all()
    assert (o.float() - o_p.float()).abs().max().item() <= BARS[v_dtype]
    assert ((inv_l - inv_p) / inv_p).abs().max().item() <= 1e-5
    if mask_kind == "all":
        assert o.abs().max().item() == 0
    width = kernel_head_dim(d, "forward")
    if v_dtype == torch.float32:
        want = (f"fwd_tf32_kernel<{width}, signed char>" if width <= 256
                else "fwd_wide_tf32_kernel<signed char>")
    else:
        want = (f"fwd_mma_kernel<signed char, {width}>" if width <= 256
                else "fwd_wide_mma_kernel<signed char>")
    keys = _kernel_names(
        lambda: flash_attention_forward(q8, k8, v, mask, bias, **kw))
    assert any(want in key for key in keys), (want, keys)
    assert not any("fwd_kernel<" in key or "fwd_wide_kernel" in key
                   for key in keys), keys


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["bf16", "int8"])
@pytest.mark.parametrize("d", [16, 128, 256])
def test_forward_kernel_large_logits(cuda_device, arm, d):
    """Scale 10 and a bias up to 4: e reaches e^14, past the f16 limit,
    which K1's bf16 P fragments hold; l sums the unrounded e."""
    from flash_cosine_sim_attention_tpu_torch.ops.flash_attention import (
        quantize_qk)

    g = torch.Generator(device=cuda_device).manual_seed(10)
    b, h, s = 2, 4, 200
    q, k = l2norm_tensors(
        *(torch.randn(b, h, s, d, device=cuda_device, generator=g)
          for _ in range(2)))
    k[:, :, :s // 2] = q[:, :, :s // 2]      # logits at the full scale
    # |o| <= 2, where the bar is a few bf16 ulps: one key can carry a row
    v = (0.4 * torch.randn(b, h, s, d, device=cuda_device,
                           generator=g)).to(torch.bfloat16)
    bias = 4 * torch.rand(h, s, s, device=cuda_device, generator=g)
    kw = dict(bias_batch_dim=False, scale=10.0, causal=True)
    if arm == "int8":
        q, k, kw["s_dequant"] = quantize_qk(q, k, "int8")
    else:
        q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    o, inv_l = flash_attention_forward(q, k, v, None, bias, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, None, bias, **kw)
    torch.cuda.synchronize()
    assert inv_p.min().item() < 1 / 65504     # past the f16 limit
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_p.float()).abs().max().item() <= BARS[torch.bfloat16]
    assert ((inv_l - inv_p) / inv_p).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["qk_int8", "qk_fp8"])
def test_quantized_qk_op_matches_plain(cuda_device, flag):
    """The public op's quantized-QK arms on the card (K1's int8 arm, or its
    float arm on e4m3-rounded q/k; then the straight-through backward)
    against the plain forward on the quantized q/k and the plain backward
    on the unquantized ones."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)
    from flash_cosine_sim_attention_tpu_torch.ops.flash_attention import (
        quantize_qk)

    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k = l2norm_tensors(
        *(torch.randn(2, 4, 192, 64, device=cuda_device, generator=g)
          for _ in range(2)))
    v, do = (torch.randn(2, 4, 192, 64, device=cuda_device, generator=g)
             for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention_forward.launches
    o = flash_cosine_sim_attention(*leaves, causal=True, l2norm_qk=False,
                                   **{flag: True})
    got = (o, *torch.autograd.grad(o, leaves, do))
    assert flash_attention_forward.launches == before + 1

    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    qq, kq, s_dequant = quantize_qk(q, k, flag[3:])
    o_p, inv_p = flash_attention_forward_plain(qq, kq, v, None, None,
                                               s_dequant=s_dequant, **kw)
    want = (o_p, *flash_attention_backward_plain(
        do, o_p, inv_p, q, k, v, None, None, **kw)[:3])
    for name, x, y in zip(("o", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(x).all(), name
        assert _grad_err(x, y, torch.float32) <= GRAD_BARS[torch.float32], name


# (in, out) of every dense layer of the 0.81B serving model, one shape
# ragged for K7's tiles (in not a multiple of 64, out not of 128), and two
# whose bf16 x rows are not 16-byte multiples (element loads of x)
QMM_SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),
              (2048, 256), (200, 272), (36, 144), (1001, 272)]


@pytest.mark.cuda
@pytest.mark.parametrize("d_in,d_out", QMM_SHAPES)
@pytest.mark.parametrize("rows", [1, 8, 15, 16, 17, 33, 129, 1024])
def test_quant_matmul_kernel_matches_plain(cuda_device, rows, d_in, d_out):
    """float32 and bfloat16 x at both of K7's regimes (up to 16 rows the
    decode tiles, above the prefill tiles), on its tensor-core instances
    by profiler name (qmm_mma_kernel<16, 1, 8, 4, T> or <128, 4, 2, 3,
    T>), no FMA one; float32 x also with x and the weights offset from
    zero (long chains of same-signed sums, which the tensor cores round
    toward zero) and against the plain version with the kernel's split
    (dot_tf32x3 of x and the codes: 1e-5 of max(1, max|y|))."""
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3

    g = torch.Generator(device=cuda_device).manual_seed(8)
    tiles = "16, 1, 8, 4" if rows <= 16 else "128, 4, 2, 3"
    for offset in (0.0, 1.0):
        w8, scale = quantize_dense_kernel(0.02 * torch.randn(
            d_in, d_out, device=cuda_device, generator=g) + 0.01 * offset)
        x32 = torch.randn(rows, d_in, device=cuda_device, generator=g) + offset
        for dtype in (torch.float32, torch.bfloat16):
            if offset and dtype == torch.bfloat16:
                continue
            x = x32.to(dtype)
            before = quantized_matmul.launches
            got = quantized_matmul(x, w8, scale)
            want = quantized_matmul_plain(x, w8, scale)
            torch.cuda.synchronize()
            assert quantized_matmul.launches == before + 1
            assert got.dtype == dtype and got.shape == (rows, d_out)
            den = max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item() / den
            assert err <= BARS[dtype], (dtype, offset, err)
            if dtype == torch.float32:
                split = dot_tf32x3(x, w8.float()) * scale
                assert (got - split).abs().max().item() / den <= 1e-5
            name = ("float" if dtype == torch.float32 else "__nv_bfloat16")
            keys = _kernel_names(lambda: quantized_matmul(x, w8, scale))
            assert any(f"qmm_mma_kernel<{tiles}, {name}>" in key
                       for key in keys), keys
            assert not any("qmm_kernel<" in key for key in keys), keys


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d_in,d_out", [(8, 8192, 2048),
                                             (8, 2048, 256),
                                             (1024, 2048, 6144)])
def test_quant_matmul_plan_fills_the_card(cuda_device, rows, d_in, d_out):
    """K7's plan: up to 16 rows take the decode tiles (16 rows a block),
    more the prefill tiles (128); products with few 128-column output
    blocks split their input until every SM has a block; the splits cover
    the whole input in 64-row tiles, each split at least one tile."""
    block_rows, splits, per_split = qmm_plan(cuda_device, rows, d_in, d_out)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert block_rows == (16 if rows <= 16 else 128)
    tiles = -(-d_in // 64)
    assert (splits - 1) * per_split < tiles <= splits * per_split
    blocks = -(-d_out // 128) * -(-rows // block_rows)
    assert blocks * splits >= min(sms, blocks * tiles)


@pytest.mark.cuda
def test_quant_matmul_kernel_refuses_what_it_cannot_take(cuda_device):
    """out not a multiple of 16 (K7's 16-byte weight loads), a weight K7
    would have to copy on every call, or a float weight: the wrapper
    raises, launches nothing and falls back to nothing."""
    x = torch.randn(8, 64, device=cuda_device)
    w8, scale = quantize_dense_kernel(torch.randn(64, 40, device=cuda_device))
    before = quantized_matmul.launches
    with pytest.raises(ValueError, match="16"):
        quantized_matmul(x, w8, scale)
    square, sq_scale = quantize_dense_kernel(
        torch.randn(64, 64, device=cuda_device))
    assert square.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        quantized_matmul(x, square.t(), sq_scale)
    with pytest.raises(TypeError):
        quantized_matmul(x, torch.randn(64, 48, device=cuda_device),
                         scale[:, :48])
    assert quantized_matmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("g_per_kv,d", [(1, 64), (4, 64), (8, 16), (2, 96),
                                        (16, 8), (32, 48), (16, 48), (32, 8),
                                        (2, 136), (1, 192), (16, 200),
                                        (3, 256), (1, 264), (4, 512),
                                        (2, 1024)])
def test_decode_kernel_matches_plain(cuda_device, g_per_kv, d):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    b, kvh, cap = 4, 2, 300
    k = torch.randn(b, kvh, cap, d, device=cuda_device, generator=g)
    v = torch.randn(b, kvh, cap, d, device=cuda_device, generator=g)
    cache = append(init_cache(b, kvh, cap, d, cuda_device),
                   l2norm_tensors(k), v)
    cache = cache._replace(length=torch.tensor(
        [0, 1, 129, 300], dtype=torch.int32, device=cuda_device))
    q = l2norm_tensors(torch.randn(b, kvh * g_per_kv, d, device=cuda_device,
                                   generator=g))

    before = quantized_decode_attention.launches
    got = quantized_decode_attention(q, cache, scale=8.0, l2norm_qk=False)
    want = decode_attention_plain(q.view(b, kvh, g_per_kv, d), cache, 8.0)
    torch.cuda.synchronize()
    assert quantized_decode_attention.launches == before + 1
    err = (got - want.view(b, kvh * g_per_kv, d)).abs().max().item()
    assert err <= 2e-3, err
    assert got[0].abs().max().item() == 0  # an empty slot returns 0


@pytest.mark.cuda
@pytest.mark.parametrize("g_per_kv,d", [(1, 64), (4, 32), (8, 16), (2, 128),
                                        (16, 8), (32, 48), (16, 48), (32, 8),
                                        (2, 136), (1, 192), (16, 200),
                                        (3, 256), (1, 264), (4, 512),
                                        (2, 1024)])
def test_decode_kernel_e4m3_matches_plain(cuda_device, g_per_kv, d):
    """The decode kernel's e4m3 arm: no V scales, e rounded to bf16."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    b, kvh, cap = 4, 2, 300
    k = torch.randn(b, kvh, cap, d, device=cuda_device, generator=g)
    v = 3 * torch.randn(b, kvh, cap, d, device=cuda_device, generator=g)
    cache = append(init_cache(b, kvh, cap, d, cuda_device,
                              kv_dtype=torch.float8_e4m3fn),
                   l2norm_tensors(k), v)
    cache = cache._replace(length=torch.tensor(
        [0, 1, 129, 300], dtype=torch.int32, device=cuda_device))
    q = l2norm_tensors(torch.randn(b, kvh * g_per_kv, d, device=cuda_device,
                                   generator=g))

    before = quantized_decode_attention.launches
    got = quantized_decode_attention(q, cache, scale=8.0, l2norm_qk=False)
    want = decode_attention_plain(q.view(b, kvh, g_per_kv, d), cache, 8.0)
    torch.cuda.synchronize()
    assert quantized_decode_attention.launches == before + 1
    err = (got - want.view(b, kvh * g_per_kv, d)).abs().max().item()
    assert err <= 1e-4, err
    assert got[0].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.int8, torch.float8_e4m3fn],
                         ids=["int8", "e4m3"])
@pytest.mark.parametrize("g_per_kv,d", [(1, 16), (8, 32), (4, 64), (2, 96),
                                        (3, 128), (16, 8), (32, 48), (16, 48),
                                        (32, 8), (2, 136), (1, 192), (16, 200),
                                        (3, 256), (1, 264), (4, 512),
                                        (2, 1024)])
def test_paged_decode_kernel_matches_plain(cuda_device, kv_dtype, g_per_kv,
                                           d):
    """Shuffled page ids, ragged lengths (empty, one token, across a page
    boundary, the whole table) and a finished slot: its row on the null
    page with a stale length, read only as far as the table reaches."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, kvh, ps, mp = 5, 2, 128, 4
    num_pages = b * mp + 3
    ids = torch.randperm(num_pages - 1, device=cuda_device, generator=g) + 1
    table = ids[:b * mp].view(b, mp).to(torch.int32)
    cache = init_paged_cache(num_pages, kvh, ps, d, b, mp, kv_dtype=kv_dtype,
                             device=cuda_device)._replace(page_table=table)
    k = torch.randn(b, kvh, mp * ps, d, device=cuda_device, generator=g)
    v = 3 * torch.randn(b, kvh, mp * ps, d, device=cuda_device, generator=g)
    cache = append_paged(cache, l2norm_tensors(k), v)
    table = table.clone()
    table[4] = 0
    cache = cache._replace(page_table=table, length=torch.tensor(
        [0, 1, 129, mp * ps, 700], dtype=torch.int32, device=cuda_device))
    q = l2norm_tensors(torch.randn(b, kvh * g_per_kv, d, device=cuda_device,
                                   generator=g))

    before = paged_decode_attention.launches
    got = paged_decode_attention(q, cache, scale=8.0, l2norm_qk=False)
    want = paged_decode_plain(q.view(b, kvh, g_per_kv, d), cache, 8.0)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert torch.isfinite(got).all()
    err = (got - want.view(b, kvh * g_per_kv, d)).abs().max().item()
    assert err <= 1e-4, err
    assert got[0].abs().max().item() == 0
    # the kernel reads q in bf16 and sums in a fixed order: bf16 queries
    # give the f32 output rounded once
    got_bf16 = paged_decode_attention(q.to(torch.bfloat16), cache, scale=8.0,
                                      l2norm_qk=False)
    assert torch.equal(got_bf16, got.to(torch.bfloat16))


# b, h, kvh, seq_q, seq_k, d, causal, key mask, bias leading dim
BWD_CASES = {
    "causal-1024-d64": (1, 2, 2, 1024, 1024, 64, True, None, None),
    "cross-causal-d32": (1, 2, 2, 70, 130, 32, True, None, None),
    "causal-q-past-k-d16": (2, 2, 2, 130, 70, 16, True, None, None),
    "ragged-gqa-key-mask-d96": (2, 4, 2, 130, 257, 96, False, "some", None),
    "all-keys-masked-d128": (1, 2, 2, 64, 128, 128, False, "all", None),
    "mqa-causal-d64": (2, 4, 1, 200, 200, 64, True, None, None),
    "bias-heads-gqa": (2, 4, 2, 100, 150, 64, True, None, "h"),
    "bias-batch-mask-d128": (2, 4, 4, 65, 65, 128, False, "some", "b"),
    "bias-reduce-17": (17, 2, 2, 130, 130, 64, True, None, "h"),
    # head dims between the kernel widths: zero-padded to 16, 64 and 96
    "causal-d8": (1, 2, 2, 100, 100, 8, True, None, None),
    "key-mask-gqa-d48": (2, 4, 1, 70, 150, 48, False, "some", None),
    "causal-gqa-d80": (1, 4, 2, 130, 130, 80, True, None, None),
    "bias-key-mask-d80": (2, 2, 2, 65, 100, 80, False, "some", "h"),
    "all-keys-masked-d48": (1, 2, 2, 64, 130, 48, False, "all", None),
    # the tensor-core dK/dV kernel's edges: GQA 8/2 at d 128, seq_k not a
    # multiple of its 64 keys, seq_q past seq_k
    "causal-1024-d128-gqa-8-2": (1, 8, 2, 1024, 1024, 128, True, None, None),
    "causal-ragged-k-d64": (2, 2, 2, 190, 190, 64, True, None, None),
    # the longest float32 one-pass chains: dK and dV sum G x seq_q queries
    # (seq_q up to ONEPASS_BWD_MAX_SEQ), 8192 both ways
    "causal-8192-d64": (1, 2, 2, 8192, 8192, 64, True, None, None),
    "causal-1024-d64-gqa-8-1": (1, 8, 1, 1024, 1024, 64, True, None, None),
    "causal-q-past-k-d64": (1, 2, 2, 200, 100, 64, True, None, None),
    # the tensor-core dQ kernel's edges: seq_k odd (dB by single adds, the
    # bias staged 4 bytes at a time) and a bias past a causal seq_q < seq_k
    "bias-odd-k-d64": (2, 2, 2, 67, 129, 64, True, None, "h"),
    # the widest instances (192, 256: 8 warps a dK/dV block) and widths
    # padded to them
    "causal-gqa-d136": (1, 4, 2, 130, 130, 136, True, None, None),
    "key-mask-bias-d192": (2, 2, 2, 100, 170, 192, False, "some", "h"),
    "causal-ragged-d192": (2, 2, 2, 150, 150, 192, True, None, None),
    "causal-q-past-k-d200": (1, 2, 2, 150, 90, 200, True, None, None),
    "causal-gqa-d256": (1, 4, 2, 256, 256, 256, True, None, None),
    "bias-batch-d256": (2, 4, 4, 70, 130, 256, False, None, "b"),
    # past 256: the wide route, column blocks of 128 (dB added by one)
    "causal-key-mask-gqa-d264": (1, 4, 2, 100, 130, 264, True, "some", None),
    "bias-heads-gqa-d384": (2, 4, 2, 70, 90, 384, True, None, "h"),
    "bias-batch-key-mask-d512": (2, 2, 1, 64, 100, 512, False, "some", "b"),
    # the wide route's dK/dV kernel on the tensor cores: a 128-column
    # remainder block (384, 1152), GQA with key masks and an (h, i, j) bias,
    # d 1032 (padded to 1152), query tiles past the keys' causal start
    "causal-key-mask-gqa-d384": (1, 4, 2, 130, 130, 384, True, "some", None),
    "key-mask-bias-heads-gqa-d384": (2, 4, 2, 70, 150, 384, False, "some",
                                     "h"),
    "causal-key-mask-gqa-d512": (2, 4, 2, 150, 150, 512, True, "some", None),
    "causal-key-mask-bias-gqa-d512": (1, 4, 2, 130, 130, 512, True, "some",
                                      "h"),
    "key-mask-gqa-d1032": (2, 4, 2, 70, 130, 1032, False, "some", None),
    "causal-key-mask-bias-gqa-d1032": (1, 4, 2, 100, 100, 1032, True, "some",
                                       "h"),
    # the wide route's dQ kernel on the tensor cores (K3a past 256, dB added
    # by column block 0 alone): d 264 (padded to 384, a remainder block),
    # 512 and 1032 (padded to 1152: 4 full blocks and a remainder), seq_q
    # below and past seq_k (cross alignment, partial tiles), key masks, GQA
    # g 2, (h, i, j) and (b, i, j) biases
    "bias-heads-cross-causal-gqa-d264": (2, 4, 2, 130, 200, 264, True, None,
                                         "h"),
    "key-mask-bias-batch-d264": (2, 4, 4, 200, 130, 264, False, "some", "b"),
    "causal-key-mask-bias-batch-gqa-d512": (2, 4, 2, 130, 200, 512, True,
                                            "some", "b"),
    "bias-heads-d512": (2, 2, 2, 256, 256, 512, False, None, "h"),
    "bias-batch-cross-mqa-d1032": (2, 2, 1, 130, 200, 1032, False, None, "b"),
    "causal-key-mask-bias-heads-cross-gqa-d1032": (1, 4, 2, 200, 130, 1032,
                                                   True, "some", "h"),
}


def _bwd_inputs(device, case, dtype):
    b, h, kvh, sq, sk, d, causal, mask_kind, bias_kind = BWD_CASES[case]
    g = torch.Generator(device=device).manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=g)

    q, k = l2norm_tensors(randn(b, h, sq, d), randn(b, kvh, sk, d))
    q, k, v = q.to(dtype), k.to(dtype), randn(b, kvh, sk, d).to(dtype)
    mask = None
    if mask_kind == "some":
        mask = torch.rand(b, sk, device=device, generator=g) > 0.3
    elif mask_kind == "all":
        mask = torch.zeros(b, sk, dtype=torch.bool, device=device)
    bias = None if bias_kind is None else 0.5 * randn(
        b if bias_kind == "b" else h, sq, sk)
    kw = dict(bias_batch_dim=bias_kind == "b", scale=8.0, causal=causal)
    o, inv_l = flash_attention_forward_plain(q, k, v, mask, bias, **kw)
    do = randn(*o.shape).to(dtype)
    return (do, o, inv_l, q, k, v, mask, bias), kw


# the one-pass kernel takes no bias, as in JAX
BWD_ROUTES = [(case, route) for case in sorted(BWD_CASES)
              for route in ("onepass", "twopass")
              if route == "twopass" or BWD_CASES[case][8] is None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,route", BWD_ROUTES)
def test_backward_kernels_match_plain(cuda_device, case, dtype, route):
    args, kw = _bwd_inputs(cuda_device, case, dtype)
    counters = ((bwd_kernel.fused_bwd_kernel,) if route == "onepass"
                else (bwd_kernel.dq_kernel, bwd_kernel.dkdv_kernel))
    before = [c.launches for c in counters]
    if route == "onepass":
        got = bwd_kernel._backward_onepass(
            *args[:7], scale=kw["scale"], causal=kw["causal"]) + (None,)
    else:
        got = bwd_kernel._backward_twopass(*args, **kw)
    want = flash_attention_backward_plain(*args, **kw)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.isfinite(x.float()).all(), name
        err = _grad_err(x, y, dtype)
        assert err <= GRAD_BARS[dtype], (name, err)
    if BWD_CASES[case][7] == "all":
        assert all(t.abs().max().item() == 0 for t in got[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256, 512])
@pytest.mark.parametrize("route", ["onepass", "twopass"])
def test_backward_kernels_large_logits(cuda_device, route, d):
    """Scale 10 (and, on the two-pass route, an (h, i, j) bias up to 4): e
    reaches e^10 (e^14), far past the f16 range, which the tensor-core
    kernels' bf16 e and dS fragments hold."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    b, h, s = 2, 4, 200
    dtype = torch.bfloat16
    q, k = l2norm_tensors(
        *(torch.randn(b, h, s, d, device=cuda_device, generator=g)
          for _ in range(2)))
    k[:, :, :s // 2] = q[:, :, :s // 2]      # logits at the full scale
    q, k = q.to(dtype), k.to(dtype)
    v = torch.randn(b, h, s, d, device=cuda_device, generator=g).to(dtype)
    bias = None if route == "onepass" else 4 * torch.rand(
        h, s, s, device=cuda_device, generator=g)
    kw = dict(bias_batch_dim=False, scale=10.0, causal=True)
    o, inv_l = flash_attention_forward_plain(q, k, v, None, bias, **kw)
    do = torch.randn(o.shape, device=cuda_device, generator=g).to(dtype)
    args = (do, o, inv_l, q, k, v, None, bias)
    if route == "onepass":
        got = bwd_kernel._backward_onepass(*args[:7], scale=10.0,
                                           causal=True) + (None,)
    else:
        got = bwd_kernel._backward_twopass(*args, **kw)
    want = flash_attention_backward_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        if y is None:
            continue
        assert torch.isfinite(x.float()).all(), name
        err = _grad_err(x, y, dtype)
        assert err <= GRAD_BARS[dtype], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 48, 80, 136, 200])
def test_op_between_kernel_widths_runs_the_kernels(cuda_device, d, dtype):
    """The public op at a head dim that is no kernel width: its forward and
    backward launch K1 and K2 (zero-padded to the next width) and match
    the plain forward, and the plain backward on the kernel forward's o
    and inv_l (a bf16 o from K1's bf16 P moves delta' = rowsum(dO o) by
    more than the backward's bar; the forward is held to its own)."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)

    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k = l2norm_tensors(
        *(torch.randn(2, 4, 150, d, device=cuda_device, generator=g)
          for _ in range(2)))
    q, k = q.to(dtype), k.to(dtype)
    v, do = (torch.randn(2, 4, 150, d, device=cuda_device,
                         generator=g).to(dtype) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n1, n2 = (flash_attention_forward.launches,
              bwd_kernel.fused_bwd_kernel.launches)
    o = flash_cosine_sim_attention(*leaves, causal=True, l2norm_qk=False)
    got = torch.autograd.grad(o, leaves, do)
    assert (flash_attention_forward.launches,
            bwd_kernel.fused_bwd_kernel.launches) == (n1 + 1, n2 + 1)

    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o_p, _ = flash_attention_forward_plain(q, k, v, None, None, **kw)
    o_k, inv_k = flash_attention_forward(q, k, v, None, None, **kw)
    want = flash_attention_backward_plain(do, o_k, inv_k, q, k, v, None,
                                          None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o_k, o.detach())
    assert o.shape == o_p.shape and o.dtype == dtype
    assert (o.float() - o_p.float()).abs().max().item() <= BARS[dtype]
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape, name
        assert _grad_err(x, y, dtype) <= GRAD_BARS[dtype], name


@pytest.mark.cuda
def test_kernels_take_head_dims_past_256(cuda_device):
    """d 264 is a multiple of 8 the JAX op takes: the op (forward and
    backward), decode and paged decode run it on the card against plain.
    d 260 is not: every wrapper raises, naming what the card takes, and
    launches nothing."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)

    g = torch.Generator(device=cuda_device).manual_seed(264)
    counts = lambda: (flash_attention_forward.launches,  # noqa: E731
                      bwd_kernel.fused_bwd_kernel.launches,
                      quantized_decode_attention.launches,
                      paged_decode_attention.launches)
    q, k, v = (torch.randn(1, 2, 64, 264, device=cuda_device, generator=g,
                           requires_grad=True) for _ in range(3))
    before = counts()
    o = flash_cosine_sim_attention(q, k, v, causal=True)
    o.float().square().sum().backward()
    assert counts()[:2] == (before[0] + 1, before[1] + 1)
    assert o.shape == q.shape and torch.isfinite(q.grad).all()
    qn, kn = l2norm_tensors(q.detach(), k.detach())
    o_p, _ = flash_attention_forward_plain(qn, kn, v.detach(), None, None,
                                           bias_batch_dim=False, scale=8.0,
                                           causal=True)
    assert (o.detach() - o_p).abs().max().item() <= BARS[torch.float32]

    cache = append(init_cache(1, 2, 64, 264, cuda_device), kn, v.detach())
    got = quantized_decode_attention(qn[:, :, 0], cache, l2norm_qk=False)
    want = decode_attention_plain(qn[:, :, 0].view(1, 2, 1, 264), cache, 8.0)
    assert (got - want.view(got.shape)).abs().max().item() <= 2e-3
    pool = append_paged(init_paged_cache(2, 2, 128, 264, 1, 1,
                                         device=cuda_device)._replace(
        page_table=torch.ones(1, 1, dtype=torch.int32, device=cuda_device)),
        kn, v.detach())
    got5 = paged_decode_attention(qn[:, :, 0], pool, l2norm_qk=False)
    want5 = paged_decode_plain(qn[:, :, 0].view(1, 2, 1, 264), pool, 8.0)
    assert (got5 - want5.view(got5.shape)).abs().max().item() <= 1e-4

    q, k, v = (torch.randn(1, 2, 64, 260, device=cuda_device)
               for _ in range(3))
    before = counts()
    match = r"positive multiples of 8 \(up to 256 at the next of \(16, 32, "
    with pytest.raises(ValueError, match="or a multiple of 8"):
        flash_cosine_sim_attention(q, k, v, causal=True)  # the op's own check
    o, inv_l = flash_attention_forward_plain(q, k, v, None, None,
                                             bias_batch_dim=False,
                                             scale=8.0, causal=True)
    with pytest.raises(ValueError, match=match):
        bwd_kernel.flash_attention_backward(
            o, o, inv_l, q, k, v, None, None, bias_batch_dim=False,
            scale=8.0, causal=True)
    with pytest.raises(ValueError, match=match):
        quantized_decode_attention(q[:, :, 0], init_cache(1, 2, 64, 260,
                                                          cuda_device))
    with pytest.raises(ValueError, match=match):
        paged_decode_attention(q[:, :, 0], init_paged_cache(
            2, 2, 128, 260, 1, 1, device=cuda_device))
    assert counts() == before


# kernel, storage, (query heads a kv head, kv heads, d)
SPLIT_CASES = [(kern, kv, shape)
               for kern in ("contiguous", "paged")
               for kv in ("int8", "e4m3")
               for shape in ((1, 2, 8), (1, 4, 64), (16, 1, 256), (1, 2, 264),
                             (8, 1, 512))]


@pytest.mark.cuda
@pytest.mark.parametrize("kern,kv,shape", SPLIT_CASES)
def test_decode_split_edges_match_plain(cuda_device, kern, kv, shape):
    """Split-K at its edges: capacity 1024 in 8 splits of 128 tokens;
    lengths 0, 1, 127, 128 (one split exactly), 129, 500, 1024 (the
    capacity) and, on the paged kernel, a finished slot on the null page
    with a stale length; g 16 and MQA.  Held against plain (2e-3 on int8,
    1e-4 on e4m3), an empty slot exactly 0, and a second call equal to
    the first bit for bit (the merge leaves its ticket counters at 0)."""
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import decode_split

    gq, kvh, d = shape
    kv_dtype = torch.int8 if kv == "int8" else torch.float8_e4m3fn
    g = torch.Generator(device=cuda_device).manual_seed(d + gq)
    ps, mp = 128, 8
    lengths = [0, 1, 127, 128, 129, 500, mp * ps]
    if kern == "paged":
        lengths.append(700)
    b = len(lengths)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert decode_split(mp * ps, b * kvh * -(-gq // 8), sms) == (128, 8)
    k = l2norm_tensors(torch.randn(b, kvh, mp * ps, d, device=cuda_device,
                                   generator=g))
    v = 3 * torch.randn(b, kvh, mp * ps, d, device=cuda_device, generator=g)
    q = l2norm_tensors(torch.randn(b, kvh * gq, d, device=cuda_device,
                                   generator=g))
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    if kern == "paged":
        ids = torch.randperm(b * mp, device=cuda_device, generator=g) + 1
        table = ids.view(b, mp).to(torch.int32)
        cache = append_paged(init_paged_cache(
            b * mp + 1, kvh, ps, d, b, mp, kv_dtype=kv_dtype,
            device=cuda_device)._replace(page_table=table), k, v)
        table = table.clone()
        table[-1] = 0                 # finished: null page, stale length
        cache = cache._replace(page_table=table, length=length)
        kernel, plain = paged_decode_attention, paged_decode_plain
    else:
        cache = append(init_cache(b, kvh, mp * ps, d, cuda_device,
                                  kv_dtype=kv_dtype), k, v)._replace(
                                      length=length)
        kernel, plain = quantized_decode_attention, decode_attention_plain
    before = kernel.launches
    first = kernel(q, cache, scale=8.0, l2norm_qk=False)
    second = kernel(q, cache, scale=8.0, l2norm_qk=False)
    want = plain(q.view(b, kvh, gq, d), cache, 8.0).view(first.shape)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)
    err = (first - want).abs().max().item()
    assert err <= (2e-3 if kv == "int8" else 1e-4), err
    assert first[0].abs().max().item() == 0


def _decode_case(kern, kv_dtype, lengths, kvh, d, cap, g, device):
    """(kernel, plain, queries (b, kvh, d) f32, cache) for one query head a
    kv head over ``cap`` tokens a slot: a contiguous cache, or the same
    tokens in shuffled pages of 128."""
    b, ps = len(lengths), 128
    k = l2norm_tensors(torch.randn(b, kvh, cap, d, device=device,
                                   generator=g))
    v = 3 * torch.randn(b, kvh, cap, d, device=device, generator=g)
    q = l2norm_tensors(torch.randn(b, kvh, d, device=device, generator=g))
    length = torch.tensor(lengths, dtype=torch.int32, device=device)
    if kern == "paged":
        mp = cap // ps
        table = (torch.randperm(b * mp, device=device, generator=g) + 1
                 ).view(b, mp).to(torch.int32)
        cache = append_paged(init_paged_cache(
            b * mp + 1, kvh, ps, d, b, mp, kv_dtype=kv_dtype,
            device=device)._replace(page_table=table), k, v)
        return (paged_decode_attention, paged_decode_plain, q,
                cache._replace(length=length))
    cache = append(init_cache(b, kvh, cap, d, device, kv_dtype=kv_dtype),
                   k, v)
    return (quantized_decode_attention, decode_attention_plain, q,
            cache._replace(length=length))


@pytest.mark.cuda
@pytest.mark.parametrize("kern", ["contiguous", "paged"])
@pytest.mark.parametrize("kv", ["int8", "e4m3"])
def test_decode_splits_of_several_tiles_match_plain(cuda_device, kern, kv):
    """The 0.81B decode step's shape: b8 kvh16 g1 d128 over a capacity of
    2048, 128 rows, so that a split holds several 128-token tiles (256 on
    the H100's 132 SMs, streamed in stages of 64).  Lengths at a split's
    edges (255, 256, 257), the step's 1060, the capacity; held against
    plain at scale 8 (2e-3 on int8, 1e-4 on e4m3)."""
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import decode_split

    kv_dtype = torch.int8 if kv == "int8" else torch.float8_e4m3fn
    g = torch.Generator(device=cuda_device).manual_seed(2048)
    lengths, kvh, d, cap = [0, 1, 255, 256, 257, 1060, 2047, 2048], 16, 128, \
        2048
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tps, _ = decode_split(cap, len(lengths) * kvh, sms)
    assert tps > 128, (sms, tps)
    kernel, plain, q, cache = _decode_case(kern, kv_dtype, lengths, kvh, d,
                                           cap, g, cuda_device)
    before = kernel.launches
    got = kernel(q, cache, scale=8.0, l2norm_qk=False)
    want = plain(q[:, :, None], cache, 8.0).view(got.shape)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= (2e-3 if kv == "int8" else 1e-4), err
    assert got[0].abs().max().item() == 0


@pytest.mark.cuda
def test_decode_calls_on_two_streams_match_plain(cuda_device):
    """K4 and K5 launched on two streams at once, alternately, over caches
    with the same rows: each stream merges with its own ticket counters,
    so every output equals plain's and every counter is back at 0."""
    from flash_cosine_sim_attention_tpu_torch.quant import decode_kernel

    g = torch.Generator(device=cuda_device).manual_seed(2)
    lengths = [1024, 900, 129, 1024, 700, 1000, 256, 1024]
    cases = [_decode_case(kern, torch.int8, lengths, 8, 64, 1024, g,
                          cuda_device) for kern in ("contiguous", "paged")]
    wants = [plain(q[:, :, None], cache, 8.0).view(q.shape)
             for _, plain, q, cache in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = []
    for i in range(24):
        for j, stream in enumerate(streams):
            kernel, _, q, cache = cases[(i + j) % 2]
            with torch.cuda.stream(stream):
                outs.append(((i + j) % 2,
                             kernel(q, cache, scale=8.0, l2norm_qk=False)))
    torch.cuda.synchronize()
    for which, out in outs:
        err = (out - wants[which]).abs().max().item()
        assert err <= 2e-3, (which, err)
    for stream in streams:
        tickets = decode_kernel._tickets[(outs[0][1].device,
                                          stream.cuda_stream)]
        assert tickets.abs().max().item() == 0


# kernel, storage, head dim
WIDE_DECODE_CASES = [(kern, kv, d) for kern in ("contiguous", "paged")
                     for kv in ("int8", "e4m3") for d in (1032, 2048, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("kern,kv,d", WIDE_DECODE_CASES)
def test_decode_kernels_past_1024_match_plain(cuda_device, kern, kv, d):
    """Past d 1024 the decode kernels split the output columns over column
    blocks of at most 1024 (ceil(d / 1024) of them), each forming the
    scores over the whole d and merging its own splits.  GQA 4/2 over a
    capacity of 512 in splits of 128 tokens: an empty slot (exactly 0), a
    slot across three splits, the whole capacity; held against plain (2e-3
    on int8, 1e-4 on e4m3), one launch a call, and a second call equal to
    the first bit for bit (every column block's counters are back at 0)."""
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import (
        decode_col_blocks, decode_split)

    kv_dtype = torch.int8 if kv == "int8" else torch.float8_e4m3fn
    g = torch.Generator(device=cuda_device).manual_seed(d)
    lengths, kvh, gq, cap, ps = [0, 300, 512], 2, 2, 512, 128
    b = len(lengths)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert decode_split(cap, b * kvh * decode_col_blocks(d), sms) == (128, 4)
    k = l2norm_tensors(torch.randn(b, kvh, cap, d, device=cuda_device,
                                   generator=g))
    v = 3 * torch.randn(b, kvh, cap, d, device=cuda_device, generator=g)
    q = l2norm_tensors(torch.randn(b, kvh * gq, d, device=cuda_device,
                                   generator=g))
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    if kern == "paged":
        mp = cap // ps
        table = (torch.randperm(b * mp, device=cuda_device, generator=g) + 1
                 ).view(b, mp).to(torch.int32)
        cache = append_paged(init_paged_cache(
            b * mp + 1, kvh, ps, d, b, mp, kv_dtype=kv_dtype,
            device=cuda_device)._replace(page_table=table), k, v)
        kernel, plain = paged_decode_attention, paged_decode_plain
    else:
        cache = append(init_cache(b, kvh, cap, d, cuda_device,
                                  kv_dtype=kv_dtype), k, v)
        kernel, plain = quantized_decode_attention, decode_attention_plain
    cache = cache._replace(length=length)
    before = kernel.launches
    first = kernel(q, cache, scale=8.0, l2norm_qk=False)
    second = kernel(q, cache, scale=8.0, l2norm_qk=False)
    want = plain(q.view(b, kvh, gq, d), cache, 8.0).view(first.shape)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)
    err = (first - want).abs().max().item()
    assert err <= (2e-3 if kv == "int8" else 1e-4), err
    assert first[0].abs().max().item() == 0


@pytest.mark.cuda
def test_profiled_calls_name_the_wide_and_split_instances(cuda_device):
    """The profiler names the wide route's instances at d 512 (bf16: the
    tensor-core fwd_wide_mma_kernel, dkdv_wide_mma_kernel and
    dq_wide_mma_kernel; no FMA forward, dK/dV or dQ instance) and the
    split-K decode kernels, one kernel a decode call, the column-block
    instance past d 1024."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)

    g = torch.Generator(device=cuda_device).manual_seed(512)
    q, k, v = (torch.randn(1, 2, 96, 512, device=cuda_device, generator=g,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    bias = torch.zeros(2, 96, 96, device=cuda_device, requires_grad=True)
    cache = append(init_cache(2, 2, 256, 512, cuda_device),
                   *l2norm_tensors(k.detach().float()[:1].expand(2, -1, -1, -1),
                                   v.detach().float()[:1].expand(2, -1, -1, -1)))
    qd = l2norm_tensors(q.detach()[:1, :, 0].expand(2, -1, -1))
    kw_, vw = (torch.randn(2, 2, 256, 1032, device=cuda_device, generator=g)
               for _ in range(2))
    wide = append(init_cache(2, 2, 256, 1032, cuda_device),
                  l2norm_tensors(kw_), vw)
    qw = l2norm_tensors(torch.randn(2, 2, 1032, device=cuda_device,
                                    generator=g))

    def work():
        flash_cosine_sim_attention(q, k, v, causal=True).float().sum().backward()
        flash_cosine_sim_attention(q, k, v, attn_bias=bias,
                                   causal=True).float().sum().backward()
        quantized_decode_attention(qd, cache, l2norm_qk=False)
        quantized_decode_attention(qw, wide, l2norm_qk=False)

    work()                             # builds and loads first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    for name in ("fwd_wide_mma_kernel<__nv_bfloat16>",
                 "dkdv_wide_mma_kernel<true>",
                 "dkdv_wide_mma_kernel<false>",
                 "dq_wide_mma_kernel", "decode_kernel<",
                 "decode_cols_kernel<"):
        assert any(name in key for key in keys), (name, keys)
    assert not any("fwd_wide_kernel" in key or "dkdv_wide_kernel" in key
                   or "dq_wide_kernel<" in key for key in keys), keys
    for name in ("decode_kernel<", "decode_cols_kernel<"):
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        assert sum(e.count for e in rows) == 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
def test_bf16_two_pass_runs_the_tensor_core_dq_kernel(cuda_device, d):
    """The bf16 two-pass route launches K3a's tensor-core instance
    (dq_mma_kernel) and K3b's, and no FMA instance of either, as the
    profiler names them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    case = "bias-heads-gqa" if d == 64 else "bias-batch-d256"
    args, kw = _bwd_inputs(cuda_device, case, torch.bfloat16)
    bwd_kernel._backward_twopass(*args, **kw)   # builds and loads first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bwd_kernel._backward_twopass(*args, **kw)
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    assert any(f"dq_mma_kernel<__nv_bfloat16, {d}>" in k for k in keys), keys
    assert any(f"dkdv_mma_kernel<__nv_bfloat16, {d}, false>" in k
               for k in keys), keys
    assert not any("dq_kernel<" in k or "dkdv_kernel<" in k for k in keys)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bias-heads-cross-causal-gqa-d264",
                                  "causal-key-mask-bias-batch-gqa-d512",
                                  "bias-batch-cross-mqa-d1032"])
def test_bf16_wide_two_pass_runs_the_tensor_core_dq_kernel(cuda_device, case):
    """Past d 256 the bf16 two-pass route launches K3a's tensor-core
    instance (dq_wide_mma_kernel) and K3b's, and no FMA instance of
    either, as the profiler names them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args, kw = _bwd_inputs(cuda_device, case, torch.bfloat16)
    bwd_kernel._backward_twopass(*args, **kw)   # builds and loads first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bwd_kernel._backward_twopass(*args, **kw)
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    assert any("dq_wide_mma_kernel" in k for k in keys), keys
    assert any("dkdv_wide_mma_kernel<false>" in k for k in keys), keys
    assert not any("dq_wide_kernel<" in k or "dkdv_wide_kernel" in k
                   for k in keys), keys


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernels(cuda_device):
    """The public op's gradient on the card goes through K2 without a bias
    and through K3a/K3b with one."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)

    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(2, 4, 96, 64, device=cuda_device, generator=g,
                           requires_grad=True) for _ in range(3))
    bias = torch.randn(4, 96, 96, device=cuda_device, generator=g,
                       requires_grad=True)
    n1, n3 = (bwd_kernel.fused_bwd_kernel.launches,
              bwd_kernel.dq_kernel.launches)
    flash_cosine_sim_attention(q, k, v, causal=True).sum().backward()
    assert bwd_kernel.fused_bwd_kernel.launches == n1 + 1
    flash_cosine_sim_attention(q, k, v, attn_bias=bias).sum().backward()
    assert bwd_kernel.dq_kernel.launches == n3 + 1
    assert bias.grad is not None and torch.isfinite(bias.grad).all()


@pytest.mark.cuda
def test_long_queries_take_the_two_pass_kernels(cuda_device):
    """Past ONEPASS_BWD_MAX_SEQ query rows the bias-free backward takes
    K3a/K3b, as the JAX dispatch does, and still matches the plain one."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_attention_backward)
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import (
        ONEPASS_BWD_MAX_SEQ)

    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k = l2norm_tensors(
        torch.randn(1, 2, ONEPASS_BWD_MAX_SEQ + 1, 64, device=cuda_device,
                    generator=g),
        torch.randn(1, 2, 128, 64, device=cuda_device, generator=g))
    v = torch.randn(1, 2, 128, 64, device=cuda_device, generator=g)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=False)
    o, inv_l = flash_attention_forward_plain(q, k, v, None, None, **kw)
    do = torch.randn(o.shape, device=cuda_device, generator=g)
    args = (do, o, inv_l, q, k, v, None, None)
    counts = [bwd_kernel.fused_bwd_kernel.launches,
              bwd_kernel.dq_kernel.launches, bwd_kernel.dkdv_kernel.launches]
    got = flash_attention_backward(*args, **kw)
    want = flash_attention_backward_plain(*args, **kw)
    assert [bwd_kernel.fused_bwd_kernel.launches,
            bwd_kernel.dq_kernel.launches,
            bwd_kernel.dkdv_kernel.launches] == [counts[0], counts[1] + 1,
                                                 counts[2] + 1]
    assert got[3] is None
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert _grad_err(x, y, torch.float32) <= GRAD_BARS[torch.float32], name


def _kernel_names(work):
    """The CUDA kernels one call of ``work`` launched, as the profiler
    names them (after a first call that builds and loads).  A profile
    that recorded no device event at all (the tracer missed the call: the
    call itself raises on any failed launch) is taken again, at most
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    work()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if keys:
            break
    return keys


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128, 192, 256])
def test_float32_runs_the_tf32_instances_of_k1_k2_at_every_width(cuda_device,
                                                                d):
    """float32 K1, the one-pass K2 and the two-pass K3a and K3b run their
    3xTF32 tensor-core instances (fwd_tf32_kernel<D>, dkdv_tf32_kernel<D,
    true>, dq_tf32_kernel<D>, dkdv_tf32_kernel<D, false>) at every width
    up to 256, and no FMA instance, as the profiler names them."""
    g = torch.Generator(device=cuda_device).manual_seed(14)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    q, k = l2norm_tensors(randn(1, 2, 130, d), randn(1, 2, 130, d))
    v = randn(1, 2, 130, d)
    bias = 0.5 * randn(2, 130, 130)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o, inv_l = flash_attention_forward_plain(q, k, v, None, None, **kw)
    do = randn(*o.shape)

    def work():
        flash_attention_forward(q, k, v, None, None, **kw)
        bwd_kernel._backward_onepass(do, o, inv_l, q, k, v, None,
                                     scale=8.0, causal=True)
        bwd_kernel._backward_twopass(do, o, inv_l, q, k, v, None, bias, **kw)

    keys = _kernel_names(work)
    want = [f"fwd_tf32_kernel<{d}, float>", f"dkdv_tf32_kernel<{d}, true>",
            f"dq_tf32_kernel<{d}>", f"dkdv_tf32_kernel<{d}, false>"]
    assert not any("fwd_kernel<" in key or "dq_kernel<" in key
                   or "dkdv_kernel<" in key for key in keys), keys
    for name in want:
        assert any(name in key for key in keys), (name, keys)
    assert not any("mma_kernel" in key for key in keys), keys


# the float32 K1 and one-pass K2 above d 128 (3xTF32 since 192 and 256
# left the FMA kernels): b, h, kvh, seq_q, seq_k, causal, key mask.  GQA
# with causal cross alignment and odd seq_k, a key mask without causal and
# seq_q past seq_k, one partial query and key tile each, and q tiles
# whose keys run past O's 256-key chains (closed into o) with a partial
# last tile
TF32_WIDE_CASES = {"gqa-causal-cross": (2, 4, 2, 130, 197, True, False),
                   "key-mask": (2, 4, 4, 200, 130, False, True),
                   "partial-tiles": (1, 2, 2, 77, 77, True, False),
                   "long-keys": (1, 2, 1, 300, 701, True, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TF32_WIDE_CASES))
@pytest.mark.parametrize("d", [192, 200, 256])
def test_float32_wide_k1_k2_tf32_instances_match_plain(cuda_device, d, case):
    """float32 K1 and the one-pass K2 at d 192 and 256, and at d 200
    (zero-padded to 256), hold o (inv_l at 1e-5 relative) and dq, dk, dv
    at the float32 bars against the exact plain versions and against the
    plain versions with the kernels' split (mm=dot_tf32x3), and run their
    3xTF32 instances by profiler name."""
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import (
        kernel_head_dim)
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3

    b, h, kvh, sq, sk, causal, masked = TF32_WIDE_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(20)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    q, k = l2norm_tensors(randn(b, h, sq, d), randn(b, kvh, sk, d), groups=8)
    v = randn(b, kvh, sk, d)
    mask = (torch.rand(b, sk, device=cuda_device, generator=g) > 0.3
            if masked else None)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=causal)
    o, inv_l = flash_attention_forward(q, k, v, mask, None, **kw)
    for mm in (None, dot_tf32x3):
        o_p, inv_p = flash_attention_forward_plain(q, k, v, mask, None,
                                                   mm=mm, **kw)
        assert o.shape == o_p.shape and torch.isfinite(o).all()
        assert (o - o_p).abs().max().item() <= BARS[torch.float32], mm
    # inv_l as in test_float32_kernels_at_8_groups_and_scale_8: at 8 groups
    # and scale 8 a logit reaches 64, where float32's own rounding moves
    # inv_l by ~1e-5
    _, inv_f = flash_attention_forward_plain(q, k, v, mask, None, **kw)
    _, inv_x = flash_attention_forward_plain(
        q, k, v, mask, None, mm=lambda a, b: (a.double() @ b.double()).float(),
        **kw)

    def rel(x, y):
        return ((x - y) / y).abs().max().item()

    assert rel(inv_l, inv_x) <= max(1e-5, 2 * rel(inv_f, inv_x))
    args = (randn(*o.shape), o_p, inv_p, q, k, v, mask, None)
    got = bwd_kernel._backward_onepass(*args[:7], scale=8.0, causal=causal)
    for mm in (None, dot_tf32x3):
        want = flash_attention_backward_plain(*args, mm=mm, **kw)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.shape == y.shape and torch.isfinite(x).all(), name
            err = _grad_err(x, y, torch.float32)
            assert err <= GRAD_BARS[torch.float32], (name, mm, err)
    width = kernel_head_dim(d, "forward")
    keys = _kernel_names(lambda: (
        flash_attention_forward(q, k, v, mask, None, **kw),
        bwd_kernel._backward_onepass(*args[:7], scale=8.0, causal=causal)))
    for name in (f"fwd_tf32_kernel<{width}, float>",
                 f"dkdv_tf32_kernel<{width}, true>"):
        assert any(name in key for key in keys), (name, keys)
    assert not any("fwd_kernel<" in key or "dkdv_kernel<" in key
                   for key in keys), keys


@pytest.mark.cuda
def test_op_at_d512_f32_runs_the_wide_tf32_kernels(cuda_device):
    """The public op in float32 at d 512, the heads-512 model's width: its
    forward and (no bias, so one-pass) backward launch K1 and K2 once each
    and K3a, K3b never; with an (h, i, j) bias K1, K3a and K3b once each
    and K2 never; o matches the plain forward, and the gradients (the
    bias's too) the plain backward on the kernel forward's o and inv_l, at
    the float32 bar; and the wrappers run the wide route's 3xTF32
    instances (fwd_wide_tf32_kernel, dkdv_wide_tf32_kernel<true>;
    dq_wide_tf32_kernel, dkdv_wide_tf32_kernel<false>) and no FMA one, as
    the profiler names them."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)

    g = torch.Generator(device=cuda_device).manual_seed(512)
    q, k = l2norm_tensors(
        *(torch.randn(2, 2, 300, 512, device=cuda_device, generator=g)
          for _ in range(2)), groups=8)
    v, do = (torch.randn(2, 2, 300, 512, device=cuda_device, generator=g)
             for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = lambda: (flash_attention_forward.launches,  # noqa: E731
                      bwd_kernel.fused_bwd_kernel.launches,
                      bwd_kernel.dq_kernel.launches,
                      bwd_kernel.dkdv_kernel.launches)
    before = counts()
    o = flash_cosine_sim_attention(*leaves, causal=True, l2norm_qk=False)
    got = torch.autograd.grad(o, leaves, do)
    assert [n - m for n, m in zip(counts(), before)] == [1, 1, 0, 0]

    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o_p, _ = flash_attention_forward_plain(q, k, v, None, None, **kw)
    o_k, inv_k = flash_attention_forward(q, k, v, None, None, **kw)
    want = flash_attention_backward_plain(do, o_k, inv_k, q, k, v, None,
                                          None, **kw)
    torch.cuda.synchronize()
    assert (o.detach() - o_p).abs().max().item() <= BARS[torch.float32]
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(x).all(), name
        assert _grad_err(x, y, torch.float32) <= GRAD_BARS[torch.float32], (
            name, _grad_err(x, y, torch.float32))
    keys = _kernel_names(lambda: (
        flash_attention_forward(q, k, v, None, None, **kw),
        bwd_kernel._backward_onepass(do, o_k, inv_k, q, k, v, None,
                                     scale=8.0, causal=True)))
    for name in ("fwd_wide_tf32_kernel<float>", "dkdv_wide_tf32_kernel<true>"):
        assert any(name in key for key in keys), (name, keys)
    assert not any("fwd_wide_kernel" in key or "dkdv_wide_kernel" in key
                   or "dq_wide_kernel" in key for key in keys), keys

    # with an (h, i, j) bias the backward takes the two-pass route
    bias = 0.5 * torch.randn(2, 300, 300, device=cuda_device, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    before = counts()
    o = flash_cosine_sim_attention(*leaves[:3], attn_bias=leaves[3],
                                   causal=True, l2norm_qk=False)
    got = torch.autograd.grad(o, leaves, do)
    assert [n - m for n, m in zip(counts(), before)] == [1, 0, 1, 1]
    o_p, _ = flash_attention_forward_plain(q, k, v, None, bias, **kw)
    o_k, inv_k = flash_attention_forward(q, k, v, None, bias, **kw)
    want = flash_attention_backward_plain(do, o_k, inv_k, q, k, v, None,
                                          bias, **kw)
    torch.cuda.synchronize()
    assert (o.detach() - o_p).abs().max().item() <= BARS[torch.float32]
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        assert torch.isfinite(x).all(), name
        assert _grad_err(x, y, torch.float32) <= GRAD_BARS[torch.float32], (
            name, _grad_err(x, y, torch.float32))
    keys = _kernel_names(lambda: bwd_kernel._backward_twopass(
        do, o_k, inv_k, q, k, v, None, bias, **kw))
    for name in ("dq_wide_tf32_kernel", "dkdv_wide_tf32_kernel<false>"):
        assert any(name in key for key in keys), (name, keys)
    assert not any("dkdv_wide_kernel" in key or "dq_wide_kernel" in key
                   or "mma_kernel" in key for key in keys), keys


# the float32 two-pass kernels' edges at every 3xTF32 width: GQA, causal
# cross alignment with odd seq_k (dB by scalar adds, the bias staged 4
# bytes at a time) and partial tiles, or a key mask without causal and
# seq_q past seq_k; an (h, i, j) or a (b, i, j) bias (the key's first
# letter); a shared bias axis of 17 (dB summed by 17 blocks); 2048 keys
# and queries (K3a's dQ past its 256-key chains, K3b's dK and dV past
# their 256-query chains)
TF32_TWOPASS_CASES = {"h": (2, 4, 2, 130, 197, True, False),
                      "b": (2, 4, 4, 200, 130, False, True),
                      "h-shared-axis-17": (17, 2, 2, 130, 130, True, False),
                      "h-long-2048": (1, 2, 2, 2048, 2048, True, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind", sorted(TF32_TWOPASS_CASES))
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 192, 200, 256, 384, 512])
def test_float32_two_pass_tf32_instances_match_plain(cuda_device, d,
                                                     bias_kind):
    """float32 K3a and K3b at every width (dq_tf32_kernel<D>,
    dkdv_tf32_kernel<D, false> up to 256, d 200 zero-padded to 256; past
    it the wide route's dq_wide_tf32_kernel and
    dkdv_wide_tf32_kernel<false>, d 384 with a 128-column remainder block;
    3xTF32) hold dq, dk, dv and dB at the float32 bar against the exact
    plain backward and against the plain backward with the kernels' split
    (mm=dot_tf32x3), with a bias, and run those instances by profiler
    name."""
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import (
        kernel_head_dim)
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3

    b, h, kvh, sq, sk, causal, masked = TF32_TWOPASS_CASES[bias_kind]
    batch_bias = bias_kind[0] == "b"
    g = torch.Generator(device=cuda_device).manual_seed(18)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    q, k = l2norm_tensors(randn(b, h, sq, d), randn(b, kvh, sk, d), groups=8)
    v = randn(b, kvh, sk, d)
    mask = (torch.rand(b, sk, device=cuda_device, generator=g) > 0.3
            if masked else None)
    bias = 0.5 * randn(b if batch_bias else h, sq, sk)
    kw = dict(bias_batch_dim=batch_bias, scale=8.0, causal=causal)
    o, inv_l = flash_attention_forward_plain(q, k, v, mask, bias, **kw)
    args = (randn(*o.shape), o, inv_l, q, k, v, mask, bias)
    got = bwd_kernel._backward_twopass(*args, **kw)
    for mm in (None, dot_tf32x3):
        want = flash_attention_backward_plain(*args, mm=mm, **kw)
        for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
            assert x.shape == y.shape and torch.isfinite(x).all(), name
            err = _grad_err(x, y, torch.float32)
            assert err <= GRAD_BARS[torch.float32], (name, mm, err)
    width = kernel_head_dim(d, "backward")
    keys = _kernel_names(lambda: bwd_kernel._backward_twopass(*args, **kw))
    names = ((f"dq_tf32_kernel<{width}>", f"dkdv_tf32_kernel<{width}, false>")
             if width <= 256 else
             ("dq_wide_tf32_kernel", "dkdv_wide_tf32_kernel<false>"))
    for name in names:
        assert any(name in key for key in keys), (name, keys)
    assert not any("dq_kernel<" in key or "dkdv_kernel<" in key
                   or "dq_wide_kernel" in key or "dkdv_wide_kernel" in key
                   for key in keys), keys


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256, 512])
def test_float32_two_pass_keeps_card_nans(cuda_device, d):
    """A NaN made on the card (0x7FFFFFFF) in q and in v leaves K3a's dq
    and dB and K3b's dk and dv NaN exactly where the plain two-pass
    backward's are (an (h, i, j) bias sends the backward there)."""
    g = torch.Generator(device=cuda_device).manual_seed(22)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    q, k = l2norm_tensors(randn(1, 2, 200, d), randn(1, 2, 200, d))
    v = randn(1, 2, 200, d)
    nan = torch.zeros(1, device=cuda_device) / 0
    q[0, 0, 5, :] = nan
    v[0, 1, 7, 3] = nan
    bias = 0.5 * randn(2, 200, 200)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=False)
    o, inv_l = flash_attention_forward_plain(q, k, v, None, bias, **kw)
    args = (randn(*o.shape), o, inv_l, q, k, v, None, bias)
    got = bwd_kernel.flash_attention_backward(*args, **kw)
    want = flash_attention_backward_plain(*args, **kw)
    for name, x, y in zip(("dq", "dk", "dv", "db"), got, want):
        assert y.isnan().any(), name
        assert torch.equal(x.isnan(), y.isnan()), name
    assert not want[2].isnan().all()  # dv of head 1 stays finite


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_float32_kernels_at_8_groups_and_scale_8(cuda_device, d):
    """8 l2norm groups at scale 8: a logit reaches 64, where JAX's bf16
    split of a float32 product misses the 1e-4 bar on o.  K1 and K2 in
    float32 (3xTF32) hold o and the gradients at the float32 bars against
    the plain versions, and inv_l at 1e-5 relative against the plain
    forward with exact products (float64, rounded to float32), or at
    twice the float32 plain version's own distance from it where that is
    larger: float32's rounding of a logit near 64 moves inv_l by ~1e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(15)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    def exact_mm(a, b):
        return (a.double() @ b.double()).float()

    def rel(x, y):
        return ((x - y) / y).abs().max().item()

    q, k = l2norm_tensors(randn(1, 8, 1024, d), randn(1, 8, 1024, d),
                          groups=8)
    v = randn(1, 8, 1024, d)
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o, inv_l = flash_attention_forward(q, k, v, None, None, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, None, None, **kw)
    _, inv_x = flash_attention_forward_plain(q, k, v, None, None,
                                             mm=exact_mm, **kw)
    torch.cuda.synchronize()
    assert (o - o_p).abs().max().item() <= BARS[torch.float32]
    assert rel(inv_l, inv_x) <= max(1e-5, 2 * rel(inv_p, inv_x))
    do = randn(*o.shape)
    args = (do, o_p, inv_p, q, k, v, None, None)
    got = bwd_kernel._backward_onepass(*args[:7], scale=8.0, causal=True)
    want = flash_attention_backward_plain(*args, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = _grad_err(x, y, torch.float32)
        assert err <= GRAD_BARS[torch.float32], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_float32_kernels_keep_card_nans(cuda_device, d):
    """A NaN made on the card (0/0 gives 0x7FFFFFFF there) in q and in v
    leaves K1's o and K2's dq, dk, dv NaN exactly where the plain
    versions' are: the tensor-core instances' split into TF32 keeps it a
    NaN (rounding it as a finite word would carry it into -0)."""
    g = torch.Generator(device=cuda_device).manual_seed(16)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    q, k = l2norm_tensors(randn(1, 2, 200, d), randn(1, 2, 200, d))
    v = randn(1, 2, 200, d)
    nan = torch.zeros(1, device=cuda_device) / 0
    q[0, 0, 5, :] = nan
    v[0, 1, 7, 3] = nan
    kw = dict(bias_batch_dim=False, scale=8.0, causal=False)
    o, _ = flash_attention_forward(q, k, v, None, None, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, None, None, **kw)
    assert o_p.isnan().any() and not o_p.isnan().all()
    assert torch.equal(o.isnan(), o_p.isnan())
    do = randn(*o.shape)
    got = bwd_kernel._backward_onepass(do, o_p, inv_p, q, k, v, None,
                                       scale=8.0, causal=False)
    want = flash_attention_backward_plain(do, o_p, inv_p, q, k, v, None,
                                          None, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert y.isnan().any(), name
        assert torch.equal(x.isnan(), y.isnan()), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_float32_long_chains_with_offset_values(cuda_device, d):
    """K1's O and K3a's dQ over 8192 keys and K2's and K3b's dK, dV over
    8192 queries are long chains of tensor-core sums, each rounded toward
    zero; with v and dO' of mean 3 every term of O and dV has one sign, so
    the drift adds up.  The float32 instances close each chain every 256
    keys or queries and hold the float32 bars against the plain
    versions."""
    g = torch.Generator(device=cuda_device).manual_seed(17)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    q, k = l2norm_tensors(randn(1, 2, 8192, d), randn(1, 2, 8192, d))
    v = randn(1, 2, 8192, d) + 3
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o, inv_l = flash_attention_forward(q, k, v, None, None, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, None, None, **kw)
    assert (o - o_p).abs().max().item() <= BARS[torch.float32]
    assert ((inv_l - inv_p) / inv_p).abs().max().item() <= 1e-5
    do = randn(*o.shape) + 3
    args = (do, o_p, inv_p, q, k, v, None, None)
    want = flash_attention_backward_plain(*args, **kw)
    for route, got in (
            ("onepass", bwd_kernel._backward_onepass(
                *args[:7], scale=8.0, causal=True)),
            ("twopass", bwd_kernel._backward_twopass(*args, **kw)[:3])):
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            err = _grad_err(x, y, torch.float32)
            assert err <= GRAD_BARS[torch.float32], (route, name, err)


@pytest.mark.cuda
def test_float32_two_pass_chains_at_seq_16384(cuda_device):
    """The float32 long-context step's chains: past ONEPASS_BWD_MAX_SEQ the
    backward is K3a and K3b, and at seq 16384 K1's O and K3a's dQ sum 16384
    keys, K3b's dK and dV 16384 queries, each closed every 256 (v and dO'
    of mean 3, as above); they hold the float32 bars against the plain
    versions."""
    g = torch.Generator(device=cuda_device).manual_seed(19)

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g)

    s = 16384
    q, k = l2norm_tensors(randn(1, 2, s, 64), randn(1, 2, s, 64))
    v = randn(1, 2, s, 64) + 3
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o, inv_l = flash_attention_forward(q, k, v, None, None, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, None, None, **kw)
    assert (o - o_p).abs().max().item() <= BARS[torch.float32]
    assert ((inv_l - inv_p) / inv_p).abs().max().item() <= 1e-5
    do = randn(*o.shape) + 3
    args = (do, o_p, inv_p, q, k, v, None, None)
    want = flash_attention_backward_plain(*args, **kw)
    for fn in (bwd_kernel.fused_bwd_kernel, bwd_kernel.dq_kernel,
               bwd_kernel.dkdv_kernel):
        fn.launches = 0
    got = bwd_kernel.flash_attention_backward(*args, **kw)
    assert got[3] is None
    assert (bwd_kernel.fused_bwd_kernel.launches, bwd_kernel.dq_kernel.launches,
            bwd_kernel.dkdv_kernel.launches) == (0, 1, 1)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = _grad_err(x, y, torch.float32)
        assert err <= GRAD_BARS[torch.float32], (name, err)
