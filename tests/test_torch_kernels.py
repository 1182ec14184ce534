"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests carry the ``cuda`` marker and skip where no card is
present: a CUDA kernel has no CPU mode.  The file imports nothing of the
JAX package, so it also runs where flax is not installed:

    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerances: float32 1e-4 (same maths, other sum order, no TF32); bf16
outputs 2e-2 (a few bf16 ulps at |o| <= 2); inv_l 1e-5 relative; the
contiguous decode kernel 2e-3 on f32 output; the int8-weight matmul
1e-4 (f32) and 2e-2 (bf16) of max(1, max|y|).  The
backward's gradients reach |g| ~ 30 at scale 8: float32 errors are taken
relative to max(1, max|g|), bar 1e-4 (K2 adds dQ with atomics whose order
varies from run to run); bf16 errors per entry, relative to |g| + rms(g),
bar 2^-7 (kernel and plain version round the same f32 sums, added in
another order, to bf16: one bf16 ulp is at most 2^-7 of the value; the
tensor-core dK/dV kernel feeds e and dS to its products as bf16 hi + lo
pairs, so its sums stay those of f32 operands to ~16 bits).  Head dims
between the kernel widths (8, 48, 80) run zero-padded to the next one;
d past 128 is refused.
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
    v_dtype: masks, bias and GQA as in the float arms."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["bf16", "int8"])
@pytest.mark.parametrize("d", [16, 128])
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
    g = torch.Generator(device=cuda_device).manual_seed(8)
    w8, scale = quantize_dense_kernel(0.02 * torch.randn(
        d_in, d_out, device=cuda_device, generator=g))
    x32 = torch.randn(rows, d_in, device=cuda_device, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        before = quantized_matmul.launches
        got = quantized_matmul(x, w8, scale)
        want = quantized_matmul_plain(x, w8, scale)
        torch.cuda.synchronize()
        assert quantized_matmul.launches == before + 1
        assert got.dtype == dtype and got.shape == (rows, d_out)
        err = (got.float() - want.float()).abs().max().item() / max(
            1.0, want.float().abs().max().item())
        assert err <= BARS[dtype], (dtype, err)


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
                                        (16, 8), (32, 48), (16, 48), (32, 8)])
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
                                        (16, 8), (32, 48), (16, 48), (32, 8)])
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
                                        (32, 8)])
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
    "causal-q-past-k-d64": (1, 2, 2, 200, 100, 64, True, None, None),
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
@pytest.mark.parametrize("route", ["onepass", "twopass"])
def test_backward_kernels_large_logits(cuda_device, route):
    """Scale 10 (and, on the two-pass route, an (h, i, j) bias up to 4): e
    reaches e^10 (e^14), far past the f16 range, which the tensor-core
    kernel's bf16 e and dS fragments hold."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    b, h, s, d = 2, 4, 200, 64
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
@pytest.mark.parametrize("d", [8, 48, 80])
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
def test_kernels_refuse_head_dims_past_128(cuda_device):
    """d 136 is a multiple of 8 the JAX op takes, but no kernel is built
    for it: every wrapper raises, naming the widths the card takes, and
    launches nothing."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)

    q, k, v = (torch.randn(1, 2, 64, 136, device=cuda_device,
                           requires_grad=True) for _ in range(3))
    counts = lambda: (flash_attention_forward.launches,  # noqa: E731
                      bwd_kernel.fused_bwd_kernel.launches,
                      quantized_decode_attention.launches)
    before = counts()
    match = r"multiples of 8 up to 128 \(built for \(16, 32, 64, 96, 128\)"
    with pytest.raises(ValueError, match=match):
        flash_cosine_sim_attention(q, k, v, causal=True)
    o, inv_l = flash_attention_forward_plain(q, k, v, None, None,
                                             bias_batch_dim=False,
                                             scale=8.0, causal=True)
    with pytest.raises(ValueError, match=match):
        bwd_kernel.flash_attention_backward(
            o, o, inv_l, q, k, v, None, None, bias_batch_dim=False,
            scale=8.0, causal=True)
    cache = init_cache(1, 2, 64, 136, cuda_device)
    with pytest.raises(ValueError, match=match):
        quantized_decode_attention(q[:, :, 0], cache)
    assert counts() == before


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
