"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests carry the ``cuda`` marker and skip where no card is
present: a CUDA kernel has no CPU mode.  The file imports nothing of the
JAX package, so it also runs where flax is not installed:

    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerances: float32 1e-4 (same maths, other sum order, no TF32); bf16
outputs 2e-2 (a few bf16 ulps at |o| <= 2); inv_l 1e-5 relative.  The
backward's gradients reach |g| ~ 30 at scale 8: float32 errors are taken
relative to max(1, max|g|), bar 1e-4 (K2 adds dQ with atomics whose order
varies from run to run); bf16 errors per entry, relative to |g| + rms(g),
bar 2^-7 (kernel and plain version round the same f32 sums, added in
another order, to bf16: one bf16 ulp is at most 2^-7 of the value).
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
    decode_attention_plain,
    init_cache,
    quantized_decode_attention,
)

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
@pytest.mark.parametrize("g_per_kv,d", [(1, 64), (4, 64), (8, 16), (2, 96)])
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
