"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests carry the ``cuda`` marker and skip where no card is
present: a CUDA kernel has no CPU mode.  The file imports nothing of the
JAX package, so it also runs where flax is not installed:

    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerances: float32 1e-4 (same maths, other sum order, no TF32); bf16
outputs 2e-2 (a few bf16 ulps at |o| <= 2); inv_l 1e-5 relative.
"""

import pytest
import torch

from flash_cosine_sim_attention_tpu_torch.ops import (
    flash_attention_forward,
    flash_attention_forward_plain,
    l2norm_tensors,
)
from flash_cosine_sim_attention_tpu_torch.quant import (
    append,
    decode_attention_plain,
    init_cache,
    quantized_decode_attention,
)

BARS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
