"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel under
     flash_cosine_sim_attention_tpu_torch/csrc with nvcc, in parallel;
  3. the forward kernel against its plain PyTorch version on the card;
  4. the INT8 decode kernel against its plain version on the card;
  5. the serving path at full width: the validation model of train.py
     (dim 512, depth 8, 8 heads of 64, bf16, random weights from a numpy
     seed loaded through params_from_flax) served by InferenceEngine with
     8 slots of capacity 1024; the kernels' launch counts are read around
     this phase only;
  6. path parity: the same teacher-forced prefill + decode steps with an
     f32 model on the card (kernels) and on the CPU (plain versions);
  7. the backward kernels (K2 one-pass; K3a dQ + dB and K3b dK, dV, the
     two-pass route) against the plain backward on the card, then checked
     and timed at the shapes phase 8 gives them;
  8. the training path at full width: the same model with float32
     parameters and bf16 compute takes 10 optimizer steps of 4
     microbatches of 4 x 1024 tokens through the port's train_step, on a
     synthetic byte corpus drawn from a numpy seed; the forward and
     one-pass backward kernels' launch counts are read around these
     steps only, and a profiled step must show the tensor-core
     instances of K1 and K2 and no bf16 FMA dK/dV kernel.  Then the op's
     attn_bias gradient, the two-pass kernels' path: a learnable
     (h, i, j) bias takes 3 Adam steps through flash_cosine_sim_attention,
     counts read around them, and a profiled fourth step must show K3b's
     tensor-core instance;
  9. training parity: one microbatch of an f32 depth-2 model, loss and
     every parameter's gradient, card (kernels) vs CPU (plain versions);
 10. the paged decode kernel (K5) and the decode kernel's e4m3 arm
     against their plain versions on the card (int8 and e4m3 codes,
     ragged, empty and finished slots, GQA, shuffled page ids), then
     checked and timed at the shapes phase 11 gives them;
 11. paged serving at full width: the serving model behind
     PagedInferenceEngine on a 63-page pool, its page accounting checked
     after each phase of traffic, then 8 steps each on an e4m3 pool and
     an e4m3 contiguous cache (K1, K5 and K4-e4m3 launches read around
     this phase only); paged vs contiguous, and paged card vs CPU, with
     an f32 model;
 12. the int8-weight matmul (K7) against its plain version over every
     (in, out) of the 0.81B production model and a ragged shape, at 1,
     8, 33 and 1024 rows, f32 and bf16, then timed at 8 rows (L2
     flushed) and 1024 beside F.linear on a bf16 weight copy (one decode
     step's 65 calls; one layer's four products at 1024 rows); K1's int8
     arm against its plain version, the bf16 arm against its plain
     version at phase 13's prefill and continuation shapes, both timed
     at b1 h16 s1024 d128 causal beside SDPA; then one
     forward and backward of the op with qk_int8 and qk_fp8 against the
     plain straight-through gradients (K1 launches read around qk_int8);
 13. int8-weight serving at full production width: the JAX package's
     production decode model (tools/bench_prod_decode.py: dim 2048,
     depth 16, 16 heads of 128, bf16, random weights drawn on the card),
     quantize_params + fuse_qkv_params, logits held against the bf16
     weights; InferenceEngine (8 slots, capacity 2048) takes eight
     1024-token prompts, 36 steps and a continuation, then
     PagedInferenceEngine 8 steps (K1, K4, K5 and K7 launches read
     around it and around the prefills, K7's checked at 65 per pass); a
     ninth 1024-token prompt refills the last slot under the profiler,
     for its device time and to show K1's and K7's tensor-core instances
     (a profiled decode step must show K7's); card vs CPU at depth 2 in
     f32;
 14. widths and groups: the op's forward and backward at d 48 (zero-padded
     to the kernels' 64), f32 and bf16, against plain with K1's and K2's
     launches read around them; K4 and K5 at 16 query heads on one kv
     head and d 8 (int8 and e4m3, ragged, empty and finished slots)
     against plain; the validation width with 16 heads of 32 on one kv
     head served by both engines (3 prompts and 8 steps each; K1, K4 and
     K5 launches read around it), then card vs CPU at depth 2 in f32.
Then one JSON line lists every ported kernel with its launches on its
path, error, times and bound (timing lines also print the achieved
TFLOP/s); the script's own wall time, the nvcc build included; the
card's name and power limit; and, last, the {"ok": true, ...} line.
Kernel device times come from torch.profiler, wrapper times are
CUDA-event medians.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

MODEL = dict(num_tokens=256, dim=512, depth=8, max_seq_len=1024, heads=8,
             dim_head=64, attn_scale=1.0, attn_l2norm_groups=8,
             pre_norm=True)
ENGINE = dict(num_slots=8, capacity=1024, prompt_buckets=(128, 256, 512, 1024))
# one-shot prompts cover every bucket; the chunked one takes the 8th slot.
# Longest prompt + 52 decoded tokens stays within capacity 1024.
PROMPT_LENS = (60, 200, 300, 500, 700, 850, 960)
CHUNKED_LEN, CHUNK_TOKENS = 400, 128
F32_ERR_BAR = 1e-4    # f32 kernels vs plain: same maths, other sum order
BF16_ERR_BAR = 2e-2   # bf16 outputs: a few bf16 ulps at |o| <= 2
PARITY_BAR = 1e-2     # f32 logits, card vs CPU (decode's bf16 roundings)
# gradients, kernel vs plain (see grad_err): f32 1e-4 of max(1, max|g|)
# (K2 adds dQ with atomics, whose order varies from run to run); bf16
# 2^-7 per entry of |g| + rms(g): both round the same f32 sums, added in
# another order, to bf16, so they differ by at most one bf16 ulp, which
# is at most 2^-7 of the value
GRAD_BARS = {torch.float32: F32_ERR_BAR, torch.bfloat16: 2 ** -7}
TRAIN_STEPS = 10
TRAIN_CORPUS_BYTES = 1 << 20   # the JAX trainer draws 8 M the same way
LOSS_BAR = 1e-4               # f32 training loss, card vs CPU
TRAIN_GRAD_BAR = 1e-3         # f32 gradients, card vs CPU, of max|g|
PAGED_ENGINE = dict(num_slots=8, page_size=128, num_pages=64,
                    max_pages_per_slot=8, reserve_tokens=128,
                    prompt_buckets=(128, 256, 512, 1024))
PAGED_LENGTHS = (0, 1, 127, 128, 129, 500, 1023, 1024)
# the JAX package's production decode configuration
# (tools/bench_prod_decode.py): 0.81B parameters, int8 weights, fused QKV
PROD_MODEL = dict(num_tokens=256, dim=2048, depth=16, max_seq_len=2048,
                  heads=16, dim_head=128, attn_scale=1.0, pre_norm=True)
PROD_ENGINE = dict(num_slots=8, capacity=2048,
                   prompt_buckets=(128, 256, 512, 1024))
PROD_PAGED = dict(num_slots=8, page_size=128, num_pages=129,
                  max_pages_per_slot=16, prompt_buckets=(128, 256, 512, 1024))
PROD_PROMPT, PROD_STEPS = 1024, 32
# (in, out) of each dense layer of that model and its calls per decode step
PROD_DENSE = {"qkv": ((2048, 6144), 16), "out": ((2048, 2048), 16),
              "ff_in": ((2048, 8192), 16), "ff_out": ((8192, 2048), 16),
              "logits": ((2048, 256), 1)}
K7_PER_PASS = 16 * 4 + 1     # K7 launches per prefill, continuation or step
QUANT_BARS = (0.05, 0.08)    # int8 vs bf16 weights, rel L2 of logits:
                             # prefill, decode (JAX's, tests/test_quant.py)
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 (NVIDIA data sheet)
# phase 14: the validation width with 16 query heads of 32 on one kv head
WIDE_MODEL = dict(MODEL, heads=16, kv_heads=1, dim_head=32)
WIDE_PROMPTS = (100, 300, 700)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def event_ms(fn, iters: int = 50, warmup: int = 5, flush=None) -> float:
    """Median CUDA-event time of one call of ``fn`` (host enqueue included
    where it is slower than the device); ``flush`` runs between calls,
    outside the timed window."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_us(work, iters: int) -> float:
    """Total device time (us) of the kernels ``iters`` calls of ``work``
    ran, from torch.profiler."""
    return sum(t for _, t, _ in cuda_rows(work, iters))


def cuda_rows(work, iters: int):
    """torch.profiler's per-kernel rows (key, self device time in us,
    count) over ``iters`` calls of ``work``.  The profiler can drop the
    record of the first kernel launched in its window: on the H100,
    profiles of 20 calls read 19 for the kernel each call launches first
    (which then sorts last by first appearance), at the same call sites
    run after run, and a sentinel kernel closing the window changed
    nothing.  So a sentinel (torch.cuda._sleep's spin_kernel) opens the
    window, and it is left out of the rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(iters):
            work()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and "spin_kernel" not in e.key]


def whole_us(work, iters: int, tries: int = 3) -> float:
    """kernel_us for a ``work`` that launches each of its kernels the same
    number of times per call: a kernel whose count is not a multiple of
    ``iters`` lost a record, so the counts are printed and ``work`` is
    profiled again; fails after ``tries`` such profiles."""
    for _ in range(tries):
        rows = cuda_rows(work, iters)
        counts = [count for _, _, count in rows]
        if not any(count % iters for count in counts):
            return sum(t for _, t, _ in rows)
        lost = [(key[:40], count) for key, _, count in rows
                if count % iters]
        print(f"  (the profiler lost kernel records: {lost} of counts "
              f"{counts} over {iters} calls; profiled again)")
    fail(f"the profiler lost kernel records {tries} times running")


def device_ms(fn, flush=None, iters: int = 20) -> float:
    """Device time per call of ``fn``'s kernels, the flush's excluded; the
    CUDA-event time where the profiler saw no device time."""
    for _ in range(3):
        fn()
    total = whole_us(fn if flush is None else lambda: (flush(), fn()), iters)
    if flush is not None:
        total -= whole_us(flush, iters)
    if total > 0:
        return total / iters / 1e3
    print("  (the profiler saw no device time: CUDA-event time instead)")
    return event_ms(fn, flush=flush)


def tflops(flops: float, ms: float) -> float:
    """Achieved rate, TFLOP/s, of ``flops`` operations in ``ms``."""
    return flops / (ms * 1e-3) / 1e12


def require_kernels(rows, names, path: str) -> None:
    """Fail unless every kernel name in ``names`` appears among the
    profiler's ``rows``, and no FMA instance of K1 or K7, and no bf16 FMA
    instance of the dK/dV kernel (K2, K3b), does: the bf16 paths must run
    the tensor-core instances."""
    keys = [key for key, _, _ in rows]
    missing = [n for n in names if not any(n in key for key in keys)]
    fma = [key[:60] for key in keys if "fwd_kernel<" in key
           or "qmm_kernel<" in key or "dkdv_kernel<__nv_bfloat16" in key]
    print(f"  {path}: tensor-core instances {', '.join(names)} launched: "
          f"{not missing}; f32 FMA instances launched: {fma or 'none'}")
    if missing or fma:
        fail(f"{path}: tensor-core kernels missing {missing}, FMA kernels "
             f"{fma}")


def spilling(ptxas_log: str):
    """The (mangled) kernel instances whose ptxas -v report shows register
    spills, with the bytes stored."""
    out, entry = [], ""
    for ln in ptxas_log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and int(m.group(1)):
            out.append(f"{entry} ({m.group(1)} B)")
    return out


def grad_err(x: torch.Tensor, y: torch.Tensor, dtype) -> float:
    """A kernel's gradient ``x`` against the plain version's ``y``, in the
    units of GRAD_BARS[dtype]: float32 max|x - y| / max(1, max|y|);
    bfloat16 max over entries of |x - y| / (|y| + rms(y)), which holds
    small entries to their own size and not to the largest one's."""
    x, y = x.float(), y.float()
    if dtype == torch.float32:
        return (x - y).abs().max().item() / max(1.0, y.abs().max().item())
    floor = y.square().mean().sqrt()
    return ((x - y).abs() / (y.abs() + floor).clamp_min(1e-30)).max().item()


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def random_flax_params(model, seed: int) -> dict:
    """Random weights in the flax parameter layout, from a numpy seed."""
    from flash_cosine_sim_attention_tpu_torch.models import flax_param_shapes

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


def build_model(params, dtype, device, cfg=MODEL):
    """The served model: parameters held in its compute dtype."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer, params_from_flax)
    model = CosineSimCausalTransformer(**cfg, dtype=dtype, param_dtype=dtype,
                                       device=device)
    return params_from_flax(params, model).eval()


def check_forward(card: str):
    """Phase 3: K1 vs its plain version; returns (max err, timing row)."""
    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(b, h, kvh, sq, sk, d, dtype):
        q = torch.randn(b, h, sq, d, device="cuda", generator=g)
        k = torch.randn(b, kvh, sk, d, device="cuda", generator=g)
        v = torch.randn(b, kvh, sk, d, device="cuda", generator=g)
        q, k = l2norm_tensors(q, k, groups=8)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    hist_mask = torch.rand(1, 1024, device="cuda", generator=g) < 0.4
    cases = [  # name, shapes, mask, bias, causal
        ("s1024 causal", (1, 8, 8, 1024, 1024, 64), None, None, True),
        ("q128 x k1024 key-masked", (1, 8, 8, 128, 1024, 64), hist_mask,
         None, False),
        ("q128 x k1024 all keys masked", (1, 8, 8, 128, 1024, 64),
         torch.zeros(1, 1024, dtype=torch.bool, device="cuda"), None, False),
        ("s1000 GQA 8/2 + bias", (2, 8, 2, 1000, 1000, 64), None,
         torch.randn(8, 1000, 1000, device="cuda", generator=g), True),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        bar = F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR
        for name, shape, mask, bias, causal in cases:
            q, k, v = inputs(*shape, dtype)
            kw = dict(bias_batch_dim=False, scale=1.0, causal=causal)
            o, inv_l = flash_attention_forward(q, k, v, mask, bias, **kw)
            o_p, inv_p = flash_attention_forward_plain(q, k, v, mask, bias, **kw)
            torch.cuda.synchronize()
            err = (o.float() - o_p.float()).abs().max().item()
            l_err = ((inv_l - inv_p) / inv_p).abs().max().item()
            finite = bool(torch.isfinite(o.float()).all())
            print(f"  K1 {name} {str(dtype)[6:]}: max|o-plain| {err:.3e} "
                  f"(bar {bar:g}), max rel inv_l err {l_err:.3e}")
            if not (finite and err <= bar and l_err <= 1e-5):
                fail(f"K1 {name} {dtype}: err {err}, inv_l {l_err}, "
                     f"finite {finite}")
            if mask is not None and not mask.any():
                if o.abs().max().item() != 0 or (
                        (inv_l - 1e10).abs().max().item() > 1e4):
                    fail("K1: a fully masked row must give o = 0, inv_l = 1e10")
            worst = max(worst, err)

    # timing at the largest prefill bucket of the served model
    import torch.nn.functional as F

    q, k, v = inputs(1, 8, 8, 1024, 1024, 64, torch.bfloat16)
    kw = dict(bias_batch_dim=False, scale=1.0, causal=True)
    call = lambda: flash_attention_forward(q, k, v, None, None, **kw)  # noqa: E731
    ms, call_ms = device_ms(call), event_ms(call)
    plain_ms = device_ms(
        lambda: flash_attention_forward_plain(q, k, v, None, None, **kw))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=1.0))
    pairs = 1024 * 1025 / 2                          # visible (i, j) pairs
    flops = 4 * 8 * 64 * pairs
    nbytes = 4 * q.numel() * 2 + 8 * 1024 * 4        # q, k, v, o + inv_l
    bound_ms, by = bound(flops, nbytes)
    print(f"  K1 b1 h8 s1024 d64 causal bf16 on {card}: device time kernel "
          f"{ms:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({tflops(flops, lib_ms):.1f}"
          f" TFLOP/s), bound {bound_ms:.5f} ms ({by}); wrapper call "
          f"{call_ms:.4f} ms")
    return worst, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by, library_ms=lib_ms)


def check_decode(card: str):
    """Phase 4: K4 vs its plain version; returns (max err, timing row)."""
    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.quant import (
        append, decode_attention_plain, init_cache, quantized_decode_attention)

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, kvh, cap, d = 8, 8, 1024, 64
    cache = init_cache(b, kvh, cap, d, "cuda")
    k = l2norm_tensors(torch.randn(b, kvh, cap, d, device="cuda", generator=g),
                       groups=8)
    v = torch.randn(b, kvh, cap, d, device="cuda", generator=g)
    full = append(cache, k, v)
    q = l2norm_tensors(torch.randn(b, kvh, d, device="cuda", generator=g),
                       groups=8).to(torch.bfloat16)
    lengths = torch.tensor([0, 1, 127, 128, 500, 1023, 1024, 7],
                           dtype=torch.int32, device="cuda")
    ragged = full._replace(length=lengths)
    out = quantized_decode_attention(q, ragged, scale=1.0, l2norm_qk=False)
    ref = decode_attention_plain(q.float()[:, :, None], ragged, 1.0)[:, :, 0]
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    print(f"  K4 b8 kvh8 g1 d64 cap1024 lengths {lengths.tolist()}: "
          f"max|o-plain| {err:.3e} (bar {BF16_ERR_BAR:g}; output in bf16)")
    if not err <= BF16_ERR_BAR or out[0].abs().max().item() != 0:
        fail(f"K4: err {err}, empty slot {out[0].abs().max().item()}")

    # timing with every slot full, L2 flushed between launches (a decode
    # step streams 8 layers' caches and the weights, so K/V arrive cold)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    qg = q.float()[:, :, None]
    call = lambda: quantized_decode_attention(  # noqa: E731
        q, full, scale=1.0, l2norm_qk=False)
    ms = device_ms(call, flush=scratch.zero_)
    call_ms = event_ms(call, flush=scratch.zero_)
    plain_ms = device_ms(lambda: decode_attention_plain(qg, full, 1.0),
                         flush=scratch.zero_)
    tokens = b * kvh * cap
    nbytes = tokens * (2 * d + 4) + q.numel() * 2 + b * kvh * d * 4 + b * 4
    bound_ms, by = bound(4 * d * tokens, nbytes)
    print(f"  K4 full cache (8 x 1024 tokens) on {card}: device time kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({by}); wrapper call {call_ms:.4f} ms; no single PyTorch call "
          f"computes it")
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=by, library_ms=None)


def serve(card: str, params, device: str = "cuda"):
    """Phase 5: the main path; returns the kernels' launch counts."""
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        quantized_decode_attention)
    from flash_cosine_sim_attention_tpu_torch.serving import InferenceEngine

    model = build_model(params, torch.bfloat16, device)
    engine = InferenceEngine(model, **ENGINE, seed=SEED, device=device)
    rng = np.random.default_rng(SEED + 2)
    vocab = MODEL["num_tokens"]
    seen = []
    # one warm-up request takes the one-time costs (library loads, GEMM
    # heuristics) out of the timed requests
    engine.finish(engine.add_request(rng.integers(0, vocab, 60)))

    flash_attention_forward.launches = 0
    quantized_decode_attention.launches = 0

    prefill_ms = {}
    for n in PROMPT_LENS:
        prompt = rng.integers(0, vocab, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = engine.add_request(prompt)
        torch.cuda.synchronize()
        bucket = next(b for b in ENGINE["prompt_buckets"] if n <= b)
        prefill_ms.setdefault(bucket, []).append(
            (n, 1e3 * (time.perf_counter() - t0)))
        seen.append(int(engine.last_token[slot]))
    chunked = engine.add_request(rng.integers(0, vocab, CHUNKED_LEN),
                                 chunk_tokens=CHUNK_TOKENS)
    step_ms, chunk_step_ms = [], []
    for _ in range(32):
        landing = bool(engine.prefilling.any())
        t0 = time.perf_counter()
        out = engine.step()
        (chunk_step_ms if landing else step_ms).append(
            1e3 * (time.perf_counter() - t0))
        seen.extend(out.values())
    if not engine.active[chunked]:
        fail("the chunked admission did not land within 32 steps")
    # device busy time of steady decode steps (profiled; the profiler's
    # own host cost makes its window's wall time useless)
    busy_us = kernel_us(lambda: seen.extend(engine.step().values()), 4)
    t0 = time.perf_counter()
    seen.append(engine.continue_request(0, rng.integers(0, vocab, 50)))
    continue_ms = 1e3 * (time.perf_counter() - t0)
    continue_us = kernel_us(lambda: seen.append(engine.continue_request(
        1, rng.integers(0, vocab, 50))), 1)
    t0 = time.perf_counter()
    many = engine.step_many(16)
    many_ms = 1e3 * (time.perf_counter() - t0)
    for toks in many.values():
        seen.extend(toks)
    launches = (flash_attention_forward.launches,
                quantized_decode_attention.launches)

    if len(many) != ENGINE["num_slots"] or not all(0 <= t < vocab for t in seen):
        fail(f"serving: {len(many)} slots decoded, tokens out of range")
    for bucket, runs in sorted(prefill_ms.items()):
        print(f"  prefill bucket {bucket} on {card}: " + ", ".join(
            f"{n} tokens {ms:.2f} ms" for n, ms in runs))
    dec = statistics.median(step_ms)
    print(f"  decode on {card}: {dec:.3f} ms/step median over {len(step_ms)} "
          f"steps, {ENGINE['num_slots'] * 1e3 / dec:.1f} tokens/s at 8 "
          f"slots; steps landing a {CHUNK_TOKENS}-token chunk "
          f"{statistics.median(chunk_step_ms):.2f} ms; continue_request "
          f"{continue_ms:.2f} ms; step_many(16) {many_ms / 16:.3f} ms/step")
    print(f"  decode device time on {card}: {busy_us / 4e3:.3f} ms/step "
          f"(profiled) of {dec:.3f} ms/step wall (unprofiled median): "
          f"device idle share {1 - busy_us / 4e3 / dec:.3f}")
    print(f"  continue_request (50 tokens, padded to 128) device time on "
          f"{card}: {continue_us / 1e3:.3f} ms (profiled) of {continue_ms:.3f}"
          f" ms wall (unprofiled, another slot)")
    print(f"  launches on the serving path: forward kernel {launches[0]}, "
          f"decode kernel {launches[1]}; {len(seen)} tokens, all in range")
    if min(launches) <= 0:
        fail(f"a kernel of the serving path never launched: {launches}")
    return launches


def path_parity(params, devices=("cuda", "cpu"), cfg=MODEL):
    """Phase 6 (and 14): f32 model, kernels on the card vs plain versions
    on the CPU; fails past PARITY_BAR."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        decode_step, init_decode_state, prefill)

    tokens = np.random.default_rng(SEED + 3).integers(
        0, cfg["num_tokens"], (2, 208))
    logits = {}
    for device in devices:
        model = build_model(params, torch.float32, device, cfg)
        toks = torch.from_numpy(tokens).to(device)
        state = init_decode_state(model, 2, 256, device=device)
        out, state = prefill(model, state, toks[:, :200])
        steps = [out]
        for t in range(200, 208):
            out, state = decode_step(model, state, toks[:, t])
            steps.append(out)
        logits[device] = torch.stack(steps).float().cpu()
    diff = (logits[devices[0]] - logits[devices[1]]).abs().max().item()
    print(f"  f32 depth {cfg['depth']}, {cfg['heads']} heads of "
          f"{cfg['dim_head']} on {cfg.get('kv_heads', cfg['heads'])} kv "
          f"heads: prefill(200) + 8 decode steps, card vs CPU: max |logit "
          f"diff| {diff:.3e} (bar {PARITY_BAR:g})")
    if not diff <= PARITY_BAR:
        fail(f"path parity: {diff}")


def check_backward(card: str):
    """Phase 7: K2, K3a, K3b vs the plain backward; returns
    ({kernel: max abs err}, {kernel: timing row})."""
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain,
        flash_attention_forward_plain, l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.reference import causal_keep

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    def inputs(b, h, kvh, sq, sk, d, dtype, mask_kind, bias_kind, causal):
        q, k = l2norm_tensors(randn(b, h, sq, d), randn(b, kvh, sk, d),
                              groups=8)
        q, k, v = q.to(dtype), k.to(dtype), randn(b, kvh, sk, d).to(dtype)
        mask = None
        if mask_kind == "some":
            mask = torch.rand(b, sk, device="cuda", generator=g) < 0.6
        elif mask_kind == "all":
            mask = torch.zeros(b, sk, dtype=torch.bool, device="cuda")
        bias = None if bias_kind is None else 0.5 * randn(
            b if bias_kind == "b" else h, sq, sk)
        kw = dict(bias_batch_dim=bias_kind == "b", scale=1.0, causal=causal)
        o, inv_l = flash_attention_forward_plain(q, k, v, mask, bias, **kw)
        return (randn(*o.shape).to(dtype), o, inv_l, q, k, v, mask, bias), kw

    cases = [  # name, (b, h, kvh, seq_q, seq_k, d), key mask, bias, causal
        ("s1024 causal", (1, 8, 8, 1024, 1024, 64), None, None, True),
        ("q128 x k1024 key-masked", (2, 8, 8, 128, 1024, 64), "some", None,
         False),
        ("q128 x k1024 all keys masked", (2, 8, 8, 128, 1024, 64), "all",
         None, False),
        ("s1000 GQA 8/2 + (h,i,j) bias", (2, 8, 2, 1000, 1000, 64), None,
         "h", True),
        ("s1000 GQA 8/2 key-masked + (b,i,j) bias", (2, 8, 2, 1000, 1000, 64),
         "some", "b", False),
        ("b17 + (h,i,j) bias: shared axis 17", (17, 2, 2, 130, 130, 64), None,
         "h", True),
    ]
    worst = {"K2": 0.0, "K3a": 0.0, "K3b": 0.0}

    def compare(name, args, kw, dtype, mask_kind):
        """Both routes (K2 only without a bias) against the plain version."""
        bar = GRAD_BARS[dtype]
        want = flash_attention_backward_plain(*args, **kw)
        runs = [("K3a", "K3b", bk._backward_twopass(*args, **kw))]
        if args[7] is None:
            runs.append(("K2", "K2", bk._backward_onepass(
                *args[:7], scale=kw["scale"], causal=kw["causal"]) + (None,)))
        torch.cuda.synchronize()
        for k_dq, k_dkdv, got in runs:
            errs = []
            for grad, owner, x, y in zip(("dq", "dk", "dv", "db"),
                                         (k_dq, k_dkdv, k_dkdv, k_dq),
                                         got, want):
                if y is None:
                    continue
                ok = torch.isfinite(x.float()).all().item()
                rel = grad_err(x, y, dtype)
                errs.append(f"{grad} {rel:.2e}")
                if not (ok and rel <= bar):
                    fail(f"{owner} {name} {dtype} {grad}: err {rel} (bar "
                         f"{bar}), finite {ok}")
                if mask_kind == "all" and x.abs().max().item() != 0:
                    fail(f"{owner} {name}: masked rows need 0 gradients")
                worst[owner] = max(
                    worst[owner], (x.float() - y.float()).abs().max().item())
            unit = ("max(1, max|g|)" if dtype == torch.float32
                    else "(|g| + rms g)")
            print(f"  {k_dq}{'' if k_dq == k_dkdv else '+' + k_dkdv} "
                  f"{name} {str(dtype)[6:]}: err / {unit}: "
                  f"{', '.join(errs)} (bar {bar:g})")

    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, mask_kind, bias_kind, causal in cases:
            args, kw = inputs(*shape, dtype, mask_kind, bias_kind, causal)
            compare(name, args, kw, dtype, mask_kind)

    # the trainer's attention shape, as phase 8 runs K2 and phase 8b runs
    # K3 (with an (h, i, j) bias): checked, then timed
    b, h, s, d = 4, 8, 1024, 64
    args, kw = inputs(b, h, h, s, s, d, torch.bfloat16, None, None, True)
    compare("b4 h8 s1024 causal (phase 8's shape)", args, kw,
            torch.bfloat16, None)
    x = bk._cuda_inputs(*args, False)
    args_b, kw_b = inputs(b, h, h, s, s, d, torch.bfloat16, None, "h", True)
    compare("b4 h8 s1024 causal + (h,i,j) bias (phase 8b's shape)", args_b,
            kw_b, torch.bfloat16, None)
    x_b = bk._cuda_inputs(*args_b, False)
    plain_ms = device_ms(lambda: flash_attention_backward_plain(*args, **kw))
    plain_b_ms = device_ms(
        lambda: flash_attention_backward_plain(*args_b, **kw_b))
    do, _, _, q, k, v = args[:6]
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=1.0)
    lib_ms = device_ms(lambda: torch.autograd.grad(o, (qs, ks, vs), do,
                                                   retain_graph=True))
    keep = causal_keep(s, s, "cuda")
    mask_b = torch.where(keep, args_b[7], float("-inf")).to(q.dtype)[None]
    o_b = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask_b,
                                         scale=1.0)
    lib_b_ms = device_ms(lambda: torch.autograd.grad(o_b, (qs, ks, vs), do,
                                                     retain_graph=True))
    pairs = b * h * s * (s + 1) / 2         # visible (i, j) pairs, all heads
    io = b * h * s * d * 2                  # one bf16 (b, h, s, d) tensor
    delta = b * h * s * 4
    bias_vis = h * s * (s + 1) / 2 * 4      # the bias entries causal reads
    rows = {}
    for name, call, wrapper, flops, nbytes, p_ms, l_ms in (
        ("K2", lambda: bk.fused_bwd_kernel(x, scale=1.0, causal=True),
         lambda: bk._backward_onepass(*args[:7], scale=1.0, causal=True),
         10 * d * pairs, 6 * io + delta + 2 * io, plain_ms, lib_ms),
        ("K3a", lambda: bk.dq_kernel(x_b, **kw_b),
         lambda: bk._backward_twopass(*args_b, **kw_b),
         6 * d * pairs, 5 * io + delta + 2 * bias_vis, plain_b_ms, lib_b_ms),
        ("K3b", lambda: bk.dkdv_kernel(x_b, **kw_b), None,
         8 * d * pairs, 6 * io + delta + bias_vis, plain_b_ms, lib_b_ms),
    ):
        ms = device_ms(call)
        bound_ms, by = bound(flops, nbytes)
        call_ms = event_ms(wrapper) if wrapper is not None else None
        rows[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=bound_ms,
                          bound_by=by, library_ms=l_ms)
        print(f"  {name} b{b} h{h} s{s} d{d} causal bf16"
              f"{'' if name == 'K2' else ' + (h,i,j) bias'} on {card}: "
              f"device time kernel {ms:.4f} ms ({tflops(flops, ms):.1f} "
              f"TFLOP/s), plain {p_ms:.4f} ms, SDPA backward {l_ms:.4f} ms "
              f"({tflops(flops, l_ms):.1f} TFLOP/s), bound {bound_ms:.5f} ms "
              f"({by})"
              + ("" if call_ms is None else
                 f"; wrapper call {call_ms:.4f} ms"
                 f"{'' if name == 'K2' else ' (K3a + K3b)'}"))
    print("  (plain: the whole plain backward; SDPA: dQ, dK, dV of "
          "scaled_dot_product_attention, with the bias as a float mask and "
          "no dB for K3; TFLOP/s count the function's products, 2d FLOPs "
          "per visible pair each: 5 for K2, 3 for K3a, 4 for K3b; the "
          "tensor-core K2 and K3b run 8 and 6, e and dS as bf16 hi + lo)")
    return worst, rows


def train(card: str):
    """Phase 8: the training path at full width; returns the launch counts
    of K1 and K2 over its 10 steps."""
    from flash_cosine_sim_attention_tpu_torch.data import (
        TextSampler, synthetic_corpus)
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.ops import bwd_kernel as bk
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.train import (
        BATCH_SIZE, GRAD_ACCUM, make_optimizer, train_step)

    torch.manual_seed(SEED)
    model = CosineSimCausalTransformer(**MODEL, dtype=torch.bfloat16,
                                       device="cuda")
    opt = make_optimizer(model)
    seq = MODEL["max_seq_len"]
    sampler = TextSampler(synthetic_corpus(TRAIN_CORPUS_BYTES, seed=SEED),
                          train_frac=90 / 95, seed=SEED)
    stream = sampler.stream("train", GRAD_ACCUM * BATCH_SIZE, seq)

    def batches():
        return torch.from_numpy(next(stream)).cuda().view(
            GRAD_ACCUM, BATCH_SIZE, seq + 1)

    flash_attention_forward.launches = 0
    bk.fused_bwd_kernel.launches = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        batch = batches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_step(model, opt, batch).item())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = (flash_attention_forward.launches, bk.fused_bwd_kernel.launches)
    rows = cuda_rows(lambda: train_step(model, opt, batches()), 1)
    busy_us = sum(t for _, t, _ in rows)
    parts = {n: sum(t for key, t, _ in rows if n in key)
             for n in ("fwd_mma_kernel<", "dkdv_mma_kernel<")}

    med = statistics.median(step_ms)
    tokens = GRAD_ACCUM * BATCH_SIZE * seq
    print(f"  losses: {', '.join(f'{x:.4f}' for x in losses)}")
    print(f"  train step on {card}: {med:.2f} ms median over {TRAIN_STEPS} "
          f"steps (first {step_ms[0]:.1f} ms), {tokens * 1e3 / med:.0f} "
          f"tokens/s")
    print(f"  train step device time on {card}: {busy_us / 1e3:.2f} ms "
          f"(profiled) of {med:.2f} ms wall (unprofiled median): device "
          f"idle share {1 - busy_us / 1e3 / med:.3f}; K1 "
          f"{parts['fwd_mma_kernel<'] / 1e3:.2f} ms and K2 "
          f"{parts['dkdv_mma_kernel<'] / 1e3:.2f} ms of it")
    print(f"  launches over the {TRAIN_STEPS} steps: forward kernel "
          f"{launches[0]}, one-pass backward kernel {launches[1]}")
    require_kernels(rows, ("fwd_mma_kernel<__nv_bfloat16, 64>",
                           "dkdv_mma_kernel<__nv_bfloat16, 64, true>"),
                    "training step (bf16 compute)")
    if not all(np.isfinite(losses)):
        fail(f"training: a loss is not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"training: the loss did not fall: {losses}")
    per_step = GRAD_ACCUM * MODEL["depth"]
    if launches != (per_step * TRAIN_STEPS,) * 2:
        fail(f"training: launches {launches}, want {per_step} per step")
    return launches


def bias_grad_path(card: str):
    """Phase 8b: the op's attn_bias gradient, the two-pass kernels' path;
    returns the launch counts of K3a and K3b over it."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_cosine_sim_attention)

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v = (torch.randn(4, 8, 1024, 64, device="cuda", generator=g
                           ).to(torch.bfloat16) for _ in range(3))
    target = torch.randn(4, 8, 1024, 64, device="cuda", generator=g)
    bias = torch.zeros(8, 1024, 1024, device="cuda", requires_grad=True)
    opt = torch.optim.Adam([bias], lr=0.05)
    losses = []

    def step():
        o = flash_cosine_sim_attention(q, k, v, attn_bias=bias, causal=True,
                                       scale=1.0, groups=8)
        loss = (o.float() - target).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())

    bk.dq_kernel.launches = bk.dkdv_kernel.launches = 0
    for _ in range(3):
        step()
    launches = (bk.dq_kernel.launches, bk.dkdv_kernel.launches)
    require_kernels(cuda_rows(step, 1),
                    ("dkdv_mma_kernel<__nv_bfloat16, 64, false>",),
                    "bias gradient step (bf16)")
    del losses[3:]
    print(f"  learnable (h,i,j) bias, b4 h8 s1024 d64 causal bf16 on {card}: "
          f"losses {', '.join(f'{x:.6f}' for x in losses)}; launches dQ+dB "
          f"kernel {launches[0]}, dK/dV kernel {launches[1]}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"bias gradient path: losses {losses}")
    if launches != (3, 3):
        fail(f"bias gradient path: launches {launches}, want (3, 3)")
    return launches


def train_parity():
    """Phase 9: one microbatch of an f32 depth-2 model, card vs CPU."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)

    cfg = dict(MODEL, depth=2)
    torch.manual_seed(SEED + 6)
    cpu = CosineSimCausalTransformer(**cfg, device="cpu")
    card = CosineSimCausalTransformer(**cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, MODEL["num_tokens"], (2, 257)))
    losses = [m(tokens.to(m.device), return_loss=True) for m in (cpu, card)]
    for loss in losses:
        loss.backward()
    loss_diff = abs(losses[0].item() - losses[1].item())
    worst, worst_name = 0.0, ""
    for (name, p), p2 in zip(cpu.named_parameters(), card.parameters()):
        g = p.grad
        err = (p2.grad.cpu() - g).abs().max().item() / g.abs().max().item()
        if err > worst:
            worst, worst_name = err, name
    print(f"  f32 depth 2, batch 2 x 256 tokens, card vs CPU: |loss diff| "
          f"{loss_diff:.3e} (bar {LOSS_BAR:g}); worst gradient "
          f"max|diff| / max|g| {worst:.3e} ({worst_name}; bar "
          f"{TRAIN_GRAD_BAR:g})")
    if not (loss_diff <= LOSS_BAR and worst <= TRAIN_GRAD_BAR):
        fail(f"training parity: loss {loss_diff}, gradient {worst}")


def _shuffled_table(b: int, mp: int, num_pages: int, seed: int):
    """(b, mp) int32 page ids drawn without repeats from 1..num_pages-1 in
    a shuffled order (page 0 is the null page)."""
    ids = np.random.default_rng(seed).permutation(np.arange(1, num_pages))
    return torch.from_numpy(ids[:b * mp].reshape(b, mp).astype(np.int32)
                            ).cuda()


def check_paged(card: str):
    """Phase 10: K5 and K4's e4m3 arm vs their plain versions, K5 vs K4 on
    the same bytes; returns ({kernel: max abs err}, {kernel: timing row})."""
    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.quant import (
        append, append_paged, decode_attention_plain, gather_pages,
        init_cache, init_paged_cache, paged_decode_attention,
        paged_decode_plain, quantized_decode_attention)

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    worst = {"K5": 0.0, "K4 e4m3": 0.0}
    ps, mp, kvh = 128, 8, 2
    b = len(PAGED_LENGTHS) + 1            # the last slot has finished
    lengths = torch.tensor(PAGED_LENGTHS + (700,), dtype=torch.int32,
                           device="cuda")
    for kv_dtype in (torch.int8, torch.float8_e4m3fn):
        kv = "int8" if kv_dtype == torch.int8 else "e4m3"
        for d in (64, 128):
            k = l2norm_tensors(torch.randn(b, kvh, mp * ps, d, device="cuda",
                                           generator=g), groups=8)
            v = 3 * torch.randn(b, kvh, mp * ps, d, device="cuda", generator=g)
            table = _shuffled_table(b, mp, b * mp + 3, SEED + d)
            paged = append_paged(init_paged_cache(
                b * mp + 3, kvh, ps, d, b, mp, kv_dtype=kv_dtype,
                device="cuda")._replace(page_table=table), k, v)
            cont = append(init_cache(b, kvh, mp * ps, d, "cuda",
                                     kv_dtype=kv_dtype), k, v)
            # the same quantized bytes, laid out both ways
            same = all(torch.equal(
                gather_pages(pool, table).transpose(-1, -2).view(torch.uint8),
                flat.view(torch.uint8)) for pool, flat in (
                    (paged.k8, cont.k8), (paged.v8, cont.v8)))
            dead = table.clone()
            dead[-1] = 0                  # finished: null page, stale length
            paged = paged._replace(page_table=dead, length=lengths)
            cont = cont._replace(length=lengths)
            for gq in (1, 4):
                q = l2norm_tensors(torch.randn(b, kvh * gq, d, device="cuda",
                                               generator=g), groups=8)
                qg = q.view(b, kvh, gq, d)
                for dtype in (torch.float32, torch.bfloat16):
                    bar = F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR
                    kw = dict(scale=8.0, l2norm_qk=False)
                    o5 = paged_decode_attention(q.to(dtype), paged, **kw)
                    o4 = quantized_decode_attention(q.to(dtype), cont, **kw)
                    p5 = paged_decode_plain(qg, paged, 8.0).view(o5.shape)
                    p4 = decode_attention_plain(qg, cont, 8.0).view(o4.shape)
                    torch.cuda.synchronize()
                    e5 = (o5.float() - p5.to(dtype).float()).abs().max().item()
                    e4 = (o4.float() - p4.to(dtype).float()).abs().max().item()
                    e54 = (o5[:-1].float() - o4[:-1].float()).abs().max().item()
                    print(f"  {kv} d{d} g{gq} {str(dtype)[6:]}: K5 vs plain "
                          f"{e5:.3e}, K4 vs plain {e4:.3e}, K5 vs K4 {e54:.3e} "
                          f"(bar {bar:g}); same bytes both ways: {same}")
                    ok = (same and max(e5, e4, e54) <= bar
                          and torch.isfinite(o5.float()).all().item()
                          and o5[0].abs().max().item() == 0)
                    if not ok:
                        fail(f"paged decode {kv} d{d} g{gq} {dtype}: K5 {e5}, "
                             f"K4 {e4}, K5 vs K4 {e54}, same bytes {same}")
                    worst["K5"] = max(worst["K5"], e5)
                    if kv == "e4m3":
                        worst["K4 e4m3"] = max(worst["K4 e4m3"], e4)

    # the shapes of phase 11's paths (b8 kvh8 g1 d64 at scale 1, every slot
    # 1024 tokens: 8 shuffled pages of 128, or the e4m3 contiguous cache),
    # held against the plain versions, then timed with L2 flushed between
    # launches as in phase 4
    b, kvh, d = 8, 8, 64
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    q32 = l2norm_tensors(torch.randn(b, kvh, d, device="cuda", generator=g),
                         groups=8)
    q = q32.to(torch.bfloat16)
    qg = q.float()[:, :, None]
    k = l2norm_tensors(torch.randn(b, kvh, mp * ps, d, device="cuda",
                                   generator=g), groups=8)
    v = torch.randn(b, kvh, mp * ps, d, device="cuda", generator=g)
    rows = {}
    tokens = b * kvh * mp * ps
    small = q.numel() * 2 + b * kvh * d * 4 + b * 4      # q, out, length
    for kv_dtype in (torch.int8, torch.float8_e4m3fn):
        kv = "int8" if kv_dtype == torch.int8 else "e4m3"
        table = _shuffled_table(b, mp, b * mp + 1, SEED + 9)
        paged = append_paged(init_paged_cache(
            b * mp + 1, kvh, ps, d, b, mp, kv_dtype=kv_dtype,
            device="cuda")._replace(page_table=table), k, v)
        checks = [("K5", f"K5 {kv} pool", paged, paged_decode_attention,
                   paged_decode_plain)]
        if kv == "e4m3":
            cont = append(init_cache(b, kvh, mp * ps, d, "cuda",
                                     kv_dtype=kv_dtype), k, v)
            checks.append(("K4 e4m3", "K4 e4m3 cache", cont,
                           quantized_decode_attention, decode_attention_plain))
        for name, label, cache, kernel, plain in checks:
            want = plain(q32[:, :, None], cache, 1.0).view(b, kvh, d)
            for dtype in (torch.float32, torch.bfloat16):
                bar = F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR
                got = kernel(q32.to(dtype), cache, scale=1.0, l2norm_qk=False)
                torch.cuda.synchronize()
                err = (got.float() - want.to(dtype).float()).abs().max().item()
                print(f"  {label} at phase 11's shape, {str(dtype)[6:]} "
                      f"queries: vs plain {err:.3e} (bar {bar:g})")
                if not err <= bar:
                    fail(f"{label} at b8 kvh8 d64, 8 x 1024 tokens, "
                         f"{dtype}: {err} against the plain version")
                worst[name] = max(worst[name], err)
        per_token = 2 * d + (4 if kv == "int8" else 0)
        bound_ms, by = bound(4 * d * tokens,
                             tokens * per_token + small + table.numel() * 4)
        call = lambda: paged_decode_attention(  # noqa: E731
            q, paged, scale=1.0, l2norm_qk=False)
        ms = device_ms(call, flush=scratch.zero_)
        call_ms = event_ms(call, flush=scratch.zero_)
        plain_ms = device_ms(lambda: paged_decode_plain(qg, paged, 1.0),
                             flush=scratch.zero_)
        print(f"  K5 {kv} pool, 8 x 1024 tokens in shuffled pages of 128 on "
              f"{card}: device time kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound_ms:.5f} ms ({by}); wrapper call "
              f"{call_ms:.4f} ms")
        if kv == "int8":
            rows["K5"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=by, library_ms=None)
        else:
            call = lambda: quantized_decode_attention(  # noqa: E731
                q, cont, scale=1.0, l2norm_qk=False)
            ms4 = device_ms(call, flush=scratch.zero_)
            plain4 = device_ms(lambda: decode_attention_plain(qg, cont, 1.0),
                               flush=scratch.zero_)
            bound4, by4 = bound(4 * d * tokens, tokens * 2 * d + small)
            print(f"  K4 e4m3 cache, 8 x 1024 tokens on {card}: device time "
                  f"kernel {ms4:.4f} ms, plain {plain4:.4f} ms, bound "
                  f"{bound4:.5f} ms ({by4})")
            rows["K4 e4m3"] = dict(ms=ms4, plain_ms=plain4, bound_ms=bound4,
                                   bound_by=by4, library_ms=None)
    print("  (no single PyTorch call computes either: library time null)")
    return worst, rows


def serve_paged(card: str, params, device: str = "cuda"):
    """Phase 11: the paged serving path; returns the launch counts of K1,
    K5 and K4's e4m3 arm on it."""
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        paged_decode_attention, quantized_decode_attention)
    from flash_cosine_sim_attention_tpu_torch.serving import (
        InferenceEngine, PagedInferenceEngine)

    model = build_model(params, torch.bfloat16, device)
    engine = PagedInferenceEngine(model, **PAGED_ENGINE, seed=SEED,
                                  device=device)
    rng = np.random.default_rng(SEED + 10)
    vocab, ps = MODEL["num_tokens"], PAGED_ENGINE["page_size"]
    cap = ps * PAGED_ENGINE["max_pages_per_slot"]
    usable = PAGED_ENGINE["num_pages"] - 1
    reserved = {}                          # slot -> pages its admission took
    seen = []

    def check_pages(when: str):
        live = np.flatnonzero(engine.active | engine.prefilling)
        want = sum(max(reserved[s], -(-int(engine.host_pos[s]) // ps))
                   for s in live)
        got = engine.pages_in_use()
        print(f"  pages in use {when}: {got} of {usable} (expected {want})")
        if got != want or got + len(engine.allocator.free) != usable:
            fail(f"paged accounting {when}: {got} pages in use, want {want}, "
                 f"{len(engine.allocator.free)} free")

    engine.finish(engine.add_request(rng.integers(0, vocab, 60)))  # warm-up
    flash_attention_forward.launches = 0
    paged_decode_attention.launches = 0

    ttft = {}
    for n in PROMPT_LENS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = engine.add_request(rng.integers(0, vocab, n))
        torch.cuda.synchronize()
        bucket = next(b for b in PAGED_ENGINE["prompt_buckets"] if n <= b)
        ttft.setdefault(bucket, []).append(
            (n, 1e3 * (time.perf_counter() - t0)))
        reserved[slot] = -(-min(n + PAGED_ENGINE["reserve_tokens"], cap) // ps)
        seen.append(int(engine.last_token[slot]))
    chunked = engine.add_request(rng.integers(0, vocab, CHUNKED_LEN),
                                 chunk_tokens=CHUNK_TOKENS)
    reserved[chunked] = 0
    check_pages("after admitting 7 prompts and queueing a chunked one")
    step_ms = []
    for _ in range(32):
        landing = bool(engine.prefilling.any())
        t0 = time.perf_counter()
        out = engine.step()
        if not landing:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        seen.extend(out.values())
    if not engine.active[chunked]:
        fail("paged: the chunked admission did not land within 32 steps")
    check_pages("after 32 steps")
    busy_us = kernel_us(lambda: seen.extend(engine.step().values()), 4)
    seen.append(engine.continue_request(0, rng.integers(0, vocab, 50)))
    check_pages("after a 50-token continue_request")
    victim = int(np.argmax([len(p) for p in engine.slot_pages]))
    freed = set(engine.slot_pages[victim])
    engine.finish(victim)
    n = 700
    slot = engine.add_request(rng.integers(0, vocab, n))
    reserved[slot] = -(-min(n + PAGED_ENGINE["reserve_tokens"], cap) // ps)
    reused = set(engine.slot_pages[slot])
    print(f"  finished slot {victim} ({len(freed)} pages); a {n}-token "
          f"prompt in slot {slot} took {len(reused)} pages, all of them "
          f"freed ones: {reused <= freed}")
    if not reused <= freed:
        fail(f"paged: the new request took pages {sorted(reused - freed)} "
             f"that the finished slot did not free")
    check_pages("after reusing the finished slot's pages")
    seen.extend(engine.step().values())
    for s in range(engine.num_slots):
        engine.finish(s)
    if engine.pages_in_use() or len(engine.allocator.free) != usable:
        fail(f"paged: {engine.pages_in_use()} pages still in use after "
             f"finishing every slot")
    print(f"  every slot finished: 0 pages in use, {usable} free")

    fp8 = PagedInferenceEngine(model, **PAGED_ENGINE, seed=SEED,
                               kv_dtype=torch.float8_e4m3fn, device=device)
    for n in PROMPT_LENS[:4]:
        fp8.add_request(rng.integers(0, vocab, n))
    for _ in range(8):
        seen.extend(fp8.step().values())
    launches = dict(k1=flash_attention_forward.launches,
                    k5=paged_decode_attention.launches)

    quantized_decode_attention.launches = 0
    cont = InferenceEngine(model, **ENGINE, seed=SEED,
                           kv_dtype=torch.float8_e4m3fn, device=device)
    for n in PROMPT_LENS[:4]:
        cont.add_request(rng.integers(0, vocab, n))
    for _ in range(8):
        seen.extend(cont.step().values())
    launches["k4_e4m3"] = quantized_decode_attention.launches

    if not all(0 <= t < vocab for t in seen):
        fail("paged serving: a token out of range")
    for bucket, runs in sorted(ttft.items()):
        print(f"  paged prefill bucket {bucket} on {card}: " + ", ".join(
            f"{n} tokens {ms:.2f} ms" for n, ms in runs))
    dec = statistics.median(step_ms)
    print(f"  paged decode on {card}: {dec:.3f} ms/step median over "
          f"{len(step_ms)} steps, {PAGED_ENGINE['num_slots'] * 1e3 / dec:.1f} "
          f"tokens/s at 8 slots; device time {busy_us / 4e3:.3f} ms/step "
          f"(profiled): device idle share {1 - busy_us / 4e3 / dec:.3f}")
    print(f"  launches on the paged serving path: forward kernel "
          f"{launches['k1']}, paged decode kernel {launches['k5']} (8 of "
          f"its steps on an e4m3 pool); decode kernel e4m3 arm "
          f"{launches['k4_e4m3']} (contiguous engine, e4m3 cache, 8 steps)")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the paged serving path never launched: {launches}")
    return launches


def paged_parity(params, devices=("cuda", "cpu")):
    """Phase 11, end: f32 model, the same teacher-forced tokens through the
    contiguous and the paged path on the card, and the paged path on the
    card vs the CPU."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        decode_step, decode_step_paged, init_decode_state,
        init_paged_decode_state, prefill, prefill_paged)

    tokens = np.random.default_rng(SEED + 11).integers(
        0, MODEL["num_tokens"], (2, 208))
    table = torch.tensor([[5, 2], [1, 6]], dtype=torch.int32)
    logits = {}
    for device in devices:
        model = build_model(params, torch.float32, device)
        toks = torch.from_numpy(tokens).to(device)
        state = init_decode_state(model, 2, 256, device=device)
        out, state = prefill(model, state, toks[:, :200])
        cont = [out]
        paged = init_paged_decode_state(model, 2, 8, 128, 2, device=device)
        paged.caches[0].page_table.copy_(table)
        rows = []
        for s in range(2):
            out, paged = prefill_paged(model, paged, s, toks[s:s + 1, :200])
            rows.append(out)
        steps = [torch.cat(rows)]
        active = torch.ones(2, dtype=torch.bool, device=device)
        for t in range(200, 208):
            out, state = decode_step(model, state, toks[:, t])
            cont.append(out)
            out, paged = decode_step_paged(model, paged, toks[:, t], active)
            steps.append(out)
        logits[device] = torch.stack(steps).float().cpu()
        if device == devices[0]:
            gap = (logits[device] - torch.stack(cont).float().cpu()
                   ).abs().max().item()
    diff = (logits[devices[0]] - logits[devices[1]]).abs().max().item()
    print(f"  f32 prefill(200) + 8 decode steps, paged vs contiguous on the "
          f"card: max |logit gap| {gap:.3e}; paged, card vs CPU: "
          f"{diff:.3e} (bar {PARITY_BAR:g} each)")
    if not (gap <= PARITY_BAR and diff <= PARITY_BAR):
        fail(f"paged parity: paged vs contiguous {gap}, card vs CPU {diff}")


def rel_err(x: torch.Tensor, y: torch.Tensor) -> float:
    """max|x - y| / max(1, max|y|): an output's error in units of its own
    size, as K7's bars are stated."""
    x, y = x.float(), y.float()
    return (x - y).abs().max().item() / max(1.0, y.abs().max().item())


def check_quant(card: str):
    """Phase 12: K7 and K1's int8 arm vs their plain versions, timed, and
    K1's float arm vs plain at phase 13's shapes; then the op's qk_int8 /
    qk_fp8 forward and straight-through backward; returns ({kernel: max
    abs err}, {kernel: timing row}, K1-int8 launches on the qk_int8 op
    path)."""
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_attention_backward_plain, flash_cosine_sim_attention,
        l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.flash_attention import (
        quantize_qk)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        quantize_dense_kernel, quantized_matmul, quantized_matmul_plain)

    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    worst = {"K7": 0.0, "K1 int8": 0.0, "K1": 0.0}
    weights = {}
    shapes = [shape for shape, _ in PROD_DENSE.values()] + [(200, 272)]
    for d_in, d_out in shapes:   # the last is ragged for K7's tiles
        w8, scale = quantize_dense_kernel(0.02 * torch.randn(
            d_in, d_out, device="cuda", generator=g))
        weights[d_in, d_out] = (w8, scale)
        errs = []
        for rows in (1, 8, 33, 1024):
            x32 = torch.randn(rows, d_in, device="cuda", generator=g)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                got = quantized_matmul(x, w8, scale)
                want = quantized_matmul_plain(x, w8, scale)
                torch.cuda.synchronize()
                err, bar = rel_err(got, want), (
                    F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR)
                errs.append(err)
                if not (err <= bar and got.dtype == dtype
                        and torch.isfinite(got.float()).all().item()):
                    fail(f"K7 rows {rows} ({d_in}, {d_out}) {dtype}: err "
                         f"{err} (bar {bar})")
                worst["K7"] = max(worst["K7"], (
                    got.float() - want.float()).abs().max().item())
        print(f"  K7 ({d_in}, {d_out}), rows 1/8/33/1024, f32 and bf16 x: "
              f"worst max|y-plain| / max(1, max|y|) {max(errs):.3e} (bars "
              f"{F32_ERR_BAR:g} f32, {BF16_ERR_BAR:g} bf16)")

    # timed at the serving model's shapes, bf16 x: 8 rows (a decode step,
    # L2 flushed: the step streams 0.8 GB of weights) and 1024 (a prefill)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    layer = dict(step)     # one layer's four products at 1024 rows
    for name, ((d_in, d_out), calls) in PROD_DENSE.items():
        w8, scale = weights[d_in, d_out]
        w_lib = (w8.float() * scale).to(torch.bfloat16).t().contiguous()
        for rows in (8, 1024):
            x = torch.randn(rows, d_in, device="cuda",
                            generator=g).to(torch.bfloat16)
            flush = scratch.zero_ if rows == 8 else None
            ms = device_ms(lambda: quantized_matmul(x, w8, scale), flush)
            plain_ms = device_ms(
                lambda: quantized_matmul_plain(x, w8, scale), flush)
            lib_ms = device_ms(lambda: F.linear(x, w_lib), flush)
            nbytes = w8.numel() + 4 * d_out + 2 * rows * (d_in + d_out)
            flops = 2 * rows * d_in * d_out
            bound_ms, by = bound(flops, nbytes)
            print(f"  K7 {name} ({d_in}, {d_out}) x {rows} rows bf16"
                  f"{', L2 flushed' if flush else ''} on {card}: device "
                  f"time kernel {ms:.4f} ms ({tflops(flops, ms):.1f} "
                  f"TFLOP/s, {nbytes / ms / 1e9:.0f} GB/s), plain "
                  f"{plain_ms:.4f} ms, F.linear on a bf16 copy {lib_ms:.4f} "
                  f"ms ({tflops(flops, lib_ms):.1f} TFLOP/s; kernel / "
                  f"F.linear {ms / lib_ms:.2f}), bound {bound_ms:.5f} ms "
                  f"({by})")
            times = (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms), ("library_ms", lib_ms))
            for key, val in times:
                if rows == 8:
                    step[key] += calls * val
                elif name != "logits":
                    layer[key] += val
    print(f"  K7 over one decode step (65 calls at 8 rows) on {card}: "
          f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, F.linear "
          f"{step['library_ms']:.4f} ms, bound {step['bound_ms']:.5f} ms "
          f"(bytes); F.linear reads a bf16 weight copy, 2x K7's bytes")
    layer_flops = 2 * 1024 * sum(
        d_in * d_out for name, ((d_in, d_out), _) in PROD_DENSE.items()
        if name != "logits")
    print(f"  K7 over one layer's four products at 1024 rows on {card}: "
          f"{layer['ms']:.4f} ms ({tflops(layer_flops, layer['ms']):.1f} "
          f"TFLOP/s), plain {layer['plain_ms']:.4f} ms, F.linear "
          f"{layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.5f} ms "
          f"(operations)")
    rows = {"K7": dict(step, bound_by="bytes"),
            "K7 prefill": dict(layer, bound_by="operations")}

    # K1's int8 arm: the JAX test's shape, then the serving model's heads
    def qkv(b, h, s, d, v_dtype):
        q, k = l2norm_tensors(
            *(torch.randn(b, h, s, d, device="cuda", generator=g)
              for _ in range(2)))
        v = torch.randn(b, h, s, d, device="cuda", generator=g).to(v_dtype)
        return q, k, v

    cases = [(2, 4, 192, 64, False, torch.float32),
             (2, 4, 192, 64, True, torch.float32),
             (2, 4, 192, 64, False, torch.bfloat16),
             (2, 4, 192, 64, True, torch.bfloat16),
             (1, 16, 1024, 128, True, torch.bfloat16)]
    for b, h, s, d, causal, v_dtype in cases:
        q, k, v = qkv(b, h, s, d, v_dtype)
        q8, k8, sdq = quantize_qk(q, k, "int8")
        kw = dict(bias_batch_dim=False, scale=1.0, causal=causal,
                  s_dequant=sdq)
        o, inv_l = flash_attention_forward(q8, k8, v, None, None, **kw)
        o_p, inv_p = flash_attention_forward_plain(q8, k8, v, None, None,
                                                   **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_p.float()).abs().max().item()
        l_err = ((inv_l - inv_p) / inv_p).abs().max().item()
        bar = F32_ERR_BAR if v_dtype == torch.float32 else BF16_ERR_BAR
        print(f"  K1 int8 b{b} h{h} s{s} d{d}{' causal' if causal else ''} "
              f"{str(v_dtype)[6:]} v: max|o-plain| {err:.3e} (bar {bar:g}), "
              f"max rel inv_l err {l_err:.3e}")
        if not (err <= bar and l_err <= 1e-5 and o.dtype == v_dtype):
            fail(f"K1 int8 b{b} h{h} s{s} d{d} {v_dtype}: err {err}, "
                 f"inv_l {l_err}")
        worst["K1 int8"] = max(worst["K1 int8"], err)

    # K1's float arm at the shapes phase 13 gives it: the 1024-token
    # prefills, then a continuation's 128-token chunk against itself
    # (causal) and against its slot's 2048-row history, 1060 rows live
    live = torch.arange(2048, device="cuda")[None, :] < 1060
    float_cases = [("b1 h16 s1024 d128 causal (prefill)", 1024, 1024, None,
                    True),
                   ("b1 h16 q128 x k128 d128 causal (continuation chunk)",
                    128, 128, None, True),
                   ("b1 h16 q128 x k2048 d128 key-masked (continuation "
                    "history)", 128, 2048, live, False)]
    for name, sq, sk, mask, causal in float_cases:
        qf, kf = l2norm_tensors(
            torch.randn(1, 16, sq, 128, device="cuda", generator=g),
            torch.randn(1, 16, sk, 128, device="cuda", generator=g))
        vf = torch.randn(1, 16, sk, 128, device="cuda", generator=g)
        qf, kf, vf = (t.to(torch.bfloat16) for t in (qf, kf, vf))
        kw = dict(bias_batch_dim=False, scale=1.0, causal=causal)
        o, inv_l = flash_attention_forward(qf, kf, vf, mask, None, **kw)
        o_p, inv_p = flash_attention_forward_plain(qf, kf, vf, mask, None,
                                                   **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_p.float()).abs().max().item()
        l_err = ((inv_l - inv_p) / inv_p).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all())
        print(f"  K1 bf16 {name}: max|o-plain| {err:.3e} (bar "
              f"{BF16_ERR_BAR:g}), max rel inv_l err {l_err:.3e}")
        if not (finite and err <= BF16_ERR_BAR and l_err <= 1e-5):
            fail(f"K1 bf16 {name}: err {err}, inv_l {l_err}, finite {finite}")
        worst["K1"] = max(worst["K1"], err)

    # timed at the serving model's prefill heads beside the float arm
    kw = dict(bias_batch_dim=False, scale=1.0, causal=True)
    ms = device_ms(lambda: flash_attention_forward(q8, k8, v, None, None,
                                                   s_dequant=sdq, **kw))
    plain_ms = device_ms(lambda: flash_attention_forward_plain(
        q8, k8, v, None, None, s_dequant=sdq, **kw))
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    float_ms = device_ms(lambda: flash_attention_forward(qb, kb, v, None,
                                                         None, **kw))
    float_plain_ms = device_ms(lambda: flash_attention_forward_plain(
        qb, kb, v, None, None, **kw))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, v, is_causal=True, scale=1.0))
    pairs = 1024 * 1025 / 2 * 16                     # visible pairs, heads
    flops = 4 * 128 * pairs
    # QK runs on int8 codes (int8 peak), P.V in bf16: in bf16-peak units
    ops = 2 * 128 * pairs * PEAK_BF16_FLOPS / PEAK_INT8_OPS + 2 * 128 * pairs
    nbytes = 2 * q8.numel() + 2 * 2 * v.numel() + 16 * 1024 * 4
    bound_ms, by = bound(ops, nbytes)
    f_bound_ms, f_by = bound(flops, 4 * 2 * v.numel() + 16 * 1024 * 4)
    print(f"  K1 int8 arm b1 h16 s1024 d128 causal, bf16 v, on {card}: "
          f"device time kernel {ms:.4f} ms ({tflops(flops, ms):.1f} TOP/s), "
          f"plain {plain_ms:.4f} ms, SDPA (bf16) {lib_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({by}); kernel / SDPA {ms / lib_ms:.2f}")
    print(f"  K1 bf16 b1 h16 s1024 d128 causal on {card}: device time kernel "
          f"{float_ms:.4f} ms ({tflops(flops, float_ms):.1f} TFLOP/s), plain "
          f"{float_plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ("
          f"{tflops(flops, lib_ms):.1f} TFLOP/s; kernel / SDPA "
          f"{float_ms / lib_ms:.2f}), bound {f_bound_ms:.5f} ms ({f_by})")
    rows["K1 int8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=by, library_ms=lib_ms)
    rows["K1 d128"] = dict(ms=float_ms, plain_ms=float_plain_ms,
                           bound_ms=f_bound_ms, bound_by=f_by,
                           library_ms=lib_ms)

    # the op's quantized-QK arms, forward and straight-through backward, at
    # the serving heads; K1-int8 launches counted around the qk_int8 op
    do = torch.randn(q.shape, device="cuda", generator=g).to(torch.bfloat16)
    launches = 0
    for flag in ("qk_int8", "qk_fp8"):
        leaves = [t.clone().requires_grad_() for t in (qb, kb, v)]
        flash_attention_forward.launches = 0
        o = flash_cosine_sim_attention(*leaves, causal=True, scale=1.0,
                                       l2norm_qk=False, **{flag: True})
        grads = torch.autograd.grad(o, leaves, do)
        if flag == "qk_int8":
            launches = flash_attention_forward.launches
        # the plain STE gradients on the same residuals: the forward
        # kernel's o and inv_l on the quantized q/k, the plain backward on
        # the unquantized ones
        qq, kq, sdq = quantize_qk(qb, kb, flag[3:])
        o_k, inv_k = flash_attention_forward(qq, kq, v, None, None,
                                             s_dequant=sdq, **kw)
        want = flash_attention_backward_plain(do, o_k, inv_k, qb, kb, v,
                                              None, None, **kw)[:3]
        torch.cuda.synchronize()
        errs = [grad_err(x, y, torch.bfloat16) for x, y in zip(grads, want)]
        finite = all(torch.isfinite(x.float()).all().item() for x in grads)
        print(f"  flash_cosine_sim_attention({flag}=True) b1 h16 s1024 d128 "
              f"causal bf16, forward + backward: finite {finite}; dq, dk, dv "
              f"vs the plain STE gradients, err / (|g| + rms g): "
              f"{', '.join(f'{e:.2e}' for e in errs)} (bar "
              f"{GRAD_BARS[torch.bfloat16]:g})")
        if not (finite and max(errs) <= GRAD_BARS[torch.bfloat16]
                and torch.equal(o.detach(), o_k)):
            fail(f"{flag} op path: grads {errs}, finite {finite}")
    print(f"  K1 launches on the qk_int8 op path: {launches}")
    if launches != 1:
        fail(f"qk_int8 op path: K1 launched {launches} times, want 1")
    return worst, rows, launches


def build_prod_model(dtype, device, depth=PROD_MODEL["depth"]):
    """The production decode model, random weights drawn on ``device`` from
    torch seed SEED (no host-side floats), unquantized."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)

    torch.manual_seed(SEED)
    return CosineSimCausalTransformer(
        **dict(PROD_MODEL, depth=depth), dtype=dtype, param_dtype=dtype,
        device=device).eval()


def serve_prod(card: str):
    """Phase 13: int8-weight serving at the 0.81B production width; returns
    the launch counts of K1, K4, K5 and K7 on it."""
    import copy

    from flash_cosine_sim_attention_tpu_torch.models import (
        decode_step, fuse_qkv_params, init_decode_state, prefill,
        quantize_params)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        paged_decode_attention, quantized_decode_attention, quantized_matmul)
    from flash_cosine_sim_attention_tpu_torch.serving import (
        InferenceEngine, PagedInferenceEngine)

    model = build_prod_model(torch.bfloat16, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    ref = copy.deepcopy(model)
    fuse_qkv_params(quantize_params(model))
    w_bytes = sum(m.weight_q.numel() for m in model.modules()
                  if hasattr(m, "weight_q"))
    print(f"  {n_params / 1e9:.3f}B parameters; int8 dense weights "
          f"{w_bytes / 1e6:.1f} MB after quantize_params + fuse_qkv_params")

    # int8 weights vs the same weights in bf16 (F.linear): one 1024-token
    # prefill and one decode step, relative L2 of the logits
    rng = np.random.default_rng(SEED + 13)
    vocab = PROD_MODEL["num_tokens"]
    tokens = torch.from_numpy(rng.integers(0, vocab, (1, PROD_PROMPT))).cuda()
    rel = []
    with torch.no_grad():
        outs = []
        for m in (ref, model):
            state = init_decode_state(m, 1, PROD_ENGINE["capacity"],
                                      device="cuda")
            first, state = prefill(m, state, tokens)
            tok = outs[0][0].argmax(-1) if outs else first.argmax(-1)
            second, _ = decode_step(m, state, tok)
            outs.append((first.float(), second.float()))
        for (a, b) in zip(*outs):
            rel.append(((b - a).norm() / a.norm()).item())
    print(f"  int8 vs bf16 weights, rel L2 of the logits: prefill "
          f"{rel[0]:.4f} (bar {QUANT_BARS[0]}), decode step {rel[1]:.4f} "
          f"(bar {QUANT_BARS[1]})")
    if not (rel[0] < QUANT_BARS[0] and rel[1] < QUANT_BARS[1]):
        fail(f"int8-weight logits: rel L2 {rel}")
    del ref, outs
    torch.cuda.empty_cache()

    engine = InferenceEngine(model, **PROD_ENGINE, seed=SEED, device="cuda")
    engine.finish(engine.add_request(rng.integers(0, vocab, 60)))  # warm-up
    counters = (flash_attention_forward, quantized_decode_attention,
                paged_decode_attention, quantized_matmul)
    for c in counters:
        c.launches = 0
    seen, ttft, step_ms = [], [], []
    for _ in range(PROD_ENGINE["num_slots"]):
        prompt = rng.integers(0, vocab, PROD_PROMPT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = engine.add_request(prompt)
        torch.cuda.synchronize()
        ttft.append(1e3 * (time.perf_counter() - t0))
        seen.append(int(engine.last_token[slot]))
    prefill_launches = dict(k1=flash_attention_forward.launches,
                            k7=quantized_matmul.launches)
    # the last slot's request again, profiled: its device time beside the
    # TTFT, and the tensor-core instances of K1 and K7 (prefill tiles)
    engine.finish(slot)
    rows = cuda_rows(lambda: seen.append(int(engine.last_token[
        engine.add_request(rng.integers(0, vocab, PROD_PROMPT))])), 1)
    prefill_us = sum(t for _, t, _ in rows)
    prefill_k7_us = sum(t for key, t, _ in rows if "qmm_" in key)
    prefill_k1_us = sum(t for key, t, _ in rows if "fwd_" in key)
    require_kernels(rows, ("fwd_mma_kernel<__nv_bfloat16, 128>",
                           "qmm_mma_kernel<128,"), "production prefill")
    for _ in range(PROD_STEPS):
        t0 = time.perf_counter()
        seen.extend(engine.step().values())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    profiled = 4
    rows = cuda_rows(lambda: seen.extend(engine.step().values()), profiled)
    busy_us = sum(t for _, t, _ in rows)
    k7_us = sum(t for key, t, _ in rows if "qmm_" in key)
    require_kernels(rows, ("qmm_mma_kernel<16,",), "production decode step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seen.append(engine.continue_request(0, rng.integers(0, vocab, 50)))
    continue_ms = 1e3 * (time.perf_counter() - t0)
    passes = PROD_ENGINE["num_slots"] + 1 + PROD_STEPS + profiled + 1
    launches = dict(k1=flash_attention_forward.launches,
                    k4=quantized_decode_attention.launches,
                    k7=quantized_matmul.launches)

    dec = statistics.median(step_ms)
    busy = busy_us / profiled / 1e3
    print(f"  TTFT, 8 prompts of {PROD_PROMPT} tokens on {card}: "
          + ", ".join(f"{ms:.2f}" for ms in ttft) + f" ms (median "
          f"{statistics.median(ttft):.2f}); launches over them K1 "
          f"{prefill_launches['k1']}, K7 {prefill_launches['k7']}")
    print(f"  one more {PROD_PROMPT}-token prefill, profiled: device time "
          f"{prefill_us / 1e3:.3f} ms (K7 {prefill_k7_us / 1e3:.3f}, K1 "
          f"{prefill_k1_us / 1e3:.3f}) of the median TTFT "
          f"{statistics.median(ttft):.2f} ms wall (unprofiled): device idle "
          f"share {1 - prefill_us / 1e3 / statistics.median(ttft):.3f}")
    print(f"  decode on {card}: {dec:.3f} ms/step median over {PROD_STEPS} "
          f"steps at 8 slots ({8e3 / dec:.1f} tokens/s); device time "
          f"{busy:.3f} ms/step (profiled): device idle share "
          f"{1 - busy / dec:.3f}; K7 {k7_us / profiled / 1e3:.3f} ms/step, "
          f"{k7_us / busy_us:.3f} of the device time; continue_request (50 "
          f"tokens) {continue_ms:.2f} ms")
    print("  the step's largest device times (ms/step, launches/step): "
          + "; ".join(f"{key[:48]} {t / profiled / 1e3:.3f} ({n // profiled})"
                      for key, t, n in sorted(rows, key=lambda r: -r[1])[:6]))
    print(f"  launches, contiguous engine: K1 {launches['k1']}, K4 "
          f"{launches['k4']}, K7 {launches['k7']} = {passes} passes (9 "
          f"prefills, {PROD_STEPS + profiled} steps, 1 continuation) x "
          f"{K7_PER_PASS}")
    depth = PROD_MODEL["depth"]
    want = dict(k1=depth * (PROD_ENGINE["num_slots"] + 1 + 2),
                k4=depth * (PROD_STEPS + profiled), k7=passes * K7_PER_PASS)
    want_prefill = dict(k1=depth * PROD_ENGINE["num_slots"],
                        k7=PROD_ENGINE["num_slots"] * K7_PER_PASS)
    if launches != want or prefill_launches != want_prefill:
        fail(f"production serving launches {launches}, prefills "
             f"{prefill_launches}, want {want}, {want_prefill}")
    del engine
    torch.cuda.empty_cache()

    for c in counters:
        c.launches = 0
    paged = PagedInferenceEngine(model, **PROD_PAGED, seed=SEED,
                                 device="cuda")
    for _ in range(PROD_PAGED["num_slots"]):
        seen.append(int(paged.last_token[paged.add_request(
            rng.integers(0, vocab, PROD_PROMPT))]))
    paged_ms = []
    for _ in range(8):
        t0 = time.perf_counter()
        seen.extend(paged.step().values())
        paged_ms.append(1e3 * (time.perf_counter() - t0))
    launches.update(k5=paged_decode_attention.launches,
                    k7_paged=quantized_matmul.launches)
    print(f"  paged engine (8 x {PROD_PROMPT}-token prompts on "
          f"{paged.pages_in_use()} of {PROD_PAGED['num_pages'] - 1} pages, "
          f"8 steps) on {card}: {statistics.median(paged_ms):.3f} ms/step "
          f"median; launches K5 {launches['k5']}, K7 {launches['k7_paged']}")
    if (launches["k5"] != depth * 8
            or launches["k7_paged"] != 16 * K7_PER_PASS):
        fail(f"paged production serving launches {launches}")
    if not all(0 <= t < vocab for t in seen):
        fail("production serving: a token out of range")
    launches.update(k1_prefill=prefill_launches["k1"],
                    k7_prefill=prefill_launches["k7"])
    return launches


def prod_parity():
    """Phase 13, end: the production widths at depth 2 in f32, quantized
    and fused; the same prefill and 8 decode steps on the card (kernels)
    and on the CPU (plain versions)."""
    import copy

    from flash_cosine_sim_attention_tpu_torch.models import (
        decode_step, fuse_qkv_params, init_decode_state, prefill,
        quantize_params)

    cpu = fuse_qkv_params(quantize_params(
        build_prod_model(torch.float32, "cpu", depth=2)))
    tokens = torch.from_numpy(np.random.default_rng(SEED + 14).integers(
        0, PROD_MODEL["num_tokens"], (2, 208)))
    logits = []
    for device in ("cuda", "cpu"):
        model = cpu if device == "cpu" else copy.deepcopy(cpu).to(device)
        toks = tokens.to(device)
        state = init_decode_state(model, 2, 256, device=device)
        out, state = prefill(model, state, toks[:, :200])
        steps = [out]
        for t in range(200, 208):
            out, state = decode_step(model, state, toks[:, t])
            steps.append(out)
        logits.append(torch.stack(steps).float().cpu())
    diff = (logits[0] - logits[1]).abs().max().item()
    print(f"  f32 depth 2 at the production widths, int8 weights, fused QKV: "
          f"prefill(200) + 8 decode steps, card vs CPU: max |logit diff| "
          f"{diff:.3e} (bar {PARITY_BAR:g})")
    if not diff <= PARITY_BAR:
        fail(f"production path parity: {diff}")


def widths_and_groups(card: str):
    """Phase 14: head widths between the kernel widths and query-head groups
    past 8.  The op's forward and backward at d 48 (the wrappers pad to 64)
    against plain; K4 and K5 at g 16, d 8 against plain; the heads-16,
    kv_heads=1 model served by both engines (K1, K4 and K5 launches read
    around it), then card vs CPU in f32 at depth 2.  Returns those counts."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain,
        flash_attention_forward_plain, flash_cosine_sim_attention,
        l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        append, append_paged, decode_attention_plain, init_cache,
        init_paged_cache, paged_decode_attention, paged_decode_plain,
        quantized_decode_attention)
    from flash_cosine_sim_attention_tpu_torch.serving import (
        InferenceEngine, PagedInferenceEngine)

    g = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    b, h, s, d = 2, 8, 512, 48
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    for dtype in (torch.float32, torch.bfloat16):
        q, k = (t.to(dtype) for t in l2norm_tensors(randn(b, h, s, d),
                                                     randn(b, h, s, d)))
        v, do = randn(b, h, s, d).to(dtype), randn(b, h, s, d).to(dtype)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n1, n2 = flash_attention_forward.launches, bk.fused_bwd_kernel.launches
        o = flash_cosine_sim_attention(*leaves, causal=True, l2norm_qk=False)
        got = torch.autograd.grad(o, leaves, do)
        moved = (flash_attention_forward.launches - n1,
                 bk.fused_bwd_kernel.launches - n2)
        o_p, _ = flash_attention_forward_plain(q, k, v, None, None, **kw)
        # the backward against the plain one on the kernel forward's o and
        # inv_l: K1's bf16 P moves delta' past the backward's own bar
        o_k, inv_k = flash_attention_forward(q, k, v, None, None, **kw)
        want = flash_attention_backward_plain(do, o_k, inv_k, q, k, v, None,
                                              None, **kw)
        torch.cuda.synchronize()
        bar = F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR
        err = (o.float() - o_p.float()).abs().max().item()
        errs = [grad_err(x, y, dtype) for x, y in zip(got, want)]
        finite = all(torch.isfinite(t.float()).all().item() for t in got)
        print(f"  op at d{d} (kernels at 64), b{b} h{h} s{s} causal "
              f"{str(dtype)[6:]}: max|o-plain| {err:.3e} (bar {bar:g}); dq, "
              f"dk, dv err {', '.join(f'{e:.2e}' for e in errs)} (bar "
              f"{GRAD_BARS[dtype]:g}); launches K1 +{moved[0]}, K2 "
              f"+{moved[1]}")
        if not (moved == (1, 1) and finite and err <= bar
                and max(errs) <= GRAD_BARS[dtype]):
            fail(f"op at d{d} {dtype}: o err {err}, grads {errs}, launches "
                 f"{moved}, finite {finite}")

    # K4 and K5: 16 query heads on one kv head at d 8 (two chunks of 8
    # heads, 8-byte rows read in place), ragged, empty and finished slots
    ps, mp, kvh, gq, d = 128, 8, 1, 16, 8
    bq = len(PAGED_LENGTHS) + 1           # the last slot has finished
    lengths = torch.tensor(PAGED_LENGTHS + (700,), dtype=torch.int32,
                           device="cuda")
    k = l2norm_tensors(randn(bq, kvh, mp * ps, d))
    v = 3 * randn(bq, kvh, mp * ps, d)
    q = l2norm_tensors(randn(bq, kvh * gq, d))
    qg = q.view(bq, kvh, gq, d)
    for kv_dtype in (torch.int8, torch.float8_e4m3fn):
        kv = "int8" if kv_dtype == torch.int8 else "e4m3"
        cont = append(init_cache(bq, kvh, mp * ps, d, "cuda",
                                 kv_dtype=kv_dtype), k, v)._replace(
                                     length=lengths)
        table = _shuffled_table(bq, mp, bq * mp + 3, SEED + 16)
        paged = append_paged(init_paged_cache(
            bq * mp + 3, kvh, ps, d, bq, mp, kv_dtype=kv_dtype,
            device="cuda")._replace(page_table=table), k, v)
        dead = table.clone()
        dead[-1] = 0                      # finished: null page, stale length
        paged = paged._replace(page_table=dead, length=lengths)
        n4, n5 = (quantized_decode_attention.launches,
                  paged_decode_attention.launches)
        o4 = quantized_decode_attention(q, cont, scale=8.0, l2norm_qk=False)
        o5 = paged_decode_attention(q, paged, scale=8.0, l2norm_qk=False)
        moved = (quantized_decode_attention.launches - n4,
                 paged_decode_attention.launches - n5)
        p4 = decode_attention_plain(qg, cont, 8.0).view(o4.shape)
        p5 = paged_decode_plain(qg, paged, 8.0).view(o5.shape)
        torch.cuda.synchronize()
        e4 = (o4 - p4).abs().max().item()
        e5 = (o5 - p5).abs().max().item()
        print(f"  {kv} g{gq} d{d}, lengths {lengths.tolist()}: K4 vs plain "
              f"{e4:.3e}, K5 vs plain {e5:.3e} (bar {F32_ERR_BAR:g}); "
              f"launches K4 +{moved[0]}, K5 +{moved[1]}")
        if not (moved == (1, 1) and max(e4, e5) <= F32_ERR_BAR
                and o4[0].abs().max().item() == 0
                and o5[0].abs().max().item() == 0):
            fail(f"decode g{gq} d{d} {kv}: K4 {e4}, K5 {e5}, launches "
                 f"{moved}, empty slot not 0")

    # the validation width with 16 query heads on one kv head: d 32, g 16
    wide = random_flax_params(
        CosineSimCausalTransformer(**WIDE_MODEL, device="meta"), SEED + 17)
    model = build_model(wide, torch.bfloat16, "cuda", WIDE_MODEL)
    rng = np.random.default_rng(SEED + 18)
    vocab = WIDE_MODEL["num_tokens"]
    flash_attention_forward.launches = 0
    quantized_decode_attention.launches = 0
    paged_decode_attention.launches = 0
    seen = []
    for engine in (InferenceEngine(model, **ENGINE, seed=SEED, device="cuda"),
                   PagedInferenceEngine(model, **PAGED_ENGINE, seed=SEED,
                                        device="cuda")):
        for n in WIDE_PROMPTS:
            slot = engine.add_request(rng.integers(0, vocab, n))
            seen.append(int(engine.last_token[slot]))
        for _ in range(8):
            seen.extend(engine.step().values())
    launches = dict(k1=flash_attention_forward.launches,
                    k4=quantized_decode_attention.launches,
                    k5=paged_decode_attention.launches)
    print(f"  heads {WIDE_MODEL['heads']} of {WIDE_MODEL['dim_head']} on "
          f"{WIDE_MODEL['kv_heads']} kv head, bf16: both engines took prompts "
          f"{WIDE_PROMPTS} and 8 steps each; launches forward kernel "
          f"{launches['k1']}, decode kernel {launches['k4']}, paged decode "
          f"kernel {launches['k5']}; {len(seen)} tokens")
    if min(launches.values()) <= 0 or not all(0 <= t < vocab for t in seen):
        fail(f"widths and groups serving: launches {launches}, tokens in "
             f"range {all(0 <= t < vocab for t in seen)}")
    cfg = dict(WIDE_MODEL, depth=2)
    path_parity(random_flax_params(
        CosineSimCausalTransformer(**cfg, device="meta"), SEED + 19), cfg=cfg)
    return launches


def main() -> None:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {smi}")

    from flash_cosine_sim_attention_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build_kernels()
    print(f"[2] build: {', '.join(_build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln]
        print(f"  {name}: {'; '.join(sorted(set(regs)))}")
        print(f"  {name} instances that spill: "
              f"{', '.join(spilling(log)) or 'none'}")

    print("[3] forward kernel vs plain")
    fwd_err, fwd_row = check_forward(smi)
    print("[4] decode kernel vs plain")
    dec_err, dec_row = check_decode(smi)
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    params = random_flax_params(
        CosineSimCausalTransformer(**MODEL, device="meta"), SEED)
    print("[5] serving path, full width")
    launches = serve(smi, params)
    print("[6] path parity")
    path_parity(params)
    print("[7] backward kernels vs plain")
    bwd_err, bwd_rows = check_backward(smi)
    print("[8] training path, full width")
    train_launches = train(smi)
    bias_launches = bias_grad_path(smi)
    print("[9] training parity")
    train_parity()
    print("[10] paged decode kernel vs plain")
    paged_err, paged_rows = check_paged(smi)
    print("[11] paged serving path, full width")
    paged_launches = serve_paged(smi, params)
    paged_parity(params)
    print("[12] int8-weight matmul and K1's int8 arm vs plain")
    quant_err, quant_rows, int8_launches = check_quant(smi)
    print("[13] int8-weight serving at the 0.81B production width")
    prod_launches = serve_prod(smi)
    prod_parity()
    print("[14] widths and groups")
    widths_and_groups(smi)

    bwd = "flash_cosine_sim_attention_tpu/ops/bwd_kernel.py"
    src = "flash_cosine_sim_attention_tpu_torch/csrc/bwd_kernel.cu"
    csrc = "flash_cosine_sim_attention_tpu_torch/csrc"
    kernels = [
        dict(name="fwd_kernel", route="cuda",
             source="flash_cosine_sim_attention_tpu_torch/csrc/fwd_kernel.cu",
             replaces="flash_cosine_sim_attention_tpu/ops/fwd_kernel.py:47",
             launches=launches[0], max_abs_err=fwd_err, **fwd_row),
        dict(name="decode_kernel", route="cuda",
             source="flash_cosine_sim_attention_tpu_torch/csrc/decode_kernel.cu",
             replaces="flash_cosine_sim_attention_tpu/quant/decode_kernel.py:137",
             launches=launches[1], max_abs_err=dec_err, **dec_row),
        dict(name="bwd_kernel:onepass", route="cuda", source=src,
             replaces=f"{bwd}:456", launches=train_launches[1],
             max_abs_err=bwd_err["K2"], **bwd_rows["K2"]),
        dict(name="bwd_kernel:dq", route="cuda", source=src,
             replaces=f"{bwd}:64", launches=bias_launches[0],
             max_abs_err=bwd_err["K3a"], **bwd_rows["K3a"]),
        dict(name="bwd_kernel:dkdv", route="cuda", source=src,
             replaces=f"{bwd}:282", launches=bias_launches[1],
             max_abs_err=bwd_err["K3b"], **bwd_rows["K3b"]),
        dict(name="decode_kernel:e4m3", route="cuda",
             source=f"{csrc}/decode_kernel.cu",
             replaces="flash_cosine_sim_attention_tpu/quant/decode_kernel.py:49",
             launches=paged_launches["k4_e4m3"],
             max_abs_err=paged_err["K4 e4m3"], **paged_rows["K4 e4m3"]),
        dict(name="paged_decode_kernel", route="cuda",
             source=f"{csrc}/paged_decode_kernel.cu",
             replaces="flash_cosine_sim_attention_tpu/quant/paged.py:183",
             launches=paged_launches["k5"], max_abs_err=paged_err["K5"],
             **paged_rows["K5"]),
        dict(name="quant_matmul", route="cuda",
             source=f"{csrc}/quant_matmul_kernel.cu",
             replaces="flash_cosine_sim_attention_tpu/quant/weights.py:66",
             launches=prod_launches["k7"], max_abs_err=quant_err["K7"],
             **quant_rows["K7"]),
        dict(name="fwd_kernel:int8", route="cuda",
             source=f"{csrc}/fwd_kernel.cu",
             replaces="flash_cosine_sim_attention_tpu/ops/fwd_kernel.py:47",
             launches=int8_launches, max_abs_err=quant_err["K1 int8"],
             **quant_rows["K1 int8"]),
        dict(name="quant_matmul:prefill", route="cuda",
             source=f"{csrc}/quant_matmul_kernel.cu",
             replaces="flash_cosine_sim_attention_tpu/quant/weights.py:66",
             launches=prod_launches["k7_prefill"],
             max_abs_err=quant_err["K7"], **quant_rows["K7 prefill"]),
        dict(name="fwd_kernel:d128", route="cuda",
             source=f"{csrc}/fwd_kernel.cu",
             replaces="flash_cosine_sim_attention_tpu/ops/fwd_kernel.py:47",
             launches=prod_launches["k1_prefill"],
             max_abs_err=quant_err["K1"], **quant_rows["K1 d128"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke.py took {time.perf_counter() - started:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
