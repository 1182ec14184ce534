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
     steps only.  Then the op's attn_bias gradient, the two-pass
     kernels' path: a learnable (h, i, j) bias takes 3 Adam steps
     through flash_cosine_sim_attention, counts read around them;
  9. training parity: one microbatch of an f32 depth-2 model, loss and
     every parameter's gradient, card (kernels) vs CPU (plain versions).
Then one JSON line lists every ported kernel with its launches on its
path, error, times and bound; the card's name and power limit; and,
the script's own wall time, the nvcc build included; and, last, the
{"ok": true, ...} line.  Kernel device times come from
torch.profiler, wrapper times are CUDA-event medians.
"""

from __future__ import annotations

import json
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
    return kernel_device_us(work, iters, ())[0]


def kernel_device_us(work, iters: int, names):
    """Device time (us) of ``iters`` calls of ``work``: the total and the
    part spent in kernels whose name contains each of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            work()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows)
    return total, {n: sum(e.self_device_time_total for e in rows
                          if n in e.key) for n in names}


def device_ms(fn, flush=None, iters: int = 20) -> float:
    """Device time per call of ``fn``'s kernels, the flush's excluded; the
    CUDA-event time where the profiler saw no device time."""
    for _ in range(3):
        fn()
    total = kernel_us(fn if flush is None else lambda: (flush(), fn()), iters)
    if flush is not None:
        total -= kernel_us(flush, iters)
    if total > 0:
        return total / iters / 1e3
    print("  (the profiler saw no device time: CUDA-event time instead)")
    return event_ms(fn, flush=flush)


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


def build_model(params, dtype, device):
    """The served model: parameters held in its compute dtype."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer, params_from_flax)
    model = CosineSimCausalTransformer(**MODEL, dtype=dtype, param_dtype=dtype,
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
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({by}); wrapper call {call_ms:.4f} ms")
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


def path_parity(params, devices=("cuda", "cpu")):
    """Phase 6: f32 model, kernels on the card vs plain versions on the
    CPU; returns the max logit difference."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        decode_step, init_decode_state, prefill)

    tokens = np.random.default_rng(SEED + 3).integers(
        0, MODEL["num_tokens"], (2, 208))
    logits = {}
    for device in devices:
        model = build_model(params, torch.float32, device)
        toks = torch.from_numpy(tokens).to(device)
        state = init_decode_state(model, 2, 256, device=device)
        out, state = prefill(model, state, toks[:, :200])
        steps = [out]
        for t in range(200, 208):
            out, state = decode_step(model, state, toks[:, t])
            steps.append(out)
        logits[device] = torch.stack(steps).float().cpu()
    diff = (logits[devices[0]] - logits[devices[1]]).abs().max().item()
    print(f"  f32 prefill(200) + 8 decode steps, card vs CPU: max |logit "
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
              f"device time kernel {ms:.4f} ms, plain {p_ms:.4f} ms, SDPA "
              f"backward {l_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})"
              + ("" if call_ms is None else
                 f"; wrapper call {call_ms:.4f} ms"
                 f"{'' if name == 'K2' else ' (K3a + K3b)'}"))
    print("  (plain: the whole plain backward; SDPA: dQ, dK, dV of "
          "scaled_dot_product_attention, with the bias as a float mask and "
          "no dB for K3)")
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
    busy_us, parts = kernel_device_us(
        lambda: train_step(model, opt, batches()), 1,
        ("fwd_kernel<", "dkdv_kernel<"))

    med = statistics.median(step_ms)
    tokens = GRAD_ACCUM * BATCH_SIZE * seq
    print(f"  losses: {', '.join(f'{x:.4f}' for x in losses)}")
    print(f"  train step on {card}: {med:.2f} ms median over {TRAIN_STEPS} "
          f"steps (first {step_ms[0]:.1f} ms), {tokens * 1e3 / med:.0f} "
          f"tokens/s")
    print(f"  train step device time on {card}: {busy_us / 1e3:.2f} ms "
          f"(profiled) of {med:.2f} ms wall (unprofiled median): device "
          f"idle share {1 - busy_us / 1e3 / med:.3f}; K1 "
          f"{parts['fwd_kernel<'] / 1e3:.2f} ms and K2 "
          f"{parts['dkdv_kernel<'] / 1e3:.2f} ms of it")
    print(f"  launches over the {TRAIN_STEPS} steps: forward kernel "
          f"{launches[0]}, one-pass backward kernel {launches[1]}")
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
    bk.dq_kernel.launches = bk.dkdv_kernel.launches = 0
    losses = []
    for _ in range(3):
        o = flash_cosine_sim_attention(q, k, v, attn_bias=bias, causal=True,
                                       scale=1.0, groups=8)
        loss = (o.float() - target).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    launches = (bk.dq_kernel.launches, bk.dkdv_kernel.launches)
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

    bwd = "flash_cosine_sim_attention_tpu/ops/bwd_kernel.py"
    src = "flash_cosine_sim_attention_tpu_torch/csrc/bwd_kernel.cu"
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke.py took {time.perf_counter() - started:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
