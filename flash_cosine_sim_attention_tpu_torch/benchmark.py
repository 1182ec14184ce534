"""Benchmark CLI: the fused op against naive eager cosine-sim attention.

Counterpart of the repository's ``benchmark.py`` (the JAX CLI) with its
flags (--causal, --mask-prob, --only-forwards, --only-backwards,
--num-times, --seq-lens) and sweep: seq 128..8192 at batch 4, heads 8,
dim_head 64, f32 and bf16, the fused op against the naive baseline of
``utils/benchmark.py``, an out-of-memory baseline reported instead of
crashing.  The MFU column rates the fused op's algorithmic FLOPs (fwd
4*b*h*i*j*d, x2.5 for bwd, x3.5 for fwd+bwd, halved when causal;
recompute not counted) against the H100's dense bf16 peak, f32 rows too.
Runs on ``cuda`` unless ``--device cpu`` is given; a CPU run prints no
MFU.

Usage:  python -m flash_cosine_sim_attention_tpu_torch.benchmark [--causal]
            [--mask-prob 0.25] [--only-forwards | --only-backwards]
            [--num-times 20] [--seq-lens 1024 4096] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ._build import resolve_device
from .ops import flash_cosine_sim_attention
from .utils import benchmark, naive_cosine_sim_attention

BATCH = 4
HEADS = 8
DIM_HEAD = 64
PEAK_CARD = "H100 SXM dense bf16"
PEAK_FLOPS = 989e12   # NVIDIA's data sheet


def attention_flops(seq: int, mode: str, causal: bool) -> float:
    """Algorithmic FLOPs: fwd = QK^T + PV = 4*b*h*s^2*d; bwd = 2.5x fwd;
    causal halves the score area."""
    base = 4.0 * BATCH * HEADS * seq * seq * DIM_HEAD
    mult = {"fwd": 1.0, "bwd": 2.5, "fwd+bwd": 3.5}[mode]
    return base * mult * (0.5 if causal else 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--mask-prob", type=float, default=0.0)
    ap.add_argument("--only-forwards", action="store_true")
    ap.add_argument("--only-backwards", action="store_true")
    ap.add_argument("--num-times", type=int, default=20)
    ap.add_argument("--seq-lens", type=int, nargs="*",
                    default=[128, 256, 512, 1024, 2048, 4096, 8192])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    if args.only_forwards and args.only_backwards:
        ap.error("--only-forwards and --only-backwards exclude each other")

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    forwards = not args.only_backwards
    backwards = not args.only_forwards
    mode = ("fwd" if not backwards else
            "bwd" if not forwards else "fwd+bwd")

    rng = np.random.default_rng(0)
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {name}   mode: {mode}   causal: {args.causal}   "
          f"mask: {args.mask_prob}")
    print(f"{'dtype':>9} {'seq':>6} {'fused ms':>10} "
          f"{'MFU (' + PEAK_CARD + ')':>26} {'naive ms':>10} "
          f"{'fused/naive':>12}")

    for dtype in (torch.float32, torch.bfloat16):
        for seq in args.seq_lens:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (BATCH, HEADS, seq, DIM_HEAD), np.float32)).to(device, dtype)
                for _ in range(3))
            mask = (torch.from_numpy(rng.random((BATCH, seq))
                                     > args.mask_prob).to(device)
                    if args.mask_prob > 0 else None)

            def fused(q, k, v):
                return flash_cosine_sim_attention(
                    q, k, v, mask=mask, causal=args.causal)

            def naive(q, k, v):
                return naive_cosine_sim_attention(
                    q, k, v, mask=mask, causal=args.causal)

            kw = dict(forwards=forwards, backwards=backwards,
                      num_times=args.num_times)
            t_fused = benchmark(fused, q, k, v, **kw)
            mfu = (f"{attention_flops(seq, mode, args.causal) / (t_fused * 1e-3) / PEAK_FLOPS:26.1%}"
                   if on_card else f"{'-':>26}")
            try:
                t_naive = benchmark(naive, q, k, v, **kw)
                naive_s = f"{t_naive:10.3f}"
                ratio = f"{t_fused / t_naive:11.2f}x"
            except torch.OutOfMemoryError:
                naive_s, ratio = f"{'oom':>10}", f"{'-':>12}"
                torch.cuda.empty_cache()
            print(f"{str(dtype)[6:]:>9} {seq:>6} {t_fused:10.3f} {mfu} "
                  f"{naive_s} {ratio}", flush=True)


if __name__ == "__main__":
    main()
