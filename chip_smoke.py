"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --ring-nccl   # phase 19's rings alone over
                                        # NCCL, a card a rank (4 cards)
    python3 chip_smoke.py --multihost-nccl  # the trainer as 2 torchrun
                                        # nodes of 2 cards (4 cards)
    python3 chip_smoke.py --f32-step    # the float32 training step
                                        # alone, profiled (1 card)
    python3 chip_smoke.py --f32-long-step  # the float32 training step
                                        # at seq 16384 alone (1 card)
    python3 chip_smoke.py --f32-head256-step  # the heads-256 model's
                                        # float32 training step alone
    python3 chip_smoke.py --f32-head256-long-step  # the heads-256
                                        # model's float32 step at seq
                                        # 16384 alone (1 card)
    python3 chip_smoke.py --f32-head512-step  # the heads-512 model's
                                        # float32 training step alone
    python3 chip_smoke.py --f32-head512-long-step  # the heads-512
                                        # model's float32 step at seq
                                        # 16384 alone (1 card)
    python3 chip_smoke.py --f32-head512-kernels  # the float32 K1, K2,
                                        # K3a and K3b at d 512 alone
    python3 chip_smoke.py --f32-wide-heads  # the float32 K1, K2, K3a
                                        # and K3b at d 192 and 256 alone
    python3 chip_smoke.py --f32-quant-kernels  # K1's int8 arm with
                                        # float32 v and K7 on float32 x
                                        # alone (1 card)
    python3 chip_smoke.py --f32-prod-serve  # phase 23 alone (1 card)

Phases (any failure exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel under
     flash_cosine_sim_attention_tpu_torch/csrc with nvcc, in parallel;
  3. the forward kernel against its plain PyTorch version on the card;
  4. the INT8 decode kernel (split-K: every timed K4 and K5 call below is
     one launch, timed whole) against its plain version on the card;
  5. the serving path at full width: the validation model of train.py
     (dim 512, depth 8, 8 heads of 64, bf16, random weights from a numpy
     seed loaded through params_from_flax) served by InferenceEngine with
     8 slots of capacity 1024; the kernels' launch counts are read around
     this phase only;
  6. path parity: the same teacher-forced prefill + decode steps with an
     f32 model on the card (kernels) and on the CPU (plain versions);
  7. the backward kernels (K2 one-pass; K3a dQ + dB and K3b dK, dV, the
     two-pass route) against the plain backward on the card, then checked
     and timed at the shapes phase 8 gives them; a profiled two-pass call
     at phase 8b's shape must show K3a's and K3b's tensor-core instances;
  8. the training path at full width: the same model with float32
     parameters and bf16 compute takes 10 optimizer steps of 4
     microbatches of 4 x 1024 tokens through the port's train_step, on a
     synthetic byte corpus drawn from a numpy seed; the forward and
     one-pass backward kernels' launch counts are read around these
     steps only, and a profiled step must show the tensor-core
     instances of K1 and K2 and no bf16 FMA dK/dV kernel.  Then the op's
     attn_bias gradient, the two-pass kernels' path: a learnable
     (h, i, j) bias takes 3 Adam steps through flash_cosine_sim_attention,
     counts read around them, and a profiled fourth step must show K3a's
     and K3b's tensor-core instances;
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
     (a profiled decode step must show K7's and K4, whose share of the
     step's device time it prints); K4 against plain and timed at the
     shape a production decode step gives it (b8 kvh16 d128, 1060 of 2048
     tokens a slot); card vs CPU at depth 2 in f32;
 14. widths and groups: the op's forward and backward at d 48 (zero-padded
     to the kernels' 64), f32 and bf16, against plain with K1's and K2's
     launches read around them; K4 and K5 at 16 query heads on one kv
     head and d 8 (int8 and e4m3, ragged, empty and finished slots)
     against plain; the validation width with 16 heads of 32 on one kv
     head served by both engines (3 prompts and 8 steps each; K1, K4 and
     K5 launches read around it), then card vs CPU at depth 2 in f32;
 15. head dims up to 256: the op's forward and both backward routes
     (with an (h, i, j) bias on the two-pass one) at d 200 (padded to 256)
     and 256, f32 and bf16, and K4 and K5 at d 200 and 256 (int8 and
     e4m3), against plain; K1, K2, K3a, K3b, K4 and K5 checked against
     plain and timed at d 256 at the shapes the heads-256 model gives
     them; that model (the validation width with 2 heads of 256) served by
     both engines, trained 3 steps and its bias gradient taken 3 times
     (every kernel's launches read around these), then card vs CPU at
     depth 2 in f32;
 16. head dims past 256 (the wide route): d 260 refused by every wrapper;
     phase 15's checks at d 264 (padded to 384) and 512, the op's at
     1032 (padded to 1152), timed at d 512, the profiles showing the wide
     tensor-core instances; K4 and K5 past 1024 (column blocks) at 1032
     and 2048 against plain (int8 and e4m3, g 1 and 4, an empty slot and
     one across a split boundary), timed at d 1032; the validation width
     with 1 head of 512 (seed 29) served, trained (a step timed, wall and
     device), its bias gradient taken, and card vs CPU at depth 2; with 1
     head of 1032 at depth 2 (seed 33) served by both engines;
 17. speculative decoding: K1 against its plain version at the verify's
     shapes (4 queries against 1024 keys masked by each slot's length,
     an empty slot included, and the 4 x 4 causal chunk), timed; the
     validation model served by SpeculativeEngine (8 slots, capacity
     1024, gamma 4, greedy) with a depth-2 draft (seed 41) and with itself
     as draft, 7 prompts admitted one and then six, 48 tokens a stream,
     every stream held to the target's greedy decode under the margin
     rule (MARGIN_BAR), K1 and K4 launches read around each engine's
     traffic and checked per round; tokens a round, round wall and device
     time and idle share printed; one b = 1 speculative_generate and one
     generate_cached of 32 tokens; card vs CPU at depth 2 in f32;
 18. tensor parallelism: a world of 2 ranks on the one card (gloo, CUDA
     tensors; two ranks share the card's SMs, so this shows correctness
     and launches, not a speed-up) on a (1, 2) mesh: (a) phase 13's
     production model (int8 weights, fused QKV) served by InferenceEngine
     at TP 2 (8 slots, capacity 2048, 8 prompts of 1024 tokens, 16 steps,
     near-greedy), its tokens equal on both ranks and held to rank 0's TP
     1 engine by the margin rule, its logits by phase 13's bars, K1, K4
     and K7 launches read on each rank; (b) the validation model (float32
     parameters) trained through make_sharded_train_step against the
     trainer's train_step from the same weights: one float32-compute step
     (loss and every gradient at the float32 bars) and 3 bf16-compute
     steps (losses at 2^-7; the first step's gradients no farther from TP
     1 than twice bf16's own distance from float32), K1 and K2 launches
     read; (c) head_sharded_flash_attention and
     head_sharded_decode_attention timed at phase 13's shapes; then a
     world of 1 over NCCL serving (a) at depth 2;
 19. ring attention: ranks on the one card over gloo (each ppermute hop
     staged through pinned host memory) run
     ring_flash_cosine_sim_attention at the 0.81B model's attention
     width (16 heads of 128): (a) bf16 causal at seq 16384 on a world of
     2 (local 8192: K1 and K2), (b) at 32768 (local 16384: K1, K3a and
     K3b), (d) f32 at b1 h4 s1024 d64; then a world of 4 on a (model 2,
     seq 2) mesh with 4 kv heads at seq 8192, (c) key-masked causal and
     non-causal; each ring's output and q/k/v gradients held on rank 0
     against the unsharded fused op (RING_BARS and RING_REL_L2), its
     output against K1's plain version on the unsharded inputs, each
     rank's K1, K2, K3a, K3b launches and hops against the schedule's;
     in this process, each case's pair calls (K1, then K2 or K3a/K3b) at
     the ring's local shapes against their plain versions; (a) timed through
     ring_flash_cosine_sim_attention_local (forward wall, forward and
     backward wall, the transport's share, each rank's device time),
     beside the unsharded forward's plain version and SDPA;
 20. pipeline parallelism: the validation model (float32 parameters) in
     2 stages of 4 layers on a world of 2, 4 microbatches of 4 x 1024,
     through make_pipeline_train_step against the trainer's train_step
     from the same weights (one float32 step at the f32 bars, 3 bf16
     steps under phase 18's rule), each rank's K1 and K2 launches (16 a
     step), a bf16 step's wall and device time; then a world of 4 on a
     (data 2, pipe 2) mesh, one float32 step;
 21. multi-host training: 2 nodes of 2 ranks on the one card over gloo,
     joined through initialize_distributed at a localhost TCP store (each
     rank's LOCAL_RANK and LOCAL_WORLD_SIZE set, its node from its rank),
     on the (data 2, model 2) mesh of make_multihost_mesh(2); each node
     feeds only its own rows (4 microbatches of 2 x 1024 from a numpy
     seed a node) through process_local_rows and local_batch_to_global;
     the validation model through make_sharded_train_step against rank
     0's train_step over the node-major concatenation from the same
     weights (one float32 step at the f32 bars, 3 bf16 steps under phase
     18's rule), each rank's K1 and K2 launches (32 a step), a bf16
     step's wall, device time and idle share a rank (no speed: four ranks
     share the card); make_multihost_mesh(4) refused with 2 ranks a node.
     --multihost-nccl instead runs the trainer itself as 2 torchrun nodes
     of 2 cards over NCCL (31 steps, --model-parallel 2) and holds its
     losses to train_step's on one card over the same rows at 4e-4;
 22. in a fresh process, the float32 instances at the main path's
     shapes: K1 (b1 h8 s1024 d64 causal), the one-pass K2 (phase 8's
     shape) and K3a/K3b (phase 8's shape with an (h, i, j) bias, and b1
     h16 s1024 d128 with one) on the tensor cores as 3xTF32 split
     products, each row held to its instances by profiler name, checked
     against its plain version and timed beside it, its bound (3 x the
     operations at the TF32 tensor cores' peak) and SDPA in float32 with
     TF32 off; K1, K2, K3a
     and K3b also against the plain versions with the same split
     (TF32X3_BARS, dB included; on a short chain SPLIT_BARS, above which
     the bfloat16 split's plain versions must read), over long chains
     (s8192, and K1, K3a and K3b at the seq-16384 step's own b1 h8 s16384
     d64; values of mean 3: O's and dQ's keys, dK's and dV's queries)
     and at 8 l2norm groups and scale 8 (logits to 64); K1, the one-pass
     K2 and (with an (h, i, j) bias) K3a and K3b at d 192 and 256 (b4 h2
     s1024 causal, the heads-256 model's shape) on their 3xTF32 instances
     by profiler name, against the exact and the dot_tf32x3 plain
     versions (dB included), NaNs in q and v kept on both backward
     routes, at d 256 on a short chain (groups 8, scale 8) and over b1 h2
     s16384 (both routes), timed beside their bounds, plain versions and
     SDPA f32 (--f32-wide-heads alone); K1, the one-pass K2 and (with an
     (h, i, j) bias) K3a and K3b at d 512 (b4 h1 s1024 causal, the
     heads-512 model's shape) on the wide route's 3xTF32 instances by
     profiler name, against the exact and the dot_tf32x3 plain versions,
     on a short chain (groups 8, scale 8, SPLIT_BARS_D512, both routes),
     over b1 h2 s8192 (one-pass) and b1 h1 s16384 (two-pass) and with
     NaNs in q and v kept (--f32-head512-kernels alone); K1 and K2 at d
     128, checked and timed alike; K1's int8 arm with float32 v (b4 h8
     d64, b1 h16 d128, b4 h1 d512, s1024 causal) on the int8 instances of
     the 3xTF32 kernels and K7 on float32 x (a decode step's 65 calls at
     8 rows, a layer's four products at 1024 rows) on its 2xTF32
     instances, held to their exact and split plain versions and timed
     beside SDPA and F.linear in float32 (bounds: Q.K at the int8 peak
     and 3 x P.V at the TF32 one; 2 x K7's operations at the TF32 peak,
     or its bytes), the qk_int8 op's forward and straight-through
     backward against the op on the plain versions, ff_out with inputs
     offset from zero (--f32-quant-kernels alone); then the validation
     model's float32 training step profiled (device time a step, K1's and
     K2's share and launches), the heads-256 and heads-512 models'
     (--f32-head256-step and --f32-head512-step alone: K1 and K2 32
     launches a step each on their 3xTF32 instances, K3a and K3b none,
     the idle share), and the validation, heads-256 and heads-512
     models' at seq 16384 (batch 1; --f32-long-step,
     --f32-head256-long-step and --f32-head512-long-step alone), where
     the backward takes K3a and K3b: device time a step, K1's, K3a's and
     K3b's share, launches and TFLOP/s, the idle share;
 23. in a fresh process, the 0.81B production model (phase 13's, uncut)
     in float32 with int8 weights and fused QKV served by
     InferenceEngine (8 slots, capacity 2048, near-greedy): a warm-up,
     then a 1024-token prompt in every slot (TTFT each), one more
     prefill profiled, 32 decode steps and 4 profiled: TTFT and the
     decode step's wall, device time, idle share, K7's, K1's and K4's
     shares and launches; the wrappers' launches against the passes and
     K7's (prefill and decode tiles) and K1's instances by profiler
     name; every slot's 33 tokens held by the margin rule to the same
     model's greedy decode on the plain versions on the card
     (--f32-prod-serve alone).
Then one JSON line lists every ported kernel, and the entries of phases
18-23 (each rank's launches and error), with its launches on its path, error,
times and bound (timing lines also print the achieved
TFLOP/s); the script's own wall time, the nvcc build included; the
card's name and power limit; and, last, the {"ok": true, ...} line.
Kernel device times come from torch.profiler, wrapper times are
CUDA-event medians; SDPA's forward is the median of five profiler
windows.
"""

from __future__ import annotations

import contextlib
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
PEAK_F32_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # H100 SXM dense TF32 tensor cores
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
# float32 K1, K2, K3a and K3b (3xTF32) against their plain versions with
# the same split (ops/mxu.py dot_tf32x3), in F32_ERR_BAR's units, at the
# main path's shapes (b1 h8 and b4 h8 s1024 d64 causal, 8 l2norm groups,
# scale 1; K3a and K3b with an (h, i, j) bias, also at b1 h16 s1024
# d128), at about 2.5x the first readings on the H100 (K1's o 2.2e-6; K2's
# dK and dV 1.4e-5 to 1.9e-5, before their sums were closed every 256
# queries; K3a's dq and db 1.8e-6 to 3.3e-6, K3b's dk and dv 3.6e-6 to
# 5.5e-6): what is left is the tensor cores' float32 sums, each rounded
# toward zero, and the sums' order (dB's atomics' varies from run to run)
TF32X3_BARS = {"K1": 5e-6, "K2": 5e-5, "K3a": 1e-5, "K3b": 1.5e-5,
               # K1's int8 arm with float32 v (the codes exact, P and V
               # split; o 6e-7 to 4.8e-6 on the H100 at b1 h16 s1024 and
               # smaller shapes, d 16 to 1032, scale 8) and K7 on float32 x
               # in max(1, max|y|)'s units (x's hi and lo times the codes;
               # 1.1e-6 to 3.3e-6 there, inputs offset from zero included)
               "K1 int8": 1e-5, "K7": 1e-5}
# K1's int8 arm with float32 v at the shapes phase 22 runs the qk_int8 op
# at: bench_int8qk.py's b4 h8 d64, the 0.81B model's b1 h16 d128 and the
# wide route's b4 h1 d512, all at seq 1024 causal
INT8_F32_SHAPES = {"K1 int8 f32 v d64": (4, 8, 64),
                   "K1 int8 f32 v": (1, 16, 128),
                   "K1 int8 f32 v d512": (4, 1, 512)}
# the same on a short chain (split_check: b4 h8 s128 d64 causal, 8 groups,
# scale 8; K3a and K3b with an (h, i, j) bias), K1 on o, above the
# readings on the H100 (K1 1.1e-5; K2 1.1e-5 to 1.8e-5; K3a 9.9e-6 to
# 1.2e-5, K3b 8.7e-6 to 9.6e-6) and below those of the plain versions
# with JAX's bfloat16 split (dot_f32x3): 1.8e-4 (K1), 4.3e-5 to 6.7e-5
# (K2), 5.5e-5 to 8.0e-5 (K3a), 5.0e-5 to 5.3e-5 (K3b).  Over 1024
# queries the tensor cores' rounding of each sum toward zero buries the
# split's error; over 128 it does not, and the two splits read apart
SPLIT_BARS = {"K1": 4e-5, "K2": 3e-5, "K3a": 3e-5, "K3b": 3e-5}
# at d 256 the bfloat16 split's plain versions read only 2.5e-5 to 3.6e-5
# on K2 and 3.3e-5 to 3.5e-5 on K3a (H100 runs, draw to draw): too close
# to SPLIT_BARS to tell the splits apart, so d 256 holds both kernels to
# tighter bars, between those readings and the kernels' (K2 5.3e-6 to
# 7.7e-6, K3a 6.9e-6 to 9.8e-6)
SPLIT_BARS_D256 = dict(SPLIT_BARS, K2=1.5e-5, K3a=2e-5)
# at d 512 (all four on the wide route) d 256's bars part K1's and K2's
# two splits too (H100 runs: K1 1.0e-5 to 1.3e-5 against the bfloat16
# split's 6.1e-5 to 6.2e-5; K2 3.4e-6 to 8.7e-6 against 1.6e-5 to
# 2.7e-5), but the bfloat16 split's K3a and K3b read only 1.3e-5 to
# 2.8e-5 there (maxima 2.0e-5 to 2.8e-5 a draw), under d 256's 2e-5 and
# 3e-5, so d 512 holds both to a tighter bar, between those and the
# kernels' 3.4e-6 to 7.1e-6
SPLIT_BARS_D512 = dict(SPLIT_BARS_D256, K3a=1.2e-5, K3b=1.2e-5)
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
# phase 15: the validation width with 2 heads of 256, the widest kernel
# width (the widest head of the public model families)
HEAD256_MODEL = dict(MODEL, heads=2, dim_head=256)
# phase 16: the validation width with 1 head of 512, the wide route; and
# with 1 head of 1032 at depth 2 (the decode kernels' column blocks)
HEAD512_MODEL = dict(MODEL, heads=1, dim_head=512)
HEAD1032_MODEL = dict(MODEL, heads=1, dim_head=1032, depth=2)
HEAD_TRAIN_STEPS = 3     # training steps of the phase 15 and 16 models
# phase 17: speculative decoding of the validation model, greedy, with a
# depth-2 draft of its width and with itself as draft
SPEC_ENGINE = dict(num_slots=8, capacity=1024, gamma=4, temperature=0.0,
                   prompt_buckets=(128, 256, 512, 1024))
SPEC_DRAFT = dict(MODEL, depth=2)
SPEC_TOKENS = 48         # tokens a stream; 960 + 48 + gamma fits 1024
# The margin rule.  A verify row attends its chunk's own k and v
# unquantized while decode_step attends the new token through the int8
# cache, and both run in bf16, so the target's logits for one token differ
# between the two paths (and between batch shapes, whose GEMMs round
# differently).  A stream may leave the target's greedy decode only at a
# token where the decode's top-2 logit margin is below MARGIN_BAR: 4 bf16
# ulps of a logit in [2, 4) (2^-6 each), above the int8 KV error's share
# (K rounded to 1/254, V to 1/254 of its row's absmax, attenuated by the
# residual stream), and above the largest verify-vs-decode logit
# difference the phase measures, which must stay below it.
MARGIN_BAR = 2 ** -4
# phase 18: tensor parallelism, TP_WORLD ranks sharing the one card over
# gloo (which takes CUDA tensors for all_reduce and broadcast; NCCL takes
# one rank a device): the production model served as in phase 13, the
# validation model trained, the head-sharded ops timed
TP_WORLD = 2
TP_PROMPT, TP_STEPS = PROD_PROMPT, 16
TP_TRAIN_STEPS = 3
TP_TIMEOUT_S = 600       # a world's time limit, and its collectives'
# phase 19: ring attention at the 0.81B model's attention width (16 heads
# of 128, bf16, causal) over RING_WORLD ranks sharing the card over gloo
# (ppermute stages each hop through pinned host memory): local lengths
# 8192 (the backward on K2) and 16384 (on K3a/K3b, past
# ONEPASS_BWD_MAX_SEQ); then GQA on a (model 2, seq 2) mesh of 4 ranks
RING_WORLD = 2
RING_HEADS, RING_DIM = PROD_MODEL["heads"], PROD_MODEL["dim_head"]
RING_SEQS = (16384, 32768)
RING_GQA_SEQ, RING_GQA_KV_HEADS = 8192, 4
# JAX's ring bars (tests/test_parallel.py:138-141, 247, 300, 353): max
# |diff| on the output, and on the gradients of sum(o^2) over max(1,
# max |g|) (check_ring_case says why)
RING_BARS = {torch.float32: (1e-4, 5e-4), torch.bfloat16: (1.5e-1, 3e-1)}
# and on the relative L2 error of the output and of each gradient: at 8192
# keys or more o is near a uniform average of v (|o| ~ 0.01-0.05), so
# JAX's absolute bars would pass a dropped shard pair.  Set from this
# phase's readings on an H100 (bf16 7e-4 to 4.9e-3, f32 1.4e-7 to 6.6e-7)
RING_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# phase 19's cases: label, mesh ("seq": RING_WORLD ranks on ("seq",);
# "model_seq": 4 ranks on (model 2, seq 2)), seq, dtype, causal and the
# keywords of ring_inputs
RING_CASES = (
    ("(a)", "seq", RING_SEQS[0], torch.bfloat16, True, {}),
    ("(b)", "seq", RING_SEQS[1], torch.bfloat16, True, {}),
    ("(d)", "seq", 1024, torch.float32, True, dict(h=4, kvh=4, d=64, seed=1)),
    ("(c) masked causal", "model_seq", RING_GQA_SEQ, torch.bfloat16, True,
     dict(kvh=RING_GQA_KV_HEADS, masked=True, seed=2)),
    ("(c) non-causal", "model_seq", RING_GQA_SEQ, torch.bfloat16, False,
     dict(kvh=RING_GQA_KV_HEADS, seed=3)),
)
# f32 elements of one (heads, queries, keys) logits tensor the plain
# versions hold at once (2 GiB): they run over chunks of heads
PLAIN_LOGITS = 1 << 29
# phase 20: the validation model in PIPE_STAGES pipeline stages
PIPE_STAGES = 2
# phase 21: MH_NODES multi-host nodes of MH_LOCAL ranks, a model axis of
# MH_LOCAL; --multihost-nccl: the trainer's losses over MH_NCCL_STEPS
# steps against one card's, at the bar the pipelined trainer met over
# NCCL on four cards
MH_NODES = 2
MH_LOCAL = 2
MH_NCCL_STEPS = 31
MH_NCCL_BAR = 4e-4
MH_NCCL_TIMEOUT_S = 300   # the trainers' time limit (killed past it)
MH_PROFILED = 2           # bf16 steps a phase-21 rank's device time spans


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


# profiler windows cuda_rows takes before it returns an empty one, and
# windows whole_rows takes before it averages over the records it kept
PROFILE_TRIES = 4
WHOLE_TRIES = 5
# cycles of the spin that opens a profiler window (about 2 ms on the
# H100); doubled for this window and every later one whenever a window
# loses the marker that follows the spin, up to OPEN_SPIN_MAX (0.5 s)
open_spin = 1 << 22
OPEN_SPIN_MAX = 1 << 30
# calls of a matmul in one of --profiler-drift's windows
DRIFT_CALLS = 20


def cuda_rows(work, iters: int, tries: int = PROFILE_TRIES):
    """torch.profiler's per-kernel rows (key, self device time in us,
    count) over ``iters`` calls of ``work``.  The profiler drops the
    records of a window's first kernels, as if its clock for device
    records ran behind the host's, by up to some milliseconds: with a
    bare 0.5 us opening spin, windows of 20 calls of a 0.34 ms matmul on
    the H100 kept 8 to 17 records in 5 of 321 windows over 330 s of one
    process (``--profiler-drift``), and a run of this script kept 13 of
    a kernel's 24 in the last of 5 windows that all lost some.  So a spin
    (torch.cuda._sleep's spin_kernel) of ``open_spin`` cycles opens the
    window and a short one marks its end, and the work starts after both;
    a window whose marker was dropped doubles ``open_spin`` and, while
    ``tries`` last, is profiled again.  The spins are left out of the
    rows.  A window with no record of the work's kernels at all is
    profiled again too, up to ``tries`` windows, and then returned
    empty.  User annotations are left out: a gloo collective's range
    (phase 18) spans the copies it issues and would count them twice."""
    global open_spin
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for t in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(open_spin)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(iters):
                work()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        rows = [(e.key, e.self_device_time_total, e.count) for e in events
                if "spin_kernel" not in e.key and not e.is_user_annotation]
        marked = any("spin_kernel" in e.key for e in events)
        if not marked and open_spin < OPEN_SPIN_MAX:
            open_spin *= 2
            print(f"  (the profiler dropped the window's opening marker: "
                  f"the opening spin is now {open_spin} cycles)")
            if t + 1 < tries:
                continue
        if rows:
            return rows
        print("  (the profiler recorded no kernel of the work in its window; "
              "profiled again)")
    return rows


def profiler_drift(seconds: float) -> None:
    """Run alone (``--profiler-drift SECONDS``): for ``seconds``, windows
    of DRIFT_CALLS calls of a 2048 x 2048 float32 matmul (0.34 ms on the
    H100), a second of 8192 x 8192 matmuls between them, each profiled
    once with a bare 1000-cycle opening spin and once by cuda_rows; prints
    the records each kept, every tenth window and wherever the bare one
    lost any, and fails if cuda_rows lost one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(2048, 2048, device="cuda")
    b = torch.randn(8192, 8192, device="cuda")
    t0 = time.perf_counter()
    w = 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(45):
            torch.mm(b, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(DRIFT_CALLS):
                torch.mm(a, a)
            torch.cuda.synchronize()
        bare = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "spin_kernel" not in e.key)
        rows = cuda_rows(lambda: torch.mm(a, a), DRIFT_CALLS)
        kept = sum(c for _, _, c in rows)
        if w % 10 == 0 or bare != DRIFT_CALLS or kept != DRIFT_CALLS:
            print(f"  {time.perf_counter() - t0:.1f} s, window {w}: kept "
                  f"{bare} of {DRIFT_CALLS} records with a bare opening "
                  f"spin, {kept} by cuda_rows (opening spin {open_spin} "
                  f"cycles; {sum(t for _, t, _ in rows) / max(kept, 1):.1f} "
                  f"us a call)", flush=True)
        if kept != DRIFT_CALLS:
            fail(f"cuda_rows kept {kept} of {DRIFT_CALLS} records")
        w += 1


def whole_rows(work, iters: int, group=None):
    """cuda_rows' (key, device time in us, count) per call of a ``work``
    that launches each of its kernels the same number of times per call,
    over ``iters`` calls: a kernel whose count is not a multiple of the
    calls lost a record, so the counts are printed and ``work`` is
    profiled again over one call more.  Runs on the H100 have lost
    records of the same kernel in 3 and in 5 windows running, once 11 of
    a kernel's 24 in the last of 5.  After WHOLE_TRIES such profiles each
    kernel's launches a call are the most that one window's kept records
    show, rounded up (exact where a window lost fewer records of it than
    it ran calls), and its time a call is the mean of its kept records
    over all the windows times those launches.  With a process ``group``
    (a ``work`` whose collectives every rank must run alike) every rank
    profiles again when any rank lost a record or saw none."""
    import torch.distributed as dist

    kept = {}   # key: [device time in us, records, launches a call]
    for n in range(iters, iters + WHOLE_TRIES):
        rows = cuda_rows(work, n, PROFILE_TRIES if group is None else 1)
        counts = [count for _, _, count in rows]
        again = torch.tensor([not rows or any(c % n for c in counts)])
        if group is not None:
            dist.all_reduce(again, dist.ReduceOp.MAX, group=group)
        if not again.item():
            return [(key, t / n, count // n) for key, t, count in rows]
        lost = [(key[:40], count) for key, _, count in rows if count % n]
        print(f"  (the profiler lost kernel records: {lost} of counts "
              f"{counts} over {n} calls; profiled again)")
        for key, t, count in rows:
            k = kept.setdefault(key, [0.0, 0, 0])
            k[0] += t
            k[1] += count
            k[2] = max(k[2], -(-count // n))
    print(f"  (lost records {WHOLE_TRIES} times running: each kernel's time "
          f"a call is the mean of its {[k[1] for k in kept.values()]} kept "
          f"records times its {[k[2] for k in kept.values()]} launches a "
          f"call)")
    return [(key, t / count * c, c) for key, (t, count, c) in kept.items()]


def whole_us(work, iters: int) -> float:
    """Device time (us) per call of ``work``, from whole_rows."""
    return sum(t for _, t, _ in whole_rows(work, iters))


def device_ms(fn, flush=None, iters: int = 20) -> float:
    """Device time per call of ``fn``'s kernels, the flush's excluded; the
    CUDA-event time where the profiler saw no device time."""
    for _ in range(3):
        fn()
    per_call = whole_us(fn if flush is None else lambda: (flush(), fn()),
                        iters)
    if flush is not None:
        per_call -= whole_us(flush, iters)
    if per_call > 0:
        return per_call / 1e3
    print("  (the profiler saw no device time: CUDA-event time instead)")
    return event_ms(fn, flush=flush)


def library_ms(name: str, fn, windows: int = 5) -> float:
    """device_ms of a library call, the median of ``windows`` profiler
    windows, printed beside each window's reading, the kernels the call
    launched (the library's choice of backend) and the CUDA-event time
    (whose host enqueue can exceed a short call's device time)."""
    reads = [device_ms(fn) for _ in range(windows)]
    kernels = sorted({key[:70] for key, _, _ in cuda_rows(fn, 1)})
    print(f"  ({name}: device time in {windows} windows "
          f"{', '.join(f'{r:.4f}' for r in reads)} ms, median taken; "
          f"kernels {kernels}; CUDA-event time {event_ms(fn):.4f} ms)")
    return statistics.median(reads)


def tflops(flops: float, ms: float) -> float:
    """Achieved rate, TFLOP/s, of ``flops`` operations in ``ms``."""
    return flops / (ms * 1e-3) / 1e12


# calls of a path profiled for require_kernels: the profiler can drop a
# kernel's record even after cuda_rows' sentinel (seen once on the H100,
# for the first kernel of a one-call window), so a kernel must be missing
# from every call's records to count as not launched
REQUIRE_ITERS = 3


def require_kernels(rows, names, path: str) -> None:
    """Fail unless every kernel name in ``names`` appears among the
    profiler's ``rows``, and no FMA instance of K1 or K7, and no bf16 FMA
    instance of the dK/dV kernel (K2, K3b) or the dQ kernel (K3a), does:
    the bf16 paths must run the tensor-core instances."""
    keys = [key for key, _, _ in rows]
    missing = [n for n in names if not any(n in key for key in keys)]
    fma = [key[:60] for key in keys if "fwd_kernel<" in key
           or "qmm_kernel<" in key or "dkdv_kernel<__nv_bfloat16" in key
           or "dq_kernel<__nv_bfloat16" in key]
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


def instance_registers(ptxas_log: str, kind: str):
    """(kernel, registers) of the instances whose mangled name holds
    ``kind`` (the wide route's tensor-core "wide_mma_kernel", the 3xTF32
    "tf32_kernel") in a ptxas -v report, each named by the part of its
    mangled name that tells the instances apart."""
    out, entry = [], ""
    for ln in ptxas_log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        m = re.search(r"Used (\d+) registers", ln)
        if m and kind in entry:
            name = re.search(rf"[a-z][a-z_]*?_{kind}(I\w+?EE)?", entry)
            out.append((name.group(0), int(m.group(1))))
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


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each entry correctly rounded from float64 to float32:
    the plain versions' exact products (``mm=exact_mm``)."""
    return (a.double() @ b.double()).float()


def max_rel(x: torch.Tensor, y: torch.Tensor) -> float:
    """The largest relative error of ``x`` against ``y`` (inv_l's units)."""
    return ((x - y) / y).abs().max().item()


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
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
    lib_ms = library_ms("SDPA b1 h8 s1024 d64",
                        lambda: F.scaled_dot_product_attention(
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


def hold_decode(label, kernel, plain, q, cache):
    """A decode kernel on queries ``q`` (b, h, d) against its plain version
    on the same cache, with f32 queries (the kernel rounds them to bf16
    as it does bf16 ones, and its f32 output is kept), at scale 1 (the
    timed calls') and 8 (the engines', where a score error moves the
    weights).  The bar is 2**-8 of the output's largest value (at most
    F32_ERR_BAR): near-uniform weights over ~1000 tokens give |o| ~ 0.03,
    so an absolute bf16 bar would pass a wrong average.  Returns the
    larger error."""
    b, h, d = q.shape
    kvh = cache.k8.shape[1]
    qg = q.float().view(b, kvh, h // kvh, d)
    worst = 0.0
    for scale in (1.0, 8.0):
        got = kernel(q.float(), cache, scale=scale, l2norm_qk=False)
        want = plain(qg, cache, scale).view(got.shape)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        bar = min(F32_ERR_BAR, 2 ** -8 * top + 1e-6)
        print(f"  {label}, f32 queries at scale {scale:g}: vs plain "
              f"{err:.3e} (bar {bar:.3e}: 2^-8 of max|o| {top:.3e})")
        if not (err <= bar and torch.isfinite(got).all().item()):
            fail(f"{label} at scale {scale:g}: {err} against plain (bar "
                 f"{bar})")
        worst = max(worst, err)
    return worst


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
    err = max(err, hold_decode(
        "K4 b8 kvh8 g1 d64, the ragged lengths", quantized_decode_attention,
        decode_attention_plain, q, ragged))
    err = max(err, hold_decode(
        "K4 b8 kvh8 g1 d64, 8 x 1024 tokens (the timed shape)",
        quantized_decode_attention, decode_attention_plain, q, full))

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


def bwd_inputs(g, b, h, kvh, sq, sk, d, dtype, mask_kind, bias_kind,
               causal):
    """The backward's inputs from generator ``g``: (dO, o, inv_l, q, k, v,
    mask, bias) with o and inv_l from the plain forward, and its keywords
    (scale 1)."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_attention_forward_plain, l2norm_tensors)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    q, k = l2norm_tensors(randn(b, h, sq, d), randn(b, kvh, sk, d), groups=8)
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


def compare_backward(worst, name, args, kw, dtype, mask_kind):
    """Both backward routes (K2 only without a bias) on ``args`` against
    the plain version at GRAD_BARS[dtype]; folds each kernel's max abs
    error into ``worst``."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain)

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
                                     (k_dq, k_dkdv, k_dkdv, k_dq), got, want):
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
        unit = "max(1, max|g|)" if dtype == torch.float32 else "(|g| + rms g)"
        print(f"  {k_dq}{'' if k_dq == k_dkdv else '+' + k_dkdv} "
              f"{name} {str(dtype)[6:]}: err / {unit}: "
              f"{', '.join(errs)} (bar {bar:g})")


def time_backward(card: str, args, kw, args_b, kw_b):
    """K2 on ``args`` (causal, no bias) and K3a, K3b on ``args_b`` (causal,
    an (h, i, j) bias), in their dtype (bf16 bounded at the tensor cores'
    peak; float32, on the tensor cores as 3xTF32 at every width, by 3 x
    its operations at the TF32 tensor cores' peak, the bound at the
    float32 peak outside them printed beside), timed beside the plain
    backward and SDPA's; returns {kernel: timing row}."""
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain)
    from flash_cosine_sim_attention_tpu_torch.ops.reference import causal_keep

    x = bk._cuda_inputs(*args, False)
    x_b = bk._cuda_inputs(*args_b, False)
    do, _, _, q, k, v = args[:6]
    b, h, s, d = q.shape
    plain_ms = device_ms(lambda: flash_attention_backward_plain(*args, **kw))
    plain_b_ms = device_ms(
        lambda: flash_attention_backward_plain(*args_b, **kw_b))
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
    io = b * h * s * d * q.element_size()   # one (b, h, s, d) tensor
    label = str(q.dtype)[6:]
    peak = PEAK_F32_FLOPS if q.dtype == torch.float32 else PEAK_BF16_FLOPS
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
        bound_ms, by = bound(flops, nbytes, peak)
        if q.dtype == torch.float32:
            # 3xTF32: three products on the TF32 tensor cores for each of
            # the function's; the FMA bound (67 TFLOP/s) in brackets
            fma_ms = bound_ms
            bound_ms, by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
            by_note = f" (3xTF32; FMA bound {fma_ms:.5f} ms)"
        else:
            by_note = ""
        call_ms = event_ms(wrapper) if wrapper is not None else None
        rows[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=bound_ms,
                          bound_by=by, library_ms=l_ms)
        print(f"  {name} b{b} h{h} s{s} d{d} causal {label}"
              f"{'' if name == 'K2' else ' + (h,i,j) bias'} on {card}: "
              f"device time kernel {ms:.4f} ms ({tflops(flops, ms):.1f} "
              f"TFLOP/s), plain {p_ms:.4f} ms, SDPA backward {l_ms:.4f} ms "
              f"({tflops(flops, l_ms):.1f} TFLOP/s), bound {bound_ms:.5f} ms "
              f"({by}){by_note}"
              + ("" if call_ms is None else
                 f"; wrapper call {call_ms:.4f} ms"
                 f"{'' if name == 'K2' else ' (K3a + K3b)'}"))
    print("  (plain: the whole plain backward; SDPA: dQ, dK, dV of "
          "scaled_dot_product_attention, with the bias as a float mask and "
          "no dB for K3; TFLOP/s count the function's products, 2d FLOPs "
          "per visible pair each: 5 for K2, 3 for K3a, 4 for K3b; the "
          "tensor-core K2, K3a and K3b run 8, 4 and 6, e and dS as bf16 "
          "hi + lo; the float32 K2, K3a and K3b run 15, 9 and 12 TF32 "
          "products, 3 a product)")
    return rows


def check_backward(card: str):
    """Phase 7: K2, K3a, K3b vs the plain backward; returns
    ({kernel: max abs err}, {kernel: timing row})."""
    from flash_cosine_sim_attention_tpu_torch.ops import bwd_kernel as bk

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def inputs(*shape_and_kinds):
        return bwd_inputs(g, *shape_and_kinds)

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

    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, mask_kind, bias_kind, causal in cases:
            args, kw = inputs(*shape, dtype, mask_kind, bias_kind, causal)
            compare_backward(worst, name, args, kw, dtype, mask_kind)

    # the trainer's attention shape, as phase 8 runs K2 and phase 8b runs
    # K3 (with an (h, i, j) bias): checked, then timed
    b, h, s, d = 4, 8, 1024, 64
    args, kw = inputs(b, h, h, s, s, d, torch.bfloat16, None, None, True)
    compare_backward(worst, "b4 h8 s1024 causal (phase 8's shape)", args, kw,
                     torch.bfloat16, None)
    args_b, kw_b = inputs(b, h, h, s, s, d, torch.bfloat16, None, "h", True)
    compare_backward(worst,
                     "b4 h8 s1024 causal + (h,i,j) bias (phase 8b's shape)",
                     args_b, kw_b, torch.bfloat16, None)
    require_kernels(cuda_rows(lambda: bk._backward_twopass(*args_b, **kw_b),
                              REQUIRE_ITERS),
                    ("dq_mma_kernel<__nv_bfloat16, 64>",
                     "dkdv_mma_kernel<__nv_bfloat16, 64, false>"),
                    "two-pass backward at phase 8b's shape (bf16)")
    return worst, time_backward(card, args, kw, args_b, kw_b)


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
    rows = cuda_rows(step, 1)
    require_kernels(rows, ("dq_mma_kernel<__nv_bfloat16, 64>",
                           "dkdv_mma_kernel<__nv_bfloat16, 64, false>"),
                    "bias gradient step (bf16)")
    parts = {n: sum(t for key, t, _ in rows if n in key) / 1e3
             for n in ("dq_mma_kernel<", "dkdv_mma_kernel<", "")}
    del losses[3:]
    print(f"  learnable (h,i,j) bias, b4 h8 s1024 d64 causal bf16 on {card}: "
          f"losses {', '.join(f'{x:.6f}' for x in losses)}; launches dQ+dB "
          f"kernel {launches[0]}, dK/dV kernel {launches[1]}; a step's "
          f"device time {parts['']:.3f} ms (profiled; K3a "
          f"{parts['dq_mma_kernel<']:.3f}, K3b {parts['dkdv_mma_kernel<']:.3f})")
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
            worst[name] = max(worst[name], hold_decode(
                f"{label} at phase 11's shape", kernel, plain, q32, cache))
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
    lib_ms = library_ms("SDPA b1 h16 s1024 d128",
                        lambda: F.scaled_dot_product_attention(
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
    k4_us = sum(t for key, t, _ in rows
                if "decode_kernel<" in key and "paged" not in key)
    require_kernels(rows, ("qmm_mma_kernel<16,", "decode_kernel<"),
                    "production decode step")
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
          f"{k7_us / busy_us:.3f} of the device time; K4 "
          f"{k4_us / profiled / 1e3:.3f} ms/step in {PROD_MODEL['depth']} "
          f"calls, {k4_us / busy_us:.3f} of the device time; "
          f"continue_request (50 tokens) {continue_ms:.2f} ms")
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
    del paged
    torch.cuda.empty_cache()
    return (launches, *decode_at_prod_shape(card))


def decode_at_prod_shape(card: str):
    """K4 at the shape a 0.81B decode step gives it: b8 kvh16 g1 d128 int8
    over a 2048-token cache holding PROD_PROMPT + 36 live tokens a slot
    (the slots' length after phase 13's traffic), L2 flushed; against plain,
    then timed, the call whole.  Returns (max abs err, timing row)."""
    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.quant import (
        append, decode_attention_plain, init_cache,
        quantized_decode_attention)

    g = torch.Generator(device="cuda").manual_seed(SEED + 28)
    b, kvh, d = PROD_ENGINE["num_slots"], PROD_MODEL["heads"], \
        PROD_MODEL["dim_head"]
    cap, live = PROD_ENGINE["capacity"], PROD_PROMPT + 36
    k = l2norm_tensors(torch.randn(b, kvh, live, d, device="cuda",
                                   generator=g))
    v = torch.randn(b, kvh, live, d, device="cuda", generator=g)
    cache = append(init_cache(b, kvh, cap, d, "cuda"), k, v)
    q = l2norm_tensors(torch.randn(b, kvh, d, device="cuda", generator=g)
                       ).to(torch.bfloat16)
    qg = q.float()[:, :, None]
    err = hold_decode(f"K4 b{b} kvh{kvh} g1 d{d} int8, {live} of {cap} "
                      "tokens a slot", quantized_decode_attention,
                      decode_attention_plain, q, cache)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    call = lambda: quantized_decode_attention(  # noqa: E731
        q, cache, scale=1.0, l2norm_qk=False)
    ms = device_ms(call, flush=scratch.zero_)
    plain_ms = device_ms(lambda: decode_attention_plain(qg, cache, 1.0),
                         flush=scratch.zero_)
    tokens = b * kvh * live
    nbytes = tokens * (2 * d + 4) + q.numel() * 2 + b * kvh * d * 4 + b * 4
    bound_ms, by = bound(4 * d * tokens, nbytes)
    print(f"  K4 b{b} kvh{kvh} g1 d{d} int8, {live} of {cap} tokens a slot "
          f"(a production decode step's shape) on {card}: vs plain "
          f"{err:.3e} (f32 output, above); device time kernel {ms:.4f} ms (the call whole), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({by}); no single PyTorch call computes "
          f"it")
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                     library_ms=None)


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


def _attention_counters():
    from flash_cosine_sim_attention_tpu_torch.ops import bwd_kernel as bk
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        paged_decode_attention, quantized_decode_attention)
    return (flash_attention_forward, bk.fused_bwd_kernel, bk.dq_kernel,
            bk.dkdv_kernel, quantized_decode_attention,
            paged_decode_attention)


def counts():
    """Launch counts of K1, K2, K3a, K3b, K4 and K5, in that order."""
    return [c.launches for c in _attention_counters()]


def op_widths_vs_plain(g, dims, worst, kernels_at):
    """The op's forward and both backward routes (an (h, i, j) bias on the
    two-pass one) at each head dim of ``dims``, f32 and bf16, b2 h4/2 s384
    causal, against plain; folds max abs errors into ``worst``."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain,
        flash_attention_forward_plain)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)

    b, h, kvh, s = 2, 4, 2, 384
    for d in dims:
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = bwd_inputs(g, b, h, kvh, s, s, d, dtype, None, None,
                                  True)
            do, _, _, q, k, v = args[:6]
            n0 = counts()
            o, inv_l = flash_attention_forward(q, k, v, None, None, **kw)
            one = bk._backward_onepass(do, o, inv_l, q, k, v, None,
                                       scale=1.0, causal=True)
            args_b, kw_b = bwd_inputs(g, b, h, kvh, s, s, d, dtype, None,
                                      "h", True)
            two = bk._backward_twopass(*args_b, **kw_b)
            moved = [n - m for n, m in zip(counts(), n0)][:4]
            o_p, inv_p = flash_attention_forward_plain(q, k, v, None, None,
                                                       **kw)
            want = flash_attention_backward_plain(do, o, inv_l, q, k, v, None,
                                                  None, **kw)
            want_b = flash_attention_backward_plain(*args_b, **kw_b)
            torch.cuda.synchronize()
            bar = F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR
            e1 = (o.float() - o_p.float()).abs().max().item()
            l1 = ((inv_l - inv_p) / inv_p).abs().max().item()
            errs = {}
            for owner, got, ref, names in (
                    ("K2", one, want, ("dq", "dk", "dv")),
                    ("K3", two, want_b, ("dq", "dk", "dv", "db"))):
                for name, x, y in zip(names, got, ref):
                    errs[f"{owner} {name}"] = grad_err(x, y, dtype)
                    who = owner if owner == "K2" else (
                        "K3a" if name in ("dq", "db") else "K3b")
                    worst[who] = max(worst[who],
                                     (x.float() - y.float()).abs().max().item())
            worst["K1"] = max(worst["K1"], e1)
            finite = all(torch.isfinite(t.float()).all().item()
                         for t in (o, *one, *two))
            print(f"  d{d} (kernels at {kernels_at(d)}) b{b} h{h}/{kvh} s{s} "
                  f"causal {str(dtype)[6:]}: K1 max|o-plain| {e1:.3e} (bar "
                  f"{bar:g}), inv_l {l1:.1e}; grads err "
                  + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
                  + f" (bar {GRAD_BARS[dtype]:g}); launches K1, K2, K3a, K3b "
                  f"+{moved}")
            if not (finite and moved == [1, 1, 1, 1] and e1 <= bar
                    and l1 <= 1e-5 and max(errs.values()) <= GRAD_BARS[dtype]):
                fail(f"d{d} {dtype}: o {e1}, inv_l {l1}, grads {errs}, "
                     f"launches {moved}, finite {finite}")


def decode_widths_vs_plain(g, dims, worst):
    """K4 and K5 at each head dim of ``dims`` (int8 and e4m3, g 2 on 2 kv
    heads; empty, ragged, whole and finished slots over 8 splits of 128
    tokens) against plain at F32_ERR_BAR; folds errors into ``worst``."""
    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.quant import (
        append, append_paged, decode_attention_plain, init_cache,
        init_paged_cache, paged_decode_attention, paged_decode_plain,
        quantized_decode_attention)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    ps, mp, kvh, gq = 128, 8, 2, 2
    bq = len(PAGED_LENGTHS) + 1           # the last slot has finished
    lengths = torch.tensor(PAGED_LENGTHS + (700,), dtype=torch.int32,
                           device="cuda")
    for d in dims:
        k = l2norm_tensors(randn(bq, kvh, mp * ps, d))
        v = 3 * randn(bq, kvh, mp * ps, d)
        q = l2norm_tensors(randn(bq, kvh * gq, d))
        qg = q.view(bq, kvh, gq, d)
        for kv_dtype in (torch.int8, torch.float8_e4m3fn):
            kv = "int8" if kv_dtype == torch.int8 else "e4m3"
            cont = append(init_cache(bq, kvh, mp * ps, d, "cuda",
                                     kv_dtype=kv_dtype), k, v)._replace(
                                         length=lengths)
            table = _shuffled_table(bq, mp, bq * mp + 3, SEED + 21)
            paged = append_paged(init_paged_cache(
                bq * mp + 3, kvh, ps, d, bq, mp, kv_dtype=kv_dtype,
                device="cuda")._replace(page_table=table), k, v)
            dead = table.clone()
            dead[-1] = 0                  # finished: null page, stale length
            paged = paged._replace(page_table=dead, length=lengths)
            n0 = counts()
            o4 = quantized_decode_attention(q, cont, scale=8.0,
                                            l2norm_qk=False)
            o5 = paged_decode_attention(q, paged, scale=8.0, l2norm_qk=False)
            again = quantized_decode_attention(q, cont, scale=8.0,
                                               l2norm_qk=False)
            moved = [n - m for n, m in zip(counts(), n0)][4:]
            p4 = decode_attention_plain(qg, cont, 8.0).view(o4.shape)
            p5 = paged_decode_plain(qg, paged, 8.0).view(o5.shape)
            torch.cuda.synchronize()
            e4 = (o4 - p4).abs().max().item()
            e5 = (o5 - p5).abs().max().item()
            worst["K4"], worst["K5"] = max(worst["K4"], e4), max(worst["K5"], e5)
            print(f"  {kv} g{gq} d{d}, lengths {lengths.tolist()}: K4 vs "
                  f"plain {e4:.3e}, K5 vs plain {e5:.3e} (bar "
                  f"{F32_ERR_BAR:g}); a second K4 call equal: "
                  f"{torch.equal(o4, again)}; launches K4, K5 +{moved}")
            if not (moved == [2, 1] and max(e4, e5) <= F32_ERR_BAR
                    and torch.equal(o4, again)
                    and o4[0].abs().max().item() == 0
                    and o5[0].abs().max().item() == 0):
                fail(f"decode d{d} {kv}: K4 {e4}, K5 {e5}, launches {moved}, "
                     f"empty slot not 0 or calls differ")


def decode_past_1024(g, dims, worst):
    """K4 and K5 past d 1024 (column blocks of at most 1024 columns) at
    each head dim of ``dims``: int8 and e4m3, g 1 and GQA 4 on 2 kv heads,
    slots of lengths 0 (exactly 0 out), 200 (across a split boundary) and
    the capacity 512, in 4 splits of 128 tokens (the pool's pages
    shuffled); a first and a second call equal bit for bit, one launch
    each, then held by hold_decode (f32 queries at scale 1 and 8).  Folds
    errors into ``worst``; a profiled call must show the column-block
    instances."""
    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.quant import (
        append, append_paged, decode_attention_plain, init_cache,
        init_paged_cache, paged_decode_attention, paged_decode_plain,
        quantized_decode_attention)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    ps, mp, kvh = 128, 4, 2
    lengths = torch.tensor((0, 200, mp * ps), dtype=torch.int32,
                           device="cuda")
    b = lengths.numel()
    for d in dims:
        for gq in (1, 4):
            k = l2norm_tensors(randn(b, kvh, mp * ps, d))
            v = 3 * randn(b, kvh, mp * ps, d)
            q = l2norm_tensors(randn(b, kvh * gq, d))
            for kv_dtype in (torch.int8, torch.float8_e4m3fn):
                kv = "int8" if kv_dtype == torch.int8 else "e4m3"
                cont = append(init_cache(b, kvh, mp * ps, d, "cuda",
                                         kv_dtype=kv_dtype), k, v)._replace(
                                             length=lengths)
                table = _shuffled_table(b, mp, b * mp + 1, SEED + 31)
                paged = append_paged(init_paged_cache(
                    b * mp + 1, kvh, ps, d, b, mp, kv_dtype=kv_dtype,
                    device="cuda")._replace(page_table=table), k, v)._replace(
                        length=lengths)
                for name, kernel, plain, cache in (
                        ("K4", quantized_decode_attention,
                         decode_attention_plain, cont),
                        ("K5", paged_decode_attention, paged_decode_plain,
                         paged)):
                    n0 = kernel.launches
                    first = kernel(q, cache, scale=8.0, l2norm_qk=False)
                    second = kernel(q, cache, scale=8.0, l2norm_qk=False)
                    torch.cuda.synchronize()
                    moved = kernel.launches - n0
                    same = torch.equal(first, second)
                    empty = first[0].abs().max().item() == 0
                    label = (f"{name} {kv} g{gq} d{d}, lengths "
                             f"{lengths.tolist()}")
                    err = hold_decode(label, kernel, plain, q, cache)
                    worst[name] = max(worst[name], err)
                    print(f"  {label}: launches +{moved}, a second call equal:"
                          f" {same}, the empty slot 0: {empty}")
                    if not (moved == 2 and same and empty
                            and torch.isfinite(first).all().item()):
                        fail(f"{label}: launches {moved}, calls equal {same},"
                             f" empty slot 0 {empty}")
        require_kernels(cuda_rows(lambda: (
            quantized_decode_attention(q, cont, l2norm_qk=False),  # noqa: B023
            paged_decode_attention(q, paged, l2norm_qk=False)),  # noqa: B023
            REQUIRE_ITERS),
            ("decode_cols_kernel<", "paged_decode_cols_kernel<"),
            f"decode and paged decode at d {d}")


def serve_decode_path(cfg, seed):
    """The decode path past d 1024: ``cfg``'s model (random weights from
    ``seed``) through serve_both.  Returns {kernel: launches}."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)

    params = random_flax_params(
        CosineSimCausalTransformer(**cfg, device="meta"), seed)
    model = build_model(params, torch.bfloat16, "cuda", cfg)
    vocab = cfg["num_tokens"]
    seen, launches = serve_both(model, vocab, np.random.default_rng(seed + 1))
    print(f"  heads {cfg['heads']} of {cfg['dim_head']} at depth "
          f"{cfg['depth']}, bf16: both engines took prompts {WIDE_PROMPTS} "
          f"and 8 steps each ({len(seen)} tokens); launches {launches}")
    if (min(launches.values()) <= 0
            or not all(0 <= t < vocab for t in seen)):
        fail(f"heads of {cfg['dim_head']}: launches {launches}, tokens "
             f"{seen}")
    return launches


def time_attention_at(card, g, d, h, worst, names):
    """K1, K2, K3a and K3b at b4 h{h} s1024 d{d} causal bf16 (a training
    microbatch of the model with h heads of d), against plain and timed;
    ``names`` are the instances the profiles must show.  Returns {kernel:
    timing row}."""
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_forward_plain)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.train import BATCH_SIZE

    b, s = BATCH_SIZE, MODEL["max_seq_len"]
    args, kw = bwd_inputs(g, b, h, h, s, s, d, torch.bfloat16, None, None,
                          True)
    q, k, v = args[3:6]
    args_b, kw_b = bwd_inputs(g, b, h, h, s, s, d, torch.bfloat16, None, "h",
                              True)
    o, inv_l = flash_attention_forward(q, k, v, None, None, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, None, None, **kw)
    torch.cuda.synchronize()
    e1 = (o.float() - o_p.float()).abs().max().item()
    l1 = ((inv_l - inv_p) / inv_p).abs().max().item()
    worst["K1"] = max(worst["K1"], e1)
    print(f"  K1 b{b} h{h} s{s} d{d} causal bf16 (the timed shape): "
          f"max|o-plain| {e1:.3e} (bar {BF16_ERR_BAR:g}), max rel inv_l err "
          f"{l1:.1e} (bar 1e-05)")
    if not (torch.isfinite(o.float()).all().item() and e1 <= BF16_ERR_BAR
            and l1 <= 1e-5):
        fail(f"K1 d{d} at the timed shape: o {e1}, inv_l {l1}")
    compare_backward(worst, f"b{b} h{h} s{s} d{d} causal (the timed shape)",
                     args, kw, torch.bfloat16, None)
    compare_backward(worst, f"b{b} h{h} s{s} d{d} causal + (h,i,j) bias "
                     "(the timed shape)", args_b, kw_b, torch.bfloat16, None)
    require_kernels(cuda_rows(lambda: (
        flash_attention_forward(q, k, v, None, None, **kw),
        bk._backward_onepass(*args[:7], scale=1.0, causal=True),
        bk._backward_twopass(*args_b, **kw_b)), REQUIRE_ITERS), names,
        f"forward and both backward routes at d {d} (bf16)")
    call = lambda: flash_attention_forward(q, k, v, None, None, **kw)  # noqa: E731
    ms = device_ms(call)
    plain_ms = device_ms(
        lambda: flash_attention_forward_plain(q, k, v, None, None, **kw))
    lib_ms = library_ms(f"SDPA b{b} h{h} s{s} d{d}",
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, scale=1.0))
    flops = 4 * d * b * h * s * (s + 1) / 2
    bound_ms, by = bound(flops, 4 * q.numel() * 2 + b * h * s * 4)
    rows = {"K1": dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by, library_ms=lib_ms)}
    print(f"  K1 b{b} h{h} s{s} d{d} causal bf16 on {card}: device time "
          f"kernel {ms:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({tflops(flops, lib_ms):.1f}"
          f" TFLOP/s), bound {bound_ms:.5f} ms ({by})")
    rows.update(time_backward(card, args, kw, args_b, kw_b))
    return rows


def time_decode_at(card, g, d, kvh, worst):
    """K4 and K5 at b8 kvh{kvh} g1 d{d} int8, 8 x 1024 live tokens (8
    slots of the model with kvh heads of d), L2 flushed: against plain, then
    timed, each call whole.  Returns {kernel: timing row}."""
    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.quant import (
        append, append_paged, decode_attention_plain, init_cache,
        init_paged_cache, paged_decode_attention, paged_decode_plain,
        quantized_decode_attention)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    bd, cap, ps = 8, 1024, 128
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    k = l2norm_tensors(randn(bd, kvh, cap, d), groups=8)
    v = randn(bd, kvh, cap, d)
    q = l2norm_tensors(randn(bd, kvh, d), groups=8).to(torch.bfloat16)
    qg = q.float()[:, :, None]
    full = append(init_cache(bd, kvh, cap, d, "cuda"), k, v)
    table = _shuffled_table(bd, cap // ps, bd * cap // ps + 1, SEED + 22)
    pool = append_paged(init_paged_cache(
        bd * cap // ps + 1, kvh, ps, d, bd, cap // ps,
        device="cuda")._replace(page_table=table), k, v)
    tokens = bd * kvh * cap
    small = q.numel() * 2 + bd * kvh * d * 4 + bd * 4
    rows = {}
    for name, label, cache, kernel, plain, extra in (
            ("K4", "cache", full, quantized_decode_attention,
             decode_attention_plain, 0),
            ("K5", "pool, shuffled pages of 128", pool, paged_decode_attention,
             paged_decode_plain, table.numel() * 4)):
        err = hold_decode(f"{name} b{bd} kvh{kvh} g1 d{d} int8 {label}, "
                          "8 x 1024 tokens", kernel, plain, q, cache)
        worst[name] = max(worst[name], err)
        call = lambda: kernel(q, cache, scale=1.0, l2norm_qk=False)  # noqa: E731,B023
        ms = device_ms(call, flush=scratch.zero_)
        plain_ms = device_ms(lambda: plain(qg, cache, 1.0),  # noqa: B023
                             flush=scratch.zero_)
        bound_ms, by = bound(4 * d * tokens,
                             tokens * (2 * d + 4) + small + extra)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=by, library_ms=None)
        print(f"  {name} b{bd} kvh{kvh} g1 d{d} int8 {label}, 8 x 1024 tokens "
              f"on {card}: vs plain {err:.3e} (f32 output, above); device "
              f"time kernel {ms:.4f} ms (the call whole), "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}); no "
              f"single PyTorch call computes it")
    return rows


def serve_both(model, vocab, rng):
    """``model`` served by both engines (prompts WIDE_PROMPTS drawn from
    ``rng``, 8 steps each), every attention kernel's launch count set to 0
    first.  Returns (the tokens seen, {"k1", "k4", "k5": launches})."""
    from flash_cosine_sim_attention_tpu_torch.serving import (
        InferenceEngine, PagedInferenceEngine)

    for c in _attention_counters():
        c.launches = 0
    seen = []
    for engine in (InferenceEngine(model, **ENGINE, seed=SEED, device="cuda"),
                   PagedInferenceEngine(model, **PAGED_ENGINE, seed=SEED,
                                        device="cuda")):
        for n in WIDE_PROMPTS:
            slot = engine.add_request(rng.integers(0, vocab, n))
            seen.append(int(engine.last_token[slot]))
        for _ in range(8):
            seen.extend(engine.step().values())
    return seen, dict(zip(("k1", "k4", "k5"), (counts()[0], *counts()[4:])))


def model_path(cfg, seed):
    """The validation width with ``cfg``'s heads: served by both engines
    (prompts WIDE_PROMPTS, 8 steps each), trained HEAD_TRAIN_STEPS steps,
    a learnable (h, i, j) bias's gradient taken 3 times (every attention kernel's launches read around
    these), then card vs CPU in f32 at depth 2.  Seeds seed..seed + 3.
    Returns {kernel: launches}."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)
    from flash_cosine_sim_attention_tpu_torch.train import (
        BATCH_SIZE, GRAD_ACCUM, make_optimizer, train_step)

    h, d, s = cfg["heads"], cfg["dim_head"], cfg["max_seq_len"]
    params = random_flax_params(
        CosineSimCausalTransformer(**cfg, device="meta"), seed)
    model = build_model(params, torch.bfloat16, "cuda", cfg)
    rng = np.random.default_rng(seed + 1)
    vocab = cfg["num_tokens"]
    seen, serving = serve_both(model, vocab, rng)
    del model
    torch.manual_seed(seed + 2)
    trainee = CosineSimCausalTransformer(**cfg, dtype=torch.bfloat16,
                                         device="cuda")
    opt = make_optimizer(trainee)
    tokens = torch.from_numpy(rng.integers(
        0, vocab, (HEAD_TRAIN_STEPS, GRAD_ACCUM, BATCH_SIZE, s + 1)))
    n0 = counts()
    losses = [train_step(trainee, opt, batch.cuda()).item()
              for batch in tokens]
    trained = [n - m for n, m in zip(counts(), n0)][:2]
    del trainee, opt
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(BATCH_SIZE, h, s, d, device="cuda",
                           generator=g).to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(h, s, s, device="cuda", requires_grad=True)
    bias_opt = torch.optim.Adam([bias], lr=0.05)
    n0 = counts()
    for _ in range(3):
        loss = flash_cosine_sim_attention(q, k, v, attn_bias=bias, causal=True,
                                          scale=1.0).float().square().mean()
        bias_opt.zero_grad()
        loss.backward()
        bias_opt.step()
    bias_path = [n - m for n, m in zip(counts(), n0)][2:4]
    launches = dict(k1=serving["k1"] + trained[0], k2=trained[1],
                    k3a=bias_path[0], k3b=bias_path[1], k4=serving["k4"],
                    k5=serving["k5"])
    print(f"  heads {h} of {d}, bf16: both engines took prompts "
          f"{WIDE_PROMPTS} and 8 steps each ({len(seen)} tokens); "
          f"{HEAD_TRAIN_STEPS} train steps, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; 3 bias-gradient steps, "
          f"bias finite: {bool(torch.isfinite(bias).all())}; launches "
          f"{launches}")
    per_train = GRAD_ACCUM * cfg["depth"] * HEAD_TRAIN_STEPS
    if (min(launches.values()) <= 0 or trained != [per_train] * 2
            or bias_path != [3, 3] or not np.all(np.isfinite(losses))
            or not torch.isfinite(bias).all().item()
            or not all(0 <= t < vocab for t in seen)):
        fail(f"heads {h} of {d}: launches {launches}, train {trained}, bias "
             f"path {bias_path}, losses {losses}")
    small = dict(cfg, depth=2)
    path_parity(random_flax_params(
        CosineSimCausalTransformer(**small, device="meta"), seed + 3),
        cfg=small)
    return launches


def time_train_step(cfg, seed) -> None:
    """A bf16 training step of the validation width with ``cfg``'s heads
    (GRAD_ACCUM microbatches of BATCH_SIZE x max_seq_len, a model made
    from ``seed``), after one untimed step: the host-clock median of 3
    steps, and the device time per step and its K1 and K2 shares from
    whole_rows over 2 steps."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.train import (
        BATCH_SIZE, GRAD_ACCUM, make_optimizer, train_step)

    h, d, s = cfg["heads"], cfg["dim_head"], cfg["max_seq_len"]
    torch.manual_seed(seed)
    trainee = CosineSimCausalTransformer(**cfg, dtype=torch.bfloat16,
                                         device="cuda")
    opt = make_optimizer(trainee)
    batch = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg["num_tokens"], (GRAD_ACCUM, BATCH_SIZE, s + 1))).cuda()
    train_step(trainee, opt, batch).item()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(trainee, opt, batch).item()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = statistics.median(walls)
    rows = whole_rows(lambda: train_step(trainee, opt, batch).item(), 2)
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    parts = {n: sum(t for key, t, _ in rows if n in key) / 1e3
             for n in ("fwd_", "dkdv_")}
    print(f"  heads {h} of {d}: a train step ({GRAD_ACCUM} x {BATCH_SIZE} x "
          f"{s}) {wall_ms:.2f} ms wall (median of 3), {busy_ms:.2f} ms device "
          f"(profiled over 2 steps; idle share {1 - busy_ms / wall_ms:.3f}), "
          f"K1 {parts['fwd_']:.2f} ms and K2 {parts['dkdv_']:.2f} ms of it")


def heads_256(card: str):
    """Phase 15: head dims up to 256.  The op's forward, one-pass backward
    and two-pass backward with an (h, i, j) bias at d 200 (the wrappers pad
    to 256) and 256, f32 and bf16, against plain; K4 and K5 at d 200 and
    256 (int8 and e4m3, ragged, empty and finished slots) against plain;
    K1, K2, K3a, K3b, K4 and K5 checked against plain and timed at d 256 at
    the shapes the heads-256 model gives them; that model (HEAD256_MODEL)
    served by both engines and trained, its bias-gradient path run, and
    card vs CPU in f32 at depth 2.  Returns ({kernel: max abs err},
    {kernel: timing row}, {kernel: launches})."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    worst = {"K1": 0.0, "K2": 0.0, "K3a": 0.0, "K3b": 0.0, "K4": 0.0,
             "K5": 0.0}
    op_widths_vs_plain(g, (200, 256), worst, lambda d: 256)
    decode_widths_vs_plain(g, (200, 256), worst)
    h = HEAD256_MODEL["heads"]
    rows = time_attention_at(card, g, 256, h, worst, (
        "fwd_mma_kernel<__nv_bfloat16, 256>",
        "dkdv_mma_kernel<__nv_bfloat16, 256, true>",
        "dkdv_mma_kernel<__nv_bfloat16, 256, false>",
        "dq_mma_kernel<__nv_bfloat16, 256>"))
    rows.update(time_decode_at(card, g, 256, h, worst))
    return worst, rows, model_path(HEAD256_MODEL, SEED + 23)


def heads_past_256(card: str):
    """Phase 16: head dims past 256, the wide route.  d 260 refused by
    every wrapper; the op's forward and both backward routes at d 264
    (padded to 384), 512 and 1032 (padded to 1152), f32 and bf16, against
    plain; K4 and K5 at d 264 and 512, and past 1024 (column blocks) at
    1032 and 2048, against plain; K1, K2, K3a, K3b, K4 and K5 checked
    against plain and timed at d 512 at the shapes the heads-512 model
    gives them, K4 and K5 at d 1032; that model (HEAD512_MODEL) served by
    both engines and trained, its bias-gradient path run, and card vs CPU
    in f32 at depth 2, and its training step timed; the 1-head-of-1032 model (HEAD1032_MODEL) served by
    both engines.  Returns (as heads_256, for d 512), ({kernel: max abs
    err}, {kernel: timing row}, {kernel: launches}) for d 1032."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_attention_backward, flash_cosine_sim_attention)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        init_cache, init_paged_cache, paged_decode_attention,
        quantized_decode_attention)

    g = torch.Generator(device="cuda").manual_seed(SEED + 27)
    # d 260: not a multiple of 8, refused, nothing launched
    q, k, v = (torch.randn(1, 2, 64, 260, device="cuda", generator=g)
               for _ in range(3))
    before = counts()
    refused = []
    for name, call in (
            ("op", lambda: flash_cosine_sim_attention(q, k, v, causal=True)),
            ("backward", lambda: flash_attention_backward(
                q, q, torch.ones(1, 2, 64, 1, device="cuda"), q, k, v, None,
                None, bias_batch_dim=False, scale=8.0, causal=True)),
            ("decode", lambda: quantized_decode_attention(
                q[:, :, 0], init_cache(1, 2, 64, 260, "cuda"))),
            ("paged decode", lambda: paged_decode_attention(
                q[:, :, 0], init_paged_cache(2, 2, 128, 260, 1, 1,
                                             device="cuda")))):
        try:
            call()
        except ValueError as err:
            if "multiple of 8" in str(err) or "multiples of 8" in str(err):
                refused.append(name)
    print(f"  d260 refused by: {', '.join(refused)}; launches unchanged: "
          f"{counts() == before}")
    if len(refused) != 4 or counts() != before:
        fail(f"d260: refused by {refused}, launches {before} -> {counts()}")

    worst = {"K1": 0.0, "K2": 0.0, "K3a": 0.0, "K3b": 0.0, "K4": 0.0,
             "K5": 0.0}
    op_widths_vs_plain(g, (264, 512, 1032), worst,
                       lambda d: f"{-(-d // 128) * 128}, the wide route")
    decode_widths_vs_plain(g, (264, 512), worst)
    wide_worst = dict(K4=0.0, K5=0.0)
    decode_past_1024(g, (1032, 2048), wide_worst)
    h = HEAD512_MODEL["heads"]
    rows = time_attention_at(card, g, 512, h, worst, (
        "fwd_wide_mma_kernel<__nv_bfloat16>",
        "dkdv_wide_mma_kernel<true>",
        "dkdv_wide_mma_kernel<false>",
        "dq_wide_mma_kernel"))
    rows.update(time_decode_at(card, g, 512, h, worst))
    wide_rows = time_decode_at(card, g, 1032, HEAD1032_MODEL["heads"],
                               wide_worst)
    launches = model_path(HEAD512_MODEL, SEED + 29)
    time_train_step(HEAD512_MODEL, SEED + 37)
    wide_launches = serve_decode_path(HEAD1032_MODEL, SEED + 33)
    return (worst, rows, launches), (wide_worst, wide_rows, wide_launches)


def greedy_reference(model, prompts, n, capacity, device="cuda"):
    """The target's greedy decode of every prompt at once: a right-padded
    prefill with the true lengths, then n - 1 decode_step argmaxes.
    Returns (tokens (p, n), the decode's top-2 logit margins (p, n), the
    logits of its first 4 steps (4, p, vocab) f32, the decode steps' wall
    times in ms)."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        decode_step, init_decode_state, prefill)

    tokens, lens = padded_prompts(prompts, device)
    state = init_decode_state(model, len(prompts), capacity, device=device)
    logits, state = prefill(model, state, tokens, true_len=lens)
    toks, margins, first, walls = [], [], [], []
    for i in range(n):
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        toks.append(logits.argmax(-1))
        if i + 1 == n:
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = decode_step(model, state, toks[-1])
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if i < 4:
            first.append(logits.float())
    return (torch.stack(toks, 1).cpu().numpy(),
            torch.stack(margins, 1).cpu().numpy(), torch.stack(first), walls)


def padded_prompts(prompts, device):
    """(tokens (p, longest) right-padded with 0, true lengths (p,) int32)."""
    width = max(len(x) for x in prompts)
    tokens = np.zeros((len(prompts), width), np.int64)
    for i, x in enumerate(prompts):
        tokens[i, :len(x)] = x
    lens = torch.tensor([len(x) for x in prompts], dtype=torch.int32,
                        device=device)
    return torch.from_numpy(tokens).to(device), lens


@contextlib.contextmanager
def plain_on_card():
    """Inside, the wrappers of K1 (the forward), K2/K3a/K3b (the op's
    backward), K4 (decode) and K7 take their plain versions on CUDA
    tensors too: the same model or op on the card with the kernels'
    references in their place.  Nothing is launched or counted there."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel, flash_attention as op, fwd_kernel)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        decode_kernel, weights)

    def forward(q, k, v, mask, bias, **kw):
        return fwd_kernel.flash_attention_forward_plain(q, k, v, mask, bias,
                                                        **kw)

    swaps = [(fwd_kernel, "_forward_cuda", forward),
             (op, "flash_attention_backward",
              bwd_kernel.flash_attention_backward_plain),
             (decode_kernel, "_decode_cuda",
              decode_kernel.decode_attention_plain),
             (weights, "_matmul_cuda", weights.quantized_matmul_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def margin_rule(label, streams, ref, margins):
    """Hold each stream to its row of the target's greedy decode ``ref``:
    equal up to its first divergence, where the decode's top-2 margin
    must be below MARGIN_BAR.  Returns {stream: first diverging index}."""
    first = {}
    for i, stream in enumerate(streams):
        n = min(len(stream), ref.shape[1])
        p = next((j for j in range(n) if stream[j] != ref[i, j]), None)
        if p is None:
            continue
        first[i] = p
        if not margins[i, p] < MARGIN_BAR:
            fail(f"{label}: stream {i} leaves the target's greedy decode at "
                 f"token {p}, where its top-2 margin is {margins[i, p]:.4f} "
                 f"(bar {MARGIN_BAR:g})")
    detail = ", ".join(f"stream {i} at token {p} (margin "
                       f"{margins[i, p]:.4f})" for i, p in first.items())
    print(f"  {label}: {len(first)} of {len(streams)} streams diverged from "
          f"the target's greedy decode{': ' + detail if detail else ''} "
          f"(margin bar {MARGIN_BAR:g})")
    return first


def spec_counters():
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        quantized_decode_attention)
    return flash_attention_forward, quantized_decode_attention


def run_spec_engine(label, target, draft, prompts, ref, margins):
    """SpeculativeEngine(SPEC_ENGINE) over ``prompts``: one admitted and
    a round run, then the rest; a slot finishes at SPEC_TOKENS tokens.
    K1 and K4 launches are read around this traffic (after a warm-up
    request) and checked per round; two rounds with every slot active are
    profiled, and their device time is set against the median wall of
    the unprofiled rounds with every slot active.  Tokens/s counts the
    unprofiled rounds only.  Every stream is held to the margin rule.
    Returns {first: each diverging stream's first divergence, short: the
    slot-rounds that emitted fewer than gamma, launches: (K1, K4)}."""
    from flash_cosine_sim_attention_tpu_torch.serving import (
        SpeculativeEngine)

    gamma, depth_t, depth_d = (SPEC_ENGINE["gamma"], target.depth,
                               draft.depth)
    engine = SpeculativeEngine(target, draft, **SPEC_ENGINE, seed=SEED,
                               device="cuda")
    warm, _ = engine.add_request(prompts[0][:60])
    engine.step_round()
    engine.finish(warm)
    k1, k4 = spec_counters()
    k1.launches = k4.launches = 0
    streams, records = {}, []
    # per round: (wall ms, tokens emitted, active slots, profiled)
    walls = []
    rounds = admitted = 0
    rows = None
    profiling = False

    def one_round():
        nonlocal rounds
        n_active = int(engine.active.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.step_round()
        walls.append((1e3 * (time.perf_counter() - t0),
                      sum(len(t) for t in out.values()), n_active,
                      profiling))
        rounds += 1
        for slot, toks in out.items():
            records.append((slot, len(streams[slot]), len(toks)))
            streams[slot].extend(toks)
        for slot in list(streams):
            if engine.active[slot] and len(streams[slot]) >= SPEC_TOKENS:
                engine.finish(slot)

    order = []
    for i, prompt in enumerate(prompts):
        slot, tok = engine.add_request(prompt)
        streams[slot] = [tok]
        order.append(slot)
        admitted += 1
        if i == 0:
            one_round()
    while engine.active.any():
        if rows is None and engine.active.sum() == len(prompts):
            profiling = True        # the profiler's host cost is in these
            rows = cuda_rows(one_round, 2)
            profiling = False
        else:
            one_round()
    launches = (k1.launches, k4.launches)
    want = (rounds * 2 * depth_t + admitted * (depth_t + depth_d),
            rounds * depth_d * gamma)
    per_slot = [streams[s] for s in order]
    first = margin_rule(label, per_slot, ref, margins)
    # rounds that emitted fewer than gamma tokens for an active slot
    short = [(order.index(s), at, n) for s, at, n in records if n < gamma]
    n_tok = sum(n for _, _, n in records)
    busy = sum(t for _, t, _ in rows) / 2e3
    k1_ms = sum(t for k, t, _ in rows if "fwd_mma_kernel<" in k) / 2e3
    k4_ms = sum(t for k, t, _ in rows
                if "decode_kernel<" in k and "paged" not in k) / 2e3
    plain = [(w, n, a) for w, n, a, prof in walls if not prof]
    full = [w for w, _, a in plain if a == len(prompts)]
    if not full:
        fail(f"{label}: no unprofiled round had all {len(prompts)} slots "
             f"active to set the profiled rounds' device time against")
    wall, full_wall = (statistics.median(w for w, _, _ in plain),
                       statistics.median(full))
    rate = sum(n for _, n, _ in plain) / (sum(w for w, _, _ in plain) / 1e3)
    print(f"  {label}: {rounds} rounds, {len(records)} slot-rounds, "
          f"{n_tok} tokens accepted, {n_tok / len(records):.3f} tokens a "
          f"slot a round (gamma {gamma}); round wall {wall:.3f} ms median "
          f"over {len(plain)} unprofiled rounds ({rate:.1f} tokens/s, their "
          f"tokens over their wall); with all {len(prompts)} slots active: "
          f"wall {full_wall:.3f} ms median of {len(full)} unprofiled rounds, "
          f"device time {busy:.3f} ms a round (2 profiled rounds), idle "
          f"share {1 - busy / full_wall:.3f}; K1 {k1_ms:.3f} ms and K4 "
          f"{k4_ms:.3f} ms a round")
    top = sorted(rows, key=lambda r: -r[1])[:5]
    print(f"  {label}: a round's largest device times (ms, launches): "
          + "; ".join(f"{k[:60]} {t / 2e3:.3f} ({c // 2})"
                      for k, t, c in top))
    print(f"  {label}: launches K1 {launches[0]} (want {want[0]} = "
          f"{rounds} rounds x 2 x depth {depth_t} + {admitted} admissions x "
          f"(depth {depth_t} + {depth_d})), K4 {launches[1]} (want "
          f"{want[1]} = {rounds} rounds x draft depth {depth_d} x gamma)")
    if launches != want:
        fail(f"{label}: launches {launches}, want {want}")
    require_kernels(rows, ("fwd_mma_kernel<__nv_bfloat16, 64>",
                           "decode_kernel<"), f"{label}, a round")
    return dict(first=first, short=short, launches=launches)


def check_verify_kernel(card: str):
    """K1 at the verify's shapes against plain: 4 queries of 8 slots x 8
    heads of 64 against 1024 keys masked by each slot's length (an empty
    slot included), and the 4 x 4 causal chunk, f32 and bf16; then the
    history call timed.  Returns (max err, timing row)."""
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)

    g = torch.Generator(device="cuda").manual_seed(SEED + 43)
    b, h, gq, cap, d = 8, 8, SPEC_ENGINE["gamma"], 1024, 64
    lengths = torch.tensor([0, 1, 60, 300, 500, 960, 1024, 7],
                           device="cuda")
    keep = torch.arange(cap, device="cuda")[None, :] < lengths[:, None]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        bar = F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR
        q, k = l2norm_tensors(
            torch.randn(b, h, gq, d, device="cuda", generator=g),
            torch.randn(b, h, cap, d, device="cuda", generator=g), groups=8)
        v = torch.randn(b, h, cap, d, device="cuda", generator=g)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        for name, args, causal in (
                ("q4 x k1024 key-masked by slot length", (q, k, v, keep),
                 False),
                ("4 x 4 causal chunk", (q, k[:, :, :gq], v[:, :, :gq], None),
                 True)):
            kw = dict(bias_batch_dim=False, scale=1.0, causal=causal)
            o, inv_l = flash_attention_forward(*args, None, **kw)
            o_p, inv_p = flash_attention_forward_plain(*args, None, **kw)
            torch.cuda.synchronize()
            err = (o.float() - o_p.float()).abs().max().item()
            l_err = ((inv_l - inv_p) / inv_p).abs().max().item()
            print(f"  K1 {name} (b8 h8 d64) {str(dtype)[6:]}: max|o-plain| "
                  f"{err:.3e} (bar {bar:g}), max rel inv_l err {l_err:.3e} "
                  f"(bar 1e-05)")
            if not (torch.isfinite(o.float()).all().item() and err <= bar
                    and l_err <= 1e-5):
                fail(f"K1 verify shape {name} {dtype}: o {err}, inv_l {l_err}")
            if not causal and (o[0].abs().max().item() != 0
                               or (inv_l[0] - 1e10).abs().max().item() > 1e4):
                fail("K1: the empty slot's rows must give o = 0, inv_l = 1e10")
            worst = max(worst, err)

    kw = dict(bias_batch_dim=False, scale=1.0, causal=False)
    call = lambda: flash_attention_forward(q, k, v, keep, None, **kw)  # noqa: E731
    ms = device_ms(call)
    plain_ms = device_ms(
        lambda: flash_attention_forward_plain(q, k, v, keep, None, **kw))
    lib_ms = library_ms("SDPA b8 h8 q4 x k1024 d64, key mask",
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=keep[:, None, None, :],
                            scale=1.0))
    visible = int(lengths.sum())
    flops = 4 * d * h * gq * visible
    # q and o, the k and v rows inside each slot's length, the mask, inv_l
    nbytes = ((2 * q.numel() + 2 * h * visible * d) * q.element_size()
              + keep.numel() + b * h * gq * 4)
    bound_ms, by = bound(flops, nbytes)
    print(f"  K1 verify history call b8 h8 q4 x k1024 d64 bf16 on {card}: "
          f"device time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})")
    return worst, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by, library_ms=lib_ms)


def spec_parity():
    """Card vs CPU at depth 2 in f32: a b = 1 greedy speculative_generate
    (depth-1 draft) gives equal tokens, and the batched verify's rows over
    a slot with history and an empty one agree within PARITY_BAR."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer, init_decode_state, prefill,
        speculative_generate)
    from flash_cosine_sim_attention_tpu_torch.models.speculative import (
        _verify_rows_batched)

    cfg, dcfg = dict(MODEL, depth=2), dict(MODEL, depth=1)
    params = random_flax_params(
        CosineSimCausalTransformer(**cfg, device="meta"), SEED + 45)
    dparams = random_flax_params(
        CosineSimCausalTransformer(**dcfg, device="meta"), SEED + 47)
    rng = np.random.default_rng(SEED + 49)
    prime = rng.integers(0, cfg["num_tokens"], (1, 100))
    chunk = rng.integers(0, cfg["num_tokens"], (2, SPEC_ENGINE["gamma"]))
    toks, rows = {}, {}
    for device in ("cuda", "cpu"):
        target = build_model(params, torch.float32, device, cfg)
        draft = build_model(dparams, torch.float32, device, dcfg)
        toks[device], _ = speculative_generate(
            target, draft, torch.from_numpy(prime), 16, 256,
            gamma=SPEC_ENGINE["gamma"], device=device)
        tokens, lens = padded_prompts([prime[0], prime[0, :1]], device)
        state = init_decode_state(target, 2, 256, device=device)
        _, state = prefill(target, state, tokens, true_len=lens)
        empty = torch.tensor([100, 0], dtype=torch.int32, device=device)
        state = state._replace(
            caches=tuple(c._replace(length=empty) for c in state.caches),
            pos=empty)
        out, _ = _verify_rows_batched(target, state,
                                      torch.from_numpy(chunk).to(device),
                                      None)
        rows[device] = out.float().cpu()
    diff = (rows["cuda"] - rows["cpu"]).abs().max().item()
    same = toks["cuda"].tolist() == toks["cpu"].tolist()
    print(f"  f32 depth 2 (draft depth 1): speculative_generate of 16 "
          f"tokens card vs CPU equal: {same}; verify rows (a slot with 100 "
          f"tokens of history, an empty one) max |logit diff| {diff:.3e} "
          f"(bar {PARITY_BAR:g})")
    if not (same and diff <= PARITY_BAR):
        fail(f"speculative parity: tokens equal {same}, verify rows {diff}")


def speculative(card: str):
    """Phase 17: speculative decoding of the validation model.  Returns
    (K1's max err at the verify shapes, its timing row, K1 launches on
    the main path: the depth-2 draft's engine run)."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer, generate_cached, init_decode_state,
        prefill, speculative_generate)
    from flash_cosine_sim_attention_tpu_torch.models.speculative import (
        _verify_rows_batched)

    err, row = check_verify_kernel(card)
    params = random_flax_params(
        CosineSimCausalTransformer(**MODEL, device="meta"), SEED)
    dparams = random_flax_params(
        CosineSimCausalTransformer(**SPEC_DRAFT, device="meta"), SEED + 41)
    target = build_model(params, torch.bfloat16, "cuda", MODEL)
    draft = build_model(dparams, torch.bfloat16, "cuda", SPEC_DRAFT)
    rng = np.random.default_rng(SEED + 42)
    vocab, cap = MODEL["num_tokens"], SPEC_ENGINE["capacity"]
    prompts = [rng.integers(0, vocab, n) for n in PROMPT_LENS]

    ref, margins, first_logits, dec_walls = greedy_reference(
        target, prompts, SPEC_TOKENS, cap)
    dec = statistics.median(dec_walls)
    print(f"  the target's greedy decode (prefill + decode_step argmax, "
          f"{len(prompts)} slots) on {card}: {dec:.3f} ms a step median, "
          f"{len(prompts) * 1e3 / dec:.1f} tokens/s")
    # verify rows against decode_step logits for the same 4 tokens, from a
    # second prefill of the same prompts (the verify appends in place)
    tokens, lens = padded_prompts(prompts, "cuda")
    state = init_decode_state(target, len(prompts), cap, device="cuda")
    _, state = prefill(target, state, tokens, true_len=lens)
    chunk = torch.from_numpy(ref[:, :SPEC_ENGINE["gamma"]]).cuda()
    rows, _ = _verify_rows_batched(target, state, chunk, None)
    dev = (rows.float().transpose(0, 1) - first_logits).abs().max().item()
    print(f"  verify rows vs decode_step logits for the same 4 tokens of "
          f"every prompt: max |diff| {dev:.4f} (must stay below the margin "
          f"bar {MARGIN_BAR:g})")
    if not dev < MARGIN_BAR:
        fail(f"verify vs decode logits differ by {dev}, past the margin bar")

    main = run_spec_engine("depth-2 draft", target, draft, prompts, ref,
                           margins)
    own = run_spec_engine("self-draft", target, target, prompts, ref,
                          margins)
    unexplained = [(i, at, n) for i, at, n in own["short"]
                   if at + n - 1 < SPEC_TOKENS
                   and at + n - 1 < own["first"].get(i, SPEC_TOKENS)
                   and not margins[i, at + n - 1] < MARGIN_BAR]
    print(f"  self-draft: {len(own['short'])} slot-rounds accepted fewer "
          f"than gamma, {len(own['short']) - len(unexplained)} of them at a "
          f"token under the margin bar or past the stream's divergence")
    if unexplained:
        fail(f"self-draft rejected proposals at clear margins: {unexplained}")

    toks, acc = speculative_generate(
        target, draft, torch.from_numpy(prompts[1])[None], SPEC_TOKENS, cap,
        gamma=SPEC_ENGINE["gamma"], device="cuda")
    margin_rule("b = 1 speculative_generate (depth-2 draft), "
                f"{acc:.3f} accepted a round", [toks[0].tolist()],
                ref[1:2], margins[1:2])
    cached = generate_cached(target, torch.from_numpy(prompts[2])[None], 32,
                             cap, filter_thres=0.999,
                             generator=torch.Generator(device="cuda").manual_seed(3),
                             device="cuda")
    margin_rule("generate_cached of 32 tokens (top-k of 1)",
                [cached[0].tolist()], ref[2:3, :32], margins[2:3, :32])
    spec_parity()
    return err, row, main["launches"][0]


def rel_l2(x: torch.Tensor, y: torch.Tensor) -> float:
    """||x - y|| / ||y||."""
    x, y = x.float(), y.float()
    return ((x - y).norm() / y.norm()).item()


def tp_counters():
    """K1, K2, K4 and K7's launch counters, in that order."""
    from flash_cosine_sim_attention_tpu_torch.ops import bwd_kernel as bk
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        quantized_decode_attention, quantized_matmul)
    return (flash_attention_forward, bk.fused_bwd_kernel,
            quantized_decode_attention, quantized_matmul)


def tp_launches():
    return dict(zip(("k1", "k2", "k4", "k7"),
                    (c.launches for c in tp_counters())))


def tp_reset():
    for c in tp_counters():
        c.launches = 0


def tp_serve(mesh, depth: int):
    """Phase 18 (a), on one rank: the production model (int8 weights,
    fused QKV) at ``depth`` served by InferenceEngine over ``mesh`` (8
    slots, capacity 2048; a warm-up request, then 8 prompts of TP_PROMPT
    tokens and TP_STEPS steps, near-greedy), the logits it sampled from
    recorded; rank 0 first serves the same traffic on one device (TP 1).
    Returns numpy results and this rank's launches around the TP traffic."""
    import copy

    import torch.distributed as dist

    from flash_cosine_sim_attention_tpu_torch.models import (
        fuse_qkv_params, quantize_params)
    from flash_cosine_sim_attention_tpu_torch.serving import InferenceEngine

    class Recording(InferenceEngine):
        """InferenceEngine that keeps the logits it samples from."""

        def _sample(self, logits):
            self.logits.append(logits.float().cpu().numpy())
            return super()._sample(logits)

    rank = dist.get_rank()
    model = fuse_qkv_params(quantize_params(
        build_prod_model(torch.bfloat16, "cuda", depth=depth)))
    vocab = PROD_MODEL["num_tokens"]

    def traffic(engine, timed):
        rng = np.random.default_rng(SEED + 60)
        engine.logits = []
        engine.finish(engine.add_request(rng.integers(0, vocab, 60)))
        engine.logits = []
        if timed:
            tp_reset()
        streams, ttft, walls = [], [], []
        for _ in range(PROD_ENGINE["num_slots"]):
            prompt = rng.integers(0, vocab, TP_PROMPT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot = engine.add_request(prompt)
            torch.cuda.synchronize()
            ttft.append(1e3 * (time.perf_counter() - t0))
            streams.append([int(engine.last_token[slot])])
        launches = tp_launches()
        for _ in range(TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.step()
            walls.append(1e3 * (time.perf_counter() - t0))
            for slot, tok in out.items():
                streams[slot].append(tok)
        prefill_rows = np.concatenate(engine.logits[:len(streams)])
        step_rows = np.stack(engine.logits[len(streams):])
        res = dict(tokens=np.array(streams), prefill=prefill_rows,
                   steps=step_rows, ttft=ttft, walls=walls,
                   prefill_launches=launches)
        if timed:
            res["launches"] = tp_launches()
            rows = cuda_rows(engine.step, 2)
            res["step_busy_ms"] = sum(t for _, t, _ in rows) / 2e3
            res["step_top"] = [(k[:60], t / 2e3, c // 2) for k, t, c in
                               sorted(rows, key=lambda r: -r[1])[:6]]
        return res

    kw = dict(PROD_ENGINE, temperature=1e-4, seed=SEED, device="cuda")
    out = {}
    if rank == 0:
        ref_model = copy.deepcopy(model)
        out["tp1"] = traffic(Recording(ref_model, **kw), False)
        del ref_model
        torch.cuda.empty_cache()
    dist.barrier()
    engine = Recording(model, mesh=mesh, **kw)
    out["local_kv_heads"] = engine.state.caches[0].k8.shape[1]
    out["tp"] = traffic(engine, True)
    return out


def tp_train(mesh):
    """Phase 18 (b), on one rank: the validation model (float32
    parameters) from one set of weights, TP 1 (the trainer's train_step)
    against TP 2 (make_sharded_train_step, clip 0.5 as the trainer's): one
    step in float32 compute, its loss and every gradient compared, then
    TP_TRAIN_STEPS steps in bf16 compute, their losses and the first
    step's gradients compared; bf16's own gradient error is read against
    the float32 step.  Returns errors, losses and this rank's K1 and K2
    launches around the TP steps."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.parallel import (
        local_shard, make_sharded_train_step, param_shardings, shard_params)
    from flash_cosine_sim_attention_tpu_torch.train import (
        MAX_GRAD_NORM, make_optimizer, train_step)

    torch.manual_seed(SEED + 50)
    weights = CosineSimCausalTransformer(**MODEL, device="cuda").state_dict()
    batch = torch.from_numpy(np.random.default_rng(SEED + 51).integers(
        0, MODEL["num_tokens"], (1, 4, MODEL["max_seq_len"] + 1))).cuda()

    def model(dtype):
        m = CosineSimCausalTransformer(**MODEL, dtype=dtype, device="cuda")
        m.load_state_dict(weights)
        return m

    def grads(m):
        return {n: p.grad.detach().clone() for n, p in m.named_parameters()}

    refs = {}
    for dtype, steps in ((torch.float32, 1), (torch.bfloat16, TP_TRAIN_STEPS)):
        ref = model(dtype)
        opt = make_optimizer(ref)
        losses = []
        for s in range(steps):
            losses.append(train_step(ref, opt, batch).item())
            if s == 0:
                first = grads(ref)
        refs[dtype] = (losses, first)
    tp_reset()
    out = {}
    for dtype, steps in ((torch.float32, 1), (torch.bfloat16, TP_TRAIN_STEPS)):
        tp = shard_params(model(dtype), mesh)
        step = make_sharded_train_step(tp, make_optimizer(tp), mesh,
                                       max_grad_norm=MAX_GRAD_NORM)
        losses = []
        for s in range(steps):
            losses.append(step(batch).item())
            if s == 0:
                got = grads(tp)
        specs = param_shardings(tp, mesh)
        want = {n: local_shard(g, mesh, specs[n])
                for n, g in refs[dtype][1].items()}
        f32 = {n: local_shard(g, mesh, specs[n])
               for n, g in refs[torch.float32][1].items()}
        out[str(dtype)[6:]] = dict(
            losses=losses, ref_losses=refs[dtype][0],
            grad_err=max(grad_err(got[n], want[n], dtype) for n in got),
            rel_l2=max(rel_l2(got[n], want[n]) for n in got),
            rel_l2_f32=max(rel_l2(got[n], f32[n]) for n in got))
    # bf16's own distance from the float32 gradients, at TP 1
    f32 = refs[torch.float32][1]
    out["bf16_floor_rel_l2"] = max(rel_l2(refs[torch.bfloat16][1][n], f32[n])
                                   for n in f32)
    out["launches"] = tp_launches()
    return out


def tp_time(mesh):
    """Phase 18 (c), on one rank: head_sharded_flash_attention at phase
    13's prefill shape (b1 h16 s1024 d128 causal bf16) and
    head_sharded_decode_attention at its decode shape (b8 h16 d128, 1060
    of 2048 tokens a slot, this rank's 8 heads of the cache), CUDA-event
    time of the whole calls on both ranks at once; the gathered outputs
    against the unsharded ops on the same inputs; then, one rank at a
    time, K1 and K4 on the local shard, and on rank 0 the whole op's
    plain version and SDPA."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch import (
        flash_cosine_sim_attention, l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)
    from flash_cosine_sim_attention_tpu_torch.parallel import (
        DATA_AXIS, MODEL_AXIS, head_sharded_decode_attention,
        head_sharded_flash_attention, local_shard, shard_cache, sharding)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        append, init_cache, quantized_decode_attention)

    g = torch.Generator(device="cuda").manual_seed(SEED + 52)
    h, d = PROD_MODEL["heads"], PROD_MODEL["dim_head"]
    q, k = l2norm_tensors(torch.randn(1, h, 1024, d, device="cuda",
                                      generator=g),
                          torch.randn(1, h, 1024, d, device="cuda",
                                      generator=g))
    v = torch.randn(1, h, 1024, d, device="cuda", generator=g)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    kw = dict(causal=True, scale=1.0, l2norm_qk=False)
    attn = lambda: head_sharded_flash_attention(q, k, v, mesh, **kw)  # noqa: E731
    err = (attn().float() - flash_cosine_sim_attention(q, k, v, **kw).float()
           ).abs().max().item()
    attn_ms = event_ms(attn, iters=20)
    b, cap, live = PROD_ENGINE["num_slots"], PROD_ENGINE["capacity"], 1060
    kc = l2norm_tensors(torch.randn(b, h, live, d, device="cuda", generator=g))
    vc = torch.randn(b, h, live, d, device="cuda", generator=g)
    cache = append(init_cache(b, h, cap, d, "cuda"), kc, vc)
    qd = l2norm_tensors(torch.randn(b, h, d, device="cuda", generator=g)
                        ).to(torch.bfloat16)
    local_cache = shard_cache(cache, mesh)
    dec = lambda: head_sharded_decode_attention(  # noqa: E731
        qd, local_cache, mesh, scale=1.0, l2norm_qk=False)
    dec_err = (dec().float() - quantized_decode_attention(
        qd, cache, scale=1.0, l2norm_qk=False).float()).abs().max().item()
    dec_ms = event_ms(dec, iters=20)
    out = dict(err=err, dec_err=dec_err, attn_ms=attn_ms, dec_ms=dec_ms)
    spec = sharding(mesh, DATA_AXIS, MODEL_AXIS, None, None)
    ql, kl, vl = (local_shard(t, mesh, spec).contiguous() for t in (q, k, v))
    qdl = local_shard(qd, mesh, sharding(mesh, DATA_AXIS, MODEL_AXIS, None)
                      ).contiguous()
    fkw = dict(bias_batch_dim=False, scale=1.0, causal=True)
    for turn in range(dist.get_world_size()):
        dist.barrier()   # one rank at a time on the card
        if turn != dist.get_rank():
            continue
        out["local_ms"] = device_ms(
            lambda: flash_attention_forward(ql, kl, vl, None, None, **fkw))
        out["local_dec_ms"] = device_ms(lambda: quantized_decode_attention(
            qdl, local_cache, scale=1.0, l2norm_qk=False))
        if turn == 0:   # the full op's plain version and SDPA
            out["plain_ms"] = device_ms(lambda: flash_attention_forward_plain(
                q, k, v, None, None, **fkw))
            out["sdpa_ms"] = library_ms(
                "SDPA b1 h16 s1024 d128", lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=1.0))
    dist.barrier()
    return out


def world_rank(rank: int, world: int, workdir: str, backend: str, body,
               args, node: tuple = None) -> None:
    """One rank of a world spawned on the one card (phases 17-22): every
    rank on device 0 over gloo, rank r on device r over NCCL (which takes
    one rank a device), the process group over ``backend`` with a file
    rendezvous in ``workdir``, or with ``node`` = (ranks a node, port) as
    multi-host nodes through initialize_distributed at localhost:port
    (rank r is local rank r % L of node r // L); with ``backend`` None no
    process group (a fresh process on device 0); runs ``body(*args)`` and
    writes its result, or its traceback, into ``workdir``."""
    import datetime
    import os
    import pickle
    import traceback

    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        torch.zeros(1, device="cuda")
        if node is not None:
            from flash_cosine_sim_attention_tpu_torch.parallel import (
                initialize_distributed)
            local, port = node
            os.environ.update(LOCAL_RANK=str(rank % local),
                              LOCAL_WORLD_SIZE=str(local))
            initialize_distributed(f"localhost:{port}", world // local,
                                   rank // local, backend=backend)
            if dist.get_rank() != rank:
                raise RuntimeError(f"rank {rank} joined as {dist.get_rank()}")
        elif backend is not None:
            dist.init_process_group(
                backend, init_method=f"file://{workdir}/rendezvous",
                rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
        out = body(*args)
        with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
        if backend is not None:
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        with open(f"{workdir}/error{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(world: int, backend: str, body, *args, node_ranks=None):
    """Run ``body(*args)`` on ``world`` spawned ranks (world_rank), with
    ``node_ranks`` as multi-host nodes of that many ranks at a port picked
    here; fail if any rank fails or the world outlives TP_TIMEOUT_S.
    Returns each rank's result.  ``run_world(1, None, body, ...)`` runs
    ``body`` alone in a fresh process."""
    import multiprocessing
    import pickle
    import tempfile
    from pathlib import Path

    import shutil

    workdir = Path(tempfile.mkdtemp(prefix="fcsa_world_"))
    ctx = multiprocessing.get_context("spawn")
    node = None
    if node_ranks is not None:
        from flash_cosine_sim_attention_tpu_torch.parallel.distributed import (
            free_port)
        node = (node_ranks, free_port())
    procs = [ctx.Process(target=world_rank, args=(r, world, str(workdir),
                                                  backend, body, args, node))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TP_TIMEOUT_S
    while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
           and not any(p.exitcode not in (None, 0) for p in procs)):
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join(timeout=60)
    errors = [f.read_text() for f in sorted(workdir.glob("error*.txt"))]
    if errors or any(p.exitcode != 0 for p in procs):
        fail(f"{body.__name__}: a world of {world} over {backend}: exit "
             f"codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
    out = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    shutil.rmtree(workdir)
    return out


def tp_body(depth: int):
    """Phase 18 on one rank: (a) at ``depth``, and with more than one rank
    (b) and (c), on a (1, world) mesh."""
    import torch.distributed as dist

    from flash_cosine_sim_attention_tpu_torch.parallel import make_mesh
    world = dist.get_world_size()
    mesh = make_mesh(world, model_parallel=world)
    out = dict(serve=tp_serve(mesh, depth))
    if world > 1:
        out["train"] = tp_train(mesh)
        out["time"] = tp_time(mesh)
    return out


def check_tp_serving(label, ranks, depth, card):
    """Hold phase 18 (a)'s TP streams and logits to rank 0's TP 1 ones:
    every rank's tokens equal, streams by the margin rule, logits by the
    relative L2 bars of phase 13 up to each stream's first divergence;
    launches as counted.  Returns (worst rel L2, launches per rank)."""
    ref, tp = ranks[0]["serve"]["tp1"], [r["serve"]["tp"] for r in ranks]
    for r, res in enumerate(tp[1:], 1):
        if not np.array_equal(res["tokens"], tp[0]["tokens"]):
            fail(f"{label}: rank {r}'s tokens differ from rank 0's")
    top2 = np.sort(np.concatenate([ref["prefill"][:, None], ref["steps"]
                                   .transpose(1, 0, 2)], axis=1), -1)
    margins = top2[..., -1] - top2[..., -2]
    first = margin_rule(f"{label}: TP streams vs TP 1", list(tp[0]["tokens"]),
                        ref["tokens"], margins)
    rel = [float(np.linalg.norm(tp[0]["prefill"] - ref["prefill"])
                 / np.linalg.norm(ref["prefill"]))]
    rows = [(s, j) for s in range(len(ref["tokens"]))
            for j in range(TP_STEPS) if j + 1 <= first.get(s, TP_STEPS)]
    a = np.stack([tp[0]["steps"][j, s] for s, j in rows])
    b = np.stack([ref["steps"][j, s] for s, j in rows])
    rel.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    print(f"  {label}: logits vs TP 1, rel L2: prefill {rel[0]:.3e} (bar "
          f"{QUANT_BARS[0]}), decode {rel[1]:.3e} over {len(rows)} "
          f"slot-steps before any divergence (bar {QUANT_BARS[1]})")
    if not (rel[0] < QUANT_BARS[0] and rel[1] < QUANT_BARS[1]):
        fail(f"{label}: logits vs TP 1 {rel}")
    passes = PROD_ENGINE["num_slots"] + TP_STEPS
    want = dict(k1=depth * PROD_ENGINE["num_slots"], k2=0,
                k4=depth * TP_STEPS, k7=passes * (4 * depth + 1))
    launches = [r["serve"]["tp"]["launches"] for r in ranks]
    for r, res in enumerate(tp):
        dec = statistics.median(res["walls"])
        busy = res["step_busy_ms"]
        print(f"  {label} rank {r} on {card}: TTFT median "
              f"{statistics.median(res['ttft']):.2f} ms ({TP_PROMPT}-token "
              f"prompts); decode step {dec:.3f} ms median over {TP_STEPS} "
              f"({8e3 / dec:.1f} tokens/s); device time {busy:.3f} ms a step "
              f"(2 profiled), idle share {1 - busy / dec:.3f}; launches "
              f"{launches[r]}")
        print(f"  {label} rank {r}: the step's largest device times (ms a "
              f"step, launches a step): " + "; ".join(
                  f"{k} {t:.3f} ({c})" for k, t, c in res["step_top"]))
        if launches[r] != want:
            fail(f"{label} rank {r}: launches {launches[r]}, want {want}")
    return max(rel), launches


def tensor_parallel(card: str):
    """Phase 18: tensor parallelism on the one card.  Returns the
    `parallel` entry of the kernels line."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world(TP_WORLD, "gloo", tp_body, PROD_MODEL["depth"])
    print(f"  a world of {TP_WORLD} ranks on the one card over gloo (CUDA "
          f"tensors), a (1, {TP_WORLD}) mesh, {time.perf_counter() - t0:.1f} "
          f"s; each rank's cache holds "
          f"{ranks[0]['serve']['local_kv_heads']} of "
          f"{PROD_MODEL['heads']} kv heads")
    rel, serve_launches = check_tp_serving(
        f"(a) 0.81B int8 fused QKV, TP {TP_WORLD}", ranks,
        PROD_MODEL["depth"], card)
    for r, res in enumerate(ranks):
        tr = res["train"]
        for dtype in ("float32", "bfloat16"):
            x = tr[dtype]
            dl = max(abs(a - b) for a, b in zip(x["losses"], x["ref_losses"]))
            print(f"  (b) rank {r}, validation model {dtype} compute, "
                  f"{len(x['losses'])} step(s) TP {TP_WORLD} vs TP 1: losses "
                  f"{', '.join(f'{v:.5f}' for v in x['losses'])} (TP 1 "
                  f"{', '.join(f'{v:.5f}' for v in x['ref_losses'])}), "
                  f"max |loss diff| {dl:.3e}; first step's gradients: "
                  f"worst {x['grad_err']:.3e} in GRAD_BARS units, worst rel "
                  f"L2 {x['rel_l2']:.3e}")
        f32, bf16 = tr["float32"], tr["bfloat16"]
        dl32 = abs(f32["losses"][0] - f32["ref_losses"][0])
        rel16 = max(abs(a - b) / abs(b) for a, b in
                    zip(bf16["losses"], bf16["ref_losses"]))
        print(f"  (b) rank {r}: bf16's own gradient error (TP 1 bf16 vs "
              f"float32 compute), worst rel L2 {tr['bf16_floor_rel_l2']:.3e}; "
              f"TP {TP_WORLD} bf16 vs float32 compute {bf16['rel_l2_f32']:.3e};"
              f" launches around the TP steps {tr['launches']}")
        if not (dl32 <= LOSS_BAR and f32["grad_err"] <= F32_ERR_BAR):
            fail(f"(b) rank {r}: float32 TP step vs TP 1: loss {dl32}, "
                 f"gradients {f32['grad_err']}")
        # bf16: TP 2 no farther from TP 1 than two runs each as far from
        # float32 as bf16 puts TP 1 (the triangle inequality's bound)
        if not (rel16 <= GRAD_BARS[torch.bfloat16]
                and bf16["rel_l2"] <= 2 * tr["bf16_floor_rel_l2"]):
            fail(f"(b) rank {r}: bf16 TP steps vs TP 1: loss rel {rel16}, "
                 f"gradient rel L2 {bf16['rel_l2']} against bf16's own "
                 f"{tr['bf16_floor_rel_l2']}")
        want = (1 + TP_TRAIN_STEPS) * MODEL["depth"]
        if (tr["launches"]["k1"], tr["launches"]["k2"]) != (want, want):
            fail(f"(b) rank {r}: launches {tr['launches']}, want K1 and K2 "
                 f"{want}")
    times = [r["time"] for r in ranks]
    for r, x in enumerate(times):
        print(f"  (c) rank {r} on {card}: head_sharded_flash_attention b1 h16 "
              f"s1024 d128 causal bf16 {x['attn_ms']:.4f} ms a call (CUDA "
              f"events, both ranks at once, the gather's gloo all_reduce "
              f"included); its K1 on the local 8 heads alone "
              f"{x['local_ms']:.4f} ms device time; "
              f"head_sharded_decode_attention b8 "
              f"h16 d128 (1060 of 2048 tokens) {x['dec_ms']:.4f} ms a call, "
              f"its K4 on 8 local heads {x['local_dec_ms']:.4f} ms; gathered "
              f"outputs vs the unsharded ops: attention max |diff| "
              f"{x['err']:.3e} (bar 0: the same tiles a head), decode "
              f"{x['dec_err']:.3e} (bar {BF16_ERR_BAR:g}: the split over the "
              f"cache may differ with the head count)")
        if not (x["err"] == 0.0 and x["dec_err"] <= BF16_ERR_BAR):
            fail(f"(c) rank {r}: the sharded ops differ from the unsharded "
                 f"ones by {x['err']} and {x['dec_err']}")
    print(f"  (c) the whole op on {card}, rank 0 alone: plain "
          f"{times[0]['plain_ms']:.4f} ms, SDPA {times[0]['sdpa_ms']:.4f} ms")
    t0 = time.perf_counter()
    nccl = run_world(1, "nccl", tp_body, 2)
    print(f"  a world of 1 over NCCL, (a) at depth 2: "
          f"{time.perf_counter() - t0:.1f} s")
    check_tp_serving("(a) over NCCL, world 1, depth 2", nccl, 2, card)
    pairs = 1024 * 1025 / 2 * PROD_MODEL["heads"]
    nbytes = 4 * 2 * 1024 * PROD_MODEL["heads"] * PROD_MODEL["dim_head"] \
        + 1024 * PROD_MODEL["heads"] * 4
    bound_ms, by = bound(4 * PROD_MODEL["dim_head"] * pairs, nbytes)
    rank_launches = [dict(
        serve={k: serve_launches[r][k] for k in ("k1", "k4", "k7")},
        train={k: ranks[r]["train"]["launches"][k] for k in ("k1", "k2")})
        for r in range(TP_WORLD)]
    errs = [ranks[r]["time"]["err"] for r in range(TP_WORLD)]
    return dict(
        name=f"parallel:tp{TP_WORLD}", route="cuda",
        source="flash_cosine_sim_attention_tpu_torch/parallel/"
               "sharded_attention.py",
        replaces="flash_cosine_sim_attention_tpu/parallel/"
                 "sharded_attention.py:26",
        launches=sum(sum(x["serve"].values()) + sum(x["train"].values())
                     for x in rank_launches),
        rank_launches=rank_launches, max_abs_err=max(errs),
        rank_errors=errs, ms=times[0]["attn_ms"],
        plain_ms=times[0]["plain_ms"], bound_ms=bound_ms, bound_by=by,
        library_ms=times[0]["sdpa_ms"])


def ring_counters():
    """The ring's kernels' launch counters (K1, K2, K3a, K3b) and the
    transport's."""
    from flash_cosine_sim_attention_tpu_torch.ops import bwd_kernel as bk
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.parallel import ppermute
    return dict(k1=flash_attention_forward, k2=bk.fused_bwd_kernel,
                k3a=bk.dq_kernel, k3b=bk.dkdv_kernel), ppermute


def ring_reset() -> None:
    counters, hop = ring_counters()
    for c in counters.values():
        c.launches = 0
    hop.calls = hop.bytes = 0


def ring_launches() -> dict:
    counters, hop = ring_counters()
    return dict({k: c.launches for k, c in counters.items()},
                hops=hop.calls, hop_bytes=hop.bytes)


def ring_inputs(n: int, dtype, h=RING_HEADS, kvh=RING_HEADS, d=RING_DIM,
                masked=False, seed=0):
    """q (1, h, n, d), k, v (1, kvh, n, d) and a key mask (1, n) or None,
    the same on every rank (one generator seed)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 70 + seed)
    q = torch.randn(1, h, n, d, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(1, kvh, n, d, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    mask = (torch.rand(1, n, device="cuda", generator=g) > 0.3) \
        if masked else None
    return q, k, v, mask


def head_chunks(h: int, kvh: int, n: int, m: int):
    """(query heads, their kv heads) slices whose (heads, n, m) f32 logits
    stay within PLAIN_LOGITS elements, whole kv groups in each."""
    group = h // kvh
    c = min(h, max(1, PLAIN_LOGITS // (n * m) // group) * group)
    return [(slice(i, i + c), slice(i // group, (i + c) // group))
            for i in range(0, h, c)]


def forward_plain_by_heads(q, k, v, mask, causal):
    """K1's plain version (scale 8, no bias) over head_chunks: (o, inv_l)."""
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward_plain)
    parts = [flash_attention_forward_plain(
        q[:, hq], k[:, hk], v[:, hk], mask, None, bias_batch_dim=False,
        scale=8.0, causal=causal)
        for hq, hk in head_chunks(q.shape[1], k.shape[1], q.shape[2],
                                  k.shape[2])]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


def backward_plain_by_heads(do, o, inv_l, q, k, v, mask, causal):
    """The backward's plain version (scale 8, no bias) over head_chunks:
    (dq, dk, dv); a chunk holds whole kv groups, so its dk, dv are whole."""
    from flash_cosine_sim_attention_tpu_torch.ops.bwd_kernel import (
        flash_attention_backward_plain)
    parts = [flash_attention_backward_plain(
        do[:, hq], o[:, hq], inv_l[:, hq], q[:, hq], k[:, hk], v[:, hk],
        mask, None, bias_batch_dim=False, scale=8.0, causal=causal)[:3]
        for hq, hk in head_chunks(q.shape[1], k.shape[1], q.shape[2],
                                  k.shape[2])]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


def ring_case(mesh, n: int, dtype, causal=True, model_axis=None, **kw):
    """Phase 19 on one rank: ring_flash_cosine_sim_attention on full
    (1, h, n, d) inputs over ``mesh``, the output and q/k/v gradients of
    sum(o^2) held on rank 0 against the unsharded fused op (its autograd
    Function where the ring composes a key mask with causality, which
    the public op refuses), and the output against K1's plain version
    on the unsharded inputs; this rank's launches and hops around the
    ring's forward and backward, and its place on the ring."""
    import torch.distributed as dist

    from flash_cosine_sim_attention_tpu_torch import (
        flash_cosine_sim_attention, l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.flash_attention import (
        _FusedAttention)
    from flash_cosine_sim_attention_tpu_torch.parallel import (
        ring_flash_cosine_sim_attention)

    q, k, v, mask = ring_inputs(n, dtype, **kw)

    def attend(ring):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        if ring:
            o = ring_flash_cosine_sim_attention(
                qq, kk, vv, mesh, mask=mask, causal=causal,
                model_axis=model_axis)
        elif mask is not None and causal:
            qn, kn = l2norm_tensors(qq, kk)
            o = _FusedAttention.apply(qn, kn, vv, mask, None, False, 8.0,
                                      True, None)
        else:
            o = flash_cosine_sim_attention(qq, kk, vv, mask=mask,
                                           causal=causal)
        return [o, *torch.autograd.grad(o.float().square().sum(),
                                        (qq, kk, vv))]

    ring_reset()
    got = attend(True)
    torch.cuda.synchronize()
    out = dict(launches=ring_launches(), seq_rank=mesh.get_local_rank("seq"),
               seq_size=mesh.size(mesh.mesh_dim_names.index("seq")),
               local_n=n // mesh.size(mesh.mesh_dim_names.index("seq")))
    if dist.get_rank() == 0:
        want = attend(False)
        out["errors"] = [
            ((a.float() - b.float()).abs().max().item(),
             max(1.0, b.float().abs().max().item()), rel_l2(a, b))
            for a, b in zip(got, want)]
        del want
        qn, kn = l2norm_tensors(q, k)
        plain = forward_plain_by_heads(qn, kn, v, mask, causal)[0]
        out["plain"] = ((got[0].float() - plain.float()).abs().max().item(),
                        rel_l2(got[0], plain))
        del plain
    del got
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def ring_time(mesh, n: int):
    """Phase 19 (a) timed, on one rank: ring_flash_cosine_sim_attention_local
    on this rank's shard of b1 h16 n d128 bf16 causal, both ranks at once:
    the forward's wall (host clock between synchronizes, started together
    after a barrier), forward and backward's wall, the share of the
    forward and backward spent in the transport (host clock around each
    ppermute, between synchronizes), and this rank's device time of a
    forward (torch.profiler); then, on rank 0 alone, the unsharded
    forward's plain version and SDPA."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward_plain)
    from flash_cosine_sim_attention_tpu_torch.parallel import (
        local_shard, ring_attention, ring_flash_cosine_sim_attention_local,
        sharding)

    q, k, v, _ = ring_inputs(n, torch.bfloat16)
    spec = sharding(mesh, None, None, "seq", None)
    ql, kl, vl = (local_shard(t, mesh, spec).contiguous().requires_grad_()
                  for t in (q, k, v))

    def fwd():
        return ring_flash_cosine_sim_attention_local(ql, kl, vl, mesh)

    def fwd_bwd():
        o = fwd()
        torch.autograd.grad(o.float().square().sum(), (ql, kl, vl))

    def walls(fn, iters):
        out = []
        for _ in range(iters):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    with torch.no_grad():
        fwd()
    fwd_bwd()
    res = dict(fwd_ms=walls(lambda: fwd().detach(), 5),
               fwd_bwd_ms=walls(fwd_bwd, 3))
    hop, spent = ring_attention.ppermute, []

    def timed_hop(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = hop(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return moved
    ring_attention.ppermute = timed_hop
    try:
        patched = walls(fwd_bwd, 3)
    finally:
        ring_attention.ppermute = hop
    res["transport_share"] = 1e3 * sum(spent) / sum(patched)
    res["hops_a_call"] = len(spent) // 3
    rows = cuda_rows(lambda: fwd().detach(), 2)
    res["device_ms"] = sum(t for _, t, _ in rows) / 2e3
    res["top"] = [(key[:50], t / 2e3, c // 2) for key, t, c in
                  sorted(rows, key=lambda r: -r[1])[:5]]
    del ql, kl, vl
    torch.cuda.empty_cache()
    dist.barrier()
    if dist.get_rank() == 0:   # the unsharded forward, rank 0 alone
        qn, kn = l2norm_tensors(q, k)
        res["plain_ms"] = device_ms(lambda: flash_attention_forward_plain(
            qn, kn, v, None, None, bias_batch_dim=False, scale=8.0,
            causal=True), iters=2)
        torch.cuda.empty_cache()
        res["sdpa_ms"] = library_ms(
            f"SDPA b1 h{RING_HEADS} s{n} d{RING_DIM}",
            lambda: F.scaled_dot_product_attention(qn, kn, v, is_causal=True,
                                                   scale=8.0))
    dist.barrier()
    return res


def ring_body(part: str):
    """Phase 19 on one rank: RING_CASES on the ``part`` mesh ("seq": a
    ("seq",) mesh of every rank; "model_seq": (model 2, seq 2)), then on
    the ("seq",) mesh (a) timed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if part == "seq":
        mesh = DeviceMesh("cuda", torch.arange(world),
                          mesh_dim_names=("seq",))
    else:
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(2, -1),
                          mesh_dim_names=("model", "seq"))
    out = {label: ring_case(mesh, n, dtype, causal=causal,
                            model_axis=None if part == "seq" else "model",
                            **kw)
           for label, on, n, dtype, causal, kw in RING_CASES if on == part}
    if part == "seq":
        out["time"] = ring_time(mesh, RING_SEQS[0])
    return out


def ring_label(label, n, dtype, kw) -> str:
    """A phase 19 case's name: its label, seq, kv heads under GQA, dtype."""
    kvh = kw.get("kvh", RING_HEADS)
    gqa = f" kvh {kvh}" if kvh != kw.get("h", RING_HEADS) else ""
    return f"{label} s{n}{gqa} {str(dtype)[6:]}"


def check_ring_case(label, ranks, dtype, causal) -> float:
    """Hold one phase 19 case: rank 0's output within JAX's ring bar of
    the unsharded op's (max |diff|), its gradients within JAX's gradient
    bar in phase 7's float32 units, max |diff| / max(1, max |g|): JAX's
    bars are absolute at shapes whose gradients stay below 1, and at the
    masked GQA shape here |dv| reaches ~10^2, where one bf16 ulp is 0.5;
    the output and every gradient also within RING_REL_L2 of the
    unsharded op's (relative L2); the output within the kernel bar
    (F32_ERR_BAR, BF16_ERR_BAR) and RING_REL_L2 of K1's plain version on
    the unsharded inputs; and every rank's launches and hops to what the
    schedule implies: a causal ring of size s gives its rank r r + 1 pair
    forwards and backwards (s (s + 1) / 2 in all), a non-causal one s
    each; the backward is K2 up to ONEPASS_BWD_MAX_SEQ local rows, K3a
    and K3b past it; s - 1 hops forward and s backward.  Returns the
    output's max |diff| from the plain version."""
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import (
        ONEPASS_BWD_MAX_SEQ)
    out_bar, grad_bar = RING_BARS[dtype]
    l2_bar = RING_REL_L2[dtype]
    plain_bar = F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR
    errs, (p_err, p_l2) = ranks[0]["errors"], ranks[0]["plain"]
    print(f"  {label}: vs the unsharded op on rank 0, max |diff| / max(1, "
          f"max |ref|) (rel L2): " + "; ".join(
              f"{name} {e:.3e} / {m:.3g} ({r:.3e})" for name, (e, m, r) in
              zip(("o", "dq", "dk", "dv"), errs))
          + f" (bars: {out_bar:g} on o's max |diff|, {grad_bar:g} on the "
          f"gradients' ratio, {l2_bar:g} on each rel L2); o vs K1's plain "
          f"version unsharded: max |diff| {p_err:.3e} (bar {plain_bar:g}), "
          f"rel L2 {p_l2:.3e}")
    if (errs[0][0] > out_bar or any(e / m > grad_bar for e, m, _ in errs[1:])
            or any(r > l2_bar for _, _, r in errs)):
        fail(f"{label}: ring vs the unsharded op {errs}")
    if not (p_err <= plain_bar and p_l2 <= l2_bar):
        fail(f"{label}: ring vs the plain forward: {p_err}, rel L2 {p_l2}")
    for r, res in enumerate(ranks):
        size, pairs = res["seq_size"], (res["seq_rank"] + 1 if causal
                                         else res["seq_size"])
        onepass = res["local_n"] <= ONEPASS_BWD_MAX_SEQ
        want = dict(k1=pairs, k2=pairs if onepass else 0,
                    k3a=0 if onepass else pairs, k3b=0 if onepass else pairs,
                    hops=2 * size - 1)
        got = {key: res["launches"][key] for key in want}
        print(f"  {label} rank {r} (seq rank {res['seq_rank']} of {size}): "
              f"launches and hops {got}, {res['launches']['hop_bytes']} "
              f"bytes sent")
        if got != want:
            fail(f"{label} rank {r}: {got}, want {want}")
    return p_err


def ring_pairs_vs_plain() -> None:
    """Phase 19's kernel calls at the ring's shapes, in this process,
    against their plain versions: for each of RING_CASES, the last seq
    rank's (on (model 2, seq 2), model rank 0's) pairs as the ring runs
    them (the diagonal causal, and key-masked where the case is; earlier
    shards non-causal), K1 then its backward (K2 at a local length up to
    ONEPASS_BWD_MAX_SEQ, K3a and K3b past it, read from the launch
    counters) on the global o and inv_l that the pairs merge to and a
    random dO.  K1's o within F32_ERR_BAR / BF16_ERR_BAR and its inv_l
    within 1e-5 relative (phase 3's bars), the gradients within
    GRAD_BARS (phase 7's)."""
    from flash_cosine_sim_attention_tpu_torch import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.ops.blocks import (
        EPS, ONEPASS_BWD_MAX_SEQ)
    from flash_cosine_sim_attention_tpu_torch.ops.bwd_kernel import (
        flash_attention_backward)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)

    kw = dict(bias_batch_dim=False, scale=8.0)
    for label, part, n, dtype, causal, inputs in RING_CASES:
        size = RING_WORLD if part == "seq" else 2
        tp = 1 if part == "seq" else 2
        q, k, v, mask = ring_inputs(n, dtype, **inputs)
        q, k, v = q[:, :q.shape[1] // tp], k[:, :k.shape[1] // tp], \
            v[:, :v.shape[1] // tp]
        qn, kn = l2norm_tensors(q, k)
        m, me = n // size, size - 1
        rows = lambda t, r: t[..., r * m:(r + 1) * m, :].contiguous()  # noqa: E731
        ql = rows(qn, me)
        pairs = [dict(g=g, k=rows(kn, g), v=rows(v, g), causal=causal and g == me,
                      mask=None if mask is None
                      else mask[:, g * m:(g + 1) * m].contiguous())
                 for g in range(size) if not causal or g <= me]
        bar = F32_ERR_BAR if dtype == torch.float32 else BF16_ERR_BAR
        o_acc = torch.zeros(ql.shape, device="cuda")
        l_acc = torch.zeros((*ql.shape[:3], 1), device="cuda")
        for p in pairs:
            o, inv_l = flash_attention_forward(ql, p["k"], p["v"], p["mask"],
                                               None, causal=p["causal"], **kw)
            o_p, inv_p = forward_plain_by_heads(ql, p["k"], p["v"], p["mask"],
                                                p["causal"])
            torch.cuda.synchronize()
            p["o_err"] = (o.float() - o_p.float()).abs().max().item()
            p["l_err"] = ((inv_l - inv_p) / inv_p).abs().max().item()
            if not (torch.isfinite(o.float()).all().item()
                    and p["o_err"] <= bar and p["l_err"] <= 1e-5):
                fail(f"K1 {label} pair ({me}, {p['g']}): o {p['o_err']}, "
                     f"inv_l {p['l_err']}")
            o_acc += o.float() / inv_l
            l_acc += 1.0 / inv_l
            del o_p, inv_p
        inv_l = 1.0 / l_acc.clamp_min(EPS)
        o = (o_acc * inv_l).to(dtype)
        g = torch.Generator(device="cuda").manual_seed(SEED + 90)
        do = torch.randn(o.shape, device="cuda", generator=g).to(dtype)
        del o_acc, l_acc
        for p in pairs:
            ring_reset()
            got = flash_attention_backward(do, o, inv_l, ql, p["k"], p["v"],
                                           p["mask"], None, causal=p["causal"],
                                           **kw)[:3]
            torch.cuda.synchronize()
            counts = ring_launches()
            ran = [name for key, name in (("k2", "K2"), ("k3a", "K3a"),
                                          ("k3b", "K3b")) if counts[key]]
            want = backward_plain_by_heads(do, o, inv_l, ql, p["k"], p["v"],
                                           p["mask"], p["causal"])
            errs = [grad_err(x, y, dtype) for x, y in zip(got, want)]
            finite = all(torch.isfinite(x.float()).all().item() for x in got)
            print(f"  {ring_label(label, n, dtype, inputs)} pair (seq rank "
                  f"{me}, shard {p['g']}, {'causal' if p['causal'] else 'non-causal'}"
                  f"{', key-masked' if p['mask'] is not None else ''}) "
                  f"b1 h{ql.shape[1]} kvh {p['k'].shape[1]} {m}x{m} "
                  f"d{ql.shape[3]}: K1 max|o-plain| {p['o_err']:.3e} (bar "
                  f"{bar:g}), max rel inv_l err {p['l_err']:.3e}; "
                  f"{'+'.join(ran)} vs plain: " + ", ".join(
                      f"{nm} {e:.2e}" for nm, e in zip(("dq", "dk", "dv"),
                                                        errs))
                  + f" (bar {GRAD_BARS[dtype]:g})")
            if ran != (["K2"] if m <= ONEPASS_BWD_MAX_SEQ else ["K3a", "K3b"]):
                fail(f"{label} pair backward ran {ran}")
            if not (finite and max(errs) <= GRAD_BARS[dtype]):
                fail(f"backward {label} pair ({me}, {p['g']}): {errs}, "
                     f"finite {finite}")
            del got, want
        del q, k, v, qn, kn, ql, pairs, o, do
        torch.cuda.empty_cache()


def ring_attention_phase(card: str, backend: str = "gloo"):
    """Phase 19: ring attention, its ranks on the one card over gloo, or
    with ``backend`` "nccl" a card a rank.  Returns the `parallel:ring`
    entry of the kernels line."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world(RING_WORLD, backend, ring_body, "seq")
    where = ("on the one card over gloo" if backend == "gloo"
             else "over NCCL, a card a rank")
    print(f"  a world of {RING_WORLD} ranks {where}, a (\"seq\",) mesh, "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    quad = run_world(4, backend, ring_body, "model_seq")
    print(f"  a world of 4 on a (model 2, seq 2) mesh, "
          f"{time.perf_counter() - t0:.1f} s")
    plain_errs = [check_ring_case(
        ring_label(label, n, dtype, kw),
        [r[label] for r in (ranks if part == "seq" else quad)], dtype, causal)
        for label, part, n, dtype, causal, kw in RING_CASES]
    if backend == "gloo":
        ring_pairs_vs_plain()
    times = [r["time"] for r in ranks]
    hops = ("gloo: device -> pinned host -> TCP -> host -> device"
            if backend == "gloo" else "NCCL: device to device")
    for r, x in enumerate(times):
        fwd, both = statistics.median(x["fwd_ms"]), statistics.median(
            x["fwd_bwd_ms"])
        print(f"  (a) timed, rank {r} on {card}: "
              f"ring_flash_cosine_sim_attention_local b1 h{RING_HEADS} "
              f"s{RING_SEQS[0]} d{RING_DIM} bf16 causal, local "
              f"{RING_SEQS[0] // RING_WORLD} rows: forward {fwd:.3f} ms wall "
              f"(both ranks at once), forward and backward {both:.3f} ms, "
              f"{x['hops_a_call']} hops in it, transport "
              f"{x['transport_share']:.3f} of it ({hops}); device time of a "
              f"forward {x['device_ms']:.3f} ms: " + "; ".join(
                  f"{k} {t:.3f} ({c})" for k, t, c in x["top"]))
    n, h, d = RING_SEQS[0], RING_HEADS, RING_DIM
    print(f"  (a) the unsharded forward on {card}, rank 0 alone: plain "
          f"{times[0]['plain_ms']:.3f} ms, SDPA {times[0]['sdpa_ms']:.4f} ms")
    bound_ms, by = bound(4 * d * n * (n + 1) / 2 * h,
                         4 * 2 * n * h * d + n * h * 4)
    rank_launches = [{key: r[case]["launches"][key]
                      for key in ("k1", "k2", "k3a", "k3b")}
                     for r in ranks + quad for case in r
                     if case.startswith("(")]
    # ms: the busiest rank's device time of (a)'s local forward; the wall
    # beside it is mostly the transport, and two ranks on one card share
    # its SMs: neither is a speed of the ring
    return dict(
        name="parallel:ring", route="cuda",
        source="flash_cosine_sim_attention_tpu_torch/parallel/"
               "ring_attention.py",
        replaces="flash_cosine_sim_attention_tpu/parallel/"
                 "ring_attention.py:201",
        launches=sum(sum(x.values()) for x in rank_launches),
        rank_launches=rank_launches, max_abs_err=max(plain_errs),
        ms=max(x["device_ms"] for x in times), ms_is="device time a rank",
        rank_device_ms=[x["device_ms"] for x in times],
        wall_ms=statistics.median(times[0]["fwd_ms"]), transport=backend,
        plain_ms=times[0]["plain_ms"], bound_ms=bound_ms, bound_by=by,
        library_ms=times[0]["sdpa_ms"])


def timed_loss(fn):
    """(``fn()``'s loss, its wall in ms from a synchronized start)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = fn().item()
    return loss, 1e3 * (time.perf_counter() - t0)


def train_step_refs(model, batch, kinds):
    """The trainer's train_step on one device from ``model(dtype)``, for
    each (dtype, steps) of ``kinds``: {dtype: (losses, the first step's
    gradients, walls)}."""
    from flash_cosine_sim_attention_tpu_torch.train import (
        make_optimizer, train_step)

    refs = {}
    for dtype, steps in kinds:
        ref = model(dtype)
        opt = make_optimizer(ref)
        losses, walls = [], []
        for s in range(steps):
            loss, wall = timed_loss(lambda: train_step(ref, opt, batch))
            losses.append(loss)
            walls.append(wall)
            if s == 0:
                first = {n: p.grad.detach().clone()
                         for n, p in ref.named_parameters()}
        refs[dtype] = (losses, first, walls)
        del ref, opt
    torch.cuda.empty_cache()
    return refs


def ref_errors(got, refs, dtype) -> dict:
    """The first step's full gradients ``got`` against train_step's
    (``train_step_refs``) in ``dtype``: GRAD_BARS units, max |diff|, rel
    L2, and rel L2 against the float32 gradients; with the reference
    losses and walls."""
    ref_losses, first, ref_walls = refs[dtype]
    f32 = refs[torch.float32][1]
    return dict(
        ref_losses=ref_losses, ref_walls=ref_walls,
        grad_err=max(grad_err(got[n], first[n], dtype) for n in got),
        abs_err=max((got[n] - first[n]).abs().max().item() for n in got),
        rel_l2=max(rel_l2(got[n], first[n]) for n in got),
        rel_l2_f32=max(rel_l2(got[n], f32[n]) for n in got))


def bf16_floor(refs) -> float:
    """bf16's own distance from float32 (worst rel L2 of train_step's
    first-step gradients)."""
    f32 = refs[torch.float32][1]
    return max(rel_l2(refs[torch.bfloat16][1][n], f32[n]) for n in f32)


def pipe_body():
    """Phase 20 on one rank: the validation model (float32 parameters)
    from one set of weights, rank 0's trainer train_step (4 microbatches
    of 4 x 1024) against make_pipeline_train_step over a (pipe 2) or
    (data 2, pipe 2) mesh (clip 0.5 as the trainer's): one step in
    float32 compute, its loss and every gradient (gathered from the
    stages) compared, and in a world of 2 TP_TRAIN_STEPS steps in bf16
    compute, their losses and the first step's gradients compared, bf16's
    own gradient error read against the float32 step; each step's wall,
    this rank's K1 and K2 launches, and the device time of one more bf16
    step."""
    import torch.distributed as dist

    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer, params_to_flax)
    from flash_cosine_sim_attention_tpu_torch.parallel import (
        make_pipeline_mesh, make_pipeline_train_step, shard_pipeline_params,
        split_pipeline_params, unshard_pipeline_params)
    from flash_cosine_sim_attention_tpu_torch.train import (
        GRAD_ACCUM, MAX_GRAD_NORM, make_optimizer)

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_pipeline_mesh(pipeline_parallel=PIPE_STAGES, device_type="cuda")
    torch.manual_seed(SEED + 80)
    weights = CosineSimCausalTransformer(**MODEL, device="cuda").state_dict()
    batch = torch.from_numpy(np.random.default_rng(SEED + 81).integers(
        0, MODEL["num_tokens"], (GRAD_ACCUM, 4, MODEL["max_seq_len"] + 1))
    ).cuda()
    flat = batch.reshape(-1, batch.shape[-1])
    kinds = ((torch.float32, 1),) + (
        ((torch.bfloat16, TP_TRAIN_STEPS),) if world == 2 else ())

    def model(dtype):
        m = CosineSimCausalTransformer(**MODEL, dtype=dtype, device="cuda")
        m.load_state_dict(weights)
        return m

    # the trainer's step on one device
    refs = train_step_refs(model, batch, kinds) if rank == 0 else {}
    dist.barrier()
    out = {}
    for dtype, steps in kinds:
        m = model(dtype)
        stage = shard_pipeline_params(m, *split_pipeline_params(
            m, params_to_flax(m), PIPE_STAGES), mesh)
        del m
        step = make_pipeline_train_step(stage, make_optimizer(stage), mesh,
                                        GRAD_ACCUM,
                                        max_grad_norm=MAX_GRAD_NORM)
        tp_reset()
        losses, walls = [], []
        for s in range(steps):
            dist.barrier()
            loss, wall = timed_loss(lambda: step(flat))
            losses.append(loss)
            walls.append(wall)
            if s == 0:
                got = unshard_pipeline_params(stage, mesh, lambda p: p.grad)
        res = dict(losses=losses, walls=walls, launches=tp_launches())
        if dtype == torch.bfloat16:
            rows = cuda_rows(lambda: step(flat), 1)
            res["busy_ms"] = sum(t for _, t, _ in rows) / 1e3
            res["top"] = [(key[:50], t / 1e3, c) for key, t, c in
                          sorted(rows, key=lambda r: -r[1])[:5]]
        if rank == 0:
            res.update(ref_errors(got, refs, dtype))
        out[str(dtype)[6:]] = res
        del stage, step, got
        torch.cuda.empty_cache()
    if rank == 0 and world == 2:
        out["bf16_floor_rel_l2"] = bf16_floor(refs)
    out["stage"] = mesh.get_local_rank("pipe")
    return out


def hold_to_train_step(label, what, r0) -> None:
    """Hold rank 0's ``what`` steps (``ref_errors`` per dtype) to the
    trainer's train_step: float32 at the f32 bars; bf16 losses at 2^-7
    relative and the first step's gradients no farther from train_step's
    than twice bf16's own distance from float32 (phase 18's rule)."""
    for dtype in ("float32", "bfloat16"):
        if dtype not in r0:
            continue
        x = r0[dtype]
        dl = max(abs(a - b) for a, b in zip(x["losses"], x["ref_losses"]))
        print(f"  {label}, {dtype} compute, {len(x['losses'])} step(s) vs "
              f"train_step: losses {', '.join(f'{v:.5f}' for v in x['losses'])}"
              f" (train_step {', '.join(f'{v:.5f}' for v in x['ref_losses'])})"
              f", max |loss diff| {dl:.3e}; first step's gradients: worst "
              f"{x['grad_err']:.3e} in GRAD_BARS units, max |diff| "
              f"{x['abs_err']:.3e}, worst rel L2 {x['rel_l2']:.3e}")
    f32 = r0["float32"]
    dl32 = abs(f32["losses"][0] - f32["ref_losses"][0])
    if not (dl32 <= LOSS_BAR and f32["grad_err"] <= F32_ERR_BAR):
        fail(f"{label}: float32 {what} step vs train_step: loss {dl32}, "
             f"gradients {f32['grad_err']}")
    if "bfloat16" in r0:
        bf16 = r0["bfloat16"]
        rel16 = max(abs(a - b) / abs(b) for a, b in
                    zip(bf16["losses"], bf16["ref_losses"]))
        print(f"  {label}: bf16's own gradient error (train_step bf16 vs "
              f"float32 compute), worst rel L2 {r0['bf16_floor_rel_l2']:.3e};"
              f" {what} bf16 vs float32 {bf16['rel_l2_f32']:.3e}")
        if not (rel16 <= GRAD_BARS[torch.bfloat16]
                and bf16["rel_l2"] <= 2 * r0["bf16_floor_rel_l2"]):
            fail(f"{label}: bf16 {what} steps vs train_step: loss rel "
                 f"{rel16}, gradient rel L2 {bf16['rel_l2']} against bf16's "
                 f"own {r0['bf16_floor_rel_l2']}")


def check_pipeline(label, ranks) -> None:
    """Hold phase 20's pipelined steps to rank 0's train_step: float32 at
    the f32 bars; bf16 losses at 2^-7 relative and the first step's
    gradients no farther from train_step's than twice bf16's own distance
    from float32 (phase 18's rule); every rank's K1 and K2 launches at
    GRAD_ACCUM microbatches x depth / PIPE_STAGES layers a step."""
    hold_to_train_step(label, "pipelined", ranks[0])
    from flash_cosine_sim_attention_tpu_torch.train import GRAD_ACCUM
    per_step = GRAD_ACCUM * MODEL["depth"] // PIPE_STAGES
    for r, res in enumerate(ranks):
        steps = sum(len(res[k]["losses"]) for k in ("float32", "bfloat16")
                    if k in res)
        got = {k: sum(res[d]["launches"][k] for d in ("float32", "bfloat16")
                      if d in res) for k in ("k1", "k2")}
        print(f"  {label} rank {r} (stage {res['stage']}): K1, K2 launches "
              f"{got} over {steps} steps ({per_step} each a step: "
              f"{GRAD_ACCUM} microbatches x "
              f"{MODEL['depth'] // PIPE_STAGES} layers)")
        if got != dict(k1=steps * per_step, k2=steps * per_step):
            fail(f"{label} rank {r}: launches {got}, want "
                 f"{steps * per_step} each")


def train_step_bound():
    """The least time of one training step of MODEL over GRAD_ACCUM
    microbatches of 4 x max_seq_len: its dense products (6 P T,
    embeddings being gathers) and its attention (forward 4 d, backward 10
    d a visible (query, key) pair and head) at the bf16 peak, against its
    float32 weights' bytes."""
    from flash_cosine_sim_attention_tpu_torch.train import GRAD_ACCUM
    dim, depth, n = MODEL["dim"], MODEL["depth"], MODEL["max_seq_len"]
    dense = depth * 12 * dim * dim + dim * MODEL["num_tokens"]
    seqs = GRAD_ACCUM * 4
    flops = 6 * dense * seqs * n + 14 * MODEL["dim_head"] * n * (n + 1) / 2 \
        * MODEL["heads"] * depth * seqs
    return bound(flops, 4 * (dense + (MODEL["num_tokens"] + n) * dim))


def pipeline_phase(card: str):
    """Phase 20: the GPipe pipeline on the one card.  Returns the
    `parallel:pipeline` entry of the kernels line."""
    from flash_cosine_sim_attention_tpu_torch.train import GRAD_ACCUM
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world(2, "gloo", pipe_body)
    print(f"  a world of 2 ranks on the one card over gloo, a (pipe 2) mesh,"
          f" {time.perf_counter() - t0:.1f} s")
    check_pipeline(f"(a) S {PIPE_STAGES}, M {GRAD_ACCUM}", ranks)
    for r, res in enumerate(ranks):
        x = res["bfloat16"]
        wall = statistics.median(x["walls"])
        print(f"  (a) rank {r} on {card}: a bf16 pipelined step "
              f"{wall:.2f} ms median wall over {len(x['walls'])} (both ranks"
              f" at once; {GRAD_ACCUM * 4 * MODEL['max_seq_len']} "
              f"tokens), device time {x['busy_ms']:.2f} ms (one step "
              f"profiled), idle share {1 - x['busy_ms'] / wall:.3f}: "
              + "; ".join(f"{k} {t:.3f} ({c})" for k, t, c in x["top"]))
    plain = statistics.median(ranks[0]["bfloat16"]["ref_walls"])
    print(f"  (a) train_step on one device, rank 0 alone: {plain:.2f} ms "
          f"median wall over {len(ranks[0]['bfloat16']['ref_walls'])}")
    t0 = time.perf_counter()
    quad = run_world(4, "gloo", pipe_body)
    print(f"  a world of 4 on a (data 2, pipe 2) mesh, "
          f"{time.perf_counter() - t0:.1f} s")
    check_pipeline("(b) data 2 x pipe 2, float32", quad)
    bound_ms, by = train_step_bound()
    rank_launches = [{k: sum(r[d]["launches"][k] for d in ("float32",
                                                           "bfloat16"))
                      for k in ("k1", "k2")} for r in ranks]
    return dict(
        name="parallel:pipeline", route="cuda",
        source="flash_cosine_sim_attention_tpu_torch/parallel/pipeline.py",
        replaces="flash_cosine_sim_attention_tpu/parallel/pipeline.py:253",
        launches=sum(sum(x.values()) for x in rank_launches),
        rank_launches=rank_launches,
        max_abs_err=ranks[0]["float32"]["abs_err"],
        # ms and plain_ms are walls of a step (two ranks on one card, the
        # hops through the host), not a speed of the pipeline
        ms=statistics.median(ranks[0]["bfloat16"]["walls"]), ms_is="wall",
        rank_device_ms=[r["bfloat16"]["busy_ms"] for r in ranks],
        plain_ms=plain, bound_ms=bound_ms, bound_by=by, library_ms=None)


def multihost_body():
    """Phase 21 on one rank of MH_NODES nodes of MH_LOCAL ranks: the
    (data, model) mesh of make_multihost_mesh(MH_LOCAL), the validation
    model (float32 parameters) trained through make_sharded_train_step,
    each node feeding only its own rows (GRAD_ACCUM microbatches of
    process_local_rows(4) rows, a numpy seed a node) through
    local_batch_to_global, against rank 0's train_step over the node-major
    concatenation from the same weights: one float32 step, TP_TRAIN_STEPS
    bf16 steps, each step's wall, this rank's K1 and K2 launches and the
    device time a step of MH_PROFILED more bf16 steps (whole_rows, every
    rank's windows alike); whether make_multihost_mesh refuses
    a model axis wider than a node."""
    import torch.distributed as dist

    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.parallel import (
        local_batch_to_global, make_multihost_mesh, make_sharded_train_step,
        param_shardings, process_local_rows, shard_params)
    from flash_cosine_sim_attention_tpu_torch.parallel.distributed import (
        process_count, process_index)
    from flash_cosine_sim_attention_tpu_torch.parallel.train import (
        _split_axis, _to_full)
    from flash_cosine_sim_attention_tpu_torch.train import (
        GRAD_ACCUM, MAX_GRAD_NORM, make_optimizer)

    rank, node = dist.get_rank(), process_index()
    mesh = make_multihost_mesh(MH_LOCAL)
    try:
        make_multihost_mesh(2 * MH_LOCAL)
        refused = None
    except ValueError as e:
        refused = str(e)
    torch.manual_seed(SEED + 90)
    weights = CosineSimCausalTransformer(**MODEL, device="cuda").state_dict()
    local_bs = process_local_rows(4)
    rows = [np.random.default_rng(SEED + 91 + p).integers(
        0, MODEL["num_tokens"], (GRAD_ACCUM, local_bs,
                                 MODEL["max_seq_len"] + 1))
        for p in range(process_count())]
    kinds = ((torch.float32, 1), (torch.bfloat16, TP_TRAIN_STEPS))

    def model(dtype):
        m = CosineSimCausalTransformer(**MODEL, dtype=dtype, device="cuda")
        m.load_state_dict(weights)
        return m

    refs = train_step_refs(model, torch.from_numpy(np.concatenate(
        rows, axis=1)).cuda(), kinds) if rank == 0 else {}
    dist.barrier()
    batch = local_batch_to_global(mesh, rows[node], batch_axis=1)
    per_node = mesh.size(0) // MH_NODES     # data ranks a node
    share = torch.from_numpy(rows[node]).chunk(per_node, dim=1)[
        mesh.get_local_rank("data") % per_node]
    out = dict(mesh=tuple(mesh.shape), refused=refused, node=node,
               local_bs=local_bs, global_shape=tuple(batch.shape),
               share_ok=torch.equal(batch.to_local().cpu(), share))
    for dtype, steps in kinds:
        m = shard_params(model(dtype), mesh)
        step = make_sharded_train_step(m, make_optimizer(m), mesh,
                                       max_grad_norm=MAX_GRAD_NORM)
        specs = param_shardings(m, mesh)
        tp_reset()
        losses, walls = [], []
        for s in range(steps):
            dist.barrier()
            loss, wall = timed_loss(lambda: step(batch))
            losses.append(loss)
            walls.append(wall)
            if s == 0:   # the full gradients, gathered over the model axis
                got = {n: (p.grad if _split_axis(specs[n]) is None else
                           _to_full(n, p.grad, m, mesh, specs[n])).clone()
                       for n, p in m.named_parameters()}
        res = dict(losses=losses, walls=walls, launches=tp_launches())
        if dtype == torch.bfloat16:
            prof = whole_rows(lambda: step(batch), MH_PROFILED,
                              group=dist.group.WORLD)
            res["busy_ms"] = sum(t for _, t, _ in prof) / 1e3
            res["top"] = [(key[:50], t / 1e3, c) for key, t, c in
                          sorted(prof, key=lambda r: -r[1])[:5]]
        if rank == 0:
            res.update(ref_errors(got, refs, dtype))
        out[str(dtype)[6:]] = res
        del m, step, got
        torch.cuda.empty_cache()
    if rank == 0:
        out["bf16_floor_rel_l2"] = bf16_floor(refs)
    return out


def multihost_phase(card: str):
    """Phase 21: multi-host training on the one card, MH_NODES nodes of
    MH_LOCAL ranks over gloo.  Returns the `parallel:multihost` entry of
    the kernels line."""
    from flash_cosine_sim_attention_tpu_torch.train import GRAD_ACCUM
    torch.cuda.empty_cache()
    world = MH_NODES * MH_LOCAL
    t0 = time.perf_counter()
    ranks = run_world(world, "gloo", multihost_body, node_ranks=MH_LOCAL)
    r0 = ranks[0]
    print(f"  {MH_NODES} nodes of {MH_LOCAL} ranks on the one card over gloo "
          f"(CUDA tensors), joined through initialize_distributed at a "
          f"localhost TCP store, mesh (data, model) {r0['mesh']}, "
          f"{time.perf_counter() - t0:.1f} s; each node fed "
          f"{r0['local_bs']} of {r0['global_shape'][1]} rows a microbatch")
    for r, res in enumerate(ranks):
        if not (res["share_ok"] and res["node"] == r // MH_LOCAL
                and res["mesh"] == (world // MH_LOCAL, MH_LOCAL)
                and res["global_shape"] == (GRAD_ACCUM, 4,
                                            MODEL["max_seq_len"] + 1)):
            fail(f"(a) rank {r}: node {res['node']}, mesh {res['mesh']}, "
                 f"global batch {res['global_shape']}, its rows its node's: "
                 f"{res['share_ok']}")
        if res["refused"] is None or "cross process" not in res["refused"]:
            fail(f"rank {r}: make_multihost_mesh({2 * MH_LOCAL}) with "
                 f"{MH_LOCAL} ranks a node did not refuse: {res['refused']}")
    print(f"  make_multihost_mesh({2 * MH_LOCAL}) with {MH_LOCAL} ranks a "
          f"node: ValueError on every rank ({r0['refused']})")
    hold_to_train_step(f"(a) {MH_NODES} x {MH_LOCAL}", "multi-host", r0)
    per_step = GRAD_ACCUM * MODEL["depth"]
    for r, res in enumerate(ranks):
        steps = sum(len(res[k]["losses"]) for k in ("float32", "bfloat16"))
        got = {k: sum(res[d]["launches"][k] for d in ("float32", "bfloat16"))
               for k in ("k1", "k2")}
        x = res["bfloat16"]
        wall = statistics.median(x["walls"])
        print(f"  (a) rank {r} (node {res['node']}): K1, K2 launches {got} "
              f"over {steps} steps ({per_step} each a step: {GRAD_ACCUM} "
              f"microbatches x {MODEL['depth']} layers); on {card} a bf16 "
              f"step {wall:.2f} ms median wall over {len(x['walls'])}, "
              f"device time {x['busy_ms']:.2f} ms (a step of "
              f"{MH_PROFILED} or more profiled), idle "
              f"share {1 - x['busy_ms'] / wall:.3f}: no speed ({world} ranks "
              f"share the card's SMs and gloo's host path): "
              + "; ".join(f"{k} {t:.3f} ({c})" for k, t, c in x["top"]))
        if got != dict(k1=steps * per_step, k2=steps * per_step):
            fail(f"(a) rank {r}: launches {got}, want {steps * per_step} "
                 f"each")
    plain = statistics.median(r0["bfloat16"]["ref_walls"])
    print(f"  (a) train_step on one device, rank 0 alone: {plain:.2f} ms "
          f"median wall over {len(r0['bfloat16']['ref_walls'])}")
    bound_ms, by = train_step_bound()
    rank_launches = [{k: sum(r[d]["launches"][k] for d in ("float32",
                                                           "bfloat16"))
                      for k in ("k1", "k2")} for r in ranks]
    return dict(
        name="parallel:multihost", route="cuda",
        source="flash_cosine_sim_attention_tpu_torch/parallel/distributed.py",
        replaces="flash_cosine_sim_attention_tpu/parallel/distributed.py:92",
        launches=sum(sum(x.values()) for x in rank_launches),
        rank_launches=rank_launches, max_abs_err=r0["float32"]["abs_err"],
        f32_launches={k: sum(r["float32"]["launches"][k] for r in ranks)
                      for k in ("k1", "k2")},
        # ms and plain_ms are walls of a step (four ranks on one card, the
        # collectives through the host), not a speed of multi-host
        ms=statistics.median(r0["bfloat16"]["walls"]), ms_is="wall",
        rank_device_ms=[r["bfloat16"]["busy_ms"] for r in ranks],
        plain_ms=plain, bound_ms=bound_ms, bound_by=by, library_ms=None)


def trainer_losses(out: str) -> dict:
    """{step: loss} of the trainer's "step N  loss X" lines."""
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step (\d+)  loss ([0-9.]+)", out, re.M)}


def multihost_nccl(card: str) -> None:
    """--multihost-nccl, on four cards: the trainer as MH_NODES torchrun
    nodes of MH_LOCAL ranks over NCCL (cards 0,1 and 2,3, --model-parallel
    MH_LOCAL, MH_NCCL_STEPS steps, a coordinator at a localhost port),
    its printed losses held at MH_NCCL_BAR to train_step's on card 0 over
    the same rows (each node's sampler seeded by seed + 1009 p, the rows
    concatenated node-major, as the trainer feeds them)."""
    import os
    import signal
    import tempfile

    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.parallel.distributed import (
        free_port)
    from flash_cosine_sim_attention_tpu_torch.train import (
        BATCH_SIZE, GRAD_ACCUM, make_optimizer, make_sampler, train_step)

    seed, n = 42, MODEL["max_seq_len"]        # the trainer's defaults
    local_bs = BATCH_SIZE // MH_NODES
    streams = [make_sampler(seed=seed + 1009 * p).stream(
        "train", GRAD_ACCUM * local_bs, n) for p in range(MH_NODES)]
    torch.manual_seed(seed)
    model = CosineSimCausalTransformer(
        num_tokens=256, dim=MODEL["dim"], depth=MODEL["depth"],
        max_seq_len=n, attn_scale=1.0, attn_l2norm_groups=8, pre_norm=True,
        dtype=torch.bfloat16, device="cuda")
    opt = make_optimizer(model)
    want = {}
    for step in range(MH_NCCL_STEPS):
        rows = np.concatenate([next(s).reshape(GRAD_ACCUM, local_bs, n + 1)
                               for s in streams], axis=1)
        loss = train_step(model, opt, torch.from_numpy(rows).cuda())
        if step % 10 == 0:
            want[step] = loss.item()
    del model, opt
    torch.cuda.empty_cache()
    port = free_port()
    logs, procs = [], []
    for p in range(MH_NODES):
        cards = ",".join(str(p * MH_LOCAL + i) for i in range(MH_LOCAL))
        log = tempfile.TemporaryFile("w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(MH_LOCAL), "-m",
             "flash_cosine_sim_attention_tpu_torch.train",
             "--num-processes", str(MH_NODES), "--process-id", str(p),
             "--coordinator", f"localhost:{port}",
             "--model-parallel", str(MH_LOCAL),
             "--steps", str(MH_NCCL_STEPS)],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=cards), stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True))
    t0 = time.perf_counter()
    deadline = time.monotonic() + MH_NCCL_TIMEOUT_S
    while (any(proc.poll() is None for proc in procs)
           and time.monotonic() < deadline and not any(
               proc.poll() not in (None, 0) for proc in procs)):
        time.sleep(0.5)
    for proc in procs:     # torchrun and its ranks, past the time limit
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for p, (proc, out) in enumerate(zip(procs, outs)):
        print(f"  node {p}: exit {proc.returncode}; last lines:\n    "
              + "\n    ".join(out.strip().splitlines()[-40:]))
        if proc.returncode != 0:
            fail(f"--multihost-nccl: node {p} exited {proc.returncode}")
    got = trainer_losses(outs[0])
    diffs = {k: abs(got.get(k, float("nan")) - v) for k, v in want.items()}
    print(f"  the trainer on {MH_NODES} nodes x {MH_LOCAL} cards over NCCL "
          f"({time.perf_counter() - t0:.1f} s, {card}): losses "
          f"{got}; train_step on one card over the same rows {want}; "
          f"|diff| {diffs} (bar {MH_NCCL_BAR:g})")
    if trainer_losses(outs[1]) or not all(d <= MH_NCCL_BAR
                                          for d in diffs.values()):
        fail(f"--multihost-nccl: losses {got} against one card's {want}")


def scale8(g, card: str) -> None:
    """K1 and the one-pass K2 in float32 at 8 l2norm groups and scale 8
    (b1 h8 s1024 d64 causal): logits reach 64, where JAX's bf16 split of a
    float32 product misses the 1e-4 bar on o.  o and the gradients are held
    to the plain versions at F32_ERR_BAR; inv_l at 1e-5 relative against
    the plain forward with exact products (float64, rounded to float32),
    or at twice the float32 plain version's own distance from it where
    that is larger: float32's rounding of a logit near 64 moves inv_l by
    ~1e-5."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain, l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)

    b, h, s, d = 1, 8, 1024, 64
    q, k = l2norm_tensors(torch.randn(b, h, s, d, device="cuda", generator=g),
                          torch.randn(b, h, s, d, device="cuda", generator=g),
                          groups=8)
    v, do = (torch.randn(b, h, s, d, device="cuda", generator=g)
             for _ in range(2))
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o, inv_l = flash_attention_forward(q, k, v, None, None, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, None, None, **kw)
    _, inv_x = flash_attention_forward_plain(q, k, v, None, None,
                                             mm=exact_mm, **kw)
    err = (o - o_p).abs().max().item()
    inv_bar = max(1e-5, 2 * max_rel(inv_p, inv_x))
    args = (do, o_p, inv_p, q, k, v, None, None)
    got = bk._backward_onepass(*args[:7], scale=8.0, causal=True)
    want = flash_attention_backward_plain(*args, **kw)
    grads = [grad_err(x, y, torch.float32) for x, y in zip(got, want)]
    print(f"  K1, K2 f32 at 8 groups and scale 8 (b{b} h{h} s{s} d{d} causal) "
          f"on {card}: max|o - plain| {err:.2e} (bar {F32_ERR_BAR:g}); inv_l "
          f"against exact products {max_rel(inv_l, inv_x):.2e} (bar "
          f"{inv_bar:.2e}: the plain version's own "
          f"{max_rel(inv_p, inv_x):.2e}), against the plain version "
          f"{max_rel(inv_l, inv_p):.2e}; dq, dk, dv "
          f"{', '.join(f'{e:.2e}' for e in grads)} (bar {F32_ERR_BAR:g})")
    if not (err <= F32_ERR_BAR and max_rel(inv_l, inv_x) <= inv_bar
            and max(grads) <= F32_ERR_BAR):
        fail(f"f32 at scale 8: o {err}, inv_l {max_rel(inv_l, inv_x)}, "
             f"gradients {grads}")


def split_check(g, card: str, d: int = 64, twopass: bool = True) -> None:
    """K1, the one-pass K2 and (with an (h, i, j) bias, ``twopass``) the
    two-pass K3a and K3b in float32 against the plain versions with the
    kernels' own split (mm=dot_tf32x3), at b4 h8 s128 d``d`` causal, 8
    l2norm groups and scale 8, held to SPLIT_BARS (at d 256
    SPLIT_BARS_D256, at d 512 SPLIT_BARS_D512; K3a on dq and db, K3b on
    dk and dv); the
    plain versions with JAX's bfloat16 split (mm=dot_f32x3) must read
    above the same bars against dot_tf32x3, else the check could not tell
    the two splits apart.  The chain is short: a long one (dK and dV sum every query)
    buries the split's error under the tensor cores' rounding of each sum
    toward zero."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain, l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import (
        dot_f32x3, dot_tf32x3)

    b, h, s = 4, 8, 128
    bars = {256: SPLIT_BARS_D256, 512: SPLIT_BARS_D512}.get(d, SPLIT_BARS)

    def randn(*shape):
        return torch.randn(*(shape or (b, h, s, d)), device="cuda",
                           generator=g)

    q, k = l2norm_tensors(randn(), randn(), groups=8)
    v, do = randn(), randn()
    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    o, inv_l = flash_attention_forward(q, k, v, None, None, **kw)
    o_t, inv_t = flash_attention_forward_plain(q, k, v, None, None,
                                               mm=dot_tf32x3, **kw)
    o_b, inv_b = flash_attention_forward_plain(q, k, v, None, None,
                                               mm=dot_f32x3, **kw)
    k1 = (o - o_t).abs().max().item()
    k1_b = (o_b - o_t).abs().max().item()
    args = (do, o_t, inv_t, q, k, v, None, None)
    got = bk._backward_onepass(*args[:7], scale=8.0, causal=True)
    want_t = flash_attention_backward_plain(*args, mm=dot_tf32x3, **kw)
    want_b = flash_attention_backward_plain(*args, mm=dot_f32x3, **kw)
    k2 = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
    k2_b = [grad_err(x, y, torch.float32)
            for x, y in zip(want_b[:3], want_t)]
    print(f"  against the dot_tf32x3 plain versions (b{b} h{h} s{s} d{d} "
          f"causal, groups 8, scale 8) on {card}: K1 o {k1:.2e}, the "
          f"dot_f32x3 (bf16 split) plain version {k1_b:.2e} (bar "
          f"{bars['K1']:g}; inv_l {max_rel(inv_l, inv_t):.2e} and "
          f"{max_rel(inv_b, inv_t):.2e}); K2 dq, dk, dv "
          f"{', '.join(f'{e:.2e}' for e in k2)}, the dot_f32x3 plain version "
          f"{', '.join(f'{e:.2e}' for e in k2_b)} (bar {bars['K2']:g})")
    if not (k1 <= bars["K1"] < k1_b
            and max(k2) <= bars["K2"] < max(k2_b)):
        fail(f"f32 split check d{d}: K1 {k1} (bf16 split {k1_b}), K2 {k2} "
             f"(bf16 split {k2_b})")
    if not twopass:
        return
    # the two-pass route on the same inputs with an (h, i, j) bias: K3a's
    # dq and db, K3b's dk and dv
    bias = 0.5 * randn(h, s, s)
    o_t, inv_t = flash_attention_forward_plain(q, k, v, None, bias,
                                               mm=dot_tf32x3, **kw)
    args = (do, o_t, inv_t, q, k, v, None, bias)
    got = bk._backward_twopass(*args, **kw)
    want_t = flash_attention_backward_plain(*args, mm=dot_tf32x3, **kw)
    want_b = flash_attention_backward_plain(*args, mm=dot_f32x3, **kw)
    k3 = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
    k3_b = [grad_err(x, y, torch.float32) for x, y in zip(want_b, want_t)]
    k3a, k3b = [k3[0], k3[3]], k3[1:3]
    k3a_b, k3b_b = [k3_b[0], k3_b[3]], k3_b[1:3]
    print(f"  the same with an (h,i,j) bias, two-pass: K3a dq, db "
          f"{', '.join(f'{e:.2e}' for e in k3a)}, the dot_f32x3 plain "
          f"version {', '.join(f'{e:.2e}' for e in k3a_b)} (bar "
          f"{bars['K3a']:g}); K3b dk, dv "
          f"{', '.join(f'{e:.2e}' for e in k3b)}, the dot_f32x3 plain "
          f"version {', '.join(f'{e:.2e}' for e in k3b_b)} (bar "
          f"{bars['K3b']:g})")
    if not (max(k3a) <= bars["K3a"] < max(k3a_b)
            and max(k3b) <= bars["K3b"] < max(k3b_b)):
        fail(f"f32 split check d{d}: K3a {k3a} (bf16 split {k3a_b}), K3b "
             f"{k3b} (bf16 split {k3b_b})")


def by_heads(fn, tensors, n: int) -> list:
    """``fn`` over slices of ``n`` heads (dim 1) of ``tensors``, one kv head
    to each query head, its outputs joined again: a plain version at seq
    16384 a few heads at a time, within the card's memory (each head's sums
    are its own)."""
    outs = [fn(*(t[:, i:i + n] for t in tensors))
            for i in range(0, tensors[0].shape[1], n)]
    return [None if parts[0] is None else torch.cat(parts, 1)
            for parts in zip(*outs)]


def long_chains(g, card: str, d: int = 64, cases=None) -> None:
    """K1, the one-pass K2 and the two-pass K3a and K3b in float32 over
    long chains, no bias, with v and dO' of mean 3 so that every term of O
    and dV has one sign: the tensor cores round each sum toward zero, and
    every kernel closes its chains every 256 keys or queries.  ``cases``
    are (heads, kv heads, seq, heads a plain call, backward routes); by
    default at d 64: b1 h2 s8192 causal (8192 keys for O and K3a's dQ,
    8192 queries for dK and dV), 8 query heads on 1 kv head at s1024 (G x
    seq_q 8192), both routes, and the float32 long-context step's own
    shape, b1 h8 s16384 causal (LONG_SEQ), where the backward takes the
    two-pass route only (past ONEPASS_BWD_MAX_SEQ): 16384 keys for K1's O
    and K3a's dQ, 16384 queries for K3b's dK and dV; its plain versions
    run 2 heads at a time (by_heads).  Held to the plain versions at
    F32_ERR_BAR (o, gradients) and inv_l at 1e-5 relative."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain, l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    kw = dict(bias_batch_dim=False, scale=8.0, causal=True)
    heads, both = MODEL["heads"], ("onepass", "twopass")
    if cases is None:
        cases = ((2, 2, 8192, 2, both), (8, 1, 1024, 8, both),
                 (heads, heads, LONG_SEQ, 2, ("twopass",)))
    for h, kvh, s, n, routes in cases:
        q, k = l2norm_tensors(randn(1, h, s, d), randn(1, kvh, s, d))
        v = randn(1, kvh, s, d) + 3
        o, inv_l = flash_attention_forward(q, k, v, None, None, **kw)
        o_p, inv_p = by_heads(
            lambda *t: flash_attention_forward_plain(*t, None, None, **kw),
            (q, k, v), n)
        err, err_l = (o - o_p).abs().max().item(), max_rel(inv_l, inv_p)
        do = randn(*o.shape) + 3
        args = (do, o_p, inv_p, q, k, v, None, None)
        want = by_heads(
            lambda *t: flash_attention_backward_plain(*t, None, None, **kw),
            args[:6], n)
        got3, grads3, grads, apart = None, [], [], []
        if "twopass" in routes:
            got3 = bk._backward_twopass(*args, **kw)[:3]
            grads3 = [grad_err(x, y, torch.float32)
                      for x, y in zip(got3, want)]
        if "onepass" in routes:
            got = bk._backward_onepass(*args[:7], scale=8.0, causal=True)
            grads = [grad_err(x, y, torch.float32) for x, y in zip(got, want)]
            if got3 is not None:
                apart = [grad_err(x, y, torch.float32)
                         for x, y in zip(got3, got)]
            del got
        print(f"  long chains, b1 h{h} kv heads {kvh} s{s} d{d} causal, v and "
              f"dO' of mean 3, on {card}: K1 o {err:.2e}, inv_l {err_l:.2e};"
              + (f" K2 dq, dk, dv {', '.join(f'{e:.2e}' for e in grads)};"
                 if grads else " K2 not on this route;")
              + (f" K3a dq, K3b dk, dv {', '.join(f'{e:.2e}' for e in grads3)}"
                 if grads3 else " K3a, K3b not run")
              + f" (bars {F32_ERR_BAR:g}, inv_l 1e-5)"
              + (f"; the two routes apart {', '.join(f'{e:.2e}' for e in apart)}"
                 if apart else ""))
        if not (err <= F32_ERR_BAR and err_l <= 1e-5
                and max(grads + grads3) <= F32_ERR_BAR):
            fail(f"f32 long chains h{h} s{s}: o {err}, inv_l {err_l}, "
                 f"gradients {grads}, two-pass {grads3}")
        del q, k, v, o, o_p, got3, want, args


def f32_step_kernels(d: int) -> dict:
    """A float32 step's attention kernels at head width ``d``, by the
    instance names that count for them (the FMA ones too, and the wide
    K2's name before it took K3b's template argument, for a reading of an
    earlier commit)."""
    return {
        "K1": ("fwd_tf32_kernel<", "fwd_kernel<float", "fwd_wide_tf32_kernel",
               "fwd_wide_kernel<float"),
        "K2": (f"dkdv_tf32_kernel<{d}>", f"dkdv_tf32_kernel<{d}, true>",
               f"dkdv_kernel<float, {d}, true>", "dkdv_wide_tf32_kernel<true>",
               "dkdv_wide_tf32_kernel(", "dkdv_wide_kernel<true>"),
        "K3a": ("dq_tf32_kernel<", "dq_kernel<float", "dq_wide_tf32_kernel",
                "dq_wide_kernel<float"),
        "K3b": (f"dkdv_tf32_kernel<{d}, false>",
                f"dkdv_kernel<float, {d}, false>", f"dkdv_kernel<float, {d}>",
                "dkdv_wide_tf32_kernel<false>", "dkdv_wide_kernel(",
                "dkdv_wide_kernel<false>"),
    }


LONG_SEQ = 16384   # the float32 long-context step's --seq-len (batch 1)


def instance_name(key: str) -> str:
    """A kernel's profiler key without its return type, namespace and
    parameters: "fwd_tf32_kernel<256, float>", "dq_wide_tf32_kernel" (a
    kernel that is no template has no "void " in its key)."""
    return re.sub(r"^(void )?(\(anonymous namespace\)::)?", "",
                  key).split("(")[0]


def step_parts(rows, d: int = 64) -> dict:
    """{kernel: (device ms, launches, instance names)} of
    f32_step_kernels(d) among a profiled step's whole_rows."""
    parts = {}
    for name, pats in f32_step_kernels(d).items():
        mine = [(key, t, c) for key, t, c in rows
                if any(p in key for p in pats)]
        parts[name] = (sum(t for _, t, _ in mine) / 1e3,
                       sum(c for _, _, c in mine),
                       sorted({instance_name(key) for key, _, _ in mine}))
    return parts


def f32_step_model(seq: int, batch: int, cfg=MODEL):
    """The model of ``cfg`` (the validation model by default) in float32
    (max_seq_len ``seq``), its optimizer and 4 batches of GRAD_ACCUM
    microbatches of ``batch`` x ``seq`` from phase 8's corpus: the
    trainer's --use-float32 --seq-len seq --batch-size batch."""
    from flash_cosine_sim_attention_tpu_torch.data import (
        TextSampler, synthetic_corpus)
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.train import (
        GRAD_ACCUM, make_optimizer)

    torch.manual_seed(SEED)
    model = CosineSimCausalTransformer(**dict(cfg, max_seq_len=seq),
                                       dtype=torch.float32, device="cuda")
    stream = TextSampler(synthetic_corpus(TRAIN_CORPUS_BYTES, seed=SEED),
                         train_frac=90 / 95, seed=SEED).stream(
                             "train", GRAD_ACCUM * batch, seq)
    batches = [torch.from_numpy(next(stream)).cuda().view(
        GRAD_ACCUM, batch, seq + 1) for _ in range(4)]
    return model, make_optimizer(model), batches


def f32_train_step(card: str) -> dict:
    """The validation model's training step in float32 (the trainer's
    --use-float32: float32 compute, 4 microbatches of 4 x 1024 of phase
    8's corpus): device time a step over 2 profiled steps (whole_rows), K1
    and K2's share of it and their launches a step.  ``python3
    chip_smoke.py --f32-step`` runs it alone, e.g. from a checkout of an
    earlier commit, for a reading before and after a change."""
    from flash_cosine_sim_attention_tpu_torch.train import (
        BATCH_SIZE, GRAD_ACCUM, train_step)

    model, opt, batches = f32_step_model(MODEL["max_seq_len"], BATCH_SIZE)
    losses = []

    def step():
        losses.append(train_step(model, opt, batches[len(losses) % 4]))

    for _ in range(2):
        step()
    rows = whole_rows(step, 2)
    total = sum(t for _, t, _ in rows) / 1e3
    parts = step_parts(rows)
    loss = [x.item() for x in losses]
    top = sorted(rows, key=lambda r: -r[1])[:4]
    print(f"  float32 train step (4 x 4 x 1024) on {card}: device time "
          f"{total:.2f} ms a step (2 steps profiled); K1 {parts['K1'][0]:.2f}"
          f" ms ({parts['K1'][0] / total:.3f}), {parts['K1'][1]} launches "
          f"{parts['K1'][2]}; K2 {parts['K2'][0]:.2f} ms "
          f"({parts['K2'][0] / total:.3f}), {parts['K2'][1]} launches "
          f"{parts['K2'][2]}; the largest kernels "
          + "; ".join(f"{key[:60]} {t / 1e3:.2f} ms ({c} launches)"
                      for key, t, c in top)
          + f"; losses {', '.join(f'{x:.4f}' for x in loss)}")
    if not np.all(np.isfinite(loss)):
        fail(f"float32 train step: losses {loss}")
    per_step = GRAD_ACCUM * MODEL["depth"]
    if parts["K1"][1] != per_step or parts["K2"][1] != per_step:
        fail(f"float32 train step: K1, K2 launches {parts['K1'][1]}, "
             f"{parts['K2'][1]} a step, want {per_step}")
    return dict(ms=total, k1_ms=parts["K1"][0], k2_ms=parts["K2"][0])


def f32_long_step(card: str, cfg=MODEL) -> dict:
    """The float32 training step at seq LONG_SEQ of the model of ``cfg``
    (the validation model by default; the trainer's --use-float32
    --seq-len 16384 --batch-size 1: GRAD_ACCUM microbatches of 1 x 16384
    of phase 8's corpus, max_seq_len 16384).  Past ONEPASS_BWD_MAX_SEQ
    query rows the backward takes the two-pass route, K3a and K3b.  The
    wrappers' counts are set to 0 before 2 warm-up steps (host-clock
    walls, ended by a synchronize) and read after them; then 2 steps are
    profiled (whole_rows): device time a step, K1's, K3a's and K3b's share,
    launches and TFLOP/s a step, the idle share (1 - device time / the
    second warm-up step's wall).  Fails unless K1, K3a and K3b ran their
    tensor-core instances at the model's head width (fwd_tf32_kernel<D, float>,
    dq_tf32_kernel<D>, dkdv_tf32_kernel<D, false> up to d 256; past it the
    wide route's fwd_wide_tf32_kernel<float>, dq_wide_tf32_kernel,
    dkdv_wide_tf32_kernel<false>) 32 times a step each and K2 never, and
    unless the losses are finite; the reading prints first.  ``python3
    chip_smoke.py --f32-long-step`` runs it alone, e.g. from a checkout of
    an earlier commit.  Returns the wrappers' launches over the 2 counted
    steps."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, fwd_kernel as fk)
    from flash_cosine_sim_attention_tpu_torch.train import (
        GRAD_ACCUM, train_step)

    d = cfg["dim_head"]
    model, opt, batches = f32_step_model(LONG_SEQ, 1, cfg)
    losses, walls = [], []

    def step():
        losses.append(train_step(model, opt, batches[len(losses) % 4]))

    wrappers = dict(k1=fk.flash_attention_forward, k2=bk.fused_bwd_kernel,
                    k3a=bk.dq_kernel, k3b=bk.dkdv_kernel)
    for fn in wrappers.values():
        fn.launches = 0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {key: fn.launches for key, fn in wrappers.items()}
    rows = whole_rows(step, 2)
    total = sum(t for _, t, _ in rows) / 1e3
    parts = step_parts(rows, d)
    loss = [x.item() for x in losses]
    top = sorted(rows, key=lambda r: -r[1])[:4]
    # the function's operations a call: 2 (K1), 3 (K3a), 4 (K3b) products
    # of 2d FLOPs per visible pair, over the model's heads
    pairs = cfg["heads"] * LONG_SEQ * (LONG_SEQ + 1) / 2
    flops = {name: n * 2 * d * pairs
             for name, n in (("K1", 2), ("K3a", 3), ("K3b", 4), ("K2", 5))}
    print(f"  float32 train step at seq {LONG_SEQ}, heads {cfg['heads']} of "
          f"{d} ({GRAD_ACCUM} x 1 x {LONG_SEQ}) on {card}: device time "
          f"{total:.2f} ms a step (2 steps profiled); wall {walls[1]:.2f} ms "
          f"(warm-up steps {', '.join(f'{w:.2f}' for w in walls)}), idle "
          f"share {1 - total / walls[1]:.3f}; "
          + "; ".join(f"{name} {ms:.2f} ms ({ms / total:.3f}), {n} launches"
                      f"{f', {tflops(flops[name] * n, ms):.1f} TFLOP/s' if n else ''}"
                      f" {names}"
                      for name in ("K1", "K3a", "K3b", "K2")
                      for ms, n, names in (parts[name],))
          + f"; wrapper launches over the 2 counted steps {launches}; the "
          "largest kernels "
          + "; ".join(f"{key[:60]} {t / 1e3:.2f} ms ({c} launches)"
                      for key, t, c in top)
          + f"; losses {', '.join(f'{x:.4f}' for x in loss)}")
    if not np.all(np.isfinite(loss)):
        fail(f"float32 train step at seq {LONG_SEQ}, d{d}: losses {loss}")
    per_step = GRAD_ACCUM * cfg["depth"]
    want = dict(k1=2 * per_step, k2=0, k3a=2 * per_step, k3b=2 * per_step)
    names = (([f"fwd_tf32_kernel<{d}, float>"], [f"dq_tf32_kernel<{d}>"],
              [f"dkdv_tf32_kernel<{d}, false>"]) if d <= 256 else
             (["fwd_wide_tf32_kernel<float>"], ["dq_wide_tf32_kernel"],
              ["dkdv_wide_tf32_kernel<false>"]))
    if (launches != want or parts["K2"][1] != 0
            or any(parts[name][1] != per_step for name in ("K1", "K3a", "K3b"))
            or (parts["K1"][2], parts["K3a"][2], parts["K3b"][2]) != names):
        fail(f"float32 train step at seq {LONG_SEQ}, d{d}: wrapper launches "
             f"{launches}, want {want}; profiled launches a step and "
             f"instances {parts}")
    return launches


def f32_head256_long_step(card: str) -> dict:
    """f32_long_step on the heads-256 model (HEAD256_MODEL: dim 512,
    depth 8, 2 heads of 256; the trainer's --use-float32 --seq-len 16384
    --batch-size 1 at that width): K1, K3a and K3b at d 256, 32 launches
    a step each.  ``python3 chip_smoke.py --f32-head256-long-step`` runs
    it alone."""
    return f32_long_step(card, HEAD256_MODEL)


def f32_head512_long_step(card: str) -> dict:
    """f32_long_step on the heads-512 model (HEAD512_MODEL: 1 head of 512;
    the trainer's --use-float32 --seq-len 16384 --batch-size 1 at that
    width): K1, K3a and K3b at b1 h1 s16384 d512 causal on the wide
    route's 3xTF32 instances (fwd_wide_tf32_kernel<float>, dq_wide_tf32_kernel,
    dkdv_wide_tf32_kernel<false>), 32 launches a step each, K2 none.
    ``python3 chip_smoke.py --f32-head512-long-step`` runs it alone, e.g.
    from a checkout of an earlier commit, whose FMA K3a and K3b it times
    before it fails."""
    return f32_long_step(card, HEAD512_MODEL)


F32_WIDE_DIMS = (192, 256)   # the widths above 128, where every f32
                             # attention kernel runs 3xTF32 too


def nan_kept(g, d: int) -> bool:
    """K1, the one-pass K2 and (with an (h, i, j) bias) the two-pass K3a
    and K3b in float32 at b1 h2 s200 d``d`` (not causal) with a NaN made
    on the card (0/0, 0x7FFFFFFF there) in q's row 5 of head 0 and in one
    entry of v: o, dq, dk, dv and dB must be NaN exactly where the plain
    versions' are (inv_l is not: 1 / max(l, 1e-10) takes the clamp's side
    of a NaN in the kernel)."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain, l2norm_tensors)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    def same_nans(got, want):
        return all(y.isnan().any() and torch.equal(x.isnan(), y.isnan())
                   for x, y in zip(got, want))

    q, k = l2norm_tensors(randn(1, 2, 200, d), randn(1, 2, 200, d))
    v = randn(1, 2, 200, d)
    nan = torch.zeros(1, device="cuda") / 0
    q[0, 0, 5, :] = nan
    v[0, 1, 7, 3] = nan
    kw = dict(bias_batch_dim=False, scale=8.0, causal=False)
    o, _ = flash_attention_forward(q, k, v, None, None, **kw)
    o_p, inv_p = flash_attention_forward_plain(q, k, v, None, None, **kw)
    do = randn(*o.shape)
    got = bk._backward_onepass(do, o_p, inv_p, q, k, v, None, scale=8.0,
                               causal=False)
    want = flash_attention_backward_plain(do, o_p, inv_p, q, k, v, None,
                                          None, **kw)
    bias = 0.5 * randn(2, 200, 200)
    o_b, inv_b = flash_attention_forward_plain(q, k, v, None, bias, **kw)
    args_b = (do, o_b, inv_b, q, k, v, None, bias)
    return bool(o_p.isnan().any() and not o_p.isnan().all()
                and torch.equal(o.isnan(), o_p.isnan())
                and same_nans(got, want)
                and same_nans(bk._backward_twopass(*args_b, **kw),
                              flash_attention_backward_plain(*args_b, **kw)))


def instance_names(work) -> list:
    """The port's kernels (no at::native one) that ``work`` launched, by
    instance name, over REQUIRE_ITERS calls."""
    return sorted({instance_name(key)
                   for key, _, _ in cuda_rows(work, REQUIRE_ITERS)
                   if "at::native" not in key})


def require_instances(label, work, want, banned, defer=None) -> list:
    """instance_names of ``work``; fails unless each name in ``want`` is
    among them and none holds a string of ``banned`` (with a ``defer``
    list, appends the failure to it instead)."""
    names = instance_names(work)
    missing = [n for n in want if not any(n in x for x in names)]
    bad = [x for x in names if any(b in x for b in banned)]
    if missing or bad:
        msg = (f"{label}: instances {names}; missing {missing}, not "
               f"expected {bad}")
        if defer is None:
            fail(msg)
        defer.append(msg)
    return names


def k1_f32(g, card: str, b: int, h: int, s: int, d: int, want, banned,
           qk_int8: bool = False, defer=None):
    """K1 with float32 v at b``b`` h``h`` s``s`` d``d`` causal (8 l2norm
    groups, scale 1; float32 q and k, or with ``qk_int8`` their int8
    codes): held to the exact plain version (F32_ERR_BAR; inv_l 1e-5
    relative) and to the plain version with the kernels' split
    (mm=dot_tf32x3: the codes are exact in TF32, so on the int8 arm it
    splits P and V only; TF32X3_BARS["K1"], ["K1 int8"]); run as ``want``
    by profiler name (none of ``banned``); timed beside its bound, the
    plain version and SDPA f32 (TF32 off, on the float q and k).  The
    bound: 3 x the operations at the TF32 tensor cores' peak (the FMA
    bound printed beside); on the int8 arm Q.K at the int8 peak and 3 x
    P.V at the TF32 one.  The instance check comes after the times are
    printed (``defer`` as in require_instances).  Returns (timing row,
    max|o - plain|)."""
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch.ops import l2norm_tensors
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward, flash_attention_forward_plain)
    from flash_cosine_sim_attention_tpu_torch.ops.flash_attention import (
        quantize_qk)
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3

    q, k = l2norm_tensors(
        torch.randn(b, h, s, d, device="cuda", generator=g),
        torch.randn(b, h, s, d, device="cuda", generator=g), groups=8)
    v = torch.randn(b, h, s, d, device="cuda", generator=g)
    kw = dict(bias_batch_dim=False, scale=1.0, causal=True)
    qk, extra = (q, k), {}
    if qk_int8:
        q8, k8, sdq = quantize_qk(q, k, "int8")
        qk, extra = (q8, k8), dict(s_dequant=sdq)
    call = lambda: flash_attention_forward(*qk, v, None, None, **extra, **kw)  # noqa: E731
    plain = lambda: flash_attention_forward_plain(*qk, v, None, None, **extra,  # noqa: E731
                                                  **kw)
    (o, inv_l), (o_p, inv_p) = call(), plain()
    err, err_l = (o - o_p).abs().max().item(), max_rel(inv_l, inv_p)
    label = (f"K1 f32 b{b} h{h} s{s} d{d} causal"
             + (", int8 q/k codes" if qk_int8 else ", groups 8, scale 1"))
    split_bar = TF32X3_BARS["K1 int8" if qk_int8 else "K1"]
    o_t, inv_t = flash_attention_forward_plain(*qk, v, None, None,
                                               mm=dot_tf32x3, **extra, **kw)
    err_t = max((o - o_t).abs().max().item(), max_rel(inv_l, inv_t))
    note = (f"; against the dot_tf32x3 plain version: o, inv_l "
            f"{err_t:.2e} (bar {split_bar:g})")
    ok = err <= F32_ERR_BAR and err_l <= 1e-5 and err_t <= split_bar
    print(f"  {label}: max|o - plain| {err:.2e} (bar {F32_ERR_BAR:g}), inv_l "
          f"{err_l:.2e} (bar 1e-5){note}")
    if not ok:
        fail(f"{label}: o {err}, inv_l {err_l}{note}")
    ms, plain_ms = device_ms(call), device_ms(plain)
    lib_ms = library_ms(f"SDPA f32 b{b} h{h} s{s} d{d}, TF32 off",
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, scale=1.0))
    pairs = b * h * s * (s + 1) / 2
    flops = 4 * d * pairs
    nbytes = (2 * qk[0].element_size() + 2 * 4) * q.numel() + b * h * s * 4
    fma_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
    if qk_int8:  # Q.K at the int8 peak, P.V as 3 TF32 products
        bound_ms, by = bound(
            flops / 2 * (3 + PEAK_TF32_FLOPS / PEAK_INT8_OPS), nbytes,
            PEAK_TF32_FLOPS)
        why = "Q.K at 1,979 TOP/s, P.V 3xTF32 at 495 TFLOP/s"
    else:
        bound_ms, by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        why = "3xTF32 at 495 TFLOP/s"
    why += f"; FMA bound {fma_ms:.5f} ms"
    names = instance_names(call)
    print(f"  {label} on {card}: device time kernel {ms:.4f} ms "
          f"({tflops(flops, ms):.2f} TFLOP/s of the function's), plain "
          f"{plain_ms:.4f} ms, SDPA f32 {lib_ms:.4f} ms (kernel / SDPA "
          f"{ms / lib_ms:.2f}), bound {bound_ms:.5f} ms ({by}, {why}); "
          f"instances {names}")
    require_instances(label, call, want, banned, defer)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms), err


def int8_op_f32(g, b: int, h: int, s: int, d: int, want, defer=None) -> int:
    """The public op with qk_int8 on float32 q, k, v at b``b`` h``h``
    s``s`` d``d`` causal (the op's defaults: scale 8, one l2norm group):
    its forward (K1's int8 arm with float32 v) and straight-through
    backward (the float32 K2 on the unquantized q and k) against the same
    op on the plain versions (plain_on_card), o and the q, k, v gradients
    at GRAD_BARS' float32 bar; run as ``want`` by profiler name, with no
    FMA or bf16 instance of K1.  Returns K1's launches over the op's
    call."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        flash_cosine_sim_attention)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)

    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=g)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def run():
        o = flash_cosine_sim_attention(*leaves, causal=True, qk_int8=True)
        return (o.detach(), *torch.autograd.grad(o, leaves, do))

    flash_attention_forward.launches = 0
    got = run()
    launches = flash_attention_forward.launches
    with plain_on_card():
        want_t = run()
    errs = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
    label = f"the qk_int8 op f32 b{b} h{h} s{s} d{d} causal"
    names = require_instances(label, run, want, [
        "fwd_kernel<", "fwd_wide_kernel", "fwd_mma_kernel",
        "fwd_wide_mma_kernel", "dkdv_kernel<", "dkdv_wide_kernel"], defer)
    print(f"  {label}, forward and straight-through backward against the "
          f"op on the plain versions: o, dq, dk, dv "
          f"{', '.join(f'{e:.2e}' for e in errs)} (bar "
          f"{GRAD_BARS[torch.float32]:g} of max(1, max|y|)); K1 launches "
          f"{launches}; instances {names}")
    if not (max(errs) <= GRAD_BARS[torch.float32] and launches == 1
            and all(torch.isfinite(x).all() for x in got)):
        fail(f"{label}: errors {errs}, launches {launches}")
    return launches


def f32_wide_heads(g, card: str):
    """The float32 attention kernels at d 192 and 256 (F32_WIDE_DIMS) at
    the heads-256 model's attention shape, b4 h2 s1024 causal (b4 h2 s1024
    d192 beside it): K1 (k1_f32), the one-pass K2, and K3a and K3b with an
    (h, i, j) bias, held to the exact plain versions (F32_ERR_BAR, dB
    included), to the plain versions with the kernels' split
    (mm=dot_tf32x3, TF32X3_BARS, dB included), to their tensor-core
    instances by profiler name (fwd_tf32_kernel<D, float>, dkdv_tf32_kernel<D,
    true>, dq_tf32_kernel<D>, dkdv_tf32_kernel<D, false>: no FMA
    instance), and NaN-keeping on both backward routes (nan_kept); at d
    256 also on a short chain at 8 groups and scale 8 (split_check, both
    routes) and over a long one, b1 h2 s16384 (long_chains, both routes,
    the plain versions a head at a time); then timed beside their bounds
    (3 x the operations at the TF32 tensor cores' peak, the FMA bound
    beside), the plain versions and SDPA f32 (TF32 off).  The backward's
    readings print before any of its instance or split checks fails, so
    ``python3 chip_smoke.py --f32-wide-heads`` on an earlier commit gives
    the FMA parents' times.  Returns ({row: timing}, {row: max abs error
    against plain}) of d 256's rows ("K1 f32 d256", ...)."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain)
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3

    b, h, s = 4, HEAD256_MODEL["heads"], HEAD256_MODEL["max_seq_len"]
    rows, errs, problems = {}, {}, []
    for d in F32_WIDE_DIMS:
        rows[f"K1 f32 d{d}"], errs[f"K1 f32 d{d}"] = k1_f32(
            g, card, b, h, s, d, [f"fwd_tf32_kernel<{d}, float>"],
            ["fwd_kernel<", "fwd_mma_kernel<"])

        worst = {"K2": 0.0, "K3a": 0.0, "K3b": 0.0}
        args, kw2 = bwd_inputs(g, b, h, h, s, s, d, torch.float32, None,
                               None, True)
        args_b, kw_b = bwd_inputs(g, b, h, h, s, s, d, torch.float32, None,
                                  "h", True)
        compare_backward(worst, f"b{b} h{h} s{s} d{d} causal", args, kw2,
                         torch.float32, None)
        compare_backward(worst, f"b{b} h{h} s{s} d{d} causal + (h,i,j) bias",
                         args_b, kw_b, torch.float32, None)
        got = bk._backward_onepass(*args[:7], scale=1.0, causal=True)
        want_t = flash_attention_backward_plain(*args, mm=dot_tf32x3, **kw2)
        errs_t = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
        got = bk._backward_twopass(*args_b, **kw_b)
        want_t = flash_attention_backward_plain(*args_b, mm=dot_tf32x3,
                                                **kw_b)
        e3 = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
        e3a, e3b = [e3[0], e3[3]], e3[1:3]
        print(f"  f32 d{d} against the dot_tf32x3 plain versions: K2 dq, dk, "
              f"dv {', '.join(f'{e:.2e}' for e in errs_t)} (bar "
              f"{TF32X3_BARS['K2']:g}); with the bias K3a dq, db "
              f"{', '.join(f'{e:.2e}' for e in e3a)} (bar "
              f"{TF32X3_BARS['K3a']:g}), K3b dk, dv "
              f"{', '.join(f'{e:.2e}' for e in e3b)} (bar "
              f"{TF32X3_BARS['K3b']:g})")
        if not max(errs_t) <= TF32X3_BARS["K2"]:
            fail(f"K2 f32 d{d} against dot_tf32x3: {errs_t}")
        if not (max(e3a) <= TF32X3_BARS["K3a"]
                and max(e3b) <= TF32X3_BARS["K3b"]):
            problems.append(f"K3a/K3b f32 d{d} against dot_tf32x3: {e3a}, "
                            f"{e3b}")
        del got, want_t
        for name, row in time_backward(card, args, kw2, args_b, kw_b).items():
            rows[f"{name} f32 d{d}"] = row
            errs[f"{name} f32 d{d}"] = worst[name]
        onepass = instance_names(lambda: bk._backward_onepass(  # noqa: B023
            *args[:7], scale=1.0, causal=True))
        twopass = instance_names(
            lambda: bk._backward_twopass(*args_b, **kw_b))  # noqa: B023
        print(f"  f32 d{d} backward instances: one-pass {onepass}, two-pass "
              f"{twopass}")
        if onepass != [f"dkdv_tf32_kernel<{d}, true>"]:
            problems.append(f"K2 f32 d{d} instances {onepass}")
        if twopass != [f"dkdv_tf32_kernel<{d}, false>",
                       f"dq_tf32_kernel<{d}>"]:
            problems.append(f"K3a/K3b f32 d{d} instances {twopass}")
        del args, args_b
        nan_ok = nan_kept(g, d)
        print(f"  K1, K2, K3a, K3b f32 d{d}: NaNs in q and v kept in o, the "
              f"gradients and dB: {nan_ok}")
        if not nan_ok:
            problems.append(f"d{d}: NaNs in q and v not kept")
    if problems:
        fail(f"f32 at d 192 and 256: {problems}")
    split_check(g, card, d=256, twopass=True)
    long_chains(g, card, d=256,
                cases=((2, 2, LONG_SEQ, 1, ("onepass", "twopass")),))
    for name, row in rows.items():
        print(f"  f32 row {name}: kernel / library "
              f"{row['ms'] / row['library_ms']:.2f}, bound / kernel "
              f"{row['bound_ms'] / row['ms']:.3f}, error vs plain "
              f"{errs[name]:.3e}")
    return ({key: row for key, row in rows.items() if key.endswith("d256")},
            {key: e for key, e in errs.items() if key.endswith("d256")})


def f32_head_step(card: str, cfg) -> dict:
    """The training step in float32 of the model of ``cfg`` (the heads-256
    or the heads-512 model: dim 512, depth 8, 2 heads of 256 or 1 of 512;
    the trainer's --use-float32 at that width: 4 microbatches of 4 x 1024
    of phase 8's corpus).  The wrappers' counts are set to 0 before 2
    warm-up steps (host-clock walls, ended by a synchronize) and read
    after them; then 2 steps are profiled (whole_rows): device time a
    step, K1's and K2's share, launches and TFLOP/s a step, the largest
    kernels, the idle share (1 - device time / the second warm-up step's
    wall).  Fails unless K1 and K2 ran their 3xTF32 tensor-core instances
    at the model's head width (fwd_tf32_kernel<D, float> and dkdv_tf32_kernel<D,
    true> up to d 256; past it the wide route's fwd_wide_tf32_kernel<float> and
    dkdv_wide_tf32_kernel<true>, never an FMA one) 32 times a step each, K3a
    and K3b never, and unless the losses are finite; the reading prints
    first, so the same script on a checkout of an earlier commit gives
    its reading before it fails.  Returns the wrappers' launches over the
    2 counted steps."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, fwd_kernel as fk)
    from flash_cosine_sim_attention_tpu_torch.train import (
        BATCH_SIZE, GRAD_ACCUM, train_step)

    d, seq = cfg["dim_head"], cfg["max_seq_len"]
    model, opt, batches = f32_step_model(seq, BATCH_SIZE, cfg)
    losses, walls = [], []

    def step():
        losses.append(train_step(model, opt, batches[len(losses) % 4]))

    wrappers = dict(k1=fk.flash_attention_forward, k2=bk.fused_bwd_kernel,
                    k3a=bk.dq_kernel, k3b=bk.dkdv_kernel)
    for fn in wrappers.values():
        fn.launches = 0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {key: fn.launches for key, fn in wrappers.items()}
    rows = whole_rows(step, 2)
    total = sum(t for _, t, _ in rows) / 1e3
    parts = step_parts(rows, d)
    loss = [x.item() for x in losses]
    top = sorted(rows, key=lambda r: -r[1])[:4]
    # the function's operations a call: 2 (K1) and 5 (K2) products of 2d
    # FLOPs per visible pair, over the microbatch's rows and heads
    pairs = BATCH_SIZE * cfg["heads"] * seq * (seq + 1) / 2
    flops = {"K1": 2 * 2 * d * pairs, "K2": 5 * 2 * d * pairs}
    print(f"  float32 train step, heads {cfg['heads']} of {d} ({GRAD_ACCUM} "
          f"x {BATCH_SIZE} x {seq}) on {card}: device time {total:.2f} ms a "
          f"step (2 steps profiled); wall {walls[1]:.2f} ms (warm-up steps "
          f"{', '.join(f'{w:.2f}' for w in walls)}), idle share "
          f"{1 - total / walls[1]:.3f}; "
          + "; ".join(f"{name} {ms:.2f} ms ({ms / total:.3f}), {n} launches"
                      f"{f', {tflops(flops[name] * n, ms):.1f} TFLOP/s' if n else ''}"
                      f" {names}"
                      for name in ("K1", "K2")
                      for ms, n, names in (parts[name],))
          + f"; wrapper launches over the 2 counted steps {launches}; the "
          "largest kernels "
          + "; ".join(f"{key[:60]} {t / 1e3:.2f} ms ({c} launches)"
                      for key, t, c in top)
          + f"; losses {', '.join(f'{x:.4f}' for x in loss)}")
    if not np.all(np.isfinite(loss)):
        fail(f"float32 heads-{d} train step: losses {loss}")
    per_step = GRAD_ACCUM * cfg["depth"]
    want = dict(k1=2 * per_step, k2=2 * per_step, k3a=0, k3b=0)
    names = (([f"fwd_tf32_kernel<{d}, float>"], [f"dkdv_tf32_kernel<{d}, true>"])
             if d <= 256 else
             (["fwd_wide_tf32_kernel<float>"], ["dkdv_wide_tf32_kernel<true>"]))
    if (launches != want
            or any(parts[name][1] != per_step for name in ("K1", "K2"))
            or parts["K3a"][1] or parts["K3b"][1]
            or (parts["K1"][2], parts["K2"][2]) != names):
        fail(f"float32 heads-{d} train step: wrapper launches {launches}, "
             f"want {want}; profiled launches a step and instances {parts}")
    return launches


def f32_head256_step(card: str) -> dict:
    """f32_head_step on the heads-256 model (HEAD256_MODEL): K1 and K2 at
    d 256 (fwd_tf32_kernel<256, float>, dkdv_tf32_kernel<256, true>).  ``python3
    chip_smoke.py --f32-head256-step`` runs it alone, e.g. from a checkout
    of an earlier commit."""
    return f32_head_step(card, HEAD256_MODEL)


def f32_head512_step(card: str) -> dict:
    """f32_head_step on the heads-512 model (HEAD512_MODEL: 1 head of 512):
    K1 and K2 at b4 h1 s1024 d512 on the wide route's 3xTF32 instances
    (fwd_wide_tf32_kernel<float>, dkdv_wide_tf32_kernel<true>; the one-pass backward,
    below ONEPASS_BWD_MAX_SEQ), 32 launches a step each.  ``python3
    chip_smoke.py --f32-head512-step`` runs it alone, e.g. from a checkout
    of an earlier commit, whose FMA instances it times before it fails."""
    return f32_head_step(card, HEAD512_MODEL)


def f32_head512_kernels(g, card: str, errs: dict) -> dict:
    """K1, the one-pass K2 and, with an (h, i, j) bias, the two-pass K3a
    and K3b in float32 at the heads-512 model's shape (b4 h1 s1024 d512
    causal): on the wide route's 3xTF32 instances by profiler name
    (fwd_wide_tf32_kernel<float>, dkdv_wide_tf32_kernel<true>,
    dq_wide_tf32_kernel, dkdv_wide_tf32_kernel<false>; no FMA one), held
    to the exact plain versions (F32_ERR_BAR) and to the plain versions
    with their split (mm=dot_tf32x3, TF32X3_BARS, dB included), on a short
    chain (split_check at d 512, both routes: SPLIT_BARS_D512), over long
    ones (long_chains: b1 h2 s8192 on the one-pass route, and the
    heads-512 step's own b1 h1 s16384 on the two-pass route, the plain
    versions a head at a time) and with NaNs in q and v kept (nan_kept,
    both routes); all four timed beside their bounds, the plain versions
    and SDPA f32.  The timings print before any instance or split check
    fails, so ``python3 chip_smoke.py --f32-head512-kernels`` on an
    earlier commit gives its FMA K3a's and K3b's times.  Folds each row's
    max abs error against plain into ``errs``; returns {row: timing} ("K1
    f32 d512", ...)."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain)
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3

    b, h, s, d = 4, HEAD512_MODEL["heads"], HEAD512_MODEL["max_seq_len"], 512
    rows = {}
    rows["K1 f32 d512"], errs["K1 f32 d512"] = k1_f32(
        g, card, b, h, s, d, ["fwd_wide_tf32_kernel<float>"],
        ["fwd_wide_kernel", "fwd_wide_mma_kernel", "fwd_tf32_kernel"])
    worst = {"K2": 0.0, "K3a": 0.0, "K3b": 0.0}
    args, kw = bwd_inputs(g, b, h, h, s, s, d, torch.float32, None, None,
                          True)
    args_b, kw_b = bwd_inputs(g, b, h, h, s, s, d, torch.float32, None, "h",
                              True)
    compare_backward(worst, f"b{b} h{h} s{s} d{d} causal", args, kw,
                     torch.float32, None)
    compare_backward(worst, f"b{b} h{h} s{s} d{d} causal + (h,i,j) bias",
                     args_b, kw_b, torch.float32, None)
    got = bk._backward_onepass(*args[:7], scale=1.0, causal=True)
    want_t = flash_attention_backward_plain(*args, mm=dot_tf32x3, **kw)
    errs_t = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
    print(f"  K2 f32 d{d} against the dot_tf32x3 plain version: dq, dk, dv "
          f"{', '.join(f'{e:.2e}' for e in errs_t)} (bar "
          f"{TF32X3_BARS['K2']:g})")
    if not max(errs_t) <= TF32X3_BARS["K2"]:
        fail(f"K2 f32 d{d} against dot_tf32x3: {errs_t}")
    del got, want_t
    for name, row in time_backward(card, args, kw, args_b, kw_b).items():
        rows[f"{name} f32 d{d}"] = row
        errs[f"{name} f32 d{d}"] = worst[name]
    got = bk._backward_twopass(*args_b, **kw_b)
    want_t = flash_attention_backward_plain(*args_b, mm=dot_tf32x3, **kw_b)
    e3 = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
    e3a, e3b = [e3[0], e3[3]], e3[1:3]
    print(f"  K3a, K3b f32 d{d} + (h,i,j) bias against the dot_tf32x3 plain "
          f"version: K3a dq, db {', '.join(f'{e:.2e}' for e in e3a)} (bar "
          f"{TF32X3_BARS['K3a']:g}); K3b dk, dv "
          f"{', '.join(f'{e:.2e}' for e in e3b)} (bar "
          f"{TF32X3_BARS['K3b']:g})")
    del got, want_t
    onepass = require_instances(
        f"K2 f32 d{d}", lambda: bk._backward_onepass(*args[:7], scale=1.0,
                                                     causal=True),
        ["dkdv_wide_tf32_kernel<true>"],
        ["dkdv_wide_kernel", "mma_kernel", "dkdv_tf32_kernel"])
    twopass = require_instances(
        f"K3a/K3b f32 d{d}", lambda: bk._backward_twopass(*args_b, **kw_b),
        ["dq_wide_tf32_kernel", "dkdv_wide_tf32_kernel<false>"],
        ["dq_wide_kernel<", "dkdv_wide_kernel", "mma_kernel",
         "dq_tf32_kernel", "dkdv_tf32_kernel"])
    print(f"  f32 d{d} backward instances: one-pass {onepass}, two-pass "
          f"{twopass}")
    if not (max(e3a) <= TF32X3_BARS["K3a"]
            and max(e3b) <= TF32X3_BARS["K3b"]):
        fail(f"K3a/K3b f32 d{d} against dot_tf32x3: {e3a}, {e3b}")
    del args, args_b
    nan_ok = nan_kept(g, d)
    print(f"  K1, K2, K3a, K3b f32 d{d}: NaNs in q and v kept in o, the "
          f"gradients and dB: {nan_ok}")
    if not nan_ok:
        fail(f"f32 d{d}: NaNs in q and v not kept")
    split_check(g, card, d=d, twopass=True)
    long_chains(g, card, d=d, cases=((2, 2, 8192, 1, ("onepass",)),
                                     (1, 1, LONG_SEQ, 1, ("twopass",))))
    return rows


def f32_quant_kernels(card: str):
    """Phase 22's rows of K1's int8 arm with float32 v and of K7 on float32
    x.  K1's int8 arm at INT8_F32_SHAPES (b4 h8, b1 h16 and b4 h1 at seq
    1024 causal, d 64, 128 and 512) through k1_f32 (the exact and the
    dot_tf32x3 plain versions, timed beside SDPA f32 with TF32 off), then
    the qk_int8 op's forward and straight-through backward there
    (int8_op_f32); K7 at one decode step's 65 calls at 8 rows (L2 flushed)
    and one layer's four products at 1024 rows, against the exact and the
    dot_tf32x3 plain versions (F32_ERR_BAR, TF32X3_BARS["K7"]), timed
    beside F.linear on a float32 weight copy and the bound (2 x the
    operations at the TF32 peak, or the bytes), and ff_out's 8192 inputs
    with inputs offset from zero.  Each is held to its tensor-core
    instances by profiler name, no FMA one; a missing instance fails
    after every row has printed its times (``python3 chip_smoke.py
    --f32-quant-kernels`` runs this alone, also on a parent checkout for
    the FMA instances' times).  Returns ({row: timing}, {row: max error
    against plain}, {int8 row: K1 launches of its op call})."""
    import torch.nn.functional as F

    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3
    from flash_cosine_sim_attention_tpu_torch.quant import (
        quantize_dense_kernel, quantized_matmul, quantized_matmul_plain)

    g = torch.Generator(device="cuda").manual_seed(SEED + 100)
    s = 1024
    rows, errs, deferred = {}, {}, []
    # K1's int8 arm with float32 v, the qk_int8 op's forward on float32
    # inputs: the kernel at INT8_F32_SHAPES, then the op's forward and
    # straight-through backward there
    int8_launches = {}
    for row, (b, h, dw) in INT8_F32_SHAPES.items():
        want = ([f"fwd_tf32_kernel<{dw}, signed char>"] if dw <= 256 else
                ["fwd_wide_tf32_kernel<signed char>"])
        rows[row], errs[row] = k1_f32(
            g, card, b, h, s, dw, want,
            ["fwd_kernel<", "fwd_wide_kernel", "mma_kernel", "float>"],
            qk_int8=True, defer=deferred)
        int8_launches[row] = int8_op_f32(g, b, h, s, dw, want + [
            f"dkdv_tf32_kernel<{dw}, true>" if dw <= 256 else
            "dkdv_wide_tf32_kernel<true>"], deferred)

    # K7 on float32 x: one decode step's 65 calls at 8 rows (L2 flushed)
    # and one layer's four products at 1024 rows (a prefill), beside
    # F.linear on a float32 weight copy; then ff_out's 8192 inputs with x
    # and the weights offset from zero (one long chain of sums a split)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    k7 = {row: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
          for row in ("K7 f32", "K7 f32 prefill")}
    k7_names = {8: "qmm_mma_kernel<16, 1, 8, 4, float>",
                1024: "qmm_mma_kernel<128, 4, 2, 3, float>"}

    def check_k7(label, x, w8, scale):
        got = quantized_matmul(x, w8, scale)
        err = rel_err(got, quantized_matmul_plain(x, w8, scale))
        # the plain version with the kernel's split: dot_tf32x3 of x and
        # the widened codes (exact in tf32), times the scale
        err_t = rel_err(got, dot_tf32x3(x, w8.float()) * scale)
        if not (err <= F32_ERR_BAR and err_t <= TF32X3_BARS["K7"]
                and torch.isfinite(got).all().item()):
            fail(f"{label}: err {err} (bar {F32_ERR_BAR}), against "
                 f"dot_tf32x3 {err_t} (bar {TF32X3_BARS['K7']})")
        return err, err_t

    for name, ((d_in, d_out), calls) in PROD_DENSE.items():
        w8, scale = quantize_dense_kernel(0.02 * torch.randn(
            d_in, d_out, device="cuda", generator=g))
        w_lib = (w8.float() * scale).t().contiguous()
        for n in (8, 1024):
            if n == 1024 and name == "logits":
                continue
            row = "K7 f32" if n == 8 else "K7 f32 prefill"
            x = torch.randn(n, d_in, device="cuda", generator=g)
            label = f"K7 {name} ({d_in}, {d_out}) x {n} rows f32"
            err, err_t = check_k7(label, x, w8, scale)
            errs[row] = max(errs.get(row, 0.0), err)
            flush = scratch.zero_ if n == 8 else None
            flops = 2 * n * d_in * d_out
            nbytes = w8.numel() + 4 * d_out + 4 * n * (d_in + d_out)
            # 2xTF32: two tf32 products a product
            bound_ms, by = bound(2 * flops, nbytes, PEAK_TF32_FLOPS)
            times = dict(
                ms=device_ms(lambda: quantized_matmul(x, w8, scale), flush),
                plain_ms=device_ms(
                    lambda: quantized_matmul_plain(x, w8, scale), flush),
                library_ms=device_ms(lambda: F.linear(x, w_lib), flush),
                bound_ms=bound_ms)
            names = require_instances(
                label, lambda: quantized_matmul(x, w8, scale),  # noqa: B023
                [k7_names[n]], ["qmm_kernel<", "__nv_bfloat16"], deferred)
            print(f"  {label}{', L2 flushed' if flush else ''} on {card}: "
                  f"kernel {times['ms']:.4f} ms "
                  f"({tflops(flops, times['ms']):.1f} TFLOP/s, "
                  f"{nbytes / times['ms'] / 1e9:.0f} GB/s), plain "
                  f"{times['plain_ms']:.4f}, F.linear f32 "
                  f"{times['library_ms']:.4f}, bound {bound_ms:.5f} ({by}); "
                  f"err {err:.2e}, against dot_tf32x3 {err_t:.2e} (bars "
                  f"{F32_ERR_BAR:g}, {TF32X3_BARS['K7']:g}); instances "
                  f"{names}")
            for key, val in times.items():
                k7[row][key] += (calls if n == 8 else 1) * val
    rows["K7 f32"] = dict(k7["K7 f32"], bound_by="bytes")
    rows["K7 f32 prefill"] = dict(k7["K7 f32 prefill"],
                                  bound_by="operations")
    step, layer = k7["K7 f32"], k7["K7 f32 prefill"]
    print(f"  K7 over one decode step (65 calls at 8 rows) f32 on {card}: "
          f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, F.linear "
          f"f32 {step['library_ms']:.4f} ms (a float32 weight copy, 4x K7's "
          f"bytes), bound {step['bound_ms']:.5f} ms (bytes)")
    print(f"  K7 over one layer's four products at 1024 rows f32 on {card}: "
          f"{layer['ms']:.4f} ms, plain {layer['plain_ms']:.4f} ms, F.linear "
          f"f32 {layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.5f} "
          f"ms (operations, 2 x at 495 TFLOP/s; FMA bound "
          f"{layer['bound_ms'] * PEAK_TF32_FLOPS / 2 / PEAK_F32_FLOPS:.5f})")
    d_in, d_out = PROD_DENSE["ff_out"][0]
    w8, scale = quantize_dense_kernel(0.02 * torch.randn(
        d_in, d_out, device="cuda", generator=g) + 0.01)
    for n in (8, 1024):
        x = torch.randn(n, d_in, device="cuda", generator=g) + 1.0
        err, err_t = check_k7(f"K7 ff_out x {n} rows f32, offset", x, w8,
                              scale)
        print(f"  K7 ff_out ({d_in}, {d_out}) x {n} rows f32, x of mean 1 "
              f"and weights of mean 0.01: err {err:.2e}, against dot_tf32x3 "
              f"{err_t:.2e} (bars {F32_ERR_BAR:g}, {TF32X3_BARS['K7']:g})")
    del scratch, w8
    if deferred:
        fail("; ".join(deferred))
    return rows, errs, int8_launches


def f32_instances(card: str):
    """Phase 22: the float32 instances at the main path's shapes.  K1 at
    b1 h8 s1024 d64 causal (phase 3's), the one-pass K2 at phase 8's (b4
    h8 s1024 d64 causal) and K3a/K3b at phase 8's shape with an (h, i, j)
    bias, and at b1 h16 s1024 d128 with one, run 3xTF32 on the tensor
    cores (fwd_tf32_kernel<64, float>, dkdv_tf32_kernel<64, true>,
    dq_tf32_kernel<D>, dkdv_tf32_kernel<D, false>).  Each row is held to
    its instances by profiler name, checked against its plain version and
    timed beside it, its bound and one PyTorch call with TF32 off (SDPA
    forward, SDPA backward).  K1, K2,
    K3a and K3b are also held to the plain versions with the kernels'
    split (mm=dot_tf32x3) at TF32X3_BARS (dB included) and on a short
    chain (split_check), checked over long chains (long_chains) and K1 and
    K2 at 8 l2norm groups and scale 8 (logits to 64, where JAX's bf16
    split of a float32 product misses the 1e-4 bar).  Bounds: K1, K2, K3a
    and K3b 3 x their operations at the TF32 tensor cores' peak (the FMA
    bound at 67 TFLOP/s printed beside).  K1, K2, K3a and K3b are timed
    at b1 h16 s1024 d128 too (the bias rows' shape; K1 f32 d128 is phase
    23's prefill).  All four kernels at d 192 and
    256 by f32_wide_heads, at d 512 by f32_head512_kernels (all four on
    the wide route's 3xTF32 instances).  Then the validation model's
    float32 training step, profiled (f32_train_step), the heads-256 and
    heads-512 models' (f32_head256_step, f32_head512_step), the validation
    model's at seq 16384 (f32_long_step), where the backward runs K3a and
    K3b, and the heads-256 and heads-512 models' at seq 16384
    (f32_head256_long_step, f32_head512_long_step: K1, K3a and K3b at d
    256 and 512).  Returns ({row: timing}, {row: max abs error against
    plain}, the launches of the seq-16384 step, of the heads-256 step, of
    the heads-256 seq-16384 step, of the heads-512 step and of the
    heads-512 seq-16384 step)."""
    from flash_cosine_sim_attention_tpu_torch.ops import (
        bwd_kernel as bk, flash_attention_backward_plain)
    from flash_cosine_sim_attention_tpu_torch.ops.mxu import dot_tf32x3

    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 22 times float32 with TF32 off")
    g = torch.Generator(device="cuda").manual_seed(SEED + 100)
    s, d = 1024, 64
    rows, errs = {}, {}
    rows["K1 f32"], errs["K1 f32"] = k1_f32(
        g, card, 1, 8, s, d, ["fwd_tf32_kernel<64, float>"],
        ["fwd_kernel<", "fwd_mma_kernel<"])

    worst = {"K2": 0.0, "K3a": 0.0, "K3b": 0.0}
    args, kw2 = bwd_inputs(g, 4, 8, 8, s, s, d, torch.float32, None, None,
                           True)
    args_b, kw_b = bwd_inputs(g, 4, 8, 8, s, s, d, torch.float32, None, "h",
                              True)
    compare_backward(worst, "b4 h8 s1024 causal (phase 8's shape)", args, kw2,
                     torch.float32, None)
    compare_backward(worst, "b4 h8 s1024 causal + (h,i,j) bias", args_b,
                     kw_b, torch.float32, None)
    got = bk._backward_onepass(*args[:7], scale=1.0, causal=True)
    want_t = flash_attention_backward_plain(*args, mm=dot_tf32x3, **kw2)
    errs_t = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
    print(f"  K2 f32 against the dot_tf32x3 plain version: dq, dk, dv "
          f"{', '.join(f'{e:.2e}' for e in errs_t)} (bar "
          f"{TF32X3_BARS['K2']:g})")
    if not max(errs_t) <= TF32X3_BARS["K2"]:
        fail(f"K2 f32 against dot_tf32x3: {errs_t}")
    # K3a and K3b at d 64 (the bias shape) and d 128 (b1 h16 s1024, an
    # (h, i, j) bias): against the dot_tf32x3 plain version (K3a on dq and
    # dB, K3b on dk and dv), and by instance name
    worst_w = {"K2": 0.0, "K3a": 0.0, "K3b": 0.0}
    args_n, kw_n = bwd_inputs(g, 1, 16, 16, s, s, 128, torch.float32, None,
                              None, True)
    args_w, kw_w = bwd_inputs(g, 1, 16, 16, s, s, 128, torch.float32, None,
                              "h", True)
    compare_backward(worst_w, "b1 h16 s1024 d128 causal", args_n, kw_n,
                     torch.float32, None)
    compare_backward(worst_w, "b1 h16 s1024 d128 causal + (h,i,j) bias",
                     args_w, kw_w, torch.float32, None)
    twopass = []
    for dw, a_, kw_ in ((d, args_b, kw_b), (128, args_w, kw_w)):
        got = bk._backward_twopass(*a_, **kw_)
        want_t = flash_attention_backward_plain(*a_, mm=dot_tf32x3, **kw_)
        e3 = [grad_err(x, y, torch.float32) for x, y in zip(got, want_t)]
        e3a, e3b = [e3[0], e3[3]], e3[1:3]
        print(f"  K3a, K3b f32 d{dw} + (h,i,j) bias against the dot_tf32x3 "
              f"plain version: K3a dq, db {', '.join(f'{e:.2e}' for e in e3a)}"
              f" (bar {TF32X3_BARS['K3a']:g}); K3b dk, dv "
              f"{', '.join(f'{e:.2e}' for e in e3b)} (bar "
              f"{TF32X3_BARS['K3b']:g})")
        if not (max(e3a) <= TF32X3_BARS["K3a"]
                and max(e3b) <= TF32X3_BARS["K3b"]):
            fail(f"K3a/K3b f32 d{dw} against dot_tf32x3: {e3a}, {e3b}")
        twopass += require_instances(
            f"K3a/K3b f32 d{dw}",
            lambda: bk._backward_twopass(*a_, **kw_),  # noqa: B023
            [f"dq_tf32_kernel<{dw}>", f"dkdv_tf32_kernel<{dw}, false>"],
            ["dq_kernel<", "dkdv_kernel<", "mma_kernel"])
    del got, want_t
    split_check(g, card)
    long_chains(g, card)
    for name, row in time_backward(card, args, kw2, args_b, kw_b).items():
        rows[f"{name} f32"] = row
        errs[f"{name} f32"] = worst[name]
    onepass = require_instances(
        "K2 f32", lambda: bk._backward_onepass(*args[:7], scale=1.0,
                                               causal=True),
        ["dkdv_tf32_kernel<64, true>"], ["dkdv_kernel<", "dkdv_mma_kernel<"])
    print(f"  f32 backward instances: one-pass {onepass}, two-pass "
          f"{twopass}")
    scale8(g, card)
    wide_rows, wide_errs = f32_wide_heads(g, card)
    rows.update(wide_rows)
    errs.update(wide_errs)

    # the float32 instances no main path counts: K1 and K2 at d 128 (K3a,
    # K3b with their bias), the wide route at d 512, K1's int8 arm
    rows["K1 f32 d128"], errs["K1 f32 d128"] = k1_f32(
        g, card, 1, 16, s, 128, ["fwd_tf32_kernel<128, float>"],
        ["fwd_kernel<", "fwd_mma_kernel<"])
    for name, row in time_backward(card, args_n, kw_n, args_w, kw_w).items():
        rows[f"{name} f32 d128"] = row
        errs[f"{name} f32 d128"] = worst_w[name]
    require_instances("K2 f32 d128", lambda: bk._backward_onepass(
        *args_n[:7], scale=1.0, causal=True),
        ["dkdv_tf32_kernel<128, true>"], ["dkdv_kernel<", "mma_kernel<"])
    del args_n, args_w
    rows.update(f32_head512_kernels(g, card, errs))
    for name, row in rows.items():
        print(f"  f32 row {name}: kernel / library "
              f"{row['ms'] / row['library_ms']:.2f}, bound / kernel "
              f"{row['bound_ms'] / row['ms']:.3f}, error vs plain "
              f"{errs[name]:.3e}")
    f32_train_step(card)
    head256_launches = f32_head256_step(card)
    head512_launches = f32_head512_step(card)
    return (rows, errs, f32_long_step(card), head256_launches,
            f32_head256_long_step(card), head512_launches,
            f32_head512_long_step(card))


def f32_prod_serve(card: str) -> dict:
    """Phase 23: the 0.81B production model served in float32 with int8
    weights and fused QKV, uncut (PROD_MODEL: dim 2048, depth 16, 16 heads
    of 128, random weights drawn on the card from SEED; quantize_params,
    then fuse_qkv_params) by InferenceEngine under PROD_ENGINE (8 slots x
    2048, buckets 128-1024, int8 KV cache), near-greedy (temperature
    1e-4).  After a warm-up request, a PROD_PROMPT-token prompt in every
    slot (TTFT, synchronized wall a prompt): K7 on float32 x at its
    prefill tiles and K1 on fwd_tf32_kernel<128, float>; one more prefill
    of the last slot's prompt profiled (device time, idle share against
    the median TTFT, K7's and K1's shares and launches); then PROD_STEPS
    decode steps (wall) and 4 profiled ones (device time, idle share, K7's
    at its decode tiles and K4's shares and launches).  The wrappers'
    launches over this traffic are checked against its passes, and the
    instances by profiler name (no FMA instance of K1 or K7).  Every
    slot's stream of 1 + PROD_STEPS tokens is held, under margin_rule, to
    the same model's greedy decode with every kernel's plain version on
    the card (plain_on_card).  ``python3 chip_smoke.py --f32-prod-serve``
    runs this alone (on a parent checkout it prints its readings, then
    fails at the instance check).  Returns the wrapper launches {k1, k4,
    k7, k1_prefill, k7_prefill}."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        fuse_qkv_params, quantize_params)
    from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
        flash_attention_forward)
    from flash_cosine_sim_attention_tpu_torch.quant import (
        quantized_decode_attention, quantized_matmul)
    from flash_cosine_sim_attention_tpu_torch.serving import InferenceEngine

    model = fuse_qkv_params(quantize_params(
        build_prod_model(torch.float32, "cuda")))
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 23)
    vocab, depth = PROD_MODEL["num_tokens"], PROD_MODEL["depth"]
    slots = PROD_ENGINE["num_slots"]
    prompts = [rng.integers(0, vocab, PROD_PROMPT) for _ in range(slots)]
    engine = InferenceEngine(model, **PROD_ENGINE, temperature=1e-4,
                             seed=SEED, device="cuda")
    engine.finish(engine.add_request(rng.integers(0, vocab, 60)))  # warm-up
    counters = (flash_attention_forward, quantized_decode_attention,
                quantized_matmul)
    for c in counters:
        c.launches = 0
    streams, ttft = {}, []
    for prompt in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = engine.add_request(prompt)
        torch.cuda.synchronize()
        ttft.append(1e3 * (time.perf_counter() - t0))
        streams[slot] = [int(engine.last_token[slot])]
    order = list(streams)
    prefill_launches = dict(k1=flash_attention_forward.launches,
                            k7=quantized_matmul.launches)
    passes = dict(prefills=slots, steps=0)

    def refill():  # the last slot's prompt again, under the profiler
        engine.finish(order[-1])
        if engine.add_request(prompts[-1]) != order[-1]:
            fail("phase 23: the refilled prompt took another slot")
        passes["prefills"] += 1

    def step():
        for slot, tok in engine.step().items():
            streams[slot].append(tok)
        passes["steps"] += 1

    pre_rows = whole_rows(refill, 1)
    streams[order[-1]] = [int(engine.last_token[order[-1]])]
    step_ms = []
    for _ in range(PROD_STEPS):
        t0 = time.perf_counter()
        step()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    profiled = 4
    dec_rows = whole_rows(step, profiled)
    launches = dict(k1=flash_attention_forward.launches,
                    k4=quantized_decode_attention.launches,
                    k7=quantized_matmul.launches)

    def part(rows, pat, launch_pat=None):
        """(device ms of the kernels matching ``pat``, launches of those
        matching ``launch_pat``: K7's reduce of its splits is in its time,
        not in its launches)"""
        return (sum(t for key, t, _ in rows if pat in key) / 1e3,
                sum(c for key, _, c in rows if (launch_pat or pat) in key))

    med_ttft, dec = statistics.median(ttft), statistics.median(step_ms)
    pre_ms = sum(t for _, t, _ in pre_rows) / 1e3
    dec_busy = sum(t for _, t, _ in dec_rows) / 1e3
    (k7p, k7p_n), (k1p, k1p_n) = (part(pre_rows, "qmm_", "qmm_mma_kernel"),
                                  part(pre_rows, "fwd_"))
    (k7d, k7d_n), (k4d, k4d_n) = (part(dec_rows, "qmm_", "qmm_mma_kernel"),
                                  part(dec_rows, "decode_kernel<"))
    print(f"  TTFT f32, {slots} prompts of {PROD_PROMPT} tokens on {card}: "
          + ", ".join(f"{ms:.2f}" for ms in ttft) + f" ms (median "
          f"{med_ttft:.2f}); launches over them K1 {prefill_launches['k1']},"
          f" K7 {prefill_launches['k7']}")
    print(f"  one more {PROD_PROMPT}-token prefill f32, profiled: device "
          f"time {pre_ms:.3f} ms of the median TTFT {med_ttft:.2f} ms wall: "
          f"idle share {1 - pre_ms / med_ttft:.3f}; K7 {k7p:.3f} ms "
          f"({k7p / pre_ms:.3f}, {k7p_n} launches), K1 {k1p:.3f} ms "
          f"({k1p / pre_ms:.3f}, {k1p_n} launches)")
    print(f"  decode f32 on {card}: {dec:.3f} ms/step median over "
          f"{PROD_STEPS} steps at {slots} slots ({slots * 1e3 / dec:.1f} "
          f"tokens/s); device time {dec_busy:.3f} ms/step (profiled): idle "
          f"share {1 - dec_busy / dec:.3f}; K7 {k7d:.3f} ms/step "
          f"({k7d / dec_busy:.3f}, {k7d_n} launches a step), K4 {k4d:.3f} "
          f"ms/step ({k4d / dec_busy:.3f}, {k4d_n} launches a step)")
    for label, rows in (("prefill", pre_rows), ("decode step", dec_rows)):
        print(f"  the f32 {label}'s largest device times (ms, launches): "
              + "; ".join(f"{key[:56]} {t / 1e3:.3f} ({c})" for key, t, c
                          in sorted(rows, key=lambda r: -r[1])[:5]))
    want = dict(k1=depth * passes["prefills"], k4=depth * passes["steps"],
                k7=K7_PER_PASS * (passes["prefills"] + passes["steps"]))
    print(f"  launches over the traffic: {launches} (want {want}: "
          f"{passes['prefills']} prefills, {passes['steps']} steps)")
    if launches != want or prefill_launches != dict(
            k1=depth * slots, k7=K7_PER_PASS * slots):
        fail(f"phase 23: launches {launches}, prefills {prefill_launches}, "
             f"want {want}")
    if (k1p_n, k7p_n, k4d_n, k7d_n) != (depth, K7_PER_PASS, depth,
                                         K7_PER_PASS):
        fail(f"phase 23: profiled launches K1 {k1p_n}, K7 {k7p_n} a "
             f"prefill, K4 {k4d_n}, K7 {k7d_n} a step")

    n = 1 + PROD_STEPS
    with plain_on_card():
        ref, margins, _, _ = greedy_reference(model, prompts, n,
                                              PROD_ENGINE["capacity"])
    margin_rule("f32 int8-weight serving on the kernels vs the plain "
                "versions", [streams[s][:n] for s in order], ref, margins)
    require_kernels(pre_rows, ("qmm_mma_kernel<128, 4, 2, 3, float>",
                               "fwd_tf32_kernel<128, float>"),
                    "f32 production prefill")
    require_kernels(dec_rows, ("qmm_mma_kernel<16, 1, 8, 4, float>",
                               "decode_kernel<"),
                    "f32 production decode step")
    del engine, model
    torch.cuda.empty_cache()
    return dict(launches, k1_prefill=prefill_launches["k1"],
                k7_prefill=prefill_launches["k7"])


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--ring-nccl", action="store_true",
        help="run phase 19's ring worlds alone over NCCL, a card a rank "
             "(needs 4 cards)")
    parser.add_argument(
        "--multihost-nccl", action="store_true",
        help="run the trainer alone as 2 torchrun nodes of 2 cards over "
             "NCCL against one card (needs 4 cards)")
    parser.add_argument(
        "--f32-step", action="store_true",
        help="profile the validation model's float32 training step alone "
             "(one card)")
    parser.add_argument(
        "--f32-long-step", action="store_true",
        help="profile the validation model's float32 training step at seq "
             f"{LONG_SEQ}, batch 1, alone (one card)")
    parser.add_argument(
        "--f32-head256-step", action="store_true",
        help="profile the heads-256 model's float32 training step alone "
             "(one card)")
    parser.add_argument(
        "--f32-head256-long-step", action="store_true",
        help="profile the heads-256 model's float32 training step at seq "
             f"{LONG_SEQ}, batch 1, alone (one card)")
    parser.add_argument(
        "--f32-head512-step", action="store_true",
        help="profile the heads-512 model's float32 training step alone "
             "(one card)")
    parser.add_argument(
        "--f32-head512-long-step", action="store_true",
        help="profile the heads-512 model's float32 training step at seq "
             f"{LONG_SEQ}, batch 1, alone (one card)")
    parser.add_argument(
        "--f32-head512-kernels", action="store_true",
        help="check and time the float32 K1, K2, K3a and K3b at d 512 "
             "alone (one card)")
    parser.add_argument(
        "--f32-wide-heads", action="store_true",
        help="check and time the float32 K1, K2, K3a and K3b at d 192 and "
             "256 alone (one card)")
    parser.add_argument(
        "--f32-quant-kernels", action="store_true",
        help="check and time K1's int8 arm with float32 v and K7 on "
             "float32 x alone (one card)")
    parser.add_argument(
        "--f32-prod-serve", action="store_true",
        help="serve the 0.81B model in float32 with int8 weights alone "
             "(phase 23, one card)")
    parser.add_argument(
        "--profiler-drift", type=float, metavar="SECONDS",
        help="profile windows of a matmul for SECONDS alone, with a bare "
             "opening spin and through cuda_rows (one card)")
    args = parser.parse_args()
    started = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    for flag, on in (("--ring-nccl", args.ring_nccl),
                     ("--multihost-nccl", args.multihost_nccl)):
        if on and torch.cuda.device_count() < 4:
            fail(f"{flag} needs 4 cards, found {torch.cuda.device_count()}")
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
        for kind, label in (("wide_mma_kernel", "wide tensor-core"),
                            ("tf32_kernel", "3xTF32")):
            regs = instance_registers(log, kind)
            if regs:
                print(f"  {name} {label} instances' registers: "
                      f"{', '.join(f'{k} {r}' for k, r in regs)}")

    if (args.ring_nccl or args.multihost_nccl or args.f32_step
            or args.f32_long_step or args.f32_head256_step
            or args.f32_head256_long_step or args.f32_head512_step
            or args.f32_head512_long_step or args.f32_head512_kernels
            or args.f32_wide_heads or args.f32_quant_kernels
            or args.f32_prod_serve or args.profiler_drift):
        if args.profiler_drift:
            print("[0] the profiler's records over a long process")
            profiler_drift(args.profiler_drift)
            flag = "--profiler-drift"
        elif args.ring_nccl:
            print("[19] ring attention over NCCL, a card a rank")
            print(json.dumps({"kernels": [ring_attention_phase(smi, "nccl")]}))
            flag = "--ring-nccl"
        elif args.multihost_nccl:
            print("[21] the trainer on 2 nodes of 2 cards over NCCL")
            multihost_nccl(smi)
            flag = "--multihost-nccl"
        elif args.f32_step:
            print("[22] the float32 training step")
            f32_train_step(smi)
            flag = "--f32-step"
        elif args.f32_head256_step:
            print("[22] the heads-256 model's float32 training step")
            f32_head256_step(smi)
            flag = "--f32-head256-step"
        elif args.f32_head512_step:
            print("[22] the heads-512 model's float32 training step")
            f32_head512_step(smi)
            flag = "--f32-head512-step"
        elif args.f32_head256_long_step:
            print("[22] the heads-256 model's float32 training step at seq "
                  f"{LONG_SEQ}")
            f32_head256_long_step(smi)
            flag = "--f32-head256-long-step"
        elif args.f32_head512_long_step:
            print("[22] the heads-512 model's float32 training step at seq "
                  f"{LONG_SEQ}")
            f32_head512_long_step(smi)
            flag = "--f32-head512-long-step"
        elif args.f32_head512_kernels:
            print("[22] the float32 K1, K2, K3a and K3b at d 512")
            f32_head512_kernels(torch.Generator(device="cuda").manual_seed(
                SEED + 100), smi, {})
            flag = "--f32-head512-kernels"
        elif args.f32_wide_heads:
            print("[22] the float32 K1, K2, K3a and K3b at d 192 and 256")
            f32_wide_heads(torch.Generator(device="cuda").manual_seed(
                SEED + 100), smi)
            flag = "--f32-wide-heads"
        elif args.f32_quant_kernels:
            print("[22] K1's int8 arm with float32 v and K7 on float32 x")
            f32_quant_kernels(smi)
            flag = "--f32-quant-kernels"
        elif args.f32_prod_serve:
            print("[23] the 0.81B model served in float32 with int8 weights")
            t23 = time.perf_counter()
            f32_prod_serve(smi)
            print(f"  phase 23 took {time.perf_counter() - t23:.1f} s")
            flag = "--f32-prod-serve"
        else:
            print(f"[22] the float32 training step at seq {LONG_SEQ}")
            f32_long_step(smi)
            flag = "--f32-long-step"
        print(f"chip_smoke.py {flag} took "
              f"{time.perf_counter() - started:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
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
    prod_launches, k4_prod_err, k4_prod_row = serve_prod(smi)
    prod_parity()
    print("[14] widths and groups")
    widths_and_groups(smi)
    print("[15] head dims up to 256")
    w_err, w_rows, w_launches = heads_256(smi)
    print("[16] head dims past 256")
    (x_err, x_rows, x_launches), (y_err, y_rows, y_launches) = (
        heads_past_256(smi))
    print("[17] speculative decoding")
    # phases 17 and 22 run in fresh processes: late in this one the
    # profiler lost whole calls' records of plain versions and library
    # calls five windows running (e.g. 22 of 24 calls of SDPA's kernel,
    # 2 of 20 of its f32 kernel), while a fresh process kept them all
    spec_err, spec_row, spec_launches = run_world(1, None, speculative,
                                                  smi)[0]
    print("[18] tensor parallelism")
    tp_entry = tensor_parallel(smi)
    print("[19] ring attention")
    ring_entry = ring_attention_phase(smi)
    print("[20] pipeline parallelism")
    pipe_entry = pipeline_phase(smi)
    print("[21] multi-host training")
    multihost_entry = multihost_phase(smi)
    print("[22] the float32 instances timed")
    (f32_rows, f32_err, long_launches, head256_launches,
     head256_long_launches, head512_launches,
     head512_long_launches) = run_world(1, None, f32_instances, smi)[0]
    print("[22] K1's int8 arm with float32 v and K7 on float32 x")
    f32q_rows, f32q_errs, int8_f32_launches = run_world(
        1, None, f32_quant_kernels, smi)[0]
    f32_rows.update(f32q_rows)
    f32_err.update(f32q_errs)
    print("[23] the 0.81B model served in float32 with int8 weights")
    t23 = time.perf_counter()
    f32_prod_launches = run_world(1, None, f32_prod_serve, smi)[0]
    print(f"  phase 23 took {time.perf_counter() - t23:.1f} s")

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
    d256 = (
        ("fwd_kernel:d256", "fwd_kernel.cu", "ops/fwd_kernel.py:47", "K1",
         "k1"),
        ("bwd_kernel:onepass:d256", "bwd_kernel.cu", "ops/bwd_kernel.py:456", "K2",
         "k2"),
        ("bwd_kernel:dq:d256", "bwd_kernel.cu", "ops/bwd_kernel.py:64", "K3a",
         "k3a"),
        ("bwd_kernel:dkdv:d256", "bwd_kernel.cu", "ops/bwd_kernel.py:282", "K3b",
         "k3b"),
        ("decode_kernel:d256", "decode_kernel.cu",
         "quant/decode_kernel.py:137", "K4", "k4"),
        ("paged_decode_kernel:d256", "paged_decode_kernel.cu",
         "quant/paged.py:183", "K5", "k5"))
    kernels += [dict(name=name, route="cuda", source=f"{csrc}/{file}",
                     replaces=f"flash_cosine_sim_attention_tpu/{tpu}",
                     launches=w_launches[key], max_abs_err=w_err[k],
                     **w_rows[k])
                for name, file, tpu, k, key in d256]
    kernels += [dict(name=name.replace("d256", "d512"), route="cuda",
                     source=f"{csrc}/{file}",
                     replaces=f"flash_cosine_sim_attention_tpu/{tpu}",
                     launches=x_launches[key], max_abs_err=x_err[k],
                     **x_rows[k])
                for name, file, tpu, k, key in d256]
    kernels.append(dict(
        name="decode_kernel:d128", route="cuda",
        source=f"{csrc}/decode_kernel.cu",
        replaces="flash_cosine_sim_attention_tpu/quant/decode_kernel.py:49",
        launches=prod_launches["k4"], max_abs_err=k4_prod_err,
        **k4_prod_row))
    kernels.append(dict(
        name="decode_kernel:d1032", route="cuda",
        source=f"{csrc}/decode_kernel.cu",
        replaces="flash_cosine_sim_attention_tpu/quant/decode_kernel.py:137",
        launches=y_launches["k4"], max_abs_err=y_err["K4"], **y_rows["K4"]))
    kernels.append(dict(
        name="paged_decode_kernel:d1032", route="cuda",
        source=f"{csrc}/paged_decode_kernel.cu",
        replaces="flash_cosine_sim_attention_tpu/quant/paged.py:183",
        launches=y_launches["k5"], max_abs_err=y_err["K5"], **y_rows["K5"]))
    kernels.append(dict(
        name="fwd_kernel:verify", route="cuda", source=f"{csrc}/fwd_kernel.cu",
        replaces="flash_cosine_sim_attention_tpu/ops/fwd_kernel.py:47",
        launches=spec_launches, max_abs_err=spec_err, **spec_row))
    kernels += [tp_entry, ring_entry, pipe_entry, multihost_entry]
    # K1's and K2's float32 instances, with their launches on phase 21's
    # float32 step (every rank's), K3a's and K3b's, with theirs on phase
    # 22's float32 step at seq 16384 (2 steps), all four at d 256 and at d
    # 512; phase 22 prints the other f32 rows
    kernels += [dict(name=name, route="cuda", source=f"{csrc}/{file}",
                     replaces=f"flash_cosine_sim_attention_tpu/{tpu}",
                     launches=launches[key], max_abs_err=f32_err[row],
                     **f32_rows[row])
                for name, file, tpu, row, key, launches in (
                    ("fwd_kernel:f32", "fwd_kernel.cu", "ops/fwd_kernel.py:47",
                     "K1 f32", "k1", multihost_entry["f32_launches"]),
                    ("bwd_kernel:onepass:f32", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:456", "K2 f32", "k2",
                     multihost_entry["f32_launches"]),
                    ("bwd_kernel:dq:f32", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:64", "K3a f32", "k3a", long_launches),
                    ("bwd_kernel:dkdv:f32", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:282", "K3b f32", "k3b",
                     long_launches),
                    # d 256, with their launches on phase 22's heads-256
                    # float32 step (2 steps)
                    ("fwd_kernel:f32:d256", "fwd_kernel.cu",
                     "ops/fwd_kernel.py:47", "K1 f32 d256", "k1",
                     head256_launches),
                    ("bwd_kernel:onepass:f32:d256", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:456", "K2 f32 d256", "k2",
                     head256_launches),
                    # with their launches on phase 22's heads-256 float32
                    # step at seq 16384 (2 steps)
                    ("bwd_kernel:dq:f32:d256", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:64", "K3a f32 d256", "k3a",
                     head256_long_launches),
                    ("bwd_kernel:dkdv:f32:d256", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:282", "K3b f32 d256", "k3b",
                     head256_long_launches),
                    # d 512 (the wide route), with their launches on phase
                    # 22's heads-512 float32 step (2 steps)
                    ("fwd_kernel:f32:d512", "fwd_kernel.cu",
                     "ops/fwd_kernel.py:47", "K1 f32 d512", "k1",
                     head512_launches),
                    ("bwd_kernel:onepass:f32:d512", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:456", "K2 f32 d512", "k2",
                     head512_launches),
                    # with their launches on phase 22's heads-512 float32
                    # step at seq 16384 (2 steps)
                    ("bwd_kernel:dq:f32:d512", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:64", "K3a f32 d512", "k3a",
                     head512_long_launches),
                    ("bwd_kernel:dkdv:f32:d512", "bwd_kernel.cu",
                     "ops/bwd_kernel.py:282", "K3b f32 d512", "k3b",
                     head512_long_launches),
                    # K1 f32 d128 and K7 on float32 x, with their launches
                    # on phase 23's float32 serving (its prefills, and its
                    # prefills and steps)
                    ("fwd_kernel:f32:d128", "fwd_kernel.cu",
                     "ops/fwd_kernel.py:47", "K1 f32 d128", "k1_prefill",
                     f32_prod_launches),
                    ("quant_matmul:f32", "quant_matmul_kernel.cu",
                     "quant/weights.py:66", "K7 f32", "k7",
                     f32_prod_launches),
                    ("quant_matmul:f32:prefill", "quant_matmul_kernel.cu",
                     "quant/weights.py:66", "K7 f32 prefill", "k7_prefill",
                     f32_prod_launches))]
    # K1's int8 arm with float32 v, with its launches on phase 22's
    # qk_int8 op calls
    kernels += [dict(name=name, route="cuda", source=f"{csrc}/fwd_kernel.cu",
                     replaces="flash_cosine_sim_attention_tpu/ops/"
                              "fwd_kernel.py:47",
                     launches=int8_f32_launches[row],
                     max_abs_err=f32_err[row], **f32_rows[row])
                for name, row in (("fwd_kernel:int8:f32:d64",
                                   "K1 int8 f32 v d64"),
                                  ("fwd_kernel:int8:f32", "K1 int8 f32 v"),
                                  ("fwd_kernel:int8:f32:d512",
                                   "K1 int8 f32 v d512"))]
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke.py took {time.perf_counter() - started:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
