"""attn_roofline.train: the attention kernels' share of their roofline in
a training step.  The bound is the forward and backward of causal
attention over the step's microbatches, every layer (the model family's
``attention_train_bound_s``; for ``cosine-causal-transformer`` the
backward at 2.5 forwards, ``perfbench/roofline.py``); the time is that
of K1, K2, K3a and K3b, the kernels below, inside the harness's
``train_step`` ranges.  The step is one range, so the kernels are told
apart by these names."""

from perfbench import core

UNIT, LAYER, MOVES = "%", "kernels", "train_tokens_per_s"
KERNELS = ("fwd_mma_kernel", "fwd_tf32_kernel", "fwd_wide_mma_kernel",
           "fwd_wide_tf32_kernel", "dkdv_mma_kernel", "dkdv_tf32_kernel",
           "dkdv_wide_mma_kernel", "dkdv_wide_tf32_kernel", "dq_mma_kernel",
           "dq_tf32_kernel", "dq_wide_mma_kernel", "dq_wide_tf32_kernel")


def read(ctx):
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    ranges = ctx.traced("train_step")
    t = sum(o.dur for r, _ in ranges
            for o in ctx.trace.named(ctx.trace.ops_in(r), KERNELS))
    if t <= 0:
        return None
    bound = core.arch(cfg).attention_train_bound_s(
        cfg, mix["grad_accum"] * mix["batch"], mix["seq_len"])
    return 100.0 * len(ranges) * bound / t
