"""qmm_roofline.decode: K7's share of its roofline in the decode steps of
the traced window.  The bound is every dense product at the rows of the
slots that decode (the model family's ``dense_k7_bound_s``;
``perfbench/roofline.py``); the time is that of K7's kernels below
inside the ``step`` ranges."""

from perfbench import core

UNIT, LAYER, MOVES = "%", "kernels", "serve_tokens_per_s"
KERNELS = ("qmm_mma_kernel", "qmm_reduce")


def read(ctx):
    ranges = ctx.traced("step")
    t = sum(o.dur for r, _ in ranges
            for o in ctx.trace.named(ctx.trace.ops_in(r), KERNELS))
    if t <= 0:
        return None
    cfg = ctx.cell.config
    arch = core.arch(cfg)
    bound = sum(arch.dense_k7_bound_s(cfg, info["rows"]) for _, info in ranges)
    return 100.0 * bound / t
