"""qmm_roofline.prefill: K7's share of its roofline in the admissions of
the traced window.  The bound is every dense product of each prompt's
real rows (the model family's ``dense_k7_bound_s``;
``perfbench/roofline.py``: 2 m n k operations; int8 weights, scales, x
and y moved once); the time is that of K7's kernels below
inside the ``admit`` ranges."""

from perfbench import core

UNIT, LAYER, MOVES = "%", "kernels", "serve_tokens_per_s"
KERNELS = ("qmm_mma_kernel", "qmm_reduce")


def read(ctx):
    ranges = ctx.traced("admit")
    t = sum(o.dur for r, _ in ranges
            for o in ctx.trace.named(ctx.trace.ops_in(r), KERNELS))
    if t <= 0:
        return None
    cfg = ctx.cell.config
    arch = core.arch(cfg)
    bound = sum(arch.dense_k7_bound_s(cfg, info["rows"]) for _, info in ranges)
    return 100.0 * bound / t
