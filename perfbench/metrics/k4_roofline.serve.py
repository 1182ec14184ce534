"""k4_roofline.serve: K4's share of its roofline in the decode steps of
the traced window.  The bound is the model family's
``decode_k4_bound_s`` over the context length of each slot that decodes,
the ``lens`` of the harness's ``step`` span (for
``cosine-causal-transformer`` every live token's K and V codes and V
scale read once, ``perfbench/roofline.py``); the time is that of the
decode kernels below inside the ``step`` ranges."""

from perfbench import core

UNIT, LAYER, MOVES = "%", "kernels", "serve_tokens_per_s"
KERNELS = ("decode_kernel", "decode_cols_kernel")


def read(ctx):
    ranges = ctx.traced("step")
    t = sum(o.dur for r, _ in ranges
            for o in ctx.trace.named(ctx.trace.ops_in(r), KERNELS))
    if t <= 0:
        return None
    cfg = ctx.cell.config
    arch = core.arch(cfg)
    bound = sum(arch.decode_k4_bound_s(cfg, info["lens"]) for _, info in ranges)
    return 100.0 * bound / t
