"""k4_roofline.serve: K4's share of its roofline in the decode steps of
the traced window.  The bound reads every live token's K and V codes and
V scale once, for the slots that decode (``perfbench/roofline.py``); the
time is that of the decode kernels below inside the ``step`` ranges."""

from perfbench import roofline

UNIT, LAYER, MOVES = "%", "kernels", "serve_tokens_per_s"
KERNELS = ("decode_kernel", "decode_cols_kernel")


def read(ctx):
    ranges = ctx.traced("step")
    t = sum(o.dur for r, _ in ranges
            for o in ctx.trace.named(ctx.trace.ops_in(r), KERNELS))
    if t <= 0:
        return None
    bound = sum(roofline.decode_k4_bound_s(ctx.cell.config, info["live"])
                for _, info in ranges)
    return 100.0 * bound / t
