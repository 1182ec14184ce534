"""mfu.prefill: the model FLOPs of the window's admissions
(``perfbench/roofline.py``) over the time ``add_request`` took (host
clock) at the bf16 peak."""

from perfbench import roofline

UNIT, LAYER, MOVES = "%", "whole step", "serve_tokens_per_s"


def read(ctx):
    t = sum(s.seconds for s in ctx.in_window("admit"))
    if t <= 0:
        return None
    return 100.0 * ctx.work["prefill_flops"] / (t * roofline.PEAK_BF16_FLOPS)
