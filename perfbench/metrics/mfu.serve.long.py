"""mfu.serve.long: the model FLOPs of the traced window's loop turns (each
decode step's at its slots' ``lens``, each admission's at its rows: the
model family's counts) over the seconds in which the device was busy in
that window, at the bf16 peak: the whole step's share of the chip's
peak on the terms of ``serve_tokens_per_busy_s``.  Not measured where
the window lost records."""

from perfbench import core, roofline

UNIT, LAYER, MOVES = "%", "whole step", "serve_tokens_per_busy_s"


def read(ctx):
    if not ctx.whole:
        return None
    cfg = ctx.cell.config
    arch = core.arch(cfg)
    flops = (sum(arch.decode_flops(cfg, info["lens"])
                 for _, info in ctx.traced("step"))
             + sum(arch.prefill_flops(cfg, info["rows"])
                   for _, info in ctx.traced("admit")))
    busy = ctx.trace.busy_s()
    if flops <= 0 or busy <= 0:
        return None
    return 100.0 * flops / (busy * roofline.PEAK_BF16_FLOPS)
