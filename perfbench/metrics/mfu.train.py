"""mfu.train: the whole window's model FLOPs (``perfbench/roofline.py``)
over the measured window's time at the bf16 peak."""

from perfbench import roofline

UNIT, LAYER, MOVES = "%", "whole step", "train_tokens_per_s"


def read(ctx):
    return 100.0 * ctx.work["model_flops"] / (
        ctx.window_s * roofline.PEAK_BF16_FLOPS)
