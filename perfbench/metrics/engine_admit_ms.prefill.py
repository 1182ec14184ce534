"""engine_admit_ms.prefill: the median wall (host clock) of an
``InferenceEngine.add_request``, over the measured window."""

from perfbench.core import median_ms

UNIT, LAYER, MOVES = "ms", "engine", "serve_tokens_per_s"


def read(ctx):
    return median_ms(ctx.in_window("admit"))
