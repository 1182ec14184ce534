"""engine_step_ms.decode: the median wall (host clock) of an
``InferenceEngine.step()`` that no admission went before, over the
measured window."""

from perfbench.core import median_ms

UNIT, LAYER, MOVES = "ms", "engine", "serve_tokens_per_s"


def read(ctx):
    return median_ms([s for s in ctx.in_window("step")
                      if not s.info["admitted"]])
