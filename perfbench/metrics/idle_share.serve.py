"""idle_share.serve: the share of the traced window in which no device
operation ran; not measured where it lost records."""

UNIT, LAYER, MOVES = "%", "device", "serve_tokens_per_s"


def read(ctx):
    if not ctx.whole:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
