"""serve_tokens_per_s.long: output tokens delivered in the measured window
over its time (host clock), read with ``--trace 1`` (an unprofiled
window) in the cell whose end-to-end rate is ``serve_tokens_per_busy_s``.
The same quantity as the end-to-end ``serve_tokens_per_s``: there the
host's speed moves it by more than a bound may allow."""

UNIT, LAYER, MOVES = "tokens/s", "engine", "serve_tokens_per_busy_s"


def read(ctx):
    return ctx.work.get("tokens_per_s")
