"""ttft_p95_ms.host: the 95th percentile, over every request admitted in
the measured window, of the time (host clock) from when its client sent
it, at its previous request's end, to its first token.  A per-layer
metric: the host's speed moves it by more than an end-to-end bound may
allow."""

UNIT, LAYER, MOVES = "ms", "engine", "serve_tokens_per_s"


def read(ctx):
    return ctx.work.get("ttft_p95_ms")
