"""itl_p95_ms.host: the 95th percentile, over every output token served in
the measured window, of the gap (host clock) since its request's
previous token; stalls from admissions count.  A per-layer metric: the
host's speed moves it by more than an end-to-end bound may allow."""

UNIT, LAYER, MOVES = "ms", "engine", "serve_tokens_per_busy_s"


def read(ctx):
    return ctx.work.get("itl_p95_ms")
