"""kv_append_ms.decode: device time, a decode step, of what the KV
append launches: the operations whose innermost range is
``fcsa.kv_append`` inside an ``fcsa.decode_step`` range (the quantize of
the new K and V and their scatter into the cache, every layer), summed
over the traced window and divided by its ``fcsa.decode_step`` ranges
(``perfbench/launches.py``)."""

from perfbench import launches

UNIT, LAYER, MOVES = "ms", "kernels", "serve_tokens_per_busy_s"


def read(ctx):
    att = launches.of(ctx)
    steps = att.count("decode_step")
    if att.ops is None or not steps:
        return None
    t = sum(a.op.dur for a in att.ops if a.innermost == "kv_append"
            and a.held_by("decode_step") is not None)
    return 1e3 * t / steps if t > 0 else None
