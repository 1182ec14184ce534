"""step_host_ms.decode: the host's time to issue a decode step.  The
median, over the traced window's ``fcsa.engine.step`` ranges that decode
(their record's ``slots`` above 0), of the range's wall less that of its
``fcsa.engine.sync`` child, where the host waits for the sampled tokens
(``perfbench/launches.py`` pairs ranges and records).

Read under the profiler, which slows the host (the profiled s1024
window idles 0.66 where an unprofiled one idles about 0.16): compare it
between a parent and its change, both traced, and never with
``engine_step_ms.decode``, which is read with tracing off."""

import statistics

from perfbench import launches

UNIT, LAYER, MOVES = "ms", "engine", "serve_tokens_per_s"


def read(ctx):
    att = launches.of(ctx)
    sync = {s.parent: r.dur for r, s in att.records("engine.sync")}
    walls = [r.dur - sync.get(s.id, 0.0)
             for r, s in att.records("engine.step") if s.attrs.get("slots")]
    if not walls:
        return None
    return 1e3 * statistics.median(walls)
