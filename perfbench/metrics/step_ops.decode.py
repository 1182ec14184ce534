"""step_ops.decode: device operations (kernels, copies, sets) launched
inside the traced window's ``fcsa.engine.step`` ranges that decode
(their record's ``slots`` above 0), a step: the count a captured graph
of the step would launch as one (``perfbench/launches.py`` attributes
each operation to the ranges around its launch call)."""

from perfbench import launches

UNIT, LAYER, MOVES = "ops", "engine", "serve_tokens_per_s"


def read(ctx):
    att = launches.of(ctx)
    steps = {id(r) for r, s in att.records("engine.step")
             if s.attrs.get("slots")}
    if att.ops is None or not steps:
        return None
    n = sum(1 for a in att.ops if id(a.held_by("engine.step")) in steps)
    return n / len(steps)
