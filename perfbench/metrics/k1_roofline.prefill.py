"""k1_roofline.prefill: the fused forward's share of its roofline in the
traced window's admissions.  The bound is causal attention over each
admission's real rows, the ``rows`` of the ``fcsa.engine.add_request``
record around its ``fcsa.prefill``, every layer (the model family's
``k1_prefill_bound_s``; for ``cosine-causal-transformer``
``causal_pairs`` and ``attention_fwd_ops`` at the bf16 peak, or q, k, v
and o moved once with the f32 row sums, whichever is longer); the time
is that of the operations whose innermost range is
``fcsa.attention.fwd`` inside ``fcsa.prefill``: K1 at the bucket's
padded width, and whatever copies it needs (``perfbench/launches.py``).
"""

from perfbench import core, launches

UNIT, LAYER, MOVES = "%", "kernels", "serve_tokens_per_s"


def k1_bound_s(cfg: dict, rows: int) -> float:
    """K1's least time over the layers of one prefill of ``rows`` real
    tokens."""
    return core.arch(cfg).k1_prefill_bound_s(cfg, rows)


def read(ctx):
    att = launches.of(ctx)
    if att.ops is None:
        return None
    bound, prefills = 0.0, set()
    for r, s in att.records("prefill"):
        admission = att.record(s.parent)
        if admission is None or admission.name != "engine.add_request":
            return None
        bound += k1_bound_s(ctx.cell.config, admission.attrs["rows"])
        prefills.add(id(r))
    t = sum(a.op.dur for a in att.ops if a.innermost == "attention.fwd"
            and id(a.held_by("prefill")) in prefills)
    if t <= 0:
        return None
    return 100.0 * bound / t
