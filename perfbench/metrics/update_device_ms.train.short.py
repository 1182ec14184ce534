"""update_device_ms.train.short: device time, a training step, of what
the trainer's update launches: the operations inside the traced
window's ``fcsa.train.update`` ranges (the gradients' mean over the
microbatches, the global-norm clip and Adam's step), summed and divided
by the ranges' count (``perfbench/launches.py``)."""

from perfbench import launches

UNIT, LAYER, MOVES = "ms", "trainer and model", "train_tokens_per_s.short"


def read(ctx):
    att = launches.of(ctx)
    updates = att.count("train.update")
    if att.ops is None or not updates:
        return None
    t = sum(a.op.dur for a in att.ops
            if a.held_by("train.update") is not None)
    return 1e3 * t / updates if t > 0 else None
