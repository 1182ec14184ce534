"""step_device_ms.train: device time a training step, from the traced
window: the stretches in which some device operation ran, inside the
harness's ``train_step`` ranges, over their count."""

UNIT, LAYER, MOVES = "ms", "trainer and model", "train_tokens_per_s"


def read(ctx):
    ranges = ctx.traced("train_step")
    if not ranges:
        return None
    busy = sum(ctx.trace.busy_s(r.start, r.end) for r, _ in ranges)
    return 1e3 * busy / len(ranges) if busy > 0 else None
