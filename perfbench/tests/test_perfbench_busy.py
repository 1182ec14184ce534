"""The device-busy rate of ``prod-decode-long``: the union of device
intervals, the measured window run in profiled stretches (the profiler
replaced by a stand-in, since it needs the card), and the readers that
the cell reads under the names of its own rate."""

import pytest

from perfbench import core, roofline
from perfbench import trace as tracing
from perfbench.tests.test_perfbench_trace import (CFG, context, spans_with,
                                                  window_events)

TWINS = ("engine_step_ms.decode", "k4_roofline.serve", "qmm_roofline.decode",
         "idle_share.serve", "step_host_ms.decode", "step_ops.decode")


@pytest.mark.parametrize("starts,ends,union", [
    ([], [], 0.0),
    ([0.0], [1.0], 1.0),
    ([0.0, 1.0, 5.0, 2.0], [2.0, 3.0, 6.0, 2.5], 4.0),   # overlaps merged
    ([0.0, 0.5], [10.0, 1.0], 10.0),                     # one inside another
    ([3.0, 0.0, 1.0], [4.0, 1.0, 2.0], 3.0),             # touching, unsorted
])
def test_merged_seconds(starts, ends, union):
    assert tracing.merged_seconds(starts, ends) == pytest.approx(union)


def test_a_stretch_is_short_of_what_it_lost():
    b = tracing.Busy(1.0, 5, {"K4": 2, "K7": 3, "K1": 0},
                     {"K4": 2, "K7": 1, "K1": 0})
    assert b.short == ["K7"]


class FakeLoop:
    """A loop whose turns take 0.1 s each on a clock of its own and serve
    ten tokens."""

    def __init__(self):
        self.spans, self.tokens, self.now = core.Spans(), 0, 0.0

    def iterate(self):
        self.now += 0.1
        self.tokens += 10
        self.spans.items.append(core.Span("step", self.now - 0.1, self.now))


def stand_in(monkeypatch, drv, loop, short_at=()):
    """``trace.device_busy`` replaced: the work runs, busy is a quarter of
    its turns' time, and the stretches numbered in ``short_at`` lose
    records."""
    calls = []

    def busy(work, counted):
        before = loop.now
        work()
        calls.append(len(calls) + 1)
        return tracing.Busy(0.25 * (loop.now - before), 0, {"K7": 2},
                            {"K7": 1 if calls[-1] in short_at else 2})

    monkeypatch.setattr(drv.tracing, "device_busy", busy)
    monkeypatch.setattr(drv.time, "perf_counter", lambda: loop.now)
    return calls


def test_busy_window_covers_the_window_in_stretches(monkeypatch):
    drv = core.load_module("drivers", "serve")
    loop = FakeLoop()
    stand_in(monkeypatch, drv, loop)
    tokens, busy, stretches, left_out = drv.busy_window(
        loop, 2.05, 4, {}, lambda *a: None)
    # 21 turns of 0.1 s reach 2.05 s: stretches of 4, 4, 4, 4, 4, 1
    assert (stretches, left_out) == (6, 0)
    assert tokens == loop.tokens == 210
    assert busy == pytest.approx(0.25 * 2.1)
    assert tokens / busy == pytest.approx(4 * 100)   # 100 tokens/s, 1/4 busy


def test_busy_window_leaves_out_a_stretch_short_of_records(monkeypatch):
    drv = core.load_module("drivers", "serve")
    loop = FakeLoop()
    stand_in(monkeypatch, drv, loop, short_at=(2,))
    tokens, busy, stretches, left_out = drv.busy_window(
        loop, 1.2, 4, {}, lambda *a: None)
    assert (stretches, left_out) == (3, 1)
    assert tokens == 80 and loop.tokens == 120
    assert busy == pytest.approx(0.25 * 0.8)


@pytest.mark.parametrize("name", TWINS)
def test_twins_read_what_their_base_reads(name):
    spans = spans_with(*[("x", 0, 0, {})] * 7,
                       ("step", 0.1, 0.3, {"rows": 8, "live": 4000,
                                           "lens": [500] * 8,
                                           "admitted": False}),
                       ("admit", 0.3, 0.6, {"rows": 500}))
    ctx = context(tracing.Trace(window_events()), spans)
    base = core.load_module("metrics", name)
    twin = core.load_module("metrics", name + ".long")
    assert (twin.UNIT, twin.LAYER) == (base.UNIT, base.LAYER)
    assert twin.MOVES == "serve_tokens_per_busy_s"
    assert twin.read(ctx) == base.read(ctx)


def test_busy_mfu_and_host_rate_readers():
    spans = spans_with(*[("x", 0, 0, {})] * 7,
                       ("step", 0.1, 0.3, {"rows": 8, "live": 4000,
                                           "lens": [500] * 8,
                                           "admitted": False}),
                       ("admit", 0.3, 0.6, {"rows": 500}))
    ctx = context(tracing.Trace(window_events()), spans,
                  work={"tokens_per_s": 4321.0})
    arch = core.arch(CFG)
    flops = arch.decode_flops(CFG, [500] * 8) + arch.prefill_flops(CFG, 500)
    mfu = core.load_module("metrics", "mfu.serve.long").read(ctx)
    assert mfu == pytest.approx(100 * flops / (310e-6
                                               * roofline.PEAK_BF16_FLOPS))
    assert core.load_module("metrics", "serve_tokens_per_s.long").read(
        ctx) == 4321.0
    lost = context(tracing.Trace(window_events()), spans, whole=False)
    assert core.load_module("metrics", "mfu.serve.long").read(lost) is None
