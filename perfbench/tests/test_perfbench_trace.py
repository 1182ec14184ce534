"""The trace reader and the per-layer metric readers on synthetic
profiler records (a Chrome trace's events, in microseconds)."""

import pytest

from perfbench import core, roofline
from perfbench import trace as tracing

CFG = {"arch": "cosine-causal-transformer", "num_tokens": 256, "dim": 2048,
       "depth": 16, "heads": 16, "dim_head": 128, "ff_mult": 4}


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def window_events():
    """A 1000 us window: a step range over [100, 500) with K4 and K7 on
    the device, an admit range over [500, 900) with K7 and K1."""
    return [
        ev("kernel", "void at::native::spin_kernel(long)", 0, 50),
        ev("user_annotation", "bench.window", 60, 1000),
        ev("user_annotation", "bench.step#7", 100, 400),
        ev("cpu_op", "aten::mm", 120, 30),
        ev("kernel", "void (anonymous namespace)::decode_kernel<signed char, false, 1>(...)", 200, 100),
        ev("kernel", "void qmm_mma_kernel<16, 1, 8, 4, __nv_bfloat16>(...)",
           320, 50),
        ev("user_annotation", "bench.admit#8", 500, 400),
        ev("kernel", "void qmm_mma_kernel<128, 4, 2, 3, __nv_bfloat16>(...)",
           600, 100),
        ev("kernel", "void qmm_reduce<__nv_bfloat16>(...)", 700, 20),
        ev("kernel", "void (anonymous namespace)::fwd_mma_kernel<__nv_bfloat16, 128>(...)", 690, 60),
        ev("gpu_memcpy", "Memcpy DtoH", 880, 10),
    ]


def test_parse_and_busy():
    t = tracing.Trace(window_events())
    assert t.marked
    assert t.window == pytest.approx((60e-6, 1060e-6))
    assert [(r.name, r.idx) for r in t.ranges] == [("step", 7), ("admit", 8)]
    # busy: 100 + 50 + [600, 750) merged 150 + 10
    assert t.busy_s() == pytest.approx(310e-6)
    assert t.busy_s(600e-6, 700e-6) == pytest.approx(100e-6)
    step = t.ranges[0]
    assert [tracing.kernel_function(o.name) for o in t.ops_in(step)] == [
        "decode_kernel", "qmm_mma_kernel"]
    assert t.count(("qmm_mma_kernel",)) == 2


def test_lost_marker_and_short_records():
    events = [e for e in window_events() if "spin" not in e["name"]]
    t = tracing.Trace(events)
    assert not t.marked
    assert tracing.short_families(t, {"K7": 3, "K4": 1, "K1": 0}) == ["K7"]
    assert tracing.short_families(t, {"K7": 2, "K4": 1}) == []


def test_breakdown():
    b = tracing.Trace(window_events()).breakdown()
    ops = dict(b["device_ops"])
    assert ops["qmm_mma_kernel"] == pytest.approx(150e-6)
    assert ops["decode_kernel"] == pytest.approx(100e-6)
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(1000e-6 - 310e-6)
    assert gaps["aten::mm"] == pytest.approx(140e-6)     # [60, 200)
    assert "bench.admit" in gaps and "bench.step" in gaps


def context(trace, spans, work=None, whole=True):
    cell = core.Cell("c", dict(CFG), {"batch": 1, "grad_accum": 1,
                                      "seq_len": 8}, 1, {}, [], [])
    return core.Context(cell, spans, (0.0, 1.0), work or {}, trace, whole)


def spans_with(*items):
    s = core.Spans()
    s.items = [core.Span(name, a, b, info) for name, a, b, info in items]
    return s


def test_serving_readers():
    spans = spans_with(*[("x", 0, 0, {})] * 7,
                       ("step", 0.1, 0.3, {"rows": 8, "live": 4000,
                                           "lens": [500] * 8,
                                           "admitted": False}),
                       ("admit", 0.3, 0.6, {"rows": 500}))
    ctx = context(tracing.Trace(window_events()), spans)
    k4 = core.load_module("metrics", "k4_roofline.serve").read(ctx)
    assert k4 == pytest.approx(100 * roofline.decode_k4_bound_s(CFG, 4000)
                               / 100e-6)
    qmm = core.load_module("metrics", "qmm_roofline.prefill").read(ctx)
    assert qmm == pytest.approx(100 * roofline.dense_k7_bound_s(CFG, 500)
                                / 120e-6)
    dec = core.load_module("metrics", "qmm_roofline.decode").read(ctx)
    assert dec == pytest.approx(100 * roofline.dense_k7_bound_s(CFG, 8)
                                / 50e-6)
    idle = core.load_module("metrics", "idle_share.serve").read(ctx)
    assert idle == pytest.approx(100 * (1 - 310 / 1000))
    assert core.load_module("metrics", "engine_step_ms.decode").read(
        ctx) == pytest.approx(200)
    assert core.load_module("metrics", "engine_admit_ms.prefill").read(
        ctx) == pytest.approx(300)


def test_readers_read_nothing_from_a_window_that_lost_records():
    spans = spans_with(*[("x", 0, 0, {})] * 7,
                       ("step", 0.1, 0.3, {"rows": 8, "live": 4000,
                                           "admitted": True}))
    ctx = context(tracing.Trace(window_events()), spans, whole=False)
    for name in ("k4_roofline.serve", "qmm_roofline.decode",
                 "idle_share.serve", "engine_step_ms.decode"):
        assert core.load_module("metrics", name).read(ctx) is None


def test_training_readers():
    events = [ev("user_annotation", "bench.window", 0, 1000),
              ev("user_annotation", "bench.train_step#0", 0, 1000),
              ev("kernel", "void fwd_mma_kernel<__nv_bfloat16, 64>(...)", 10,
                 200),
              ev("kernel", "void dkdv_mma_kernel<__nv_bfloat16, 64, true>(...)",
                 300, 300),
              ev("kernel", "ampere_bf16_s16816gemm_bf16_128x128", 650, 150)]
    ctx = context(tracing.Trace(events), spans_with(("train_step", 0, 1, {})))
    ctx.cell.config["depth"] = 2
    attn = core.load_module("metrics", "attn_roofline.train").read(ctx)
    bound = roofline.bound_s(
        roofline.attention_train_ops(1, 16, 8, 128),
        roofline.attention_train_bytes(1, 16, 16, 8, 128))
    assert attn == pytest.approx(100 * 2 * bound / 500e-6)
    assert core.load_module("metrics", "step_device_ms.train").read(
        ctx) == pytest.approx(0.65)
