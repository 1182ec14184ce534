"""``perfbench/launches.py`` and the readers of the program's spans, on
synthetic profiler records (a Chrome trace's events, in microseconds)
and span records."""

import pytest

from perfbench import core, launches, roofline
from perfbench import trace as tracing
from flash_cosine_sim_attention_tpu_torch.utils.profiling import SpanRecord

CFG = {"arch": "cosine-causal-transformer", "num_tokens": 256, "dim": 2048,
       "depth": 16, "heads": 16, "dim_head": 128, "ff_mult": 4,
       "compute_dtype": "bfloat16"}
CLOCK = 5.0       # the records' clock less the trace's, seconds


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def rt(name, ts, dur=4):
    return ev("cuda_runtime", name, ts, dur)


def kernel(name, ts, dur):
    return ev("kernel", f"void {name}<__nv_bfloat16>(...)", ts, dur)


# (name, start, end, attrs) of the program's spans, in order of their
# starts; the parent is the innermost open one
SPANS = [
    ("engine.add_request", 110, 390, {"slot": 3, "rows": 700, "width": 1024}),
    ("prefill", 120, 380, {"batch": 1, "width": 1024}),
    ("attention.fwd", 130, 150, {}),
    ("engine.step", 510, 990, {"slots": 8, "live": 4000, "chunk": False}),
    ("decode_step", 520, 900, {"slots": 8}),
    ("kv_append", 530, 600, {"t": 1}),
    ("qmm", 610, 660, {"rows": 8}),
    ("engine.sync", 910, 980, {}),
    ("train.step", 1110, 1490, {"micro": 1}),
    ("train.update", 1300, 1480, {}),
]


def window_events():
    """An admission over [100, 400), a decode step over [500, 1000) and a
    training step over [1100, 1500), each with the program's ranges, the
    host's launch calls and the device operations they launched."""
    events = [
        ev("kernel", "void at::native::spin_kernel(long)", 0, 50),
        ev("user_annotation", "bench.window", 60, 1500),
        ev("user_annotation", "bench.admit#0", 100, 300),
        ev("user_annotation", "bench.step#1", 500, 500),
        ev("user_annotation", "bench.train_step#2", 1100, 400),
        # the admission: K1 launched inside attention.fwd
        rt("cudaLaunchKernel", 135),
        kernel("fwd_mma_kernel", 200, 100),
        # the step: two append kernels, one K7 (its driver call nested in
        # the runtime's), the sampled tokens' copy
        rt("cudaLaunchKernel", 540), rt("cudaLaunchKernel", 560),
        rt("cudaLaunchKernel", 620, 10), ev("cuda_driver", "cuLaunchKernel",
                                            622, 2),
        rt("cudaMemcpyAsync", 915),
        kernel("elementwise_kernel", 700, 20),
        kernel("index_elementwise_kernel", 730, 30),
        kernel("qmm_mma_kernel", 770, 50),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 930, 5),
        # the training step: a kernel of the model, one of the update and
        # a set the update asked for
        rt("cudaLaunchKernel", 1150), rt("cudaLaunchKernel", 1310),
        rt("cudaMemsetAsync", 1320),
        kernel("dkdv_mma_kernel", 1200, 80),
        kernel("multi_tensor_apply_kernel", 1330, 40),
        ev("gpu_memset", "Memset (Device)", 1380, 10),
    ]
    events += [ev("user_annotation", f"fcsa.{n}", s, e - s)
               for n, s, e, _ in SPANS]
    return events


def records(spans=SPANS, shift=0.0):
    out, stack = [], []
    for i, (name, s, e, attrs) in enumerate(spans):
        while stack and stack[-1][1] < e:
            stack.pop()
        out.append(SpanRecord(i, stack[-1][0] if stack else None, name,
                              s * 1e-6 + CLOCK + shift, e * 1e-6 + CLOCK,
                              dict(attrs)))
        stack.append((i, e))
    return out


def harness_spans(drift=0.0):
    """The harness's spans of the three ranges, on the host's clock,
    which runs ``drift`` seconds a second slower than the trace's."""
    harness = core.Spans()
    harness.items = [core.Span(n, s * 1e-6 * (1 - drift) + CLOCK,
                               e * 1e-6 * (1 - drift) + CLOCK, {})
                     for n, s, e in (("admit", 100, 400), ("step", 500, 1000),
                                     ("train_step", 1100, 1500))]
    return harness


def context(events, recs, monkeypatch, whole=True):
    monkeypatch.setattr(launches, "program_spans", lambda: list(recs))
    cell = core.Cell("c", dict(CFG), {}, 1, {}, [], [])
    return core.Context(cell, harness_spans(), (0.0, 1.0), {},
                        tracing.Trace(events), whole)


def test_pairing_is_in_order_and_by_kind():
    att = launches.attribute(tracing.Trace(window_events()))
    got = [(tracing.kernel_function(a.op.name), a.innermost) for a in att]
    assert got == [
        ("fwd_mma_kernel", "attention.fwd"),
        ("elementwise_kernel", "kv_append"),
        ("index_elementwise_kernel", "kv_append"),
        ("qmm_mma_kernel", "qmm"),
        ("Memcpy DtoH", "engine.sync"),
        ("dkdv_mma_kernel", "train.step"),
        ("multi_tensor_apply_kernel", "train.update"),
        ("Memset", "train.update"),
    ]


def test_the_innermost_range_wins():
    att = launches.attribute(tracing.Trace(window_events()))
    append = [a for a in att if a.innermost == "kv_append"]
    assert all(a.held_by("decode_step").name == "fcsa.decode_step"
               and a.held_by("engine.step") is not None for a in append)
    assert [h.name for h in append[0].holders] == [
        "fcsa.engine.step", "fcsa.decode_step", "fcsa.kv_append"]


def test_pairing_holds_where_the_device_clock_drifts():
    """The device's timestamps drift from the host's: operations paired
    by order keep their ranges though late ones start after theirs."""
    events = window_events()
    for e in events:
        if e["cat"] in tracing.DEVICE_CATS and "spin" not in e["name"]:
            e["ts"] += 0.5 * (e["ts"] - 100)
    drifted = launches.attribute(tracing.Trace(events))
    plain = launches.attribute(tracing.Trace(window_events()))
    assert [(a.op.name, a.innermost) for a in drifted] == [
        (a.op.name, a.innermost) for a in plain]


@pytest.mark.parametrize("dropped", ["index_elementwise_kernel",
                                     "Memcpy DtoH", "Memset"])
def test_a_count_that_differs_reads_none(monkeypatch, dropped):
    events = [e for e in window_events()
              if not (e["cat"] in tracing.DEVICE_CATS
                      and dropped in e["name"])]
    said = []
    assert launches.attribute(tracing.Trace(events), log=said.append) is None
    assert said and "bench." in said[0]
    ctx = context(events, records(), monkeypatch)
    for name in ("step_ops.decode", "kv_append_ms.decode",
                 "k1_roofline.prefill", "update_device_ms.train.short"):
        assert core.load_module("metrics", name).read(ctx) is None


def test_records_pair_by_name_and_clock():
    trace, harness = tracing.Trace(window_events()), harness_spans()
    pairs = launches.pair_records(trace, harness, records())
    assert [(r.name, s.name) for r, s in pairs][:2] == [
        ("fcsa.engine.add_request", "engine.add_request"),
        ("fcsa.prefill", "prefill")]
    # a window profiled twice: the last records are its own
    assert launches.pair_records(trace, harness, records()[-3:] + records()
                                 ) == pairs
    swapped = records()
    swapped[6].name = "kv_append"
    assert launches.pair_records(trace, harness, swapped,
                                 log=lambda *a: None) is None
    assert launches.pair_records(trace, harness, records(shift=5e-3),
                                 log=lambda *a: None) is None
    # each record is put on the trace's clock by the harness range it
    # starts in, so the clocks may drift apart between ranges
    # (a drift of 0.9 puts the last range 1.08 ms off the first one's)
    drifting = records()
    for rec in drifting:
        rec.start = CLOCK + (rec.start - CLOCK) * 0.1
    got = launches.pair_records(trace, harness_spans(0.9), drifting)
    assert [(r.name, s.id) for r, s in got] == [(r.name, s.id)
                                                 for r, s in pairs]


def test_readers_read_the_window(monkeypatch):
    ctx = context(window_events(), records(), monkeypatch)

    def read(name):
        return core.load_module("metrics", name).read(ctx)

    # the step's 480 us less its sync's 70 us
    assert read("step_host_ms.decode") == pytest.approx(0.41)
    # 3 kernels and the copy in the one decoding step
    assert read("step_ops.decode") == pytest.approx(4.0)
    assert read("kv_append_ms.decode") == pytest.approx(0.05)
    k1 = core.load_module("metrics", "k1_roofline.prefill")
    assert read("k1_roofline.prefill") == pytest.approx(
        100 * k1.k1_bound_s(CFG, 700) / 100e-6)
    assert read("update_device_ms.train.short") == pytest.approx(0.05)


def test_k1_bound_at_real_rows():
    k1 = core.load_module("metrics", "k1_roofline.prefill")
    rows = 1024
    ops = 16 * roofline.attention_fwd_ops(1, 16, rows * (rows + 1) // 2, 128)
    nbytes = 16 * (4 * 16 * rows * 128 * 2 + 4 * 16 * rows)
    assert k1.k1_bound_s(CFG, rows) == pytest.approx(
        max(ops / roofline.PEAK_BF16_FLOPS, nbytes / roofline.PEAK_BYTES_PER_S))


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent of this change: no fcsa ranges, no records."""
    events = [e for e in window_events() if not e["name"].startswith("fcsa.")]
    ctx = context(events, [], monkeypatch)
    for name in ("step_host_ms.decode", "step_ops.decode",
                 "kv_append_ms.decode", "k1_roofline.prefill",
                 "update_device_ms.train.short"):
        assert core.load_module("metrics", name).read(ctx) is None
    ctx = context(window_events(), records(), monkeypatch, whole=False)
    assert core.load_module("metrics", "step_ops.decode").read(ctx) is None
