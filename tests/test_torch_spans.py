"""The port's spans on the CPU: off with no profiler (no record, no clock,
no ``record_function``), and under ``torch.profiler`` ranges named
``fcsa.<name>`` that nest as the layers do and pair one to one with the
records ``take_spans`` hands over."""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flash_cosine_sim_attention_tpu_torch import train
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
)
from flash_cosine_sim_attention_tpu_torch.models.decoding import (
    fuse_qkv_params,
    quantize_params,
)
from flash_cosine_sim_attention_tpu_torch.serving import InferenceEngine
from flash_cosine_sim_attention_tpu_torch.utils import profiling

DEPTH = 2
PROMPT = 10


def _serve():
    """An int8-weight engine of two slots: one admission of a 10-token
    prompt (bucket 16), then one decode step."""
    torch.manual_seed(0)
    model = CosineSimCausalTransformer(
        num_tokens=32, dim=32, max_seq_len=64, depth=DEPTH, heads=2,
        dim_head=16, device="cpu")
    fuse_qkv_params(quantize_params(model)).eval()
    engine = InferenceEngine(model, num_slots=2, capacity=64,
                             prompt_buckets=(16, 32), device="cpu")

    def work():
        engine.add_request(np.arange(PROMPT, dtype=np.int32))
        engine.step()
    return work


def _train():
    """One training step of two microbatches through the fused op."""
    torch.manual_seed(0)
    model = CosineSimCausalTransformer(
        num_tokens=32, dim=32, max_seq_len=32, depth=DEPTH, heads=2,
        dim_head=16, device="cpu")
    optimizer = train.make_optimizer(model)
    batches = torch.randint(0, 32, (2, 2, 17))
    return lambda: train.train_step(model, optimizer, batches)


WORK = {"serve": _serve, "train": _train}


@pytest.fixture(autouse=True)
def no_records_left():
    profiling.take_spans()
    yield
    profiling.take_spans()


@pytest.mark.parametrize("kind", sorted(WORK))
def test_off_without_a_profiler(monkeypatch, kind):
    work = WORK[kind]()
    entered, clock = [], []
    real_rf = torch.profiler.record_function

    def counting_rf(*args, **kw):
        entered.append(args)
        return real_rf(*args, **kw)

    def counting_clock():
        clock.append(1)
        return 0.0

    monkeypatch.setattr(torch.profiler, "record_function", counting_rf)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=counting_clock))
    assert not profiling.recording()
    work()
    assert entered == [] and clock == []
    assert profiling.take_spans() == []
    # the same context object every time: nothing is built when off
    assert profiling.span("qmm", rows=1) is profiling.span("kv_append")


def _traced(kind, tmp_path):
    """Run ``kind``'s work under the profiler: the trace's fcsa ranges
    (name, start, end) in order of their starts, and the records."""
    work = WORK[kind]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    records = profiling.take_spans()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted(((e["name"][len("fcsa."):], float(e["ts"]),
                      float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("ph") == "X"
                     and e.get("name", "").startswith("fcsa.")),
                    key=lambda r: (r[1], -r[2]))
    return ranges, records


def _enclosing(ranges):
    """Each range's innermost enclosing range's index (None at the top)."""
    out = []
    for i, (_, s, e) in enumerate(ranges):
        holders = [j for j, (_, s2, e2) in enumerate(ranges)
                   if j != i and s2 <= s and e <= e2
                   and (s2, -e2) < (s, -e)]
        out.append(max(holders, key=lambda j: (ranges[j][1], -ranges[j][2]),
                       default=None))
    return out


NESTING = {
    "serve": {
        "engine.add_request": None, "prefill": "engine.add_request",
        "engine.step": None, "decode_step": "engine.step",
        "decode_attention": "decode_step", "engine.sync": "engine.step",
    },
    "train": {
        "train.step": None, "train.micro": "train.step",
        "attention.fwd": "train.micro", "attention.bwd": "train.micro",
        "train.update": "train.step",
    },
}


@pytest.mark.parametrize("kind", sorted(WORK))
def test_ranges_nest_as_the_layers_do(tmp_path, kind):
    ranges, _ = _traced(kind, tmp_path)
    parent = _enclosing(ranges)
    names = [r[0] for r in ranges]
    for i, name in enumerate(names):
        up = None if parent[i] is None else names[parent[i]]
        if name in NESTING[kind]:
            assert up == NESTING[kind][name], (name, up)
    if kind == "serve":
        # the append, the decode attention and every int8 product of the
        # step lie inside its decode_step; the prefill's inside prefill
        step = names.index("engine.step")
        for i, name in enumerate(names):
            if name in ("kv_append", "qmm", "attention.fwd"):
                want = "decode_step" if i > step else "prefill"
                assert names[parent[i]] == want, (i, name)
            if name == "engine.sample":
                want = "engine.step" if i > step else "engine.add_request"
                assert names[parent[i]] == want, (i, name)
        assert names.count("decode_attention") == DEPTH
        # 4 products a layer and the logits, in the prefill and the step
        assert names.count("qmm") == 2 * (4 * DEPTH + 1)
        assert names.count("engine.sample") == 2
    else:
        assert names.count("train.micro") == 2
        assert names.count("attention.fwd") == 2 * DEPTH
        assert names.count("attention.bwd") == 2 * DEPTH
        micros = [r for r in ranges if r[0] == "train.micro"]
        update = next(r for r in ranges if r[0] == "train.update")
        assert update[1] >= max(m[2] for m in micros)


@pytest.mark.parametrize("kind", sorted(WORK))
def test_records_pair_with_ranges(tmp_path, kind):
    ranges, records = _traced(kind, tmp_path)
    assert [r.name for r in records] == [r[0] for r in ranges]
    parent = _enclosing(ranges)
    ids = [r.id for r in records]
    for i, rec in enumerate(records):
        want = None if parent[i] is None else ids[parent[i]]
        assert rec.parent == want, (i, rec)
        assert rec.end >= rec.start > 0
    by = {}
    for rec in records:
        by.setdefault(rec.name, []).append(rec.attrs)
    if kind == "serve":
        assert by["engine.add_request"] == [
            {"slot": 0, "rows": PROMPT, "width": 16}]
        assert by["prefill"] == [{"batch": 1, "width": 16}]
        assert by["engine.step"] == [
            {"slots": 1, "live": PROMPT + 1, "chunk": False}]
        assert by["decode_step"] == [{"slots": 2}]
        assert {a["rows"] for a in by["qmm"]} == {16, 2}
        assert {a["t"] for a in by["kv_append"]} == {16, 1}
    else:
        assert by["train.step"] == [{"micro": 2}]
        assert by["train.micro"] == [{"i": 0}, {"i": 1}]
        assert by["train.update"] == [{}]
        # the CPU backward is the plain version, whatever the card would run
        assert by["attention.bwd"] == [{"route": "plain"}] * (2 * DEPTH)
