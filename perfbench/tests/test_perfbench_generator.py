"""The traffic generator repeats for a seed, and every seed asks for the
same sizes."""

import numpy as np
import pytest
import torch

from perfbench import core, generator

SEED = 2**31 + 977           # past 32 signed bits, as the driver's are


def draw(mix, seed, n):
    reqs = generator.Requests(mix, seed, 256)
    return [reqs.next() for _ in range(n)]


@pytest.mark.parametrize("traffic", ["closed-128-long", "closed-16-prefill"])
def test_requests_repeat_for_a_seed(traffic):
    mix = core.load_json("traffic", traffic)
    a, b = draw(mix, SEED, 70), draw(mix, SEED, 70)
    assert [r.out_len for r in a] == [r.out_len for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = draw(mix, SEED + 1, 70)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]


@pytest.mark.parametrize("traffic", ["closed-128-long", "closed-16-prefill"])
def test_every_seed_asks_for_the_same_sizes(traffic):
    mix = core.load_json("traffic", traffic)
    n = mix["strata"]
    sizes = [sorted((len(r.prompt), r.out_len) for r in draw(mix, s, n))
             for s in (1, SEED)]
    assert sorted(x for x, _ in sizes[0]) == sorted(x for x, _ in sizes[1])
    assert sorted(y for _, y in sizes[0]) == sorted(y for _, y in sizes[1])
    for r in draw(mix, SEED, 3 * n):
        assert mix["prompt"]["min"] <= len(r.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= r.out_len <= mix["output"]["max"]
        assert r.prompt.dtype == np.int32 and r.prompt.max() < 256


def test_quantiles_cover_the_range():
    uni = {"dist": "uniform", "min": 4, "max": 16}
    assert [generator.quantile(uni, (i + 0.5) / 13) for i in range(13)] == \
        list(range(4, 17))
    log = {"dist": "log_uniform", "min": 256, "max": 1024}
    qs = [generator.quantile(log, (i + 0.5) / 64) for i in range(64)]
    assert qs == sorted(qs) and qs[0] >= 256 and qs[-1] <= 1024
    assert 480 <= qs[32] <= 540        # the geometric mean, 512


def test_in_flight_requests_are_part_served():
    mix = core.load_json("traffic", "closed-128-long")
    reqs = generator.Requests(mix, SEED, 256)
    outs = [reqs.in_flight().out_len for _ in range(256)]
    assert min(outs) >= 1 and max(outs) <= mix["output"]["max"]
    assert min(outs) < mix["output"]["min"]


@pytest.mark.parametrize("traffic", ["train-b4-s16384", "train-b16x4-s1024"])
def test_batches_repeat_and_rows_differ(traffic):
    mix = dict(core.load_json("traffic", traffic), seq_len=32)
    a = generator.Batches(mix, SEED, 256, torch.device("cpu"))
    b = generator.Batches(mix, SEED, 256, torch.device("cpu"))
    x, y = a.next(), b.next()
    assert torch.equal(x, y) and not torch.equal(a.next(), x)
    assert x.shape == (mix["grad_accum"], mix["batch"], 33)
    rows = x.reshape(-1, 33)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert a.tokens == mix["grad_accum"] * mix["batch"] * 32


def test_derived_seeds_differ_by_stream():
    assert generator.derive_seed(SEED, "weights") != generator.derive_seed(
        SEED, "batches")
    assert generator.derive_seed(SEED, "weights") == generator.derive_seed(
        SEED, "weights")
    assert 0 <= generator.derive_seed(2**62, "x") < 2**63


def test_a_block_in_flight_leaves_the_same_tokens_for_every_seed():
    mix = core.load_json("traffic", "closed-128-long")
    n = mix["strata"]

    def left(seed):
        reqs = generator.Requests(mix, seed, 256)
        return sorted(reqs.in_flight().out_len for _ in range(2 * n))

    assert left(1) == left(SEED) == left(SEED + 1)
    reqs = generator.Requests(mix, SEED, 256)
    flying = [reqs.in_flight() for _ in range(n)]
    fresh = draw(mix, SEED, n)
    assert all(1 <= f.out_len <= r.out_len for f, r in zip(flying, fresh))
    assert [len(f.prompt) for f in flying] == [len(r.prompt) for r in fresh]
