"""The comparison that decides ``correct``, shown to fail: each cell's
run with the timed path broken underneath comes out not correct, the
same run unbroken comes out correct, and the control (the reference in
float8 e4m3 operands) reads above a limit.  The harness's look for a
card is skipped: the drivers run on the CPU at a tiny size, where the
program takes its plain PyTorch versions, against each cell's own
limits."""

import time

import pytest
import torch

import flash_cosine_sim_attention_tpu_torch.serving.engine as port_engine
import flash_cosine_sim_attention_tpu_torch.train as port_train
from perfbench import core, generator
from perfbench.reference import compare
from perfbench.reference import model as ref

CPU = torch.device("cpu")
SEED = 2**31 + 4099
TRAIN = ("val-train-s16k", "val-train-s1024")
SERVE = ("prod-decode-long", "prod-prefill-heavy")


def correct(cell, seconds=1.0):
    out = core.load_module("drivers", cell.traffic["kind"]).run(
        cell, SEED, seconds, False, CPU, time.perf_counter(), lambda *a: None)
    return out.failed == 0 and all(v <= lim for v, lim in out.checks.values())


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_sound_run_is_correct(tiny_cell, name):
    assert correct(tiny_cell(name))


def state_unchanged(model, optimizer, batches):
    """A training step that computes its loss and gradients and leaves
    the parameters and the optimizer as they were."""
    optimizer.zero_grad(set_to_none=True)
    losses = []
    for batch in batches:
        loss = model(batch, return_loss=True)
        loss.backward()
        losses.append(loss.detach())
    return torch.stack(losses).mean()


def half_batch(model, optimizer, batches, step=port_train.train_step):
    """Half of each microbatch left out, the mean taken over the rest."""
    return step(model, optimizer, batches[:, :batches.shape[1] // 2])


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_broken_training_step_is_not_correct(tiny_cell, monkeypatch, name,
                                             fault):
    monkeypatch.setattr(port_train, "train_step", fault)
    assert not correct(tiny_cell(name))


def altered_token(self, logits, sample=port_engine.SlotEngine._sample):
    """Every sampled token altered where it is produced."""
    return (sample(self, logits) + 1) % logits.shape[-1]


def decode_state_unchanged(model, state, token, mesh=None, active=None,
                           step=port_engine.decode_step):
    """A decode step that returns the cache state it was given."""
    logits, _ = step(model, state, token, mesh=mesh, active=active)
    return logits, state


@pytest.mark.parametrize("name", SERVE)
def test_altered_token_is_not_correct(tiny_cell, monkeypatch, name):
    monkeypatch.setattr(port_engine.SlotEngine, "_sample", altered_token)
    assert not correct(tiny_cell(name))


@pytest.mark.parametrize("name", SERVE)
def test_unchanged_decode_state_is_not_correct(tiny_cell, monkeypatch, name):
    monkeypatch.setattr(port_engine, "decode_step", decode_state_unchanged)
    assert not correct(tiny_cell(name))


@pytest.mark.parametrize("name", TRAIN)
def test_control_fails_a_training_limit(tiny_cell, name):
    cell = tiny_cell(name)
    drv = core.load_module("drivers", "train")
    exact = drv.reference(cell.config, cell.traffic, SEED, CPU)
    low = drv.reference(cell.config, cell.traffic, SEED, CPU, rnd=ref.fp8)
    numbers = compare.train_numbers(low, exact)
    limits = cell.check["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


# at the tiny widths float8's error moves few argmaxes; four layers of
# 256 over 24 requests show it on every seed tried (six), as the cells'
# own widths do on the chip
CONTROL_MODEL = {"dim": 256, "depth": 4, "heads": 4, "dim_head": 64}


@pytest.mark.parametrize("name", SERVE)
def test_control_fails_the_serving_limit(tiny_cell, name):
    """The control's gap over 24 of the mix's prompts, each with as many
    tokens after it as the mix serves (drawn at random: the control
    reads every position of whatever sequence it is given)."""
    cell = tiny_cell(name)
    cell.config.update(CONTROL_MODEL)
    drv = core.load_module("drivers", "serve")
    W = drv.reference_weights(cell.config,
                              generator.derive_seed(SEED, "weights"), CPU)
    requests = generator.Requests(cell.traffic, SEED, 256)
    widest = 0.0
    for _ in range(24):
        req = requests.next()
        req.served = requests.rng.integers(0, 256, req.out_len).tolist()
        rows = drv.reference_rows(W, cell.config, req, CPU)
        low = drv.reference_rows(W, cell.config, req, CPU, ref.fp8)
        widest = max(widest, compare.served_gaps(rows, low.argmax(-1)).max()
                     .item())
    assert widest > cell.check["limits"]["logit_gap"]
