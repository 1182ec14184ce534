"""Shared pieces of the harness's tests: the benchmark's files, and its
cells cut to a size the CPU runs in seconds (the program takes its plain
PyTorch versions there)."""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import core  # noqa: E402

TINY_TRAFFIC = {
    "train": {"batch": 2, "grad_accum": 2, "seq_len": 64},
    "serve": {"slots": 3, "capacity": 96, "prompt_buckets": [16, 32, 64],
              "prompt": {"dist": "log_uniform", "min": 8, "max": 40},
              "output": {"dist": "uniform", "min": 12, "max": 16}},
}


def cut(cell: core.Cell) -> core.Cell:
    """``cell`` with its model cut to the CPU size its family's ``tiny``
    gives, its traffic to ``TINY_TRAFFIC`` and its check to 60 served
    tokens; its limits are the cell's own."""
    cell.config = core.arch(cell.config).tiny(cell.config)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[cell.traffic["kind"]])
    if "sample_tokens" in cell.check:
        cell.check = dict(cell.check, sample_tokens=60)
    return cell


@pytest.fixture(scope="session")
def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def tiny_cell(bench):
    """``tiny_cell(name)``: the cell with its widths and traffic cut so
    that a run takes seconds on the CPU; its limits are the cell's own.
    Served requests get at least 12 tokens and the check holds 60, so
    that decode steps, not prefills, serve most of what is compared."""
    def make(name):
        return cut(core.Cell.load(bench, name))
    return make


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
