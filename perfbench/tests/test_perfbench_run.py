"""``run.py`` refuses a machine without the card, and on the card runs
every cell correct (the one test here that needs the card)."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
RUN = [sys.executable, str(REPO / "perfbench" / "run.py")]


def test_without_a_card_it_exits_nonzero_and_prints_no_metric(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(RUN + ["--workload", "val-train-s16k", "--seed",
                                 str(2**31 + 5), "--seconds", "1",
                                 "--trace", "0"], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "metrics" not in proc.stderr


@pytest.mark.parametrize("name", ["val-train-s1024", "prod-prefill-heavy"])
def test_result_line_on_the_cpu(tiny_cell, name):
    """The rest of a run past the look for a card: the result's keys, the
    cell's end-to-end metrics by name, the checks last."""
    spec = importlib.util.spec_from_file_location("perfbench_run",
                                                  REPO / "perfbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    cell = tiny_cell(name)
    result = run.execute(cell, 2**31 + 3, 0.5, False, torch.device("cpu"))
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["checks"]) == set(cell.check["limits"])
    json.dumps(result)


@pytest.mark.cuda
def test_every_cell_runs_correct_on_the_card(card, bench):
    for w in bench["workloads"]:
        proc = subprocess.run(RUN + ["--workload", w["name"], "--seed",
                                     str(2**31 + 11), "--seconds", "3",
                                     "--trace", "0"], capture_output=True,
                              text=True, cwd=REPO, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-3000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"], (w["name"], result["checks"])
        assert result["device"]["platform"] == "gpu"
