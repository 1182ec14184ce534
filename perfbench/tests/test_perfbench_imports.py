"""Nothing the harness runs loads JAX or the JAX package, compared by
whole top-level module name, and the reference imports nothing of the
program either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from perfbench import core

HERE = Path(__file__).resolve().parents[1]
PORT = "flash_cosine_sim_attention_tpu_torch"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_top_level_names():
    assert core.banned_modules([PORT, f"{PORT}.ops", "jaxtyping",
                                "perfbench.run"]) == []
    assert core.banned_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                                "flax.linen", "optax",
                                "flash_cosine_sim_attention_tpu",
                                "flash_cosine_sim_attention_tpu.ops"]) == [
        "flash_cosine_sim_attention_tpu", "flash_cosine_sim_attention_tpu.ops",
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "optax"]


def test_no_file_of_the_harness_imports_jax():
    files = sorted(HERE.rglob("*.py"))
    bad = [(str(f), n) for f in files for n in _imports(f)
           if n.split(".")[0] in core.BANNED]
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").glob("*.py")):
        names = list(_imports(f))
        assert not [n for n in names if n.split(".")[0] == PORT], f
        assert not [n for n in names if n.split(".")[0] == "perfbench"], f


def test_a_run_loads_no_jax():
    """Drive both kinds of cell at a tiny size on the CPU in a fresh
    process, then look at what it loaded."""
    code = f"""
import sys, time, json
sys.path.insert(0, {str(HERE.parent)!r})
sys.path.insert(0, {str(HERE / 'tests')!r})
import torch
from perfbench import core
from conftest import cut
bench = json.load(open({str(HERE.parent / 'BENCHMARK.json')!r}))
for name in ("val-train-s1024", "prod-prefill-heavy"):
    cell = cut(core.Cell.load(bench, name))
    cell.check = dict(cell.check, sample_tokens=10)
    core.load_module("drivers", cell.traffic["kind"]).run(
        cell, 5, 0.5, False, torch.device("cpu"), time.perf_counter(),
        lambda *a: None)
assert {PORT!r} in sys.modules
print(core.banned_modules())
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
