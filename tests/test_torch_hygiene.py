"""The port stands alone: no JAX anywhere in it, and no quiet CPU fallback
in its entry points."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "flash_cosine_sim_attention_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "flash_cosine_sim_attention_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_smoke_script_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if name.split(".")[0] in BANNED]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import flash_cosine_sim_attention_tpu_torch\n"
            "import flash_cosine_sim_attention_tpu_torch.models\n"
            "import flash_cosine_sim_attention_tpu_torch.serving\n"
            "import flash_cosine_sim_attention_tpu_torch.data\n"
            "import flash_cosine_sim_attention_tpu_torch.utils\n"
            "import flash_cosine_sim_attention_tpu_torch.train\n"
            "loaded = [m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED!r}]\n"
            "assert not loaded, loaded\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_to_run_on_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer, init_decode_state)
    from flash_cosine_sim_attention_tpu_torch.serving import InferenceEngine

    kw = dict(num_tokens=16, dim=32, max_seq_len=16, depth=1, heads=2,
              dim_head=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        CosineSimCausalTransformer(**kw)
    model = CosineSimCausalTransformer(**kw, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, capacity=16, prompt_buckets=(16,))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_state(model, 1, 16)
    from flash_cosine_sim_attention_tpu_torch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
    with pytest.raises(NotImplementedError):
        train.main(["--device", "cpu", "--model-parallel", "2"])
