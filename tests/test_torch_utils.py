"""The port's public surface and utils/ against the JAX package on the CPU
(JAX's own checks in tests/test_debug.py), and cached decoding's capacity
guard."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_cosine_sim_attention_tpu as jfcsa
import flash_cosine_sim_attention_tpu_torch as fcsa
from flash_cosine_sim_attention_tpu.utils import (
    xla_naive_cosine_sim_attention as jax_naive,
)
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    generate_cached,
)
from flash_cosine_sim_attention_tpu_torch.utils import (
    StepTimer,
    benchmark,
    checkify_attention,
    debug_attention,
    naive_cosine_sim_attention,
    trace,
    xla_naive_cosine_sim_attention,
)

ROOT = Path(__file__).resolve().parents[1]


def _inputs(seed=0, shape=(1, 2, 64, 64)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32) for _ in range(3))


def test_top_level_exports_match_jax():
    assert set(fcsa.__all__) == set(jfcsa.__all__)
    assert fcsa.debug() is None
    from flash_cosine_sim_attention_tpu_torch import ops
    assert ops.debug is fcsa.debug
    assert xla_naive_cosine_sim_attention is naive_cosine_sim_attention


def test_checkify_clean_inputs_pass():
    q, k, v = map(torch.from_numpy, _inputs())
    err, out = checkify_attention(causal=True)(q, k, v)
    err.throw()
    assert err.get() is None and out.shape == q.shape


def test_checkify_catches_nan():
    q, k, v = map(torch.from_numpy, _inputs())
    v[0, 0, 3, :] = float("nan")
    err, _ = checkify_attention(causal=True)(q, k, v)
    with pytest.raises(FloatingPointError, match="non-finite"):
        err.throw()


def test_debug_report():
    q, k, v = map(torch.from_numpy, _inputs())
    rep = debug_attention(q, k, v, causal=True)
    assert rep["fused_finite"] and rep["oracle_finite"]
    assert rep["max_abs_diff"] < 1e-4
    assert rep["shape"] == (1, 2, 64, 64)
    assert rep["dtype"] == "torch.float32" and rep["backend"] == "cpu"
    assert set(rep) == {"max_abs_diff", "mean_abs_diff", "fused_finite",
                        "oracle_finite", "shape", "dtype", "backend"}


@pytest.mark.parametrize("mode", ["fwd", "fwd+bwd", "bwd"])
def test_benchmark_utility_smoke(mode):
    x = torch.ones(128, 128)
    w = torch.ones(128, 128)
    kw = dict(forwards=mode != "bwd", backwards=mode != "fwd", num_times=4,
              grad_argnums=(0,))
    assert benchmark(lambda x, w: x @ w, x, w, **kw) >= 0.0


def test_profiling_trace_and_step_timer(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "trace.json").stat().st_size > 0
    timer = StepTimer(window=2)
    for _ in range(4):
        timer.tick()
    assert timer.mean_step_s > 0 and timer.tokens_per_sec(10) > 0


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_naive_matches_jax(causal, masked):
    q, k, v = _inputs(1, (2, 2, 48, 32))
    mask = (np.random.default_rng(2).random((2, 48)) > 0.3
            if masked else None)
    want = jax_naive(*map(jnp.asarray, (q, k, v)),
                     mask=None if mask is None else jnp.asarray(mask),
                     scale=8.0, causal=causal)
    got = naive_cosine_sim_attention(
        *map(torch.from_numpy, (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask),
        scale=8.0, causal=causal)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4


def test_benchmark_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "flash_cosine_sim_attention_tpu_torch.benchmark",
         "--seq-lens", "128", "--num-times", "2", "--only-forwards",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = [ln.split() for ln in proc.stdout.splitlines()[2:]]
    assert [r[:2] for r in rows] == [["float32", "128"], ["bfloat16", "128"]]
    assert all(float(r[2]) > 0 and r[3] == "-" for r in rows)


def test_generate_cached_refuses_past_capacity():
    torch.manual_seed(0)
    model = CosineSimCausalTransformer(num_tokens=64, dim=32, max_seq_len=64,
                                       depth=1, heads=2, dim_head=16,
                                       device="cpu")
    prime = torch.randint(0, 64, (1, 6))
    with pytest.raises(ValueError) as e:
        generate_cached(model, prime, 16, 16, device="cpu")
    assert "21" in str(e.value) and "capacity 16" in str(e.value)
    out = generate_cached(model, prime[:, :1], 16, 16, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 16)
