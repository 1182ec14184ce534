"""The port's tensor parallelism against the JAX package's on the CPU.

One gloo world of 4 CPU processes (``tests/torch_parallel_worker.py``,
``file://`` rendezvous under a temporary directory) builds a (2, 2) and a
(1, 4) mesh and runs every case once; this process computes the JAX side
on ``tests/conftest.py``'s 8 virtual devices with meshes of the same
shapes (JAX's own checks in tests/test_parallel.py).  Bars: f32 outputs
1e-4 against JAX's sharded result and 1e-5 against the port's own
unsharded one; gradients relative to max|g|.
"""

import multiprocessing
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from flash_cosine_sim_attention_tpu import l2norm_tensors as jax_l2norm
from flash_cosine_sim_attention_tpu.models import (
    CosineSimCausalTransformer as JaxModel,
)
from flash_cosine_sim_attention_tpu.parallel import (
    head_sharded_decode_attention as jax_sharded_decode,
    head_sharded_flash_attention as jax_sharded_attention,
    make_mesh as jax_mesh,
    make_sharded_train_step as jax_train_step,
    param_shardings as jax_param_shardings,
    shard_cache as jax_shard_cache,
    shard_params as jax_shard_params,
)
from flash_cosine_sim_attention_tpu.quant import (
    append as jax_append,
    init_cache as jax_init_cache,
)
from flash_cosine_sim_attention_tpu.serving import (
    InferenceEngine as JaxEngine,
)
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    flax_param_shapes,
)
from flash_cosine_sim_attention_tpu_torch.parallel import make_mesh
from flash_cosine_sim_attention_tpu_torch.utils import restore_checkpoint

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TRAIN = dict(num_tokens=64, dim=64, depth=2, max_seq_len=32, heads=8,
             dim_head=16, pre_norm=True)
SERVE = dict(num_tokens=64, dim=64, depth=2, max_seq_len=256, heads=8,
             dim_head=16, pre_norm=True, attn_scale=1.0)
# JAX meshes of the port's shapes: (data, model)
MESHES = {"2x2": (4, 2), "1x4": (4, 4)}


def _flax(cfg, seed):
    """(JAX model, its params, the same as numpy): random weights in the
    flax layout from a numpy seed."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "kernel":
            return rng.standard_normal(shape, np.float32) / np.sqrt(shape[0])
        if name == "embedding":
            return 0.02 * rng.standard_normal(shape, np.float32)
        return (np.ones if name == "scale" else np.zeros)(shape, np.float32)

    def walk(node):
        return {k: leaf(k, v) if isinstance(v, tuple) else walk(v)
                for k, v in node.items()}
    params = walk(flax_param_shapes(
        CosineSimCausalTransformer(**cfg, device="meta")))
    return (JaxModel(**cfg, dtype=jnp.float32),
            {"params": jax.tree.map(jnp.asarray, params)}, params)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    attention = [
        ("4d", "2x2", (f32(2, 4, 64, 32), f32(2, 4, 64, 32),
                       f32(2, 4, 64, 32))),
        ("3d", "2x2", (f32(2, 4, 64, 32), f32(2, 64, 32), f32(2, 64, 32))),
        ("gqa2", "1x4", (f32(2, 8, 64, 32), f32(2, 2, 64, 32),
                         f32(2, 2, 64, 32))),
        ("gqa4", "1x4", (f32(2, 8, 64, 32), f32(2, 4, 64, 32),
                         f32(2, 4, 64, 32))),
        ("mask", "2x2", (f32(2, 4, 64, 32), f32(2, 4, 64, 32),
                         f32(2, 4, 64, 32), rng.random((2, 64)) > 0.3)),
    ]
    decode = (f32(2, 8, 32), f32(2, 8, 50, 32), f32(2, 8, 50, 32), 64)
    x = rng.integers(0, 64, (4, 33))
    jax_side = {}
    train = []
    for name, mesh_name, kvh in (("dense", "2x2", None), ("gqa2", "2x2", 2),
                                 ("gqa2_replicated", "1x4", 2)):
        cfg = dict(TRAIN, kv_heads=kvh)
        jmodel, jparams, params = _flax(cfg, 1)
        jax_side[name] = (jmodel, jparams, cfg)
        train.append((name, mesh_name, cfg, params, x))
    serving = []
    for name, kvh, quantized in (("dense", None, False), ("gqa4", 4, False),
                                 ("int8_fused_mqa", 1, True)):
        cfg = dict(SERVE, kv_heads=kvh)
        jmodel, jparams, params = _flax(cfg, 2)
        jax_side["serve_" + name] = (jmodel, jparams)
        serving.append((name, cfg, params, quantized))
    rules_cfg = dict(SERVE, depth=1)
    return dict(attention=attention, decode=decode, train=train,
                serving=serving, rules=(rules_cfg, _flax(rules_cfg, 3)[2]),
                x=x), jax_side


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, JAX models, rank 0's results) of one run of the world."""
    import torch_parallel_worker

    workdir = tmp_path_factory.mktemp("tp_world")
    inputs, jax_side = _inputs()
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_parallel_worker.run,
                         args=(rank, WORLD, str(workdir)))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join(timeout=30)
    errors = [f.read_text() for f in sorted(workdir.glob("error-*.txt"))]
    assert not errors, errors[0]
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(workdir / "results.pkl", "rb") as f:
        results = pickle.load(f)
    return inputs, jax_side, results


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-30)


@pytest.mark.parametrize("name", ["4d", "3d", "gqa2", "gqa4", "mask"])
def test_head_sharded_attention_matches_jax(world, name):
    """Causal, or non-causal with a key mask (the mask shards over data)."""
    inputs, _, results = world
    _, mesh_name, (q, k, v, *mask) = next(c for c in inputs["attention"]
                                          if c[0] == name)
    got = results["attention"][name]
    mesh = jax_mesh(*MESHES[mesh_name][:1],
                    model_parallel=MESHES[mesh_name][1])
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kw = (dict(mask=jnp.asarray(mask[0])) if mask else dict(causal=True))
    want = jax_sharded_attention(jq, jk, jv, mesh, **kw)
    assert np.abs(got["o"] - np.asarray(want)).max() < 1e-4
    assert np.abs(got["o"] - got["o_local"]).max() < 1e-5
    if name == "4d":
        # every rank's gradients of the full inputs, against the unsharded
        # op's (held to JAX's by tests/test_torch_backward.py)
        for g, gl in zip(got["grads"], got["grads_local"]):
            assert _rel(g, gl) < 1e-5


def test_head_sharded_decode_matches_jax(world):
    inputs, _, results = world
    q, k, v, cap = inputs["decode"]
    got = results["decode"]
    b, h, _, d = k.shape
    cache = jax_append(jax_init_cache(b, h, cap, d),
                       jax_l2norm(jnp.asarray(k)), jnp.asarray(v))
    for mesh_name, (n, tp) in MESHES.items():
        mesh = jax_mesh(n, model_parallel=tp)
        want = jax_sharded_decode(jnp.asarray(q), jax_shard_cache(cache, mesh),
                                  mesh, use_kernel=False)
        assert np.abs(got[mesh_name] - np.asarray(want)).max() < 1e-4
        assert np.abs(got[mesh_name] - got["o_local"]).max() < 1e-5
    assert "kv_heads=2" in got["misaligned"]
    assert got["mqa"] == ["S(0)", "R"]


def test_param_sharding_rules_match_jax(world):
    """JAX's (in, out) specs in the port's (out, in) Dense axes: column
    P(None, "model") is the weight's dim 0, row P("model", None) its dim
    1; a QuantDense keeps JAX's (in, out) codes, its scales follow the
    column split and stay whole under the row split."""
    inputs, _, results = world
    cfg, params = inputs["rules"]
    jp = {"params": jax.tree.map(jnp.asarray, params)}
    specs = jax_param_shardings(jp, jax_mesh(4, model_parallel=4))
    jspec = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
             for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    P = jax.sharding.PartitionSpec
    port = results["rules"]["plain"]
    pairs = {"params/attn_0/to_q/kernel": "attn.0.to_q.weight",
             "params/attn_0/to_k/kernel": "attn.0.to_k.weight",
             "params/attn_0/to_out/kernel": "attn.0.to_out.weight",
             "params/ff_0/Dense_0/kernel": "ff.0.proj_in.weight",
             "params/ff_0/Dense_1/kernel": "ff.0.proj_out.weight",
             "params/token_emb/embedding": "token_emb.weight",
             "params/to_logits/kernel": "to_logits.weight"}
    as_port = {P(None, "model"): ["R", "S(0)"], P("model", None):
               ["R", "S(1)"], P(): ["R", "R"]}
    for jname, name in pairs.items():
        assert port[name] == as_port[jspec[jname]], name
    quant = results["rules"]["quant"]
    assert quant["attn.0.to_q.weight_q"] == ["R", "S(1)"]
    assert quant["attn.0.to_q.weight_scale"] == ["R", "S(1)"]
    assert quant["attn.0.to_out.weight_q"] == ["R", "S(0)"]
    assert quant["attn.0.to_out.weight_scale"] == ["R", "R"]
    assert results["rules"]["fused_split_err"] == 0.0


@pytest.mark.parametrize("name", ["dense", "gqa2", "gqa2_replicated"])
def test_sharded_train_step_matches_jax(world, name):
    inputs, jax_side, results = world
    got = results["train"][name]
    jmodel, jparams, cfg = jax_side[name]
    x = jnp.asarray(inputs["x"])
    mesh_name = next(c[1] for c in inputs["train"] if c[0] == name)
    mesh = jax_mesh(*MESHES[mesh_name][:1],
                    model_parallel=MESHES[mesh_name][1])
    jm = JaxModel(**cfg, dtype=jnp.float32, mesh=mesh)
    tx = optax.adam(1e-3)
    p1 = jax_shard_params(jparams, mesh)
    _, _, want = jax_train_step(jm, tx, mesh)(p1, tx.init(p1), x)
    assert abs(got["loss"] - got["loss_local"]) < 1e-5
    assert abs(got["loss"] - float(want)) < 1e-4
    assert got["grad_err"] < 1e-5
    assert got["moved"] > 0
    tp = MESHES[mesh_name][1]
    kvh = cfg["kv_heads"] or cfg["heads"]
    assert got["local_heads"] == (
        cfg["heads"] // tp, kvh if kvh % tp else kvh // tp, bool(kvh % tp))


def test_shard_opt_state_round_trips(world):
    assert world[2]["train"]["opt_state"] == dict(
        shapes_ok=True, slice_ok=True, exact=True)


@pytest.mark.parametrize("name", ["dense", "gqa4", "int8_fused_mqa"])
def test_tp_serving_engine_matches_local(world, name):
    _, jax_side, results = world
    got = results["serving"][name]
    agree = sum(a == b for a, b in zip(got["local"], got["tp"]))
    assert agree >= 4, got
    kvh = {"dense": 8, "gqa4": 4, "int8_fused_mqa": 1}[name]
    assert got["local_kv_heads"] == (kvh // 4 if kvh % 4 == 0 else kvh)
    assert got["paged_refused"]   # JAX's paged engine has no mesh either
    if name == "dense":
        assert got["logit_err"] < 1e-5
        assert got["chunked_tp"] == got["chunked_local"]
        jmodel, jparams = jax_side["serve_dense"]
        jeng = JaxEngine(jmodel, jparams, num_slots=2, capacity=256,
                         prompt_buckets=(16, 32), temperature=1e-4, seed=3)
        s = jeng.add_request(np.arange(11) % 64)
        want = [int(jeng.last_token[s])] + [jeng.step()[s] for _ in range(4)]
        assert sum(a == b for a, b in zip(want, got["tp"])) >= 4, want


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")
    assert not dist.is_initialized()


def test_trainer_model_parallel_under_torchrun(tmp_path):
    """--model-parallel 2 on two gloo ranks: a step, then a checkpoint of
    the full weights that restores into a single-device model."""
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m",
           "flash_cosine_sim_attention_tpu_torch.train", "--device", "cpu",
           "--model-parallel", "2", "--steps", "2", "--dim", "32",
           "--depth", "1", "--seq-len", "32", "--batch-size", "2",
           "--checkpoint-dir", str(ck), "--checkpoint-every", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh: data=1 model=2" in proc.stdout
    assert proc.stdout.count("step 0  loss") == 1   # rank 0 alone prints
    model = CosineSimCausalTransformer(
        num_tokens=256, dim=32, depth=1, max_seq_len=32, attn_scale=1.0,
        attn_l2norm_groups=8, pre_norm=True, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    assert restore_checkpoint(str(ck), model, opt) == 1


def test_trainer_pipeline_parallel_still_raises():
    from flash_cosine_sim_attention_tpu_torch import train
    with pytest.raises(NotImplementedError):
        train.main(["--device", "cpu", "--pipeline-parallel", "2"])
