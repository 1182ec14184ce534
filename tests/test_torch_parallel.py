"""The port's tensor, sequence and pipeline parallelism against the JAX
package's on the CPU.

One gloo world of 4 CPU processes (``tests/torch_parallel_worker.py``,
``file://`` rendezvous under a temporary directory) builds (data, model)
meshes of (2, 2) and (1, 4), ("seq",) and (model, seq) meshes and (pipe,)
and (data, pipe) meshes, and runs every case once; this process computes
the JAX side on ``tests/conftest.py``'s 8 virtual devices with meshes of
the same shapes (JAX's own checks in tests/test_parallel.py and
tests/test_pipeline.py), the ring's and the pipeline's while the world
runs.  Bars: f32 outputs 1e-4 against JAX's sharded result and 1e-5
against the port's own unsharded one; gradients relative to max|g|; the
ring at JAX's ring bars (f32 1e-4 / 5e-4, bf16 1.5e-1 / 3e-1) against
JAX's ring, the pipeline at 5e-6 against the plain model and JAX's
pipeline.
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
    make_pipeline_loss_fn as jax_pipeline_loss_fn,
    make_pipeline_mesh as jax_pipeline_mesh,
    make_sharded_train_step as jax_train_step,
    merge_pipeline_params as jax_merge_pipeline,
    param_shardings as jax_param_shardings,
    ring_flash_cosine_sim_attention as jax_ring,
    shard_cache as jax_shard_cache,
    shard_params as jax_shard_params,
    split_pipeline_params as jax_split_pipeline,
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
from flash_cosine_sim_attention_tpu_torch.parallel import (
    make_mesh,
    merge_pipeline_params,
    split_pipeline_params,
)
from flash_cosine_sim_attention_tpu_torch.parallel import mesh as port_mesh
from flash_cosine_sim_attention_tpu_torch.utils import restore_checkpoint

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TRAIN = dict(num_tokens=64, dim=64, depth=2, max_seq_len=32, heads=8,
             dim_head=16, pre_norm=True)
SERVE = dict(num_tokens=64, dim=64, depth=2, max_seq_len=256, heads=8,
             dim_head=16, pre_norm=True, attn_scale=1.0)
# JAX meshes of the port's shapes: (data, model)
MESHES = {"2x2": (4, 2), "1x4": (4, 4)}
# ring meshes: (shape, axis names); pipeline meshes: pipeline_parallel
RING_MESHES = {"seq4": ((4,), ("seq",)),
               "model2_seq2": ((2, 2), ("model", "seq")),
               "model4_seq1": ((4, 1), ("model", "seq"))}
PIPE_MESHES = {"pipe4": None, "data2_pipe2": 2, "data4_pipe1": 1}
PIPE = dict(num_tokens=64, dim=64, depth=4, max_seq_len=32, heads=4,
            dim_head=16, pre_norm=True, attn_scale=1.0, use_fused=False)
# JAX's ring bars (tests/test_parallel.py): outputs, gradients
RING_BARS = {"float32": (1e-4, 5e-4), "bfloat16": (1.5e-1, 3e-1)}
PIPE_BAR = 5e-6       # tests/test_pipeline.py


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
    # (name, mesh, dtype, kwargs, (q, k, v[, mask])), after
    # tests/test_parallel.py's ring tests at 4-way sequence shards
    qkv = lambda b, h, kvh: (f32(b, h, 128, 32), f32(b, kvh, 128, 32),  # noqa: E731
                             f32(b, kvh, 128, 32))
    ring = [
        ("causal", "seq4", "float32", dict(causal=True), qkv(1, 2, 2)),
        ("noncausal", "seq4", "float32", dict(causal=False), qkv(1, 2, 2)),
        ("gqa1", "seq4", "float32", dict(causal=True), qkv(1, 4, 1)),
        ("gqa2", "seq4", "float32", dict(causal=True), qkv(1, 4, 2)),
        ("mask_causal", "seq4", "float32", dict(causal=True),
         qkv(2, 2, 2) + (rng.random((2, 128)) > 0.3,)),
        ("mask", "seq4", "float32", dict(causal=False),
         qkv(2, 2, 2) + (rng.random((2, 128)) > 0.3,)),
        ("bf16", "seq4", "bfloat16", dict(causal=True), qkv(1, 2, 2)),
        ("model_seq", "model2_seq2", "float32",
         dict(causal=True, model_axis="model"), qkv(1, 4, 2)),
        ("repeat", "model4_seq1", "float32",
         dict(causal=True, model_axis="model"), qkv(1, 8, 2)),
    ]
    # (name, mesh, cfg, params, tokens, stages, microbatches, remat),
    # after tests/test_pipeline.py
    pipeline = []
    for name, mesh_name, depth, fused, b, n_stages, n_micro, remat in (
            ("4x2", "pipe4", 4, False, 4, 4, 2, False),
            ("4x2_remat", "pipe4", 4, False, 4, 4, 2, True),
            ("2x4_data2", "data2_pipe2", 4, False, 8, 2, 4, True),
            ("1x2_data4", "data4_pipe1", 4, False, 8, 1, 2, False),
            ("fused", "data2_pipe2", 2, True, 4, 2, 2, False)):
        cfg = dict(PIPE, depth=depth, use_fused=fused)
        jmodel, jparams, params = _flax(cfg, 4)
        jax_side["pipe_" + name] = (jmodel, jparams)
        pipeline.append((name, mesh_name, cfg, params,
                         rng.integers(0, 64, (b, 33)), n_stages, n_micro,
                         remat))
    return dict(attention=attention, decode=decode, train=train,
                serving=serving, rules=(rules_cfg, _flax(rules_cfg, 3)[2]),
                ring=ring, pipeline=pipeline, x=x), jax_side


def _jax_ring(inputs):
    """JAX's ring on meshes of the port's shapes: (o, dq, dk, dv) of
    sum(o^2), one jitted call a case."""
    out = {}
    for name, mesh_name, dtype, kw, (q, k, v, *mask) in inputs["ring"]:
        shape, axes = RING_MESHES[mesh_name]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(shape),
                                 axes)
        kw = dict(kw, mask=jnp.asarray(mask[0]) if mask else None)

        def loss(q, k, v, kw=kw, mesh=mesh):
            o = jax_ring(q, k, v, mesh, **kw)
            return jnp.sum(o.astype(jnp.float32) ** 2), o
        (_, o), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)))
        out[name] = [np.asarray(t, np.float32) for t in (o, *grads)]
    return out


def _jax_pipeline(inputs, jax_side):
    """JAX's pipelined loss and merged gradients on meshes of the port's
    shapes; the fused case's loss alone, as JAX's own test takes it."""
    out = {}
    for name, mesh_name, cfg, _, x, n_stages, n_micro, remat in \
            inputs["pipeline"]:
        jmodel, jparams = jax_side["pipe_" + name]
        mesh = jax_pipeline_mesh(4, pipeline_parallel=PIPE_MESHES[mesh_name])
        loss_fn = jax_pipeline_loss_fn(jmodel, mesh, n_micro, remat=remat)
        stacked, aux = jax_split_pipeline(jmodel, jparams, n_stages)
        tokens = jnp.asarray(x)
        if cfg["use_fused"]:
            out[name] = (float(loss_fn(stacked, aux, tokens)), None)
            continue
        loss, (gs, ga) = jax.jit(jax.value_and_grad(
            lambda s, a: loss_fn(s, a, tokens), argnums=(0, 1)))(stacked, aux)
        out[name] = (float(loss), jax.tree.map(
            np.asarray, jax_merge_pipeline(jmodel, gs, ga)))
    return out


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
    try:
        # the ring's and the pipeline's JAX side while the world runs
        jax_side["ring"] = _jax_ring(inputs)
        jax_side["pipeline"] = _jax_pipeline(inputs, jax_side)
    finally:
        deadline = time.monotonic() + 300
        while (any(p.is_alive() for p in procs)
               and time.monotonic() < deadline):
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


def test_trainer_pipeline_parallel_still_raises(monkeypatch):
    """--pipeline-parallel runs under torchrun only and excludes
    --model-parallel and multi-host (as in the JAX trainer); multi-host
    with neither --coordinator nor torchrun's environment raises, naming
    --coordinator."""
    from flash_cosine_sim_attention_tpu_torch import train
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--device", "cpu", "--pipeline-parallel", "2"])
    for flag in (["--model-parallel", "2"], ["--num-processes", "2"]):
        with pytest.raises(ValueError, match="exclusive"):
            train.main(["--device", "cpu", "--pipeline-parallel", "2", *flag])
    for name in ("MASTER_ADDR", "MASTER_PORT", "GROUP_RANK",
                 "GROUP_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="--coordinator"):
        train.main(["--device", "cpu", "--num-processes", "2"])
    assert not dist.is_initialized()


def test_trainer_pipeline_parallel_under_torchrun(tmp_path):
    """--pipeline-parallel 2 on two gloo ranks: a step, then a checkpoint
    of the merged full weights and moments that restores into a
    single-device model."""
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m",
           "flash_cosine_sim_attention_tpu_torch.train", "--device", "cpu",
           "--pipeline-parallel", "2", "--steps", "2", "--dim", "32",
           "--depth", "2", "--seq-len", "32", "--batch-size", "2",
           "--checkpoint-dir", str(ck), "--checkpoint-every", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "pipeline mesh: data=1 pipe=2 (n_micro=4)" in proc.stdout
    assert proc.stdout.count("step 0  loss") == 1   # rank 0 alone prints
    model = CosineSimCausalTransformer(
        num_tokens=256, dim=32, depth=2, max_seq_len=32, attn_scale=1.0,
        attn_l2norm_groups=8, pre_norm=True, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    assert restore_checkpoint(str(ck), model, opt) == 1
    # every parameter, every stage's layers included, has its moments
    assert len(opt.state) == len(list(model.parameters()))
    assert all(s["exp_avg_sq"].abs().max() > 0 for s in opt.state.values())


def test_ppermute_partial_permutation_and_its_transpose(world):
    """A rank no pair sends to gets zeros (rank 3, and rank 3's x gets a
    zero gradient); the gradient takes the inverse permutation; a tuple
    keeps its dtypes; an axis of size 1 is the identity, no hop."""
    got = world[2]["transport"]
    ones = np.ones((2, 3), np.float32)
    np.testing.assert_array_equal(got["y"], [3 * ones, ones, 2 * ones,
                                             0 * ones])
    w = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    # rank r sent to d = perm[r]; its gradient is d's weight, (d + 1) w
    np.testing.assert_array_equal(got["grad"], [2 * w, 3 * w, 1 * w,
                                                0 * w])
    assert got["calls"] == 2          # the forward hop and its transpose
    dtypes, vals = got["tuple"]
    assert dtypes == ["torch.float32", "torch.bfloat16", "torch.bool"]
    src = [(r - 1) % 4 for r in range(4)]
    np.testing.assert_array_equal(vals[0][:, 0], [s + 0.5 for s in src])
    np.testing.assert_array_equal(vals[1][:, 0], [s + 0.25 for s in src])
    np.testing.assert_array_equal(vals[2], np.eye(4)[src])
    assert got["size1_identity"]


@pytest.mark.parametrize("backend,staged", [
    ("gloo", True), ("nccl", False), ("cpu:gloo,cuda:nccl", False),
    ("cpu:gloo,cuda:gloo", True)])
def test_ppermute_stages_cuda_tensors_by_backend(monkeypatch, backend,
                                                 staged):
    """Host staging is chosen from the group's backend alone: a CUDA
    tensor goes through host memory over gloo, directly over NCCL; a CPU
    tensor never stages."""
    from types import SimpleNamespace
    monkeypatch.setattr(port_mesh.dist, "get_backend", lambda g: backend)
    on = lambda kind: SimpleNamespace(device=SimpleNamespace(type=kind))  # noqa: E731
    assert port_mesh._stages_through_host(None, on("cuda")) is staged
    assert port_mesh._stages_through_host(None, on("cpu")) is False


RING_CASES = ["causal", "noncausal", "gqa1", "gqa2", "mask_causal", "mask",
              "bf16", "model_seq", "repeat"]


@pytest.mark.parametrize("name", RING_CASES)
def test_ring_attention_matches_jax(world, name):
    """Output and q/k/v gradients of sum(o^2) against JAX's ring at JAX's
    bars, and against the port's unsharded op (the plain forward where
    mask and causality compose) at 1e-5 (bf16: JAX's ring bars, the pairs
    round on their own); hops: size - 1 forward, size backward."""
    inputs, jax_side, results = world
    case = next(c for c in inputs["ring"] if c[0] == name)
    got, want = results["ring"][name], jax_side["ring"][name]
    out_bar, grad_bar = RING_BARS[case[2]]
    assert np.abs(got["o"] - want[0]).max() < out_bar
    for g, w in zip(got["grads"], want[1:]):
        assert np.abs(g - w).max() < grad_bar
    if case[2] == "float32":
        assert np.abs(got["o"] - got["ref"]).max() < 1e-5
        for g, gl in zip(got["grads"], got["ref_grads"]):
            assert _rel(g, gl) < 1e-5
    else:
        assert np.abs(got["o"] - got["ref"]).max() < out_bar
        for g, gl in zip(got["grads"], got["ref_grads"]):
            assert np.abs(g - gl).max() < grad_bar
    size = RING_MESHES[case[1]][0][-1]
    assert got["hops"] == ((size - 1, 2 * size - 1) if size > 1 else (0, 0))


def test_pipeline_split_matches_jax_and_round_trips():
    """The port's split of a flax tree equals JAX's leaf by leaf, and
    merge inverts it exactly."""
    cfg = dict(PIPE, depth=4)
    jmodel, jparams, params = _flax(cfg, 4)
    model = CosineSimCausalTransformer(**cfg, device="meta")
    for n_stages in (4, 2, 1):
        stacked, aux = split_pipeline_params(model, params, n_stages)
        want = jax_split_pipeline(jmodel, jparams, n_stages)
        flat = jax.tree_util.tree_flatten_with_path
        got_leaves = flat(jax.tree.map(np.asarray, (stacked, aux)))[0]
        want_leaves = flat(jax.tree.map(np.asarray, want))[0]
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (_, a), (_, b) in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(a, b)
        back = merge_pipeline_params(model, stacked, aux)["params"]
        for (pa, a), (pb, b) in zip(
                flat(jax.tree.map(np.asarray, back))[0],
                flat(params)[0]):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="split into 3"):
        split_pipeline_params(model, params, 3)
    with pytest.raises(ValueError, match="pre-norm"):
        split_pipeline_params(CosineSimCausalTransformer(
            **dict(cfg, pre_norm=False), device="meta"), params, 2)


PIPE_CASES = ["4x2", "4x2_remat", "2x4_data2", "1x2_data4", "fused"]


@pytest.mark.parametrize("name", PIPE_CASES)
def test_pipeline_matches_plain_and_jax(world, name):
    """Loss and every gradient of the pipeline (each stage's layers and
    the summed replicated parameters, gathered) against the plain model
    and JAX's pipeline at 5e-6; each rank's stage holds exactly its slice
    of the weights."""
    _, jax_side, results = world
    got = results["pipeline"][name]
    want_loss, want_grads = jax_side["pipeline"][name]
    assert abs(got["loss"] - got["loss_plain"]) < PIPE_BAR
    assert got["grad_err"] < PIPE_BAR
    assert got["weights_err"] == 0.0
    assert abs(got["loss"] - want_loss) < PIPE_BAR
    if want_grads is not None:
        diffs = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                             got["grads"], want_grads["params"])
        assert max(jax.tree.leaves(diffs)) < PIPE_BAR, diffs


def test_parallel_exports_cover_jax():
    """The port's parallel/ exports every name of JAX's."""
    import flash_cosine_sim_attention_tpu.parallel as jax_parallel
    import flash_cosine_sim_attention_tpu_torch.parallel as port_parallel
    assert not set(jax_parallel.__all__) - set(port_parallel.__all__)
