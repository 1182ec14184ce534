"""The port's multi-host path (``parallel/distributed.py`` and the trainer's
``--num-processes`` / ``--process-id`` / ``--coordinator``) on the CPU.

A JAX process maps to a node of L ranks here.  JAX's own checks
(tests/test_distributed.py: a two-process dry run and the trainer on two
processes) run as 2 nodes of 2 gloo ranks, every world at a free
localhost port.  The parity world (``tests/torch_distributed_worker.py``)
trains against JAX's ``make_sharded_train_step`` on a (2, 2) mesh of
``tests/conftest.py``'s virtual devices over the node-major concatenation
of the nodes' rows, at the bars of tests/test_torch_parallel.py's
``test_sharded_train_step_matches_jax`` (loss 1e-4, gradients 1e-5
relative to max|g|) and, for the weights after an Adam step,
tests/test_torch_training.py's.
"""

import multiprocessing
import os
import pickle
import socket
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

from flash_cosine_sim_attention_tpu.models import (
    CosineSimCausalTransformer as JaxModel,
)
from flash_cosine_sim_attention_tpu.parallel import (
    make_mesh as jax_mesh,
    make_sharded_train_step as jax_train_step,
    shard_params as jax_shard_params,
)
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    params_from_flax,
    params_to_flax,
)
from flash_cosine_sim_attention_tpu_torch.parallel import (
    initialize_distributed,
    make_multihost_mesh,
    process_local_rows,
    run_multiprocess_cpu_dryrun,
)
from flash_cosine_sim_attention_tpu_torch.parallel import distributed
from flash_cosine_sim_attention_tpu_torch.parallel.distributed import (
    free_port,
)
from flash_cosine_sim_attention_tpu_torch.train import (
    MAX_GRAD_NORM,
    clip_by_global_norm_,
)
from flash_cosine_sim_attention_tpu_torch.utils import restore_checkpoint
from test_torch_parallel import _flax

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(num_tokens=64, dim=64, depth=2, max_seq_len=32, heads=8,
           dim_head=16, pre_norm=True, attn_scale=1.0)
NODE_ROWS = 2          # rows a node feeds a step: a global batch of 4
STEPS = 2


def test_two_node_dryrun():
    """JAX's test_two_process_dryrun: 2 nodes of 2 ranks, model axis 2."""
    res = run_multiprocess_cpu_dryrun(
        num_processes=2, devices_per_process=2, model_parallel=2,
        steps=2, dim=64, depth=1, seq_len=64)
    assert set(res) == {0, 1}
    assert abs(res[0] - res[1]) < 1e-6


def test_train_cli_two_nodes(tmp_path):
    """JAX's test_train_cli_two_process: one torchrun of 2 ranks a node;
    node 0 prints the mesh and the loss, node 1 no step line.  101 steps
    reach step 100's validation (each node's rows, averaged over data) and
    a checkpoint of the full weights, which restores into a single-device
    model."""
    ck = tmp_path / "ck"
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for pid in range(2):
        log = open(tmp_path / f"node{pid}.log", "w+")
        procs.append((log, subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m",
             "flash_cosine_sim_attention_tpu_torch.train", "--device", "cpu",
             "--num-processes", "2", "--process-id", str(pid),
             "--coordinator", f"localhost:{port}", "--model-parallel", "2",
             "--steps", "101", "--dim", "64", "--depth", "1",
             "--seq-len", "64", "--batch-size", "4", "--checkpoint-dir",
             str(ck), "--checkpoint-every", "100"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    outs = []
    try:
        for log, p in procs:
            p.wait(timeout=300)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
            log.seek(0)
            outs.append(log.read())
            log.close()
    for pid, (_, p) in enumerate(procs):
        assert p.returncode == 0, f"node {pid}:\n{outs[pid][-3000:]}"
    assert "processes: 2  mesh: data=2 model=2" in outs[0]
    assert "step 0" in outs[0] and "loss" in outs[0]
    assert "step 0" not in outs[1]
    assert "valid loss" in outs[0] and "valid loss" not in outs[1]
    model = CosineSimCausalTransformer(
        num_tokens=256, dim=64, depth=1, max_seq_len=64, attn_scale=1.0,
        attn_l2norm_groups=8, pre_norm=True, device="cpu")
    assert restore_checkpoint(str(ck), model,
                              torch.optim.Adam(model.parameters())) == 100


def _step0_loss(out: str) -> float:
    line = next(x for x in out.splitlines() if x.startswith("step 0  loss"))
    return float(line.split()[3])


@pytest.mark.parametrize("flag", ["--model-parallel", "--pipeline-parallel"])
def test_trainer_across_torchrun_nodes_without_multihost(tmp_path, flag):
    """Without the multi-host flags a world that spans torchrun nodes
    (2 nodes of 1 rank, LOCAL_WORLD_SIZE 1 < the world's 2) trains on the
    global batch every rank draws, as one node does: a float32 step's
    loss is the single-device trainer's (printed to 4 decimals)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    common = ["-m", "flash_cosine_sim_attention_tpu_torch.train", "--device",
              "cpu", "--use-float32", "--steps", "1", "--dim", "32",
              "--depth", "2", "--seq-len", "32", "--batch-size", "2"]
    cmds = [[sys.executable, *common]] + [
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
         "--node-rank", str(node), "--nproc-per-node", "1", "--master-addr",
         "localhost", "--master-port", str(port), *common, flag, "2"]
        for node in range(2)]
    procs = []
    for i, cmd in enumerate(cmds):
        log = open(tmp_path / f"run{i}.log", "w+")
        procs.append((log, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    outs = []
    try:
        for log, p in procs:
            p.wait(timeout=240)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
            log.seek(0)
            outs.append(log.read())
            log.close()
    for i, (_, p) in enumerate(procs):
        assert p.returncode == 0, f"run {i}:\n{outs[i][-3000:]}"
    assert "step 0" not in outs[2]
    assert abs(_step0_loss(outs[1]) - _step0_loss(outs[0])) <= 1e-4


def _jax_side(params, rows):
    """JAX's sharded step on a (2, 2) mesh over the node-major
    concatenation of each step's rows: the losses, and the first step's
    clipped gradients and the weights after it."""
    mesh = jax_mesh(4, model_parallel=2)
    jm = JaxModel(**CFG, dtype=jnp.float32, mesh=mesh)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(2e-4))
    p = jax_shard_params({"params": jax.tree.map(jnp.asarray, params)}, mesh)
    batches = [jnp.asarray(np.concatenate(r)) for r in rows]
    grads = jax.jit(jax.grad(lambda q: jm.apply(q, batches[0],
                                                return_loss=True)))(p)
    clip = optax.clip_by_global_norm(0.5)
    grads, _ = clip.update(grads, clip.init(p))
    as_np = lambda t: jax.tree.map(np.array, t)["params"]  # noqa: E731
    opt_state, step, losses = tx.init(p), jax_train_step(jm, tx, mesh), []
    for batch in batches:
        p, opt_state, loss = step(p, opt_state, batch)
        losses.append(float(loss))
        after = after if len(losses) > 1 else as_np(p)
    return losses, as_np(grads), after


def _port_grads(params, rows):
    """The port's single-process clipped gradients over the same
    concatenation (the trainer's train_step's first half), on one thread
    as each rank runs: MKL's threads follow the machine's load, and with
    them its sums' order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = params_from_flax(params, CosineSimCausalTransformer(
            **CFG, device="cpu"))
        model(torch.from_numpy(np.concatenate(rows[0])),
              return_loss=True).backward()
        clip_by_global_norm_(model.parameters(), MAX_GRAD_NORM)
        return params_to_flax(model, grads=True)
    finally:
        torch.set_num_threads(threads)


def _leaves(tree):
    return [(jax.tree_util.keystr(k), v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_multihost_step_matches_jax(tmp_path):
    """2 nodes x 2 ranks (initialize_distributed, make_multihost_mesh(2)):
    2 float32 steps (clip 0.5, Adam 2e-4, the trainer's), each node
    feeding its own rows, against JAX's sharded step over the
    concatenation: losses at 1e-4; the first step's clipped gradients at
    1e-5 of the gradients' max|g| (and of each leaf's own against the
    port's single-process step, the sharded sums being the only
    difference); the weights after it at 1e-6, by test_torch_training's
    rule for an Adam step: an entry whose gradient is under 1e-4 of the
    largest has no defined Adam direction (lr g / (|g| + eps) turns on
    g's last digits) and is held to 2 lr, at most 5 % of the entries; an
    entry with no gradient stays put.  Each rank's share is its node's
    rows; as one node of 4 ranks at mp 2, the node's rows split over its
    two data ranks in order."""
    import torch_distributed_worker

    _, _, params = _flax(dict(CFG), 5)
    rngs = [np.random.default_rng(100 + node) for node in range(2)]
    rows = [[r.integers(0, CFG["num_tokens"], (NODE_ROWS, 33))
             for r in rngs] for _ in range(STEPS)]
    rows4 = np.random.default_rng(7).integers(0, 64, (4, 33))
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(cfg=CFG, params=params, rows=rows, rows4=rows4,
                         global_rows=2 * NODE_ROWS), f)
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_distributed_worker.run,
                         args=(node, local, port, str(tmp_path)))
             for node in range(2) for local in range(2)]
    for p in procs:
        p.start()
    try:
        want_losses, want_grads, want_params = _jax_side(params, rows)
        local_grads = dict(_leaves(_port_grads(params, rows)))
    finally:
        deadline = time.monotonic() + 240
        while (any(p.is_alive() for p in procs)
               and time.monotonic() < deadline
               and not any(p.exitcode not in (None, 0) for p in procs)):
            time.sleep(0.2)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
    errors = [f.read_text() for f in sorted(tmp_path.glob("error-*.txt"))]
    assert not errors, errors[0]
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = []
    for r in range(4):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    for r, got in enumerate(ranks):
        assert got["local_rows"] == NODE_ROWS
        assert got["global_shape"] == (2 * NODE_ROWS, 33)
        node = r // 2
        assert got["data_rank"] == node
        for s in range(STEPS):
            np.testing.assert_array_equal(got["shares"][s], rows[s][node])
        np.testing.assert_array_equal(
            got["share4"], rows4[2 * got["data_rank4"]:][:2])
        for a, b in zip(got["losses"], want_losses):
            assert abs(a - b) < 1e-4

        grads = dict(_leaves(got["grads"]))
        want = dict(_leaves(want_grads))
        assert grads.keys() == want.keys()
        g_max = max(np.abs(g).max() for g in want.values())
        for k, g in grads.items():
            assert np.abs(g - want[k]).max() < 1e-5 * g_max, k
            assert (np.abs(g - local_grads[k]).max()
                    < 1e-5 * np.abs(local_grads[k]).max()), k
        before, after = dict(_leaves(params)), dict(_leaves(want_params))
        floors = 0
        for k, w in _leaves(got["params"]):
            err, g = np.abs(w - after[k]), np.abs(want[k])
            floor = (g > 0) & (g < 1e-4 * g_max)
            floors += floor.sum()
            assert err[~floor].max(initial=0) <= 1e-6, (k, err.max())
            assert err[floor].max(initial=0) <= 2 * 2e-4, k
            assert np.array_equal(w[g == 0], before[k][g == 0]), k
        assert floors <= 0.05 * sum(g.size for g in want.values())
    assert [x["data_rank4"] for x in ranks] == [0, 0, 1, 1]


def test_multihost_errors(monkeypatch):
    """Where JAX asserts the port raises: a batch that does not split over
    the nodes, a model axis wider than a node or not dividing it, and a
    coordinator whose port is taken (named in the error); with more than
    one node a missing coordinator, node count or node rank raises, naming
    the trainer's flag.  One node is a no-op, as in JAX."""
    initialize_distributed(num_processes=1)
    # each value is required: torchrun's environment is never read
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("GROUP_RANK", "0")
    for args, flag in (((None, 2, 0), "--coordinator"),
                       (("localhost:1", 2, None), "--process-id"),
                       (("localhost:1", None, 0), "--num-processes")):
        with pytest.raises(ValueError, match=flag):
            initialize_distributed(*args, device="cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: 4)
    assert process_local_rows(4) == 2
    with pytest.raises(ValueError, match="not divisible by 2"):
        process_local_rows(3)
    with pytest.raises(ValueError, match="cross process boundaries"):
        make_multihost_mesh(4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="does not divide"):
        make_multihost_mesh(3)
    monkeypatch.undo()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with socket.socket() as taken:
        taken.bind(("localhost", 0))
        taken.listen()
        port = taken.getsockname()[1]
        with pytest.raises(RuntimeError, match=f"localhost:{port} failed"):
            initialize_distributed(f"localhost:{port}", 2, 0, device="cpu")
    assert not dist.is_initialized()
