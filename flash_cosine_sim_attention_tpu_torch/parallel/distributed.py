"""Multi-host (multi-node) runtime: data parallelism across nodes, tensor
parallelism inside each node.

Counterpart of ``flash_cosine_sim_attention_tpu/parallel/distributed.py``.
A JAX process owns every device of its host; a rank here owns one device.
So a JAX process maps to a node of L ranks (torchrun's
``LOCAL_WORLD_SIZE``, 1 without torchrun), and JAX's process count and
process id become the node count N and the node rank p:

  * ``initialize_distributed``: one call per rank joins a world of N * L
    ranks over a TCP store at the coordinator, global rank p * L +
    ``LOCAL_RANK``.  Node-major ranks are JAX's process-major device
    order.
  * ``make_multihost_mesh``: a (data, model) mesh over the global ranks
    whose model axis never leaves a node (``make_mesh`` puts rank r at
    (r // mp, r % mp), so mp dividing L keeps each model group inside one
    node); only the data-axis gradient sum crosses nodes.
  * ``local_batch_to_global``: per-node feeding.  Every node builds only
    its own rows of the global batch (the node-major concatenation of the
    nodes' rows); each rank takes its share of them and no collective
    runs, as ``jax.make_array_from_process_local_data`` copies nothing
    across hosts.
  * ``run_multiprocess_cpu_dryrun``: N * L fresh interpreters on the CPU
    over gloo, sharded training steps with per-node feeding: the
    multi-host code path (rank order, feeding, cross-node collectives)
    without a cluster.

Launch, one command a node (host:port is node 0's address and a free port):

  torchrun --standalone --nproc-per-node L -m \\
      flash_cosine_sim_attention_tpu_torch.train --num-processes N \\
      --process-id p --coordinator host:port [--model-parallel mp]
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .._build import resolve_device
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_rank,
    axis_size,
    make_mesh,
    sharding,
)

# how long a rank waits for the whole world at the coordinator (JAX's
# jax.distributed.initialize waits 300 s too)
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)
# ports tests/test_distributed.py (the JAX package's) binds; its tests can
# run at the same moment as the port's
_JAX_TEST_PORTS = (12687, 12711, 12713)


def _local_world() -> int:
    """L: ranks a node (torchrun's LOCAL_WORLD_SIZE; 1 without torchrun)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def process_count() -> int:
    """N, the node count (``jax.process_count``): 1 without a process
    group."""
    if not dist.is_initialized():
        return 1
    world, local = dist.get_world_size(), _local_world()
    if world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE {local} does not divide the "
                         f"world size {world}")
    return world // local


def process_index() -> int:
    """p, this rank's node (``jax.process_index``): 0 without a process
    group."""
    return dist.get_rank() // _local_world() if dist.is_initialized() else 0


def _required(value, flag: str):
    if value is None:
        raise ValueError(f"{flag} is required with more than one node")
    return value


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Join the world of ``num_processes`` nodes of L ranks each as global
    rank ``process_id * L + LOCAL_RANK``.  Call once per rank, before any
    collective.  With ``num_processes == 1`` it does nothing, as in JAX;
    otherwise each of the three is required and a missing one raises,
    naming the trainer's flag (JAX's cluster auto-detection has no
    counterpart: under ``torchrun --standalone`` torchrun's environment
    describes one node, and under a multi-node torchrun its
    ``MASTER_PORT`` is held by torchrun's own store).  ``device`` is the
    device the rank computes on (default ``cuda``; raises without a
    card); ``backend`` defaults to NCCL on the card, which takes one card
    a rank (this rank's is ``LOCAL_RANK``), and gloo on the CPU.  With
    ``backend="gloo"`` on the card the ranks stay on the current device:
    several ranks can share one card.

    The world is built on a TCP store of its own at the coordinator (node
    0's rank 0 holds it), never on torchrun's.  A failed rendezvous
    raises; nothing falls back to a smaller world."""
    if num_processes == 1:
        return
    nodes = _required(num_processes,
                      "num_processes (the trainer's --num-processes)")
    coordinator = _required(coordinator_address,
                            "coordinator_address (the trainer's "
                            "--coordinator)")
    node = _required(process_id, "process_id (the trainer's --process-id)")
    local, local_rank = _local_world(), int(os.environ.get("LOCAL_RANK", "0"))
    if not (0 <= node < nodes and 0 <= local_rank < local):
        raise ValueError(f"node {node} of {nodes}, local rank {local_rank} "
                         f"of {local}: out of range")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(local_rank)
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    rank, world = node * local + local_rank, nodes * local
    try:
        store = dist.TCPStore(host.strip("[]"), int(port), world,
                              is_master=rank == 0,
                              timeout=RENDEZVOUS_TIMEOUT)
    except RuntimeError as e:
        raise RuntimeError(
            f"rank {rank} of {world}: the rendezvous at {coordinator} "
            f"failed: {e}") from e
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)


def make_multihost_mesh(model_parallel: Optional[int] = None,
                        devices: Optional[int] = None,
                        device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model) mesh over the first ``devices`` global ranks (default:
    the whole world; JAX's ``devices`` is a device list, here a rank
    count), the model axis inside a node.

    ``model_parallel`` defaults to min(L, 8), lowered until it divides L,
    as in JAX; it raises ``ValueError`` where JAX asserts: a model axis
    wider than a node ("would cross process boundaries") or not dividing
    L.  ``device_type`` as in ``make_mesh`` (default ``cuda``)."""
    local = _local_world()
    if model_parallel is None:
        model_parallel = min(local, 8)
        while local % model_parallel:
            model_parallel -= 1
    if model_parallel > local:
        raise ValueError(
            f"model_parallel={model_parallel} would cross process boundaries"
            f" (local ranks: {local}); shard the model inside a node")
    if local % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the {local} ranks of a node")
    return make_mesh(devices, model_parallel=model_parallel,
                     device_type=device_type)


def local_batch_to_global(mesh: DeviceMesh, local_batch,
                          batch_axis: int = 0) -> DTensor:
    """This rank's share of the global batch, sharded over ``data``, from
    this node's rows ``local_batch`` (numpy or a tensor): the global batch
    is the node-major concatenation of every node's rows, so a node's L /
    mp data ranks split its rows in order, and the ranks of one model
    group get the same rows.  Makes no collective: the returned DTensor
    (``.to_local()`` is the share, on the mesh's device) is
    ``make_sharded_train_step``'s already-sharded batch."""
    rows = torch.as_tensor(local_batch)
    per_node = axis_size(mesh, DATA_AXIS) // process_count()
    n = rows.shape[batch_axis]
    if n % per_node:
        raise ValueError(f"{n} rows of a node do not split over its "
                         f"{per_node} data ranks")
    size = n // per_node
    share = rows.narrow(batch_axis, axis_rank(mesh, DATA_AXIS) % per_node
                        * size, size)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    spec = [None] * rows.ndim
    spec[batch_axis] = DATA_AXIS
    return DTensor.from_local(share.to(device), mesh, sharding(mesh, *spec),
                              run_check=False)


def process_local_rows(global_rows: int) -> int:
    """Rows this node must feed for a ``global_rows`` global batch."""
    n = process_count()
    if global_rows % n:
        raise ValueError(
            f"global batch {global_rows} not divisible by {n} processes")
    return global_rows // n


# ---------------------------------------------------------------------------
# multi-process CPU dry run (one machine, N nodes of L ranks)
# ---------------------------------------------------------------------------

_WORKER_FLAG = "FCSA_MP_WORKER"


def _worker_main() -> None:
    """A rank's body: JAX's worker's model and optimizer, sharded train
    steps with per-node feeding."""
    cfg = json.loads(os.environ[_WORKER_FLAG])
    torch.set_num_threads(1)
    initialize_distributed(cfg["coordinator"], cfg["num_processes"],
                           cfg["process_id"], device="cpu")
    from ..models import CosineSimCausalTransformer
    from .train import make_sharded_train_step, shard_params

    mesh = make_multihost_mesh(cfg["model_parallel"], device_type="cpu")
    data_par = axis_size(mesh, DATA_AXIS)
    seq = cfg["seq_len"]
    global_batch = max(2, data_par)
    torch.manual_seed(0)     # the same weights on every rank
    model = shard_params(CosineSimCausalTransformer(
        num_tokens=256, dim=cfg["dim"], depth=cfg["depth"],
        max_seq_len=seq, heads=8, dim_head=cfg["dim"] // 8, attn_scale=1.0,
        pre_norm=True, dtype=torch.float32, device="cpu"), mesh)
    optimizer = torch.optim.Adam(model.parameters(), lr=2e-4,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_sharded_train_step(model, optimizer, mesh, max_grad_norm=0.5)

    local_rows = process_local_rows(global_batch)
    np_rng = np.random.default_rng(1000 + cfg["process_id"])
    for _ in range(cfg["steps"]):
        local = np_rng.integers(0, 256, (local_rows, seq + 1))
        loss = step(local_batch_to_global(mesh, local))
    loss = loss.item()
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    print(f"FCSA_MP_RESULT process={cfg['process_id']} rank={dist.get_rank()}"
          f" mesh=(data={data_par},model={axis_size(mesh, MODEL_AXIS)}) "
          f"world={dist.get_world_size()} loss={loss:.6f}", flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    """A localhost port free at the time of the call, never one that the
    JAX package's multi-host tests bind."""
    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port not in _JAX_TEST_PORTS:
            return port


def run_multiprocess_cpu_dryrun(
    num_processes: int = 2,
    devices_per_process: int = 4,
    model_parallel: Optional[int] = None,
    steps: int = 2,
    seq_len: int = 128,
    dim: int = 64,
    depth: int = 2,
    port: Optional[int] = None,
    timeout: float = 300.0,
) -> dict:
    """Spawn ``num_processes`` nodes of ``devices_per_process`` ranks, each
    a fresh interpreter on the CPU (gloo; ``port`` at localhost is the
    coordinator, a free one by default); returns {process_id: loss}.

    Raises on any rank's failure, on a run past ``timeout`` seconds, or
    when the replicated loss differs across ranks by 1e-6 or more."""
    if model_parallel is None:
        model_parallel = devices_per_process
    port = free_port() if port is None else port
    env_base = dict(os.environ, OMP_NUM_THREADS="1",
                    LOCAL_WORLD_SIZE=str(devices_per_process))
    env_base.pop("PYTHONPATH", None)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    with tempfile.TemporaryDirectory(prefix="fcsa_dryrun_") as logs:
        try:
            for pid in range(num_processes):
                for local_rank in range(devices_per_process):
                    env = dict(env_base, LOCAL_RANK=str(local_rank))
                    env[_WORKER_FLAG] = json.dumps({
                        "coordinator": f"localhost:{port}",
                        "num_processes": num_processes, "process_id": pid,
                        "model_parallel": model_parallel, "steps": steps,
                        "seq_len": seq_len, "dim": dim, "depth": depth})
                    log = open(os.path.join(logs, f"{pid}-{local_rank}"), "w+")
                    procs.append((pid, log, subprocess.Popen(
                        [sys.executable, "-c",
                         "import sys; sys.path.insert(0, sys.argv[1]); "
                         "from flash_cosine_sim_attention_tpu_torch.parallel"
                         ".distributed import _worker_main; _worker_main()",
                         repo_root],
                        stdout=log, stderr=subprocess.STDOUT, env=env)))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for _, _, p in procs):
                failed = [p for _, _, p in procs if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outputs = []
        for pid, log, p in procs:
            log.seek(0)
            outputs.append((pid, p.returncode, log.read()))
            log.close()
    results, losses = {}, []
    for pid, rc, out in outputs:
        if rc != 0:
            raise RuntimeError(
                f"multi-process dryrun: a rank of process {pid} failed or "
                f"timed out (rc={rc}):\n{out[-2000:]}")
        for line in out.splitlines():
            if line.startswith("FCSA_MP_RESULT"):
                losses.append(float(line.rsplit("loss=", 1)[1]))
                results.setdefault(pid, losses[-1])
    if len(losses) != num_processes * devices_per_process:
        raise RuntimeError(
            f"multi-process dryrun: expected "
            f"{num_processes * devices_per_process} results, got "
            f"{len(losses)}:\n" + "\n".join(o[-500:] for _, _, o in outputs))
    if max(losses) - min(losses) >= 1e-6:
        raise RuntimeError(
            f"replicated loss diverged across ranks: {losses}")
    return results
