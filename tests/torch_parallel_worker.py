"""The rank body of tests/test_torch_parallel.py.

Each rank of a gloo world of 4 CPU processes runs every case once, on a
(2, 2) and a (1, 4) (data, model) mesh, on ("seq",) and (model, seq)
meshes for ring attention and on (pipe,) and (data, pipe) meshes for the
pipeline, from the numpy inputs the test wrote; rank 0 writes the results
as numpy.  Imports no JAX: the test process computes the JAX side.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from flash_cosine_sim_attention_tpu_torch import (
    flash_cosine_sim_attention,
    l2norm_tensors,
)
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    fuse_qkv_params,
    init_decode_state,
    init_paged_decode_state,
    params_from_flax,
    params_to_flax,
    prefill,
    quantize_params,
)
from flash_cosine_sim_attention_tpu_torch.models.decoding import decode_step
from flash_cosine_sim_attention_tpu_torch.ops.fwd_kernel import (
    flash_attention_forward_plain,
)
from flash_cosine_sim_attention_tpu_torch.parallel import (
    MODEL_AXIS,
    cache_shardings,
    head_sharded_decode_attention,
    head_sharded_flash_attention,
    local_shard,
    make_mesh,
    make_pipeline_mesh,
    make_pipeline_train_step,
    make_sharded_train_step,
    param_shardings,
    ppermute,
    ring_flash_cosine_sim_attention,
    shard_cache,
    shard_opt_state,
    shard_params,
    shard_pipeline_params,
    sharding,
    split_pipeline_params,
    unshard_opt_state,
    unshard_params,
    unshard_pipeline_params,
)
from flash_cosine_sim_attention_tpu_torch.quant import (
    append,
    init_cache,
    quantized_decode_attention,
)
from flash_cosine_sim_attention_tpu_torch.serving import InferenceEngine


def _max_over_ranks(x: float) -> float:
    t = torch.tensor(float(x), dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.item()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def attention(inp, meshes):
    out = {}
    for name, mesh_name, (q, k, v, *mask) in inp["attention"]:
        mesh = meshes[mesh_name]
        q, k, v = (_t(a).requires_grad_() for a in (q, k, v))
        kw = dict(mask=_t(mask[0])) if mask else dict(causal=True)
        o = head_sharded_flash_attention(q, k, v, mesh, **kw)
        o_local = flash_cosine_sim_attention(q, k, v, **kw)
        res = dict(o=o.detach().numpy(), o_local=o_local.detach().numpy())
        if name == "4d":
            res["grads"] = [g.numpy() for g in torch.autograd.grad(
                o.square().sum(), (q, k, v))]
            res["grads_local"] = [g.numpy() for g in torch.autograd.grad(
                o_local.square().sum(), (q, k, v))]
        out[name] = res
    return out


def decode(inp, meshes):
    q, k, v, cap = inp["decode"]
    q, k, v = _t(q), _t(k), _t(v)
    b, h, n, d = k.shape
    cache = append(init_cache(b, h, cap, d, "cpu"), l2norm_tensors(k), v)
    out = {"o_local": quantized_decode_attention(q, cache).numpy()}
    for name in ("2x2", "1x4"):
        mesh = meshes[name]
        out[name] = head_sharded_decode_attention(
            q, shard_cache(cache, mesh), mesh).numpy()
    try:
        cache_shardings(meshes["1x4"], kv_heads=2)
        out["misaligned"] = None
    except ValueError as e:
        out["misaligned"] = str(e)
    out["mqa"] = [str(p) for p in cache_shardings(meshes["1x4"], 1).k8]
    return out


def _model(cfg, params):
    model = CosineSimCausalTransformer(**cfg, device="cpu")
    params_from_flax(params, model)
    return model


def rules(inp, meshes):
    cfg, params = inp["rules"]
    mesh = meshes["1x4"]
    out = {"plain": {n: [str(p) for p in s] for n, s in
                     param_shardings(_model(cfg, params), mesh).items()}}
    quant = quantize_params(_model(cfg, params))
    out["quant"] = {n: [str(p) for p in s] for n, s in
                    param_shardings(quant, mesh).items()}
    # a fused to_qkv is split piece by piece: each rank holds its own
    # heads of q, k and v
    worst = 0.0
    for kvh in (4, 1):
        for quantized in (False, True):
            model = CosineSimCausalTransformer(**dict(cfg, kv_heads=kvh),
                                               device="cpu")
            if quantized:
                quantize_params(model)
            a = model.attn[0]
            key = "weight_q" if quantized else "weight"
            axis = 1 if quantized else 0
            parts = [getattr(m, key).clone() for m in (a.to_q, a.to_k, a.to_v)]
            shard_params(fuse_qkv_params(model), mesh)
            spec = sharding(mesh, *[MODEL_AXIS if i == axis else None
                                    for i in range(2)])
            want = torch.cat(
                [local_shard(parts[0], mesh, spec)]
                + [local_shard(p, mesh, spec) if kvh % 4 == 0 else p
                   for p in parts[1:]], dim=axis)
            got = getattr(a.to_qkv, key)
            worst = max(worst, (got.float() - want.float()).abs().max().item()
                        if got.shape == want.shape else float("inf"))
    out["fused_split_err"] = _max_over_ranks(worst)
    return out


def train(inp, meshes):
    out = {}
    for name, mesh_name, cfg, params, x in inp["train"]:
        mesh = meshes[mesh_name]
        x = _t(x)
        ref = _model(cfg, params)
        loss0 = ref(x, return_loss=True)
        loss0.backward()
        model = shard_params(_model(cfg, params), mesh)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        specs = param_shardings(model, mesh)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss = make_sharded_train_step(model, opt, mesh)(x)
        grads0 = dict(ref.named_parameters())
        err, moved = 0.0, 0.0
        for n, p in model.named_parameters():
            g0 = local_shard(grads0[n].grad, mesh, specs[n])
            err = max(err, ((p.grad - g0).abs().max()
                            / g0.abs().max().clamp_min(1e-30)).item())
            moved = max(moved, (p.detach() - before[n]).abs().max().item())
        kv = model.attn[0]
        out[name] = dict(loss=loss.item(), loss_local=loss0.item(),
                         grad_err=_max_over_ranks(err),
                         moved=_max_over_ranks(moved),
                         local_heads=(kv.heads, kv.kv_heads, kv.kv_replicated))
    out["opt_state"] = opt_state_round_trip(inp, meshes["2x2"])
    return out


def opt_state_round_trip(inp, mesh):
    """An Adam state of a single-device step laid onto the mesh and
    gathered back: slices, step counts and the round trip exact."""
    _, _, cfg, params, x = inp["train"][0]
    model = fuse_qkv_params(_model(cfg, params))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(_t(x), return_loss=True).backward()
    opt.step()
    full = {n: {k: v.clone() for k, v in opt.state[p].items()}
            for n, p in model.named_parameters()}
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    shard_params(model, mesh)
    shard_opt_state(opt, model, mesh)
    shapes_ok = all(opt.state[p]["exp_avg"].shape == p.shape
                    and torch.equal(opt.state[p]["step"], full[n]["step"])
                    for n, p in model.named_parameters())
    specs = param_shardings(model, mesh)
    p = model.ff[0].proj_in.weight
    slice_ok = torch.equal(opt.state[p]["exp_avg_sq"], local_shard(
        full["ff.0.proj_in.weight"]["exp_avg_sq"], mesh,
        specs["ff.0.proj_in.weight"]))
    unshard_opt_state(opt, model)
    unshard_params(model)
    exact = all(torch.equal(p, weights[n]) and all(
        torch.equal(opt.state[p][k], v) for k, v in full[n].items())
        for n, p in model.named_parameters())
    return dict(shapes_ok=shapes_ok, slice_ok=slice_ok, exact=exact)


def _stream(engine, prompt, steps, chunk=None):
    slot = engine.add_request(prompt, chunk_tokens=chunk)
    toks = [] if chunk else [int(engine.last_token[slot])]
    while len(toks) < steps:
        got = engine.step()
        if slot in got:
            toks.append(got[slot])
    engine.finish(slot)
    return toks


def serving(inp, meshes):
    out = {}
    mesh = meshes["1x4"]
    prompt = np.arange(11) % 64
    kw = dict(num_slots=2, capacity=256, prompt_buckets=(16, 32),
              temperature=1e-4, seed=3, device="cpu")
    for name, cfg, params, quantized in inp["serving"]:
        def build():
            model = _model(cfg, params)
            return fuse_qkv_params(quantize_params(model)) if quantized \
                else model
        local = InferenceEngine(build(), **kw)
        tp = InferenceEngine(build(), mesh=mesh, **kw)
        res = dict(local=_stream(local, prompt, 5), tp=_stream(tp, prompt, 5),
                   local_kv_heads=tp.state.caches[0].k8.shape[1])
        try:
            init_paged_decode_state(tp.model, 2, 4, 128, 2, device="cpu")
            res["paged_refused"] = False
        except ValueError:
            res["paged_refused"] = True
        if name == "dense":
            res["chunked_local"] = _stream(local, prompt, 5, chunk=4)
            res["chunked_tp"] = _stream(tp, prompt, 5, chunk=4)
            # the same prefill and one decode step, TP vs one device
            toks = _t(np.arange(20)[None] % 64)
            logits = []
            for engine, m in ((local, None), (tp, mesh)):
                state = init_decode_state(engine.model, 1, 64, device="cpu")
                a, state = prefill(engine.model, state, toks, mesh=m)
                b, _ = decode_step(engine.model, state, a.argmax(-1), mesh=m)
                logits.append(torch.stack([a, b]))
            res["logit_err"] = _max_over_ranks(
                (logits[0] - logits[1]).abs().max().item())
        out[name] = res
    return out


def _all_ranks(x: torch.Tensor) -> np.ndarray:
    """(world, *x.shape): every rank's ``x``, on every rank."""
    buf = torch.zeros(dist.get_world_size(), *x.shape, dtype=torch.float32)
    buf[dist.get_rank()] = x.detach().float()
    dist.all_reduce(buf)
    return buf.numpy()


def transport(inp, meshes):
    """ppermute: a partial permutation (rank 3 sends and receives
    nothing), its backward, a tuple of dtypes around the ring, and an
    axis of size 1."""
    mesh, r = meshes["seq4"], dist.get_rank()
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    calls = ppermute.calls
    y = ppermute(x, mesh, "seq", [(0, 1), (1, 2), (2, 0)])
    (y * torch.arange(6.0).reshape(2, 3) * (r + 1)).sum().backward()
    out = dict(y=_all_ranks(y), grad=_all_ranks(x.grad),
               calls=ppermute.calls - calls)
    ring = [(i, (i + 1) % 4) for i in range(4)]
    sent = (torch.full((3,), r + 0.5), torch.full((2,), r + 0.25,
                                                  dtype=torch.bfloat16),
            torch.arange(4) == r)
    got = ppermute(sent, mesh, "seq", ring)
    out["tuple"] = ([str(t.dtype) for t in got],
                    [_all_ranks(t) for t in got])
    one = meshes["model4_seq1"]
    calls = ppermute.calls
    out["size1_identity"] = ppermute(x, one, "seq", [(0, 0)]) is x \
        and ppermute.calls == calls
    return out


def _ring_reference(q, k, v, mask, causal, kw):
    """The unsharded op, or with a mask and causality together (which the
    op refuses) the plain forward on l2-normalized inputs."""
    if mask is not None and causal:
        qn, kn = l2norm_tensors(q, k, groups=kw.get("groups", 1))
        return flash_attention_forward_plain(
            qn, kn, v, mask, None, bias_batch_dim=False,
            scale=kw.get("scale", 8.0), causal=True)[0]
    return flash_cosine_sim_attention(q, k, v, mask=mask, causal=causal,
                                      **kw)


def ring(inp, meshes):
    out = {}
    for name, mesh_name, dtype, kw, (q, k, v, *mask) in inp["ring"]:
        kw = dict(kw)
        causal, model_axis = kw.pop("causal"), kw.pop("model_axis", None)
        mask = _t(mask[0]) if mask else None
        q, k, v = (_t(a).to(getattr(torch, dtype)).requires_grad_()
                   for a in (q, k, v))
        calls = ppermute.calls
        o = ring_flash_cosine_sim_attention(
            q, k, v, meshes[mesh_name], mask=mask, causal=causal,
            model_axis=model_axis, **kw)
        hops_fwd = ppermute.calls - calls
        grads = torch.autograd.grad(o.float().square().sum(), (q, k, v))
        ref = _ring_reference(q, k, v, mask, causal, kw)
        ref_grads = torch.autograd.grad(ref.float().square().sum(),
                                        (q, k, v))
        out[name] = dict(
            o=o.detach().float().numpy(), ref=ref.detach().float().numpy(),
            grads=[g.float().numpy() for g in grads],
            ref_grads=[g.float().numpy() for g in ref_grads],
            hops=(hops_fwd, ppermute.calls - calls))
    return out


def pipeline(inp, meshes):
    out = {}
    for name, mesh_name, cfg, params, x, n_stages, n_micro, remat in \
            inp["pipeline"]:
        mesh, x = meshes[mesh_name], _t(x)
        model = _model(cfg, params)
        loss0 = model(x, return_loss=True)
        loss0.backward()
        stage = shard_pipeline_params(
            model, *split_pipeline_params(model, params, n_stages), mesh)
        step = make_pipeline_train_step(
            stage, torch.optim.SGD(stage.parameters(), lr=0.0), mesh,
            n_micro, remat=remat)
        loss = step(x)
        full = dict(model.named_parameters())
        weights = unshard_pipeline_params(stage, mesh)
        grads = unshard_pipeline_params(stage, mesh, lambda p: p.grad)
        res = dict(loss=loss.item(), loss_plain=loss0.item(),
                   weights_err=max((weights[n] - p).abs().max().item()
                                   for n, p in full.items()),
                   grad_err=max((grads[n] - p.grad).abs().max().item()
                                for n, p in full.items()))
        for n, p in full.items():
            p.grad = grads[n]
        res["grads"] = params_to_flax(model, grads=True)
        out[name] = res
    return out


def run(rank: int, world: int, workdir: str) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        with open(f"{workdir}/inputs.pkl", "rb") as f:
            inp = pickle.load(f)
        meshes = {"2x2": make_mesh(model_parallel=2, device_type="cpu"),
                  "1x4": make_mesh(model_parallel=4, device_type="cpu")}
        for name, shape, dims in (
                ("seq4", (4,), ("seq",)),
                ("model2_seq2", (2, 2), ("model", "seq")),
                ("model4_seq1", (4, 1), ("model", "seq"))):
            meshes[name] = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                                      mesh_dim_names=dims)
        for name, pp in (("pipe4", None), ("data2_pipe2", 2),
                         ("data4_pipe1", 1)):
            meshes[name] = make_pipeline_mesh(pipeline_parallel=pp,
                                              device_type="cpu")
        res = {}
        for case in (attention, decode, rules, train, serving, transport,
                     ring, pipeline):
            res[case.__name__] = case(inp, meshes)
        if rank == 0:
            with open(f"{workdir}/results.tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(f"{workdir}/results.tmp", f"{workdir}/results.pkl")
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        with open(f"{workdir}/error-{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise
