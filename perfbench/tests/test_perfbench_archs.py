"""Model families: the routed build, reference and counts of each
configuration equal those of ``reference/model.py`` and ``roofline.py``
called directly, and a second family written only here runs both kinds
of cell through the unchanged drivers, ``control.py`` and the record
check, found where ``core.ARCHS`` points."""

import gc
import time

import pytest
import torch

import flash_cosine_sim_attention_tpu_torch.models.decoding as decoding
import flash_cosine_sim_attention_tpu_torch.serving.engine as port_engine
from conftest import cut
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer)
from perfbench import control, core, generator, roofline
from perfbench import trace as tracing
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train

CPU = torch.device("cpu")
SEED = 2**31 + 7919
CONFIGS = ("cosine-enwik8-val", "cosine-0.81b-int8w")


def tiny_config(name):
    cfg = core.load_json("configs", name)
    return core.arch(cfg).tiny(cfg)


def same_tensors(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", CONFIGS)
def test_routed_weights_and_logits_are_the_direct_ones(name):
    cfg = tiny_config(name)
    arch, n = core.arch(cfg), cfg["max_seq_len"]
    dtype = getattr(torch, cfg["param_dtype"])
    raw = ref.make_weights(cfg, n, SEED, CPU, dtype)
    model = arch.build(cfg, n, SEED, CPU, serving=False)
    assert same_tensors({k: p.detach() for k, p in model.named_parameters()},
                        raw)
    train_w = arch.reference_weights(cfg, n, SEED, CPU, serving=False)
    assert same_tensors(train_w,
                        ref.make_weights(cfg, n, SEED, CPU, torch.float32))
    served = arch.reference_weights(cfg, n, SEED, CPU, serving=True)
    assert same_tensors(served, ref.served_weights(raw) if cfg.get(
        "int8_weights") else {k: v.float() for k, v in raw.items()})
    tokens = torch.randint(0, cfg["num_tokens"], (1, 40),
                           generator=torch.Generator().manual_seed(3))
    with ref.exact_matmuls():
        for rnd in (ref.identity, ref.fp8):
            assert torch.equal(
                arch.reference_logits(served, cfg, tokens, rnd, prompt_len=24),
                ref.logits(served, cfg, tokens, rnd, prompt_len=24))
            assert torch.equal(arch.reference_loss(train_w, cfg, tokens, rnd),
                               ref.loss(train_w, cfg, tokens, rnd))


@pytest.mark.parametrize("name", CONFIGS)
def test_routed_served_model_is_the_direct_one(name):
    """The served build equals the model made, quantized and fused
    directly through the port's public calls."""
    cfg = tiny_config(name)
    n = cfg["max_seq_len"]
    routed = core.arch(cfg).build(cfg, n, SEED, CPU, serving=True)
    direct = CosineSimCausalTransformer(
        num_tokens=cfg["num_tokens"], dim=cfg["dim"], max_seq_len=n,
        depth=cfg["depth"], heads=cfg["heads"], dim_head=cfg["dim_head"],
        attn_scale=cfg["attn_scale"],
        attn_l2norm_groups=cfg["attn_l2norm_groups"], pre_norm=True,
        use_fused=True, dtype=getattr(torch, cfg["compute_dtype"]),
        param_dtype=getattr(torch, cfg["param_dtype"]), device=CPU)
    raw = ref.make_weights(cfg, n, SEED, CPU,
                           getattr(torch, cfg["param_dtype"]))
    with torch.no_grad():
        for k, p in direct.named_parameters():
            p.copy_(raw[k])
    if cfg.get("int8_weights"):
        decoding.quantize_params(direct)
    if cfg.get("fused_qkv"):
        decoding.fuse_qkv_params(direct)
    assert not routed.training
    assert same_tensors(routed.state_dict(), direct.state_dict())


def test_served_build_frees_the_drawn_leaves_before_quantizing(monkeypatch):
    """The one flat draw of the weights is gone when the program
    quantizes, so the serving cells' memory peak stays the program's."""
    cfg = tiny_config("cosine-0.81b-int8w")
    total = sum(p.numel() for p in core.arch(cfg).build(
        cfg, cfg["max_seq_len"], SEED, CPU, serving=False).parameters())
    alive = []

    def quantize(model, run=decoding.quantize_params):
        gc.collect()
        alive.append(sum(1 for o in gc.get_objects()
                         if torch.is_tensor(o) and o.numel() >= total // 2))
        return run(model)
    monkeypatch.setattr(decoding, "quantize_params", quantize)
    core.arch(cfg).build(cfg, cfg["max_seq_len"], SEED, CPU, serving=True)
    assert alive == [0]


@pytest.mark.parametrize("name", CONFIGS)
def test_routed_counts_are_the_direct_ones(name):
    cfg = tiny_config(name)
    arch = core.arch(cfg)
    lens = [5, 17, 96, 1, 40]
    assert arch.train_step_flops(cfg, 2, 64, 3) == roofline.train_step_flops(
        cfg, 2, 64, 3)
    assert arch.prefill_flops(cfg, 37) == roofline.prefill_flops(cfg, 37)
    assert arch.decode_flops(cfg, lens) == roofline.decode_flops(
        cfg, len(lens), sum(lens))
    assert arch.decode_k4_bound_s(cfg, lens) == roofline.decode_k4_bound_s(
        cfg, sum(lens))
    assert arch.dense_k7_bound_s(cfg, 37) == roofline.dense_k7_bound_s(cfg, 37)
    h, d = cfg["heads"], cfg["dim_head"]
    assert arch.attention_train_bound_s(cfg, 6, 64) == cfg["depth"] * (
        roofline.bound_s(roofline.attention_train_ops(6, h, 64, d),
                         roofline.attention_train_bytes(6, h, h, 64, d)))
    elt = {"bfloat16": 2, "float32": 4}[cfg["compute_dtype"]]
    assert arch.k1_prefill_bound_s(cfg, 37) == cfg["depth"] * roofline.bound_s(
        roofline.attention_fwd_ops(1, h, roofline.causal_pairs(37, 37), d),
        4 * h * 37 * d * elt + 4 * h * 37)


def test_routed_training_reference_is_the_direct_one(bench):
    cell = cut(core.Cell.load(bench, "val-train-s1024"))
    cfg, mix = cell.config, cell.traffic
    drv = core.load_module("drivers", "train")
    routed = drv.reference(cfg, mix, SEED, CPU, steps=2)
    W0 = ref.make_weights(cfg, mix["seq_len"], generator.derive_seed(
        SEED, "weights"), CPU, torch.float32)
    feed = generator.Batches(mix, SEED, cfg["num_tokens"], CPU)
    with ref.exact_matmuls():
        direct = ref_train.steps(ref.loss, cfg, cfg["optimizer"], W0,
                                 [feed.next() for _ in range(2)])
    assert routed == direct


# --- a second family, written only here -------------------------------------

GQA_FAMILY = '''
"""The port's model with fewer KV heads than query heads (query head i
reads KV head i // (heads // kv_heads)), its leaves listed by a
param_spec of its own: a family the harness's tests add."""

import math

import torch
import torch.nn.functional as F

from perfbench import core, roofline
from perfbench.reference import model as ref

_base = core.load_module("archs", "cosine-causal-transformer")
COUNTED = {"K1.gqa": (("ops.fwd_kernel", "flash_attention_forward"),
                      ("fwd_mma_kernel", "fwd_tf32_kernel"))}
attention_train_bound_s = _base.attention_train_bound_s
k1_prefill_bound_s = _base.k1_prefill_bound_s
dense_k7_bound_s = _base.dense_k7_bound_s


def param_spec(cfg, max_seq_len):
    dim, dh = cfg["dim"], cfg["dim_head"]
    h, kvh, hidden = cfg["heads"], cfg["kv_heads"], cfg["dim"] * cfg["ff_mult"]
    norm = [("norm.weight", (dim,), 1.0), ("norm.bias", (dim,), 0.0)]
    spec = [("token_emb.weight", (cfg["num_tokens"], dim), None),
            ("pos_emb.weight", (max_seq_len, dim), None)]
    for l in range(cfg["depth"]):
        spec += [(f"attn.{l}.{k}", s, i) for k, s, i in norm]
        spec += [(f"attn.{l}.to_q.weight", (h * dh, dim), None),
                 (f"attn.{l}.to_k.weight", (kvh * dh, dim), None),
                 (f"attn.{l}.to_v.weight", (kvh * dh, dim), None),
                 (f"attn.{l}.to_out.weight", (dim, h * dh), None)]
        spec += [(f"ff.{l}.{k}", s, i) for k, s, i in norm]
        spec += [(f"ff.{l}.proj_in.weight", (hidden, dim), None),
                 (f"ff.{l}.proj_out.weight", (dim, hidden), None)]
    spec += [(f"final_{k}", s, i) for k, s, i in norm]
    return spec + [("to_logits.weight", (cfg["num_tokens"], dim), None)]


def make_weights(cfg, max_seq_len, seed, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, shape, fill in param_spec(cfg, max_seq_len):
        if fill is not None:
            out[name] = torch.full(shape, fill, device=device, dtype=dtype)
        else:
            std = 0.02 if "emb" in name else math.sqrt(2.0 / sum(shape))
            out[name] = torch.randn(shape, generator=gen, device=device,
                                    dtype=dtype) * std
    return out


def build(cfg, max_seq_len, seed, device, serving):
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.models.decoding import (
        fuse_qkv_params, quantize_params)

    dtype = getattr(torch, cfg["param_dtype"])
    model = CosineSimCausalTransformer(
        num_tokens=cfg["num_tokens"], dim=cfg["dim"], max_seq_len=max_seq_len,
        depth=cfg["depth"], heads=cfg["heads"], kv_heads=cfg["kv_heads"],
        dim_head=cfg["dim_head"], attn_scale=cfg["attn_scale"],
        attn_l2norm_groups=cfg["attn_l2norm_groups"], pre_norm=True,
        dtype=getattr(torch, cfg["compute_dtype"]), param_dtype=dtype,
        device="meta").to_empty(device=device)
    weights = make_weights(cfg, max_seq_len, seed, device, dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights.pop(name))
    assert not weights
    if not serving:
        return model
    if cfg.get("int8_weights"):
        quantize_params(model)
    if cfg.get("fused_qkv"):
        fuse_qkv_params(model)
    return model.eval()


def reference_weights(cfg, max_seq_len, seed, device, serving):
    if not serving:
        return make_weights(cfg, max_seq_len, seed, device, torch.float32)
    raw = make_weights(cfg, max_seq_len, seed, device,
                       getattr(torch, cfg["param_dtype"]))
    return ref.served_weights(raw) if cfg.get("int8_weights") else {
        k: v.float() for k, v in raw.items()}


def reference_logits(W, cfg, tokens, rnd=ref.identity, prompt_len=None):
    b, n = tokens.shape
    dh, group = cfg["dim_head"], cfg["heads"] // cfg["kv_heads"]
    groups, scale = cfg["attn_l2norm_groups"], float(cfg["attn_scale"])

    def dense(x, name):
        return rnd(x) @ rnd(W[name]).t()

    def norm(x, p):
        return F.layer_norm(x, x.shape[-1:], W[p + ".weight"], W[p + ".bias"],
                            ref.LN_EPS)

    def heads(t, repeat=1):
        t = t.reshape(b, n, -1, dh).transpose(1, 2)
        return ref._l2norm(t, groups).repeat_interleave(repeat, dim=1)

    x = W["token_emb.weight"][tokens] + W["pos_emb.weight"][:n][None]
    for l in range(cfg["depth"]):
        a = norm(x, f"attn.{l}.norm")
        q = heads(dense(a, f"attn.{l}.to_q.weight"))
        k = heads(dense(a, f"attn.{l}.to_k.weight"), group)
        v = dense(a, f"attn.{l}.to_v.weight").reshape(b, n, -1, dh)
        v = v.transpose(1, 2).repeat_interleave(group, dim=1)
        o = (ref.attend(q, k, v, scale, rnd) if prompt_len is None else
             ref.attend_served(q, k, v, scale, prompt_len, rnd))
        x = dense(o.transpose(1, 2).reshape(b, n, -1),
                  f"attn.{l}.to_out.weight") + x
        f = F.gelu(dense(norm(x, f"ff.{l}.norm"), f"ff.{l}.proj_in.weight"),
                   approximate="tanh")
        x = dense(f, f"ff.{l}.proj_out.weight") + x
    return dense(norm(x, "final_norm"), "to_logits.weight")


def reference_loss(W, cfg, tokens, rnd=ref.identity):
    lg = reference_logits(W, cfg, tokens[:, :-1], rnd)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def train_step_flops(cfg, b, n, micro=1):
    return roofline.train_step_flops(cfg, b, n, micro)


def prefill_flops(cfg, n):
    return roofline.prefill_flops(cfg, n)


def decode_flops(cfg, lens):
    return roofline.decode_flops(cfg, len(lens), sum(lens))


def decode_k4_bound_s(cfg, lens):
    return roofline.decode_k4_bound_s(cfg, sum(lens))


def tiny(cfg):
    out = dict(cfg, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
               max_seq_len=96)
    if out["attn_l2norm_groups"] > 1:
        out["attn_l2norm_groups"] = 2
    return out
'''
FAMILY = "cosine-gqa-test"
CELLS = {"train": ("cosine-enwik8-val", "val-train-s1024"),
         "serve": ("cosine-0.81b-int8w", "prod-prefill-heavy")}


@pytest.fixture
def gqa_cell(bench, tmp_path, monkeypatch):
    """``gqa_cell(kind)``: a tiny cell of the second family, on an
    existing cell's traffic and limits."""
    (tmp_path / f"{FAMILY}.py").write_text(GQA_FAMILY)
    monkeypatch.setattr(core, "ARCHS", tmp_path)

    def make(kind):
        config, like = CELLS[kind]
        base = core.Cell.load(bench, like)
        cfg = dict(core.load_json("configs", config), arch=FAMILY)
        return cut(core.Cell(f"gqa.{kind}", cfg, base.traffic, 1, base.check,
                             [], []))
    return make


def run_cell(cell):
    out = core.load_module("drivers", cell.traffic["kind"]).run(
        cell, SEED, 1.0, False, CPU, time.perf_counter(), lambda *a: None)
    return out.failed == 0 and all(v <= lim for v, lim in out.checks.values())


def test_second_family_is_the_port_with_fewer_kv_heads(gqa_cell):
    cfg = gqa_cell("serve").config
    arch = core.arch(cfg)
    model = arch.build(cfg, cfg["max_seq_len"], SEED, CPU, serving=False)
    assert [a.kv_heads for a in model.attn] == [2, 2]
    assert [a.heads for a in model.attn] == [4, 4]
    assert model.attn[0].to_k.weight.shape == (2 * 16, 64)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_second_family_runs_correct(gqa_cell, kind):
    assert run_cell(gqa_cell(kind))


def altered_token(self, logits, sample=port_engine.SlotEngine._sample):
    return (sample(self, logits) + 1) % logits.shape[-1]


def test_second_family_altered_token_is_not_correct(gqa_cell, monkeypatch):
    monkeypatch.setattr(port_engine.SlotEngine, "_sample", altered_token)
    assert not run_cell(gqa_cell("serve"))


def test_second_family_control_readings(gqa_cell):
    """``control.py``'s readings: the program's number under each limit,
    the planted faults' over one."""
    cell = gqa_cell("train")
    r = control.train_readings(cell, SEED, True, CPU)
    limits = cell.check["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(r["half_batch"][k] > limits[k] for k in limits), r
    cell = gqa_cell("serve")
    r = control.serve_readings(cell, SEED, True, 1.0, CPU)
    assert r["requests"] > 0
    assert r["program"] <= cell.check["limits"]["logit_gap"]
    assert r["altered_token"] > cell.check["limits"]["logit_gap"]


def test_second_family_counted_joins_the_record_check(gqa_cell):
    arch = core.arch(gqa_cell("serve").config)
    table = tracing.families(arch.COUNTED)
    assert set(table) == set(tracing.COUNTED) | {"K1.gqa"}
    assert "K1.gqa" in tracing.counters(table)
    window = [{"ph": "X", "cat": "kernel", "name": "void fwd_mma_kernel<>()",
               "ts": 10, "dur": 5}]
    trace = tracing.Trace(window)
    assert tracing.short_families(trace, {"K1.gqa": 2}, table) == ["K1.gqa"]
    assert tracing.short_families(trace, {"K1.gqa": 1}, table) == []
    with pytest.raises(ValueError):
        tracing.families({"K7": tracing.COUNTED["K7"]})
