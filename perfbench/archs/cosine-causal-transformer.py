"""The model family ``cosine-causal-transformer``: the port's
``CosineSimCausalTransformer``, pre-norm (LayerNorm, a tanh-GELU MLP,
learned absolute positions, cosine-sim attention, MHA or GQA by index).

A configuration names its family under ``arch``, and the harness finds
this file by that name (``core.arch``).  It is the one part of the
harness that knows the model's layout: how the program is built and
given the benchmark's weights, the plain reference, the model's work
counts and the bounds the per-layer readers take.  Its reference is
``reference/model.py`` and its counts ``roofline.py``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import roofline
from perfbench.reference import model as ref

# kernel families this family adds to ``trace.COUNTED``'s record check
COUNTED: Dict[str, tuple] = {}

ELT = {"bfloat16": 2, "float32": 4}


def build(cfg: dict, max_seq_len: int, seed: int, device, serving: bool):
    """The program's model of configuration ``cfg``, its leaves in the
    configuration's dtype holding the benchmark's weights, drawn on
    ``device`` from ``seed`` (``reference.model.make_weights``, which the
    reference draws again).  Built on the meta device first, so the
    program's own initialization draws nothing.  ``serving``: quantized
    and fused as the configuration says, in eval mode."""
    from flash_cosine_sim_attention_tpu_torch.models import (
        CosineSimCausalTransformer)
    from flash_cosine_sim_attention_tpu_torch.models.decoding import (
        fuse_qkv_params, quantize_params)

    param_dtype = getattr(torch, cfg["param_dtype"])
    model = CosineSimCausalTransformer(
        num_tokens=cfg["num_tokens"], dim=cfg["dim"], max_seq_len=max_seq_len,
        depth=cfg["depth"], heads=cfg["heads"], kv_heads=cfg.get("kv_heads"),
        dim_head=cfg["dim_head"], attn_scale=cfg["attn_scale"],
        attn_l2norm_groups=cfg["attn_l2norm_groups"], pre_norm=True,
        use_fused=True, dtype=getattr(torch, cfg["compute_dtype"]),
        param_dtype=param_dtype, device="meta").to_empty(device=device)
    weights = ref.make_weights(cfg, max_seq_len, seed, device, param_dtype)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the model's leaves differ from the benchmark's: "
                           f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    # the drawn leaves are freed before quantizing, or they would set the
    # served run's memory peak (1 GB above the program's own, 0.81B model)
    del weights, params
    if not serving:
        return model
    if cfg.get("int8_weights"):
        quantize_params(model)
    if cfg.get("fused_qkv"):
        fuse_qkv_params(model)
    return model.eval()


def reference_weights(cfg: dict, max_seq_len: int, seed: int, device,
                      serving: bool) -> Dict[str, torch.Tensor]:
    """float32 leaves of the same weights: for serving drawn in the
    configuration's dtype and, with int8 weights, quantized and
    dequantized as the program holds them; for training drawn in
    float32, the dict that ``reference/train.py``'s Adam updates."""
    if not serving:
        return ref.make_weights(cfg, max_seq_len, seed, device, torch.float32)
    raw = ref.make_weights(cfg, max_seq_len, seed, device,
                           getattr(torch, cfg["param_dtype"]))
    return ref.served_weights(raw) if cfg.get("int8_weights") else {
        k: v.float() for k, v in raw.items()}


def reference_logits(W, cfg: dict, tokens: torch.Tensor, rnd=ref.identity,
                     prompt_len=None) -> torch.Tensor:
    return ref.logits(W, cfg, tokens, rnd, prompt_len=prompt_len)


def reference_loss(W, cfg: dict, tokens: torch.Tensor,
                   rnd=ref.identity) -> torch.Tensor:
    return ref.loss(W, cfg, tokens, rnd)


# --- the model's work ------------------------------------------------------

def train_step_flops(cfg: dict, b: int, n: int, micro: int = 1) -> float:
    return roofline.train_step_flops(cfg, b, n, micro)


def prefill_flops(cfg: dict, n: int) -> float:
    return roofline.prefill_flops(cfg, n)


def decode_flops(cfg: dict, lens: List[int]) -> float:
    """One decode step of the slots whose context lengths, each new token
    included, are ``lens``: every layer attends a slot's whole context."""
    return roofline.decode_flops(cfg, len(lens), sum(lens))


# --- the bounds the per-layer readers take --------------------------------

def attention_train_bound_s(cfg: dict, b: int, n: int) -> float:
    """The attention kernels' least time over one training step's layers:
    the forward and backward of causal attention on (b, n)."""
    h, d = cfg["heads"], cfg["dim_head"]
    kvh = cfg.get("kv_heads") or h
    return cfg["depth"] * roofline.bound_s(
        roofline.attention_train_ops(b, h, n, d),
        roofline.attention_train_bytes(b, h, kvh, n, d))


def k1_prefill_bound_s(cfg: dict, rows: int) -> float:
    """K1's least time over the layers of one prefill of ``rows`` real
    tokens: ``causal_pairs`` and ``attention_fwd_ops`` at the bf16 peak,
    or q, k, v and o moved once with the f32 row sums."""
    h, d = cfg["heads"], cfg["dim_head"]
    kvh = cfg.get("kv_heads") or h
    ops = roofline.attention_fwd_ops(1, h, roofline.causal_pairs(rows, rows),
                                     d)
    nbytes = ((2 * h + 2 * kvh) * rows * d * ELT[cfg["compute_dtype"]]
              + 4 * h * rows)
    return cfg["depth"] * roofline.bound_s(ops, nbytes)


def decode_k4_bound_s(cfg: dict, lens: List[int]) -> float:
    """K4's least time over one decode step's layers: every slot's whole
    context read once."""
    return roofline.decode_k4_bound_s(cfg, sum(lens))


def dense_k7_bound_s(cfg: dict, n: int) -> float:
    """K7's least time over the dense products of one pass of n rows."""
    return roofline.dense_k7_bound_s(cfg, n)


# --- tests -----------------------------------------------------------------

def tiny(cfg: dict) -> dict:
    """``cfg`` cut to widths the CPU runs in seconds: two layers of two
    heads of 32, 96 positions; more than one l2norm group becomes two."""
    out = dict(cfg, dim=64, depth=2, heads=2, dim_head=32, max_seq_len=96)
    if out["attn_l2norm_groups"] > 1:
        out["attn_l2norm_groups"] = 2
    return out
