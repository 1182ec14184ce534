"""Frozen peaks of the card and the operations and bytes of each op.

Every count here comes from the shapes of a call, never from what a kernel
happens to do, so a roofline share reads the same work whatever implements
it.  The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, no
sparsity) at its 700 W limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12      # HBM3

# the attention backward counted as 2.5 forwards; recompute not counted
ATTN_BWD_PER_FWD = 2.5


def bound_s(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: operations at ``peak`` or
    bytes at the HBM rate, whichever is longer."""
    return max(ops / peak, nbytes / PEAK_BYTES_PER_S)


def causal_pairs(n_q: int, n_k: int) -> int:
    """Visible (query, key) pairs of causal attention with the queries at
    the end of the keys: query i of n_q sees n_k - n_q + i + 1 keys."""
    off = n_k - n_q
    return n_q * (off + 1) + n_q * (n_q - 1) // 2


def attention_fwd_ops(b: int, h: int, pairs: int, d: int) -> float:
    """q.k and p.v: two products of 2 * d operations a visible pair."""
    return 4.0 * b * h * pairs * d


def attention_train_ops(b: int, h: int, n: int, d: int) -> float:
    """Forward and backward of causal self-attention over n tokens."""
    return (1 + ATTN_BWD_PER_FWD) * attention_fwd_ops(b, h, causal_pairs(n, n), d)


def attention_train_bytes(b: int, h: int, kvh: int, n: int, d: int,
                          elt: int = 2) -> float:
    """Each operand read once, each result written once: forward reads q,
    k, v and writes o and the f32 row sums; backward reads q, k, v, o, do
    and the row sums and writes dq, dk, dv."""
    q = b * h * n * d * elt
    kv = b * kvh * n * d * elt
    rows = b * h * n * 4
    fwd = q + 2 * kv + q + rows
    bwd = 3 * q + 2 * kv + rows + q + 2 * kv
    return float(fwd + bwd)


def k4_bytes(live_tokens: int, kv_heads: int, d: int) -> float:
    """K4 (decode over the int8 KV cache): every live token's K and V
    codes and its f32 V scale, read once, per kv head."""
    return float(live_tokens * kv_heads * (2 * d + 4))


def k7_ops(m: int, n: int, k: int) -> float:
    """K7 (x (m, k) times int8 w (k, n)): 2 m n k."""
    return 2.0 * m * n * k


def k7_bytes(m: int, n: int, k: int, x_elt: int = 2) -> float:
    """The int8 weights and their f32 column scales read once, x read
    once and y written once."""
    return float(k * n + 4 * n + m * k * x_elt + m * n * x_elt)


def k7_bound_s(m: int, n: int, k: int) -> float:
    return bound_s(k7_ops(m, n, k), k7_bytes(m, n, k))


# --- the model's products ------------------------------------------------

def dense_shapes(cfg: dict) -> list:
    """(in, out) of every dense product of one layer of the model, in the
    order a pass runs them, and of the logits (last)."""
    dim, h, kvh, dh = (cfg["dim"], cfg["heads"], cfg.get("kv_heads") or
                       cfg["heads"], cfg["dim_head"])
    hidden = dim * cfg["ff_mult"]
    layer = [(dim, (h + 2 * kvh) * dh), (h * dh, dim), (dim, hidden),
             (hidden, dim)]
    return layer * cfg["depth"] + [(dim, cfg["num_tokens"])]


def dense_params(cfg: dict) -> int:
    return sum(i * o for i, o in dense_shapes(cfg))


def train_step_flops(cfg: dict, b: int, n: int, micro: int = 1) -> float:
    """Model FLOPs of one training step of ``micro`` microbatches of
    (b, n) tokens: 6 per dense weight and token, the attention forward
    and backward; recompute not counted."""
    tokens = micro * b * n
    attn = cfg["depth"] * attention_train_ops(micro * b, cfg["heads"], n,
                                              cfg["dim_head"])
    return 6.0 * dense_params(cfg) * tokens + attn


def prefill_flops(cfg: dict, n: int) -> float:
    """A prompt of n real tokens: 2 per dense weight and token, causal
    attention forward."""
    attn = cfg["depth"] * attention_fwd_ops(1, cfg["heads"], causal_pairs(n, n),
                                            cfg["dim_head"])
    return 2.0 * dense_params(cfg) * n + attn


def decode_flops(cfg: dict, rows: int, live: int) -> float:
    """One decode step of ``rows`` slots that attend ``live`` tokens in
    all (each slot's context, its new token included)."""
    attn = cfg["depth"] * attention_fwd_ops(1, cfg["heads"], live,
                                            cfg["dim_head"])
    return 2.0 * dense_params(cfg) * rows + attn


def dense_k7_bound_s(cfg: dict, n: int) -> float:
    """K7's least time over the dense products of one pass of n rows."""
    return sum(k7_bound_s(n, o, i) for i, o in dense_shapes(cfg))


def decode_k4_bound_s(cfg: dict, live: int) -> float:
    """K4's least time over one decode step's layers, ``live`` tokens
    attended over its slots."""
    kvh = cfg.get("kv_heads") or cfg["heads"]
    return cfg["depth"] * k4_bytes(live, kvh, cfg["dim_head"]) / PEAK_BYTES_PER_S
