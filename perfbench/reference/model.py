"""Plain float32 reference of the cosine-sim causal transformer.

Written from the model's equations, not from the program: pre-norm blocks
(LayerNorm with eps 1e-6, bias-free dense layers), q and k l2-normalized
in ``attn_l2norm_groups`` groups, causal softmax attention at
``attn_scale``, a tanh-GELU feed-forward, a final LayerNorm and the
logits.  It imports nothing of the program and nothing of JAX.

Matrix products take their operands through ``rnd``: the identity for the
reference, ``fp8`` for the control (every operand rounded through e4m3
at a per-tensor scale, straight through for gradients).  Attention runs
in blocks of query rows, with its backward recomputing each block, so a
16384-token sequence fits.  Call under ``exact_matmuls()``: TF32 off.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
NORM_EPS = 1e-12
FP8_MAX = 448.0
ROWS = 1024                    # query rows an attention block takes

Rounding = Callable[[torch.Tensor], torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 at a per-tensor absmax scale;
    the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    r = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (r - t.detach()) if t.requires_grad else r


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# --- parameters ------------------------------------------------------------

def param_spec(cfg: dict, max_seq_len: int):
    """(name, shape, init) of every leaf, init ("normal", std), ("ones",)
    or ("zeros",): embeddings N(0, 0.02), dense weights (out, in)
    xavier-normal at gain 1 (pre-norm), LayerNorms 1 and 0."""
    dim, h, dh = cfg["dim"], cfg["heads"], cfg["dim_head"]
    kvh = cfg.get("kv_heads") or h
    hidden = dim * cfg["ff_mult"]

    def dense(out, inp):
        return ((out, inp), ("normal", math.sqrt(2.0 / (inp + out))))

    def norm(prefix):
        return [(f"{prefix}.weight", (dim,), ("ones",)),
                (f"{prefix}.bias", (dim,), ("zeros",))]

    spec = [("token_emb.weight", (cfg["num_tokens"], dim), ("normal", 0.02)),
            ("pos_emb.weight", (max_seq_len, dim), ("normal", 0.02))]
    for l in range(cfg["depth"]):
        spec += norm(f"attn.{l}.norm")
        spec += [(f"attn.{l}.to_q.weight", *dense(h * dh, dim)),
                 (f"attn.{l}.to_k.weight", *dense(kvh * dh, dim)),
                 (f"attn.{l}.to_v.weight", *dense(kvh * dh, dim)),
                 (f"attn.{l}.to_out.weight", *dense(dim, h * dh))]
        spec += norm(f"ff.{l}.norm")
        spec += [(f"ff.{l}.proj_in.weight", *dense(hidden, dim)),
                 (f"ff.{l}.proj_out.weight", *dense(dim, hidden))]
    spec += norm("final_norm")
    spec += [("to_logits.weight", *dense(cfg["num_tokens"], dim))]
    return spec


def make_weights(cfg: dict, max_seq_len: int, seed: int, device,
                 dtype) -> Dict[str, torch.Tensor]:
    """Every leaf drawn on ``device`` from ``seed`` in ``dtype``: one
    normal draw for all random leaves together, sliced and scaled."""
    spec = param_spec(cfg, max_seq_len)
    total = sum(math.prod(s) for _, s, init in spec if init[0] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, init in spec:
        if init[0] == "normal":
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(init[1])
            at += n
        else:
            fill = torch.ones if init[0] == "ones" else torch.zeros
            out[name] = fill(shape, device=device, dtype=dtype)
    return out


def quantize_weight(w: torch.Tensor) -> torch.Tensor:
    """An (out, in) dense weight as int8 serving holds it, dequantized:
    codes at an absmax scale per output column of the (in, out) kernel,
    rounded half to even."""
    wt = w.float().t()
    scale = wt.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / 127.0
    codes = torch.round(wt / scale).clamp(-127, 127)
    return (codes * scale).t().contiguous()


def served_weights(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """float32 weights of the int8-weight model: every dense weight
    quantized and dequantized, embeddings and LayerNorms as they are."""
    return {name: quantize_weight(w) if w.ndim == 2 and "emb" not in name
            else w.float() for name, w in raw.items()}


def quantize_k(k: torch.Tensor) -> torch.Tensor:
    """The int8 cache's K: l2-normalized components at the fixed scale
    127, dequantized."""
    return torch.round(k * 127.0).clamp(-127, 127) / 127.0


def quantize_v(v: torch.Tensor) -> torch.Tensor:
    """The int8 cache's V: a per-token absmax scale, dequantized."""
    scale = v.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(v / scale).clamp(-127, 127) * scale


# --- attention ---------------------------------------------------------------

def _block_scores(q, k, i0, scale):
    """Scores of query rows i0.. (their positions i0 + r, keys from 0)
    with the causal mask applied."""
    s = scale * (q @ k.transpose(-1, -2))
    rows = torch.arange(i0, i0 + q.shape[-2], device=q.device)[:, None]
    cols = torch.arange(k.shape[-2], device=q.device)[None, :]
    return s.masked_fill(cols > rows, float("-inf"))


class CausalAttention(torch.autograd.Function):
    """softmax(scale q k^T, causal) v over (b, h, n, d), ROWS query rows
    at a time; the backward recomputes each block from the saved row
    log-sums.  ``rnd`` rounds q, k, the probabilities and v for the
    products of the forward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rnd):
        n = q.shape[-2]
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:-1], device=q.device, dtype=q.dtype)
        qr, kr, vr = rnd(q), rnd(k), rnd(v)
        for i0 in range(0, n, ROWS):
            i1 = min(n, i0 + ROWS)
            s = _block_scores(qr[..., i0:i1, :], kr[..., :i1, :], i0, scale)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            lse[..., i0:i1] = (m + torch.log(l))[..., 0]
            o[..., i0:i1, :] = rnd(p / l) @ vr[..., :i1, :]
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, n = ctx.scale, q.shape[-2]
        delta = (do * o).sum(-1, keepdim=True)
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        for i0 in range(0, n, ROWS):
            i1 = min(n, i0 + ROWS)
            qb, kb, vb, dob = (q[..., i0:i1, :], k[..., :i1, :],
                               v[..., :i1, :], do[..., i0:i1, :])
            p = torch.exp(_block_scores(qb, kb, i0, scale)
                          - lse[..., i0:i1, None])
            dv[..., :i1, :] += p.transpose(-1, -2) @ dob
            ds = p * (dob @ vb.transpose(-1, -2) - delta[..., i0:i1, :])
            dq[..., i0:i1, :] = scale * (ds @ kb)
            dk[..., :i1, :] += scale * (ds.transpose(-1, -2) @ qb)
        return dq, dk, dv, None, None


def attend(q, k, v, scale, rnd: Rounding = identity):
    return CausalAttention.apply(q, k, v, scale, rnd)


@torch.no_grad()
def attend_served(q, k, v, scale, prompt_len: int,
                  rnd: Rounding = identity):
    """Attention as the served model runs it: query rows of the prompt
    (prefill) see the keys and values as computed, later rows (decode
    steps) see them through the int8 cache."""
    o = torch.empty_like(q)
    o[..., :prompt_len, :] = attend(q[..., :prompt_len, :],
                                    k[..., :prompt_len, :],
                                    v[..., :prompt_len, :], scale, rnd)
    n = q.shape[-2]
    if n > prompt_len:
        kq, vq = quantize_k(k), quantize_v(v)
        qr, kr, vr = rnd(q), rnd(kq), rnd(vq)
        for i0 in range(prompt_len, n, ROWS):
            i1 = min(n, i0 + ROWS)
            s = _block_scores(qr[..., i0:i1, :], kr[..., :i1, :], i0, scale)
            o[..., i0:i1, :] = rnd(torch.softmax(s, dim=-1)) @ vr[..., :i1, :]
    return o


# --- the model ---------------------------------------------------------------

def _l2norm(t: torch.Tensor, groups: int) -> torch.Tensor:
    g = t.reshape(*t.shape[:-1], groups, t.shape[-1] // groups)
    g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True).clamp_min(NORM_EPS)
    return g.reshape(t.shape)


def logits(W: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
           rnd: Rounding = identity,
           prompt_len: Optional[int] = None) -> torch.Tensor:
    """tokens (b, n) from position 0 -> logits (b, n, vocab), float32.
    With ``prompt_len`` the attention is the served model's
    (``attend_served``); without it plain causal self-attention."""
    b, n = tokens.shape
    h, dh = cfg["heads"], cfg["dim_head"]
    groups, scale = cfg["attn_l2norm_groups"], float(cfg["attn_scale"])

    def dense(x, name):
        return rnd(x) @ rnd(W[name]).t()

    def norm(x, prefix):
        return F.layer_norm(x, x.shape[-1:], W[f"{prefix}.weight"],
                            W[f"{prefix}.bias"], LN_EPS)

    def heads(t):
        return t.reshape(b, n, -1, dh).transpose(1, 2)

    pos = torch.arange(n, device=tokens.device)
    x = W["token_emb.weight"][tokens] + W["pos_emb.weight"][pos][None]
    for l in range(cfg["depth"]):
        a = norm(x, f"attn.{l}.norm")
        q = _l2norm(heads(dense(a, f"attn.{l}.to_q.weight")), groups)
        k = _l2norm(heads(dense(a, f"attn.{l}.to_k.weight")), groups)
        v = heads(dense(a, f"attn.{l}.to_v.weight"))
        if prompt_len is None:
            o = attend(q, k, v, scale, rnd)
        else:
            o = attend_served(q, k, v, scale, prompt_len, rnd)
        x = dense(o.transpose(1, 2).reshape(b, n, h * dh),
                  f"attn.{l}.to_out.weight") + x
        f = norm(x, f"ff.{l}.norm")
        f = F.gelu(dense(f, f"ff.{l}.proj_in.weight"), approximate="tanh")
        x = dense(f, f"ff.{l}.proj_out.weight") + x
    return dense(norm(x, "final_norm"), "to_logits.weight")


def loss(W, cfg, tokens, rnd: Rounding = identity) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens[:, 1:] given tokens[:, :-1]."""
    lg = logits(W, cfg, tokens[:, :-1], rnd)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           tokens[:, 1:].reshape(-1))
