"""GPT-style validation transformer around cosine-sim attention.

Counterpart of ``flash_cosine_sim_attention_tpu/models/transformer.py``
as ``nn.Module``s with the same structure, parameter layout
(``models/convert.py`` loads and exports the flax parameters) and init.
Like the flax modules, each module holds its parameters in
``param_dtype`` (float32 by default: the trainer's Adam keeps f32 master
weights) and casts them, and its input, to the compute ``dtype`` at use,
so the attention kernels see the q/k/v dtype the JAX model gives them.
Parity details: flax ``LayerNorm`` takes its statistics in float32 with
eps 1e-6, flax ``gelu`` is the tanh approximation, and flax's
``variance_scaling(gain**2, "fan_avg", "normal")`` is torch's
``xavier_normal_(gain)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._build import resolve_device
from ..ops import (
    flash_cosine_sim_attention,
    l2norm_tensors,
    non_cosine_sim_attention,
    plain_cosine_sim_attention,
)

LAYERNORM_EPS = 1e-6  # flax default


class Dense(nn.Module):
    """Bias-free flax ``Dense``: ``weight`` (out, in) in ``param_dtype``,
    xavier-normal init with ``gain``; computes in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, gain: float = 1.0,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype, device=device))
        nn.init.xavier_normal_(self.weight, gain)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: scale 1 and bias 0 at init, statistics and
    normalization in float32, output in ``dtype``."""

    def __init__(self, dim: int, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=param_dtype, device=device)
        self.weight = nn.Parameter(torch.ones(dim, **kw))
        self.bias = nn.Parameter(torch.zeros(dim, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), LAYERNORM_EPS).to(self.dtype)


class Embed(nn.Module):
    """flax ``Embed``: table N(0, std) in ``param_dtype``, cast to
    ``dtype`` before the gather."""

    def __init__(self, num: int, dim: int, std: float, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            num, dim, dtype=param_dtype, device=device))
        nn.init.normal_(self.weight, std=std)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight.to(self.dtype))


class Attention(nn.Module):
    """Causal cosine-sim attention block: projections without bias; the
    fused op, the plain oracle (``use_fused=False``) or the vanilla-softmax
    baseline (``non_cosine_sim_attn``)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 kv_heads: Optional[int] = None, scale: float = 8.0,
                 l2norm_groups: int = 1, pre_norm: bool = False,
                 use_fused: bool = True, non_cosine_sim_attn: bool = False,
                 init_gain: float = 1.0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kvh = kv_heads or heads
        if heads % kvh:
            raise ValueError(f"heads {heads} not divisible by kv_heads {kvh}")
        if non_cosine_sim_attn and kvh != heads:
            raise ValueError("the vanilla-softmax baseline is MHA-only")
        self.heads, self.kv_heads, self.dim_head = heads, kvh, dim_head
        self.scale, self.l2norm_groups = scale, l2norm_groups
        self.use_fused, self.non_cosine_sim_attn = use_fused, non_cosine_sim_attn
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm = LayerNorm(dim, **kw) if pre_norm else None
        self.to_q = Dense(dim, dim_head * heads, 1.0, **kw)
        self.to_k = Dense(dim, dim_head * kvh, 1.0, **kw)
        self.to_v = Dense(dim, dim_head * kvh, init_gain, **kw)
        self.to_out = Dense(dim_head * heads, dim, init_gain, **kw)

    def project(self, x: torch.Tensor):
        """(b, n, dim) -> q (b, h, n, d), k, v (b, kvh, n, d)."""
        if self.norm is not None:
            x = self.norm(x)

        def split(t, nh):
            return t.reshape(*t.shape[:-1], nh, self.dim_head).transpose(1, 2)
        return (split(self.to_q(x), self.heads),
                split(self.to_k(x), self.kv_heads),
                split(self.to_v(x), self.kv_heads))

    def qkv(self, x: torch.Tensor):
        """``project`` with q and k l2-normalized."""
        q, k, v = self.project(x)
        q, k = l2norm_tensors(q, k, groups=self.l2norm_groups)
        return q, k, v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """(b, h, n, d) attention output -> (b, n, dim)."""
        o = o.transpose(1, 2)
        return self.to_out(o.reshape(*o.shape[:2], -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.non_cosine_sim_attn:
            return self.out(non_cosine_sim_attention(*self.project(x)))
        attend = (flash_cosine_sim_attention if self.use_fused
                  else plain_cosine_sim_attention)
        return self.out(attend(*self.qkv(x), causal=True, scale=self.scale,
                               l2norm_qk=False))


class FeedForward(nn.Module):
    """Linear-GELU(tanh)-Linear, ``mult``x expansion."""

    def __init__(self, dim: int, mult: int = 4, pre_norm: bool = False,
                 init_gain: float = 1.0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm = LayerNorm(dim, **kw) if pre_norm else None
        self.proj_in = Dense(dim, dim * mult, init_gain, **kw)
        self.proj_out = Dense(dim * mult, dim, init_gain, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        return self.proj_out(F.gelu(self.proj_in(x), approximate="tanh"))


# attn_fn(layer, q, k, v) -> (b, h, n, d) attention output of that layer
AttnFn = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


class CosineSimCausalTransformer(nn.Module):
    """Char-level causal LM for validating the attention kernels.

    Built on ``device`` (default ``cuda``; raises when no card is present
    and the CPU was not asked for), with JAX's init: post-norm takes the
    DeepNet gain (8 * depth) ** -0.25 on to_v / to_out / FF and embeddings
    N(0, 1e-5), pre-norm gain 1 and N(0, 0.02)."""

    def __init__(self, num_tokens: int, dim: int, max_seq_len: int,
                 depth: int, heads: int = 8, kv_heads: Optional[int] = None,
                 dim_head: int = 64, attn_scale: float = 8.0,
                 attn_l2norm_groups: int = 1, pre_norm: bool = False,
                 use_fused: bool = True, non_cosine_sim_attn: bool = False,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_tokens, self.dim, self.max_seq_len = num_tokens, dim, max_seq_len
        self.depth, self.heads, self.dim_head = depth, heads, dim_head
        self.kv_heads = kv_heads or heads
        self.attn_scale, self.attn_l2norm_groups = attn_scale, attn_l2norm_groups
        self.pre_norm, self.dtype = pre_norm, dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        emb_std = 0.02 if pre_norm else 1e-5
        gain = 1.0 if pre_norm else (8 * depth) ** -0.25
        self.token_emb = Embed(num_tokens, dim, emb_std, **kw)
        self.pos_emb = Embed(max_seq_len, dim, emb_std, **kw)
        self.attn = nn.ModuleList(
            Attention(dim, dim_head, heads, kv_heads, attn_scale,
                      attn_l2norm_groups, pre_norm, use_fused,
                      non_cosine_sim_attn, gain, **kw)
            for _ in range(depth))
        self.ff = nn.ModuleList(
            FeedForward(dim, pre_norm=pre_norm, init_gain=gain, **kw)
            for _ in range(depth))
        if pre_norm:
            self.final_norm = LayerNorm(dim, **kw)
        else:
            self.attn_norm = nn.ModuleList(
                LayerNorm(dim, **kw) for _ in range(depth))
            self.ff_norm = nn.ModuleList(
                LayerNorm(dim, **kw) for _ in range(depth))
        self.to_logits = Dense(dim, num_tokens, 1.0, **kw)

    @property
    def device(self) -> torch.device:
        return self.to_logits.weight.device

    @property
    def residual_scale(self) -> float:
        # DeepNet residual scaling, post-norm only (ref transformer.py:132)
        return 1.0 if self.pre_norm else (2 * self.depth) ** 0.25

    def embed(self, tokens: torch.Tensor, pos0: torch.Tensor) -> torch.Tensor:
        """tokens (b, n) at per-slot start positions pos0 (b,).  Positions
        past the table are clamped to its last row, as the JAX gather
        clamps; they only occur on right-pad rows, which are never read."""
        n = tokens.shape[1]
        pos = pos0[:, None].long() + torch.arange(n, device=tokens.device)
        pos = pos.clamp(max=self.max_seq_len - 1)
        return self.token_emb(tokens) + self.pos_emb(pos)

    def trunk(self, h: torch.Tensor, attn_fn: Optional[AttnFn] = None
              ) -> torch.Tensor:
        """Embedded (b, n, dim) -> logits (b, n, vocab).  ``attn_fn``
        supplies each layer's attention output from its q, k, v (cached
        decoding); None runs each layer's own causal attention."""
        res = self.residual_scale
        for layer in range(self.depth):
            attn = self.attn[layer]
            a = attn(h) if attn_fn is None else attn.out(
                attn_fn(layer, *attn.qkv(h)))
            h = a + h * res
            if not self.pre_norm:
                h = self.attn_norm[layer](h)
            h = self.ff[layer](h) + h * res
            if not self.pre_norm:
                h = self.ff_norm[layer](h)
        if self.pre_norm:
            h = self.final_norm(h)
        return self.to_logits(h)

    def forward(self, tokens: torch.Tensor, return_loss: bool = False
                ) -> torch.Tensor:
        """tokens (b, n) -> logits (b, n, vocab); with ``return_loss``, the
        mean next-token cross-entropy of tokens[:, 1:] given tokens[:, :-1]
        (log-softmax in float32)."""
        if return_loss:
            tokens, labels = tokens[:, :-1], tokens[:, 1:]
        pos0 = torch.zeros(tokens.shape[0], dtype=torch.int32,
                           device=tokens.device)
        logits = self.trunk(self.embed(tokens, pos0))
        if not return_loss:
            return logits
        logp = F.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, labels[..., None].long()).mean()


def top_k_filter(logits: torch.Tensor, thres: float = 0.9) -> torch.Tensor:
    """Keep the top (1-thres) fraction of logits (ties at the k-th value
    included), -inf the rest (ref transformer.py:41-46)."""
    k = max(1, int((1 - thres) * logits.shape[-1]))
    kth = logits.topk(k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


@torch.no_grad()
def generate(model: CosineSimCausalTransformer, start_tokens: torch.Tensor,
             seq_len: int, temperature: float = 1.0,
             filter_thres: float = 0.9,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Top-k autoregressive sampling (ref transformer.py:167-181): each new
    token is drawn from the logits of the last real token, given the last
    ``max_seq_len`` tokens.  start_tokens (b, n) -> (b, seq_len).  The JAX
    version runs the model on a fixed-size window whose tail is padding;
    causal attention makes the last real row the same, so the port feeds
    only the real tokens."""
    buf = start_tokens.long()
    n = buf.shape[1]
    for _ in range(seq_len):
        logits = model(buf[:, -model.max_seq_len:])[:, -1].float()
        probs = F.softmax(top_k_filter(logits, filter_thres) / temperature,
                          dim=-1)
        sample = torch.multinomial(probs, 1, generator=generator)
        buf = torch.cat([buf, sample], dim=1)
    return buf[:, n:]
