"""GPT-style validation transformer around cosine-sim attention, for
inference.

Counterpart of ``flash_cosine_sim_attention_tpu/models/transformer.py``
as ``nn.Module``s with the same structure and parameter layout
(``models/convert.py`` loads the flax parameters).  Only the forward pass
is ported; training arrives with the backward kernels.  Parity details:
flax ``LayerNorm`` uses eps 1e-6 and flax ``gelu`` the tanh
approximation.  Parameters are held in the model's compute dtype, which is
what the flax modules cast their float32 parameters to.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .._build import resolve_device
from ..ops import flash_cosine_sim_attention, l2norm_tensors

LAYERNORM_EPS = 1e-6  # flax default


class Attention(nn.Module):
    """Causal cosine-sim attention block: projections without bias."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 kv_heads: Optional[int] = None, scale: float = 8.0,
                 l2norm_groups: int = 1, pre_norm: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        kvh = kv_heads or heads
        if heads % kvh:
            raise ValueError(f"heads {heads} not divisible by kv_heads {kvh}")
        self.heads, self.kv_heads, self.dim_head = heads, kvh, dim_head
        self.scale, self.l2norm_groups = scale, l2norm_groups
        kw = dict(bias=False, dtype=dtype, device=device)
        self.norm = (nn.LayerNorm(dim, eps=LAYERNORM_EPS, dtype=dtype,
                                  device=device) if pre_norm else None)
        self.to_q = nn.Linear(dim, dim_head * heads, **kw)
        self.to_k = nn.Linear(dim, dim_head * kvh, **kw)
        self.to_v = nn.Linear(dim, dim_head * kvh, **kw)
        self.to_out = nn.Linear(dim_head * heads, dim, **kw)

    def qkv(self, x: torch.Tensor):
        """(b, n, dim) -> q (b, h, n, d), k, v (b, kvh, n, d), with q and k
        l2-normalized."""
        if self.norm is not None:
            x = self.norm(x)

        def split(t, nh):
            return t.reshape(*t.shape[:-1], nh, self.dim_head).transpose(1, 2)
        q = split(self.to_q(x), self.heads)
        k = split(self.to_k(x), self.kv_heads)
        v = split(self.to_v(x), self.kv_heads)
        q, k = l2norm_tensors(q, k, groups=self.l2norm_groups)
        return q, k, v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """(b, h, n, d) attention output -> (b, n, dim)."""
        o = o.transpose(1, 2)
        return self.to_out(o.reshape(*o.shape[:2], -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x)
        return self.out(flash_cosine_sim_attention(
            q, k, v, causal=True, scale=self.scale, l2norm_qk=False))


class FeedForward(nn.Module):
    """Linear-GELU(tanh)-Linear, ``mult``x expansion."""

    def __init__(self, dim: int, mult: int = 4, pre_norm: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.norm = (nn.LayerNorm(dim, eps=LAYERNORM_EPS, dtype=dtype,
                                  device=device) if pre_norm else None)
        kw = dict(bias=False, dtype=dtype, device=device)
        self.proj_in = nn.Linear(dim, dim * mult, **kw)
        self.act = nn.GELU(approximate="tanh")
        self.proj_out = nn.Linear(dim * mult, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        return self.proj_out(self.act(self.proj_in(x)))


# attn_fn(layer, q, k, v) -> (b, h, n, d) attention output of that layer
AttnFn = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


class CosineSimCausalTransformer(nn.Module):
    """Char-level causal LM for validating the attention kernels.

    Built on ``device`` (default ``cuda``; raises when no card is present
    and the CPU was not asked for)."""

    def __init__(self, num_tokens: int, dim: int, max_seq_len: int,
                 depth: int, heads: int = 8, kv_heads: Optional[int] = None,
                 dim_head: int = 64, attn_scale: float = 8.0,
                 attn_l2norm_groups: int = 1, pre_norm: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_tokens, self.dim, self.max_seq_len = num_tokens, dim, max_seq_len
        self.depth, self.heads, self.dim_head = depth, heads, dim_head
        self.kv_heads = kv_heads or heads
        self.attn_scale, self.attn_l2norm_groups = attn_scale, attn_l2norm_groups
        self.pre_norm, self.dtype = pre_norm, dtype
        kw = dict(dtype=dtype, device=device)
        self.token_emb = nn.Embedding(num_tokens, dim, **kw)
        self.pos_emb = nn.Embedding(max_seq_len, dim, **kw)
        self.attn = nn.ModuleList(
            Attention(dim, dim_head, heads, kv_heads, attn_scale,
                      attn_l2norm_groups, pre_norm, **kw)
            for _ in range(depth))
        self.ff = nn.ModuleList(
            FeedForward(dim, pre_norm=pre_norm, **kw) for _ in range(depth))
        if pre_norm:
            self.final_norm = nn.LayerNorm(dim, eps=LAYERNORM_EPS, **kw)
        else:
            self.attn_norm = nn.ModuleList(
                nn.LayerNorm(dim, eps=LAYERNORM_EPS, **kw)
                for _ in range(depth))
            self.ff_norm = nn.ModuleList(
                nn.LayerNorm(dim, eps=LAYERNORM_EPS, **kw)
                for _ in range(depth))
        self.to_logits = nn.Linear(dim, num_tokens, bias=False, **kw)

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

    def trunk(self, h: torch.Tensor, attn_fn: AttnFn) -> torch.Tensor:
        """Embedded (b, n, dim) -> logits (b, n, vocab); ``attn_fn``
        supplies each layer's attention output from its q, k, v."""
        res = self.residual_scale
        for layer in range(self.depth):
            attn = self.attn[layer]
            h = attn.out(attn_fn(layer, *attn.qkv(h))) + h * res
            if not self.pre_norm:
                h = self.attn_norm[layer](h)
            h = self.ff[layer](h) + h * res
            if not self.pre_norm:
                h = self.ff_norm[layer](h)
        if self.pre_norm:
            h = self.final_norm(h)
        return self.to_logits(h)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full causal forward: tokens (b, n) -> logits (b, n, vocab)."""
        def attn(layer, q, k, v):
            return flash_cosine_sim_attention(
                q, k, v, causal=True, scale=self.attn_scale, l2norm_qk=False)
        pos0 = torch.zeros(tokens.shape[0], dtype=torch.int32,
                           device=tokens.device)
        return self.trunk(self.embed(tokens, pos0), attn)


def top_k_filter(logits: torch.Tensor, thres: float = 0.9) -> torch.Tensor:
    """Keep the top (1-thres) fraction of logits (ties at the k-th value
    included), -inf the rest (ref transformer.py:41-46)."""
    k = max(1, int((1 - thres) * logits.shape[-1]))
    kth = logits.topk(k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))
