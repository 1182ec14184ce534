"""Plain PyTorch reference layer: l2 normalization, the shape rules, and
the unfused cosine-sim attention oracle.

Counterpart of ``flash_cosine_sim_attention_tpu/ops/reference.py``
(itself the reference's Python layer, ref .py:38-126).  Everything runs
on any device and in any dtype; sums are taken in float32.
"""

from __future__ import annotations

from typing import Optional

import torch


def _norm_eps(dtype) -> float:
    """Dtype-dependent norm clamp (ref .py:39: 1e-12 f32 / 1e-3 half)."""
    if dtype in (torch.float16, torch.bfloat16):
        return 1e-3
    return 1e-12


def l2norm(t: torch.Tensor, eps: Optional[float] = None) -> torch.Tensor:
    """L2-normalize the last dimension with a clamped norm (norm in f32)."""
    eps = _norm_eps(t.dtype) if eps is None else eps
    tf = t.float()
    norm = torch.linalg.vector_norm(tf, dim=-1, keepdim=True)
    return (tf / norm.clamp_min(eps)).to(t.dtype)


def grouped_l2norm(t: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """L2-normalize ``groups`` sub-vectors of the last dim (ref .py:50-55)."""
    if groups == 1:
        return l2norm(t)
    dim = t.shape[-1]
    if dim % groups:
        raise ValueError(f"head dim {dim} not divisible by groups {groups}")
    return l2norm(t.reshape(*t.shape[:-1], groups, dim // groups)).reshape(
        t.shape)


def l2norm_tensors(*tensors: torch.Tensor, groups: int = 1):
    """Grouped-l2norm each tensor in the first one's dtype (ref .py:57-65)."""
    dtype = tensors[0].dtype
    out = tuple(grouped_l2norm(t, groups=groups).to(dtype) for t in tensors)
    return out if len(out) > 1 else out[0]


def canonicalize_qkv(q, k, v, attn_bias_batch_dim):
    """Apply the reference's shape rules; return 4-D views + restore info.

    * 3-D q => merged batch-head: (b*h, 1, n, d), with
      ``attn_bias_batch_dim`` forced True (ref cu:1647-1654).
    * 3-D k/v => single-headed KV: (b, 1, j, d) (ref cu:1656-1660).
    """
    merged_batch_heads = q.ndim == 3
    if merged_batch_heads:
        if k.ndim != 3 or v.ndim != 3:
            raise ValueError(
                "if batch and heads are merged for queries, keys and values "
                "must also have only 3 dimensions")
        attn_bias_batch_dim = True
        q = q[:, None]
    single_head_kv = k.ndim == 3
    if single_head_kv:
        k = k[:, None]
        v = v[:, None]
    if not q.shape[-1] == k.shape[-1] == v.shape[-1]:
        raise ValueError("q, k, v head dims must match")
    if k.shape[-2] != v.shape[-2]:
        raise ValueError("k and v sequence lengths must match")
    return q, k, v, merged_batch_heads, single_head_kv, attn_bias_batch_dim


def causal_keep(seq_q: int, seq_k: int, device) -> torch.Tensor:
    """(i, j) bool: query row r sees key cols <= r + (j - i), the
    cross-attention causal alignment (ref .py:114)."""
    row = torch.arange(seq_q, device=device)[:, None]
    col = torch.arange(seq_k, device=device)[None, :]
    return col <= row + (seq_k - seq_q)


def plain_cosine_sim_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    scale: float = 8.0,
    groups: int = 1,
    causal: bool = False,
    l2norm_qk: bool = True,
    attn_bias_batch_dim: bool = False,
) -> torch.Tensor:
    """Unfused cosine-sim attention with a softmax; numerically the ground
    truth (a fully masked row gets the uniform average, as upstream)."""
    if causal and mask is not None:
        raise ValueError("mask should not be supplied if causality is needed")
    q, k, v, merged, _, attn_bias_batch_dim = canonicalize_qkv(
        q, k, v, attn_bias_batch_dim)
    if l2norm_qk:
        q, k = l2norm_tensors(q, k, groups=groups)
    dtype = q.dtype
    h, kvh = q.shape[1], k.shape[1]
    if 1 < kvh < h:
        k = k.repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
    sim = q.float() @ k.float().transpose(-1, -2) * scale
    if attn_bias is not None:
        bias = attn_bias[:, None] if attn_bias_batch_dim else attn_bias[None]
        sim = sim + bias.float()
    mask_value = -torch.finfo(torch.float32).max
    if causal:
        sim = sim.masked_fill(
            ~causal_keep(*sim.shape[-2:], sim.device), mask_value)
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :], mask_value)
    out = (sim.softmax(dim=-1) @ v.float()).to(dtype)
    return out[:, 0] if merged else out
