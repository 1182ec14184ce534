from .flash_attention import flash_cosine_sim_attention
from .fwd_kernel import flash_attention_forward, flash_attention_forward_plain
from .reference import (
    canonicalize_qkv,
    grouped_l2norm,
    l2norm,
    l2norm_tensors,
    plain_cosine_sim_attention,
)

__all__ = [
    "canonicalize_qkv",
    "flash_attention_forward",
    "flash_attention_forward_plain",
    "flash_cosine_sim_attention",
    "grouped_l2norm",
    "l2norm",
    "l2norm_tensors",
    "plain_cosine_sim_attention",
]
