from .bwd_kernel import (
    flash_attention_backward,
    flash_attention_backward_plain,
)
from .flash_attention import flash_cosine_sim_attention
from .fwd_kernel import flash_attention_forward, flash_attention_forward_plain
from .reference import (
    canonicalize_qkv,
    grouped_l2norm,
    l2norm,
    l2norm_tensors,
    non_cosine_sim_attention,
    plain_cosine_sim_attention,
    streaming_cosine_sim_attention,
)

__all__ = [
    "canonicalize_qkv",
    "flash_attention_backward",
    "flash_attention_backward_plain",
    "flash_attention_forward",
    "flash_attention_forward_plain",
    "flash_cosine_sim_attention",
    "grouped_l2norm",
    "l2norm",
    "l2norm_tensors",
    "non_cosine_sim_attention",
    "plain_cosine_sim_attention",
    "streaming_cosine_sim_attention",
]
