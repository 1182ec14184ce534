from .convert import flax_param_shapes, params_from_flax
from .decoding import (
    DecodeState,
    decode_step,
    init_decode_state,
    prefill,
    prefill_continue,
)
from .transformer import (
    Attention,
    CosineSimCausalTransformer,
    FeedForward,
    top_k_filter,
)

__all__ = [
    "Attention",
    "CosineSimCausalTransformer",
    "DecodeState",
    "FeedForward",
    "decode_step",
    "flax_param_shapes",
    "init_decode_state",
    "params_from_flax",
    "prefill",
    "prefill_continue",
    "top_k_filter",
]
