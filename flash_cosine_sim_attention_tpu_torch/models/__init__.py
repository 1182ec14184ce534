from .convert import flax_param_shapes, params_from_flax, params_to_flax
from .decoding import (
    DecodeState,
    PagedDecodeState,
    decode_step,
    decode_step_paged,
    init_decode_state,
    init_paged_decode_state,
    prefill,
    prefill_continue,
    prefill_continue_paged,
    prefill_paged,
)
from .transformer import (
    Attention,
    CosineSimCausalTransformer,
    FeedForward,
    generate,
    top_k_filter,
)

__all__ = [
    "Attention",
    "CosineSimCausalTransformer",
    "DecodeState",
    "FeedForward",
    "PagedDecodeState",
    "decode_step",
    "decode_step_paged",
    "flax_param_shapes",
    "generate",
    "init_decode_state",
    "init_paged_decode_state",
    "params_from_flax",
    "params_to_flax",
    "prefill",
    "prefill_continue",
    "prefill_continue_paged",
    "prefill_paged",
    "top_k_filter",
]
