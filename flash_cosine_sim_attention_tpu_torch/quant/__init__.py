from .decode_kernel import (
    decode_attention_plain,
    quantized_decode_attention,
    reference_decode_attention,
)
from .kv_cache import (
    FP8_DTYPE,
    K_SCALE,
    QuantKVCache,
    append,
    dequantize_k,
    dequantize_v,
    init_cache,
    quantize_k,
    quantize_v,
)
from .paged import (
    PageAllocator,
    PagedKVCache,
    append_paged,
    gather_pages,
    init_paged_cache,
    paged_decode_attention,
    paged_decode_plain,
)

__all__ = [
    "FP8_DTYPE",
    "K_SCALE",
    "PageAllocator",
    "PagedKVCache",
    "QuantKVCache",
    "append",
    "append_paged",
    "decode_attention_plain",
    "dequantize_k",
    "dequantize_v",
    "gather_pages",
    "init_cache",
    "init_paged_cache",
    "paged_decode_attention",
    "paged_decode_plain",
    "quantize_k",
    "quantize_v",
    "quantized_decode_attention",
    "reference_decode_attention",
]
