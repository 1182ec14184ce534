from .decode_kernel import (
    decode_attention_plain,
    quantized_decode_attention,
    reference_decode_attention,
)
from .kv_cache import (
    K_SCALE,
    QuantKVCache,
    append,
    dequantize_k,
    dequantize_v,
    init_cache,
    quantize_k,
    quantize_v,
)

__all__ = [
    "K_SCALE",
    "QuantKVCache",
    "append",
    "decode_attention_plain",
    "dequantize_k",
    "dequantize_v",
    "init_cache",
    "quantize_k",
    "quantize_v",
    "quantized_decode_attention",
    "reference_decode_attention",
]
