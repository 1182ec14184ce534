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
from .weights import (
    dense_apply,
    dequantize_dense_kernel,
    quantize_dense_kernel,
    quantized_matmul,
    quantized_matmul_plain,
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
    "dense_apply",
    "dequantize_dense_kernel",
    "dequantize_k",
    "dequantize_v",
    "gather_pages",
    "init_cache",
    "init_paged_cache",
    "paged_decode_attention",
    "paged_decode_plain",
    "quantize_dense_kernel",
    "quantize_k",
    "quantize_params",
    "quantize_v",
    "quantized_decode_attention",
    "quantized_matmul",
    "quantized_matmul_plain",
    "reference_decode_attention",
]


def __getattr__(name):
    # JAX exports quantize_params from its quant package.  The port's
    # rewrites the model's modules, so it lives with fuse_qkv_params in
    # models/decoding.py; it is looked up there on first use, as models
    # import this package.
    if name == "quantize_params":
        from ..models.decoding import quantize_params
        return quantize_params
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
