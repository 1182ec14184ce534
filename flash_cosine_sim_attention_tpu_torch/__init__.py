"""PyTorch / CUDA port of the cosine-sim flash attention framework, for
NVIDIA Hopper (H100).

The JAX package ``flash_cosine_sim_attention_tpu`` beside it is the
reference; each module here has a namesake there.  This package holds the
serving path (the fused forward for prefill, decode over an int8 or e4m3
KV cache, and decode over a paged cache), the backward, the validation
transformer and its trainer, cached and paged decoding, and the
continuous-batching ``InferenceEngine`` and ``PagedInferenceEngine``;
``parallel/`` runs the model, its training step and ``InferenceEngine``
tensor-parallel over ``torch.distributed``, and ``utils/`` holds the
timing, debugging and profiling helpers.
Each kernel is hand-written CUDA under ``csrc/`` with a plain PyTorch
version beside it.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; CPU tensors take the plain
versions.  The kernels are built with ``nvcc`` at first use.
"""

from .ops import (
    debug,
    flash_cosine_sim_attention,
    grouped_l2norm,
    l2norm,
    l2norm_tensors,
    non_cosine_sim_attention,
    plain_cosine_sim_attention,
    streaming_cosine_sim_attention,
)
from .version import __version__

__all__ = [
    "__version__",
    "debug",
    "flash_cosine_sim_attention",
    "grouped_l2norm",
    "l2norm",
    "l2norm_tensors",
    "non_cosine_sim_attention",
    "plain_cosine_sim_attention",
    "streaming_cosine_sim_attention",
]
