from .benchmark import (
    benchmark,
    naive_cosine_sim_attention,
    xla_naive_cosine_sim_attention,
)
from .checkpoint import restore_checkpoint, save_checkpoint
from .debug import checkify_attention, debug_attention
from .profiling import StepTimer, trace

__all__ = [
    "benchmark",
    "checkify_attention",
    "debug_attention",
    "naive_cosine_sim_attention",
    "xla_naive_cosine_sim_attention",
    "restore_checkpoint",
    "save_checkpoint",
    "StepTimer",
    "trace",
]
