from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    copy_to_model,
    gather,
    local_shard,
    make_mesh,
    reduce_from_model,
    scatter,
    sharding,
)
from .sharded_attention import (
    head_sharded_flash_attention,
    head_sharded_flash_attention_local,
    shard_kv,
)
from .sharded_decode import (
    cache_shardings,
    head_sharded_decode_attention,
    head_sharded_decode_attention_local,
    local_kv_heads,
    shard_cache,
)
from .train import (
    make_sharded_train_step,
    param_shardings,
    shard_opt_state,
    shard_params,
    unshard_opt_state,
    unshard_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "cache_shardings",
    "copy_to_model",
    "gather",
    "head_sharded_decode_attention",
    "head_sharded_decode_attention_local",
    "head_sharded_flash_attention",
    "head_sharded_flash_attention_local",
    "local_kv_heads",
    "local_shard",
    "make_mesh",
    "make_sharded_train_step",
    "param_shardings",
    "reduce_from_model",
    "scatter",
    "shard_cache",
    "shard_kv",
    "shard_opt_state",
    "shard_params",
    "sharding",
    "unshard_opt_state",
    "unshard_params",
]
