"""step_device_ms.train.short: ``step_device_ms.train`` read in the cells whose rate is
``train_tokens_per_s.short`` (sequences of 1024, host-bound)."""

from perfbench import core

_base = core.load_module("metrics", "step_device_ms.train")
UNIT, LAYER, read = _base.UNIT, _base.LAYER, _base.read
MOVES = "train_tokens_per_s.short"
