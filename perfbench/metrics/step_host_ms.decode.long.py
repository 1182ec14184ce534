"""step_host_ms.decode.long: ``step_host_ms.decode`` read in the cell whose end-to-end rate is
``serve_tokens_per_busy_s`` (128 slots decoding long contexts)."""

from perfbench import core

_base = core.load_module("metrics", "step_host_ms.decode")
UNIT, LAYER, read = _base.UNIT, _base.LAYER, _base.read
MOVES = "serve_tokens_per_busy_s"
