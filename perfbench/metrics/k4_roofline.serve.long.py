"""k4_roofline.serve.long: ``k4_roofline.serve`` read in the cell whose end-to-end rate is
``serve_tokens_per_busy_s`` (128 slots decoding long contexts)."""

from perfbench import core

_base = core.load_module("metrics", "k4_roofline.serve")
UNIT, LAYER, read = _base.UNIT, _base.LAYER, _base.read
MOVES = "serve_tokens_per_busy_s"
