"""qmm_roofline.decode.long: ``qmm_roofline.decode`` read in the cell whose end-to-end rate is
``serve_tokens_per_busy_s`` (128 slots decoding long contexts)."""

from perfbench import core

_base = core.load_module("metrics", "qmm_roofline.decode")
UNIT, LAYER, read = _base.UNIT, _base.LAYER, _base.read
MOVES = "serve_tokens_per_busy_s"
