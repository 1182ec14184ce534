"""The frozen counts against shapes worked by hand, and the MFU readers
on a hand-made window."""

import pytest

from perfbench import core, roofline

CFG = {"num_tokens": 256, "dim": 512, "depth": 8, "heads": 8, "dim_head": 64,
       "ff_mult": 4}


def test_causal_pairs():
    assert roofline.causal_pairs(4, 4) == 10          # 1 + 2 + 3 + 4
    assert roofline.causal_pairs(1, 7) == 7           # one decode query
    assert roofline.causal_pairs(2, 5) == 4 + 5


def test_attention_counts():
    # b 1, h 1, n 4, d 2: 10 pairs, 4 * 10 * 2 forward, 3.5 x with backward
    assert roofline.attention_fwd_ops(1, 1, 10, 2) == 80
    assert roofline.attention_train_ops(1, 1, 4, 2) == 280
    # q, k, v bf16 (16 B each), the row sums f32 (16 B): fwd 16*4 + 16,
    # bwd reads q k v o do (80) and the sums (16), writes dq dk dv (48)
    assert roofline.attention_train_bytes(1, 1, 1, 4, 2) == 80 + 144


def test_k4_and_k7_counts():
    # 10 live tokens, 2 kv heads, d 8: codes 16 B and a 4 B scale each
    assert roofline.k4_bytes(10, 2, 8) == 400
    assert roofline.k7_ops(3, 5, 7) == 210
    # int8 w 35 B, scales 20 B, x 3*7*2, y 3*5*2
    assert roofline.k7_bytes(3, 5, 7) == 35 + 20 + 42 + 30


def test_model_counts():
    # a layer: qkv 512 x 1536, out 512 x 512, ff 512 x 2048 and back
    per_layer = 512 * 1536 + 512 * 512 + 2 * 512 * 2048
    assert roofline.dense_params(CFG) == 8 * per_layer + 512 * 256
    n = 1024
    attn = 8 * 3.5 * 4 * 8 * (n * (n + 1) // 2) * 64
    assert roofline.train_step_flops(CFG, 1, n) == pytest.approx(
        6 * roofline.dense_params(CFG) * n + attn)
    assert roofline.decode_flops(CFG, 2, 30) == pytest.approx(
        2 * roofline.dense_params(CFG) * 2 + 8 * 4 * 8 * 30 * 64)
    assert roofline.prefill_flops(CFG, 3) == pytest.approx(
        2 * roofline.dense_params(CFG) * 3 + 8 * 4 * 8 * 6 * 64)


def test_bound_takes_the_longer():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_mfu_readers():
    ctx = core.Context(None, core.Spans(), (0.0, 2.0),
                       {"model_flops": 989e12, "prefill_flops": 0.0},
                       None, False)
    for name in ("mfu.train", "mfu.serve"):
        assert core.load_module("metrics", name).read(ctx) == pytest.approx(50)
