"""Constants shared by the kernels and their plain versions.

The JAX package's block tables were tuned for the TPU v5e's 128x128
matrix unit and large VMEM; they do not carry over.  The decode kernels'
tiles below are read by their wrappers (``csrc/decode_common.cuh``,
shared by both decode kernels, holds the same numbers); the forward's
(64 query rows x 64 keys), the backward's and the int8-weight matmul's
tiles live in their ``csrc/*.cu`` sources alone.
"""

import torch

# head dims the reference supports (cu:84); the plain versions take any width
ALLOWED_DIM_HEADS = (16, 32, 64, 96, 128)

# the widths the CUDA kernels are built for: the reference's, and 192 and
# 256 (the widest head of the public model families, and the widest a
# FlashAttention-2 tile keeps whole in registers and shared memory)
KERNEL_WIDTHS = ALLOWED_DIM_HEADS + (192, 256)


# past the widest instance the attention kernels take a wide route: the
# head dim zero-padded to a multiple of WIDE_CHUNK, and the output columns
# (O, dQ, dK, dV) a grid axis of column blocks that each form S (and the
# backward's dP') again.  The kernels (bf16 K1, K2, K3b, K3a:
# `fwd_wide_mma_kernel`, `dkdv_wide_mma_kernel`, `dq_wide_mma_kernel`;
# f32 K1, K2, K3b, K3a and K1 on int8 codes with f32 v:
# `fwd_wide_tf32_kernel`, `dkdv_wide_tf32_kernel`, `dq_wide_tf32_kernel`)
# own 256 columns a block, so at d 384 or 1152 the last block owns a
# 128-column remainder, and stream Q, K, V and dO' in row chunks of 256
# bytes (128 bytes: 128 int8 codes a chunk in the f32 forward).  128
# rather than 256: d 264 pads to 384 instead of 512 (csrc/fwd_kernel.cu
# and csrc/bwd_kernel.cu take the same number)
WIDE_CHUNK = 128


def kernel_head_dim(d: int, kernel: str) -> int:
    """The head width the CUDA kernels run head dim ``d`` at: up to 256
    the next of KERNEL_WIDTHS at or above it, past 256 the next multiple
    of WIDE_CHUNK (the wide route).  Any multiple of 8 runs there exactly
    (the forward and backward wrappers pad zero lanes, which add 0 to
    every dot product and give 0 gradients; the decode kernels read d-byte
    rows in place).  Raises for any other d."""
    if d > 0 and d % 8 == 0:
        if d <= KERNEL_WIDTHS[-1]:
            return next(w for w in KERNEL_WIDTHS if w >= d)
        return -(-d // WIDE_CHUNK) * WIDE_CHUNK
    raise ValueError(
        f"the CUDA {kernel} kernel takes head dims that are positive "
        f"multiples of 8 (up to 256 at the next of {KERNEL_WIDTHS}, past "
        f"it at the next multiple of {WIDE_CHUNK}), got {d}")

EPS = 1e-10  # rowsum clamp, matches the reference kernel's eps (cu:83)

# the JAX dispatch's onepass_bwd_max_seq default (without the environment
# override): on the TPU it bounds the VMEM-resident q extent of the
# one-pass backward.  The Hopper K2 adds dQ into an f32 scratch with
# atomics and has no such limit; here the cap holds only where
# onepass_backward says
ONEPASS_BWD_MAX_SEQ = 8192


def onepass_backward(bias: bool, dtype, d: int, seq_q: int) -> bool:
    """Whether the CUDA backward of an input with (``bias``) or without a
    bias, of ``dtype``, head dim ``d`` and ``seq_q`` query rows takes the
    one-pass kernel K2 (else K3a, then K3b).  A bias always takes the two
    passes (only K3a forms dB).  bfloat16 up to d 256 (the tensor-core
    `dkdv_mma_kernel` instances) takes K2 at any length: it forms S and
    dP' once where K3a and K3b form both twice (8 products a visible
    pair against 4 + 6), and its dQ atomics cost less than the second
    pass: at b4 h8 s16384 causal on an H100, K2 ran 0.27-0.82 of K3a +
    K3b's time at every width from 16 to 256 (16.6 against 32.0 ms at d
    64).  float32, and bfloat16 past d 256 (the wide route), keep the
    two passes past ONEPASS_BWD_MAX_SEQ rows: their K2 is unmeasured at
    that length, and no main path of theirs but chip_smoke.py's float32
    long-context steps runs there."""
    if bias:
        return False
    if dtype == torch.bfloat16 and d <= KERNEL_WIDTHS[-1]:
        return True
    return seq_q <= ONEPASS_BWD_MAX_SEQ

# decode kernels (K4, csrc/decode_kernel.cu; K5, csrc/paged_decode_kernel.cu):
# split-K.  One 128-thread block per (split of a slot's tokens, 8 query
# heads of a kv head's group, slot x kv head; csrc/decode_common.cuh GMAX):
# a larger group (GQA past 8, MQA) takes one block per 8 of its heads, and
# a split is a whole number of DECODE_TILE tokens, streamed in stages of up
# to 128.  The paged kernel's tiles are PAGED_TILE tokens of a page, so
# page_size must be a multiple of PAGED_TILE (the JAX pool's 128-lane rule,
# kept so that the same configurations are valid in both packages)
DECODE_TILE = 128
PAGED_TILE = 128
# the most output columns a decode block serves (csrc/decode_common.cuh
# DCOLS): up to this head dim a block serves the whole row, its P.V sums
# in registers (at most two 4-column words a thread); past it the columns
# become a grid axis of decode_col_blocks(d) blocks of at most this many
# columns, each forming the scores over the whole d
DECODE_BLOCK_COLUMNS = 1024
# the blocks a decode call aims to launch on each SM of the card it runs
# on (132 on the H100), so that the splits that hold live tokens fill the
# card even when the slots are a quarter full (the lengths live on the
# device and are not read)
DECODE_BLOCKS_PER_SM = 8


def decode_col_blocks(d: int) -> int:
    """The column blocks of a decode kernel's row of ``d`` lanes: 1 up to
    DECODE_BLOCK_COLUMNS, else ceil(d / DECODE_BLOCK_COLUMNS)."""
    return -(-d // DECODE_BLOCK_COLUMNS) if d > DECODE_BLOCK_COLUMNS else 1


def decode_split(capacity: int, rows: int, sms: int):
    """(tokens a split, splits) of a decode call over ``capacity`` tokens a
    slot and ``rows`` = slots x kv heads x chunks of 8 query heads x column
    blocks, on a card of ``sms`` SMs: as many whole DECODE_TILE tiles a
    split as give about DECODE_BLOCKS_PER_SM blocks an SM, and one tile at
    least.  The host knows the capacity, not the lengths, so a call
    launches every split and the ones past a slot's length exit at once.
    On the H100's
    132 SMs: b8 kvh8 at 1024 tokens, 8 splits of 128; b8 kvh16 at 2048, 8
    of 256; b8 kvh2 at 1024, 8 of 128."""
    tiles = -(-capacity // DECODE_TILE)
    blocks = DECODE_BLOCKS_PER_SM * max(sms, 1)
    want = max(1, min(tiles, -(-blocks // max(rows, 1))))
    per = -(-tiles // want)
    return per * DECODE_TILE, -(-tiles // per)
