"""Constants shared by the kernels and their plain versions.

The JAX package's block tables were tuned for the TPU v5e's 128x128
matrix unit and large VMEM; they do not carry over.  The decode kernels'
tiles below are read by their wrappers (``csrc/decode_common.cuh``,
shared by both decode kernels, holds the same numbers); the forward's
(64 query rows x 64 keys), the backward's and the int8-weight matmul's
tiles live in their ``csrc/*.cu`` sources alone.
"""

# head dims the reference supports (cu:84); the CUDA kernels are built for
# exactly these widths, the plain versions take any width
ALLOWED_DIM_HEADS = (16, 32, 64, 96, 128)


def kernel_head_dim(d: int, kernel: str) -> int:
    """The width of the CUDA kernel instance that runs head dim ``d``: the
    next of ALLOWED_DIM_HEADS at or above it.  Any multiple of 8 up to 128
    runs there exactly (the forward and backward wrappers pad zero lanes,
    which add 0 to every dot product and give 0 gradients; the decode
    kernels read d-byte rows in place).  Raises for any other d."""
    if 0 < d <= ALLOWED_DIM_HEADS[-1] and d % 8 == 0:
        return next(w for w in ALLOWED_DIM_HEADS if w >= d)
    raise ValueError(
        f"the CUDA {kernel} kernel takes head dims that are multiples of 8 "
        f"up to {ALLOWED_DIM_HEADS[-1]} (built for {ALLOWED_DIM_HEADS}, a "
        f"narrower one runs at the next of these), got {d}")

EPS = 1e-10  # rowsum clamp, matches the reference kernel's eps (cu:83)

# the one-pass backward (K2) takes every bias-free input with seq_q up to
# this; longer ones take the two-pass kernels, as in the JAX dispatch
# (its onepass_bwd_max_seq default, without the environment override).
# On the TPU the cap bounds the VMEM-resident q extent; the Hopper K2 adds
# dQ into an f32 scratch with atomics and has no such limit, so the cap
# only keeps the two dispatches alike.
ONEPASS_BWD_MAX_SEQ = 8192

# decode kernel: one 128-thread block per (batch, kv head, 8 query heads of
# its group; csrc/decode_common.cuh GMAX) streams the slot's live tokens
# DECODE_TILE at a time; a larger group (GQA past 8, MQA) takes one block
# per 8 of its heads
DECODE_TILE = 128

# paged decode kernel: one 128-thread block per (slot, kv head) walks the
# slot's pages PAGED_TILE tokens at a time, so a page holds whole tiles:
# page_size must be a multiple of PAGED_TILE (the JAX pool's 128-lane rule,
# kept so that the same configurations are valid in both packages).  A
# block serves 8 query heads, as in the decode kernel
PAGED_TILE = 128
