"""Constants shared by the kernels and their plain versions.

The JAX package's block tables were tuned for the TPU v5e's 128x128
matrix unit and large VMEM; they do not carry over.  The decode kernels'
tiles below are read by their wrappers (``csrc/decode_common.cuh``,
shared by both decode kernels, holds the same numbers); the forward's
(64 query rows x 64 keys), the backward's and the int8-weight matmul's
tiles live in their ``csrc/*.cu`` sources alone.
"""

# head dims the reference supports (cu:84); the CUDA kernels are built for
# exactly these, the plain versions take any width
ALLOWED_DIM_HEADS = (16, 32, 64, 96, 128)

EPS = 1e-10  # rowsum clamp, matches the reference kernel's eps (cu:83)

# the one-pass backward (K2) takes every bias-free input with seq_q up to
# this; longer ones take the two-pass kernels, as in the JAX dispatch
# (its onepass_bwd_max_seq default, without the environment override).
# On the TPU the cap bounds the VMEM-resident q extent; the Hopper K2 adds
# dQ into an f32 scratch with atomics and has no such limit, so the cap
# only keeps the two dispatches alike.
ONEPASS_BWD_MAX_SEQ = 8192

# decode kernel: one 128-thread block per (batch, kv head) streams the
# slot's live tokens DECODE_TILE at a time; at most DECODE_MAX_GROUP query
# heads share a kv head
DECODE_TILE = 128
DECODE_MAX_GROUP = 8

# paged decode kernel: one 128-thread block per (slot, kv head) walks the
# slot's pages PAGED_TILE tokens at a time, so a page holds whole tiles:
# page_size must be a multiple of PAGED_TILE (the JAX pool's 128-lane rule,
# kept so that the same configurations are valid in both packages).  At
# most DECODE_MAX_GROUP query heads share a kv head, as in the decode kernel
PAGED_TILE = 128
