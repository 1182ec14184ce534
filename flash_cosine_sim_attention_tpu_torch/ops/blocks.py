"""Constants shared by the kernels and their plain versions.

The JAX package's block tables were tuned for the TPU v5e's 128x128
matrix unit and large VMEM; they do not carry over.  The Hopper kernels
use the fixed tiles below (see ``csrc/fwd_kernel.cu`` and
``csrc/decode_kernel.cu``, which hold the same numbers).
"""

# head dims the reference supports (cu:84); the CUDA kernels are built for
# exactly these, the plain versions take any width
ALLOWED_DIM_HEADS = (16, 32, 64, 96, 128)

EPS = 1e-10  # rowsum clamp, matches the reference kernel's eps (cu:83)

# forward kernel: one 128-thread block per (batch, head, FWD_BLOCK_Q rows),
# looping over FWD_BLOCK_K-key tiles
FWD_BLOCK_Q = 64
FWD_BLOCK_K = 64

# decode kernel: one 128-thread block per (batch, kv head) streams the
# slot's live tokens DECODE_TILE at a time; at most DECODE_MAX_GROUP query
# heads share a kv head
DECODE_TILE = 128
DECODE_MAX_GROUP = 8
