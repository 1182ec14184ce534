// Device helpers shared by the two one-token decode kernels for Hopper
// (sm_90a): decode_kernel.cu (contiguous cache) and paged_decode_kernel.cu
// (page pool).  Both keep the JAX decode kernels' maths and bf16 roundings,
// read int8 or e4m3 codes, take any head dim that is a multiple of 8, and
// are split-K ("flash-decoding") kernels:
//
// - Grid (splits, chunks of GMAX query heads, slot x kv head x column
//   blocks).  A kv head's group of G query heads, any G (GQA past 8, MQA),
//   takes ceil(G / GMAX) chunks; a slot's token capacity is cut into splits
//   of `tps` tokens, a whole number of 128-token tiles (ops/blocks.py
//   decode_split sets it from the capacity the host knows, never from the
//   lengths, which live on the device: the engines never read them).
// - A block reads its slot's length, and a split that starts at or past
//   it exits at once; the live splits are nlive = max(1, ceil(len / tps)).
// - Up to DCOLS (1024) columns a block serves the whole row: it streams
//   its tokens in stages of TT tokens through a double-buffered cp.async
//   ring (TT = 128 up to d 64, fewer above, so a stage's K or V stays
//   within 8 KB), forms the unscaled weights e, their sum l and O =
//   sum(bf16(e v_scale) v) for its tokens, its P.V sums in registers (at
//   most two 4-column words, or 8 V rows, a thread) and the chunk's f32
//   queries and a stage's rows in shared memory: both grow with d.
// - Past DCOLS the output columns are a grid axis of ncb = ceil(d / DCOLS)
//   column blocks of at most DCOLS columns (`*_cols_kernel`), so that
//   registers and shared memory no longer grow with d.  Each column block
//   forms the scores over the whole d, reading K and the queries straight
//   from global memory (L1 and L2 serve the ncb - 1 repeats) with no
//   staging, and adds P.V for its own columns only.
// - There is no row max, so partial results merge by plain sums: with one
//   live split the block writes out = O / max(l, EPS) itself; otherwise it
//   writes (O, l) to an f32 workspace, and the last block of its (slot, kv
//   head, chunk, column block) to finish (a ticket from an int32 counter
//   of its own, taken after a __threadfence) sums the live splits in split
//   order, writes out and resets the counter for the next call.  One
//   launch a call, and the same sum order whichever block finishes last.
//
// The splits of a call run on ~8 blocks an SM (ops/blocks.py
// DECODE_BLOCKS_PER_SM): one block per (slot, kv head, head chunk) over all its
// tokens would be 16 to 64 blocks on 132 SMs, and such a block's walk is
// latency-bound (each thread's score and P.V are dependent chains of d
// and 128 * ceil(d / 128) FMAs a tile, with one warp a scheduler).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace decode_common {

constexpr int NT = 128;    // threads; tokens per tile (ops/blocks.py DECODE_TILE, PAGED_TILE)
constexpr int GMAX = 8;    // query heads per block
// output columns a block serves (ops/blocks.py DECODE_BLOCK_COLUMNS): the
// whole row up to this head dim, past it a column block
constexpr int DCOLS = 1024;
constexpr float EPS = 1e-10f;

// Tokens a stage holds: 128 up to d 64, then halved so that a stage's K
// or V codes stay within 8 KB (64 at d 72-128, 32 up to 256, 16 past);
// always a power of two dividing 128
__host__ __device__ constexpr int stage_tokens(int d) {
  int tt = NT;
  while (tt > 16 && tt * d > 8192) tt /= 2;
  return tt;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A token's weight exp(s * logit_scale - scale) with the product and the
// difference each rounded (no fused multiply-add), as the plain version
// rounds them: the same score gives the same weight bit for bit, so the
// weight's bf16 rounding cannot fall the other way at a tie
__device__ __forceinline__ float token_weight(float s, float logit_scale,
                                              float scale) {
  return expf(__fsub_rn(__fmul_rn(s, logit_scale), scale));
}

// Four storage bytes (a little-endian word) -> their values, exact in
// float (and in bf16).  int8: each byte, its sign bit flipped, is placed
// under the exponent of 2^23 by one byte permute and 2^23 + 128 taken
// away, two full-rate instructions a byte where an integer-to-float
// conversion runs at a quarter of the rate.  e4m3: the hardware's
// two-at-a-time conversion to f16, then to f32 (NaN codes stay NaN).
template <typename T>
__device__ __forceinline__ void decode4(uint32_t word, float (&f)[4]);
template <>
__device__ __forceinline__ void decode4<int8_t>(uint32_t word, float (&f)[4]) {
  const uint32_t w = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + i)) -
           8388736.f;
}
template <>
__device__ __forceinline__ void decode4<__nv_fp8_e4m3>(uint32_t word,
                                                       float (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t h2;
    const unsigned short pair = static_cast<unsigned short>(word >> (16 * i));
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(pair));
    f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(h2)));
    f[2 * i + 1] =
        __half2float(__ushort_as_half(static_cast<unsigned short>(h2 >> 16)));
  }
}

// The chunk's gn query rows (heads g0.. of the G that share (slot, kv
// head) `bh`; q is (B, KVH, G, d)), bf16 -> f32 rows of d in `qs`.
__device__ __forceinline__ void load_queries(const __nv_bfloat16* q, size_t bh,
                                             int G, int g0, int gn, int d,
                                             float* qs) {
  const __nv_bfloat16* qb = q + (bh * G + g0) * d;
  for (int idx = threadIdx.x; idx < gn * d; idx += NT)
    qs[idx] = __bfloat162float(qb[idx]);
}

// Where a block's split lies and whether it has work: tokens [t0, t1) of
// its slot, nlive live splits.
struct Split {
  int len, t0, t1, nlive;
  __device__ Split(int length, int limit, int tps) {
    len = min(max(length, 0), limit);
    nlive = max(1, (len + tps - 1) / tps);
    t0 = blockIdx.x * tps;
    t1 = min(t0 + tps, len);
  }
  __device__ bool live() const { return int(blockIdx.x) < nlive; }
};

// The workspace of the split-K merge: partial O (nsplit, rows, d) and l
// (nsplit, rows, ncb) in f32, rows = B * KVH * G, and one int32 ticket
// counter per (slot, kv head, chunk, column block), zero between calls.
struct Merge {
  float* ws_o;
  float* ws_l;
  int* tickets;
  size_t rows;
  int ncb;  // column blocks a row: 1 up to DCOLS
};

// The output columns a block writes: n columns from c0 of rows ld floats
// long, column block cb of the row's Merge::ncb.  Up to DCOLS: {d, d, 0, 0}.
struct Cols {
  int n, ld, c0, cb;
};

// Column block cb of ncb over a row of d lanes: columns [c0, c0 + n),
// whole 4-column words, the blocks' widths within 4 of each other
__device__ __forceinline__ Cols column_block(int d, int ncb, int cb) {
  const int per = 4 * ((d / 4 + ncb - 1) / ncb);
  const int c0 = cb * per;
  return Cols{min(per, d - c0), d, c0, cb};
}

// The end of every decode kernel.  `red` holds np partial P.V sums,
// red[(p * gm + gi) * cl.n + c] for every part p < np, head gi < gn <= gm
// and column c < cl.n; lred[gi * (NT / 32) + w] warp w's row sums.  Writes
// the chunk's gn rows at columns cl.c0 + c, O / max(l, EPS) in f32, from
// `out` on (row index `row0` = bh * G + g0): directly with one live split,
// else through the workspace and the last block's merge.  `flag` is one
// int of shared memory.
__device__ __forceinline__ void finish_split(const float* red, int np, int gm,
                                             const float* lred, int gn,
                                             const Cols& cl, const Split& sp,
                                             size_t row0,
                                             float* __restrict__ out,
                                             const Merge& m, int* flag) {
  const int tid = threadIdx.x, n = cl.n;
  __syncthreads();  // red and lred are complete
  // entry idx = gi * n + c of the block: its offset from row row0's start
  auto at = [&](int idx) {
    return size_t(idx / n) * cl.ld + cl.c0 + idx % n;
  };
  auto o_sum = [&](int idx) {
    float a = 0.f;
    for (int p = 0; p < np; ++p) a += red[p * gm * n + idx];
    return a;
  };
  auto l_sum = [&](int gi) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) l += lred[gi * (NT / 32) + w];
    return l;
  };
  float* ob = out + row0 * cl.ld;
  if (sp.nlive == 1) {
    for (int idx = tid; idx < gn * n; idx += NT)
      ob[at(idx)] = o_sum(idx) * (1.f / fmaxf(l_sum(idx / n), EPS));
    return;
  }
  const size_t split = blockIdx.x;
  float* wo = m.ws_o + (split * m.rows + row0) * cl.ld;
  for (int idx = tid; idx < gn * n; idx += NT) wo[at(idx)] = o_sum(idx);
  if (tid < gn)
    m.ws_l[(split * m.rows + row0 + tid) * m.ncb + cl.cb] = l_sum(tid);
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  int* ticket = m.tickets + size_t(blockIdx.z) * gridDim.y + blockIdx.y;
  if (tid == 0) *flag = atomicAdd(ticket, 1) == sp.nlive - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the last block: every live split's partials, summed in split order
  for (int idx = tid; idx < gn * n; idx += NT) {
    const int gi = idx / n;
    const size_t o_at = at(idx);
    float a = 0.f, l = 0.f;
    for (int s = 0; s < sp.nlive; ++s) {
      a += __ldcg(m.ws_o + (size_t(s) * m.rows + row0) * cl.ld + o_at);
      l += __ldcg(m.ws_l + (size_t(s) * m.rows + row0 + gi) * m.ncb + cl.cb);
    }
    ob[o_at] = a * (1.f / fmaxf(l, EPS));
  }
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
                              // (each stream has its own counters)
}

// Sums each thread's row-sum partials lpart over its warp into lred.
template <int GN>
__device__ __forceinline__ void reduce_lsum(const float (&lpart)[GN], int gn,
                                            float* lred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int gi = 0; gi < GN; ++gi) {
    if (gi < gn) {
      float l = lpart[gi];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (lane == 0) lred[gi * (NT / 32) + warp] = l;
    }
  }
}

// The query heads a block serves, as compiled: the least of 1, 2, 4 and
// GMAX that holds min(G, GMAX), so that the MHA decode (g 1) runs no
// predicated-off work for the 7 heads it does not have
inline int heads_instance(int G) {
  const int g = G < GMAX ? G : GMAX;
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : GMAX;
}

// The width classes of a decode kernel: the whole row in registers, one
// word (or up to 2 V rows) a thread; two words (up to 8 V rows); past
// DCOLS, column blocks (the `*_cols_kernel`s)
enum Width { NARROW = 0, WIDE_ROW = 1, COLUMNS = 2 };

// The column blocks of a row of d lanes (ops/blocks.py decode_col_blocks)
inline int col_blocks(int d) { return d > DCOLS ? (d + DCOLS - 1) / DCOLS : 1; }

// Calls launch(T{}, std::integral_constant<int, W>{},
// std::integral_constant<int, GN>{}) for the storage type (fp8:
// __nv_fp8_e4m3, else int8_t), the width class W (WIDE_ROW: d past `narrow`,
// COLUMNS: past DCOLS) and the heads a block serves (heads_instance(G));
// cudaErrorInvalidValue unless d is a positive multiple of 8.
template <typename F>
cudaError_t dispatch(bool fp8, int d, int narrow, int G, F&& launch) {
  if (d <= 0 || d % 8 != 0 || G <= 0) return cudaErrorInvalidValue;
  auto by_heads = [&](auto code, auto width) -> cudaError_t {
    switch (heads_instance(G)) {
      case 1: return launch(code, width, std::integral_constant<int, 1>{});
      case 2: return launch(code, width, std::integral_constant<int, 2>{});
      case 4: return launch(code, width, std::integral_constant<int, 4>{});
      default: return launch(code, width, std::integral_constant<int, GMAX>{});
    }
  };
  auto by_width = [&](auto code) -> cudaError_t {
    if (d <= narrow) return by_heads(code, std::integral_constant<int, NARROW>{});
    if (d <= DCOLS) return by_heads(code, std::integral_constant<int, WIDE_ROW>{});
    return by_heads(code, std::integral_constant<int, COLUMNS>{});
  };
  return fp8 ? by_width(__nv_fp8_e4m3{}) : by_width(int8_t{});
}

}  // namespace decode_common
