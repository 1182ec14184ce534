// Device helpers shared by the two one-token decode kernels for Hopper
// (sm_90a): decode_kernel.cu (contiguous cache) and paged_decode_kernel.cu
// (page pool).  Both keep the JAX decode kernels' maths and bf16 roundings,
// read int8 or e4m3 codes, and run one NT-thread block per (slot, kv head,
// chunk of GMAX query heads): a kv head's group of G query heads, any G
// (GQA past 8, MQA), takes ceil(G / GMAX) blocks along grid z.  Each
// reads the slot's K and V bytes; the chunks of one (slot, kv head) run
// side by side, so the repeats come from L2, and with few kv heads (MQA)
// they are what fills the card.  Code rows are d bytes, any multiple of 8
// up to the instance's width D: the kernels read the cache in place and
// treat lanes d..D as zero.
//
// P.V splits the block's NT threads over the head dim: up to d 128 each
// thread holds one column of one of NPARTS = NT / D token lanes; above (the
// 192 and 256 instances) one lane of NCOL = D / NT columns a thread,
// columns tid and tid + NT (the second only where it is below d).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace decode_common {

constexpr int NT = 128;    // threads = tokens per tile (ops/blocks.py DECODE_TILE, PAGED_TILE)
constexpr int GMAX = 8;    // query heads per block
constexpr float EPS = 1e-10f;

template <int D>
struct PvLanes {
  static constexpr int NPARTS = D < NT ? NT / D : 1;  // token lanes
  static constexpr int W = D < NT ? D : NT;           // threads a lane
  static constexpr int NCOL = (D + NT - 1) / NT;      // columns a thread
};

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

// one storage byte -> its value (exact in float, and in bf16)
template <typename T>
__device__ __forceinline__ float code_value(uint8_t b);
template <>
__device__ __forceinline__ float code_value<int8_t>(uint8_t b) {
  return float(static_cast<int8_t>(b));
}
template <>
__device__ __forceinline__ float code_value<__nv_fp8_e4m3>(uint8_t b) {
  __nv_fp8_e4m3 x;
  x.__x = b;
  return static_cast<float>(x);
}

// The chunk's gn query rows (heads g0.. of the G that share (slot, kv
// head) `bh`; q is (B, KVH, G, d)), bf16 -> f32 shared, lanes past d as 0.
template <int D>
__device__ __forceinline__ void load_queries(const __nv_bfloat16* q, size_t bh,
                                             int G, int g0, int gn, int d,
                                             float (&qs)[GMAX][D]) {
  const __nv_bfloat16* qb = q + (bh * G + g0) * d;
  for (int idx = threadIdx.x; idx < GMAX * D; idx += NT) {
    const int gi = idx / D, dd = idx % D;
    qs[gi][dd] = gi < gn && dd < d ? __bfloat162float(qb[gi * d + dd]) : 0.f;
  }
}

// The end of both kernels: sums each query head's unscaled weights lpart
// over the block and its P.V partials acc over the NPARTS token lanes,
// and writes the chunk's gn rows of d lanes, O / max(l, EPS) in f32, from
// `out` on.  Thread (dcol, part) with pv_lane holds head dims dcol + j NT
// (those below d) of lane part.  `red` may share its room with the tiles'
// (the kernels' last barrier has passed).
template <int D, int NPARTS = PvLanes<D>::NPARTS, int NCOL = PvLanes<D>::NCOL>
__device__ __forceinline__ void store_rows(
    const float (&acc)[NCOL][GMAX], const float (&lpart)[GMAX], bool pv_lane,
    int part, int dcol, int gn, int d, float (&red)[NPARTS][GMAX][D],
    float (&lred)[GMAX][NT / 32], float* __restrict__ out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < gn) {
      float l = lpart[gi];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (lane == 0) lred[gi][warp] = l;
#pragma unroll
      for (int j = 0; j < NCOL; ++j)
        if (pv_lane && dcol + j * NT < d) red[part][gi][dcol + j * NT] = acc[j][gi];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < gn * d; idx += NT) {
    const int gi = idx / d, dc = idx % d;
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int p = 0; p < NPARTS; ++p) a += red[p][gi][dc];
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) l += lred[gi][w];
    out[idx] = a * (1.f / fmaxf(l, EPS));
  }
}

// Calls launch(T{}, std::integral_constant<int, D>{}) for the storage type
// (fp8: __nv_fp8_e4m3, else int8_t) and the instance width D, the first of
// ops/blocks.py KERNEL_WIDTHS at or above the row length d;
// cudaErrorInvalidValue unless d is a multiple of 8 up to 256.
template <typename F>
cudaError_t dispatch(bool fp8, int d, F&& launch) {
  if (d <= 0 || d > 256 || d % 8 != 0) return cudaErrorInvalidValue;
  auto by_dim = [&](auto code) -> cudaError_t {
    if (d <= 16) return launch(code, std::integral_constant<int, 16>{});
    if (d <= 32) return launch(code, std::integral_constant<int, 32>{});
    if (d <= 64) return launch(code, std::integral_constant<int, 64>{});
    if (d <= 96) return launch(code, std::integral_constant<int, 96>{});
    if (d <= 128) return launch(code, std::integral_constant<int, 128>{});
    if (d <= 192) return launch(code, std::integral_constant<int, 192>{});
    return launch(code, std::integral_constant<int, 256>{});
  };
  return fp8 ? by_dim(__nv_fp8_e4m3{}) : by_dim(int8_t{});
}

}  // namespace decode_common
