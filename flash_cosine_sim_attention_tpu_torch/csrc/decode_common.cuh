// Device helpers shared by the two one-token decode kernels for Hopper
// (sm_90a): decode_kernel.cu (contiguous cache) and paged_decode_kernel.cu
// (page pool).  Both keep the JAX decode kernels' maths and bf16 roundings,
// read int8 or e4m3 codes, and run one NT-thread block per (slot, kv head)
// over that head's G <= GMAX query heads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace decode_common {

constexpr int NT = 128;    // threads = tokens per tile (ops/blocks.py DECODE_TILE, PAGED_TILE)
constexpr int GMAX = 8;    // query heads per kv head (ops/blocks.py DECODE_MAX_GROUP)
constexpr float EPS = 1e-10f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// The block's G query rows of (slot, kv head) `bh`, bf16 -> f32 shared.
template <int D>
__device__ __forceinline__ void load_queries(const __nv_bfloat16* q, size_t bh,
                                             int G, float (&qs)[GMAX][D]) {
  for (int idx = threadIdx.x; idx < G * D; idx += NT)
    qs[idx / D][idx % D] = __bfloat162float(q[bh * G * D + idx]);
}

// The end of both kernels: sums each query head's unscaled weights lpart
// over the block and its P.V partials acc over the NPARTS token lanes,
// and writes out[bh] = O / max(l, EPS) in f32.  Thread (dcol, part) with
// pv_lane holds head dim dcol of lane part.
template <int D, int NPARTS>
__device__ __forceinline__ void store_rows(
    const float (&acc)[GMAX], const float (&lpart)[GMAX], bool pv_lane,
    int part, int dcol, int G, float (&red)[NPARTS][GMAX][D],
    float (&lred)[GMAX][NT / 32], float* __restrict__ out, size_t bh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < G) {
      float l = lpart[gi];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (lane == 0) lred[gi][warp] = l;
      if (pv_lane) red[part][gi][dcol] = acc[gi];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += NT) {
    const int gi = idx / D, dc = idx % D;
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int p = 0; p < NPARTS; ++p) a += red[p][gi][dc];
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) l += lred[gi][w];
    out[bh * G * D + idx] = a * (1.f / fmaxf(l, EPS));
  }
}

// Calls launch(T{}, std::integral_constant<int, D>{}) for the storage type
// (fp8: __nv_fp8_e4m3, else int8_t) and the head dim d, one of
// ops/blocks.py ALLOWED_DIM_HEADS; cudaErrorInvalidValue for any other d.
template <typename F>
cudaError_t dispatch(bool fp8, int d, F&& launch) {
  auto by_dim = [&](auto code) -> cudaError_t {
    switch (d) {
      case 16: return launch(code, std::integral_constant<int, 16>{});
      case 32: return launch(code, std::integral_constant<int, 32>{});
      case 64: return launch(code, std::integral_constant<int, 64>{});
      case 96: return launch(code, std::integral_constant<int, 96>{});
      case 128: return launch(code, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  return fp8 ? by_dim(__nv_fp8_e4m3{}) : by_dim(int8_t{});
}

}  // namespace decode_common
