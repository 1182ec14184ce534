// One-token cosine-sim attention over the INT8 KV cache, for Hopper (sm_90a).
//
// Replaces both TPU decode kernels of
// flash_cosine_sim_attention_tpu/quant/decode_kernel.py: `_decode_kernel`
// and `_decode_kernel_packed`.  The packed one is the same maths on a
// 128-lane view that works around the TPU's int8 tiling; Hopper has no such
// tiling, so one kernel over the natural (b, kvh, cap, d) int8 layout
// serves both.  Per slot b, kv head, and each of its g query heads:
//     s = bf16(q_hat) . k8                       (K dequant 1/127 folded
//     e = exp(s * scale / 127 - scale)            into the logit scale)
//     l = sum(e)                                 (unscaled weights)
//     O = sum(bf16(e * v_scale[t]) * v8)         (V's per-token scale
//     out = O / max(l, 1e-10)                     folded into e)
// over the slot's live tokens t < length[b] only.  The bf16 roundings of q
// and of the scaled weights are the JAX kernel's own (it feeds bf16 to its
// matrix unit), so the two agree to the order of the f32 sums.  A slot of
// length 0 returns 0.
//
// Bound on the H100: bytes.  At full length a call streams the int8 K and
// V of every live token once (8.4 MB at b8 kvh8 cap1024 d64, ~2.5 us at
// 3.35 TB/s) and does ~2 FLOP per byte.  The kernel reads the lengths from
// the device (no host sync) and loops only over live tokens, so dead
// capacity costs nothing.  One 128-thread block per (slot, kv head): each
// thread scores one token of a 128-token tile (16-byte loads of its K row)
// and stages that token's V row in shared memory, so a tile's loads are in
// flight together; then the block accumulates the tile's P.V out of shared
// memory with threads split over the head dim.  At b8 kvh8 that is 64
// blocks on 132 SMs, so the card is under-filled: the later design splits each slot's tokens over several
// blocks and merges their partial (O, l) sums in a second pass (split-K,
// "flash-decoding"), which the no-row-max sums make a plain addition.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads = tokens per tile (ops/blocks.py DECODE_TILE)
constexpr int GMAX = 8;   // query heads per kv head (ops/blocks.py DECODE_MAX_GROUP)
constexpr float EPS = 1e-10f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
__global__ void __launch_bounds__(NT) decode_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
    const int8_t* __restrict__ v8, const float* __restrict__ v_scale,
    const int* __restrict__ length, float* __restrict__ out, int KVH, int G,
    int cap, float logit_scale, float scale) {
  constexpr int NPARTS = NT / D > 0 ? NT / D : 1;  // token lanes in P.V
  __shared__ float qs[GMAX][D];
  __shared__ float es[GMAX][NT];
  __shared__ float red[NPARTS][GMAX][D];
  __shared__ float lred[GMAX][NT / 32];
  __shared__ __align__(16) int8_t vt[NT][D];  // the tile's V rows

  const int kvhi = blockIdx.x, bi = blockIdx.y;
  const size_t bh = size_t(bi) * KVH + kvhi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(length[bi], 0), cap);

  for (int idx = tid; idx < G * D; idx += NT)
    qs[idx / D][idx % D] = __bfloat162float(q[bh * G * D + idx]);

  const int8_t* kb = k8 + bh * cap * D;
  const int8_t* vb = v8 + bh * cap * D;
  const float* vsb = v_scale + bh * cap;
  const int dcol = tid % D, part = tid / D;
  const bool pv_lane = tid < NPARTS * D;

  float acc[GMAX], lpart[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) acc[gi] = lpart[gi] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += NT) {
    const int t = t0 + tid;
    if (t < len) {
      // all of the token's loads first, so a tile's K and V rows are in
      // flight together; its V row is staged for P.V in shared memory
      const uint4* kr = reinterpret_cast<const uint4*>(kb + size_t(t) * D);
      const uint4* vr = reinterpret_cast<const uint4*>(vb + size_t(t) * D);
      uint4 ku[D / 16], vu[D / 16];
#pragma unroll
      for (int w = 0; w < D / 16; ++w) {
        ku[w] = kr[w];
        vu[w] = vr[w];
      }
      const float vsc = vsb[t];
      uint4* vdst = reinterpret_cast<uint4*>(&vt[tid][0]);
#pragma unroll
      for (int w = 0; w < D / 16; ++w) vdst[w] = vu[w];
      float s[GMAX];
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) s[gi] = 0.f;
#pragma unroll
      for (int w = 0; w < D / 16; ++w) {
        const int8_t* kv = reinterpret_cast<const int8_t*>(&ku[w]);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = float(kv[e]);
#pragma unroll
          for (int gi = 0; gi < GMAX; ++gi)
            if (gi < G) s[gi] = fmaf(qs[gi][w * 16 + e], kf, s[gi]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        if (gi < G) {
          const float e = expf(s[gi] * logit_scale - scale);
          lpart[gi] += e;
          es[gi][tid] = bf16_round(e * vsc);
        }
      }
    }
    __syncthreads();
    if (pv_lane) {
      const int tmax = min(NT, len - t0);
      for (int kk = part; kk < tmax; kk += NPARTS) {
        const float vv = float(vt[kk][dcol]);
#pragma unroll
        for (int gi = 0; gi < GMAX; ++gi)
          if (gi < G) acc[gi] = fmaf(es[gi][kk], vv, acc[gi]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < G) {
      float l = lpart[gi];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
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

template <int D>
cudaError_t launch(const void* q, const void* k8, const void* v8,
                   const void* v_scale, const void* length, void* out, int B,
                   int KVH, int G, int cap, float logit_scale, float scale,
                   cudaStream_t stream) {
  decode_kernel<D><<<dim3(KVH, B), NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(v_scale),
      static_cast<const int*>(length), static_cast<float*>(out), KVH, G, cap,
      logit_scale, scale);
  return cudaGetLastError();
}

}  // namespace

// Contiguous tensors: q (B, KVH, G, d) bf16, already l2-normalized;
// k8/v8 (B, KVH, cap, d) int8; v_scale (B, KVH, cap) f32; length (B,)
// int32 on the device; out (B, KVH, G, d) f32.  logit_scale is
// scale * (1/127).  Returns the cudaGetLastError() after the launch.
extern "C" int fcsa_decode(const void* q, const void* k8, const void* v8,
                           const void* v_scale, const void* length, void* out,
                           int B, int KVH, int G, int cap, int d,
                           float logit_scale, float scale, void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0 || G > GMAX || cap <= 0)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return int(launch<16>(q, k8, v8, v_scale, length, out, B, KVH, G, cap, logit_scale, scale, s));
    case 32: return int(launch<32>(q, k8, v8, v_scale, length, out, B, KVH, G, cap, logit_scale, scale, s));
    case 64: return int(launch<64>(q, k8, v8, v_scale, length, out, B, KVH, G, cap, logit_scale, scale, s));
    case 96: return int(launch<96>(q, k8, v8, v_scale, length, out, B, KVH, G, cap, logit_scale, scale, s));
    case 128: return int(launch<128>(q, k8, v8, v_scale, length, out, B, KVH, G, cap, logit_scale, scale, s));
    default: return int(cudaErrorInvalidValue);
  }
}
