// One-token cosine-sim attention over the quantized KV cache, for Hopper
// (sm_90a).
//
// Replaces both TPU decode kernels of
// flash_cosine_sim_attention_tpu/quant/decode_kernel.py: `_decode_kernel`
// and `_decode_kernel_packed`.  The packed one is the same maths on a
// 128-lane view that works around the TPU's int8 tiling; Hopper has no such
// tiling, so one kernel over the natural (b, kvh, cap, d) layout serves
// both.  It is templated on the storage type: int8 (K at the fixed scale
// 127, V with a per-token scale) or e4m3 (`__nv_fp8_e4m3`, no scales; the
// JAX `has_vscale=False` arm).  Per slot b, kv head, and each of its g
// query heads:
//     s = bf16(q_hat) . k                        (K's dequant, 1/127 or 1,
//     e = exp(s * scale * kdq - scale)            folded into the logit scale)
//     l = sum(e)                                 (unscaled weights)
//     O = sum(bf16(e * v_scale[t]) * v)          (int8: V's per-token scale
//     out = O / max(l, 1e-10)                     folded into e; e4m3: bf16(e))
// over the slot's live tokens t < length[b] only.  int8 and e4m3 values are
// exact in bf16, and the bf16 roundings of q and of the weights are the JAX
// kernel's own (it feeds bf16 to its matrix unit), so the two agree to the
// order of the f32 sums.  A slot of length 0 returns 0.
//
// Bound on the H100: bytes.  At full length a call streams the K and V
// codes of every live token once (8.4 MB at b8 kvh8 cap1024 d64 in int8,
// ~2.5 us at 3.35 TB/s; e4m3 reads no scales) and does ~2 FLOP per byte.
// The kernel reads the lengths from
// the device (no host sync) and loops only over live tokens, so dead
// capacity costs nothing.  One 128-thread block per (slot, kv head): each
// thread scores one token of a 128-token tile (16-byte loads of its K row)
// and stages that token's V row in shared memory, so a tile's loads are in
// flight together; then the block accumulates the tile's P.V out of shared
// memory with threads split over the head dim.  At b8 kvh8 that is 64
// blocks on 132 SMs, so the card is under-filled: the later design splits each slot's tokens over several
// blocks and merges their partial (O, l) sums in a second pass (split-K,
// "flash-decoding"), which the no-row-max sums make a plain addition.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

// T: int8_t (per-token V scales) or __nv_fp8_e4m3 (no scales)
template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ v8, const float* __restrict__ v_scale,
    const int* __restrict__ length, float* __restrict__ out, int KVH, int G,
    int cap, float logit_scale, float scale) {
  constexpr int NPARTS = NT / D > 0 ? NT / D : 1;  // token lanes in P.V
  __shared__ float qs[GMAX][D];
  __shared__ float es[GMAX][NT];
  __shared__ float red[NPARTS][GMAX][D];
  __shared__ float lred[GMAX][NT / 32];
  __shared__ __align__(16) uint8_t vt[NT][D];  // the tile's V rows
  constexpr bool kScaled = std::is_same<T, int8_t>::value;

  const int kvhi = blockIdx.x, bi = blockIdx.y;
  const size_t bh = size_t(bi) * KVH + kvhi;
  const int tid = threadIdx.x;
  const int len = min(max(length[bi], 0), cap);
  load_queries<D>(q, bh, G, qs);

  const uint8_t* kb = k8 + bh * cap * D;
  const uint8_t* vb = v8 + bh * cap * D;
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
      const float vsc = kScaled ? vsb[t] : 1.f;
      uint4* vdst = reinterpret_cast<uint4*>(&vt[tid][0]);
#pragma unroll
      for (int w = 0; w < D / 16; ++w) vdst[w] = vu[w];
      float s[GMAX];
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) s[gi] = 0.f;
#pragma unroll
      for (int w = 0; w < D / 16; ++w) {
        const uint8_t* kv = reinterpret_cast<const uint8_t*>(&ku[w]);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = code_value<T>(kv[e]);
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
          es[gi][tid] = bf16_round(kScaled ? e * vsc : e);
        }
      }
    }
    __syncthreads();
    if (pv_lane) {
      const int tmax = min(NT, len - t0);
      for (int kk = part; kk < tmax; kk += NPARTS) {
        const float vv = code_value<T>(vt[kk][dcol]);
#pragma unroll
        for (int gi = 0; gi < GMAX; ++gi)
          if (gi < G) acc[gi] = fmaf(es[gi][kk], vv, acc[gi]);
      }
    }
    __syncthreads();
  }

  store_rows<D, NPARTS>(acc, lpart, pv_lane, part, dcol, G, red, lred, out, bh);
}

}  // namespace

// Contiguous tensors: q (B, KVH, G, d) bf16, already l2-normalized;
// k8/v8 (B, KVH, cap, d) int8 (fp8 = 0) or e4m3 (fp8 = 1); v_scale
// (B, KVH, cap) f32, read for int8 only; length (B,) int32 on the device;
// out (B, KVH, G, d) f32.  logit_scale is scale * kdq (1/127 for int8, 1
// for e4m3).  Returns the cudaGetLastError() after the launch.
extern "C" int fcsa_decode(const void* q, const void* k8, const void* v8,
                           const void* v_scale, const void* length, void* out,
                           int B, int KVH, int G, int cap, int d, int fp8,
                           float logit_scale, float scale, void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0 || G > GMAX || cap <= 0)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return int(dispatch(fp8, d, [&](auto code, auto dim) {
    decode_kernel<decltype(code), decltype(dim)::value>
        <<<dim3(KVH, B), NT, 0, s>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const uint8_t*>(k8), static_cast<const uint8_t*>(v8),
            static_cast<const float*>(v_scale),
            static_cast<const int*>(length), static_cast<float*>(out), KVH, G,
            cap, logit_scale, scale);
    return cudaGetLastError();
  }));
}
