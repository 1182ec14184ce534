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
// The kernel reads the lengths from the device (no host sync) and loops
// only over live tokens, so dead capacity costs nothing.  One 128-thread
// block per (slot, kv head, chunk of 8 query heads): each thread scores
// one token of a 128-token tile (8-byte loads of its d-byte K row, so any
// d that is a multiple of 8 is read in place) and stages that token's V
// row in shared memory, so a tile's loads are in flight together; then the
// block accumulates the tile's P.V out of shared memory with threads split
// over the head dim.  At b8 kvh8 that is 64 blocks on 132 SMs, so the card
// is under-filled: the later design splits each slot's tokens over several
// blocks and merges their partial (O, l) sums in a second pass (split-K,
// "flash-decoding"), which the no-row-max sums make a plain addition.

#include <initializer_list>

#include "decode_common.cuh"

namespace {

using namespace decode_common;

// T: int8_t (per-token V scales) or __nv_fp8_e4m3 (no scales).  Grid
// (query-head chunks, KVH, B): a chunk's blocks sit side by side.
template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ v8, const float* __restrict__ v_scale,
    const int* __restrict__ length, float* __restrict__ out, int KVH, int G,
    int cap, int d, float logit_scale, float scale) {
  constexpr int NPARTS = NT / D > 0 ? NT / D : 1;  // token lanes in P.V
  constexpr int DW = D / 8;                        // 8-byte words of a row
  __shared__ float qs[GMAX][D];
  __shared__ float es[GMAX][NT];
  __shared__ float red[NPARTS][GMAX][D];
  __shared__ float lred[GMAX][NT / 32];
  __shared__ __align__(16) uint8_t vt[NT][D];  // the tile's V rows
  constexpr bool kScaled = std::is_same<T, int8_t>::value;

  const int g0 = blockIdx.x * GMAX, kvhi = blockIdx.y, bi = blockIdx.z;
  const int gn = min(GMAX, G - g0);
  const size_t bh = size_t(bi) * KVH + kvhi;
  const int tid = threadIdx.x;
  const int len = min(max(length[bi], 0), cap);
  const int dw = d / 8;  // the row's words; words dw..DW read as 0
  load_queries<D>(q, bh, G, g0, gn, d, qs);

  const uint8_t* kb = k8 + bh * cap * d;
  const uint8_t* vb = v8 + bh * cap * d;
  const float* vsb = v_scale + bh * cap;
  const int dcol = tid % D, part = tid / D;
  const bool pv_lane = tid < NPARTS * D && dcol < d;

  float acc[GMAX], lpart[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) acc[gi] = lpart[gi] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += NT) {
    const int t = t0 + tid;
    if (t < len) {
      // all of the token's loads first, so a tile's K and V rows are in
      // flight together; its V row is staged for P.V in shared memory
      const uint2* kr = reinterpret_cast<const uint2*>(kb + size_t(t) * d);
      const uint2* vr = reinterpret_cast<const uint2*>(vb + size_t(t) * d);
      uint2 ku[DW], vu[DW];
#pragma unroll
      for (int w = 0; w < DW; ++w) {
        ku[w] = w < dw ? kr[w] : make_uint2(0, 0);
        vu[w] = w < dw ? vr[w] : make_uint2(0, 0);
      }
      const float vsc = kScaled ? vsb[t] : 1.f;
      uint2* vdst = reinterpret_cast<uint2*>(&vt[tid][0]);
#pragma unroll
      for (int w = 0; w < DW; ++w) vdst[w] = vu[w];
      float s[GMAX];
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) s[gi] = 0.f;
#pragma unroll
      for (int w = 0; w < DW; ++w) {
        const uint8_t* kv = reinterpret_cast<const uint8_t*>(&ku[w]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float kf = code_value<T>(kv[e]);
#pragma unroll
          for (int gi = 0; gi < GMAX; ++gi)
            if (gi < gn) s[gi] = fmaf(qs[gi][w * 8 + e], kf, s[gi]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        if (gi < gn) {
          const float e = token_weight(s[gi], logit_scale, scale);
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
          if (gi < gn) acc[gi] = fmaf(es[gi][kk], vv, acc[gi]);
      }
    }
    __syncthreads();
  }

  store_rows<D, NPARTS>(acc, lpart, pv_lane, part, dcol, gn, d, red, lred,
                        out + (bh * G + g0) * d);
}

}  // namespace

// Contiguous tensors: q (B, KVH, G, d) bf16, already l2-normalized, any
// group G; k8/v8 (B, KVH, cap, d) int8 (fp8 = 0) or e4m3 (fp8 = 1), 8-byte
// aligned, d a multiple of 8 up to 128; v_scale (B, KVH, cap) f32, read
// for int8 only; length (B,) int32 on the device; out (B, KVH, G, d) f32.
// logit_scale is scale * kdq (1/127 for int8, 1 for e4m3).  Returns the
// cudaGetLastError() after the launch.
extern "C" int fcsa_decode(const void* q, const void* k8, const void* v8,
                           const void* v_scale, const void* length, void* out,
                           int B, int KVH, int G, int cap, int d, int fp8,
                           float logit_scale, float scale, void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0 || cap <= 0)
    return int(cudaErrorInvalidValue);
  for (const void* p : {k8, v8})
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return int(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((G + GMAX - 1) / GMAX, KVH, B);
  return int(dispatch(fp8, d, [&](auto code, auto dim) {
    decode_kernel<decltype(code), decltype(dim)::value><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k8),
        static_cast<const uint8_t*>(v8), static_cast<const float*>(v_scale),
        static_cast<const int*>(length), static_cast<float*>(out), KVH, G,
        cap, d, logit_scale, scale);
    return cudaGetLastError();
  }));
}
