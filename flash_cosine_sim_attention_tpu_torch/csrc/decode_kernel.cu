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
// The kernel reads the lengths from the device (no host sync) and loads
// only live tokens, so dead capacity costs a block that exits at once.
//
// Design: split-K over the slot's tokens (decode_common.cuh), one launch
// a call.  A stage of TT tokens is TT * d contiguous bytes of K (and of
// V): the block copies it with 8-byte cp.async (any d a multiple of 8),
// consecutive threads on consecutive words, into rows padded to an odd
// multiple of 8 * (128 / TT) bytes, double-buffered.  Scores: 128 / TT
// threads a token, each reading every (128 / TT)-th 8-byte word of its
// row (the padding puts a half warp's words on 16 distinct bank pairs),
// summed by shuffles.  P.V: a thread owns 4 columns (one word of a V row)
// and a share of the stage's tokens; its accumulators stay in registers
// across stages, and the shares are summed once, at the end of the split.
//
// Past d 1024 (`decode_cols_kernel`, decode_common.cuh DCOLS) the output
// columns are a grid axis of ceil(d / 1024) column blocks, and nothing a
// block holds grows with d.  A stage is 32 tokens, 8 a warp (16 and 4
// above 2 query heads a block, so that the scores, queries and P.V sums
// stay in registers); the warp's lanes form their scores from 8-byte words
// of the K rows and 16-byte words of the bf16 queries read straight from
// global memory (each K row is read once a column block, the repeats from
// L2), summed by shuffles.  Then each thread adds P.V for up to two
// 4-column words of the block's columns, a V row's words read coalesced
// across the block and a stage's words all in flight at once.  The column
// blocks merge their splits apart, each with its own ticket counters.

#include <initializer_list>

#include "decode_common.cuh"

namespace {

using namespace decode_common;

// The block's dynamic shared memory: the stage ring (the P.V partials
// reuse its room at the end), the queries, a stage's weights, the row
// sums' partials and the merge flag, for a block of gm query heads.  Rows
// of a stage are `sb` bytes.
struct Layout {
  int tt, tpt, sb, np;
  size_t stage, qs, es, lred, flag, bytes;
  __host__ __device__ Layout(int d, int gm) {
    tt = stage_tokens(d);
    tpt = NT / tt;                      // threads a token in the scores
    int m = (d / 8 + tpt - 1) / tpt;    // 8-byte words a thread, made odd
    if (m % 2 == 0) ++m;
    sb = 8 * tpt * m;
    const int nw = d / 4;               // 4-column words of a row
    np = nw <= NT ? NT / nw : 1;        // P.V token shares
    stage = (2 * size_t(tt) * sb + sizeof(float) * tt + 15) / 16 * 16;
    const size_t red = sizeof(float) * size_t(np) * gm * d;
    qs = 2 * stage > red ? 2 * stage : red;
    es = qs + sizeof(float) * gm * d;
    lred = es + sizeof(float) * gm * tt;
    flag = lred + sizeof(float) * gm * (NT / 32);
    bytes = flag + 16;
  }
};

// T: int8_t (per-token V scales) or __nv_fp8_e4m3 (no scales); WIDE: d
// past 512, two P.V words a thread; GN: the query heads a block serves
// (decode_common.cuh heads_instance).  Grid (splits, head chunks, B * KVH).
template <typename T, bool WIDE, int GN>
__global__ void __launch_bounds__(NT) decode_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ v8, const float* __restrict__ v_scale,
    const int* __restrict__ length, float* __restrict__ out, Merge m,
    int KVH, int G, int cap, int d, int tps, float logit_scale, float scale) {
  constexpr int NCW = WIDE ? 2 : 1;
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  const size_t bh = blockIdx.z;
  const Split sp(length[bh / KVH], cap, tps);
  if (!sp.live()) return;
  const Layout L(d, GN);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* es = reinterpret_cast<float*>(smem + L.es);
  float* lred = reinterpret_cast<float*>(smem + L.lred);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  const int g0 = blockIdx.y * GN, gn = min(GN, G - g0);
  const int tid = threadIdx.x, tt = L.tt, tpt = L.tpt, sb = L.sb;
  load_queries(q, bh, G, g0, gn, d, qs);
  const uint8_t* kb = k8 + bh * cap * d;
  const uint8_t* vb = v8 + bh * cap * d;
  const float* vsb = v_scale + bh * cap;
  const int dw8 = d / 8, nw = d / 4;
  const int nst = (sp.t1 - sp.t0 + tt - 1) / tt;

  // stage i's tokens (zeros past the split's live end) into ring buffer i & 1
  auto load = [&](int i) {
    unsigned char* st = ring + (i & 1) * L.stage;
    const int s0 = sp.t0 + i * tt;
    for (int idx = tid; idx < tt * dw8; idx += NT) {
      const int r = idx / dw8, w = idx - r * dw8;
      const bool in = s0 + r < sp.t1;
      const size_t off = size_t(s0 + r) * d + 8 * w;
      cp_async8(st + r * sb + 8 * w, in ? kb + off : kb, in ? 8 : 0);
      cp_async8(st + (tt + r) * sb + 8 * w, in ? vb + off : vb, in ? 8 : 0);
    }
    if (kScaled) {
      float* vsc = reinterpret_cast<float*>(st + 2 * tt * sb);
      for (int r = tid; r < tt; r += NT) {
        const bool in = s0 + r < sp.t1;
        cp_async4(vsc + r, in ? vsb + s0 + r : vsb, in ? 4 : 0);
      }
    }
  };

  // score roles: token tl of the stage, word share p; P.V roles: word w0
  // (and w0 + NT), token share part
  const int tl = tid / tpt, p = tid % tpt;
  const int w0 = nw <= NT ? tid % nw : tid;
  const int part = nw <= NT ? tid / nw : 0;
  const bool pv = part < L.np;
  float lpart[GN], acc[NCW][4][GN];
#pragma unroll
  for (int gi = 0; gi < GN; ++gi) {
    lpart[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < NCW; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[j][x][gi] = 0.f;
  }

  if (nst > 0) load(0);
  cp_async_commit();
  for (int i = 0; i < nst; ++i) {
    if (i + 1 < nst) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage i (and, at i 0, the queries) has landed
    const unsigned char* kst = ring + (i & 1) * L.stage;
    const unsigned char* vst = kst + tt * sb;
    const float* vsc = reinterpret_cast<const float*>(kst + 2 * tt * sb);
    const int n = min(tt, sp.t1 - (sp.t0 + i * tt));  // live tokens

    // scores: 8 codes at a time against 8 query lanes (two float4 loads a
    // head, the same addresses for every token of a share)
    float s[GN];
#pragma unroll
    for (int gi = 0; gi < GN; ++gi) s[gi] = 0.f;
    const unsigned char* kr = kst + tl * sb;
#pragma unroll 2
    for (int w = p; w < dw8; w += tpt) {
      const uint2 u = *reinterpret_cast<const uint2*>(kr + 8 * w);
      float kf[8];
      decode4<T>(u.x, *reinterpret_cast<float(*)[4]>(kf));
      decode4<T>(u.y, *reinterpret_cast<float(*)[4]>(kf + 4));
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        if (gi >= gn) continue;
        const float4* qw = reinterpret_cast<const float4*>(qs + gi * d + 8 * w);
        const float4 a = qw[0], b = qw[1];
        s[gi] = fmaf(a.x, kf[0], fmaf(a.y, kf[1], fmaf(a.z, kf[2], fmaf(
            a.w, kf[3], fmaf(b.x, kf[4], fmaf(b.y, kf[5], fmaf(
                b.z, kf[6], fmaf(b.w, kf[7], s[gi]))))))));
      }
    }
    for (int off = tpt / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int gi = 0; gi < GN; ++gi)
        if (gi < gn) s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], off);
    }
    if (p == 0) {
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        if (gi >= gn) continue;
        float ev = 0.f;
        if (tl < n) {
          const float e = token_weight(s[gi], logit_scale, scale);
          lpart[gi] += e;
          ev = bf16_round(kScaled ? e * vsc[tl] : e);
        }
        es[gi * tt + tl] = ev;
      }
    }
    __syncthreads();

    if (pv) {
#pragma unroll 4
      for (int t = part; t < n; t += L.np) {
        const unsigned char* vr = vst + t * sb;
        float ev[GN];
#pragma unroll
        for (int gi = 0; gi < GN; ++gi) ev[gi] = gi < gn ? es[gi * tt + t] : 0.f;
#pragma unroll
        for (int j = 0; j < NCW; ++j) {
          const int w = w0 + j * NT;
          if (j > 0 && w >= nw) continue;
          float vv[4];
          decode4<T>(*reinterpret_cast<const uint32_t*>(vr + 4 * w), vv);
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int gi = 0; gi < GN; ++gi)
              acc[j][x][gi] = fmaf(ev[gi], vv[x], acc[j][x][gi]);
        }
      }
    }
    __syncthreads();  // the next stage's loads may overwrite this buffer
  }
  cp_async_wait<0>();

  if (pv) {
#pragma unroll
    for (int j = 0; j < NCW; ++j) {
      const int w = w0 + j * NT;
      if (j > 0 && w >= nw) continue;
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        if (gi >= gn) continue;
#pragma unroll
        for (int x = 0; x < 4; ++x)
          red[(part * GN + gi) * d + 4 * w + x] = acc[j][x][gi];
      }
    }
  }
  reduce_lsum<GN>(lpart, gn, lred);
  finish_split(red, L.np, GN, lred, gn, Cols{d, d, 0, 0}, sp, bh * G + g0,
               out, m, flag);
}

// d past DCOLS: grid (splits, head chunks, B * KVH * ncb), column block
// blockIdx.z % ncb.  q must be 16-byte aligned (rows of 2d bytes).
template <typename T, int GN>
__global__ void __launch_bounds__(NT) decode_cols_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ v8, const float* __restrict__ v_scale,
    const int* __restrict__ length, float* __restrict__ out, Merge m,
    int KVH, int G, int cap, int d, int tps, float logit_scale, float scale) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  // tokens a warp and a stage: 8 and 32 for up to 2 query heads, 4 and 16
  // above (a thread's scores, queries and P.V sums stay within registers)
  constexpr int CTW = GN > 2 ? 4 : 8, CTT = CTW * (NT / 32);
  __shared__ float es[GN * CTT];        // a stage's weights
  __shared__ float red[GN * DCOLS];     // the block's P.V sums
  __shared__ float lred[GN * (NT / 32)];
  __shared__ int flag;
  const size_t bh = blockIdx.z / m.ncb;
  const Split sp(length[bh / KVH], cap, tps);
  if (!sp.live()) return;
  const Cols cl = column_block(d, m.ncb, blockIdx.z % m.ncb);
  const int g0 = blockIdx.y * GN, gn = min(GN, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* qb = q + (bh * G + g0) * d;
  const uint8_t* kb = k8 + bh * cap * d;
  const uint8_t* vb = v8 + bh * cap * d + cl.c0;
  const float* vsb = v_scale + bh * cap;
  const int dw8 = d / 8, ncw = cl.n / 4;  // K row words; the block's V words

  float lpart[GN], acc[2][4][GN];
#pragma unroll
  for (int gi = 0; gi < GN; ++gi) {
    lpart[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[j][x][gi] = 0.f;
  }

  for (int s0 = sp.t0; s0 < sp.t1; s0 += CTT) {
    const int n = min(CTT, sp.t1 - s0);  // live tokens of the stage
    const int tb = warp * CTW;           // the warp's first token
    // scores: lane l takes 8-byte words l, l + 32, .. of the warp's rows
    float s[CTW][GN];
#pragma unroll
    for (int j = 0; j < CTW; ++j)
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) s[j][gi] = 0.f;
    // every load is unconditional (rows past the stage's live end read
    // its last live row, heads past gn the chunk's last head, and their
    // results go unused), so that a lane's loads are all in flight at once
#pragma unroll 2
    for (int w = lane; w < dw8; w += 32) {
      float qf[GN][8];
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            qb + size_t(min(gi, gn - 1)) * d + 8 * w));
        const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
          qf[gi][2 * i] = f.x;
          qf[gi][2 * i + 1] = f.y;
        }
      }
#pragma unroll
      for (int j = 0; j < CTW; ++j) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(
            kb + size_t(s0 + min(tb + j, n - 1)) * d + 8 * w));
        float kf[8];
        decode4<T>(u.x, *reinterpret_cast<float(*)[4]>(kf));
        decode4<T>(u.y, *reinterpret_cast<float(*)[4]>(kf + 4));
#pragma unroll
        for (int gi = 0; gi < GN; ++gi) {
          float a = s[j][gi];
#pragma unroll
          for (int i = 7; i >= 0; --i) a = fmaf(qf[gi][i], kf[i], a);
          s[j][gi] = a;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CTW; ++j)
#pragma unroll
      for (int gi = 0; gi < GN; ++gi)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s[j][gi] += __shfl_xor_sync(0xffffffffu, s[j][gi], off);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < CTW; ++j) {
        const int t = tb + j;
#pragma unroll
        for (int gi = 0; gi < GN; ++gi) {
          if (gi >= gn) continue;
          float ev = 0.f;
          if (t < n) {
            const float e = token_weight(s[j][gi], logit_scale, scale);
            lpart[gi] += e;
            ev = bf16_round(kScaled ? e * vsb[s0 + t] : e);
          }
          es[gi * CTT + t] = ev;
        }
      }
    }
    __syncthreads();  // the stage's weights are in es

    // P.V: words tid and tid + NT of the block's columns; the stage's V
    // words are all loaded before any is used, so their loads overlap
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int w = tid + j * NT;
      if (w >= ncw) continue;
      uint32_t vw[CTT];
#pragma unroll
      for (int t = 0; t < CTT; ++t)
        vw[t] = __ldg(reinterpret_cast<const uint32_t*>(
            vb + size_t(s0 + min(t, n - 1)) * d + 4 * w));
#pragma unroll
      for (int t = 0; t < CTT; ++t) {
        if (t >= n) break;
        float vv[4];
        decode4<T>(vw[t], vv);
#pragma unroll
        for (int gi = 0; gi < GN; ++gi) {
          const float ev = gi < gn ? es[gi * CTT + t] : 0.f;
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc[j][x][gi] = fmaf(ev, vv[x], acc[j][x][gi]);
        }
      }
    }
    __syncthreads();  // the next stage may overwrite es
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int w = tid + j * NT;
    if (w >= ncw) continue;
#pragma unroll
    for (int gi = 0; gi < GN; ++gi) {
      if (gi >= gn) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x) red[gi * cl.n + 4 * w + x] = acc[j][x][gi];
    }
  }
  reduce_lsum<GN>(lpart, gn, lred);
  finish_split(red, 1, GN, lred, gn, cl, sp, bh * G + g0, out, m, &flag);
}

}  // namespace

// Contiguous tensors: q (B, KVH, G, d) bf16, already l2-normalized, any
// group G, 16-byte aligned past d 1024; k8/v8 (B, KVH, cap, d) int8 (fp8 =
// 0) or e4m3 (fp8 = 1), 8-byte aligned, d any multiple of 8; v_scale (B,
// KVH, cap) f32, read for int8 only; length (B,) int32 on the device; out
// (B, KVH, G, d) f32.  The split-K workspace: ws_o (nsplit, B, KVH, G, d)
// and ws_l (nsplit, B, KVH, G, ncb) f32, tickets (B * KVH * ceil(G / 8) *
// ncb) int32, zero between calls, where ncb = ceil(d / 1024) past d 1024
// and 1 up to it; tps tokens a split (a multiple of 128), nsplit * tps
// covering cap.  logit_scale is scale * kdq (1/127 for int8, 1 for e4m3).
// Returns the cudaGetLastError() after the launch.
extern "C" int fcsa_decode(const void* q, const void* k8, const void* v8,
                           const void* v_scale, const void* length, void* out,
                           void* ws_o, void* ws_l, void* tickets, int B,
                           int KVH, int G, int cap, int d, int fp8, int tps,
                           int nsplit, float logit_scale, float scale,
                           void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0 || cap <= 0 || tps <= 0 || tps % NT ||
      nsplit <= 0 || size_t(nsplit) * tps < size_t(cap) ||
      size_t(nsplit - 1) * tps >= size_t(cap))
    return int(cudaErrorInvalidValue);
  for (const void* p : {k8, v8})
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return int(cudaErrorMisalignedAddress);
  if (d > DCOLS && reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const int gm = heads_instance(G), ncb = col_blocks(d);
  const dim3 grid(nsplit, (G + gm - 1) / gm, B * KVH * ncb);
  const Merge m{static_cast<float*>(ws_o), static_cast<float*>(ws_l),
                static_cast<int*>(tickets), size_t(B) * KVH * G, ncb};
  return int(dispatch(fp8, d, 512, G, [&](auto code, auto width, auto heads) {
    using T = decltype(code);
    constexpr int W = decltype(width)::value;
    constexpr int GN = decltype(heads)::value;
    const auto qp = static_cast<const __nv_bfloat16*>(q);
    const auto kp = static_cast<const uint8_t*>(k8);
    const auto vp = static_cast<const uint8_t*>(v8);
    const auto sp = static_cast<const float*>(v_scale);
    const auto lp = static_cast<const int*>(length);
    const auto op = static_cast<float*>(out);
    if constexpr (W == COLUMNS) {
      decode_cols_kernel<T, GN><<<grid, NT, 0, s>>>(
          qp, kp, vp, sp, lp, op, m, KVH, G, cap, d, tps, logit_scale, scale);
    } else {
      auto kernel = decode_kernel<T, W == WIDE_ROW, GN>;
      const size_t smem = Layout(d, GN).bytes;
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (err != cudaSuccess) return err;
      kernel<<<grid, NT, smem, s>>>(qp, kp, vp, sp, lp, op, m, KVH, G, cap, d,
                                    tps, logit_scale, scale);
    }
    return cudaGetLastError();
  }));
}
