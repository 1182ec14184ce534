// One-token cosine-sim attention over a paged quantized KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` of
// flash_cosine_sim_attention_tpu/quant/paged.py (line 183).  The pool keeps
// the JAX layout: K and V codes (num_pages, kvh, d, page_size), token-minor,
// int8 (K at the fixed scale 127, V with a per-token f32 scale in
// v_scale (num_pages, kvh, 1, page_size)) or e4m3 (no scales), addressed
// through page_table (slots, max_pages) int32.  Per slot b, kv head h, and
// each of its g query heads, over tokens t < min(length[b], max_pages *
// page_size), token t living at column t % ps of page page_table[b, t / ps]:
//     s = bf16(q_hat) . k[t]                     (K's dequant, 1/127 or 1,
//     e = exp(s * scale * kdq - scale)            folded into the logit scale)
//     l = sum(e)                                 (unscaled weights)
//     O = sum(bf16(e * v_scale[t]) * v[t])       (int8; e4m3: bf16(e) * v[t])
//     out = O / max(l, 1e-10)
// in f32.  These are the contiguous decode kernel's bf16 roundings, so on
// the same quantized bytes the paged and contiguous outputs differ only by
// the order of the f32 sums.  A slot of length 0 returns exactly 0.  The
// token loop stops at the end of the table, so a finished slot whose row
// points at the null page 0 with a stale length reads only page 0 (its
// output is discarded); a page id outside the pool is read as page 0.
//
// Bound on the H100: bytes.  A call streams the K and V codes (and, for
// int8, the f32 V scales) of every live token once: 8 slots x 8 kv heads x
// 1024 tokens x (2 x 64 + 4) B = 8.65 MB at d 64 in int8, ~2.6 us at
// 3.35 TB/s; the work is ~2 FLOP per byte.
//
// Design: split-K over the slot's pages (decode_common.cuh), one launch a
// call; a split is a whole number of 128-token tiles, and a page holds
// whole tiles (page_size a multiple of 128), so a stage of TT tokens never
// crosses a page.  A stage of one kv head is d rows of TT contiguous bytes
// of a page: the block copies them with 16-byte cp.async into rows of TT +
// 16 bytes, double-buffered.  Scores: a thread owns 4 tokens (one word of
// a row) and every (512 / TT)-th row, so a warp reads whole rows at once;
// its partial sums meet by shuffles across the warp's rows and through
// shared memory across the 4 warps.  P.V: a thread owns a row of V (one
// output column; above d 128 up to 8 of them) and reads it 16 tokens at a
// time, weighing 4 tokens at once; 8 lanes on 8 rows hit
// 8 distinct 16-byte bank groups (the row stride is an odd number of 16-
// byte units for TT >= 32).
//
// Past d 1024 (`paged_decode_cols_kernel`, decode_common.cuh DCOLS) the
// output columns are a grid axis of ceil(d / 1024) column blocks, and
// nothing a block holds grows with d: a stage is one 128-token tile, whose
// K rows the warps read straight from global memory (a warp one row of
// 128 contiguous bytes at a time, each lane 4 tokens; the query lane a
// broadcast), summed across the 4 warps through shared memory; then each
// thread adds P.V for up to 8 V rows of the block's columns, 16 tokens a
// load.  The column blocks merge their splits apart, each with its own
// ticket counters.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

// The block's dynamic shared memory: the stage ring (the P.V partials
// reuse its room at the end), the queries, a stage's weights, the score
// partials of the 4 warps, the row sums' partials and the merge flag, for
// a block of gm query heads.
struct Layout {
  int tt, rs, np;
  size_t stage, qs, es, spart, lred, flag, bytes;
  __host__ __device__ Layout(int d, int gm) {
    tt = stage_tokens(d);
    rs = tt + 16;                       // bytes a staged row
    np = d < NT ? NT / d : 1;           // P.V token shares
    stage = 2 * size_t(d) * rs + sizeof(float) * tt;  // K, V, V scales
    stage = (stage + 15) / 16 * 16;
    const size_t red = sizeof(float) * size_t(np) * gm * d;
    qs = 2 * stage > red ? 2 * stage : red;
    es = qs + sizeof(float) * gm * d;
    spart = es + sizeof(float) * gm * tt;
    lred = spart + sizeof(float) * (NT / 32) * gm * tt;
    flag = lred + sizeof(float) * gm * (NT / 32);
    bytes = flag + 16;
  }
};

// T: int8_t (per-token V scales) or __nv_fp8_e4m3 (no scales); WIDE: d
// past 256, up to 8 V rows a thread; GN: the query heads a block serves
// (decode_common.cuh heads_instance).  Grid (splits, head chunks, B * KVH).
template <typename T, bool WIDE, int GN>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ v8, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ length,
    float* __restrict__ out, Merge m, int KVH, int G, int d, int num_pages,
    int ps, int mp, int tps, float logit_scale, float scale) {
  constexpr int NR = WIDE ? DCOLS / NT : 256 / NT;  // V rows a thread
  constexpr int NRH = NR < 4 ? NR : GN > 4 ? 2 : 4;  // of them at a time
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  const size_t bh = blockIdx.z;
  const int bi = bh / KVH, kvhi = bh % KVH;
  const Split sp(length[bi], mp * ps, tps);
  if (!sp.live()) return;
  const Layout L(d, GN);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* es = reinterpret_cast<float*>(smem + L.es);
  float* spart = reinterpret_cast<float*>(smem + L.spart);
  float* lred = reinterpret_cast<float*>(smem + L.lred);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  const int g0 = blockIdx.y * GN, gn = min(GN, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tt = L.tt, rs = L.rs;
  const int* row = page_table + size_t(bi) * mp;
  load_queries(q, bh, G, g0, gn, d, qs);
  const int nst = (sp.t1 - sp.t0 + tt - 1) / tt;

  // stage i: d rows of tt bytes of one page (16-byte pieces wholly past
  // the split's live end as zeros) into ring buffer i & 1
  auto load = [&](int i) {
    unsigned char* st = ring + (i & 1) * L.stage;
    const int s0 = sp.t0 + i * tt;
    int pid = row[s0 / ps];
    if (pid < 0 || pid >= num_pages) pid = 0;
    const size_t page = (size_t(pid) * KVH + kvhi) * d;  // row 0 of (pid, h)
    const int off = s0 % ps, cpr = tt / 16;
    for (int idx = tid; idx < d * cpr; idx += NT) {
      const int c = idx / cpr, j = idx - c * cpr;
      const bool in = s0 + 16 * j < sp.t1;
      const size_t at = (page + c) * ps + off + 16 * j;
      cp_async16(st + c * rs + 16 * j, in ? k8 + at : k8, in ? 16 : 0);
      cp_async16(st + (d + c) * rs + 16 * j, in ? v8 + at : v8, in ? 16 : 0);
    }
    if (kScaled) {
      float* vsc = reinterpret_cast<float*>(st + 2 * d * rs);
      const float* src = v_scale + (size_t(pid) * KVH + kvhi) * ps + off;
      for (int r = tid; r < tt; r += NT) {
        const bool in = s0 + r < sp.t1;
        cp_async4(vsc + r, in ? src + r : v_scale, in ? 4 : 0);
      }
    }
  };

  // score roles: token word w (tokens 4w..4w + 3) of rows r, r + rw, ...
  // of the warp's share; P.V roles: V row dcol (+ NT j), token share part
  const int tw4 = tt / 4, rw = 32 / tw4;
  const int w = lane % tw4, r = lane / tw4;
  const int pw = d < NT ? d : NT;
  const int dcol = tid % pw, part = tid / pw;
  const bool pv = part < L.np;
  float lpart[GN], acc[NR][GN];
#pragma unroll
  for (int gi = 0; gi < GN; ++gi) {
    lpart[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j][gi] = 0.f;
  }

  if (nst > 0) load(0);
  cp_async_commit();
  for (int i = 0; i < nst; ++i) {
    if (i + 1 < nst) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage i (and, at i 0, the queries) has landed
    const unsigned char* kst = ring + (i & 1) * L.stage;
    const unsigned char* vst = kst + d * rs;
    const float* vsc = reinterpret_cast<const float*>(kst + 2 * d * rs);
    const int n = min(tt, sp.t1 - (sp.t0 + i * tt));  // live tokens

    float s[4][GN];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) s[x][gi] = 0.f;
#pragma unroll 2
    for (int c = warp * rw + r; c < d; c += (NT / 32) * rw) {
      float kf[4];
      decode4<T>(*reinterpret_cast<const uint32_t*>(kst + c * rs + 4 * w), kf);
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        if (gi >= gn) continue;
        const float qv = qs[gi * d + c];
#pragma unroll
        for (int x = 0; x < 4; ++x) s[x][gi] = fmaf(qv, kf[x], s[x][gi]);
      }
    }
    for (int off = tw4; off < 32; off <<= 1) {
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        if (gi >= gn) continue;
#pragma unroll
        for (int x = 0; x < 4; ++x)
          s[x][gi] += __shfl_xor_sync(0xffffffffu, s[x][gi], off);
      }
    }
    if (r == 0) {
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        if (gi >= gn) continue;
        *reinterpret_cast<float4*>(spart + (warp * GN + gi) * tt + 4 * w) =
            make_float4(s[0][gi], s[1][gi], s[2][gi], s[3][gi]);
      }
    }
    __syncthreads();
    if (tid < tt) {
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        if (gi >= gn) continue;
        float sc = 0.f;
#pragma unroll
        for (int wp = 0; wp < NT / 32; ++wp) sc += spart[(wp * GN + gi) * tt + tid];
        float ev = 0.f;
        if (tid < n) {
          const float e = token_weight(sc, logit_scale, scale);
          lpart[gi] += e;
          ev = bf16_round(kScaled ? e * vsc[tid] : e);
        }
        es[gi * tt + tid] = ev;
      }
    }
    __syncthreads();

    if (pv) {
      // 16 tokens of each of the thread's rows at a time, 4 of them
      // against their weights at once (tokens past the live count weigh 0)
      const int nch = (n + 15) / 16;
      for (int j = part; j < nch; j += L.np) {
#pragma unroll
        for (int j0 = 0; j0 < NR; j0 += NRH) {  // NRH rows' codes live at once
          uint4 u[NRH];
#pragma unroll
          for (int jr = 0; jr < NRH; ++jr) {
            const int c = dcol + (j0 + jr) * NT;
            u[jr] = c < d ? *reinterpret_cast<const uint4*>(vst + c * rs + 16 * j)
                          : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            if (16 * j + 4 * q4 >= n) break;
            float ev[4][GN];
#pragma unroll
            for (int gi = 0; gi < GN; ++gi) {
              const float4 e4 = gi < gn ? *reinterpret_cast<const float4*>(
                                              es + gi * tt + 16 * j + 4 * q4)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
              ev[0][gi] = e4.x;
              ev[1][gi] = e4.y;
              ev[2][gi] = e4.z;
              ev[3][gi] = e4.w;
            }
#pragma unroll
            for (int jr = 0; jr < NRH; ++jr) {
              const uint32_t word = q4 == 0 ? u[jr].x : q4 == 1 ? u[jr].y
                                  : q4 == 2 ? u[jr].z : u[jr].w;
              float vv[4];
              decode4<T>(word, vv);
#pragma unroll
              for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int gi = 0; gi < GN; ++gi)
                  acc[j0 + jr][gi] = fmaf(ev[x][gi], vv[x], acc[j0 + jr][gi]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next stage's loads may overwrite this buffer
  }
  cp_async_wait<0>();

  if (pv) {
#pragma unroll
    for (int jr = 0; jr < NR; ++jr) {
      const int c = dcol + jr * NT;
      if (c >= d) continue;
#pragma unroll
      for (int gi = 0; gi < GN; ++gi)
        if (gi < gn) red[(part * GN + gi) * d + c] = acc[jr][gi];
    }
  }
  reduce_lsum<GN>(lpart, gn, lred);
  finish_split(red, L.np, GN, lred, gn, Cols{d, d, 0, 0}, sp, bh * G + g0,
               out, m, flag);
}

// d past DCOLS: grid (splits, head chunks, B * KVH * ncb), column block
// blockIdx.z % ncb; stages of NT tokens, one tile of a page.
template <typename T, int GN>
__global__ void __launch_bounds__(NT) paged_decode_cols_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ v8, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ length,
    float* __restrict__ out, Merge m, int KVH, int G, int d, int num_pages,
    int ps, int mp, int tps, float logit_scale, float scale) {
  constexpr int NR = DCOLS / NT;        // V rows a thread
  constexpr int NRH = GN > 4 ? 2 : 4;   // of them at a time
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  static_assert(NT * (NT / 32) <= DCOLS, "score partials fit red's room");
  __shared__ __align__(16) float es[GN * NT];      // a stage's weights
  __shared__ __align__(16) float red[GN * DCOLS];  // score partials, then
                                                   // the P.V sums
  __shared__ float lred[GN * (NT / 32)];
  __shared__ int flag;
  const size_t bh = blockIdx.z / m.ncb;
  const int bi = bh / KVH, kvhi = bh % KVH;
  const Split sp(length[bi], mp * ps, tps);
  if (!sp.live()) return;
  const Cols cl = column_block(d, m.ncb, blockIdx.z % m.ncb);
  const int g0 = blockIdx.y * GN, gn = min(GN, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* qb = q + (bh * G + g0) * d;
  const int* row = page_table + size_t(bi) * mp;
  float* spart = red;                    // (NT / 32) x GN x NT

  float lpart[GN], acc[NR][GN];
#pragma unroll
  for (int gi = 0; gi < GN; ++gi) {
    lpart[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j][gi] = 0.f;
  }

  for (int s0 = sp.t0; s0 < sp.t1; s0 += NT) {
    const int n = min(NT, sp.t1 - s0);  // live tokens of the stage
    int pid = row[s0 / ps];
    if (pid < 0 || pid >= num_pages) pid = 0;
    const size_t page = (size_t(pid) * KVH + kvhi) * d;  // row 0 of (pid, h)
    const int off = s0 % ps;
    // scores: warp w takes rows w, w + 4, ..; lane l tokens 4l .. 4l + 3
    float s[4][GN];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) s[x][gi] = 0.f;
#pragma unroll 4
    for (int c = warp; c < d; c += NT / 32) {
      float kf[4];
      decode4<T>(__ldg(reinterpret_cast<const uint32_t*>(
                     k8 + (page + c) * ps + off + 4 * lane)),
                 kf);
#pragma unroll
      for (int gi = 0; gi < GN; ++gi) {
        if (gi >= gn) continue;
        const float qv = __bfloat162float(qb[size_t(gi) * d + c]);
#pragma unroll
        for (int x = 0; x < 4; ++x) s[x][gi] = fmaf(qv, kf[x], s[x][gi]);
      }
    }
#pragma unroll
    for (int gi = 0; gi < GN; ++gi) {
      if (gi >= gn) continue;
      *reinterpret_cast<float4*>(spart + (warp * GN + gi) * NT + 4 * lane) =
          make_float4(s[0][gi], s[1][gi], s[2][gi], s[3][gi]);
    }
    __syncthreads();
    const float* vsc = v_scale + (size_t(pid) * KVH + kvhi) * ps + off;
#pragma unroll
    for (int gi = 0; gi < GN; ++gi) {
      if (gi >= gn) continue;
      float sc = 0.f;
#pragma unroll
      for (int wp = 0; wp < NT / 32; ++wp) sc += spart[(wp * GN + gi) * NT + tid];
      float ev = 0.f;
      if (tid < n) {
        const float e = token_weight(sc, logit_scale, scale);
        lpart[gi] += e;
        ev = bf16_round(kScaled ? e * vsc[tid] : e);
      }
      es[gi * NT + tid] = ev;
    }
    __syncthreads();  // the weights are in es, spart's readers are done

    // P.V: rows tid + NT j of the block's columns, 16 tokens a load, 4 of
    // them against their weights at once (tokens past n weigh 0)
    const int nch = (n + 15) / 16;
#pragma unroll
    for (int j0 = 0; j0 < NR; j0 += NRH) {
      for (int ch = 0; ch < nch; ++ch) {
        uint4 u[NRH];
#pragma unroll
        for (int jr = 0; jr < NRH; ++jr) {
          const int c = tid + (j0 + jr) * NT;
          u[jr] = c < cl.n ? __ldg(reinterpret_cast<const uint4*>(
                                 v8 + (page + cl.c0 + c) * ps + off + 16 * ch))
                           : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          if (16 * ch + 4 * q4 >= n) break;
          float ev[4][GN];
#pragma unroll
          for (int gi = 0; gi < GN; ++gi) {
            const float4 e4 = gi < gn ? *reinterpret_cast<const float4*>(
                                            es + gi * NT + 16 * ch + 4 * q4)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
            ev[0][gi] = e4.x;
            ev[1][gi] = e4.y;
            ev[2][gi] = e4.z;
            ev[3][gi] = e4.w;
          }
#pragma unroll
          for (int jr = 0; jr < NRH; ++jr) {
            const uint32_t word = q4 == 0 ? u[jr].x : q4 == 1 ? u[jr].y
                                : q4 == 2 ? u[jr].z : u[jr].w;
            float vv[4];
            decode4<T>(word, vv);
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int gi = 0; gi < GN; ++gi)
                acc[j0 + jr][gi] = fmaf(ev[x][gi], vv[x], acc[j0 + jr][gi]);
          }
        }
      }
    }
    __syncthreads();  // the next stage may overwrite es and spart
  }

#pragma unroll
  for (int jr = 0; jr < NR; ++jr) {
    const int c = tid + jr * NT;
    if (c >= cl.n) continue;
#pragma unroll
    for (int gi = 0; gi < GN; ++gi)
      if (gi < gn) red[gi * cl.n + c] = acc[jr][gi];
  }
  reduce_lsum<GN>(lpart, gn, lred);
  finish_split(red, 1, GN, lred, gn, cl, sp, bh * G + g0, out, m, &flag);
}

}  // namespace

// Contiguous tensors on one device: q (B, KVH, G, d) bf16, already
// l2-normalized, any group G, d any multiple of 8; k8/v8 (num_pages, KVH,
// d, ps) int8 (fp8 = 0) or e4m3 (fp8 = 1), 16-byte aligned; v_scale
// (num_pages, KVH, 1, ps) f32, read for int8 only; page_table (B, mp)
// int32; length (B,) int32; out (B, KVH, G, d) f32.  ps is a multiple of
// 128.  The split-K workspace as for fcsa_decode, over the table's mp * ps
// tokens.  logit_scale is scale * kdq (1/127 for int8, 1 for e4m3).
// Returns the cudaGetLastError() after the launch.
extern "C" int fcsa_paged_decode(const void* q, const void* k8, const void* v8,
                                 const void* v_scale, const void* page_table,
                                 const void* length, void* out, void* ws_o,
                                 void* ws_l, void* tickets, int B, int KVH,
                                 int G, int d, int num_pages, int ps, int mp,
                                 int fp8, int tps, int nsplit,
                                 float logit_scale, float scale,
                                 void* stream) {
  const size_t cap = size_t(mp) * ps;
  if (B <= 0 || KVH <= 0 || G <= 0 || num_pages <= 0 || mp <= 0 ||
      ps <= 0 || ps % NT || tps <= 0 || tps % NT || nsplit <= 0 ||
      size_t(nsplit) * tps < cap || size_t(nsplit - 1) * tps >= cap)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int gm = heads_instance(G), ncb = col_blocks(d);
  const dim3 grid(nsplit, (G + gm - 1) / gm, B * KVH * ncb);
  const Merge m{static_cast<float*>(ws_o), static_cast<float*>(ws_l),
                static_cast<int*>(tickets), size_t(B) * KVH * G, ncb};
  return int(dispatch(fp8, d, 256, G, [&](auto code, auto width, auto heads) {
    using T = decltype(code);
    constexpr int W = decltype(width)::value;
    constexpr int GN = decltype(heads)::value;
    const auto qp = static_cast<const __nv_bfloat16*>(q);
    const auto kp = static_cast<const uint8_t*>(k8);
    const auto vp = static_cast<const uint8_t*>(v8);
    const auto sp = static_cast<const float*>(v_scale);
    const auto tp = static_cast<const int*>(page_table);
    const auto lp = static_cast<const int*>(length);
    const auto op = static_cast<float*>(out);
    if constexpr (W == COLUMNS) {
      paged_decode_cols_kernel<T, GN><<<grid, NT, 0, s>>>(
          qp, kp, vp, sp, tp, lp, op, m, KVH, G, d, num_pages, ps, mp, tps,
          logit_scale, scale);
    } else {
      auto kernel = paged_decode_kernel<T, W == WIDE_ROW, GN>;
      const size_t smem = Layout(d, GN).bytes;
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (err != cudaSuccess) return err;
      kernel<<<grid, NT, smem, s>>>(qp, kp, vp, sp, tp, lp, op, m, KVH, G, d,
                                    num_pages, ps, mp, tps, logit_scale,
                                    scale);
    }
    return cudaGetLastError();
  }));
}
