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
// 3.35 TB/s; the work is ~2 FLOP per byte.  Design: one 128-thread block
// per (slot, kv head, chunk of 8 query heads) reads its slot's length and
// table row from device memory (no host sync) and walks the live pages 128
// tokens at a time.  A page of one kv head is d rows of page_size
// contiguous bytes (any d a multiple of 8: the tile is d rows), so a tile's
// K and V (d x 128 bytes each) are staged in shared memory with 16-byte
// loads, every load of the tile in flight before any is used; thread t then
// scores token t down its column of the K tile, and the block accumulates
// the tile's P.V with threads split over the head dim, each reading four
// tokens of its V row at once.  The rows are padded by one word so that
// neither the column reads nor the row reads conflict on a bank.  The
// block's shared memory is dynamic: at d 256 the two tiles alone take
// 66 KB, past the 48 KB of static shared memory (the P.V partials share
// their room with the tiles), and above d 128 the tile is staged in two
// rounds, so its loads stay within 64 registers.  At b8
// kvh8 that is 64 blocks on 132 SMs, and a block waits for each tile's
// loads: the later design splits a slot's pages over several blocks and
// merges their partial (O, l) sums (no row max, so a plain addition), and
// double-buffers tiles with cp.async or TMA.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

constexpr int ROW = NT + 4; // bytes per staged row: one word of padding

// the block's dynamic shared memory: the K and V tiles (d-major; the P.V
// partials reuse their room at the end), then the queries, the tile's
// weights, its V scales and the row sums' partials
template <int D>
struct PagedSmem {
  static constexpr size_t KS = 0;
  static constexpr size_t VS = KS + size_t(D) * ROW;
  static constexpr size_t QS = VS + size_t(D) * ROW;
  static constexpr size_t ES = QS + sizeof(float) * GMAX * D;
  static constexpr size_t VSC = ES + sizeof(float) * GMAX * NT;
  static constexpr size_t LRED = VSC + sizeof(float) * NT;
  static constexpr size_t BYTES = LRED + sizeof(float) * GMAX * (NT / 32);
  static_assert(sizeof(float) * PvLanes<D>::NPARTS * GMAX * D <= QS,
                "the P.V partials fit in the tiles' room");
};

// T: int8_t (per-token V scales) or __nv_fp8_e4m3 (no scales).  Grid
// (query-head chunks, KVH, B): a chunk's blocks sit side by side.
template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ v8, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ length,
    float* __restrict__ out, int KVH, int G, int d, int num_pages, int ps,
    int mp, float logit_scale, float scale) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  using PV = PvLanes<D>;
  using S = PagedSmem<D>;
  constexpr int NPARTS = PV::NPARTS, NCOL = PV::NCOL;
  constexpr int PER_THREAD = (D * (NT / 16) + NT - 1) / NT;
  // 16-byte pieces a thread loads at once: the whole tile up to d 128
  constexpr int RB = PER_THREAD <= 8 ? PER_THREAD : PER_THREAD / 2;
  const int chunks = d * (NT / 16);                // 16-byte pieces of a tile
  extern __shared__ __align__(16) unsigned char psmem[];
  auto& ks = *reinterpret_cast<uint8_t(*)[D][ROW]>(psmem + S::KS);
  auto& vs = *reinterpret_cast<uint8_t(*)[D][ROW]>(psmem + S::VS);
  auto& qs = *reinterpret_cast<float(*)[GMAX][D]>(psmem + S::QS);
  auto& es = *reinterpret_cast<float(*)[GMAX][NT]>(psmem + S::ES);
  auto& vsc = *reinterpret_cast<float(*)[NT]>(psmem + S::VSC);
  auto& lred = *reinterpret_cast<float(*)[GMAX][NT / 32]>(psmem + S::LRED);
  auto& red = *reinterpret_cast<float(*)[NPARTS][GMAX][D]>(psmem + S::KS);

  const int g0 = blockIdx.x * GMAX, kvhi = blockIdx.y, bi = blockIdx.z;
  const int gn = min(GMAX, G - g0);
  const size_t bh = size_t(bi) * KVH + kvhi;
  const int tid = threadIdx.x;
  const int len = min(max(length[bi], 0), mp * ps);
  const int* row = page_table + size_t(bi) * mp;
  load_queries<D>(q, bh, G, g0, gn, d, qs);

  const int dcol = tid % PV::W, part = tid / PV::W;
  const bool pv_lane = tid < NPARTS * PV::W && dcol < d;
  float acc[NCOL][GMAX], lpart[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    lpart[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[j][gi] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += NT) {
    int pid = row[t0 / ps];
    if (pid < 0 || pid >= num_pages) pid = 0;
    const size_t page = (size_t(pid) * KVH + kvhi) * d;  // row 0 of (pid, h)
    const int off = t0 % ps;

    // stage the tile: all 16-byte loads of a round (the whole tile up to
    // d 128) first, then the stores
    if (kScaled) vsc[tid] = v_scale[(size_t(pid) * KVH + kvhi) * ps + off + tid];
#pragma unroll
    for (int i0 = 0; i0 < PER_THREAD; i0 += RB) {
      uint4 kr[RB], vr[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int c = tid + (i0 + i) * NT;
        if (c < chunks) {
          const size_t at = (page + c / (NT / 16)) * ps + off + (c % (NT / 16)) * 16;
          kr[i] = *reinterpret_cast<const uint4*>(k8 + at);
          vr[i] = *reinterpret_cast<const uint4*>(v8 + at);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int c = tid + (i0 + i) * NT;
        if (c < chunks) {
          const int r = c / (NT / 16), col = (c % (NT / 16)) * 16;
          uint32_t* kd = reinterpret_cast<uint32_t*>(&ks[r][col]);
          uint32_t* vd = reinterpret_cast<uint32_t*>(&vs[r][col]);
          kd[0] = kr[i].x; kd[1] = kr[i].y; kd[2] = kr[i].z; kd[3] = kr[i].w;
          vd[0] = vr[i].x; vd[1] = vr[i].y; vd[2] = vr[i].z; vd[3] = vr[i].w;
        }
      }
    }
    __syncthreads();

    // score: thread tid owns token t0 + tid, reading its K column's d rows
    const int live = min(NT, len - t0);
    if (tid < live) {
      float s[GMAX];
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) s[gi] = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < d; ++dd) {
        const float kf = code_value<T>(ks[dd][tid]);
#pragma unroll
        for (int gi = 0; gi < GMAX; ++gi)
          if (gi < gn) s[gi] = fmaf(qs[gi][dd], kf, s[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        if (gi < gn) {
          const float e = token_weight(s[gi], logit_scale, scale);
          lpart[gi] += e;
          es[gi][tid] = bf16_round(kScaled ? e * vsc[tid] : e);
        }
      }
    } else {
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) es[gi][tid] = 0.f;
    }
    __syncthreads();

    // P.V: thread (dcol, part) sums words part, part + NPARTS, ... of its
    // V row; tokens past the live count carry e = 0 and are skipped
    if (pv_lane) {
      const int words = (live + 3) / 4;
      for (int w = part; w < words; w += NPARTS) {
        const int n = min(4, live - 4 * w);
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          if (c > 0 && dcol + c * NT >= d) continue;
          const uint32_t word =
              *reinterpret_cast<const uint32_t*>(&vs[dcol + c * NT][4 * w]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < n) {
              const float vv = code_value<T>(uint8_t(word >> (8 * j)));
#pragma unroll
              for (int gi = 0; gi < GMAX; ++gi)
                if (gi < gn) acc[c][gi] = fmaf(es[gi][4 * w + j], vv, acc[c][gi]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  store_rows<D>(acc, lpart, pv_lane, part, dcol, gn, d, red, lred,
                out + (bh * G + g0) * d);
}

}  // namespace

// Contiguous tensors on one device: q (B, KVH, G, d) bf16, already
// l2-normalized, any group G, d a multiple of 8 up to 256; k8/v8
// (num_pages, KVH, d, ps) int8 (fp8 = 0) or e4m3
// (fp8 = 1), 16-byte aligned; v_scale (num_pages, KVH, 1, ps) f32, read for
// int8 only; page_table (B, mp) int32; length (B,) int32; out (B, KVH, G, d)
// f32.  ps is a multiple of 128.  logit_scale is scale * kdq (1/127 for
// int8, 1 for e4m3).  Returns the cudaGetLastError() after the launch.
extern "C" int fcsa_paged_decode(const void* q, const void* k8, const void* v8,
                                 const void* v_scale, const void* page_table,
                                 const void* length, void* out, int B, int KVH,
                                 int G, int d, int num_pages, int ps, int mp,
                                 int fp8, float logit_scale, float scale,
                                 void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0 || num_pages <= 0 || mp <= 0 ||
      ps <= 0 || ps % NT)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((G + GMAX - 1) / GMAX, KVH, B);
  return int(dispatch(fp8, d, [&](auto code, auto dim) {
    constexpr int D = decltype(dim)::value;
    constexpr size_t smem = PagedSmem<D>::BYTES;
    auto kernel = paged_decode_kernel<decltype(code), D>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, s>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const uint8_t*>(k8), static_cast<const uint8_t*>(v8),
            static_cast<const float*>(v_scale),
            static_cast<const int*>(page_table),
            static_cast<const int*>(length), static_cast<float*>(out), KVH, G,
            d, num_pages, ps, mp, logit_scale, scale);
    return cudaGetLastError();
  }));
}
