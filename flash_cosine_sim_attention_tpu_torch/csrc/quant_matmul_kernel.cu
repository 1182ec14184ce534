// INT8-weight dequant-matmul for Hopper (sm_90a): y = x . (w8 * scale).
//
// Replaces the TPU kernel `_dequant_matmul_kernel` of
// flash_cosine_sim_attention_tpu/quant/weights.py (launched there by
// `quantized_matmul`).  x is (rows, in) float32 or bfloat16, w8 (in, out)
// int8 codes, scale (1, out) float32; the products are summed in float32,
// the per-column scale is applied once to the sum (the TPU kernel scales
// each K block's partial: the two differ only at f32 rounding), and y is
// cast to x's dtype.  Only the int8 weight bytes are read: no dequantized
// copy of the weight exists anywhere.
//
// Bound on the H100: a decode step's product (8 rows) reads the whole
// weight matrix to do 16 FLOP per weight byte, far below the ~295 FLOP/B
// ridge, so it is bytes-bound (the 0.81B serving model's 2048 x 6144 QKV
// matrix: 12.6 MB, 3.76 us at 3.35 TB/s).  A 1024-token prefill does 2048
// FLOP per weight byte: operations-bound on the tensor cores.
//
// bfloat16 x runs on the tensor cores, as the TPU kernel runs its bf16
// MXU product: every int8 code is exact in bf16 (|c| <= 127 < 2^8), so
// bf16 x times the codes by `mma.sync.m16n8k16` with f32 accumulators is
// the same function as an f32 product of x and the codes, up to the order
// of the sums.  One kernel, `qmm_mma_kernel`, serves both regimes:
//   * a ring of STAGES shared-memory tiles (x: BM rows x 64 inputs, w8:
//     64 inputs x 128 columns) filled by 16-byte `cp.async` (zero-fill at
//     the ragged edges; an x whose rows are not 16-byte multiples takes
//     element loads into the same ring), so several tiles of weight bytes
//     are in flight while one is multiplied;
//   * each weight byte is turned into bf16 once per block (bit operations
//     on bf16 pairs, exact: 2 instructions a byte) into one bf16 tile,
//     which feeds the B fragments through `ldmatrix.trans` (w8 is k-major,
//     the B operand's transposed layout); x feeds the A fragments through
//     `ldmatrix`;
//   * prefill (rows > 16): 128 x 128 block tiles, 8 warps of 32 x 64, so
//     each A fragment is reused across 8 products and each B across 2;
//   * decode (rows <= 16): the rows fill one m16 A fragment (zero rows
//     padded), the 8 warps split the 128 columns, and 4 stages keep 24 KB
//     of weights in flight per block.
// Few output blocks (decode: 2048 outputs are 16 blocks on 132 SMs;
// prefill: 1024 rows and 2048 outputs are 128 blocks) split the input
// dimension over blockIdx.z until about two blocks (decode) or one block
// (prefill) run per SM; each split writes its f32 partial sums, and a
// second small kernel adds the splits, scales and casts (no atomics:
// deterministic).
// float32 x (parity runs at a 1e-4 bar, which bf16 tensor cores cannot
// meet without a split product) keeps the f32 FMA kernel `qmm_kernel`: a
// thread loads 16 weight bytes of a row with one 16-byte load, the next
// tile in registers while the current one is multiplied, and turns its 4
// bytes of a row into floats at use.
// `fcsa_qmm_plan` picks the regime and the splits from the shape and the
// card's SM count; the wrapper (quant/weights.py) asks it, so the tiles are
// defined here only.  out must be a multiple of 16 (16-byte weight loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int BN = 128;         // output columns per block
constexpr int SPLIT_K = 64;     // input rows per tile: the unit of a split
constexpr int SMALL_ROWS = 16;  // up to this many rows take the decode tiles
constexpr int PREFILL_ROWS = 128;
constexpr int BLOCKS_PER_SM = 2;  // decode: split the input until this many run

// ---------------------------------------------------------------------------
// Tensor-core kernel (bfloat16 x)

constexpr int XS = SPLIT_K + 8;  // x tile row stride, bf16: 144 bytes
constexpr int BS = BN + 8;       // bf16 weight tile row stride: 272 bytes

// two int8 codes, in the low bytes of a word's 16-bit halves, -> a bf16
// pair, exactly: code c = (c & 127) - 128 s with s its sign bit, so it is
// (128 + (c & 127)) - (128 + 128 s), and both terms are bf16 bit patterns
// (exponent 2^7, the low 7 bits as mantissa; 128 or 256)
__device__ __forceinline__ uint32_t code_pair_to_bf16(uint32_t h) {
  const uint32_t lo7 = (h & 0x007F007Fu) | 0x43004300u;
  const uint32_t sgn = (h & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo7),
                                   *reinterpret_cast<const __nv_bfloat162*>(&sgn));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// four int8 codes (one word) -> four bf16 (two pairs, byte order kept)
__device__ __forceinline__ uint2 codes_to_bf16(uint32_t w) {
  return make_uint2(code_pair_to_bf16(__byte_perm(w, 0u, 0x4140)),
                    code_pair_to_bf16(__byte_perm(w, 0u, 0x4342)));
}

// block of WM x WN warps over BM rows x BN columns; k tiles of SPLIT_K
template <int BM, int WM, int WN, int STAGES>
struct MmaTiles {
  static constexpr int NT = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  static constexpr int MI = TM / 16, NI = TN / 8;   // m16 / n8 fragments
  static constexpr size_t XBYTES = size_t(BM) * XS * 2;  // one x stage
  static constexpr size_t WBYTES = size_t(SPLIT_K) * BN;  // one w8 stage
  static constexpr size_t SMEM =
      STAGES * (XBYTES + WBYTES) + size_t(SPLIT_K) * BS * 2;
  static_assert(NI % 2 == 0 && TM % 16 == 0, "fragment tiling");
};

template <int BM, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32) qmm_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w8,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
    float* __restrict__ work, int rows, int d_in, int d_out, int k_split,
    int x_vec) {
  using T = MmaTiles<BM, WM, WN, STAGES>;
  constexpr int NT = T::NT, MI = T::MI, NI = T::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                        // STAGES x BM x XS bf16
  unsigned char* ws = xs + STAGES * T::XBYTES;     // STAGES x 64 x BN int8
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(
      ws + STAGES * T::WBYTES);                    // 64 x BS bf16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(d_in, k_begin + k_split);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + SPLIT_K - 1) / SPLIT_K : 0;

  // this thread's 16-byte copies of a tile: 16 weight columns of rows
  // tid / 8 + 32 i, and 8 x inputs of rows tid / 8 + 32 i; only the tile's
  // first input row moves from tile to tile
  constexpr int WCH = SPLIT_K * BN / 16 / NT;
  constexpr int XCH = (BM * SPLIT_K / 8 + NT - 1) / NT;
  const int cr = tid >> 3;                     // tile row of copy 0
  const int wc = (tid & 7) * 16, xc = (tid & 7) * 8;
  const bool w_in = col0 + wc < d_out;
  auto load = [&](int stage, int tile) {
    const int k0 = k_begin + tile * SPLIT_K;
    int8_t* wst = reinterpret_cast<int8_t*>(ws + stage * T::WBYTES);
    const int8_t* wsrc = w8 + size_t(k0) * d_out + col0 + wc;
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int r = cr + i * (NT / 8);
      const bool in = w_in && k0 + r < k_end;
      cp_async16(wst + r * BN + wc, in ? wsrc + size_t(r) * d_out : w8,
                 in ? 16 : 0);
    }
    __nv_bfloat16* xst =
        reinterpret_cast<__nv_bfloat16*>(xs + stage * T::XBYTES);
    const __nv_bfloat16* xsrc = x + size_t(row0) * d_in + k0 + xc;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int r = cr + i * (NT / 8);
      if (r >= BM) break;
      const int gr = row0 + r, gk = k0 + xc;
      __nv_bfloat16* dst = xst + r * XS + xc;
      if (x_vec) {  // rows are 16-byte multiples: a chunk is all in or out
        const bool in = gr < rows && gk < k_end;
        cp_async16(dst, in ? xsrc + size_t(r) * d_in : x, in ? 16 : 0);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (gr < rows && gk + e < k_end) ? x[size_t(gr) * d_in + gk + e]
                                               : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every reader of tile t - 1 is done
    {  // the codes of tile t, once, into the bf16 tile
      const unsigned char* wst = ws + stage * T::WBYTES;
#pragma unroll
      for (int i = 0; i < WCH; ++i) {
        const int r = cr + i * (NT / 8), cc = wc;
        const uint4 raw = *reinterpret_cast<const uint4*>(wst + r * BN + cc);
        const uint2 a = codes_to_bf16(raw.x), b = codes_to_bf16(raw.y);
        const uint2 e = codes_to_bf16(raw.z), f = codes_to_bf16(raw.w);
        uint4* dst = reinterpret_cast<uint4*>(bs + r * BS + cc);
        dst[0] = make_uint4(a.x, a.y, b.x, b.y);
        dst[1] = make_uint4(e.x, e.y, f.x, f.y);
      }
    }
    if (t + STAGES - 1 < ntiles) load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_async_commit();
    __syncthreads();  // the bf16 tile is written

    const unsigned char* xst = xs + stage * T::XBYTES;
#pragma unroll
    for (int kk = 0; kk < SPLIT_K / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], xst + ((wm * T::TM + i * 16 + (lane & 15)) * XS +
                                 kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * BS +
                   wn * T::TN + j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(acc[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // C fragment: rows lane/4 and lane/4 + 8, columns 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = col0 + wn * T::TN + j * 8 + 2 * (lane & 3);
      if (col >= d_out) continue;  // d_out is even: col + 1 is in too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * T::TM + i * 16 + (lane >> 2) + 8 * h;
        if (row >= rows) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (work == nullptr)
          *reinterpret_cast<uint32_t*>(y + size_t(row) * d_out + col) =
              pack_bf16(v0 * scale[col], v1 * scale[col + 1]);
        else
          *reinterpret_cast<float2*>(
              work + (size_t(blockIdx.z) * rows + row) * d_out + col) =
              make_float2(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 FMA kernel (float32 x)

constexpr int NT = 256;  // 8 warps: warp = row group, lane = 4 columns

// input rows (of w8) per tile: more bytes in flight for the decode regime
__host__ __device__ constexpr int block_in(int bm) { return bm == 8 ? 128 : 32; }

// byte j of a 32-bit word as a signed value
__device__ __forceinline__ float code(int w, int j) {
  return float((w << (24 - 8 * j)) >> 24);
}

template <int BM>
__global__ void __launch_bounds__(NT) qmm_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w8,
    const float* __restrict__ scale, float* __restrict__ y,
    float* __restrict__ work, int rows, int d_in, int d_out, int k_split) {
  constexpr int BK = block_in(BM);
  constexpr int RM = BM / 8;          // token rows per thread
  constexpr int XL = BM * BK / NT;    // x elements each thread loads a tile
  constexpr int WL = BK * BN / 16 / NT;  // 16-byte weight loads a tile
  __shared__ float xs[BK][BM + 1];    // x tile, input-major; pad: no conflicts
  __shared__ __align__(16) int8_t ws[BK][BN];  // weight codes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(d_in, k_begin + k_split);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // this thread's weight loads: rows wr + 32 i of the tile, 16 columns
  // from wc
  const int wr = tid >> 3, wc = col0 + (tid & 7) * 16;
  int4 wreg[WL];
  float xreg[XL];
  auto load = [&](int tile) {
    const int k0 = k_begin + tile * BK;
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int gk = k0 + wr + i * (NT / 8);
      wreg[i] = (gk < k_end && wc < d_out)
                    ? __ldg(reinterpret_cast<const int4*>(
                          w8 + size_t(gk) * d_out + wc))
                    : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int idx = tid + i * NT, r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gkx = k0 + kk;
      xreg[i] = (gr < rows && gkx < k_end) ? x[size_t(gr) * d_in + gkx] : 0.f;
    }
  };

  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (ntiles > 0) load(0);
  for (int tile = 0; tile < ntiles; ++tile) {
    __syncthreads();  // the previous tile's readers are done
    {
#pragma unroll
      for (int i = 0; i < WL; ++i)
        *reinterpret_cast<int4*>(&ws[wr + i * (NT / 8)][(tid & 7) * 16]) =
            wreg[i];
#pragma unroll
      for (int i = 0; i < XL; ++i) {
        const int idx = tid + i * NT;
        xs[idx % BK][idx / BK] = xreg[i];
      }
    }
    __syncthreads();
    if (tile + 1 < ntiles) load(tile + 1);  // in flight while we multiply

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const int w = *reinterpret_cast<const int*>(&ws[kk][lane * 4]);
      const float b[4] = {code(w, 0), code(w, 1), code(w, 2), code(w, 3)};
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float a = xs[kk][warp * RM + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a, b[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + warp * RM + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + lane * 4 + c;
      if (col >= d_out) continue;
      if (work == nullptr)
        y[size_t(row) * d_out + col] = acc[r][c] * scale[col];
      else
        work[(size_t(blockIdx.z) * rows + row) * d_out + col] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// y = (sum over splits of the partials) * scale, cast to T
template <typename T>
__global__ void qmm_reduce(const float* __restrict__ work,
                           const float* __restrict__ scale, T* __restrict__ y,
                           int rows, int d_out, int splits) {
  const size_t n = size_t(rows) * d_out;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += work[size_t(z) * n + i];
    store(y + i, s * scale[i % d_out]);
  }
}

template <typename T>
cudaError_t reduce(const float* work, const float* scale, void* y, int rows,
                   int d_out, int splits, cudaStream_t stream) {
  const size_t n = size_t(rows) * d_out;
  const int blocks = int((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  qmm_reduce<T><<<blocks, 256, 0, stream>>>(work, scale, static_cast<T*>(y),
                                            rows, d_out, splits);
  return cudaGetLastError();
}

template <int BM, int WM, int WN, int STAGES>
cudaError_t launch_mma(const void* x, const void* w8, const float* scale,
                       void* y, float* work, int rows, int d_in, int d_out,
                       int splits, int k_split, cudaStream_t stream) {
  using T = MmaTiles<BM, WM, WN, STAGES>;
  const auto kernel = qmm_mma_kernel<BM, WM, WN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::SMEM));
  if (err != cudaSuccess) return err;
  // 16-byte x loads need 16-byte rows and a 16-byte aligned start
  const int x_vec = d_in % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((d_out + BN - 1) / BN, (rows + BM - 1) / BM, splits);
  kernel<<<grid, T::NT, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
      scale, static_cast<__nv_bfloat16*>(y), work, rows, d_in, d_out,
      k_split, x_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || work == nullptr) return err;
  return reduce<__nv_bfloat16>(work, scale, y, rows, d_out, splits, stream);
}

template <int BM>
cudaError_t launch_fma(const void* x, const void* w8, const float* scale,
                       void* y, float* work, int rows, int d_in, int d_out,
                       int splits, int k_split, cudaStream_t stream) {
  const dim3 grid((d_out + BN - 1) / BN, (rows + BM - 1) / BM, splits);
  qmm_kernel<BM><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w8), scale,
      static_cast<float*>(y), work, rows, d_in, d_out, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || work == nullptr) return err;
  return reduce<float>(work, scale, y, rows, d_out, splits, stream);
}

}  // namespace

// K7's grid for a (rows, d_in) x (d_in, d_out) product on a card of
// `sm_count` SMs, written to plan[0..2]: rows per block (16: the decode
// tiles; 128: the prefill tiles), input splits, and 64-row input tiles per
// split.  Products with few output blocks split the input dimension until
// about BLOCKS_PER_SM blocks (decode: 8 rows and 2048 outputs are 16
// blocks) or one block (prefill: 1024 rows and 2048 outputs are 128
// blocks) run on each SM.  The caller sizes the splits' f32 scratch
// (splits, rows, d_out) from it when splits > 1.
extern "C" void fcsa_qmm_plan(int rows, int d_in, int d_out, int sm_count,
                              int* plan) {
  const int bm = rows <= SMALL_ROWS ? SMALL_ROWS : PREFILL_ROWS;
  const long long sms = sm_count > 0 ? sm_count : 1;
  const long long blocks =
      (long long)((d_out + BN - 1) / BN) * ((rows + bm - 1) / bm);
  const int tiles = d_in > 0 ? (d_in + SPLIT_K - 1) / SPLIT_K : 1;
  const long long target = bm == SMALL_ROWS ? BLOCKS_PER_SM * sms : sms;
  long long want = (target + blocks - 1) / blocks;
  want = want < tiles ? want : tiles;
  want = want > 1 ? want : 1;
  const int per_split = int((tiles + want - 1) / want);
  plan[0] = bm;
  plan[1] = (tiles + per_split - 1) / per_split;
  plan[2] = per_split;
}

// dtype: 0 = float32, 1 = bfloat16 (x and y share it).  All tensors
// contiguous: x (rows, d_in), w8 (d_in, d_out) int8 on a 16-byte boundary,
// scale (d_out,) f32, y (rows, d_out); work (splits, rows, d_out) f32 when
// splits > 1, else null.  block_rows, splits and per_split are
// fcsa_qmm_plan's: split z covers input rows [z, z + 1) * per_split * 64.
// bfloat16 runs the tensor-core kernel, float32 the FMA kernel.  Returns
// the cudaGetLastError() after the launches (0 = success).
extern "C" int fcsa_qmm(const void* x, const void* w8, const void* scale,
                        void* y, void* work, int dtype, int rows, int d_in,
                        int d_out, int block_rows, int splits, int per_split,
                        void* stream) {
  const long long k_split = (long long)per_split * SPLIT_K;
  if (rows <= 0 || d_in <= 0 || d_out <= 0 || d_out % 16 != 0 ||
      splits < 1 || per_split < 1 || (splits > 1) != (work != nullptr) ||
      reinterpret_cast<uintptr_t>(w8) % 16 != 0 || block_rows <= 0 ||
      (rows + block_rows - 1) / block_rows > 65535 || splits > 65535 ||
      splits * k_split < d_in)
    return int(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  auto* wk = static_cast<float*>(work);
  auto s = static_cast<cudaStream_t>(stream);
  const int ks = int(k_split);
  if (dtype == 1 && block_rows == SMALL_ROWS)
    return int(launch_mma<SMALL_ROWS, 1, 8, 4>(x, w8, sc, y, wk, rows, d_in, d_out, splits, ks, s));
  if (dtype == 1 && block_rows == PREFILL_ROWS)
    return int(launch_mma<PREFILL_ROWS, 4, 2, 3>(x, w8, sc, y, wk, rows, d_in, d_out, splits, ks, s));
  if (dtype == 0 && block_rows == SMALL_ROWS)
    return int(launch_fma<8>(x, w8, sc, y, wk, rows, d_in, d_out, splits, ks, s));
  if (dtype == 0 && block_rows == PREFILL_ROWS)
    return int(launch_fma<64>(x, w8, sc, y, wk, rows, d_in, d_out, splits, ks, s));
  return int(cudaErrorInvalidValue);
}
