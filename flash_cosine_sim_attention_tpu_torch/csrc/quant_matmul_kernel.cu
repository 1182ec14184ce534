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
// Both dtypes run on the tensor cores.  bfloat16 x, as the TPU kernel runs
// its bf16 MXU product: every int8 code is exact in bf16 (|c| <= 127 <
// 2^8), so bf16 x times the codes by `mma.sync.m16n8k16` with f32
// accumulators is the same function as an f32 product of x and the codes,
// up to the order of the sums.  float32 x (parity runs at a 1e-4 bar,
// which one bf16 or tf32 product cannot meet) as 2xTF32: each A fragment
// of x is split into tf32 hi and lo at fragment load (split_tf32) and
// multiplied by the codes, exact in tf32, as x_lo.w + x_hi.w by
// `mma.sync.m16n8k8` into f32; w's lo is exactly zero, so this is the
// whole 3xTF32 product (ops/mxu.py dot_tf32x3 of x and the codes is its
// plain version).  The tensor cores round each f32 sum toward zero, so
// the f32 instance closes its chains of sums every 256 inputs into an
// accumulator of its own, added to nearest (ff_out's 8192 inputs may lie
// in one split at prefill).  One kernel, `qmm_mma_kernel`, templated on
// x's type, serves both regimes:
//   * a ring of STAGES shared-memory tiles (x: BM rows x 64 inputs, w8:
//     64 inputs x 128 columns) filled by 16-byte `cp.async` (zero-fill at
//     the ragged edges; an x whose rows are not 16-byte multiples takes
//     element loads into the same ring), so several tiles of weight bytes
//     are in flight while one is multiplied;
//   * each weight byte is turned into bf16 once per block (bit operations
//     on bf16 pairs, exact: 2 instructions a byte) into one bf16 tile,
//     which feeds the B fragments through `ldmatrix.trans` (w8 is k-major,
//     the B operand's transposed layout), or, for f32 x at the prefill
//     tiles, widened on into one f32 tile (a bf16 is a float's high
//     half), whose B fragments are single 32-bit words; x feeds the A
//     fragments through `ldmatrix`.  At the decode tiles each warp is the
//     only reader of its 16 columns, so f32 x reads each B fragment's two
//     codes straight from the int8 stage (converted at use), and its x
//     tile, which all 8 warps read, is split into hi and lo once a tile;
//   * prefill (rows > 16): 128 x 128 block tiles, 8 warps of 32 x 64, so
//     each A fragment is reused across 8 products and each B across 2;
//   * decode (rows <= 16): the rows fill one m16 A fragment (zero rows
//     padded), the 8 warps split the 128 columns, and 4 stages keep 24 KB
//     of weights in flight per block.
// Shared memory: bf16 58 KB (decode) and 95 KB (prefill); f32 57 KB and
// 160 KB (three stages of 128 f32 x rows, 102 KB, and the 34 KB f32
// weight tile).
// Few output blocks (decode: 2048 outputs are 16 blocks on 132 SMs;
// prefill: 1024 rows and 2048 outputs are 128 blocks) split the input
// dimension over blockIdx.z until about two blocks (decode) or one block
// (prefill) run per SM; each split writes its f32 partial sums, and a
// second small kernel adds the splits, scales and casts (no atomics:
// deterministic).
// `fcsa_qmm_plan` picks the regime and the splits from the shape and the
// card's SM count; the wrapper (quant/weights.py) asks it, so the tiles are
// defined here only.  out must be a multiple of 16 (16-byte weight loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int BN = 128;         // output columns per block
constexpr int SPLIT_K = 64;     // input rows per tile: the unit of a split
constexpr int SMALL_ROWS = 16;  // up to this many rows take the decode tiles
constexpr int PREFILL_ROWS = 128;
constexpr int BLOCKS_PER_SM = 2;  // decode: split the input until this many run

// ---------------------------------------------------------------------------
// Tensor-core kernel (bfloat16 x: bf16 products; float32 x: 2xTF32)

constexpr int WS = BN + 8;  // widened weight tile row stride, elements

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

// a bf16 pair -> its two floats (a bf16 is a float's high half), low
// half first: exact
__device__ __forceinline__ uint2 bf16_pair_to_f32(uint32_t p) {
  return make_uint2(p << 16, p & 0xFFFF0000u);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// two adjacent outputs (the even column first) in y's dtype
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// block of WM x WN warps over BM rows x BN columns; k tiles of SPLIT_K;
// x of type TX
template <int BM, int WM, int WN, int STAGES, typename TX>
struct MmaTiles {
  static constexpr bool F32 = std::is_same<TX, float>::value;
  // f32 x at the decode tiles (one row of warps, each warp the only
  // reader of its columns): the B fragments come straight from the int8
  // stage and x is split once a tile (see the kernel)
  static constexpr bool DIRECT = F32 && WM == 1;
  static constexpr int NT = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  static constexpr int MI = TM / 16, NI = TN / 8;   // m16 / n8 fragments
  // x tile rows of SPLIT_K elements and 16 bytes (144 bytes bf16, 272
  // f32): an odd count of 16-byte units, so the 8 rows an ldmatrix reads
  // hit 8 distinct banks
  static constexpr int XSB = SPLIT_K * int(sizeof(TX)) + 16;
  static constexpr size_t XBYTES = size_t(BM) * XSB;      // one x stage
  // w8 stage rows: BN bytes, or BN + 16 where B fragments read the codes
  // (a fragment's 4 k rows then sit 4 banks apart)
  static constexpr int WROW = DIRECT ? BN + 16 : BN;
  static constexpr size_t WBYTES = size_t(SPLIT_K) * WROW;  // one w8 stage
  // then the widened weight tile, SPLIT_K rows of WS elements of x's type
  // (f32 rows 8 words past 32 banks' multiple: a B fragment's 32 reads,
  // (k q, column g), hit 32 banks), or where DIRECT the x tile's lo
  static constexpr size_t SMEM =
      STAGES * (XBYTES + WBYTES) +
      (DIRECT ? XBYTES : size_t(SPLIT_K) * WS * sizeof(TX));
  static_assert(NI % 2 == 0 && TM % 16 == 0, "fragment tiling");
  static_assert(SMEM <= 232448, "K7 shared memory");
};

template <int BM, int WM, int WN, int STAGES, typename TX>
__global__ void __launch_bounds__(WM * WN * 32) qmm_mma_kernel(
    const TX* __restrict__ x, const int8_t* __restrict__ w8,
    const float* __restrict__ scale, TX* __restrict__ y,
    float* __restrict__ work, int rows, int d_in, int d_out, int k_split,
    int x_vec) {
  using T = MmaTiles<BM, WM, WN, STAGES, TX>;
  constexpr bool F32 = T::F32, DIRECT = T::DIRECT;
  constexpr int NT = T::NT, MI = T::MI, NI = T::NI, XSB = T::XSB;
  constexpr int WROW = T::WROW;
  constexpr int ES = int(sizeof(TX));
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                        // STAGES x BM x XSB
  unsigned char* ws = xs + STAGES * T::XBYTES;     // STAGES x 64 x BN int8
  TX* bs = reinterpret_cast<TX*>(ws + STAGES * T::WBYTES);  // 64 x WS
  unsigned char* xlo = ws + STAGES * T::WBYTES;  // DIRECT: BM x XSB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(d_in, k_begin + k_split);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + SPLIT_K - 1) / SPLIT_K : 0;

  // this thread's 16-byte copies of a tile: 16 weight columns of rows
  // tid / 8 + 32 i, and x's copies tid + NT i of the tile's BM rows of XPR
  // copies (EPC elements each); only the tile's first input row moves
  // from tile to tile
  constexpr int WCH = SPLIT_K * BN / 16 / NT;
  constexpr int XPR = SPLIT_K * ES / 16, EPC = 16 / ES;
  constexpr int XCH = (BM * XPR + NT - 1) / NT;
  const int cr = tid >> 3;                     // tile row of copy 0
  const int wc = (tid & 7) * 16;
  const bool w_in = col0 + wc < d_out;
  auto load = [&](int stage, int tile) {
    const int k0 = k_begin + tile * SPLIT_K;
    int8_t* wst = reinterpret_cast<int8_t*>(ws + stage * T::WBYTES);
    const int8_t* wsrc = w8 + size_t(k0) * d_out + col0 + wc;
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int r = cr + i * (NT / 8);
      const bool in = w_in && k0 + r < k_end;
      cp_async16(wst + r * WROW + wc, in ? wsrc + size_t(r) * d_out : w8,
                 in ? 16 : 0);
    }
    unsigned char* xst = xs + stage * T::XBYTES;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int idx = tid + i * NT;
      if (idx >= BM * XPR) break;
      const int r = idx / XPR, xc = (idx % XPR) * EPC;
      const int gr = row0 + r, gk = k0 + xc;
      unsigned char* dst = xst + r * XSB + xc * ES;
      if (x_vec) {  // rows are 16-byte multiples: a chunk is all in or out
        const bool in = gr < rows && gk < k_end;
        cp_async16(dst, in ? x + size_t(gr) * d_in + gk : x, in ? 16 : 0);
      } else {
        __align__(16) TX v[EPC];
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          v[e] = (gr < rows && gk + e < k_end) ? x[size_t(gr) * d_in + gk + e]
                                               : zero<TX>();
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  // acc: the current chain of mma sums; f32 x closes it every CHAIN tiles
  // (256 inputs) into tot, added to nearest: the tensor cores round each
  // f32 sum toward zero, and one chain over ff_out's 8192 inputs drifts
  // past the 1e-4 bar where x's mean is far from 0
  constexpr int CHAIN = 256 / SPLIT_K;
  float acc[MI][NI][4], tot[F32 ? MI : 1][F32 ? NI : 1][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        if constexpr (F32) tot[i][j][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every reader of tile t - 1 is done
    if constexpr (DIRECT) {
      // x's tile t split once, for the 8 warps that all read it: hi in
      // place, lo into xlo (its readers of tile t - 1 are done)
      unsigned char* xst = xs + stage * T::XBYTES;
      for (int idx = tid; idx < BM * XPR; idx += NT) {
        const int at = (idx / XPR) * XSB + (idx % XPR) * 16;
        const float4 v = *reinterpret_cast<const float4*>(xst + at);
        uint4 h, l;
        split_tf32(v.x, h.x, l.x);
        split_tf32(v.y, h.y, l.y);
        split_tf32(v.z, h.z, l.z);
        split_tf32(v.w, h.w, l.w);
        *reinterpret_cast<uint4*>(xst + at) = h;
        *reinterpret_cast<uint4*>(xlo + at) = l;
      }
    } else {  // the codes of tile t, once, into the widened tile (bf16, or
              // f32: every code, |c| <= 127, is exact in both, and in tf32)
      const unsigned char* wst = ws + stage * T::WBYTES;
#pragma unroll
      for (int i = 0; i < WCH; ++i) {
        const int r = cr + i * (NT / 8), cc = wc;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(wst + r * WROW + cc);
        const uint2 a = codes_to_bf16(raw.x), b = codes_to_bf16(raw.y);
        const uint2 e = codes_to_bf16(raw.z), f = codes_to_bf16(raw.w);
        uint4* dst = reinterpret_cast<uint4*>(bs + r * WS + cc);
        if constexpr (F32) {
          const uint32_t pairs[8] = {a.x, a.y, b.x, b.y, e.x, e.y, f.x, f.y};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const uint2 lo = bf16_pair_to_f32(pairs[2 * p]);
            const uint2 hi = bf16_pair_to_f32(pairs[2 * p + 1]);
            dst[p] = make_uint4(lo.x, lo.y, hi.x, hi.y);
          }
        } else {
          dst[0] = make_uint4(a.x, a.y, b.x, b.y);
          dst[1] = make_uint4(e.x, e.y, f.x, f.y);
        }
      }
    }
    if (t + STAGES - 1 < ntiles) load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_async_commit();
    __syncthreads();  // the widened tile (or x's split) is written

    const unsigned char* xst = xs + stage * T::XBYTES;
    if constexpr (DIRECT) {
      // as below, with x's hi and lo fragments read from the split tile
      // and each B fragment's two codes read from the int8 stage and
      // converted at use: a warp is the only reader of its columns, so
      // widening the tile first would convert each code as often and
      // add a pass and a barrier
      const int8_t* wt = reinterpret_cast<const int8_t*>(
          ws + stage * T::WBYTES) + (lane & 3) * WROW + wn * T::TN +
          (lane >> 2);
#pragma unroll
      for (int kk = 0; kk < SPLIT_K / 8; ++kk) {
        uint32_t ah[MI][4], al[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int at = (i * 16 + (lane & 15)) * XSB + kk * 32 +
                         (lane >> 4) * 16;
          ldmatrix_x4(ah[i], xst + at);
          ldmatrix_x4(al[i], xlo + at);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int8_t* b = wt + kk * 8 * WROW + j * 8;
          const uint32_t b0 = __float_as_uint(float(b[0]));
          const uint32_t b1 = __float_as_uint(float(b[4 * WROW]));
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_tf32(acc[i][j], al[i], b0, b1);
            mma_tf32(acc[i][j], ah[i], b0, b1);
          }
        }
      }
    } else if constexpr (F32) {
      // 2xTF32: each A fragment of x split into tf32 hi and lo at load,
      // x_lo.w then x_hi.w by mma.sync m16n8k8 (small terms first).  w's
      // codes are exact in tf32, so its lo is exactly zero and the 3xTF32
      // product lo.hi + hi.lo + hi.hi of x and w is this one: the
      // kernel's function is dot_tf32x3 of x and the codes.  B fragments
      // (k q, column g) and (k q + 4, g) are single words of the f32 tile
      const float* wt = reinterpret_cast<const float*>(bs) +
                        (lane & 3) * WS + wn * T::TN + (lane >> 2);
#pragma unroll
      for (int kk = 0; kk < SPLIT_K / 8; ++kk) {
        uint32_t ah[MI][4], al[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t a[4];
          ldmatrix_x4(a, xst + (wm * T::TM + i * 16 + (lane & 15)) * XSB +
                             kk * 32 + (lane >> 4) * 16);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_tf32(__uint_as_float(a[q]), ah[i][q], al[i][q]);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const float* b = wt + kk * 8 * WS + j * 8;
          const uint32_t b0 = __float_as_uint(b[0]);
          const uint32_t b1 = __float_as_uint(b[4 * WS]);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_tf32(acc[i][j], al[i], b0, b1);
            mma_tf32(acc[i][j], ah[i], b0, b1);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < SPLIT_K / 16; ++kk) {
        uint32_t a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldmatrix_x4(a[i], xst + (wm * T::TM + i * 16 + (lane & 15)) * XSB +
                                kk * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WS +
                     wn * T::TN + j * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_bf16(acc[i][2 * j], a[i], b[0], b[1]);
            mma_bf16(acc[i][2 * j + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    if constexpr (F32) {
      if ((t + 1) % CHAIN == 0) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[i][j][e] += acc[i][j][e];
              acc[i][j][e] = 0.f;
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
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (F32) {
          v0 += tot[i][j][2 * h];
          v1 += tot[i][j][2 * h + 1];
        }
        if (work == nullptr)
          store2(y + size_t(row) * d_out + col, v0 * scale[col],
                 v1 * scale[col + 1]);
        else
          *reinterpret_cast<float2*>(
              work + (size_t(blockIdx.z) * rows + row) * d_out + col) =
              make_float2(v0, v1);
      }
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

template <int BM, int WM, int WN, int STAGES, typename TX>
cudaError_t launch_mma(const void* x, const void* w8, const float* scale,
                       void* y, float* work, int rows, int d_in, int d_out,
                       int splits, int k_split, cudaStream_t stream) {
  using T = MmaTiles<BM, WM, WN, STAGES, TX>;
  const auto kernel = qmm_mma_kernel<BM, WM, WN, STAGES, TX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::SMEM));
  if (err != cudaSuccess) return err;
  // 16-byte x loads need 16-byte rows and a 16-byte aligned start
  const int x_vec = (size_t(d_in) * sizeof(TX)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((d_out + BN - 1) / BN, (rows + BM - 1) / BM, splits);
  kernel<<<grid, T::NT, T::SMEM, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w8), scale,
      static_cast<TX*>(y), work, rows, d_in, d_out, k_split, x_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || work == nullptr) return err;
  return reduce<TX>(work, scale, y, rows, d_out, splits, stream);
}

// the decode tiles (rows <= 16: one m16 fragment, 8 warps over the 128
// columns, 4 stages) or the prefill tiles (128 x 128, 8 warps of 32 x 64,
// 3 stages)
template <typename TX>
cudaError_t launch_tiles(int block_rows, const void* x, const void* w8,
                         const float* scale, void* y, float* work, int rows,
                         int d_in, int d_out, int splits, int k_split,
                         cudaStream_t stream) {
  if (block_rows == SMALL_ROWS)
    return launch_mma<SMALL_ROWS, 1, 8, 4, TX>(x, w8, scale, y, work, rows,
                                               d_in, d_out, splits, k_split,
                                               stream);
  if (block_rows == PREFILL_ROWS)
    return launch_mma<PREFILL_ROWS, 4, 2, 3, TX>(x, w8, scale, y, work, rows,
                                                 d_in, d_out, splits, k_split,
                                                 stream);
  return cudaErrorInvalidValue;
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
// Both run the tensor-core kernel (float32 as 2xTF32).  Returns
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
  if (dtype == 0)
    return int(launch_tiles<float>(block_rows, x, w8, sc, y, wk, rows, d_in,
                                   d_out, splits, ks, s));
  if (dtype == 1)
    return int(launch_tiles<__nv_bfloat16>(block_rows, x, w8, sc, y, wk, rows,
                                           d_in, d_out, splits, ks, s));
  return int(cudaErrorInvalidValue);
}
