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
// FLOP per weight byte: operations-bound on the tensor cores.  This first
// port runs both products as float32 FMAs out of shared memory (as K1
// does); wgmma/TMA tiles are the later, fast version.  What it does about
// the bytes:
//   * one block owns 128 output columns; each thread loads 16 consecutive
//     weight bytes of a row with one 16-byte load (8 threads read a whole
//     128-byte line); for decode-sized x a thread loads four rows, 32
//     apart, per tile.  The next tile's loads are issued into registers
//     before the current tile is multiplied (register double buffering).
//     The tile stays int8 in shared memory; each thread turns its 4 bytes
//     of a row into floats at use;
//   * few output blocks (decode: 2048 outputs are 16 blocks on 132 SMs)
//     split the input dimension over blockIdx.z until about two blocks run
//     per SM; each split writes its f32 partial sums, and a second small
//     kernel adds the splits, scales and casts (no atomics: deterministic).
// The tiles: 128 columns; 8 token rows (one per warp) x 128 input rows
// per step for decode-sized x (up to 16 rows), 64 token rows (eight per
// warp) x 32 input rows above.  `fcsa_qmm_plan` picks the rows per block
// and the splits from the shape and the card's SM count; the wrapper
// (quant/weights.py) asks it, so the tiles are defined here only.
// Ragged edges load as 0; out must be a multiple of 16 (16-byte loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;  // output columns per block
constexpr int NT = 256;  // 8 warps: warp = row group, lane = 4 columns
constexpr int SMALL_ROWS = 16;  // up to this many rows take the decode tiles
constexpr int BLOCKS_PER_SM = 2;  // split the input until this many run

// input rows (of w8) per tile: more bytes in flight for the decode regime
__host__ __device__ constexpr int block_in(int bm) { return bm == 8 ? 128 : 32; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// byte j of a 32-bit word as a signed value
__device__ __forceinline__ float code(int w, int j) {
  return float((w << (24 - 8 * j)) >> 24);
}

template <typename T, int BM>
__global__ void __launch_bounds__(NT) qmm_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w8,
    const float* __restrict__ scale, T* __restrict__ y,
    float* __restrict__ work, int rows, int d_in, int d_out, int per_split) {
  constexpr int BK = block_in(BM);
  constexpr int RM = BM / 8;          // token rows per thread
  constexpr int XL = BM * BK / NT;    // x elements each thread loads a tile
  constexpr int WL = BK * BN / 16 / NT;  // 16-byte weight loads a tile
  __shared__ float xs[BK][BM + 1];    // x tile, input-major; pad: no conflicts
  __shared__ __align__(16) int8_t ws[BK][BN];  // weight codes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int ntiles = (d_in + BK - 1) / BK;
  const int t_begin = blockIdx.z * per_split;
  const int t_end = min(ntiles, t_begin + per_split);

  // this thread's weight loads: rows wr + 32 i of the tile, 16 columns
  // from wc
  const int wr = tid >> 3, wc = col0 + (tid & 7) * 16;
  int4 wreg[WL];
  float xreg[XL];
  auto load = [&](int tile) {
    const int k0 = tile * BK;
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int gk = k0 + wr + i * (NT / 8);
      wreg[i] = (gk < d_in && wc < d_out)
                    ? __ldg(reinterpret_cast<const int4*>(
                          w8 + size_t(gk) * d_out + wc))
                    : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int idx = tid + i * NT, r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gkx = k0 + kk;
      xreg[i] = (gr < rows && gkx < d_in) ? to_f32(x[size_t(gr) * d_in + gkx]) : 0.f;
    }
  };

  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (t_begin < t_end) load(t_begin);
  for (int tile = t_begin; tile < t_end; ++tile) {
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
    if (tile + 1 < t_end) load(tile + 1);  // in flight while we multiply

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
        store(y + size_t(row) * d_out + col, acc[r][c] * scale[col]);
      else
        work[(size_t(blockIdx.z) * rows + row) * d_out + col] = acc[r][c];
    }
  }
}

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

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w8, const float* scale, void* y,
                   float* work, int rows, int d_in, int d_out, int splits,
                   int per_split, cudaStream_t stream) {
  const int row_blocks = (rows + BM - 1) / BM;
  if (row_blocks > 65535 || splits > 65535 ||
      (long long)splits * per_split * block_in(BM) < d_in)
    return cudaErrorInvalidValue;
  const dim3 grid((d_out + BN - 1) / BN, row_blocks, splits);
  qmm_kernel<T, BM><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w8), scale,
      static_cast<T*>(y), work, rows, d_in, d_out, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || work == nullptr) return err;
  const size_t n = size_t(rows) * d_out;
  const int blocks = int((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  qmm_reduce<T><<<blocks, 256, 0, stream>>>(work, scale, static_cast<T*>(y),
                                            rows, d_out, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int block_rows, const void* x, const void* w8,
                          const float* scale, void* y, float* work, int rows,
                          int d_in, int d_out, int splits, int per_split,
                          cudaStream_t s) {
  switch (block_rows) {
    case 8: return launch<T, 8>(x, w8, scale, y, work, rows, d_in, d_out, splits, per_split, s);
    case 64: return launch<T, 64>(x, w8, scale, y, work, rows, d_in, d_out, splits, per_split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K7's grid for a (rows, d_in) x (d_in, d_out) product on a card of
// `sm_count` SMs, written to plan[0..2]: rows per block, input splits,
// input tiles per split.  Few output blocks (decode: 8 rows and 2048
// outputs are 16 blocks) split the input dimension until about
// BLOCKS_PER_SM blocks run on each SM; the caller sizes the splits' f32
// scratch (splits, rows, d_out) from it when splits > 1.
extern "C" void fcsa_qmm_plan(int rows, int d_in, int d_out, int sm_count,
                              int* plan) {
  const int bm = rows <= SMALL_ROWS ? 8 : 64;
  const long long blocks =
      (long long)((d_out + BN - 1) / BN) * ((rows + bm - 1) / bm);
  const long long target = (long long)BLOCKS_PER_SM * (sm_count > 0 ? sm_count : 1);
  const int tiles = d_in > 0 ? (d_in + block_in(bm) - 1) / block_in(bm) : 1;
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
// fcsa_qmm_plan's: split z covers input tiles [z * per_split, (z + 1) *
// per_split) of block_in(block_rows) rows.  Returns the
// cudaGetLastError() after the launches (0 = success).
extern "C" int fcsa_qmm(const void* x, const void* w8, const void* scale,
                        void* y, void* work, int dtype, int rows, int d_in,
                        int d_out, int block_rows, int splits, int per_split,
                        void* stream) {
  if (rows <= 0 || d_in <= 0 || d_out <= 0 || d_out % 16 != 0 ||
      splits < 1 || per_split < 1 || (splits > 1) != (work != nullptr) ||
      reinterpret_cast<uintptr_t>(w8) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  auto* wk = static_cast<float*>(work);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_rows<float>(block_rows, x, w8, sc, y, wk, rows, d_in, d_out, splits, per_split, s);
  else if (dtype == 1)
    err = dispatch_rows<__nv_bfloat16>(block_rows, x, w8, sc, y, wk, rows, d_in, d_out, splits, per_split, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}
