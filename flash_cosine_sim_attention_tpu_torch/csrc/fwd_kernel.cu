// Fused cosine-sim attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel_t` of
// flash_cosine_sim_attention_tpu/ops/fwd_kernel.py (launched there by
// `_forward_transposed`).  Same maths: q and k arrive l2-normalized, so
// every logit is bounded by `scale` (plus the bias) and the kernel needs no
// running row max.  Each key tile adds
//     e = exp2(log2e * (scale * q.k + bias))      (no "- scale" shift)
// to O = sum(e * v) and l = sum(e) in float32, and the block writes
//     inv_l = 1 / max(l, 1e-10),  o = O * inv_l.
// `inv_l` is returned because chunked prefill merges two partial
// attentions by their row sums 1/inv_l, so it must equal the JAX forward's.
// A row that sees no key returns o = 0 and inv_l = 1e10.
//
// Without the shift e reaches e^(scale + bias): at the served model's
// scale 1 with 8 l2norm groups that is e^8.  The P tile stays in float32
// here; a half-precision P tile would overflow past scale + bias > 11.09.
//
// Bound on the H100: at the serving shapes (b1 h8 s1024 d64 causal bf16)
// the work is ~1.07 GFLOP over ~4.2 MB, far above the card's ~295 FLOP/B
// ridge, so the bound is the tensor-core rate (~1.1 us).  This first port
// does not reach it: one 128-thread block per (batch, head, 64 query rows)
// runs both products as float32 FMAs out of shared memory (q, k, v tiles
// converted to f32 once at load; padded rows avoid bank conflicts).  That
// keeps f32 inputs at full f32 precision (no TF32) and bf16 inputs exact
// up to the f32 sums.  wgmma/TMA tiles are the later, fast version.
//
// Masking: causal keeps key col <= row + (seq_k - seq_q) (cross-attention
// alignment) and the loop stops at the last tile a row of the block can
// see; an optional (b, j) key mask and the ragged edges select e = 0, and
// out-of-range k/v rows load as 0, so no 0 * garbage NaN can reach O.
// GQA: query head h reads kv head h / (H / KVH).  Bias: (b|h, i, j) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block (ops/blocks.py FWD_BLOCK_Q)
constexpr int BK = 64;   // keys per tile (ops/blocks.py FWD_BLOCK_K)
constexpr int NT = 128;  // threads: 16 row groups of 4 rows x 8 column lanes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EPS = 1e-10f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr size_t smem_bytes() {
  // q tile and k tile with one pad column, v tile, P tile with one pad column
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) +
                          size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const float* __restrict__ bias,
    T* __restrict__ o, float* __restrict__ inv_l, int H, int KVH, int seq_q,
    int seq_k, int causal, int bias_batch_dim, float c) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DC = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;          // BQ x DP, pre-multiplied by scale * log2e
  float* ks = qs + BQ * DP;  // BK x DP
  float* vs = ks + BK * DP;  // BK x D
  float* ps = vs + BK * D;   // BQ x PP exp weights

  const int bi = blockIdx.z, hi = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvhi = hi / (H / KVH);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int diff = seq_k - seq_q;

  const T* qb = q + (size_t(bi) * H + hi) * seq_q * D;
  const T* kb = k + (size_t(bi) * KVH + kvhi) * seq_k * D;
  const T* vb = v + (size_t(bi) * KVH + kvhi) * seq_k * D;
  const uint8_t* mb = mask ? mask + size_t(bi) * seq_k : nullptr;
  const float* bb =
      bias ? bias + size_t(bias_batch_dim ? bi : hi) * seq_q * seq_k : nullptr;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, cc = idx % D, row = q0 + r;
    qs[r * DP + cc] = row < seq_q ? to_f32(qb[size_t(row) * D + cc]) * c : 0.f;
  }

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + BQ, seq_q) - 1;
  const int kend = causal ? max(0, min(seq_k, last_row + diff + 1)) : seq_k;
  const int nk = (kend + BK - 1) / BK;

  float acc[4][DC];
  float lsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lsum[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[r][cc] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done with ks/vs/ps
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, cc = idx % D, col = k0 + r;
      const bool in = col < seq_k;
      ks[r * DP + cc] = in ? to_f32(kb[size_t(col) * D + cc]) : 0.f;
      vs[r * D + cc] = in ? to_f32(vb[size_t(col) * D + cc]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) s[r][cc] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float a[4], b[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[(ty * 4 + r) * DP + dd];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) b[cc] = ks[(tx + 8 * cc) * DP + dd];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) s[r][cc] = fmaf(a[r], b[cc], s[r][cc]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int col = k0 + tx + 8 * cc;
        bool keep = row < seq_q && col < seq_k;
        if (causal) keep = keep && col <= row + diff;
        if (mb != nullptr) keep = keep && mb[min(col, seq_k - 1)] != 0;
        float x = s[r][cc];
        if (bb != nullptr && keep) x += bb[size_t(row) * seq_k + col] * LOG2E;
        const float e = keep ? exp2f(x) : 0.f;
        lsum[r] += e;
        ps[(ty * 4 + r) * PP + tx + 8 * cc] = e;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = ps[(ty * 4 + r) * PP + kk];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = vs[kk * D + tx + 8 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][cc] = fmaf(p[r], vv, acc[r][cc]);
      }
    }
  }

  // the 8 lanes of a row group are consecutive lanes of one warp
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], off);
  }
  T* ob = o + (size_t(bi) * H + hi) * seq_q * D;
  float* lb = inv_l + (size_t(bi) * H + hi) * seq_q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= seq_q) continue;
    const float inv = 1.f / fmaxf(lsum[r], EPS);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      store(ob + size_t(row) * D + tx + 8 * cc, acc[r][cc] * inv);
    if (tx == 0) lb[row] = inv;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, const float* bias, void* o,
                   float* inv_l, int B, int H, int KVH, int seq_q, int seq_k,
                   int causal, int bias_batch_dim, float c,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + BQ - 1) / BQ, H, B);
  fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, bias, static_cast<T*>(o), inv_l, H, KVH,
      seq_q, seq_k, causal, bias_batch_dim, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const uint8_t* mask, const float* bias, void* o,
                       float* inv_l, int B, int H, int KVH, int seq_q,
                       int seq_k, int causal, int bias_batch_dim, float c,
                       cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    case 32: return launch<T, 32>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    case 64: return launch<T, 64>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    case 96: return launch<T, 96>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    case 128: return launch<T, 128>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  All tensors
// contiguous: q/o (B, H, seq_q, d), k/v (B, KVH, seq_k, d), mask (B, seq_k)
// uint8 or null, bias (B|H, seq_q, seq_k) f32 or null, inv_l (B, H, seq_q)
// f32.  Returns the cudaGetLastError() after the launch (0 = success).
extern "C" int fcsa_fwd(const void* q, const void* k, const void* v,
                        const void* mask, const void* bias, void* o,
                        void* inv_l, int dtype, int B, int H, int KVH,
                        int seq_q, int seq_k, int d, int causal,
                        int bias_batch_dim, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || seq_q <= 0 || seq_k <= 0)
    return int(cudaErrorInvalidValue);
  const float c = float(double(scale) * 1.4426950408889634);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* bs = static_cast<const float*>(bias);
  auto* l = static_cast<float*>(inv_l);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, m, bs, o, l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, m, bs, o, l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}
