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
//
// The int8 arm (the TPU kernel's int8 q/k path, `_fwd_kernel_t` with
// `s_dequant`): q and k arrive as int8 codes of the l2-normalized values
// at the fixed scale 127, v in float32 or bfloat16, and o comes out in v's
// dtype.  The q and k tiles stay int8 in shared memory, packed four codes
// to a word, and each logit's dot product is an exact int32 sum of
// `__dp4a` products (|sum| <= 127^2 * 128 < 2^24, so its float is exact
// too).  The logit is then s_int * (scale * log2e * s_dequant) in float32,
// with the float arms' exp convention, masks, bias and GQA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

template <typename TQ>
__host__ __device__ constexpr bool is_int8() { return std::is_same<TQ, int8_t>::value; }

// 4-byte words per q / k row in shared memory, one pad word included:
// float values, or int8 codes packed four to a word
template <typename TQ, int D>
__host__ __device__ constexpr int qk_row() { return is_int8<TQ>() ? D / 4 + 1 : D + 1; }

template <typename TQ, int D>
constexpr size_t smem_bytes() {
  // q tile, k tile, v tile, P tile with one pad column
  return 4 * (size_t(BQ) * qk_row<TQ, D>() + size_t(BK) * qk_row<TQ, D>() +
              size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <typename TQ, typename TV, int D>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k, const TV* __restrict__ v,
    const uint8_t* __restrict__ mask, const float* __restrict__ bias,
    TV* __restrict__ o, float* __restrict__ inv_l, int H, int KVH, int seq_q,
    int seq_k, int causal, int bias_batch_dim, float c) {
  constexpr bool Q8 = is_int8<TQ>();
  constexpr int QR = qk_row<TQ, D>();
  constexpr int DW = D / 4;  // int8 codes: words per row
  constexpr int PP = BK + 1;
  constexpr int DC = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;          // BQ x QR; float: pre-multiplied by c
  float* ks = qs + BQ * QR;  // BK x QR
  float* vs = ks + BK * QR;  // BK x D
  float* ps = vs + BK * D;   // BQ x PP exp weights
  int* qw = reinterpret_cast<int*>(qs);  // int8 arm: packed codes
  int* kw = reinterpret_cast<int*>(ks);

  const int bi = blockIdx.z, hi = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvhi = hi / (H / KVH);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int diff = seq_k - seq_q;

  const TQ* qb = q + (size_t(bi) * H + hi) * seq_q * D;
  const TQ* kb = k + (size_t(bi) * KVH + kvhi) * seq_k * D;
  const TV* vb = v + (size_t(bi) * KVH + kvhi) * seq_k * D;
  const uint8_t* mb = mask ? mask + size_t(bi) * seq_k : nullptr;
  const float* bb =
      bias ? bias + size_t(bias_batch_dim ? bi : hi) * seq_q * seq_k : nullptr;

  if constexpr (Q8) {
    const int* qb4 = reinterpret_cast<const int*>(qb);
    for (int idx = tid; idx < BQ * DW; idx += NT) {
      const int r = idx / DW, w = idx % DW, row = q0 + r;
      qw[r * QR + w] = row < seq_q ? qb4[size_t(row) * DW + w] : 0;
    }
  } else {
    for (int idx = tid; idx < BQ * D; idx += NT) {
      const int r = idx / D, cc = idx % D, row = q0 + r;
      qs[r * QR + cc] = row < seq_q ? to_f32(qb[size_t(row) * D + cc]) * c : 0.f;
    }
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
      if constexpr (!Q8)
        ks[r * QR + cc] = in ? to_f32(kb[size_t(col) * D + cc]) : 0.f;
      vs[r * D + cc] = in ? to_f32(vb[size_t(col) * D + cc]) : 0.f;
    }
    if constexpr (Q8) {
      const int* kb4 = reinterpret_cast<const int*>(kb);
      for (int idx = tid; idx < BK * DW; idx += NT) {
        const int r = idx / DW, w = idx % DW, col = k0 + r;
        kw[r * QR + w] = col < seq_k ? kb4[size_t(col) * DW + w] : 0;
      }
    }
    __syncthreads();

    float s[4][8];
    if constexpr (Q8) {
      int si[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) si[r][cc] = 0;
#pragma unroll 4
      for (int dd = 0; dd < DW; ++dd) {
        int a[4], b[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qw[(ty * 4 + r) * QR + dd];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) b[cc] = kw[(tx + 8 * cc) * QR + dd];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) si[r][cc] = __dp4a(a[r], b[cc], si[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) s[r][cc] = float(si[r][cc]) * c;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) s[r][cc] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        float a[4], b[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[(ty * 4 + r) * QR + dd];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) b[cc] = ks[(tx + 8 * cc) * QR + dd];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) s[r][cc] = fmaf(a[r], b[cc], s[r][cc]);
      }
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
  TV* ob = o + (size_t(bi) * H + hi) * seq_q * D;
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

template <typename TQ, typename TV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, const float* bias, void* o,
                   float* inv_l, int B, int H, int KVH, int seq_q, int seq_k,
                   int causal, int bias_batch_dim, float c,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TQ, D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<TQ, TV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + BQ - 1) / BQ, H, B);
  fwd_kernel<TQ, TV, D><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const TV*>(v), mask, bias, static_cast<TV*>(o), inv_l, H,
      KVH, seq_q, seq_k, causal, bias_batch_dim, c);
  return cudaGetLastError();
}

template <typename TQ, typename TV>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const uint8_t* mask, const float* bias, void* o,
                       float* inv_l, int B, int H, int KVH, int seq_q,
                       int seq_k, int causal, int bias_batch_dim, float c,
                       cudaStream_t s) {
  switch (d) {
    case 16: return launch<TQ, TV, 16>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    case 32: return launch<TQ, TV, 32>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    case 64: return launch<TQ, TV, 64>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    case 96: return launch<TQ, TV, 96>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    case 128: return launch<TQ, TV, 128>(q, k, v, mask, bias, o, inv_l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); 2 = int8 q/k
// codes with float32 v and o; 3 = int8 q/k codes with bfloat16 v and o.
// All tensors contiguous: q/o (B, H, seq_q, d), k/v (B, KVH, seq_k, d),
// mask (B, seq_k) uint8 or null, bias (B|H, seq_q, seq_k) f32 or null,
// inv_l (B, H, seq_q) f32.  The logits are scale * s_dequant * q.k (int8
// arms; s_dequant = 1 for the float ones).  Returns the cudaGetLastError()
// after the launch (0 = success).
extern "C" int fcsa_fwd(const void* q, const void* k, const void* v,
                        const void* mask, const void* bias, void* o,
                        void* inv_l, int dtype, int B, int H, int KVH,
                        int seq_q, int seq_k, int d, int causal,
                        int bias_batch_dim, float scale, float s_dequant,
                        void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || seq_q <= 0 || seq_k <= 0)
    return int(cudaErrorInvalidValue);
  const float c = float(double(scale) * 1.4426950408889634);
  const float c8 = float(double(scale) * 1.4426950408889634 * s_dequant);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* bs = static_cast<const float*>(bias);
  auto* l = static_cast<float*>(inv_l);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch_d<float, float>(d, q, k, v, m, bs, o, l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s); break;
    case 1: err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, q, k, v, m, bs, o, l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c, s); break;
    case 2: err = dispatch_d<int8_t, float>(d, q, k, v, m, bs, o, l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c8, s); break;
    case 3: err = dispatch_d<int8_t, __nv_bfloat16>(d, q, k, v, m, bs, o, l, B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c8, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return int(err);
}
