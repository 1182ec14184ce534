// Fused cosine-sim attention backward for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels of flash_cosine_sim_attention_tpu/ops/bwd_kernel.py:
//   fcsa_bwd_onepass  K2   `_fused_bwd_kernel_t`  dQ, dK, dV in one sweep
//   fcsa_bwd_dq       K3a  `_dq_kernel_t`         dQ, and dB summed over the
//                                                 bias's shared axis
//   fcsa_bwd_dkdv     K3b  `_dkdv_kernel_t`       dK, dV
// K2 and K3b share one template (dkdv_kernel); K2 adds the dQ sweep.
//
// Maths (the JAX forward's convention: no row max, no "- scale" shift).
// The wrapper hands in dO' = dO * inv_l (rounded back to dO's dtype) and
// delta' = rowsum(dO * O) * inv_l in f32, so P = e * inv_l never forms:
//     e   = exp2(log2e * (scale * q.k + bias))
//     dP' = dO' . v^T
//     dS  = e * (dP' - delta')
//     dV += e^T dO'          dK += scale * dS^T q
//     dQ += scale * dS k     dB += dS (no scale)
// An entry that is out of range, causally hidden or key-masked contributes
// exactly 0: its e and dS are selected to 0 and never computed, and every
// out-of-range row of a tile loads as 0, so no garbage reaches a sum.
//
// Ownership on a card whose blocks run in parallel and in no order:
// - dkdv_kernel: one block per (batch, kv head, BK keys) owns its dK, dV
//   rows in registers and loops over the kv head's whole query-head group
//   and the q tiles that can see its keys, so GQA/MQA need no atomics and
//   no per-query-head outputs.  K2 (DQ = true) also forms dS . K for each
//   q tile and adds it to an f32 (B, H, seq_q, d) scratch with atomicAdd,
//   as the original CUDA kernel did; the TPU kernel avoided atomics by
//   keeping the whole q extent resident in VMEM, which does not fit in
//   227 KB of shared memory.  The wrapper zeroes the scratch and scales
//   and casts it afterwards.  The atomics' order varies from run to run.
// - dq_kernel: one block per (batch, head, BQ queries) owns its dQ rows
//   and loops over the keys they can see.  With a bias it adds each dS
//   entry to an f32 (B|H, seq_q, seq_k) dB scratch with atomicAdd: the
//   shared axis (batch for an (h, i, j) bias, heads for a (b, i, j) one)
//   is summed by the blocks that share a bias slice, so there is no cap
//   on its length (the TPU kernel capped it at 16 for VMEM).
//
// Bound on the H100 at the trainer's shape (b4 h8 s1024 d64 causal bf16):
// K2 does 5 products of 2d FLOPs per visible (i, j) pair, ~10.7 GFLOP,
// ~10.9 us at the bf16 tensor-core rate, against ~34 MB of bf16 q, k, v,
// dO', dK, dV plus delta' and the f32 dQ scratch (~10 us at 3.35 TB/s):
// operations bound.  This first port is ~55x that (PERF.md, measured by
// chip_smoke.py): like the forward kernel it runs every product as f32 FMAs out
// of shared memory (tiles widened to f32 once at load, rows padded by one
// column against bank conflicts), keeps e and dS in f32, and leaves the
// tensor cores idle.  mma.sync / wgmma tiles are the later, fast version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads: 16 row groups of 4 rows x 16 lanes
constexpr int PP = BK + 1;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Params {
  const void* q;        // (B, H, seq_q, d)
  const void* k;        // (B, KVH, seq_k, d)
  const void* v;        // (B, KVH, seq_k, d)
  const void* dO;       // (B, H, seq_q, d), pre-scaled by inv_l
  const float* delta;   // (B, H, seq_q), rowsum(dO * O) * inv_l
  const uint8_t* mask;  // (B, seq_k) or null
  const float* bias;    // (B|H, seq_q, seq_k) or null
  void* dq;             // (B, H, seq_q, d)            dq_kernel
  float* dq_acc;        // (B, H, seq_q, d) f32, zeroed K2's scratch
  void* dk;             // (B, KVH, seq_k, d)          dkdv_kernel
  void* dv;
  float* db;            // (B|H, seq_q, seq_k) f32, zeroed, or null
  int H, KVH, seq_q, seq_k, causal, bias_batch_dim;
  float scale, c;       // c = scale * log2e
};

template <int D>
constexpr size_t smem_bytes() {
  // q, dO, k, v tiles with one pad column; e and dS tiles; delta'
  return sizeof(float) * (2 * size_t(BQ) * (D + 1) + 2 * size_t(BK) * (D + 1) +
                          2 * size_t(BQ) * PP + BQ);
}

// rows [row0, row0 + rows) of a (*, D) tensor into a padded f32 tile;
// rows at or past `end` load as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int end, int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, cc = idx % D, row = row0 + r;
    dst[r * (D + 1) + cc] = row < end ? to_f32(src[size_t(row) * D + cc]) : 0.f;
  }
}

// One (BQ queries) x (BK keys) tile: s = q.k and dP' = dO'.v^T, then e and
// dS with every hidden entry at 0.  Writes e to `es` (if given) and dS to
// `dss`, both [query][key]; adds dS to `db` (if given) at (row, col).
// Thread (ty, tx) holds rows ty*4 + r and columns tx + 16*cc.
template <int D>
__device__ __forceinline__ void score_tile(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* dl, float* es, float* dss, int q0, int k0, const Params& p,
    const uint8_t* mb, const float* bb, float* db) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) s[r][cc] = dp[r][cc] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float a[4], g[4], b[4], w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = qs[(ty * 4 + r) * DP + dd];
      g[r] = dos[(ty * 4 + r) * DP + dd];
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      b[cc] = ks[(tx + 16 * cc) * DP + dd];
      w[cc] = vs[(tx + 16 * cc) * DP + dd];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        s[r][cc] = fmaf(a[r], b[cc], s[r][cc]);
        dp[r][cc] = fmaf(g[r], w[cc], dp[r][cc]);
      }
  }
  const int diff = p.seq_k - p.seq_q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = ty * 4 + r, row = q0 + lr;
    const float dlt = dl[lr];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int lc = tx + 16 * cc, col = k0 + lc;
      bool keep = row < p.seq_q && col < p.seq_k;
      if (p.causal) keep = keep && col <= row + diff;
      if (mb != nullptr && keep) keep = mb[col] != 0;
      float e = 0.f, ds = 0.f;
      if (keep) {
        float x = s[r][cc] * p.c;
        if (bb != nullptr) x += bb[size_t(row) * p.seq_k + col] * LOG2E;
        e = exp2f(x);
        ds = e * (dp[r][cc] - dlt);
        if (db != nullptr) atomicAdd(db + size_t(row) * p.seq_k + col, ds);
      }
      if (es != nullptr) es[lr * PP + lc] = e;
      dss[lr * PP + lc] = ds;
    }
  }
}

// K2 (DQ = true) and K3b (DQ = false): grid (key tiles, KVH, B).
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(NT) dkdv_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x DP
  float* dos = qs + BQ * DP;   // BQ x DP
  float* ks = dos + BQ * DP;   // BK x DP
  float* vs = ks + BK * DP;    // BK x DP
  float* es = vs + BK * DP;    // BQ x PP
  float* dss = es + BQ * PP;   // BQ x PP
  float* dl = dss + BQ * PP;   // BQ

  const int bi = blockIdx.z, kvhi = blockIdx.y, k0 = blockIdx.x * BK;
  const int G = p.H / p.KVH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t kvoff = (size_t(bi) * p.KVH + kvhi) * p.seq_k * D;
  load_tile<T, D>(ks, static_cast<const T*>(p.k) + kvoff, k0, p.seq_k, BK);
  load_tile<T, D>(vs, static_cast<const T*>(p.v) + kvoff, k0, p.seq_k, BK);
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) adk[r][cc] = adv[r][cc] = 0.f;

  // the first query row that sees key k0 (causal: col <= row + diff)
  const int qfirst = p.causal ? max(0, k0 - (p.seq_k - p.seq_q)) : 0;
  const int nq = (p.seq_q + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int hi = kvhi * G + g;
    const size_t qrow0 = (size_t(bi) * p.H + hi) * p.seq_q;
    const T* qb = static_cast<const T*>(p.q) + qrow0 * D;
    const T* dob = static_cast<const T*>(p.dO) + qrow0 * D;
    const float* bb =
        p.bias ? p.bias + size_t(p.bias_batch_dim ? bi : hi) * p.seq_q * p.seq_k
               : nullptr;
    for (int qt = qfirst / BQ; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(qs, qb, q0, p.seq_q, BQ);
      load_tile<T, D>(dos, dob, q0, p.seq_q, BQ);
      for (int i = threadIdx.x; i < BQ; i += NT)
        dl[i] = q0 + i < p.seq_q ? p.delta[qrow0 + q0 + i] : 0.f;
      __syncthreads();
      score_tile<D>(qs, dos, ks, vs, dl, es, dss, q0, k0, p, mb, bb, nullptr);
      __syncthreads();

      // dV += e^T dO', dK += dS^T q: contraction over the tile's queries
#pragma unroll 4
      for (int ii = 0; ii < BQ; ++ii) {
        float e[4], ds[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          e[r] = es[ii * PP + ty * 4 + r];
          ds[r] = dss[ii * PP + ty * 4 + r];
        }
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const float o = dos[ii * DP + tx + 16 * cc];
          const float qv = qs[ii * DP + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            adv[r][cc] = fmaf(e[r], o, adv[r][cc]);
            adk[r][cc] = fmaf(ds[r], qv, adk[r][cc]);
          }
        }
      }

      if constexpr (DQ) {
        // dQ += dS k for this tile's queries, added across key blocks
        float aq[4][DC];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) aq[r][cc] = 0.f;
#pragma unroll 4
        for (int jj = 0; jj < BK; ++jj) {
          float a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = dss[(ty * 4 + r) * PP + jj];
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) {
            const float kv = ks[jj * DP + tx + 16 * cc];
#pragma unroll
            for (int r = 0; r < 4; ++r) aq[r][cc] = fmaf(a[r], kv, aq[r][cc]);
          }
        }
        float* dqb = p.dq_acc + qrow0 * D;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = q0 + ty * 4 + r;
          if (row >= p.seq_q) continue;
#pragma unroll
          for (int cc = 0; cc < DC; ++cc)
            atomicAdd(dqb + size_t(row) * D + tx + 16 * cc, aq[r][cc]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + kvoff;
  T* dvb = static_cast<T*>(p.dv) + kvoff;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int col = k0 + ty * 4 + r;
    if (col >= p.seq_k) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      store(dkb + size_t(col) * D + tx + 16 * cc, adk[r][cc] * p.scale);
      store(dvb + size_t(col) * D + tx + 16 * cc, adv[r][cc]);
    }
  }
}

// K3a: grid (query tiles, H, B).
template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * DP;
  float* ks = dos + BQ * DP;
  float* vs = ks + BK * DP;
  float* dss = vs + BK * DP + BQ * PP;  // the e tile's room stays unused
  float* dl = dss + BQ * PP;

  const int bi = blockIdx.z, hi = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvhi = hi / (p.H / p.KVH);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qrow0 = (size_t(bi) * p.H + hi) * p.seq_q;
  const size_t kvoff = (size_t(bi) * p.KVH + kvhi) * p.seq_k * D;
  load_tile<T, D>(qs, static_cast<const T*>(p.q) + qrow0 * D, q0, p.seq_q, BQ);
  load_tile<T, D>(dos, static_cast<const T*>(p.dO) + qrow0 * D, q0, p.seq_q, BQ);
  for (int i = threadIdx.x; i < BQ; i += NT)
    dl[i] = q0 + i < p.seq_q ? p.delta[qrow0 + q0 + i] : 0.f;
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;
  const size_t bslice = size_t(p.bias_batch_dim ? bi : hi) * p.seq_q * p.seq_k;
  const float* bb = p.bias ? p.bias + bslice : nullptr;
  float* db = p.db ? p.db + bslice : nullptr;

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + BQ, p.seq_q) - 1;
  const int kend =
      p.causal ? max(0, min(p.seq_k, last_row + p.seq_k - p.seq_q + 1)) : p.seq_k;
  const int nk = (kend + BK - 1) / BK;

  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[r][cc] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(ks, static_cast<const T*>(p.k) + kvoff, k0, p.seq_k, BK);
    load_tile<T, D>(vs, static_cast<const T*>(p.v) + kvoff, k0, p.seq_k, BK);
    __syncthreads();
    score_tile<D>(qs, dos, ks, vs, dl, nullptr, dss, q0, k0, p, mb, bb, db);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = dss[(ty * 4 + r) * PP + jj];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float kv = ks[jj * DP + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][cc] = fmaf(a[r], kv, acc[r][cc]);
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq) + qrow0 * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= p.seq_q) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      store(dqb + size_t(row) * D + tx + 16 * cc, acc[r][cc] * p.scale);
  }
}

enum Which { ONEPASS = 0, DQ = 1, DKDV = 2 };

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                   const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(Which which, const Params& p, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  const dim3 kgrid((p.seq_k + BK - 1) / BK, p.KVH, B);
  switch (which) {
    case ONEPASS: return launch(dkdv_kernel<T, D, true>, kgrid, smem, s, p);
    case DKDV: return launch(dkdv_kernel<T, D, false>, kgrid, smem, s, p);
    case DQ:
      return launch(dq_kernel<T, D>, dim3((p.seq_q + BQ - 1) / BQ, p.H, B),
                    smem, s, p);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_d(int d, Which which, const Params& p, int B, cudaStream_t s) {
  switch (d) {
    case 16: return run<T, 16>(which, p, B, s);
    case 32: return run<T, 32>(which, p, B, s);
    case 64: return run<T, 64>(which, p, B, s);
    case 96: return run<T, 96>(which, p, B, s);
    case 128: return run<T, 128>(which, p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(Which which, Params p, int dtype, int B, int d, void* stream) {
  if (B <= 0 || p.H <= 0 || p.KVH <= 0 || p.H % p.KVH != 0 || p.seq_q <= 0 ||
      p.seq_k <= 0)
    return int(cudaErrorInvalidValue);
  p.c = float(double(p.scale) * 1.4426950408889634);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(run_d<float>(d, which, p, B, s));
  if (dtype == 1) return int(run_d<__nv_bfloat16>(d, which, p, B, s));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the dq/dk/dv outputs
// share it).  All tensors contiguous, shapes as in Params; mask uint8 or
// null, bias f32 or null.  Each returns the cudaGetLastError() after its
// launch (0 = success).

// K2: dk, dv in the input dtype (dk scaled); dq_acc (B, H, seq_q, d) f32,
// zeroed by the caller, receives the unscaled sum of dS . k.
extern "C" int fcsa_bwd_onepass(const void* q, const void* k, const void* v,
                                const void* dO, const void* delta,
                                const void* mask, void* dq_acc, void* dk,
                                void* dv, int dtype, int B, int H, int KVH,
                                int seq_q, int seq_k, int d, int causal,
                                float scale, void* stream) {
  Params p{q, k, v, dO, static_cast<const float*>(delta),
           static_cast<const uint8_t*>(mask), nullptr, nullptr,
           static_cast<float*>(dq_acc), dk, dv, nullptr,
           H, KVH, seq_q, seq_k, causal, 0, scale, 0.f};
  return dispatch(ONEPASS, p, dtype, B, d, stream);
}

// K3a: dq in the input dtype (scaled); db (B|H, seq_q, seq_k) f32, zeroed
// by the caller, receives dB when a bias is given (null otherwise).
extern "C" int fcsa_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dO, const void* delta, const void* mask,
                           const void* bias, void* dq, void* db, int dtype,
                           int B, int H, int KVH, int seq_q, int seq_k, int d,
                           int causal, int bias_batch_dim, float scale,
                           void* stream) {
  Params p{q, k, v, dO, static_cast<const float*>(delta),
           static_cast<const uint8_t*>(mask), static_cast<const float*>(bias),
           dq, nullptr, nullptr, nullptr, static_cast<float*>(db),
           H, KVH, seq_q, seq_k, causal, bias_batch_dim, scale, 0.f};
  return dispatch(DQ, p, dtype, B, d, stream);
}

// K3b: dk (scaled), dv in the input dtype.
extern "C" int fcsa_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* dO, const void* delta,
                             const void* mask, const void* bias, void* dk,
                             void* dv, int dtype, int B, int H, int KVH,
                             int seq_q, int seq_k, int d, int causal,
                             int bias_batch_dim, float scale, void* stream) {
  Params p{q, k, v, dO, static_cast<const float*>(delta),
           static_cast<const uint8_t*>(mask), static_cast<const float*>(bias),
           nullptr, nullptr, dk, dv, nullptr,
           H, KVH, seq_q, seq_k, causal, bias_batch_dim, scale, 0.f};
  return dispatch(DKDV, p, dtype, B, d, stream);
}
