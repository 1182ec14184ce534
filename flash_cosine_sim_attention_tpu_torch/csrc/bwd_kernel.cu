// Fused cosine-sim attention backward for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels of flash_cosine_sim_attention_tpu/ops/bwd_kernel.py:
//   fcsa_bwd_onepass  K2   `_fused_bwd_kernel_t`  dQ, dK, dV in one sweep
//   fcsa_bwd_dq       K3a  `_dq_kernel_t`         dQ, and dB summed over the
//                                                 bias's shared axis
//   fcsa_bwd_dkdv     K3b  `_dkdv_kernel_t`       dK, dV
// K2 and K3b share one template (dkdv_mma_kernel for bf16 on the tensor
// cores, dkdv_kernel for f32 on FMAs); K2 adds the dQ sweep.
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
// - the dK/dV kernels (K2 and K3b): one block per (batch, kv head, 64
//   keys) owns its dK, dV rows in registers and loops over the kv head's
//   whole query-head group and the q tiles that can see its keys, so
//   GQA/MQA need no atomics and no per-query-head outputs.  K2 (DQ = true)
//   also forms dS . K for each q tile and adds it to an f32 (B, H, seq_q,
//   d) scratch with atomics, as the original CUDA kernel did; the TPU
//   kernel avoided atomics by keeping the whole q extent resident in VMEM,
//   which does not fit in 227 KB of shared memory.  The wrapper zeroes the
//   scratch and scales and casts it afterwards.  The atomics' order varies
//   from run to run.
// - dq_kernel (K3a): one block per (batch, head, BQ queries) owns its dQ
//   rows and loops over the keys they can see.  With a bias it adds each
//   dS entry to an f32 (B|H, seq_q, seq_k) dB scratch with atomicAdd: the
//   shared axis (batch for an (h, i, j) bias, heads for a (b, i, j) one)
//   is summed by the blocks that share a bias slice, so there is no cap
//   on its length (the TPU kernel capped it at 16 for VMEM).
//
// Bound on the H100 at the trainer's shape (b4 h8 s1024 d64 causal bf16):
// K2's maths is 5 products of 2d FLOPs per visible (i, j) pair, ~10.7 GFLOP,
// ~10.9 us at the bf16 tensor-core rate, against ~34 MB of bf16 q, k, v,
// dO', dK, dV plus delta' and the f32 dQ scratch (~10 us at 3.35 TB/s):
// operations bound.  Beside both, K2's dQ adds are ~17.8 M f32 reductions
// (136 visible 64 x 64 tile pairs per head, 64 x 64 each) into an 8.4 MB
// scratch that stays in the 50 MB L2.  K3b (with an (h, i, j) bias) does
// 4 of the products and reads the visible half of the f32 bias (~17 MB).
//
// bfloat16 inputs run the tensor-core kernel `dkdv_mma_kernel`, the
// FlashAttention-2 backward reshaped for this op (no row max, JAX's exp2
// convention, the prescaled dO' and delta').  4 warps of 128 threads, each
// warp owning 16 of the block's 64 keys.  K and V arrive once by cp.async
// and stay in shared memory: their A fragments are read by ldmatrix per q
// tile, since in registers they would cost 64 more at d 128 beside dK's
// and dV's 128 accumulators.  Q, dO' and delta' tiles (64 queries; 32
// above d 64 and 16 for K3b at d 128, which keeps the S tiles and the
// accumulators within 255 registers) stream through a double-buffered
// cp.async ring.  Per tile:
// S^T = K.Q^T and dP^T = V.dO'^T by mma.sync m16n8k16 with f32 sums;
// e^T = exp2(c s + bias log2e), hidden entries selected to exact 0 (the
// masks are skipped on tiles every pair of which is visible);
// dS^T = e^T (dP^T - delta'); then dV += e^T.dO' and dK += dS^T.Q, the C
// fragments of e^T and dS^T turned into A fragments in registers, dO' and
// Q read by ldmatrix.trans.  K2 then stages dS^T in shared memory, and
// after a barrier each warp forms 16 query rows of dS.K (all d, or half
// of d at the 32-query tiles) and adds them to the scratch with float2
// atomics (red.global.add.v2.f32).  K3b stages each tile's bias (64 keys
// of BQ query rows, f32) through the same cp.async ring, so tiles that
// every pair of sees whole skip the masks with a bias too.  Causal blocks
// run heaviest first: key tiles are the grid's slowest axis, low keys
// (seen by the most queries) first.
//
// e and dS enter the dV, dK and dQ products as two bf16 operands each, hi
// = bf16(x) and lo = bf16(x - hi), so the products see them to ~16 bits
// (8 products of 2d FLOPs per visible pair for K2 instead of 5).  The JAX
// kernels round them to bf16 once; on the card that moves a gradient entry
// by up to a bf16 ulp of its largest term, and for the early keys of a
// causal row (a few large terms that cancel) that broke the 2^-7 of
// |g| + rms(g) bar against the f32 plain version (on an H100: 0.0195 on dV
// at b1 h8/2 s1024 d128; the plain version itself moves 0.0104 when the
// scale moves by 2^-21).
//
// float32 inputs keep the FMA kernel `dkdv_kernel`, and K3a stays FMA code
// for both dtypes: every product is an f32 FMA out of shared memory (tiles
// widened to f32 once at load, rows padded by one column against bank
// conflicts), with e and dS in f32.  The f32 instances hold a 1e-4 bar
// against the plain version that bf16 tensor cores cannot meet without
// the 3-pass split of the JAX package; K3a (with its per-entry dB atomics)
// is the next kernel to move to the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mma_common.cuh"

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

// K2 (DQ = true) and K3b (DQ = false) on f32 FMAs: grid (key tiles, KVH, B).
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

// ---------------------------------------------------------------------------
// Tensor-core dK/dV kernel (bf16): K2 (DQ = true) and K3b (DQ = false).
// Grid (KVH, B, key tiles); MNT threads, warp w owning keys k0 + 16w ..

constexpr int MW = 4;          // warps
constexpr int MBK = 16 * MW;   // keys per block
constexpr int MNT = 32 * MW;   // threads

template <int D, bool DQ>
struct MmaLayout {
  // queries per tile: fewer at larger d keep the S tiles and the
  // accumulators within 255 registers (K3b's bias path needs 16 at d 128)
  static constexpr int BQ = D <= 64 ? 64 : (DQ || D <= 96 ? 32 : 16);
  static constexpr int RS = 2 * D + 16;        // bf16 row stride, bytes: an
  static constexpr int SS = 2 * BQ + 16;       // odd count of 16-byte units,
                                               // so ldmatrix rows hit 8 banks
  static constexpr int BS = MBK + 4;           // bias row stride, floats:
                                               // 2 rows apart = 8 banks
  static constexpr size_t KV = size_t(MBK) * RS;  // the K or V tile
  static constexpr size_t QT = size_t(BQ) * RS;   // one Q or dO' tile
  // K, V; two Q and two dO' tiles; two delta' rows; then K2's dS^T hi and
  // lo tiles, or K3b's two bias tiles (BQ queries x 64 keys, f32)
  static constexpr size_t BASE = 2 * KV + 4 * QT + 2 * BQ * sizeof(float);
  static constexpr size_t DST = 2 * size_t(MBK) * SS;
  static constexpr size_t BIAS = 2 * size_t(BQ) * BS * sizeof(float);
};

// Two f32 values as bf16 pairs hi (x rounded) and lo (x - hi rounded): a
// product that takes both sees x to ~16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The A fragments (hi, lo) of k16 step j from the C fragments of n8 tiles
// 2j and 2j + 1 of a (16 x BQ) f32 tile
template <int NQ>
__device__ __forceinline__ void split_a(const float (&c)[NQ][4], int j,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c[2 * j][0], c[2 * j][1], hi[0], lo[0]);
  split_bf16(c[2 * j][2], c[2 * j][3], hi[1], lo[1]);
  split_bf16(c[2 * j + 1][0], c[2 * j + 1][1], hi[2], lo[2]);
  split_bf16(c[2 * j + 1][2], c[2 * j + 1][3], hi[3], lo[3]);
}

// T: __nv_bfloat16 (q, k, v, dO' and dK, dV)
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(MNT, 1) dkdv_mma_kernel(Params p) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 operands");
  using L = MmaLayout<D, DQ>;
  constexpr int BQ = L::BQ, RS = L::RS, SS = L::SS;
  constexpr int NQ = BQ / 8;     // n8 tiles of a warp's (16 keys x BQ) tile
  constexpr int ND = D / 8;      // n8 tiles over the head dim
  constexpr int QG = BQ / 16;    // dQ: 16-query groups of a tile ...
  constexpr int DP = MW / QG;    // ... and the head-dim parts per group
  constexpr int NDQ = ND / DP;   // n8 tiles of a warp's dQ part, formed
  constexpr int NH = D > 96 ? 2 : 1;  // in NH passes (d 128: registers)
  constexpr int NDH = NDQ / NH;
  static_assert(NDH % 2 == 0, "dQ passes take pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* ks = msmem;
  unsigned char* vs = ks + L::KV;
  unsigned char* qs = vs + L::KV;        // 2 buffers
  unsigned char* dos = qs + 2 * L::QT;   // 2 buffers
  float* dls = reinterpret_cast<float*>(dos + 2 * L::QT);  // 2 x BQ
  unsigned char* dss = reinterpret_cast<unsigned char*>(dls + 2 * BQ);
  float* bss = dls + 2 * BQ;             // K3b: 2 bias tiles in dS^T's room

  const int kvhi = blockIdx.x, bi = blockIdx.y, k0 = blockIdx.z * MBK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int G = p.H / p.KVH, diff = p.seq_k - p.seq_q;
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;

  // (head, q tile) pairs that see the block's keys: the causal start is the
  // first query row that sees key k0
  const int qfirst = p.causal ? max(0, k0 - diff) : 0;
  const int qt0 = qfirst / BQ;
  const int per_head = max(0, (p.seq_q + BQ - 1) / BQ - qt0);
  const int total = G * per_head;

  // `nrows` rows of D bf16 from global rows [first, first + nrows) of `src`
  // (rows past `limit` as zeros) to shared memory rows RS bytes apart
  auto load_rows = [&](unsigned char* dst, const void* src, int first,
                       int nrows, int limit) {
    constexpr int chunks = 2 * D / 16;
    const unsigned char* sb = static_cast<const unsigned char*>(src);
    for (int idx = tid; idx < nrows * chunks; idx += MNT) {
      const int r = idx / chunks, cc = (idx % chunks) * 16, row = first + r;
      const bool in = row < limit;
      cp_async16(dst + r * RS + cc, in ? sb + size_t(row) * 2 * D + cc : sb,
                 in ? 16 : 0);
    }
  };
  auto q_rows = [&](int it) {  // the query rows' first index, (b, h, 0)
    return (size_t(bi) * p.H + kvhi * G + it / per_head) * p.seq_q;
  };
  const bool bias16 = p.seq_k % 4 == 0;  // bias rows in 16-byte units
  auto load_tile = [&](int it, int buf) {
    const size_t qrow0 = q_rows(it);
    const int q0 = (qt0 + it % per_head) * BQ;
    load_rows(qs + buf * L::QT,
              static_cast<const T*>(p.q) + qrow0 * D, q0, BQ,
              p.seq_q);
    load_rows(dos + buf * L::QT,
              static_cast<const T*>(p.dO) + qrow0 * D, q0, BQ,
              p.seq_q);
    for (int i = tid; i < BQ; i += MNT) {
      const bool in = q0 + i < p.seq_q;
      cp_async4(dls + buf * BQ + i, in ? p.delta + qrow0 + q0 + i : p.delta,
                in ? 4 : 0);
    }
    if (DQ || p.bias == nullptr) return;
    // the bias tile (queries q0.., keys k0..), past either length as 0
    const int hb = p.bias_batch_dim ? bi : kvhi * G + it / per_head;
    const float* bb = p.bias + (size_t(hb) * p.seq_q + q0) * p.seq_k + k0;
    float* dst = bss + buf * BQ * L::BS;
    const int rows = min(BQ, p.seq_q - q0), cols = min(MBK, p.seq_k - k0);
    if (bias16) {
      for (int idx = tid; idx < BQ * MBK / 4; idx += MNT) {
        const int r = idx / (MBK / 4), c = (idx % (MBK / 4)) * 4;
        const int n = r < rows ? 4 * max(0, min(4, cols - c)) : 0;
        cp_async16(dst + r * L::BS + c, n ? bb + size_t(r) * p.seq_k + c : bb,
                   n);
      }
    } else {
      for (int idx = tid; idx < BQ * MBK; idx += MNT) {
        const int r = idx / MBK, c = idx % MBK;
        const bool in = r < rows && c < cols;
        cp_async4(dst + r * L::BS + c, in ? bb + size_t(r) * p.seq_k + c : bb,
                  in ? 4 : 0);
      }
    }
  };

  if (total > 0) {
    load_rows(ks, static_cast<const T*>(p.k) + kvrow0 * D, k0, MBK, p.seq_k);
    load_rows(vs, static_cast<const T*>(p.v) + kvrow0 * D, k0, MBK, p.seq_k);
    load_tile(0, 0);
  }
  cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // this thread's keys: C rows g and g + 8 of the warp's 16
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_ok[h] = keys[h] < p.seq_k && (mb == nullptr || mb[keys[h]] != 0);
  const bool keys_whole = mb == nullptr && k0 + MBK <= p.seq_k;

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) load_tile(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it (and, at it 0, K and V) has landed
    const size_t qrow0 = q_rows(it);
    const int q0 = (qt0 + it % per_head) * BQ;
    const unsigned char* qt = qs + buf * L::QT;
    const unsigned char* dot = dos + buf * L::QT;
    const float* dl = dls + buf * BQ;

    // S^T = K.Q^T, dP^T = V.dO'^T: an x4 ldmatrix of Q / dO' gives the B
    // fragments of 2 n8 tiles
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < D / 16; ++st) {
      uint32_t ka[4], va[4];
      const int arow = (warp * 16 + (lane & 15)) * RS + st * 32 + (lane >> 4) * 16;
      ldmatrix_x4(ka, ks + arow);
      ldmatrix_x4(va, vs + arow);
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        const int brow = (j * 16 + (lane & 7) + (lane >> 4) * 8) * RS +
                         st * 32 + ((lane >> 3) & 1) * 16;
        uint32_t b[4];
        ldmatrix_x4(b, qt + brow);
        mma_bf16(s[2 * j], ka, b[0], b[1]);
        mma_bf16(s[2 * j + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, dot + brow);
        mma_bf16(dp[2 * j], va, b[0], b[1]);
        mma_bf16(dp[2 * j + 1], va, b[2], b[3]);
      }
    }

    // e^T into s, dS^T into dp, in the C layout: entry (n, 2h + x) is key
    // keys[h], query q0 + 8n + 2tq + x.  A tile whose every (key, query)
    // pair is visible (no key mask, inside both lengths and the causal
    // diagonal) skips the masks; the bias comes from its staged tile
    const bool whole = keys_whole && q0 + BQ <= p.seq_q &&
                       (!p.causal || k0 + MBK - 1 <= q0 + diff);
    const bool has_bias = !DQ && p.bias != nullptr;
    const float* bt = bss + buf * BQ * L::BS + warp * 16 + g;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = n * 8 + 2 * tq + x, qr = q0 + col;
        const float dlt = dl[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float lg = s[n][2 * h + x] * p.c;
          if (has_bias) lg += bt[col * L::BS + 8 * h] * LOG2E;
          float e, ds;
          if (whole) {
            e = exp2f(lg);
            ds = e * (dp[n][2 * h + x] - dlt);
          } else {
            bool keep = key_ok[h] && qr < p.seq_q;
            if (p.causal) keep = keep && keys[h] <= qr + diff;
            e = keep ? exp2f(lg) : 0.f;
            ds = keep ? e * (dp[n][2 * h + x] - dlt) : 0.f;
          }
          s[n][2 * h + x] = e;
          dp[n][2 * h + x] = ds;
        }
      }

    if constexpr (DQ) {  // stage dS^T (keys x queries) for dQ = dS.K
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (warp * 16 + g + 8 * h) * SS + (n * 8 + 2 * tq) * 2;
          split_bf16(dp[n][2 * h], dp[n][2 * h + 1],
                     *reinterpret_cast<uint32_t*>(dss + at),
                     *reinterpret_cast<uint32_t*>(dss + MBK * SS + at));
        }
    }

    // dV += e^T.dO', then dK += dS^T.Q: n8 tiles 2j, 2j + 1 of e^T / dS^T
    // are the A fragments (hi and lo) of k16 step j (queries 16j ..); two
    // passes, so one operand's fragments are live at a time (d 128 stays
    // within 255 registers)
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t ah[4], al[4];
      split_a(s, j, ah, al);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dot + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                 (dn * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(dv[2 * dn], ah, b[0], b[1]);
        mma_bf16(dv[2 * dn], al, b[0], b[1]);
        mma_bf16(dv[2 * dn + 1], ah, b[2], b[3]);
        mma_bf16(dv[2 * dn + 1], al, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t ah[4], al[4];
      split_a(dp, j, ah, al);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, qt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                 (dn * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(dk[2 * dn], ah, b[0], b[1]);
        mma_bf16(dk[2 * dn], al, b[0], b[1]);
        mma_bf16(dk[2 * dn + 1], ah, b[2], b[3]);
        mma_bf16(dk[2 * dn + 1], al, b[2], b[3]);
      }
    }

    if constexpr (DQ) {
      // dQ rows of this tile += dS.K over the block's 64 keys: warp w takes
      // query group w % QG and head-dim part w / QG; dS^T (hi and lo) is
      // read by ldmatrix.trans as dS's A fragments, K by ldmatrix.trans
      __syncthreads();  // every warp's dS^T is staged
      const int qg = warp % QG, dpart = warp / QG;
      float* dqb = p.dq_acc + qrow0 * D;
#pragma unroll
      for (int hp = 0; hp < NH; ++hp) {
        const int c0 = (dpart * NDQ + hp * NDH) * 8;  // the pass's columns
        float dq[NDH][4];
#pragma unroll
        for (int n = 0; n < NDH; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MBK / 16; ++kk) {
          const int arow = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * SS +
                           (qg * 16 + ((lane >> 3) & 1) * 8) * 2;
          uint32_t ah[4], al[4];
          ldmatrix_x4_trans(ah, dss + arow);
          ldmatrix_x4_trans(al, dss + MBK * SS + arow);
#pragma unroll
          for (int dn = 0; dn < NDH / 2; ++dn) {
            uint32_t b[4];
            ldmatrix_x4_trans(
                b, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                       (c0 + dn * 16 + (lane >> 4) * 8) * 2);
            mma_bf16(dq[2 * dn], ah, b[0], b[1]);
            mma_bf16(dq[2 * dn], al, b[0], b[1]);
            mma_bf16(dq[2 * dn + 1], ah, b[2], b[3]);
            mma_bf16(dq[2 * dn + 1], al, b[2], b[3]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + qg * 16 + g + 8 * h;
          if (row >= p.seq_q) continue;
#pragma unroll
          for (int n = 0; n < NDH; ++n)
            atomicAdd(reinterpret_cast<float2*>(
                          dqb + size_t(row) * D + c0 + n * 8 + 2 * tq),
                      make_float2(dq[n][2 * h], dq[n][2 * h + 1]));
        }
      }
    }
    __syncthreads();  // the next tile's loads may overwrite this buffer
  }
  cp_async_wait<0>();

  T* dkb = static_cast<T*>(p.dk) + kvrow0 * D;
  T* dvb = static_cast<T*>(p.dv) + kvrow0 * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= p.seq_k) continue;
    const size_t at = size_t(keys[h]) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + at + n * 8) =
          pack_bf16(dk[n][2 * h] * p.scale, dk[n][2 * h + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + at + n * 8) =
          pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

enum Which { ONEPASS = 0, DQ = 1, DKDV = 2 };

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(Which which, const Params& p, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  if (which == DQ)
    return launch(dq_kernel<T, D>, dim3((p.seq_q + BQ - 1) / BQ, p.H, B), NT,
                  smem, s, p);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // 16-byte copies: every row is a 16-byte multiple, so aligned bases do
    for (const void* t : {p.q, p.k, p.v, p.dO})
      if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return cudaErrorMisalignedAddress;
    // key tiles slowest, so the causal blocks with the most work go first
    const dim3 grid(p.KVH, B, (p.seq_k + MBK - 1) / MBK);
    using L2 = MmaLayout<D, true>;
    using L3 = MmaLayout<D, false>;
    return which == ONEPASS
               ? launch(dkdv_mma_kernel<T, D, true>, grid, MNT,
                        L2::BASE + L2::DST, s, p)
               : launch(dkdv_mma_kernel<T, D, false>, grid, MNT,
                        L3::BASE + (p.bias ? L3::BIAS : 0), s, p);
  } else {
    const dim3 kgrid((p.seq_k + BK - 1) / BK, p.KVH, B);
    return which == ONEPASS
               ? launch(dkdv_kernel<T, D, true>, kgrid, NT, smem, s, p)
               : launch(dkdv_kernel<T, D, false>, kgrid, NT, smem, s, p);
  }
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
