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
// Bound on the H100: at the serving shapes (b1 h8 s1024 d64 causal bf16)
// the work is ~1.07 GFLOP over ~4.2 MB, far above the card's ~295 FLOP/B
// ridge, so the bound is the tensor-core rate (~1.1 us).  In float32 the
// 3xTF32 instance does three times the operations at the TF32 rate (495
// TFLOP/s): ~6.5 us, against ~2.5 us for its 8.4 MB.
//
// bfloat16 q/k/v, and int8 q/k codes with bfloat16 v, run on the tensor
// cores (`fwd_mma_kernel`), in the FlashAttention-2 shape: one 128-thread
// block per (batch, head, 64 query rows), 4 warps of 16 rows each.  Q's
// fragments stay in registers; K and V tiles of 64 keys stream through a
// double-buffered `cp.async` ring (zero-filled past seq_k, so no 0 *
// garbage NaN reaches O).  S = Q.K^T by `mma.sync` into f32 (bf16
// m16n8k16) or exact int32 (int8 m16n8k32: |s| <= 127^2 * 128 < 2^24, so
// its float is exact too); the logit is s * c in f32, c = scale * log2e
// (times s_dequant for the codes), plus bias * log2e.  e = exp2(logit),
// masked to exact 0; l sums the unrounded f32 e, and e is rounded to bf16
// only as the A fragment of P.V (the C fragments of S are the A fragments
// of P.V, so P never touches shared memory; V arrives by
// `ldmatrix.trans`).  This is the JAX kernel's order (fwd_kernel.py:
// 201-203).  A bf16 P cannot overflow (f32's exponent range): it holds up
// to e^(scale + bias).  Causal blocks are launched heaviest first.  At d
// 16 the int8 codes are zero-padded to the k = 32 step in shared memory.
// Above d 128 (the 192 and 256 instances) a warp's O accumulators are
// D / 2 f32 registers a thread (128 at d 256) beside the 32 of the S tile,
// so Q's A fragments (another D / 4) are not kept: they are read again
// from the resident Q tile by ldmatrix at every key tile.
//
// float32 q/k/v at every width up to 256 run on the tensor cores as
// 3xTF32 split products (`fwd_tf32_kernel`): every operand x is split
// into two tf32 values, hi = rn(x) and lo = rn(x - hi) (cvt.rn.tf32.f32,
// which keeps a NaN a NaN), and each product is lo.hi + hi.lo + hi.hi by
// mma.sync m16n8k8 into f32 (lo.lo dropped), which holds the f32 parity
// bar of 1e-4.  The TPU kernel splits into bf16 hi / lo instead (Mosaic
// has no TF32 tier); at 8 l2norm groups and scale 8 that split misses the
// bar (1.7e-4 on o), TF32's 11 significant bits a part do not.  The FA2
// block shape of fwd_mma_kernel; K and V tiles arrive as f32 by cp.async
// and are split once for the block after they land (hi in place, lo
// beside them), since every warp reads all of them; a warp reads only its
// own Q rows, whose hi / lo fragments stay in registers up to d 64, are
// split once into a resident lo tile up to d 128, and above are split at
// each fragment load (a resident lo tile would not fit).  P stays f32
// (the bf16 arm rounds it to bf16) and is split in registers: the C
// fragment of S holds keys 2q and 2q + 1, which serve as the tf32 A
// fragment's k indices q and q + 4 when V's rows are read in that order
// (add_product_tf32x3), so P never touches shared memory.  The masks, e,
// l and inv_l are the bf16 instance's.  The tensor cores round each f32
// sum toward zero, and a chain of them on one accumulator drifts with its
// length (past the 1e-4 bar over 8192 keys whose values' mean is far from
// 0): every 256 keys O's chain is closed into a running sum, added to
// nearest.  Key tiles: 64 keys up to d 96, 32 at d 128 and 192, 16 at
// 256.  Shared memory up to d 128 (the Q tile, Q's lo, six K / V tiles,
// O's running sum of D / 2 words a thread): 135 KB at d 64, 224 KB at d
// 96, 197 KB at d 128.
// Above d 128 a warp of 16 rows would hold O's 128 accumulators a thread
// (d 256) and sum S over 32 k steps, one warp an SM sub-partition, whose
// chains of dependent mma leave the tensor cores idle; and the heaviest
// causal block sets the time (128 blocks in one wave at the heads-256
// shape, b4 h2 s1024).  So a block has 8 warps, two for each 16 rows:
// warp w sums S over half w / 4 of d, the pair adds its halves through
// shared memory (both in the same order, so both form the same e), and
// each forms e and O's half of the columns (D / 4 accumulators a thread).
// S costs nothing twice; a tile costs a pair barrier and a 2 KB (d 256)
// or 4 KB (d 192) exchange a pair.  O's chains close into o itself (the
// thread's own words).  Blocks run heaviest causal q tiles first.  The
// heads-256 shape's 128 blocks of 64 rows run in one wave whose heaviest
// block, seeing all 64 key tiles against the mean's 34, sets the time:
// splitting the q tiles' keys over blocks (256-key chunks, merged by the
// last to finish) took d 256 from 0.261 to 0.223 ms a call on an H100,
// but the heads-256 f32 step only from 102.5 to 101.4 ms, within its
// run-to-run spread, so the kernel does without it.
// Shared memory (the Q tile, six K / V tiles of 32 keys at d 192 and 16
// at d 256, the halves of S): 212 KB at d 192, 170.5 KB at d 256.  Bound
// at the heads-256 training shape (b4 h2 s1024 d256 causal f32): 4.3
// GFLOP, three times that on the TF32 tensor cores, 0.026 ms at 495
// TFLOP/s (the FMA route's bound, at 67 TFLOP/s, is 0.064 ms).
// int8 q/k codes with float32 v (the op's qk_int8 on float32 inputs) run
// as instances of the same kernel, fwd_tf32_kernel<D, int8_t>: Q and K
// tiles are int8 rows laid out as MmaLayout lays them (a d 16 row padded
// to one 32-byte k step with zeros), S = Q.K^T by mma.sync m16n8k32.s8
// into exact int32 sums, as fwd_mma_kernel forms it, converted to float
// once and scaled by c; the codes are exact, so no hi / lo split of Q or
// K and no K lo tile.  Q's code fragments stay in registers at every
// width (D / 32 words a thread at most); above d 128 each warp of a pair
// sums S over half of a row's bytes and the pair adds its halves through
// shared memory as the float instances do.  e, the masks, l and P.V
// (3xTF32, V split) are the float instances'.  K's tiles are a quarter of
// the bytes, so key tiles are 64 keys up to d 128 and 32 above.  Shared
// memory 158 KB at d 128, 147.5 KB at d 256.  Bound at b1 h16 s1024 d128
// causal: Q.K's 2.15 GOP at 1,979 TOP/s and P.V's 3 x 2.15 GFLOP at 495
// TFLOP/s, 0.0141 ms.
//
// Past d 256 (the wide route) a warp's O accumulators no longer fit, so
// the output columns become a grid axis: the wrapper pads d to a multiple
// of 128 (ops/blocks.py WIDE_CHUNK).  Bound: at the heads-512 training
// shape (b4 h1 s1024 d512 causal bf16) the work is ~4.3 GFLOP over ~12.6
// MB, operations-bound on paper (~5 us); what bounds this design is the
// tensor cores' issue rate with 4 warps an SM and the S it forms again.
// bf16 (code 1) and int8 q/k with bf16 v (code 3) run on the tensor cores
// (`fwd_wide_mma_kernel`): a block owns 64 query rows and 256 of O's
// columns (a warp's 16 rows x 256 f32 are 128 registers a thread, the d
// 256 instance's budget; at d 384 or 1152 the last block owns a 128-column
// remainder), so S is formed ceil(d / 256) times, twice at d 512, which
// keeps 128 blocks in flight on 132 SMs at that shape (one 8-warp block
// forming S once per 64 rows would leave half the card idle).  Q and K
// stream in 256-byte row chunks (128 bf16 or 256 int8 lanes; an int8 row
// may end in a 128-byte chunk) through a 3-stage cp.async ring, S summed
// over the chunks by mma.sync in f32 (bf16) or exact int32 (int8); a key
// tile's V columns (64 x 256 bf16) arrive with its first chunk into a
// double buffer.  e, l, the masks and P's bf16 rounding are those of
// fwd_mma_kernel; column block 0 alone writes inv_l.  Shared memory is
// 168 KB at every d.
// float32 (code 0) runs on the tensor cores as 3xTF32
// (`fwd_wide_tf32_kernel`): a block owns 32 query rows and 256 of O's
// columns, so S is formed twice at d 512, and its grid puts the query
// tiles slowest, heaviest first over the whole grid: 256 blocks at the
// heads-512 training shape, whose causal work the card spreads evenly (64
// rows a block made 128 blocks of one wave, the heaviest with twice the
// mean's keys).  A 256-byte chunk holds 64 f32 lanes and a 64-key f32 V
// tile of 256 columns takes 64 KB, so key tiles are 32 keys.  8 warps,
// four for each 16 rows: warp w sums S over quarter w / 2 of every chunk,
// the four add their quarters through shared memory once a tile (all in
// the same order, so all form the same e), and each forms O over its
// quarter of the block's columns (64 f32, 32 registers a thread).  Up to
// d 512 the block's Q rows stay resident (66 KB at d 512) and only K
// streams, in 64-lane chunks through a 4-stage cp.async ring; past it Q's
// chunks stream beside K's.  Each 16-byte word of a K chunk, which two
// warps read, and of the V tile (32 x 256 f32, loaded once the last
// tile's products are done), which two warps read, is split once for the
// block (hi in place, lo beside) by the thread that copied it, as soon as
// its own copies land: the split needs no barrier of its own.  A warp's Q
// rows are split as they are read.  S sums in four accumulators (hi.hi
// and the small terms apart, each by the k step's parity).  P stays f32,
// split in registers (add_product_tf32x3).  O's chains close into o
// itself every 256 keys; the masks, e, l and inv_l are fwd_tf32_kernel's.
// Shared memory 213.5 KB up to d 512, 183 KB past it.  On an H100 at b4
// h1 s1024 d512 causal this took K1 from 0.69 ms (64-row blocks, Q
// streamed, the K chunk split by the whole block after a barrier of its
// own) through 0.60 and 0.48 to 0.41 ms.  Bound at the heads-512
// training shape: 3 x 4.3 GFLOP on the TF32 tensor cores, 0.026 ms at
// 495 TFLOP/s (the FMA rate's, 67 TFLOP/s, 0.064 ms).
// int8 q/k codes with float32 v (code 2) run as its int8 instance,
// fwd_wide_tf32_kernel<int8_t>: the same grid, warps and V tiles; a chunk
// holds 128 codes (128 bytes), so a warp's quarter is one 32-byte k step
// of mma.sync m16n8k32.s8 into exact int32 sums, with no split and no K
// lo; the quarters are added as floats through shared memory as the float
// instance adds them.  Q's rows stay resident while they hold at most 2048
// bytes (d 2048; 16.5 KB at d 512), and the instance takes 115.5 KB of
// shared memory at d 512.  At d 384 a row has 3 chunks, fewer than the
// ring's stages, so a tile's last chunk waits for every copy in flight
// (its V tile among them).

// Masking: causal keeps key col <= row + (seq_k - seq_q) (cross-attention
// alignment) and the loop stops at the last tile a row of the block can
// see; an optional (b, j) key mask and the ragged edges select e = 0.
// GQA: query head h reads kv head h / (H / KVH).  Bias: (b|h, i, j) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EPS = 1e-10f;

template <typename TQ>
__host__ __device__ constexpr bool is_int8() { return std::is_same<TQ, int8_t>::value; }

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16 q/k/v, or int8 q/k codes with bf16 v

template <typename TQ, int D>
struct MmaLayout {
  static constexpr int QB = D * int(sizeof(TQ));    // bytes of a q / k row
  static constexpr int QBP = QB < 32 ? 32 : QB;     // whole 32-byte k steps
  // shared-memory row strides, 16 bytes past the row: an odd number of
  // 16-byte units, so the 8 rows an ldmatrix reads hit 8 distinct banks
  static constexpr int QS = QBP + 16;
  static constexpr int VS = 2 * D + 16;
  static constexpr size_t SMEM = size_t(BQ) * QS + 2 * size_t(BK) * (QS + VS);
};

template <typename TQ, int D>
__global__ void __launch_bounds__(NT, 1) fwd_mma_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
    float* __restrict__ inv_l, int H, int KVH, int seq_q, int seq_k,
    int causal, int bias_batch_dim, float c) {
  using L = MmaLayout<TQ, D>;
  constexpr bool Q8 = is_int8<TQ>();
  constexpr int QB = L::QB, QS = L::QS, VS = L::VS;
  constexpr int KSTEPS = L::QBP / 32;  // 32-byte k steps of S = Q.K^T
  constexpr int NS = BK / 8;           // n8 tiles of S
  constexpr int NO = D / 8;            // n8 tiles of O
  constexpr bool QREG = D <= 128;      // Q's A fragments kept in registers
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                 // BQ x QS
  unsigned char* ks = qs + BQ * QS;         // 2 x BK x QS
  unsigned char* vs = ks + 2 * BK * QS;     // 2 x BK x VS

  const int bi = blockIdx.z, hi = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int kvhi = hi / (H / KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int diff = seq_k - seq_q;

  const unsigned char* qb = reinterpret_cast<const unsigned char*>(
      q + (size_t(bi) * H + hi) * seq_q * D);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      k + (size_t(bi) * KVH + kvhi) * seq_k * D);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      v + (size_t(bi) * KVH + kvhi) * seq_k * D);
  const uint8_t* mb = mask ? mask + size_t(bi) * seq_k : nullptr;
  const float* bb =
      bias ? bias + size_t(bias_batch_dim ? bi : hi) * seq_q * seq_k : nullptr;

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + BQ, seq_q) - 1;
  const int kend = causal ? max(0, min(seq_k, last_row + diff + 1)) : seq_k;
  const int nk = (kend + BK - 1) / BK;

  auto load_kv = [&](int buf, int k0) {
    load_rows<QB, QS, NT>(ks + buf * BK * QS, kb, k0, BK, seq_k);
    load_rows<2 * D, VS, NT>(vs + buf * BK * VS, vb, k0, BK, seq_k);
  };

  if constexpr (L::QBP > QB) {  // int8 d 16: zero the k step's second half
    for (int r = tid; r < BQ + 2 * BK; r += NT)
      *reinterpret_cast<uint4*>(smem + r * QS + QB) = make_uint4(0, 0, 0, 0);
  }
  if (nk > 0) {
    load_rows<QB, QS, NT>(qs, qb, q0, BQ, seq_q);
    load_kv(0, 0);
  }
  cp_async_commit();

  uint32_t qf[QREG ? KSTEPS : 1][4];
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float lsum[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nk) load_kv((kt + 1) & 1, k0 + BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and, at kt 0, the q tile) has landed
    // Q's A fragment of k step st: kept from the first tile, or (above d
    // 128) read again from the resident Q tile
    const unsigned char* qrow = qs + (warp * 16 + (lane & 15)) * QS + (lane >> 4) * 16;
    if constexpr (QREG) {
      if (kt == 0) {
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) ldmatrix_x4(qf[st], qrow + st * 32);
      }
    }
    auto q_frag = [&](int st, uint32_t(&a)[4]) {
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[st][i];
      } else {
        ldmatrix_x4(a, qrow + st * 32);
      }
    };
    const unsigned char* kt_s = ks + (kt & 1) * BK * QS;
    const unsigned char* vt_s = vs + (kt & 1) * BK * VS;

    // S = Q.K^T: an x4 ldmatrix of K gives the B fragments of 2 n8 tiles
    float s[NS][4];
    if constexpr (Q8) {
      int si[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) si[n][e] = 0;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        uint32_t a[4];
        q_frag(st, a);
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, kt_s + (j * 16 + (lane & 7) + (lane >> 4) * 8) * QS +
                             st * 32 + ((lane >> 3) & 1) * 16);
          mma_s8(si[2 * j], a, b[0], b[1]);
          mma_s8(si[2 * j + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = float(si[n][e]);
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        uint32_t a[4];
        q_frag(st, a);
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, kt_s + (j * 16 + (lane & 7) + (lane >> 4) * 8) * QS +
                             st * 32 + ((lane >> 3) & 1) * 16);
          mma_bf16(s[2 * j], a, b[0], b[1]);
          mma_bf16(s[2 * j + 1], a, b[2], b[3]);
        }
      }
    }

    // e = exp2(s * c + bias * log2e), masked to 0, in the C layout: entry
    // (n, 2h + x) is row rows[h], column k0 + 8n + 2tq + x.  A tile every
    // row of the block sees whole (no key mask, no bias, inside seq_k and
    // the causal diagonal) skips the masks: rows past seq_q are not stored
    const bool whole = mb == nullptr && bb == nullptr && k0 + BK <= seq_k &&
                       (!causal || k0 + BK - 1 <= q0 + diff);
    if (whole) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] * c);
          lsum[e >> 1] += s[n][e];
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int row = rows[h], col = k0 + n * 8 + 2 * tq + x;
            bool keep = row < seq_q && col < seq_k;
            if (causal) keep = keep && col <= row + diff;
            if (mb != nullptr) keep = keep && mb[col] != 0;
            float lg = s[n][2 * h + x] * c;
            if (bb != nullptr && keep) lg += bb[size_t(row) * seq_k + col] * LOG2E;
            const float e = keep ? exp2f(lg) : 0.f;
            lsum[h] += e;
            s[n][2 * h + x] = e;
          }
    }

    // O += P.V: S's C fragments of n8 tiles 2j, 2j + 1 are P's A fragment
    // of k16 step j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vt_s + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VS +
                   (dn * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(oacc[2 * dn], a, b[0], b[1]);
        mma_bf16(oacc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next tile's loads may overwrite this buffer
  }

  // a row's sum is spread over the 4 lanes of a quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  __nv_bfloat16* ob = o + (size_t(bi) * H + hi) * seq_q * D;
  float* lb = inv_l + (size_t(bi) * H + hi) * seq_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= seq_q) continue;
    const float inv = 1.f / fmaxf(lsum[h], EPS);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(ob + size_t(row) * D + n * 8 + 2 * tq) =
          pack_bf16(oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);
    if (tq == 0) lb[row] = inv;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core f32 kernel: float32 v and o at every width up to 256, with
// float32 q/k (every product as three tf32 mma.sync passes, 3xTF32) or
// int8 q/k codes (S = Q.K^T exact by the s8 mma.sync of fwd_mma_kernel,
// P.V as 3xTF32).  Up to d 128 the block shape and key loop of
// fwd_mma_kernel (4 warps, 16 rows each); above, 8 warps, two for each 16
// rows (see Tf32Layout).

// Key tiles of the float instances above d 128: 32 keys at d 192, 16 at d
// 256 (32 do not fit there); 16 at d 192 ran 0.172 against 0.158 ms at
// b4 h2 s1024 causal on an H100.  The int8 instances, whose K tiles are a
// quarter of the bytes and have no lo, take 64 keys up to d 128 and 32
// above.
template <int D, typename TQ>
struct Tf32Layout {
  static constexpr bool Q8 = is_int8<TQ>();
  // above d 128 a block has 8 warps, two for each 16 rows: warp w sums
  // S over half h = w / 4 of d and owns O's columns [h D / 2, (h + 1) D /
  // 2), so a thread holds D / 4 of O's words (64 at d 256) and each SM
  // sub-partition runs two warps; the pair adds its two halves of S
  // through shared memory (XS)
  static constexpr bool WIDE = D > 128;
  static constexpr int HALVES = WIDE ? 2 : 1;
  static constexpr int NT = 128 * HALVES;
  static constexpr int BKT = Q8 ? (D <= 128 ? 64 : 32)
                                : D <= 96 ? 64 : D <= 192 ? 32 : 16;
  // Q's A fragments in registers: the float hi / lo up to d 64, the int8
  // codes (D / 32 words a thread at most) at every width
  static constexpr bool QREG = Q8 || D <= 64;
  // float Q's lo as a resident tile up to d 128; above, Q's rows (each
  // read by its own warps only) are split at each fragment load
  static constexpr bool QLO = !QREG && !WIDE;
  // f32 rows of D + 4 floats, (4D + 16) bytes: an odd count of 16-byte
  // units, so the 8 rows an ldmatrix reads hit 8 distinct banks, and 2
  // rows 8 banks apart for add_product_tf32x3's reads of V
  static constexpr int RF = D + 4;
  static constexpr int RS = 4 * RF;
  // Q and K rows: f32 rows, or int8 rows laid out as MmaLayout lays them
  // (padded to whole 32-byte k steps, 16 bytes past them)
  static constexpr int QBP = Q8 ? MmaLayout<int8_t, D>::QBP : 4 * D;
  static constexpr int QS = Q8 ? MmaLayout<int8_t, D>::QS : RS;
  // the Q tile (and its lo where QLO), two K and two V tiles (float K and
  // V each split in place into its hi), the current K (float only) and V
  // tiles' lo; then up to d 128 O's running sum (the closed chains), each
  // thread's D / 2 words, and above the pairs' halves of S (8 warps x the
  // S tile's C fragments; O's chains close into o itself)
  static constexpr size_t XS = WIDE ? 2 * size_t(NT) * BKT : 0;  // bytes
  static constexpr size_t SMEM = size_t(QLO ? 2 : 1) * BQ * QS +
                                 2 * size_t(BKT) * QS +
                                 size_t(Q8 ? 3 : 4) * BKT * RS +
                                 (WIDE ? XS : size_t(NT) * D / 2 * 4);
};

template <int D, typename TQ>
__global__ void __launch_bounds__(Tf32Layout<D, TQ>::NT, 1) fwd_tf32_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ mask,
    const float* __restrict__ bias, float* __restrict__ o,
    float* __restrict__ inv_l, int H, int KVH, int seq_q, int seq_k,
    int causal, int bias_batch_dim, float c) {
  using L = Tf32Layout<D, TQ>;
  constexpr bool Q8 = L::Q8;
  constexpr int RS = L::RS, RF = L::RF, QS = L::QS, BKT = L::BKT;
  constexpr int NTH = L::NT;
  constexpr bool QREG = L::QREG, QLO = L::QLO, WIDE = L::WIDE;
  constexpr int QB = D * int(sizeof(TQ));  // bytes of a q / k row
  constexpr int DH = D / L::HALVES;        // O's columns of a warp
  constexpr int HB = L::QBP / L::HALVES;   // bytes of a warp's part of a row
  constexpr int KSTEPS = HB / 32;          // 32-byte k steps of a warp's S
  constexpr int NS = BKT / 8;              // n8 tiles of S
  constexpr int NO = DH / 8;               // n8 tiles of a warp's O
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                          // BQ x QS
  unsigned char* qlo = qs + BQ * QS;                 // QLO: BQ x QS
  unsigned char* ks = qs + (QLO ? 2 : 1) * BQ * QS;  // 2 x BKT x QS
  unsigned char* vs = ks + 2 * BKT * QS;             // 2 x BKT x RS
  unsigned char* klo = vs + 2 * BKT * RS;            // float: BKT x RS
  unsigned char* vlo = klo + (Q8 ? 0 : BKT * RS);    // BKT x RS
  // up to d 128 O's running sum (D / 2 x NT), above the halves of S
  float* osum = reinterpret_cast<float*>(vlo + BKT * RS);
  float* xs = osum;

  const int bi = blockIdx.z, hi = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int kvhi = hi / (H / KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, part = warp >> 2;  // its 16 rows, its half of d
  const int diff = seq_k - seq_q;

  const TQ* qb = q + (size_t(bi) * H + hi) * seq_q * D;
  const TQ* kb = k + (size_t(bi) * KVH + kvhi) * seq_k * D;
  const float* vb = v + (size_t(bi) * KVH + kvhi) * seq_k * D;
  const uint8_t* mb = mask ? mask + size_t(bi) * seq_k : nullptr;
  const float* bb =
      bias ? bias + size_t(bias_batch_dim ? bi : hi) * seq_q * seq_k : nullptr;

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + BQ, seq_q) - 1;
  const int kend = causal ? max(0, min(seq_k, last_row + diff + 1)) : seq_k;
  const int nk = (kend + BKT - 1) / BKT;

  auto load_kv = [&](int buf, int k0) {
    load_rows<QB, QS, NTH>(ks + buf * BKT * QS, kb, k0, BKT, seq_k);
    load_rows<4 * D, RS, NTH>(vs + buf * BKT * RS, vb, k0, BKT, seq_k);
  };
  if constexpr (L::QBP > QB) {  // int8 d 16: zero the k step's second half
    for (int r = tid; r < BQ + 2 * BKT; r += NTH)
      *reinterpret_cast<uint4*>(smem + r * QS + QB) = make_uint4(0, 0, 0, 0);
  }
  if (nk > 0) {
    load_rows<QB, QS, NTH>(qs, qb, q0, BQ, seq_q);
    load_kv(0, 0);
  }
  cp_async_commit();

  // Q's A fragments: float hi and lo, or the int8 codes (in qh)
  uint32_t qh[QREG ? KSTEPS : 1][4], ql[QREG && !Q8 ? KSTEPS : 1][4];
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float lsum[2] = {0.f, 0.f};
  const int rows[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  // the warp's Q rows, from its half's first k step
  const int qrow = (rg * 16 + (lane & 15)) * QS + (lane >> 4) * 16 + part * HB;
  const int c0 = part * DH;  // the warp's first column of O (and of V)

  // O sums every visible key, each mma rounding its sum toward zero.
  // Every CHAIN tiles (256 keys) the chain is closed: oacc is added, to
  // nearest, into O's running sum and restarts from 0.  The running sum
  // lies in shared memory up to d 128 (the thread's own words, word i at
  // osum[i * NT + tid]) and above in the thread's own words of o (rows
  // past seq_q are dropped: they are never stored)
  constexpr int CHAIN = 256 / BKT;
  // the thread's row `row` of o, from the warp's first column
  float* const oh = o + (size_t(bi) * H + hi) * seq_q * D;
  auto out_row = [&](int row) { return oh + size_t(row) * D + c0; };
  bool summed = false;
  auto close_chain = [&]() {
    if constexpr (!WIDE) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* w = osum + (n * 4 + e) * NTH + tid;
          *w = summed ? *w + oacc[n][e] : oacc[n][e];
        }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= seq_q) continue;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          float2* w = reinterpret_cast<float2*>(out_row(rows[h]) + n * 8 +
                                                2 * tq);
          float2 x = make_float2(oacc[n][2 * h], oacc[n][2 * h + 1]);
          if (summed) {
            const float2 y = *w;
            x.x += y.x, x.y += y.y;
          }
          *w = x;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
    summed = true;
  };

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BKT;
    if (kt + 1 < nk) load_kv((kt + 1) & 1, k0 + BKT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and, at kt 0, the q tile) has landed
    unsigned char* kt_s = ks + (kt & 1) * BKT * QS;
    unsigned char* vt_s = vs + (kt & 1) * BKT * RS;
    // every warp reads all of K and V: split the floats once, for the
    // block (the int8 codes are exact)
    if constexpr (!Q8) split_rows<D, RS, NTH>(kt_s, klo, BKT);
    split_rows<D, RS, NTH>(vt_s, vlo, BKT);
    if (kt == 0) {
      if constexpr (Q8) {  // a warp's own Q rows' codes, in registers
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) ldmatrix_x4(qh[st], qs + qrow + st * 32);
      } else if constexpr (QREG) {  // a warp's own Q rows, split in registers
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) {
          uint32_t a[4];
          ldmatrix_x4(a, qs + qrow + st * 32);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(a[i]), qh[st][i], ql[st][i]);
        }
      } else if constexpr (QLO) {
        split_rows<D, RS, NTH>(qs, qlo, BQ);
      }
    }
    __syncthreads();  // the tiles' hi and lo are in place

    float s[NS][4];
    if constexpr (Q8) {
      // S = Q.K^T over the warp's k steps in exact int32 sums (|s| <=
      // 127^2 D < 2^24, so its float is exact too), as fwd_mma_kernel
      // forms it: an x4 ldmatrix of K gives the B fragments of 2 n8 tiles
      int si[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) si[n][e] = 0;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, kt_s + (j * 16 + (lane & 7) + (lane >> 4) * 8) * QS +
                             part * HB + st * 32 + ((lane >> 3) & 1) * 16);
          mma_s8(si[2 * j], qh[st], b[0], b[1]);
          mma_s8(si[2 * j + 1], qh[st], b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = float(si[n][e]);
    } else {
      // S = Q.K^T over the warp's k steps: x4 ldmatrix of K's hi and lo
      // give the B fragments of 2 n8 tiles.  hi.hi sums into s, the small
      // terms lo.hi + hi.lo into sl: the tensor cores round each sum
      // toward zero, and s chains a third as many of them (at 8 groups and
      // scale 8 this brings inv_l's distance from exact products down to
      // float32's own)
      float sl[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.f;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        uint32_t ah[4], al[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[st][i];
            al[i] = ql[st][i];
          }
        } else if constexpr (QLO) {
          ldmatrix_x4(ah, qs + qrow + st * 32);
          ldmatrix_x4(al, qlo + qrow + st * 32);
        } else {  // the warp's own Q rows, split as they are read
          uint32_t a[4];
          ldmatrix_x4(a, qs + qrow + st * 32);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
        }
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          const int brow = (j * 16 + (lane & 7) + (lane >> 4) * 8) * QS +
                           part * HB + st * 32 + ((lane >> 3) & 1) * 16;
          uint32_t bh[4], bl[4];
          ldmatrix_x4(bh, kt_s + brow);
          ldmatrix_x4(bl, klo + brow);
          mma_tf32(sl[2 * j], al, bh[0], bh[1]);
          mma_tf32(sl[2 * j], ah, bl[0], bl[1]);
          mma_tf32(s[2 * j], ah, bh[0], bh[1]);
          mma_tf32(sl[2 * j + 1], al, bh[2], bh[3]);
          mma_tf32(sl[2 * j + 1], ah, bl[2], bl[3]);
          mma_tf32(s[2 * j + 1], ah, bh[2], bh[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];
    }
    if constexpr (WIDE) {
      // the pair's two halves of S, added in the same order by both warps
      // (so both form the same e): word (n, e) of a lane at
      // xs[((rg * 2 + part) * NS * 4 + n * 4 + e) * 32 + lane]
      float* mine = xs + (rg * 2 + part) * NS * 4 * 32 + lane;
      const float* h0 = xs + rg * 2 * NS * 4 * 32 + lane;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = s[n][e];
      pair_sync(1 + rg);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = h0[(n * 4 + e) * 32] + h0[(NS * 4 + n * 4 + e) * 32];
    }

    // e = exp2(s * c + bias * log2e), masked to 0, as in fwd_mma_kernel
    const bool whole = mb == nullptr && bb == nullptr && k0 + BKT <= seq_k &&
                       (!causal || k0 + BKT - 1 <= q0 + diff);
    if (whole) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] * c);
          lsum[e >> 1] += s[n][e];
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int row = rows[h], col = k0 + n * 8 + 2 * tq + x;
            bool keep = row < seq_q && col < seq_k;
            if (causal) keep = keep && col <= row + diff;
            if (mb != nullptr) keep = keep && mb[col] != 0;
            float lg = s[n][2 * h + x] * c;
            if (bb != nullptr && keep) lg += bb[size_t(row) * seq_k + col] * LOG2E;
            const float e = keep ? exp2f(lg) : 0.f;
            lsum[h] += e;
            s[n][2 * h + x] = e;
          }
    }

    // O[:, the warp's columns] += P.V with P in f32 (split hi / lo like
    // any operand): S's C fragments are P's A fragments, V's rows read in
    // the same order
    add_product_tf32x3<BKT, DH, RF>(
        oacc, s, reinterpret_cast<const float*>(vt_s) + c0,
        reinterpret_cast<const float*>(vlo) + c0, lane);
    __syncthreads();  // the next tile's loads, splits and halves of S may
                      // overwrite these
    if ((kt + 1) % CHAIN == 0 && kt + 1 < nk) close_chain();
  }
  // a row's sum is spread over the 4 lanes of a quad (both warps of a
  // pair hold the same sums)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  float* lb = inv_l + (size_t(bi) * H + hi) * seq_q;
  if (summed) {
    if constexpr (!WIDE) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] += osum[(n * 4 + e) * NTH + tid];
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= seq_q) continue;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(
              out_row(rows[h]) + n * 8 + 2 * tq);
          oacc[n][2 * h] += y.x;
          oacc[n][2 * h + 1] += y.y;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= seq_q) continue;
    const float inv = 1.f / fmaxf(lsum[h], EPS);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(out_row(row) + n * 8 + 2 * tq) =
          make_float2(oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);
    if (tq == 0 && part == 0) lb[row] = inv;
  }
}

// ---------------------------------------------------------------------------
// Wide route on the tensor cores: bf16 q/k/v, or int8 q/k codes with bf16
// v, d a multiple of WCOL past 256.  Grid (query tiles, H, B x column
// blocks of MCOL), query tiles heaviest first; NT threads, warp w owning
// query rows q0 + 16w ..

constexpr int WCOL = 128;          // the wide route's d is a multiple of it
                                   // (ops/blocks.py WIDE_CHUNK)
constexpr int MCOL = 256;          // O columns of a block: a warp's 16 rows x
                                   // 256 f32 are 128 registers a thread
constexpr int MCB = 256;           // bytes of a Q / K row chunk
constexpr int MCS = MCB + 16;      // its shared row stride (17 16-byte units)
constexpr int MVS = 2 * MCOL + 16; // V tile row stride (33 units)
constexpr int MSTAGES = 3;         // Q and K chunk stages in flight
constexpr size_t MCHUNK = size_t(BQ + BK) * MCS;   // one stage
constexpr size_t MVT = size_t(BK) * MVS;           // one V tile
constexpr size_t WIDE_MMA_SMEM = MSTAGES * MCHUNK + 2 * MVT;

template <typename TQ>
__global__ void __launch_bounds__(NT, 1) fwd_wide_mma_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
    float* __restrict__ inv_l, int H, int KVH, int seq_q, int seq_k, int d,
    int causal, int bias_batch_dim, float c) {
  constexpr bool Q8 = is_int8<TQ>();
  constexpr int NS = BK / 8;       // n8 tiles of S
  constexpr int NO = MCOL / 8;     // n8 tiles of O
  constexpr int CPR = MCB / 16;    // 16-byte copies of a chunk row
  constexpr int VPR = 2 * MCOL / 16;  // ... and of a V tile row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* vs = smem + MSTAGES * MCHUNK;  // 2 V tiles

  const int ncb = (d + MCOL - 1) / MCOL;
  const int bi = blockIdx.z / ncb, c0 = (blockIdx.z % ncb) * MCOL;
  const int ncols = min(MCOL, d - c0);   // 256, or 128 (d an odd multiple)
  const int hi = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int kvhi = hi / (H / KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int diff = seq_k - seq_q;
  const int QB = d * int(sizeof(TQ));    // bytes of a q / k row
  const int nch = (QB + MCB - 1) / MCB;  // chunks of it (the last may be
                                         // 128 bytes: int8 codes)

  const unsigned char* qb = reinterpret_cast<const unsigned char*>(
      q + (size_t(bi) * H + hi) * seq_q * d);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      k + (size_t(bi) * KVH + kvhi) * seq_k * d);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      v + (size_t(bi) * KVH + kvhi) * seq_k * d + c0);
  const uint8_t* mb = mask ? mask + size_t(bi) * seq_k : nullptr;
  const float* bb =
      bias ? bias + size_t(bias_batch_dim ? bi : hi) * seq_q * seq_k : nullptr;

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + BQ, seq_q) - 1;
  const int kend = causal ? max(0, min(seq_k, last_row + diff + 1)) : seq_k;
  const int nk = (kend + BK - 1) / BK;
  const int steps = nk * nch;  // (key tile, chunk) pairs, chunks fastest

  // the copies a thread issues: 16 bytes at byte cq of chunk rows rq +
  // 8i (i < 8), and at byte cv of V rows rv + 4i (i < 16); each from one
  // base pointer a call, advanced by a fixed stride, so that no per-row
  // address stays live in registers across the steps
  const int rq = tid / CPR, cq = (tid % CPR) * 16;
  const int rv = tid / VPR, cv = (tid % VPR) * 16;
  const bool v_in = cv < 2 * ncols;  // else zeros (a 128-column remainder
                                     // block's P.V stops before them)
  // 64 rows from global row `first` (rows past `limit` as zeros) of a
  // chunk at byte `off` into shared rows MCS apart; the bytes past QB (an
  // int8 row's last, 128-byte chunk) are not copied, nor read
  auto load_chunk = [&](unsigned char* dst, const unsigned char* src,
                        int first, int limit, int off) {
    if (off + cq >= QB) return;
    const unsigned char* from = src + size_t(first + rq) * QB + off + cq;
    unsigned char* to = dst + rq * MCS + cq;
    const size_t step = size_t(NT / CPR) * QB;
#pragma unroll
    for (int i = 0; i < BQ * CPR / NT; ++i) {
      const bool in = first + rq + i * (NT / CPR) < limit;
      cp_async16(to, in ? from : src, in ? 16 : 0);
      from += step;
      to += (NT / CPR) * MCS;
    }
  };
  // step st's Q and K chunks into stage st % MSTAGES; a key tile's first
  // step also brings its V columns
  auto issue = [&](int st) {
    if (st < steps) {
      const int kt = st / nch, ch = st - kt * nch;
      unsigned char* qs = smem + (st % MSTAGES) * MCHUNK;
      load_chunk(qs, qb, q0, seq_q, ch * MCB);
      load_chunk(qs + BQ * MCS, kb, kt * BK, seq_k, ch * MCB);
      if (ch == 0) {
        const int first = kt * BK + rv;
        const unsigned char* from = vb + size_t(first) * 2 * d + cv;
        unsigned char* to = vs + (kt & 1) * MVT + rv * MVS + cv;
        const size_t step = size_t(NT / VPR) * 2 * d;
#pragma unroll
        for (int i = 0; i < BK * VPR / NT; ++i) {
          const bool in = v_in && first + i * (NT / VPR) < seq_k;
          cp_async16(to, in ? from : vb, in ? 16 : 0);
          from += step;
          to += (NT / VPR) * MVS;
        }
      }
    }
    cp_async_commit();
  };

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float lsum[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float s[NS][4];
  int si[Q8 ? NS : 1][4];

#pragma unroll
  for (int st = 0; st < MSTAGES - 1; ++st) issue(st);
  for (int st = 0; st < steps; ++st) {
    issue(st + MSTAGES - 1);
    cp_async_wait<MSTAGES - 1>();
    __syncthreads();  // step st's chunks (and its tile's V) have landed
    const int kt = st / nch, ch = st - kt * nch, k0 = kt * BK;
    // 32-byte k steps of the chunk: all 8 but in an int8 row's 128-byte
    // last chunk
    const int ksteps = Q8 ? min(MCB, QB - ch * MCB) / 32 : MCB / 32;
    const unsigned char* qs = smem + (st % MSTAGES) * MCHUNK;
    const unsigned char* ks = qs + BQ * MCS;
    if (ch == 0) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (Q8) si[n][e] = 0;
          else s[n][e] = 0.f;
        }
    }

    // S += Q.K^T over the chunk: an x4 ldmatrix of K gives the B fragments
    // of 2 n8 tiles
    const unsigned char* qrow = qs + (warp * 16 + (lane & 15)) * MCS + (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < MCB / 32; ++kk) {
      if (kk >= ksteps) break;
      uint32_t a[4];
      ldmatrix_x4(a, qrow + kk * 32);
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (j * 16 + (lane & 7) + (lane >> 4) * 8) * MCS +
                           kk * 32 + ((lane >> 3) & 1) * 16);
        if constexpr (Q8) {
          mma_s8(si[2 * j], a, b[0], b[1]);
          mma_s8(si[2 * j + 1], a, b[2], b[3]);
        } else {
          mma_bf16(s[2 * j], a, b[0], b[1]);
          mma_bf16(s[2 * j + 1], a, b[2], b[3]);
        }
      }
    }

    if (ch == nch - 1) {
      if constexpr (Q8) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = float(si[n][e]);
      }
      // e = exp2(s * c + bias * log2e), masked to 0, in the C layout, as
      // fwd_mma_kernel: whole tiles skip the masks
      const bool whole = mb == nullptr && bb == nullptr && k0 + BK <= seq_k &&
                         (!causal || k0 + BK - 1 <= q0 + diff);
      if (whole) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = exp2f(s[n][e] * c);
            lsum[e >> 1] += s[n][e];
          }
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int row = rows[h], col = k0 + n * 8 + 2 * tq + x;
              bool keep = row < seq_q && col < seq_k;
              if (causal) keep = keep && col <= row + diff;
              if (mb != nullptr) keep = keep && mb[col] != 0;
              float lg = s[n][2 * h + x] * c;
              if (bb != nullptr && keep) lg += bb[size_t(row) * seq_k + col] * LOG2E;
              const float e = keep ? exp2f(lg) : 0.f;
              lsum[h] += e;
              s[n][2 * h + x] = e;
            }
      }
      // O[:, cols] += P.V[:, cols]: S's C fragments of n8 tiles 2j, 2j + 1
      // are P's A fragment (rounded to bf16) of k16 step j, packed before
      // the products.  The loop stops at the block's columns: that bound
      // (a branch each 16 columns) keeps ptxas from hoisting the V loads
      // of the whole tile, which spilled at 255 registers
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      }
      const unsigned char* vt = vs + (kt & 1) * MVT;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int dn = 0; dn < MCOL / 16; ++dn) {
          if (dn * 16 >= ncols) break;
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * MVS +
                     (dn * 16 + (lane >> 4) * 8) * 2);
          mma_bf16(oacc[2 * dn], pa[j], b[0], b[1]);
          mma_bf16(oacc[2 * dn + 1], pa[j], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next steps' loads may overwrite these buffers
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  __nv_bfloat16* ob = o + (size_t(bi) * H + hi) * seq_q * d + c0;
  float* lb = inv_l + (size_t(bi) * H + hi) * seq_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= seq_q) continue;
    const float inv = 1.f / fmaxf(lsum[h], EPS);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 >= ncols) break;
      *reinterpret_cast<uint32_t*>(ob + size_t(row) * d + n * 8 + 2 * tq) =
          pack_bf16(oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);
    }
    if (tq == 0 && c0 == 0) lb[row] = inv;  // every column block has this l
  }
}

// ---------------------------------------------------------------------------
// Wide route on the tensor cores with float32 v and o, d a multiple of
// WCOL past 256: float32 q/k (3xTF32) or int8 q/k codes (S exact by the
// s8 mma.sync, P.V as 3xTF32).  Grid (B x column blocks of MCOL, H, query
// tiles), query tiles slowest and heaviest first; FT_NT threads: warp w
// owns query rows q0 + 16 (w % 2) .., sums S over quarter w / 2 of every
// chunk and forms O over that quarter of the block's columns.

constexpr int FT_NT = 256;               // threads: 8 warps, four a 16 rows
constexpr int FT_BQ = 32;                // query rows a block
constexpr int FT_BK = 32;                // keys a tile
constexpr int FT_RF = MCOL + 4;          // V tile row stride, floats (4 mod 16)
constexpr int FT_STAGES = 4;             // chunk stages in flight
template <typename TQ>
struct FtLayout {
  static constexpr bool Q8 = is_int8<TQ>();
  static constexpr int ES = int(sizeof(TQ));
  // d lanes of a Q / K chunk: 64 floats or 128 codes, so a warp's quarter
  // is two 32-byte k steps (tf32 m16n8k8) or one (s8 m16n8k32)
  static constexpr int KC = Q8 ? 128 : 64;
  static constexpr int CB = KC * ES;      // bytes of a chunk row
  static constexpr int CS = CB + 16;      // its shared row stride (odd units)
  // bytes of the widest Q row that stays resident: d 512 in f32, 2048 codes
  static constexpr int QRES = 2048;
  // K's rows of a chunk stage: hi and lo (floats), or the codes
  static constexpr int KROWS = Q8 ? FT_BK : 2 * FT_BK;
  // the block's Q rows, resident while a row holds at most QRES bytes
  // (rows of d ES + 16 bytes: an odd count of 16-byte units); the chunk
  // stages (past QRES Q's FT_BQ rows, then K's rows); the V tile (FT_BK
  // keys x MCOL columns) and its lo; the warps' quarters of S (8 warps x
  // the S tile's C fragments)
  static constexpr size_t VT = size_t(FT_BK) * FT_RF * 4;
  static constexpr size_t XSB = size_t(FT_NT) * (FT_BK / 2) * 4;
  __host__ __device__ static bool qres(int d) { return d * ES <= QRES; }
  __host__ __device__ static int qstride(int d) { return d * ES + 16; }
  __host__ __device__ static size_t ring(int d) {
    return qres(d) ? size_t(FT_BQ) * qstride(d) : 0;
  }
  __host__ __device__ static size_t chunk(int d) {
    return size_t((qres(d) ? 0 : FT_BQ) + KROWS) * CS;
  }
  __host__ __device__ static size_t vs(int d) {
    return ring(d) + FT_STAGES * chunk(d);
  }
  __host__ __device__ static size_t smem(int d) { return vs(d) + 2 * VT + XSB; }
  // the most of it at any d: Q resident at QRES, or streamed
  static constexpr size_t MOST =
      (size_t(FT_BQ) * (QRES + 16) + FT_STAGES * size_t(KROWS) * CS >
               FT_STAGES * size_t(FT_BQ + KROWS) * CS
           ? size_t(FT_BQ) * (QRES + 16) + FT_STAGES * size_t(KROWS) * CS
           : FT_STAGES * size_t(FT_BQ + KROWS) * CS) +
      2 * VT + XSB;
};
static_assert(FtLayout<float>::MOST <= 232448 &&
                  FtLayout<int8_t>::MOST <= 232448,
              "the wide f32 K1's shared memory");

template <typename TQ>
__global__ void __launch_bounds__(FT_NT, 1) fwd_wide_tf32_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ mask,
    const float* __restrict__ bias, float* __restrict__ o,
    float* __restrict__ inv_l, int H, int KVH, int seq_q, int seq_k, int d,
    int causal, int bias_batch_dim, float c) {
  using L = FtLayout<TQ>;
  constexpr bool Q8 = L::Q8;
  constexpr int CS = L::CS, CB = L::CB;
  constexpr int NS = FT_BK / 8;          // n8 tiles of S
  constexpr int NO = MCOL / 4 / 8;       // n8 tiles of a warp's O (at most)
  constexpr int KSTEPS = CB / 4 / 32;    // k steps of a warp's quarter chunk
  constexpr int CPR = CB / 16;           // 16-byte copies of a chunk row
  constexpr int VPR = MCOL / 4;          // ... and of a V tile row
  extern __shared__ __align__(16) unsigned char smem[];
  const bool qres = L::qres(d);
  const int qs_ = L::qstride(d);
  unsigned char* ring = smem + L::ring(d);
  const size_t chunk = L::chunk(d);
  const int kofs = qres ? 0 : FT_BQ * CS;  // K's rows in a stage
  unsigned char* vt = smem + L::vs(d);
  unsigned char* vlo = vt + L::VT;
  float* xs = reinterpret_cast<float*>(vlo + L::VT);

  const int ncb = (d + MCOL - 1) / MCOL;
  const int bi = blockIdx.x / ncb, c0 = (blockIdx.x % ncb) * MCOL;
  const int ncols = min(MCOL, d - c0);  // 256, or 128 (d an odd multiple)
  const int hi = blockIdx.y;
  // heaviest tiles first, over the whole grid
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FT_BQ;
  const int kvhi = hi / (H / KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp & 1, part = warp >> 1;  // its 16 rows, its quarter
  const int wcols = ncols / 4;                // the warp's O columns
  const int diff = seq_k - seq_q;
  const int nch = d / L::KC;                  // chunks of a row
  const size_t rowb = size_t(d) * L::ES;      // bytes of a q / k row

  const unsigned char* qb = reinterpret_cast<const unsigned char*>(
      q + (size_t(bi) * H + hi) * seq_q * d);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      k + (size_t(bi) * KVH + kvhi) * seq_k * d);
  const float* vb = v + (size_t(bi) * KVH + kvhi) * seq_k * d + c0;
  const uint8_t* mb = mask ? mask + size_t(bi) * seq_k : nullptr;
  const float* bb =
      bias ? bias + size_t(bias_batch_dim ? bi : hi) * seq_q * seq_k : nullptr;

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + FT_BQ, seq_q) - 1;
  const int kend = causal ? max(0, min(seq_k, last_row + diff + 1)) : seq_k;
  const int nk = (kend + FT_BK - 1) / FT_BK;
  const int steps = nk * nch;  // (key tile, chunk) pairs, chunks fastest

  // `nrows` rows from global row `first` (rows past `limit` as zeros) of a
  // chunk at byte `off` into shared rows CS apart
  auto load_chunk = [&](unsigned char* dst, const unsigned char* src,
                        int first, int nrows, int limit, int off) {
    for (int idx = tid; idx < nrows * CPR; idx += FT_NT) {
      const int r = idx / CPR, cc = (idx % CPR) * 16, row = first + r;
      const bool in = row < limit;
      cp_async16(dst + r * CS + cc, in ? src + size_t(row) * rowb + off + cc : src,
                 in ? 16 : 0);
    }
  };
  // step st's K chunk (and past QRES its Q chunk) into stage st %
  // FT_STAGES
  auto issue = [&](int st) {
    if (st < steps) {
      const int kt = st / nch, ch = st - kt * nch;
      unsigned char* stg = ring + (st % FT_STAGES) * chunk;
      if (!qres) load_chunk(stg, qb, q0, FT_BQ, seq_q, ch * CB);
      load_chunk(stg + kofs, kb, kt * FT_BK, FT_BK, seq_k, ch * CB);
    }
    cp_async_commit();
  };
  // key tile kt's V columns (zeros past the block's columns), with a
  // step's chunks
  auto load_v = [&](int kt) {
    for (int idx = tid; idx < FT_BK * VPR; idx += FT_NT) {
      const int r = idx / VPR, cc = (idx % VPR) * 4, row = kt * FT_BK + r;
      const bool in = row < seq_k && cc < ncols;
      cp_async16(vt + (r * FT_RF + cc) * 4, in ? vb + size_t(row) * d + cc : vb,
                 in ? 16 : 0);
    }
  };
  // the 16-byte words this thread copied (same loops as issue's) split in
  // place into their tf32 hi, each lo at the same place of `lo`: once its
  // own copies have landed a thread may read them before any barrier, so
  // the float K chunk and the V tile, which four warps each read, are
  // split once for the block at no barrier of their own
  auto split_own = [&](unsigned char* hi_, unsigned char* lo_, int per_row,
                       int stride) {
    for (int idx = tid; idx < FT_BK * per_row; idx += FT_NT) {
      const int at = (idx / per_row) * stride + (idx % per_row) * 16;
      const float4 x = *reinterpret_cast<const float4*>(hi_ + at);
      uint4 h, l;
      split_tf32(x.x, h.x, l.x);
      split_tf32(x.y, h.y, l.y);
      split_tf32(x.z, h.z, l.z);
      split_tf32(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi_ + at) = h;
      *reinterpret_cast<uint4*>(lo_ + at) = l;
    }
  };

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float lsum[2] = {0.f, 0.f};
  const int rows[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  // the warp's Q rows, resident or in a chunk stage, from its quarter's
  // first k step
  const int qrow = (rg * 16 + (lane & 15)) * (qres ? qs_ : CS) +
                   (lane >> 4) * 16 + part * KSTEPS * 32;

  // O sums every visible key, each mma rounding its sum toward zero: every
  // CHAIN tiles (256 keys) the chain is closed into the thread's own words
  // of o, added to nearest, and restarts from 0 (rows past seq_q are
  // dropped: they are never stored)
  constexpr int CHAIN = 256 / FT_BK;
  float* const oh = o + (size_t(bi) * H + hi) * seq_q * d + c0 + part * wcols;
  auto out_row = [&](int row) { return oh + size_t(row) * d; };
  bool summed = false;
  auto close_chain = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= seq_q) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (n * 8 >= wcols) break;
        float2* w = reinterpret_cast<float2*>(out_row(rows[h]) + n * 8 + 2 * tq);
        float2 x = make_float2(oacc[n][2 * h], oacc[n][2 * h + 1]);
        if (summed) {
          const float2 y = *w;
          x.x += y.x, x.y += y.y;
        }
        *w = x;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
    summed = true;
  };

  if (qres && nk > 0) {  // the block's Q rows, once
    const int per_row = int(rowb / 16);
    for (int idx = tid; idx < FT_BQ * per_row; idx += FT_NT) {
      const int r = idx / per_row, cc = (idx % per_row) * 16, row = q0 + r;
      const bool in = row < seq_q;
      cp_async16(smem + r * qs_ + cc, in ? qb + size_t(row) * rowb + cc : qb,
                 in ? 16 : 0);
    }
  }
#pragma unroll
  for (int st = 0; st < FT_STAGES - 1; ++st) issue(st);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * FT_BK;
    // S = Q.K^T: the float products in four accumulators, hi.hi in sb, the
    // small terms lo.hi + hi.lo in sm, each by the k step's parity
    // (shorter chains of sums that the tensor cores round toward zero,
    // over twice the d 256 instance's lanes a warp); the int8 codes' in
    // exact int32 sums (si: |s| <= 127^2 d, below 2^31)
    float sb[2][NS][4], sm[2][NS][4];
    int si[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (Q8) {
          si[n][e] = 0;
        } else {
          sb[0][n][e] = sm[0][n][e] = sb[1][n][e] = sm[1][n][e] = 0.f;
        }
      }
    for (int ch = 0; ch < nch; ++ch) {
      const int st = kt * nch + ch;
      unsigned char* stg = ring + (st % FT_STAGES) * chunk;
      const unsigned char* qs = qres ? smem + ch * CB : stg;
      unsigned char* ks = stg + kofs;
      unsigned char* klo = ks + FT_BK * CS;  // floats only
      // this thread's copies of step st; at a tile's last step also its V,
      // which lands FT_STAGES - 1 steps after the tile's first: with fewer
      // chunks than that (int8 codes at d 384) every copy in flight
      if (ch == nch - 1 && nch < FT_STAGES)
        cp_async_wait<0>();
      else
        cp_async_wait<FT_STAGES - 2>();
      if constexpr (!Q8) split_own(ks, klo, CPR, CS);
      if (ch == nch - 1) split_own(vt, vlo, VPR, FT_RF * 4);
      __syncthreads();  // step st's chunks (and at the tile's last, its V)
                        // landed and split; step st - 1's readers are done
      // the tile's V once the last tile's products are done
      if (ch == 0) load_v(kt);
      issue(st + FT_STAGES - 1);  // into step st - 1's stage
      // S += Q.K^T over the warp's quarter of the chunk: x4 ldmatrix of K
      // (float: its hi and lo) give the B fragments of 2 n8 tiles; a warp
      // reads only its own Q rows, float ones split as they are read
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qs + qrow + kk * 32);
        if constexpr (Q8) {
#pragma unroll
          for (int j = 0; j < NS / 2; ++j) {
            uint32_t b[4];
            ldmatrix_x4(b, ks + (j * 16 + (lane & 7) + (lane >> 4) * 8) * CS +
                               part * KSTEPS * 32 + kk * 32 +
                               ((lane >> 3) & 1) * 16);
            mma_s8(si[2 * j], a, b[0], b[1]);
            mma_s8(si[2 * j + 1], a, b[2], b[3]);
          }
        } else {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
          const int r = kk & 1;
#pragma unroll
          for (int j = 0; j < NS / 2; ++j) {
            const int brow = (j * 16 + (lane & 7) + (lane >> 4) * 8) * CS +
                             part * KSTEPS * 32 + kk * 32 +
                             ((lane >> 3) & 1) * 16;
            uint32_t bh[4], bl[4];
            ldmatrix_x4(bh, ks + brow);
            ldmatrix_x4(bl, klo + brow);
            mma_tf32(sm[r][2 * j], al, bh[0], bh[1]);
            mma_tf32(sm[r][2 * j], ah, bl[0], bl[1]);
            mma_tf32(sb[r][2 * j], ah, bh[0], bh[1]);
            mma_tf32(sm[r][2 * j + 1], al, bh[2], bh[3]);
            mma_tf32(sm[r][2 * j + 1], ah, bl[2], bl[3]);
            mma_tf32(sb[r][2 * j + 1], ah, bh[2], bh[3]);
          }
        }
      }
    }

    // the tile's S: the warp's quarter, then the four quarters of its rows
    // added in the same order by each of their warps (so all form the same
    // e): word (n, e) of a lane at xs[((rg * 4 + part) * NS * 4 + n * 4 +
    // e) * 32 + lane]
    constexpr int QW = NS * 4 * 32;  // a warp's words
    float s[NS][4];
    float* mine = xs + (rg * 4 + part) * QW + lane;
    const float* h0 = xs + rg * 4 * QW + lane;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(n * 4 + e) * 32] =
            Q8 ? float(si[n][e])
               : (sb[0][n][e] + sb[1][n][e]) + (sm[0][n][e] + sm[1][n][e]);
    warps_sync(1 + rg, 128);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int w = (n * 4 + e) * 32;
        s[n][e] = (h0[w] + h0[QW + w]) + (h0[2 * QW + w] + h0[3 * QW + w]);
      }

    // e = exp2(s * c + bias * log2e), masked to 0, as in fwd_mma_kernel
    const bool whole = mb == nullptr && bb == nullptr && k0 + FT_BK <= seq_k &&
                       (!causal || k0 + FT_BK - 1 <= q0 + diff);
    if (whole) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] * c);
          lsum[e >> 1] += s[n][e];
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int row = rows[h], col = k0 + n * 8 + 2 * tq + x;
            bool keep = row < seq_q && col < seq_k;
            if (causal) keep = keep && col <= row + diff;
            if (mb != nullptr) keep = keep && mb[col] != 0;
            float lg = s[n][2 * h + x] * c;
            if (bb != nullptr && keep) lg += bb[size_t(row) * seq_k + col] * LOG2E;
            const float e = keep ? exp2f(lg) : 0.f;
            lsum[h] += e;
            s[n][2 * h + x] = e;
          }
    }
    // O[:, the warp's columns] += P.V with P in f32, split in registers:
    // S's C fragments are P's A fragments, V's rows read in the same order
    add_product_tf32x3<FT_BK, MCOL / 4, FT_RF>(
        oacc, s, reinterpret_cast<const float*>(vt) + part * wcols,
        reinterpret_cast<const float*>(vlo) + part * wcols, lane, wcols / 8);
    if ((kt + 1) % CHAIN == 0 && kt + 1 < nk) close_chain();
  }
  cp_async_wait<0>();

  // a row's sum is spread over the 4 lanes of a quad (the four warps of
  // its rows hold the same sums)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  float* lb = inv_l + (size_t(bi) * H + hi) * seq_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= seq_q) continue;
    const float inv = 1.f / fmaxf(lsum[h], EPS);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 >= wcols) break;
      float2* w = reinterpret_cast<float2*>(out_row(row) + n * 8 + 2 * tq);
      float2 x = make_float2(oacc[n][2 * h], oacc[n][2 * h + 1]);
      if (summed) {
        const float2 y = *w;
        x.x += y.x, x.y += y.y;
      }
      *w = make_float2(x.x * inv, x.y * inv);
    }
    // every column block has this l
    if (tq == 0 && part == 0 && c0 == 0) lb[row] = inv;
  }
}

// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const uint8_t* mask;
  const float* bias;
  void* o;
  float* inv_l;
  int B, H, KVH, seq_q, seq_k, causal, bias_batch_dim;
  float c;
};

template <typename TQ, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  // 16-byte copies: every row is a 16-byte multiple, so aligned bases do
  for (const void* p : {a.q, a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  constexpr size_t smem = MmaLayout<TQ, D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_mma_kernel<TQ, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_q + BQ - 1) / BQ, a.H, a.B);
  fwd_mma_kernel<TQ, D><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.mask, a.bias,
      static_cast<__nv_bfloat16*>(a.o), a.inv_l, a.H, a.KVH, a.seq_q,
      a.seq_k, a.causal, a.bias_batch_dim, a.c);
  return cudaGetLastError();
}

template <int D, typename TQ>
cudaError_t launch_tf32(const Args& a, cudaStream_t stream) {
  // 16-byte copies: every row is a 16-byte multiple, so aligned bases do
  for (const void* p : {a.q, a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  using L = Tf32Layout<D, TQ>;
  static_assert(L::SMEM <= 232448, "K1 f32 shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tf32_kernel<D, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(L::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_q + BQ - 1) / BQ, a.H, a.B);
  fwd_tf32_kernel<D, TQ><<<grid, L::NT, L::SMEM, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
      static_cast<const float*>(a.v), a.mask, a.bias,
      static_cast<float*>(a.o), a.inv_l, a.H, a.KVH, a.seq_q, a.seq_k,
      a.causal, a.bias_batch_dim, a.c);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_wide_mma(int d, const Args& a, cudaStream_t stream) {
  if (d % WCOL != 0) return cudaErrorInvalidValue;
  for (const void* p : {a.q, a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wide_mma_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(WIDE_MMA_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_q + BQ - 1) / BQ, a.H, a.B * ((d + MCOL - 1) / MCOL));
  fwd_wide_mma_kernel<TQ><<<grid, NT, WIDE_MMA_SMEM, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.mask, a.bias,
      static_cast<__nv_bfloat16*>(a.o), a.inv_l, a.H, a.KVH, a.seq_q,
      a.seq_k, d, a.causal, a.bias_batch_dim, a.c);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_wide_tf32(int d, const Args& a, cudaStream_t stream) {
  if (d % WCOL != 0) return cudaErrorInvalidValue;
  // 16-byte copies: every row is a 16-byte multiple, so aligned bases do
  for (const void* p : {a.q, a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const size_t smem = FtLayout<TQ>::smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wide_tf32_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * ((d + MCOL - 1) / MCOL), a.H,
                  (a.seq_q + FT_BQ - 1) / FT_BQ);
  fwd_wide_tf32_kernel<TQ><<<grid, FT_NT, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
      static_cast<const float*>(a.v), a.mask, a.bias, static_cast<float*>(a.o),
      a.inv_l, a.H, a.KVH, a.seq_q, a.seq_k, d, a.causal, a.bias_batch_dim,
      a.c);
  return cudaGetLastError();
}

// bf16 v and o: bf16 q/k, or int8 q/k codes
template <typename TQ>
cudaError_t dispatch_mma(int d, const Args& a, cudaStream_t s) {
  switch (d) {
    case 16: return launch_mma<TQ, 16>(a, s);
    case 32: return launch_mma<TQ, 32>(a, s);
    case 64: return launch_mma<TQ, 64>(a, s);
    case 96: return launch_mma<TQ, 96>(a, s);
    case 128: return launch_mma<TQ, 128>(a, s);
    case 192: return launch_mma<TQ, 192>(a, s);
    case 256: return launch_mma<TQ, 256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// f32 v and o: float32 q/k (3xTF32), or int8 q/k codes (P.V 3xTF32)
template <typename TQ>
cudaError_t dispatch_tf32(int d, const Args& a, cudaStream_t s) {
  switch (d) {
    case 16: return launch_tf32<16, TQ>(a, s);
    case 32: return launch_tf32<32, TQ>(a, s);
    case 64: return launch_tf32<64, TQ>(a, s);
    case 96: return launch_tf32<96, TQ>(a, s);
    case 128: return launch_tf32<128, TQ>(a, s);
    case 192: return launch_tf32<192, TQ>(a, s);
    case 256: return launch_tf32<256, TQ>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); 2 = int8 q/k
// codes with float32 v and o; 3 = int8 q/k codes with bfloat16 v and o.
// Every dtype runs on the tensor cores at every width: 1 and 3 by bf16 and
// s8 mma.sync (fwd_mma_kernel), 0 and 2 with P.V, and 0's S, as 3xTF32
// (fwd_tf32_kernel), 2's S by s8 mma.sync.  d past 256 (a multiple of 128)
// takes the wide route: fwd_wide_mma_kernel for 1 and 3,
// fwd_wide_tf32_kernel for 0 and 2.
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
  const bool q8 = dtype == 2 || dtype == 3;
  const float c = float(double(scale) * 1.4426950408889634 *
                        (q8 ? double(s_dequant) : 1.0));
  const Args a{q, k, v, static_cast<const uint8_t*>(mask),
               static_cast<const float*>(bias), o, static_cast<float*>(inv_l),
               B, H, KVH, seq_q, seq_k, causal, bias_batch_dim, c};
  auto s = static_cast<cudaStream_t>(stream);
  if (d > 256) {  // the wide route: d a multiple of WCOL
    switch (dtype) {
      case 0: return int(launch_wide_tf32<float>(d, a, s));
      case 1: return int(launch_wide_mma<__nv_bfloat16>(d, a, s));
      case 2: return int(launch_wide_tf32<int8_t>(d, a, s));
      case 3: return int(launch_wide_mma<int8_t>(d, a, s));
      default: return int(cudaErrorInvalidValue);
    }
  }
  switch (dtype) {
    case 0: return int(dispatch_tf32<float>(d, a, s));
    case 1: return int(dispatch_mma<__nv_bfloat16>(d, a, s));
    case 2: return int(dispatch_tf32<int8_t>(d, a, s));
    case 3: return int(dispatch_mma<int8_t>(d, a, s));
    default: return int(cudaErrorInvalidValue);
  }
}
