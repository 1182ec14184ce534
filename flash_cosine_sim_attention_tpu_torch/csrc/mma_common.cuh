// Tensor-core and asynchronous-copy helpers shared by the forward kernel
// (fwd_kernel.cu), the backward's dK/dV kernel (bwd_kernel.cu), the
// int8-weight matmul (quant_matmul_kernel.cu) and the two decode kernels
// (decode_common.cuh): 16-, 8- and 4-byte `cp.async` with zero-fill, a
// block's loader of rows into shared memory, `ldmatrix`, the `mma.sync`
// products they run (bf16 m16n8k16, s8 m16n8k32 and tf32 m16n8k8, f32 /
// s32 sums), with the hi / lo split of a float into two tf32 operands, and
// a barrier of a few warps.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k32): with g = lane / 4
// and q = lane % 4, a thread's C fragment holds rows g and g + 8, columns
// 2q and 2q + 1; its A fragment a0..a3 holds (row g, k bytes 4q..4q+3),
// (g + 8, same), (g, 16 + 4q..), (g + 8, 16 + 4q..) of a 32-byte k step,
// and its B fragment b0, b1 holds (k bytes 4q..4q+3, column g) and
// (16 + 4q.., g).  So one `ldmatrix.x4` of a row-major 16-row tile, lanes
// 0-15 addressing rows 0-15 at byte 0 and lanes 16-31 the same rows at
// byte 16, yields an A fragment for bf16 and int8 alike.
//
// mma.m16n8k8 on tf32 (one 32-byte k step of 8 floats): a0..a3 hold (row
// g, k q), (g + 8, q), (g, q + 4), (g + 8, q + 4); b0, b1 hold (k q,
// column g) and (k q + 4, g); C as above.  So the same ldmatrix.x4 of a
// row-major 16-row f32 tile (lanes 0-15 at byte 0, 16-31 at byte 16)
// yields an A fragment, and one of 16 key rows a pair of B fragments,
// exactly as for bf16: the 16-bit matrices only move whole 32-bit words.
// A float fed unconverted to a tf32 mma has its low 13 bits ignored
// (truncated, not rounded), so every operand goes through split_tf32.
// The mma's f32 sums are rounded toward zero, and a long chain of them on
// one accumulator drifts: where a sum feeds an exponential (S = Q.K^T in
// the forward) the small terms are kept in an accumulator of their own.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with src_bytes 0 nothing is read
// and the 16 bytes are written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 8 bytes (through L1, for rows that are 8- but not 16-byte aligned);
// with src_bytes 0 nothing is read and the 8 bytes are written as zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes (through L1, for rows that are not 16-byte aligned); with
// src_bytes 0 nothing is read and the 4 bytes are written as zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `nrows` rows of RB bytes from global rows [first, first + nrows) of `src`
// (rows past `limit` as zeros) to shared memory rows RS bytes apart, 16
// bytes a copy, by the block's NTH threads
template <int RB, int RS, int NTH>
__device__ __forceinline__ void load_rows(unsigned char* dst, const void* src,
                                          int first, int nrows, int limit) {
  constexpr int chunks = RB / 16;
  const unsigned char* sb = static_cast<const unsigned char*>(src);
  for (int idx = threadIdx.x; idx < nrows * chunks; idx += NTH) {
    const int r = idx / chunks, cc = (idx % chunks) * 16, row = first + r;
    const bool in = row < limit;
    cp_async16(dst + r * RS + cc, in ? sb + size_t(row) * RB + cc : sb,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on bf16 inputs, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on tf32 inputs (f32 words whose low 13 bits are zero), f32
// sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 explicit mantissa bits, to nearest, ties to even)
// by cvt.rn.tf32.f32, one instruction on sm_90, its low 13 bits cleared.
// A NaN stays a NaN and an infinity stays.  (cvt.rna.tf32.f32, ties away
// from zero, expands into a longer sequence and took K1 and K2 longer;
// adding 0x1000 to the bit pattern rounds a finite word as cvt.rna does
// in two integer operations, but carries the card's NaN, 0x7fffffff, into
// -0, and guarding it cost more than the instruction.)
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  uint32_t u;
  asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u & 0xffffe000u;
}

// x as hi + lo, both tf32: hi = rn(x), lo = rn(x - hi) (x - hi is exact
// in f32), so hi + lo holds x to ~22 bits; a product that takes lo.hi +
// hi.lo + hi.hi sees f32 operands to ~2^-21 of each
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// C += a . b on f32 operands as three tf32 products, small terms first
// (lo.lo dropped): a, b as their (hi, lo) fragments
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Each word of `rows` rows of D floats at `hi` (rows RS bytes apart)
// replaced by its tf32 hi, its lo written at the same place of `lo`: a tile
// that several warps read is split once, by the block's NTH threads
template <int D, int RS, int NTH>
__device__ __forceinline__ void split_rows(unsigned char* hi, unsigned char* lo,
                                           int rows) {
  constexpr int chunks = D / 4;  // 16-byte words of a row
  for (int idx = threadIdx.x; idx < rows * chunks; idx += NTH) {
    const int at = (idx / chunks) * RS + (idx % chunks) * 16;
    const float4 x = *reinterpret_cast<const float4*>(hi + at);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// acc (16 x D, C fragments) += c . src on f32 operands (3xTF32): c is a
// (16 x N) f32 tile in C fragments, split hi / lo here; src an (N x D) f32
// tile in shared memory, rows RF floats apart, split by split_rows into
// `src` (hi) and `src_lo`.  The C fragment of n8 tile j holds columns 8j
// + 2q and 8j + 2q + 1; they serve as the tf32 A fragment's k indices q
// and q + 4 when src's rows are read in the same order (row 8j + 2q for k
// q, 8j + 2q + 1 for k q + 4).  A permutation of the summed index on both
// operands leaves the product unchanged, so no value moves between lanes;
// with RF = 4 (mod 16) the two rows a lane reads sit 8 banks apart and a
// warp's 32 reads hit 32 banks.  Only acc's first nd8 n8 tiles are formed
// (the wide route's blocks that own fewer columns; a branch each tile).
template <int N, int D, int RF>
__device__ __forceinline__ void add_product_tf32x3(float (&acc)[D / 8][4],
                                                   const float (&c)[N / 8][4],
                                                   const float* src,
                                                   const float* src_lo,
                                                   int lane, int nd8 = D / 8) {
  const int at = (2 * (lane & 3)) * RF + (lane >> 2);
  const float* bh = src + at;
  const float* bl = src_lo + at;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(c[j][0], ah[0], al[0]);
    split_tf32(c[j][2], ah[1], al[1]);
    split_tf32(c[j][1], ah[2], al[2]);
    split_tf32(c[j][3], ah[3], al[3]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      if (dn >= nd8) break;
      const int r0 = j * 8 * RF + dn * 8, r1 = r0 + RF;
      mma_tf32x3(acc[dn], ah, al, __float_as_uint(bh[r0]),
                 __float_as_uint(bh[r1]), __float_as_uint(bl[r0]),
                 __float_as_uint(bl[r1]));
    }
  }
}

// add_product_tf32x3 with src's words split as they are read (no lo
// tile): for a tile that one warp reads alone, or that has no room for
// its lo
template <int N, int D, int RF>
__device__ __forceinline__ void add_product_tf32x3(float (&acc)[D / 8][4],
                                                   const float (&c)[N / 8][4],
                                                   const float* src,
                                                   int lane, int nd8 = D / 8) {
  const float* b = src + (2 * (lane & 3)) * RF + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(c[j][0], ah[0], al[0]);
    split_tf32(c[j][2], ah[1], al[1]);
    split_tf32(c[j][1], ah[2], al[2]);
    split_tf32(c[j][3], ah[3], al[3]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      if (dn >= nd8) break;
      const int r0 = j * 8 * RF + dn * 8;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b[r0], bh0, bl0);
      split_tf32(b[r0 + RF], bh1, bl1);
      mma_tf32x3(acc[dn], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// bar.sync on barrier `id` (1-15; 0 is __syncthreads) by `threads`
// threads, whole warps: a warp pair's or a few warps' barrier
__device__ __forceinline__ void warps_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) { warps_sync(id, 64); }

// d += a . b on int8 inputs, exact int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half (the lower address)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace
