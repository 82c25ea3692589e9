// Tensor-core building blocks shared by the flash kernels: cp.async copies
// from global to shared memory, ldmatrix fragment loads and the
// mma.sync.m16n8k16 bf16 product with an f32 accumulator, and the
// swizzled shared-memory tile that cp.async fills and ldmatrix reads; for
// f32 inputs, the m16n8k8 TF32 product, the split of an f32 value into
// two TF32 halves and the padded f32 tile (at the end of this file).
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4):
//   A (16x16, row-major), 4 registers of 2 bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, cols 2t..), a2 (row g, cols 2t+8..), a3 (row g+8,
//     cols 2t+8..);
//   B (16x8, column-major), 2 registers: b0 (rows 2t, 2t+1, col g),
//     b1 (rows 2t+8, 2t+9, col g);
//   C (16x8 f32), 4 registers: c0, c1 (row g, cols 2t, 2t+1), c2, c3
//     (row g+8, cols 2t, 2t+1).
// ldmatrix.x4 loads four 8x8 matrices; lanes 8j..8j+7 give the addresses
// of matrix j's eight 16-byte rows.  Without .trans lane l receives row
// l/4, elements 2(l%4) and 2(l%4)+1 of each; with .trans the transposed.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes; reads src_bytes of them (0 or 16) and zero-fills the
// rest.  dst and src must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

// A [rows][D] bf16 tile in shared memory, addressed in 16-byte chunks of 8
// elements.  Where a row holds a multiple of 8 chunks (D 64, 128), chunk c
// of row r sits at c ^ (r % 8); other D pad each row by one chunk (an odd
// number of chunks a row).  Either way the eight rows an ldmatrix phase
// reads at one chunk index fall in eight different bank groups.
template <int D>
struct Tile {
  static constexpr int kChunks = D / 8;
  static constexpr bool kSwizzle = kChunks % 8 == 0;
  static constexpr int kStride = kSwizzle ? D : D + 8;  // elements a row
  __device__ static __forceinline__ int at(int row, int chunk) {
    return row * kStride + (kSwizzle ? chunk ^ (row & 7) : chunk) * 8;
  }
};

// Issues the cp.async copies of rows [r0, r0 + kRows) of a [n_rows][D]
// matrix with row stride `stride` into a tile of layout L, spread over the
// kThreads threads of the CTA; rows past n_rows are zero-filled.
template <class L, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0,
                                          int n_rows) {
  constexpr int kCopies = kRows * L::kChunks;
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kCopies % kThreads != 0 && idx >= kCopies) break;
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + L::at(r, c), ok ? src + (r0 + r) * stride + c * 8 : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// f32 at f32 accuracy on the tensor cores: split TF32
// ---------------------------------------------------------------------------
//
// Each f32 operand x is split as hi = tf32(x), lo = tf32(x - hi), both
// rounded to nearest with ties away from zero (as cvt.rna rounds), and
// A.B is summed as lo.hi + hi.lo + hi.hi in one f32 accumulator (lo.lo
// dropped): about 21 bits of each operand, the product CUTLASS calls
// OpMultiplyAddFastF32.  Single-pass TF32 keeps about 11.
//
// Fragment layouts of m16n8k8 with .tf32 operands, one 32-bit register
// an element (lane = 4 * g + t):
//   A (16x8, row-major): a0 (row g, col t), a1 (row g+8, col t),
//     a2 (row g, col t+4), a3 (row g+8, col t+4);
//   B (8x8, column-major): b0 (row t, col g), b1 (row t+4, col g);
//   C as in m16n8k16.
// An 8x4 f32 block is an 8x8 b16 matrix, so ldmatrix (without .trans)
// hands lane (g, t) row g, word t of each of its four blocks: the A
// layout, and B's where B's columns are rows of a row-major tile.
// ldmatrix cannot transpose 32-bit elements; a B whose k index runs
// down a tile's rows is read by scalar loads.
//
// A C fragment is not an A fragment: a lane holds C columns 2t and 2t+1,
// A wants columns t and t+4.  A sum over k does not depend on the order
// of k, so a product whose A is a C fragment permutes k alike on both
// sides: A's columns (t, t+4) are read as C's (2t, 2t+1), and B's rows
// (t, t+4) are taken from rows 2t and 2t+1 of the tile.

// hi and lo of each of the N f32 values (as bits) in x.  Rounding adds
// half a TF32 step to the magnitude's bits; the tensor core ignores the
// 13 bits below the step, and hi's are cleared for the subtraction,
// which is then exact.  For finite x this is cvt.rna.tf32.f32's result,
// in four instructions an element (add, clear, subtract, add) where
// cvt.rna, which also guards inf and NaN (FSETP, SEL), takes eight.
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = (x[i] + 0x1000u) & 0xffffe000u;
    lo[i] = __float_as_uint(__uint_as_float(x[i]) -
                            __uint_as_float(hi[i])) +
            0x1000u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A.B at f32 accuracy from the split halves of A and of B's (b0, b1):
// the two small terms first, then hi.hi
__device__ __forceinline__ void mma_split_tf32(float (&c)[4],
                                               const uint32_t (&a_hi)[4],
                                               const uint32_t (&a_lo)[4],
                                               uint32_t b0_hi, uint32_t b1_hi,
                                               uint32_t b0_lo,
                                               uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

// A [rows][D] f32 tile in shared memory, each row padded by 4 words so
// that rows sit 4 (mod 8) words apart (D is a multiple of 16): the eight
// rows an ldmatrix phase reads at one 16-byte column fall in eight
// different groups of four banks, and the scalar loads of a transposed B
// fragment (lane (g, t) at rows 2t and 2t + 1, column g) hit 32 banks,
// since 2t * stride is 8t or 24t (mod 32).
template <int D>
struct TileF32 {
  static constexpr int kChunks = D / 4;   // 16-byte chunks a row
  static constexpr int kStride = D + 4;   // words a row
  __device__ static __forceinline__ int at(int row, int col) {
    return row * kStride + col;
  }
};

// Issues the cp.async copies of rows [r0, r0 + kRows) of a [n_rows][D] f32
// matrix with row stride `stride` (rows 16-byte aligned) into a tile of
// layout L, spread over the kThreads threads of the CTA; rows past n_rows
// are zero-filled.
template <class L, int kRows, int kThreads>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int r0,
                                              int n_rows) {
  constexpr int kCopies = kRows * L::kChunks;
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kCopies % kThreads != 0 && idx >= kCopies) break;
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + L::at(r, 4 * c),
               ok ? src + (r0 + r) * stride + 4 * c : src, ok ? 16 : 0);
  }
}

}  // namespace
