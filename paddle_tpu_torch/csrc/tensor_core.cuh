// Tensor-core building blocks shared by the bf16 kernels: cp.async copies
// from global to shared memory, ldmatrix fragment loads and the
// mma.sync.m16n8k16 bf16 product with an f32 accumulator, and the
// swizzled shared-memory tile that cp.async fills and ldmatrix reads.
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

}  // namespace
