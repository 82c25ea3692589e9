// Hopper (sm_90a) building blocks of the kernels that run on wgmma:
// shared-memory matrix descriptors for 128-byte-swizzled K-major tiles
// (and MN-major ones, for a B operand read as it lies),
// the warpgroup product and its fences, mbarriers, TMA tile loads, the
// cp.async arrive on an mbarrier, the async-proxy fence and named
// barriers; on the host, the TMA tensor maps of those tiles.
//
// Tile layout (what the descriptors below describe, and what TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes): a [rows][64] bf16 tile, one
// 128-byte row a matrix row, its eight 16-byte chunks permuted as chunk c
// of row r at c ^ (r % 8).  Eight rows make a 1024-byte core group; the
// tile must start on a 1024-byte boundary.  A k16 slice of the tile is
// addressed by moving the descriptor's start address 32 bytes along the
// row; the hardware applies the swizzle to the final address.
//
// wgmma accumulator layout, m64nNk16 f32 (thread = 32 * warp + 4 * g + t
// of the warpgroup): d[4j + 2h + e] holds row 16 * warp + g + 8h, column
// 8j + 2t + e, for j < N/8 and h, e in {0, 1}.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the divisor's
// magic number is computed on the host): the per-tile index arithmetic of
// the implicit GEMMs.
struct FastDiv {
  uint32_t mul, shift;
  __device__ __forceinline__ int operator()(int n) const {
    const uint32_t u = static_cast<uint32_t>(n);
    return static_cast<int>((__umulhi(u, mul) + u) >> shift);
  }
};

inline FastDiv make_fastdiv(uint32_t d) {
  uint32_t shift = 0;
  while ((uint64_t(1) << shift) < d) ++shift;
  const uint64_t mul = ((uint64_t(1) << 32) * ((uint64_t(1) << shift) - d)) / d + 1;
  return FastDiv{static_cast<uint32_t>(mul), shift};
}

// Offset in bytes of 16-byte chunk `chunk` of row `row` in a 128-byte-
// swizzled tile.
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// The descriptor of a K-major 128-byte-swizzled tile at shared address
// `addr` (1024-byte aligned, or moved from such an address by a k16 step
// of 32 bytes): start address >> 4 in bits 0-13, the leading byte offset
// (unused by the swizzled K-major layout; 1) in bits 16-29, the stride
// between 8-row groups (1024 bytes >> 4) in bits 32-45, base offset 0,
// layout 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The descriptor of an MN-major 128-byte-swizzled tile (B read as it
// lies, rows along K): a [k][64] bf16 block per 64 columns, one 128-byte
// row a k index, swizzled as above (what TMA writes for a 64-column box),
// the blocks `lbo` bytes apart.  For MN-major layouts the leading byte
// offset is the stride between 64-column blocks and the stride byte
// offset (1024) the stride between 8-row groups of k; a k16 step moves
// the start address by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t wgmma_desc_mn(uint32_t addr,
                                                  uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the accumulator registers to this point of the program, so the
// compiler moves no read or write of them across a wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A[64x16] * B[Nx16]^T, A a K-major bf16 tile in shared memory and
// B a K-major one (kTransB 0) or an MN-major one (kTransB 1, wgmma's
// transpose-B, as wgmma_desc_mn describes it); d the f32 accumulator in
// registers.
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the other threads (and to
// the async proxy); follow with __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on `bar` that also expects `bytes` more of asynchronous
// (TMA) writes before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: copies the box at (c0, c1) (innermost first) of the 2D tensor map
// `map` (a CUtensorMap in parameter or global memory) to `dst`, in the
// map's swizzle, zero-filling outside the tensor; completes `bytes` of
// `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One arrival on `bar`, made when every cp.async this thread issued
// before has landed; counts towards the barrier's expected arrivals
// (.noinc).
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Orders shared-memory writes made through the generic proxy (st.shared,
// cp.async) before reads by the async proxy (wgmma operands) that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `threads` threads (a multiple of 32) on hardware barrier
// `id` (1-15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The driver's cuTensorMapEncodeTiled, reached through the runtime (the
// libraries do not link libcuda), looked up once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline cudaError_t tensor_map_encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
    if (e == cudaSuccess && found != cudaDriverEntryPointSuccess)
      e = cudaErrorNotSupported;
    if (e != cudaSuccess) return e;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// A TMA map of the row-major matrix [rows, cols] of `elem`-byte elements
// (`type`) at `base`, in boxes of `box_rows` rows x 128 bytes, 128-byte
// swizzled as the wgmma tiles are, zero outside the matrix.
inline cudaError_t encode_swizzled_map(CUtensorMap* map,
                                       CUtensorMapDataType type, int elem,
                                       const void* base, long long rows,
                                       int cols, int box_rows) {
  EncodeTiled encode;
  const cudaError_t e = tensor_map_encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The bf16 matrix [rows, cols] in boxes of `box_rows` x 64 columns.
inline cudaError_t encode_tile_map(CUtensorMap* map, const void* base,
                                   long long rows, int cols, int box_rows) {
  return encode_swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                             rows, cols, box_rows);
}

// The int8 matrix [rows, cols] (bytes) in boxes of `box_rows` x 128
// columns: the tile of wgmma's s8 products, whose k32 slices are 32 bytes
// as the bf16 tile's k16 slices are.
inline cudaError_t encode_byte_tile_map(CUtensorMap* map, const void* base,
                                        long long rows, int cols,
                                        int box_rows) {
  return encode_swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base,
                             rows, cols, box_rows);
}

}  // namespace
