// The wide tile of the flash kernels: head dims D > 128, where the
// tensor-core tiles' f32 accumulators and shared-memory tiles do not fit
// (an f32 O accumulator of 16 rows x 256 columns is 128 registers a lane
// before any fragment; the f32 forward's tiles need 240 KB at D 128
// already).  The wide kernels run on the CUDA cores in f32: a CTA of 4
// warps owns 16 rows (query rows; keys in dkv) and sweeps tiles of 32 of
// the other side; a lane owns one key (one q row in dkv) of the tile for
// the scores, so each row's max and sum are five xor shuffles of one warp;
// and thread t owns output columns t and t + 128 of all 16 rows of one
// 256-column slice of the output.  Every product is an FMA in f32,
// rounded to nearest at each step, so there is no long chain of truncating
// tensor-core sums to bias it.  Tiles are converted to f32 as they land in
// shared memory, by 16-byte loads (the wrappers pad D to a multiple of 16
// and align rows to 16 bytes, as for the other tiles); the other side's
// rows are padded by 4 words, so a quarter warp's 16-byte reads of 8 rows
// hit 32 banks.
// Any D: above 256 the scores (and dP) are summed over D in 256-wide
// slices of both sides staged in turn, one FMA chain in column order, so
// a slice boundary changes no rounding; the output columns are covered in
// 256-wide slices, one a grid index (blockIdx.z), and each slice's CTA
// recomputes the same scores and softmax state.  Shared memory is sized
// for one slice whatever D is, so no head dim is refused.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWideThreads = 128;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideRows = 16;  // the CTA's own rows
constexpr int kWideSweep = 32;  // rows of a tile of the other side
constexpr int kWideOwn = kWideRows / kWideWarps;  // rows a warp scores
constexpr int kWideSlice = 256;  // columns of D staged at a time
constexpr int kWideCols = kWideSlice / kWideThreads;  // columns a thread
constexpr int kWidePad = 4;  // words a swept row is padded by

__device__ __forceinline__ float wide_f32(float x) { return x; }
__device__ __forceinline__ float wide_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T wide_cast(float x);
template <>
__device__ __forceinline__ float wide_cast<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 wide_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (P before P.V in bf16, dS in bf16)
template <typename T>
__device__ __forceinline__ float wide_round(float x) {
  return wide_f32(wide_cast<T>(x));
}

// 8 consecutive elements of T as f32, by 16-byte loads
__device__ __forceinline__ void wide_load8(const float* src, float4& a,
                                           float4& b) {
  a = reinterpret_cast<const float4*>(src)[0];
  b = reinterpret_cast<const float4*>(src)[1];
}
__device__ __forceinline__ void wide_load8(const __nv_bfloat16* src,
                                           float4& a, float4& b) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  a = make_float4(__uint_as_float(u.x << 16),
                  __uint_as_float(u.x & 0xffff0000u),
                  __uint_as_float(u.y << 16),
                  __uint_as_float(u.y & 0xffff0000u));
  b = make_float4(__uint_as_float(u.z << 16),
                  __uint_as_float(u.z & 0xffff0000u),
                  __uint_as_float(u.w << 16),
                  __uint_as_float(u.w & 0xffff0000u));
}

// The CTA loads rows [r0, r0 + rows) of a [n_rows][D] matrix (row stride
// `stride` elements, D a multiple of 16) into f32 rows of `ld` words;
// rows past n_rows are zero.
template <typename T>
__device__ __forceinline__ void wide_load_rows(float* dst, int ld,
                                               const T* src,
                                               long long stride, int r0,
                                               int rows, int n_rows, int D) {
  const int per_row = D / 8;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += kWideThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r0 + r < n_rows) wide_load8(src + (r0 + r) * stride + c, a, b);
    *reinterpret_cast<float4*>(dst + r * ld + c) = a;
    *reinterpret_cast<float4*>(dst + r * ld + c + 4) = b;
  }
}

// Adds to s the dot products of a lane's swept row x with the warp's
// kWideOwn own rows (rows own0 + kWideWarps * i of `own`, D words a row)
// over D columns: own rows are the same for the whole warp (broadcast
// reads).
__device__ __forceinline__ void wide_dots(float (&s)[kWideOwn],
                                          const float* own, int own0,
                                          const float* x, int D) {
  for (int c = 0; c < D; c += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + c);
#pragma unroll
    for (int i = 0; i < kWideOwn; ++i) {
      const float4 ov = *reinterpret_cast<const float4*>(
          own + (own0 + kWideWarps * i) * D + c);
      s[i] = fmaf(ov.x, xv.x, s[i]);
      s[i] = fmaf(ov.y, xv.y, s[i]);
      s[i] = fmaf(ov.z, xv.z, s[i]);
      s[i] = fmaf(ov.w, xv.w, s[i]);
    }
  }
}

// The number of 256-column slices of D, and the width of slice `i`.
__host__ __device__ __forceinline__ int wide_slices(int D) {
  return (D + kWideSlice - 1) / kWideSlice;
}
__device__ __forceinline__ int wide_width(int D, int i) {
  return min(kWideSlice, D - i * kWideSlice);
}

__device__ __forceinline__ float wide_warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float wide_warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace
