// Fused matmul epilogue for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/epilogue.py::_fc_ep_kernel (wrapper
// _fc_ep_pallas).  Contract, read from the Pallas kernel:
//   out[M,N] = act(x[M,K] . w[K,N] + bias[N] + residual[M,N])
//   x and w row-major, both f32 or both bf16; bias and residual optional,
//   each f32 or bf16.  The product is accumulated in f32; bias, residual
//   and act are applied to the f32 accumulator in that order
//   (apply_acc_stages), and the result is cast once to x's dtype.
//   act: 0 none, 1 relu (max(v, 0)), 2 gelu (0.5 v erfc(-v/sqrt 2)),
//   3 gelu, tanh approximation; both gelu forms are jax.nn.gelu's.
//   M, N and K are arbitrary: every edge is masked.  The Pallas wrapper
//   falls back to the unfused chain above Mosaic's VMEM budget; this
//   kernel takes every shape.
//
// Design.  One CTA of 256 threads (8 warps) owns a 128x128 output tile
// and walks K in steps staged through shared memory, twice buffered.
//   bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32
//   accumulate).  A K step is 32 deep; each warp owns a 64x32 sub-tile
//   (4x4 mma tiles, 64 f32 accumulators a thread).  Fragments come from
//   shared memory by ldmatrix (x4, and x4.trans for w, which is stored
//   [k][n]); rows are padded by 16 bytes so the eight 16-byte rows of
//   each ldmatrix phase fall in distinct banks.  When K and N are
//   multiples of 8 and x and w are 16-byte aligned, tiles arrive by
//   cp.async (16 bytes a thread, zero-filled past the edge) while the
//   previous step computes; otherwise each element is loaded and masked.
//   f32: full f32 on the CUDA cores (TF32 off, as the rest of the port),
//   K steps of 8, each thread an 8x8 register micro-tile.
// The epilogue runs on the accumulator registers and each output element
// is written once.
//
// What bounds it.  At the training path's shapes (M = 32 * 512 = 16384,
// bf16; bytes: x, w, bias, residual read once, out written once):
//   out-proj K 512,  N 512  + residual: 8.6 GFLOP, 50.9 MB: 0.0152 ms,
//     bytes (3.35 TB/s);
//   fc1      K 512,  N 2048 + bias, relu: 34.4 GFLOP, 86.0 MB: 0.0347 ms,
//     operations (989 TFLOP/s dense bf16);
//   fc2      K 2048, N 512  + bias, residual: 34.4 GFLOP, 102.8 MB:
//     0.0347 ms, operations.
// mma.sync cannot reach the card's dense bf16 rate (that takes wgmma fed
// by TMA), and this version issues one ldmatrix per mma pair with only
// two stages in flight, so it is expected well above those bounds.
// wgmma with a TMA ring, and a persistent grid, are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kThreads = 256;

// bf16 path
constexpr int kBK = 32;
constexpr int kAStride = kBK + 8;  // bf16 elements a row of the x tile
constexpr int kBStride = kBN + 8;  // bf16 elements a row of the w tile

// f32 path
constexpr int kFBK = 8;

struct Params {
  const void* x;
  const void* w;
  const void* bias;
  const void* res;
  void* out;
  int M, N, K;
  int bias_dtype, res_dtype;  // 0 f32, 1 bf16; unused for a null pointer
  int act;
};

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          long long i) {
  return dtype == 0 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1:
      return v < 0.f ? 0.f : v;  // keeps NaN, as jnp.maximum
    case 2:
      return 0.5f * v * erfcf(-v * 0.70710678118654752440f);
    case 3:
      return v * (0.5f * (1.f + tanhf(0.79788456080286535588f *
                                      (v + 0.044715f * (v * v * v)))));
    default:
      return v;
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The epilogue for one output element: bias, residual, act on the f32
// accumulator, one cast, one store.
template <typename T>
__device__ __forceinline__ void epilogue_store(const Params& p, int row,
                                               int col, float acc) {
  if (row >= p.M || col >= p.N) return;
  const long long idx = static_cast<long long>(row) * p.N + col;
  if (p.bias) acc += load_f32(p.bias, p.bias_dtype, col);
  if (p.res) acc += load_f32(p.res, p.res_dtype, idx);
  static_cast<T*>(p.out)[idx] = from_f32<T>(apply_act(acc, p.act));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

// Stages the x tile [m0:m0+128, k0:k0+32] and the w tile
// [k0:k0+32, n0:n0+128] into shared memory; out-of-range elements are 0.
template <bool kVec>
__device__ __forceinline__ void load_tiles_bf16(
    const Params& p, __nv_bfloat16* As, __nv_bfloat16* Bs, int m0, int n0,
    int k0) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  // 128 rows x 4 chunks of 8 for x, 32 rows x 16 chunks of 8 for w
#pragma unroll
  for (int c = threadIdx.x; c < kBM * kBK / 8; c += kThreads) {
    const int row = c >> 2, kc = (c & 3) * 8;
    const int gm = m0 + row, gk = k0 + kc;
    __nv_bfloat16* dst = As + row * kAStride + kc;
    if (kVec) {
      const bool ok = gm < p.M && gk < p.K;
      cp_async16(dst, ok ? x + static_cast<long long>(gm) * p.K + gk : x,
                 ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < p.M && gk + e < p.K)
                     ? x[static_cast<long long>(gm) * p.K + gk + e]
                     : zero;
    }
  }
#pragma unroll
  for (int c = threadIdx.x; c < kBK * kBN / 8; c += kThreads) {
    const int row = c >> 4, nc = (c & 15) * 8;
    const int gk = k0 + row, gn = n0 + nc;
    __nv_bfloat16* dst = Bs + row * kBStride + nc;
    if (kVec) {
      const bool ok = gk < p.K && gn < p.N;
      cp_async16(dst, ok ? w + static_cast<long long>(gk) * p.N + gn : w,
                 ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gk < p.K && gn + e < p.N)
                     ? w[static_cast<long long>(gk) * p.N + gn + e]
                     : zero;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    fc_ep_bf16_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBK * kBStride];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warp_m = warp >> 2;  // 2 warps down M, 64 rows each
  const int warp_n = warp & 3;   // 4 warps across N, 32 columns each
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (p.K + kBK - 1) / kBK;
  if (nk > 0) {
    load_tiles_bf16<kVec>(p, As[0], Bs[0], m0, n0, 0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_tiles_bf16<kVec>(p, As[nxt], Bs[nxt], m0, n0, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // lanes 0-15 point at rows 0-15, k 0-7; lanes 16-31 at k 8-15
        const int row = warp_m * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(a[mi], as + row * kAStride + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrix j = lane / 8: k half (j & 1), n half (j >> 1); the
        // transposed load gives each thread a (k, k+1) pair at one n
        uint32_t r[4];
        const int k = kk + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int n = warp_n * 32 + np * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(r, bs + k * kBStride + n);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // accumulator fragment: c0, c1 at (lane/4, 2*(lane%4) + {0,1}), c2, c3
  // eight rows below
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp_m * 64 + mi * 16 + (lane >> 2) + h * 8;
        const int col = n0 + warp_n * 32 + ni * 8 + (lane & 3) * 2;
        epilogue_store<__nv_bfloat16>(p, row, col, acc[mi][ni][2 * h]);
        epilogue_store<__nv_bfloat16>(p, row, col + 1,
                                      acc[mi][ni][2 * h + 1]);
      }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) fc_ep_f32_kernel(const Params p) {
  // x is stored transposed ([k][m]) so a thread reads its rows as float4
  __shared__ __align__(16) float As[kFBK][kBM];
  __shared__ __align__(16) float Bs[kFBK][kBN];

  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // each thread: rows {4ty..4ty+3, 64+4ty..}, columns {4tx.., 64+4tx..}
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  for (int k0 = 0; k0 < p.K; k0 += kFBK) {
    const int gm = m0 + a_row;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gk = k0 + a_k + e;
      As[a_k + e][a_row] =
          (gm < p.M && gk < p.K) ? x[static_cast<long long>(gm) * p.K + gk]
                                 : 0.f;
    }
    const int gk = k0 + b_row;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gn = n0 + b_col + e;
      Bs[b_row][b_col + e] =
          (gk < p.K && gn < p.N) ? w[static_cast<long long>(gk) * p.N + gn]
                                 : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[k][64 + 4 * tx]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      epilogue_store<float>(p, row, col, acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out); bias_dtype and
// res_dtype the same codes, ignored when the pointer is null.  act as in
// the header.  Returns a cudaError_t.
int pt_fc_epilogue(const void* x, const void* w, const void* bias,
                   const void* res, void* out, int M, int N, int K,
                   int dtype, int bias_dtype, int res_dtype, int act,
                   void* stream) {
  if (M < 0 || N < 0 || K < 0 || act < 0 || act > 3 ||
      (bias && (bias_dtype < 0 || bias_dtype > 1)) ||
      (res && (res_dtype < 0 || res_dtype > 1)))
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const Params p{x, w, bias, res, out, M, N, K, bias_dtype, res_dtype, act};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fc_ep_f32_kernel<<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1) {
    const bool vec = K % 8 == 0 && N % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (vec)
      fc_ep_bf16_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else
      fc_ep_bf16_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
