// Fused convolution epilogue and convolution + batch-norm statistics for
// Hopper (sm_90a), plain C interface.
//
// Replaces two kernels of paddle_tpu/ops/pallas_conv.py:
//   _conv_ep_kernel (:99, wrapper _conv_ep_pallas):
//     out = act(conv(x, w) + bias + residual)
//   _conv_stats_kernel (:311, wrapper _conv_stats_pallas):
//     y = conv(x, w) + bias, plus per-channel partial sums of y and y*y
//     taken from y after its cast to the output dtype.
// Contract, read from the Pallas kernels: x is NHWC [N,H,W,Cin], the filter
// arrives as [KH,KW,Cin,Cout] (row-major, i.e. the GEMM's [K, Cout]
// operand), out is NHWC [N,OH,OW,Cout].  x and w are both f32 or both
// bf16; bias [Cout] and residual [N,OH,OW,Cout] optional, each f32 or bf16.
// The products are accumulated in f32; bias, residual and act (0 none,
// 1 relu) are applied to the f32 accumulator in that order
// (apply_acc_stages), and the result is cast once to x's dtype.  Padding
// is (PH, PW) on the top and left; taps that fall outside the input read
// 0, so any bottom/right padding follows from OH and OW.  Every shape is
// taken: the Pallas wrappers' pad of x, VMEM-budget fall-backs, replicated
// statistics blocks and 256-wide Cout blocks were TPU rules and are gone.
//
// Statistics (s1, s2 non-null): the kernel writes, for each 128-row tile
// of the output (rows = N*OH*OW pixels), the sum over its rows of y and of
// y*y per channel into s1[tile][c] and s2[tile][c], f32, where y is the
// value stored (after the cast).  No atomics: each tile's partial is
// reduced in a fixed order, and the caller sums the [tiles, Cout] partials.
// pt_conv_tile_m() gives the tile height, and the entry point refuses
// partials whose row count is not the number of tiles.
//
// Design: an implicit GEMM, M = N*OH*OW, N = Cout, K = KH*KW*Cin, with the
// mainloop of fc_epilogue.cu.  One CTA of 256 threads owns a 128x128 output
// tile (M tiles on grid.x, whose limit is 2^31-1, Cout tiles on grid.y) and
// walks K in steps staged through shared memory.  The x tile is
// gathered from the input (im2col without materialising it): each thread
// keeps the input coordinates of its two rows, and a K index k maps to the
// tap (k / Cin) and channel (k % Cin).
//   bf16: mma.sync.m16n8k16 with an f32 accumulator, K steps of 32, two
//   stages.  When Cin and Cout are multiples of 8 and x and w are 16-byte
//   aligned, 8 consecutive channels of one tap arrive by one 16-byte
//   cp.async (zero-filled outside the input); otherwise each element is
//   loaded and masked (the 3-channel stem).
//   f32: full f32 on the CUDA cores (TF32 off), K steps of 8, each thread
//   an 8x8 register micro-tile.
// The epilogue runs on the accumulator registers; each output element is
// written once.
//
// What bounds it.  At ResNet-50's bf16 shapes on the training path the
// convolutions are operation-bound at the card's dense bf16 rate, except
// the 1x1 convolutions of the first stage and the stem, whose bytes
// dominate; chip_smoke.py computes both bounds at every distinct shape.
// mma.sync with two stages and a gathered x tile does not approach the
// dense rate (that takes wgmma fed by TMA, with the im2col done by TMA's
// im2col mode); that and a persistent grid are the next steps.

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
  float* s1;
  float* s2;
  int N, H, W, C;       // input, NHWC
  int Cout, KH, KW, SH, SW, PH, PW, OH, OW;
  int M, K;             // GEMM sizes: N*OH*OW and KH*KW*C
  int bias_dtype, res_dtype;  // 0 f32, 1 bf16; unused for a null pointer
  int act;
};

// The input coordinates of one output row (pixel).
struct Row {
  long long base;  // offset of image n in x
  int ih0, iw0;    // top-left input position of its window
  bool valid;
};

__device__ __forceinline__ Row make_row(const Params& p, int gm) {
  Row r;
  r.valid = gm < p.M;
  if (!r.valid) gm = 0;
  const int ohw = p.OH * p.OW;
  const int n = gm / ohw;
  const int rem = gm - n * ohw;
  const int oh = rem / p.OW;
  const int ow = rem - oh * p.OW;
  r.base = static_cast<long long>(n) * p.H * p.W * p.C;
  r.ih0 = oh * p.SH - p.PH;
  r.iw0 = ow * p.SW - p.PW;
  return r;
}

// Offset in x of (row, k), or -1 where the tap falls outside the input or
// k >= K.
__device__ __forceinline__ long long x_offset(const Params& p, const Row& r,
                                              int k) {
  if (!r.valid || k >= p.K) return -1;
  const int tap = k / p.C;
  const int c = k - tap * p.C;
  const int ti = tap / p.KW;
  const int tj = tap - ti * p.KW;
  const int ih = r.ih0 + ti, iw = r.iw0 + tj;
  if (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W) return -1;
  return r.base + (static_cast<long long>(ih) * p.W + iw) * p.C + c;
}

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          long long i) {
  return dtype == 0 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(p)[i]);
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The epilogue of one output element: bias, residual, act on the f32
// accumulator, one cast, one store.  Returns the stored value as f32 (0
// outside the output), which the statistics sum.
template <typename T>
__device__ __forceinline__ float epilogue_store(const Params& p, int row,
                                                int col, float acc) {
  if (row >= p.M || col >= p.Cout) return 0.f;
  const long long idx = static_cast<long long>(row) * p.Cout + col;
  if (p.bias) acc += load_f32(p.bias, p.bias_dtype, col);
  if (p.res) acc += load_f32(p.res, p.res_dtype, idx);
  if (p.act == 1 && acc < 0.f) acc = 0.f;  // keeps NaN, as jnp.maximum
  const T v = from_f32<T>(acc);
  static_cast<T*>(p.out)[idx] = v;
  return to_f32(v);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

// Stages the gathered x tile [m0:m0+128, k0:k0+32] and the w tile
// [k0:k0+32, n0:n0+128] into shared memory; out-of-range elements are 0.
// rows[i] is the row of chunk threadIdx.x + i*256 (row tid/4 + 64 i).
template <bool kVec>
__device__ __forceinline__ void load_tiles_bf16(const Params& p,
                                                const Row (&rows)[2],
                                                __nv_bfloat16* As,
                                                __nv_bfloat16* Bs, int n0,
                                                int k0) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int kc = (threadIdx.x & 3) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (threadIdx.x >> 2) + 64 * i;
    __nv_bfloat16* dst = As + row * kAStride + kc;
    if (kVec) {
      // Cin % 8 == 0: the 8 channels share one tap and are contiguous
      const long long off = x_offset(p, rows[i], k0 + kc);
      cp_async16(dst, off >= 0 ? x + off : x, off >= 0 ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const long long off = x_offset(p, rows[i], k0 + kc + e);
        dst[e] = off >= 0 ? x[off] : zero;
      }
    }
  }
#pragma unroll
  for (int c = threadIdx.x; c < kBK * kBN / 8; c += kThreads) {
    const int row = c >> 4, nc = (c & 15) * 8;
    const int gk = k0 + row, gn = n0 + nc;
    __nv_bfloat16* dst = Bs + row * kBStride + nc;
    if (kVec) {
      const bool ok = gk < p.K && gn < p.Cout;
      cp_async16(dst,
                 ok ? w + static_cast<long long>(gk) * p.Cout + gn : w,
                 ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gk < p.K && gn + e < p.Cout)
                     ? w[static_cast<long long>(gk) * p.Cout + gn + e]
                     : zero;
    }
  }
}

// The CTA's partial statistics of column col (0..127 within the tile) are
// red1[col], red2[col]; thread col writes them.
__device__ __forceinline__ void store_partials(const Params& p,
                                               const float* red1,
                                               const float* red2, int n0) {
  const int col = threadIdx.x;
  if (col < kBN && n0 + col < p.Cout) {
    const long long i =
        static_cast<long long>(blockIdx.x) * p.Cout + n0 + col;
    p.s1[i] = red1[col];
    p.s2[i] = red2[col];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    conv_bf16_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBK * kBStride];
  __shared__ float red1[2][kBN], red2[2][kBN];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warp_m = warp >> 2;  // 2 warps down M, 64 rows each
  const int warp_n = warp & 3;   // 4 warps across N, 32 columns each
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const Row rows[2] = {make_row(p, m0 + (threadIdx.x >> 2)),
                       make_row(p, m0 + (threadIdx.x >> 2) + 64)};

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (p.K + kBK - 1) / kBK;
  if (nk > 0) {
    load_tiles_bf16<kVec>(p, rows, As[0], Bs[0], n0, 0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_tiles_bf16<kVec>(p, rows, As[nxt], Bs[nxt], n0, (kt + 1) * kBK);
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
  float t1[4][2], t2[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) t1[ni][e] = t2[ni][e] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp_m * 64 + mi * 16 + (lane >> 2) + h * 8;
        const int col = n0 + warp_n * 32 + ni * 8 + (lane & 3) * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = epilogue_store<__nv_bfloat16>(
              p, row, col + e, acc[mi][ni][2 * h + e]);
          t1[ni][e] += v;
          t2[ni][e] += v * v;
        }
      }
  if (p.s1 == nullptr) return;

  // column sums: over the 8 lanes that share (lane % 4), then over the
  // two warps down M, in a fixed order
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        t1[ni][e] += __shfl_xor_sync(0xffffffffu, t1[ni][e], off);
        t2[ni][e] += __shfl_xor_sync(0xffffffffu, t2[ni][e], off);
      }
      if ((lane >> 2) == 0) {
        const int col = warp_n * 32 + ni * 8 + lane * 2 + e;
        red1[warp_m][col] = t1[ni][e];
        red2[warp_m][col] = t2[ni][e];
      }
    }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int col = threadIdx.x;
    red1[0][col] += red1[1][col];
    red2[0][col] += red2[1][col];
  }
  __syncthreads();
  store_partials(p, red1[0], red2[0], n0);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) conv_f32_kernel(const Params p) {
  // x is stored transposed ([k][m]) so a thread reads its rows as float4
  __shared__ __align__(16) float As[kFBK][kBM];
  __shared__ __align__(16) float Bs[kFBK][kBN];
  __shared__ float red1[16][kBN], red2[16][kBN];

  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  // each thread: rows {4ty..4ty+3, 64+4ty..}, columns {4tx.., 64+4tx..}
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  const Row row = make_row(p, m0 + a_row);
  for (int k0 = 0; k0 < p.K; k0 += kFBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long off = x_offset(p, row, k0 + a_k + e);
      As[a_k + e][a_row] = off >= 0 ? x[off] : 0.f;
    }
    const int gk = k0 + b_row;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gn = n0 + b_col + e;
      Bs[b_row][b_col + e] =
          (gk < p.K && gn < p.Cout)
              ? w[static_cast<long long>(gk) * p.Cout + gn]
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

  float t1[8], t2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t1[j] = t2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      const float v = epilogue_store<float>(p, r, col, acc[i][j]);
      t1[j] += v;
      t2[j] += v * v;
    }
  }
  if (p.s1 == nullptr) return;

  // column sums over the 16 row groups (ty), in order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4;
    red1[ty][col] = t1[j];
    red2[ty][col] = t2[j];
  }
  __syncthreads();
  if (tid < kBN) {
    float s1 = 0.f, s2 = 0.f;
    for (int g = 0; g < 16; ++g) {
      s1 += red1[g][tid];
      s2 += red2[g][tid];
    }
    red1[0][tid] = s1;
    red2[0][tid] = s2;
  }
  __syncthreads();
  store_partials(p, red1[0], red2[0], n0);
}

}  // namespace

extern "C" {

// x NHWC [N,H,W,C], w [KH,KW,C,Cout], bias [Cout] or null, res
// [N,OH,OW,Cout] or null, out [N,OH,OW,Cout]; s1 and s2 null, or both
// [s_rows, Cout] f32 for the statistics, where s_rows must be
// ceil(N*OH*OW / pt_conv_tile_m()).  dtype: 0 = float32, 1 = bfloat16 (x, w
// and out); bias_dtype and res_dtype the same codes, ignored for a null
// pointer.  act: 0 none, 1 relu.  Returns a cudaError_t.
int pt_conv_epilogue(const void* x, const void* w, const void* bias,
                     const void* res, void* out, void* s1, void* s2, int N,
                     int H, int W, int C, int Cout, int KH, int KW, int SH,
                     int SW, int PH, int PW, int OH, int OW, int dtype,
                     int bias_dtype, int res_dtype, int act, int s_rows,
                     void* stream) {
  if (N < 0 || H <= 0 || W <= 0 || C <= 0 || Cout < 0 || KH <= 0 ||
      KW <= 0 || SH <= 0 || SW <= 0 || PH < 0 || PW < 0 || OH < 0 ||
      OW < 0 || act < 0 || act > 1 || (s1 == nullptr) != (s2 == nullptr) ||
      (bias && (bias_dtype < 0 || bias_dtype > 1)) ||
      (res && (res_dtype < 0 || res_dtype > 1)))
    return cudaErrorInvalidValue;
  const long long M = static_cast<long long>(N) * OH * OW;
  const long long K = static_cast<long long>(KH) * KW * C;
  if (M > 0x7fffffffLL || K > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  (Cout + kBN - 1) / kBN);
  if (grid.y > 65535 || (s1 && s_rows != static_cast<long long>(grid.x)))
    return cudaErrorInvalidValue;
  if (M == 0 || Cout == 0) return cudaSuccess;
  const Params p{x,  w,  bias, res, out, static_cast<float*>(s1),
                 static_cast<float*>(s2), N, H, W, C, Cout, KH, KW, SH,
                 SW, PH, PW, OH, OW, static_cast<int>(M),
                 static_cast<int>(K), bias_dtype, res_dtype, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv_f32_kernel<<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1) {
    const bool vec = C % 8 == 0 && Cout % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (vec)
      conv_bf16_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else
      conv_bf16_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The output rows (pixels) of one tile: one row of statistics partials.
int pt_conv_tile_m() { return kBM; }

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
