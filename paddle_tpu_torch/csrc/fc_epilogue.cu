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
// Paths.  The wrapper picks one by a plain rule (ops/epilogue.py
// fc_kernel_path) and passes it in; the entry point refuses a path the
// operands do not allow, so neither path gives way to the other.
//   2 wgmma (bf16, K and N multiples of 8, x and w 16-byte aligned: the
//     rows TMA can address; the training path's shapes): a persistent,
//     warp-specialised kernel, the structure of conv_epilogue.cu's.  One
//     CTA an SM walks 128 x 256 output tiles (row-major over the tiles).
//     One thread of a producer warpgroup (setmaxnreg down to 40
//     registers; the consumers up to 232, so their 128 accumulators a
//     thread do not spill, as they did at the 168 that 384 threads leave)
//     loads each K step of 64 by TMA into a ring of four
//     128-byte-swizzled stages with full/empty mbarriers: the x tile
//     [128 rows][64 k] K-major, and w as it lies ([K,N] row-major, so
//     MN-major for the product) in four 64 k x 64 n boxes, read by
//     wgmma's transpose-B (wgmma.cuh's wgmma_desc_mn); the tensor maps
//     are encoded on the host through cudaGetDriverEntryPoint (no libcuda
//     link).  Two consumer warpgroups, side by side along N, each run two
//     wgmma.m64n128k16 products a k16 step from shared memory (128 x 128
//     f32 accumulators, 128 registers a thread) and release a stage once
//     the products that read it are done.  The epilogue applies bias,
//     residual (a bf16 one staged by 16-byte cp.async, an f32 or
//     misaligned one read in place) and act to the accumulator with no
//     per-element branch (act is a template parameter), casts once, stages
//     the tile in shared memory 64 columns at a time (the fourth stage
//     fits beside a half-width staging buffer) and stores it in 16-byte
//     coalesced rows, while the producer already fills the ring for the
//     CTA's next tile.
//     Tile choice: 128 x 256 for every shape (at M = 16384 the out-proj
//     and fc2 shapes have 256 tiles, 1.94 waves of 132 SMs, and fc1 1024
//     tiles, 7.8 waves); ping-pong consumers, each on its own 128 x 128
//     tile, would load each x tile twice for the same columns, a third
//     more L2 traffic a flop than one 128 x 256 tile shared by both.
//   1 mma.sync (bf16 rows TMA cannot address: K or N not a multiple of
//     8, or misaligned bases): one CTA of 256 threads (8 warps) owns a
//     128 x 128 output tile and walks K in steps of 32 staged through
//     shared memory, twice buffered; each warp owns a 64 x 32 sub-tile
//     (4 x 4 mma.sync.m16n8k16 tiles, 64 f32 accumulators a thread),
//     fragments by ldmatrix (x4, and x4.trans for w, stored [k][n]), rows
//     padded by 16 bytes; each element is loaded and masked.
//   0 f32 (off every main path): full f32 on the CUDA cores (TF32 off,
//     as the rest of the port), 128 x 128 tiles, K steps of 8, each
//     thread an 8 x 8 register micro-tile.
// The mma.sync and f32 paths put row tiles on grid.x (up to 2^31 - 1)
// and the wgmma path walks them persistently, so every M is computed.
//
// What bounds it.  At the training path's shapes (M = 32 * 512 = 16384,
// bf16; bytes: x, w, bias, residual read once, out written once):
//   out-proj K 512,  N 512  + residual: 8.6 GFLOP, 50.9 MB: 0.0152 ms,
//     bytes (3.35 TB/s);
//   fc1      K 512,  N 2048 + bias, relu: 34.4 GFLOP, 86.0 MB: 0.0347 ms,
//     operations (989 TFLOP/s dense bf16);
//   fc2      K 2048, N 512  + bias, residual: 34.4 GFLOP, 102.8 MB:
//     0.0347 ms, operations.
// Against the operation bound the wgmma path keeps the tensor cores fed
// from shared memory with loads up to four stages ahead (each 128 x 256
// tile reads 48 KB from L2 a K step for 4.2 MFLOP: about 11 TB/s from L2
// at the card's dense rate, so L2 is the next limit of this tile shape;
// TMA multicast across a cluster would halve w's share).  Against the
// byte bound it writes each output once in 16-byte stores and overlaps a
// tile's epilogue with the next tile's loads, not with its products:
// fc1's 8 K steps a tile leave the epilogue exposed (PERF.md has the
// times).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

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

template <int kAct>
__device__ __forceinline__ float act_of(float v) {
  if constexpr (kAct == 1) {
    return v < 0.f ? 0.f : v;  // keeps NaN, as jnp.maximum
  } else if constexpr (kAct == 2) {
    return 0.5f * v * erfcf(-v * 0.70710678118654752440f);
  } else if constexpr (kAct == 3) {
    return v * (0.5f * (1.f + tanhf(0.79788456080286535588f *
                                    (v + 0.044715f * (v * v * v)))));
  } else {
    return v;
  }
}

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1:
      return act_of<1>(v);
    case 2:
      return act_of<2>(v);
    case 3:
      return act_of<3>(v);
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
// [k0:k0+32, n0:n0+128] into shared memory, element by element;
// out-of-range elements are 0.
__device__ __forceinline__ void load_tiles_bf16(const Params& p,
                                                __nv_bfloat16* As,
                                                __nv_bfloat16* Bs, int m0,
                                                int n0, int k0) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  // 128 rows x 4 chunks of 8 for x, 32 rows x 16 chunks of 8 for w
#pragma unroll
  for (int c = threadIdx.x; c < kBM * kBK / 8; c += kThreads) {
    const int row = c >> 2, kc = (c & 3) * 8;
    const int gm = m0 + row, gk = k0 + kc;
    __nv_bfloat16* dst = As + row * kAStride + kc;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (gm < p.M && gk + e < p.K)
                   ? x[static_cast<long long>(gm) * p.K + gk + e]
                   : zero;
  }
#pragma unroll
  for (int c = threadIdx.x; c < kBK * kBN / 8; c += kThreads) {
    const int row = c >> 4, nc = (c & 15) * 8;
    const int gk = k0 + row, gn = n0 + nc;
    __nv_bfloat16* dst = Bs + row * kBStride + nc;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (gk < p.K && gn + e < p.N)
                   ? w[static_cast<long long>(gk) * p.N + gn + e]
                   : zero;
  }
}

__global__ void __launch_bounds__(kThreads) fc_ep_bf16_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBK * kBStride];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warp_m = warp >> 2;  // 2 warps down M, 64 rows each
  const int warp_n = warp & 3;   // 4 warps across N, 32 columns each
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (p.K + kBK - 1) / kBK;
  if (nk > 0) load_tiles_bf16(p, As[0], Bs[0], m0, n0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    // the loads of step kt + 1 go to the other buffer, which every warp
    // finished reading at the end of step kt - 1
    if (kt + 1 < nk)
      load_tiles_bf16(p, As[(kt + 1) & 1], Bs[(kt + 1) & 1], m0, n0,
                      (kt + 1) * kBK);
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
// bf16: wgmma tensor cores, TMA ring, persistent
// ---------------------------------------------------------------------------

constexpr int kWBM = 128;                // tile rows
constexpr int kWBN = 256;                // tile columns
constexpr int kWBNW = 128;               // a consumer warpgroup's columns
constexpr int kWBK = 64;                 // one 128-byte swizzled row of bf16
constexpr int kWg = 128;                 // threads a warpgroup
constexpr int kStages = 4;
constexpr int kWThreads = 3 * kWg;       // two consumer warpgroups, a producer one
// registers a thread after setmaxnreg: the producer warpgroup gives up
// what the consumers' 128 accumulators a thread need (2 x 128 x 232 +
// 128 x 40 = 65536 - 1024)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kABytes = kWBM * kWBK * 2;         // the x tile of a stage
constexpr int kBBox = kWBK * 64 * 2;             // one 64 k x 64 n box of w
constexpr int kStageBytes = kABytes + kWBN / 64 * kBBox;
constexpr int kHalf = kWBNW / 2;                 // columns staged at a time
constexpr int kStagingBytes = kWg * kHalf * 2;   // a warpgroup's staging
constexpr int kWSmem =
    kStages * kStageBytes + 2 * kStagingBytes + 2 * kStages * 8 + 1024;
static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");

struct WParams {
  const void* bias;
  const void* res;
  __nv_bfloat16* out;
  int M, N, K;
  int bias_dtype, res_dtype;  // 0 f32, 1 bf16; unused for a null pointer
  int res_staged;             // a bf16 residual arrives by 16-byte cp.async
};

// Element offset of 8-column chunk `chunk` of row `row` in a warpgroup's
// staging tile ([128][64] bf16, half its columns); the chunk index is
// XORed with row % 8, so the accumulator fragments (8 rows at one chunk)
// and the row-wise 16-byte reads both reach 32 different banks.
__device__ __forceinline__ int staged(int row, int chunk) {
  return row * kHalf + ((chunk ^ (row & 7)) << 3);
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// The producer (one thread): every K step of every tile of this CTA into
// the ring, x by one TMA box, w by up to four (boxes wholly past N are
// not loaded: the columns they would feed are never stored).
__device__ __forceinline__ void produce(const WParams& p, char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int n_tiles, int tiles,
                                        const CUtensorMap* map_x,
                                        const CUtensorMap* map_w) {
  const int nk = (p.K + kWBK - 1) / kWBK;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / n_tiles;
    const int m0 = mt * kWBM, n0 = (tile - mt * n_tiles) * kWBN;
    const int boxes = min(kWBN / 64, (p.N - n0 + 63) / 64);
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      char* a_s = smem + stage * kStageBytes;
      char* b_s = a_s + kABytes;
      mbar_arrive_expect_tx(&full[stage], kABytes + boxes * kBBox);
      tma_load_2d(a_s, map_x, &full[stage], kt * kWBK, m0);
      for (int i = 0; i < boxes; ++i)
        tma_load_2d(b_s + i * kBBox, map_w, &full[stage], n0 + 64 * i,
                    kt * kWBK);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup's epilogue of one tile (its 128 rows from m0 and
// 128 columns from n0), 64 columns at a time: bias, residual and act on
// the f32 accumulator, one cast, the half-tile staged in shared memory
// and stored in 16-byte rows.  kRes: 0 no residual, 1 a bf16 one staged
// by 16-byte cp.async, 2 one read in place (f32, or not 16-byte aligned).
// The per-element code has no branch.
template <int kAct, int kRes>
__device__ __forceinline__ void epilogue(const WParams& p,
                                         float (&acc)[2][kWBNW / 2],
                                         __nv_bfloat16* st, int wg, int m0,
                                         int n0) {
  constexpr int kChunks = kHalf / 8;
  const int wt = threadIdx.x & (kWg - 1);
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  // this thread's rows: 64 mi + 16 warp + g + 8 h, all with row % 8 == g
  __nv_bfloat16* st_t = st + (16 * warp + g) * kHalf + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int nh = n0 + kHalf * half;
    // the previous half's (or tile's) reads of st are done
    named_barrier(1 + wg, kWg);
    if constexpr (kRes == 1) {
      const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(p.res);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int idx = wt + i * kWg;
        const int r = idx / kChunks, ch = idx % kChunks;
        const int row = m0 + r, col = nh + ch * 8;
        const bool ok = row < p.M && col < p.N;
        cp_async16(st + staged(r, ch),
                   ok ? res + static_cast<long long>(row) * p.N + col : res,
                   ok ? 16 : 0);
      }
      cp_async_wait_all();
      named_barrier(1 + wg, kWg);
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int jj = kChunks * half + j;  // the accumulator's column block
      const int col = nh + 8 * j + 2 * t;
      const int sw = (j ^ g) << 3;
      float bias[2] = {0.f, 0.f};
      if (p.bias) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < p.N)
            bias[e] = load_f32(p.bias, p.bias_dtype, col + e);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(
              st_t + (64 * mi + 8 * h) * kHalf + sw);
          float v0 = acc[mi][4 * jj + 2 * h] + bias[0];
          float v1 = acc[mi][4 * jj + 2 * h + 1] + bias[1];
          if constexpr (kRes == 1) {
            const float2 r = __bfloat1622float2(*slot);
            v0 += r.x;
            v1 += r.y;
          }
          if constexpr (kRes == 2) {
            const int row = m0 + 64 * mi + 16 * warp + g + 8 * h;
            const long long idx = static_cast<long long>(row) * p.N + col;
            if (row < p.M && col < p.N) {
              v0 += load_f32(p.res, p.res_dtype, idx);
              v1 += load_f32(p.res, p.res_dtype, idx + 1);
            }
          }
          *slot = __floats2bfloat162_rn(act_of<kAct>(v0), act_of<kAct>(v1));
        }
    }
    named_barrier(1 + wg, kWg);
    if (m0 + kWg <= p.M && nh + kHalf <= p.N) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int idx = wt + i * kWg;
        const int r = idx / kChunks, ch = idx % kChunks;
        *reinterpret_cast<uint4*>(p.out + static_cast<long long>(m0 + r) *
                                              p.N + nh + ch * 8) =
            *reinterpret_cast<const uint4*>(st + staged(r, ch));
      }
    } else {
      for (int idx = wt; idx < kWg * kChunks; idx += kWg) {
        const int r = idx / kChunks, ch = idx % kChunks;
        const int row = m0 + r, col = nh + ch * 8;
        if (row < p.M && col < p.N)
          *reinterpret_cast<uint4*>(p.out +
                                    static_cast<long long>(row) * p.N + col) =
              *reinterpret_cast<const uint4*>(st + staged(r, ch));
      }
    }
  }
}

template <int kAct>
__global__ void __launch_bounds__(kWThreads, 1)
    fc_wgmma_kernel(const WParams p, int n_tiles, int tiles,
                    const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w) {
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* staging =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(staging) + 2 * kStagingBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expected bytes
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWg)
      produce(p, smem, full, empty, n_tiles, tiles, &map_x, &map_w);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = threadIdx.x & 31;
  const uint32_t smem_base = smem_addr(smem);
  __nv_bfloat16* st = staging + wg * (kStagingBytes / 2);
  const int nk = (p.K + kWBK - 1) / kWBK;
  int stage = 0;
  uint32_t phase = 0;
  float acc[2][kWBNW / 2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / n_tiles;
    const int m0 = mt * kWBM, n0 = (tile - mt * n_tiles) * kWBN;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < kWBNW / 2; ++i) acc[mi][i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      wgmma_fence();
      const uint32_t a_s = smem_base + stage * kStageBytes;
      // this warpgroup's two 64-column boxes of w
      const uint32_t b_s = a_s + kABytes + 2 * wg * kBBox;
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk) {
        const uint64_t bd = wgmma_desc_mn(b_s + kk * 16 * 128, kBBox);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          wgmma_m64n128k16<1>(acc[mi],
                              wgmma_desc(a_s + 64 * mi * 128 + kk * 32), bd);
      }
      wgmma_commit();
      // keep this step's products in flight; the previous step's have
      // completed, so its stage goes back to the producer
      wgmma_wait<1>();
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operand(acc[0]);
    fence_operand(acc[1]);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    const int en = n0 + kWBNW * wg;
    if (!p.res)
      epilogue<kAct, 0>(p, acc, st, wg, m0, en);
    else if (p.res_staged)
      epilogue<kAct, 1>(p, acc, st, wg, m0, en);
    else
      epilogue<kAct, 2>(p, acc, st, wg, m0, en);
  }
}

template <int kAct>
cudaError_t launch_wgmma(const WParams& p, const void* x, const void* w,
                         cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fc_wgmma_kernel<kAct>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWSmem);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms = n;
  }
  const long long m_tiles = (static_cast<long long>(p.M) + kWBM - 1) / kWBM;
  const long long n_tiles = (p.N + kWBN - 1) / kWBN;
  const long long tiles = m_tiles * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  // x as [M, K] in 128-row boxes, w as [K, N] in 64-row boxes
  CUtensorMap map_x, map_w;
  cudaError_t e = encode_tile_map(&map_x, x, p.M, p.K, kWBM);
  if (e == cudaSuccess) e = encode_tile_map(&map_w, w, p.K, p.N, 64);
  if (e != cudaSuccess) return e;
  fc_wgmma_kernel<kAct><<<grid, kWThreads, kWSmem, s>>>(
      p, static_cast<int>(n_tiles), static_cast<int>(tiles), map_x, map_w);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
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
// the header.  path: 0 the f32 CUDA-core kernel (dtype 0), 1 the bf16
// mma.sync kernel, 2 the bf16 wgmma kernel (K > 0, K and N multiples of
// 8, x, w and out 16-byte aligned); a path the operands do not allow is
// refused.  Returns a cudaError_t.
int pt_fc_epilogue(const void* x, const void* w, const void* bias,
                   const void* res, void* out, int M, int N, int K,
                   int dtype, int bias_dtype, int res_dtype, int act,
                   int path, void* stream) {
  if (M < 0 || N < 0 || K < 0 || act < 0 || act > 3 || dtype < 0 ||
      dtype > 1 || path < 0 || path > 2 || (path == 0) != (dtype == 0) ||
      (bias && (bias_dtype < 0 || bias_dtype > 1)) ||
      (res && (res_dtype < 0 || res_dtype > 1)))
    return cudaErrorInvalidValue;
  if (path == 2 && (K == 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(x) ||
                    !aligned16(w) || !aligned16(out)))
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    const WParams wp{bias, res, static_cast<__nv_bfloat16*>(out),
                     M, N, K, bias_dtype, res_dtype,
                     res != nullptr && res_dtype == 1 && aligned16(res)};
    switch (act) {
      case 0: return launch_wgmma<0>(wp, x, w, s);
      case 1: return launch_wgmma<1>(wp, x, w, s);
      case 2: return launch_wgmma<2>(wp, x, w, s);
      default: return launch_wgmma<3>(wp, x, w, s);
    }
  }
  const Params p{x, w, bias, res, out, M, N, K, bias_dtype, res_dtype, act};
  // row tiles on grid.x, which takes up to 2^31 - 1 blocks
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (path == 0)
    fc_ep_f32_kernel<<<grid, kThreads, 0, s>>>(p);
  else
    fc_ep_bf16_kernel<<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
