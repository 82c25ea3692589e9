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
// arrives as [Cout,KH,KW,Cin] (OHWI, row-major: the GEMM's [Cout, K]
// operand, K-major, k = (kh * KW + kw) * Cin + c), out is NHWC
// [N,OH,OW,Cout].  x and w are both f32 or both bf16; bias [Cout] and
// residual [N,OH,OW,Cout] optional, each f32 or bf16.  The products are
// accumulated in f32; bias, residual and act (0 none, 1 relu) are applied
// to the f32 accumulator in that order (apply_acc_stages), and the result
// is cast once to x's dtype.  Padding is (PH, PW) on the top and left;
// taps that fall outside the input read 0, so any bottom/right padding
// follows from OH and OW.  In bf16, Cin must be a multiple of 8 and x and
// w 16-byte aligned (the wrapper pads Cin with zero channels, as the
// 3-channel stem needs, and copies a misaligned view); f32 takes any
// shape.
//
// Statistics (s1, s2 non-null): the kernel writes, for each 128-row tile
// of the output (rows = N*OH*OW pixels), the sum over its rows of y and of
// y*y per channel into s1[tile][c] and s2[tile][c], f32, where y is the
// value stored (after the cast).  No atomics: each tile's partial is
// reduced in a fixed order, and the caller sums the [tiles, Cout] partials.
// pt_conv_tile_m() gives the tile height, and the entry point refuses
// partials whose row count is not the number of tiles.
//
// Design: an implicit GEMM, M = N*OH*OW, N = Cout, K = KH*KW*Cin.
//   bf16 (the training path): a persistent, warp-specialised wgmma kernel.
//   One CTA an SM walks output tiles; producer warpgroups fill a ring of
//   128-byte-swizzled shared-memory stages, K steps of 64: one thread
//   loads the w tile by TMA (a 2D tensor map over [Cout, K], encoded on
//   the host with the driver's cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the library links no libcuda), and the x
//   tile of a 1x1 stride-1 conv, whose rows are x's pixels; otherwise
//   the producers gather the x tile (im2col without materialising it)
//   with 16-byte cp.async (zero-filled outside the input and past K).
//   Each stage's "full" mbarrier takes the TMA bytes and every producer's
//   cp.async.mbarrier.arrive.noinc; two consumer warpgroups wait on it,
//   fence the async proxy, run wgmma.m64nNk16 with both operands read from
//   shared memory through descriptors, and release the stage on its
//   "empty" mbarrier once the products that read it have completed.
//   Each gathering producer thread owns one 16-byte chunk (8 channels) of
//   its rows and advances that chunk's (tap, channel) and the x offset by
//   increments, so the K loop does no division (the per-tile row
//   coordinates use a multiply-high).  The
//   tile follows Cout: 256 rows x 64 or 128 columns (the two warpgroups
//   split M) for Cout <= 64 or <= 128, 128 x 256 (they split N) above, so
//   a Cout = 64 conv computes no idle columns; each warpgroup holds 128
//   rows x 64 or 128 columns of f32 accumulator.  A Cout <= 64 tile has
//   two producer warpgroups (512 threads), the others one (384 threads,
//   168 registers each, no spill).  The epilogue applies the stages to
//   the accumulator with no per-element branch, casts, writes the tile to
//   a shared-memory staging buffer of its warpgroup (a bf16 residual tile
//   is first staged there by 16-byte cp.async) and stores it with 16-byte
//   coalesced writes, while the producers already fill the ring for the
//   next tile.  Statistics are summed from the cast values in registers,
//   then across lanes by shuffles and across warps in a fixed order: one
//   partial row per warpgroup and 128 rows.  The 3-channel stem arrives
//   from the wrapper as pixel pairs of 4 channels at half the stride
//   (ops/conv_epilogue.py _kernel_operands), so one 16-byte copy carries
//   two taps.
//   f32 (batch-2 checks only): full f32 on the CUDA cores (TF32 off), 128x128
//   tiles, K steps of 8, each thread an 8x8 register micro-tile.
//
// What bounds it.  At ResNet-50's bf16 shapes on the training path the 3x3
// convolutions and the deep 1x1 ones are operation-bound at the card's
// dense bf16 rate (989 TFLOP/s); the 1x1 convolutions of the first stages
// and the stem are bound by their bytes (the output dominates: 205 MB of
// the 257 MB of 64->256 at 56x56, batch 128).  chip_smoke.py computes
// both bounds at every distinct shape.  Against the operation bound the
// design keeps the tensor cores fed from shared memory by wgmma with loads
// two or three stages ahead; against the byte bound it writes each output
// once in 16-byte stores and overlaps one tile's epilogue with the next
// tile's loads.  What holds it now (PERF.md): x's cp.async gather on the
// operation-bound 3x3 shapes, the epilogue on the 1x1 shapes with
// Cout >= 256 and few K steps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

// Output rows (pixels) a statistics partial covers.
constexpr int kTileM = 128;

// f32 path
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kThreads = 256;
constexpr int kFBK = 8;

// bf16 path: two consumer warpgroups and one or two producer warpgroups
constexpr int kBK = 64;  // one 128-byte swizzled row of bf16
constexpr int kWg = 128;

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
  int vec_out;          // bf16: Cout % 8 == 0, out 16-byte aligned
  int res_staged;       // bf16: the residual arrives by 16-byte cp.async
  FastDiv div_ohw, div_ow, div_ntiles;  // bf16: by OH*OW, OW, Cout tiles
  int tma_x;            // bf16: x arrives by TMA (1x1, stride 1, no pad)
};

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          long long i) {
  return dtype == 0 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(p)[i]);
}

// ---------------------------------------------------------------------------
// bf16: wgmma tensor cores
// ---------------------------------------------------------------------------

// The tile of one configuration: each consumer warpgroup owns 128 rows x
// kBNW columns; kSplitN puts the two side by side along N (a 128 x 2kBNW
// tile), otherwise one above the other (256 x kBNW).
template <int kBNW, bool kSplitN>
struct Cfg {
  static constexpr int BM = kSplitN ? 128 : 256;
  static constexpr int BN = kSplitN ? 2 * kBNW : kBNW;
  static constexpr int kStages = kBNW == 128 ? 3 : 4;
  // producer threads: a Cout <= 64 tile gathers 256 rows for 64 columns of
  // products, so its gather gets two warpgroups (its consumers need 118
  // registers, within the 128 that 512 threads leave)
  static constexpr int kProducers = kBNW == 64 ? 2 * kWg : kWg;
  static constexpr int kThreads = 2 * kWg + kProducers;
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  static constexpr int kStagingBytes = kWg * kBNW * 2;  // a warpgroup's
  static constexpr int kRedBytes = 2 * 4 * kBNW * 4;    // a warpgroup's
  static constexpr int kSmemBytes = kStages * kStageBytes +
                                    2 * kStagingBytes + 2 * kRedBytes +
                                    2 * kStages * 8 + 1024;
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");
};

// Element offset of 8-column chunk `chunk` of row `row` in a warpgroup's
// staging tile ([128][kBNW] bf16); the chunk index is XORed with row % 8,
// so the accumulator fragments (8 rows at one chunk) and the row-wise
// 16-byte reads both reach 32 different banks.
template <int kBNW>
__device__ __forceinline__ int staged(int row, int chunk) {
  return row * kBNW + ((chunk ^ (row & 7)) << 3);
}

// The producer warpgroups: fill stage after stage for every tile of this
// CTA.  Thread pt copies chunk pt % 8 of tile rows pt / 8 + kStep i.
template <int kBNW, bool kSplitN>
__device__ __forceinline__ void produce(const Params& p, char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int n_tiles, int tiles,
                                        const CUtensorMap* map_w,
                                        const CUtensorMap* map_x) {
  using C = Cfg<kBNW, kSplitN>;
  constexpr int kStep = C::kProducers / 8;  // rows a pass
  constexpr int kARows = C::BM / kStep;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const int pt = threadIdx.x - 2 * kWg;
  const int chunk = pt & 7, r0 = pt >> 3;
  const uint32_t dst0 = swz128(r0, chunk);  // rows r0 + kStep i
  const int ohw = p.OH * p.OW;
  const int nk = (p.K + kBK - 1) / kBK;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = p.div_ntiles(tile);
    const int m0 = mt * C::BM, n0 = (tile - mt * n_tiles) * C::BN;
    // each row's window: x offset of its top-left tap (may lie outside x)
    // and its top-left input position; rows past M never pass the check
    int row_off[kARows], ih0[kARows], iw0[kARows];
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int m = m0 + r0 + kStep * i;
      if (m < p.M) {
        const int n = p.div_ohw(m), rem = m - n * ohw;
        const int oh = p.div_ow(rem), ow = rem - oh * p.OW;
        ih0[i] = oh * p.SH - p.PH;
        iw0[i] = ow * p.SW - p.PW;
        row_off[i] = ((n * p.H + ih0[i]) * p.W + iw0[i]) * p.C;
      } else {
        ih0[i] = -(1 << 30);
        iw0[i] = 0;
        row_off[i] = 0;
      }
    }
    // this thread's chunk at K step 0: channel c of tap (ti, tj), at x
    // offset off from a row's top-left tap
    int c = chunk * 8, ti = 0, tj = 0, off = chunk * 8;
    while (c >= p.C) {
      c -= p.C;
      if (++tj == p.KW) {
        tj = 0;
        ++ti;
        off += (p.W - p.KW) * p.C;
      }
    }
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      char* a_s = smem + stage * C::kStageBytes;
      char* b_s = a_s + C::kABytes;
      // one thread loads the w tile (and, for a 1x1 stride-1 conv, the x
      // tile) by TMA; the others gather x
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[stage],
                              (p.tma_x ? C::kABytes : 0) + C::BN * kBK * 2);
        tma_load_2d(b_s, map_w, &full[stage], kt * kBK, n0);
        if (p.tma_x) tma_load_2d(a_s, map_x, &full[stage], kt * kBK, m0);
      }
      if (!p.tma_x) {
        const bool tap_ok = ti < p.KH;
#pragma unroll
        for (int i = 0; i < kARows; ++i) {
          const bool ok = tap_ok &&
                          static_cast<unsigned>(ih0[i] + ti) <
                              static_cast<unsigned>(p.H) &&
                          static_cast<unsigned>(iw0[i] + tj) <
                              static_cast<unsigned>(p.W);
          cp_async16(a_s + dst0 + kStep * 128 * i,
                     ok ? x + (row_off[i] + off) : x, ok ? 16 : 0);
        }
      }
      cp_async_arrive_noinc(&full[stage]);
      // the next K step: 64 channels on, across taps by increments
      c += kBK;
      off += kBK;
      while (c >= p.C) {
        c -= p.C;
        if (++tj == p.KW) {
          tj = 0;
          ++ti;
          off += (p.W - p.KW) * p.C;
        }
      }
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  cp_async_wait_all();
}

// A consumer warpgroup's epilogue of one tile: bias, residual and act on
// the f32 accumulator, one cast, the tile staged in shared memory and
// stored in 16-byte rows; the statistics of the stored values.  kRes: 0 no
// residual, 1 a bf16 residual staged by 16-byte cp.async, 2 one read in
// place (f32, or not 16-byte aligned).  The per-element code has no branch.
template <int kBNW, int kRes>
__device__ __forceinline__ void epilogue(const Params& p,
                                         float (&acc)[2][kBNW / 2],
                                         __nv_bfloat16* st, float* red,
                                         int wg, int m0, int n0) {
  constexpr int kChunks = kBNW / 8;
  const int wt = threadIdx.x & (kWg - 1);
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  // relu as a select that keeps NaN, as jnp.maximum; no act: -inf
  const float lo = p.act == 1 ? 0.f : -__int_as_float(0x7f800000);
  // this thread's rows: 64 mi + 16 warp + g + 8 h, all with row % 8 == g
  bool in[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      in[mi][h] = m0 + 64 * mi + 16 * warp + g + 8 * h < p.M;
  __nv_bfloat16* st_t = st + (16 * warp + g) * kBNW + 2 * t;
  // the previous tile's reads of st and red are done
  named_barrier(1 + wg, kWg);
  if constexpr (kRes == 1) {
    const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(p.res);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = wt + i * kWg;
      const int r = idx / kChunks, ch = idx % kChunks;
      const int row = m0 + r, col = n0 + ch * 8;
      const bool ok = row < p.M && col < p.Cout;
      cp_async16(st + staged<kBNW>(r, ch),
                 ok ? res + static_cast<long long>(row) * p.Cout + col : res,
                 ok ? 16 : 0);
    }
    cp_async_wait_all();
    named_barrier(1 + wg, kWg);
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const int sw = (j ^ g) << 3;
    float bias[2] = {0.f, 0.f};
    if (p.bias) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + e < p.Cout) bias[e] = load_f32(p.bias, p.bias_dtype, col + e);
    }
    __nv_bfloat162 y[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(
            st_t + (64 * mi + 8 * h) * kBNW + sw);
        float v0 = acc[mi][4 * j + 2 * h] + bias[0];
        float v1 = acc[mi][4 * j + 2 * h + 1] + bias[1];
        if constexpr (kRes == 1) {
          const float2 r = __bfloat1622float2(*slot);
          v0 += r.x;
          v1 += r.y;
        }
        if constexpr (kRes == 2) {
          const long long idx =
              static_cast<long long>(m0 + 64 * mi + 16 * warp + g + 8 * h) *
                  p.Cout + col;
          if (in[mi][h] && col < p.Cout)
            v0 += load_f32(p.res, p.res_dtype, idx);
          if (in[mi][h] && col + 1 < p.Cout)
            v1 += load_f32(p.res, p.res_dtype, idx + 1);
        }
        v0 = v0 < lo ? lo : v0;
        v1 = v1 < lo ? lo : v1;
        y[mi][h] = __floats2bfloat162_rn(v0, v1);
        *slot = y[mi][h];
      }
    if (p.s1) {
      // column sums of the stored values over this thread's rows, then
      // over the 8 lanes that share t, then (below) over the four warps,
      // in a fixed order
      float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 yf = __bfloat1622float2(y[mi][h]);
          const float a = in[mi][h] && col < p.Cout ? yf.x : 0.f;
          const float b = in[mi][h] && col + 1 < p.Cout ? yf.y : 0.f;
          t1[0] += a;
          t2[0] += a * a;
          t1[1] += b;
          t2[1] += b * b;
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          t1[e] += __shfl_xor_sync(0xffffffffu, t1[e], o);
          t2[e] += __shfl_xor_sync(0xffffffffu, t2[e], o);
        }
        if (g == 0) {
          red[warp * kBNW + 8 * j + 2 * t + e] = t1[e];
          red[(4 + warp) * kBNW + 8 * j + 2 * t + e] = t2[e];
        }
      }
    }
  }
  named_barrier(1 + wg, kWg);
  if (p.vec_out && m0 + kWg <= p.M && n0 + kBNW <= p.Cout) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = wt + i * kWg;
      const int r = idx / kChunks, ch = idx % kChunks;
      *reinterpret_cast<uint4*>(out + static_cast<long long>(m0 + r) *
                                          p.Cout + n0 + ch * 8) =
          *reinterpret_cast<const uint4*>(st + staged<kBNW>(r, ch));
    }
  } else {
    for (int idx = wt; idx < kWg * kChunks; idx += kWg) {
      const int r = idx / kChunks, ch = idx % kChunks;
      const int row = m0 + r, col = n0 + ch * 8;
      if (row >= p.M || col >= p.Cout) continue;
      const __nv_bfloat16* src = st + staged<kBNW>(r, ch);
      __nv_bfloat16* dst = out + static_cast<long long>(row) * p.Cout + col;
      if (p.vec_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && col + e < p.Cout; ++e) dst[e] = src[e];
      }
    }
  }
  // a 256-row tile past M's end leaves its second partial row unwritten
  if (p.s1 && wt < kBNW && n0 + wt < p.Cout && m0 < p.M) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      a += red[w * kBNW + wt];
      b += red[(4 + w) * kBNW + wt];
    }
    const long long i = static_cast<long long>(m0 / kTileM) * p.Cout + n0 + wt;
    p.s1[i] = a;
    p.s2[i] = b;
  }
}

template <int kBNW, bool kSplitN>
__global__ void __launch_bounds__(Cfg<kBNW, kSplitN>::kThreads, 1)
    conv_wgmma_kernel(const Params p, int n_tiles, int tiles,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_x) {
  using C = Cfg<kBNW, kSplitN>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* staging =
      reinterpret_cast<__nv_bfloat16*>(smem + C::kStages * C::kStageBytes);
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<char*>(staging) + 2 * C::kStagingBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(red) + 2 * C::kRedBytes);
  uint64_t* empty = full + C::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      // every producer's copies, and the TMA thread's expected bytes
      mbar_init(&full[s], C::kProducers + 1);
      mbar_init(&empty[s], 8);      // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg >= 2) {
    produce<kBNW, kSplitN>(p, smem, full, empty, n_tiles, tiles, &map_w,
                           &map_x);
  } else {
    const int lane = threadIdx.x & 31;
    // rows and columns of this warpgroup within the tile and its stages
    const int a_row0 = kSplitN ? 0 : 128 * wg;
    const int b_row0 = kSplitN ? kBNW * wg : 0;
    const uint32_t smem_base = smem_addr(smem);
    __nv_bfloat16* st = staging + wg * (C::kStagingBytes / 2);
    float* wred = red + wg * (C::kRedBytes / 4);
    const int nk = (p.K + kBK - 1) / kBK;
    int stage = 0;
    uint32_t phase = 0;
    float acc[2][kBNW / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = p.div_ntiles(tile);
      const int m0 = mt * C::BM, n0 = (tile - mt * n_tiles) * C::BN;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < kBNW / 2; ++i) acc[mi][i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        // the stage was written by cp.async (generic proxy); wgmma reads
        // it through the async proxy
        fence_proxy_async();
        fence_operand(acc[0]);
        fence_operand(acc[1]);
        wgmma_fence();
        const uint32_t a_s = smem_base + stage * C::kStageBytes;
        const uint32_t b_s = a_s + C::kABytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t bd = wgmma_desc(b_s + b_row0 * 128 + kk * 32);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint64_t ad =
                wgmma_desc(a_s + (a_row0 + 64 * mi) * 128 + kk * 32);
            if constexpr (kBNW == 128)
              wgmma_m64n128k16(acc[mi], ad, bd);
            else
              wgmma_m64n64k16(acc[mi], ad, bd);
          }
        }
        wgmma_commit();
        // keep this step's products in flight; the previous step's have
        // completed, so its stage goes back to the producer
        wgmma_wait<1>();
        fence_operand(acc[0]);
        fence_operand(acc[1]);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      if (lane == 0) mbar_arrive(&empty[prev]);
      const int em = m0 + a_row0, en = n0 + b_row0;
      if (!p.res)
        epilogue<kBNW, 0>(p, acc, st, wred, wg, em, en);
      else if (p.res_staged)
        epilogue<kBNW, 1>(p, acc, st, wred, wg, em, en);
      else
        epilogue<kBNW, 2>(p, acc, st, wred, wg, em, en);
    }
  }
}

template <int kBNW, bool kSplitN>
cudaError_t launch_wgmma(Params p, cudaStream_t s) {
  using C = Cfg<kBNW, kSplitN>;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(conv_wgmma_kernel<kBNW, kSplitN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  const long long m_tiles = (static_cast<long long>(p.M) + C::BM - 1) / C::BM;
  const long long n_tiles = (p.Cout + C::BN - 1) / C::BN;
  const long long tiles = m_tiles * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  p.div_ntiles = make_fastdiv(static_cast<uint32_t>(n_tiles));
  // w as [Cout, K]; x as [N*H*W, C] when its rows are the output rows
  CUtensorMap map_w, map_x;
  cudaError_t e = encode_tile_map(&map_w, p.w, p.Cout, p.K, C::BN);
  p.tma_x = p.KH == 1 && p.KW == 1 && p.SH == 1 && p.SW == 1 && p.PH == 0 &&
            p.PW == 0 && p.OH == p.H && p.OW == p.W;
  map_x = map_w;
  if (e == cudaSuccess && p.tma_x)
    e = encode_tile_map(&map_x, p.x, p.M, p.C, C::BM);
  if (e != cudaSuccess) return e;
  conv_wgmma_kernel<kBNW, kSplitN><<<grid, C::kThreads, C::kSmemBytes, s>>>(
      p, static_cast<int>(n_tiles), static_cast<int>(tiles), map_w, map_x);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32
// ---------------------------------------------------------------------------

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

// The epilogue of one output element: bias, residual, act on the f32
// accumulator, one store.  Returns the stored value (0 outside the
// output), which the statistics sum.
__device__ __forceinline__ float epilogue_store_f32(const Params& p, int row,
                                                    int col, float acc) {
  if (row >= p.M || col >= p.Cout) return 0.f;
  const long long idx = static_cast<long long>(row) * p.Cout + col;
  if (p.bias) acc += load_f32(p.bias, p.bias_dtype, col);
  if (p.res) acc += load_f32(p.res, p.res_dtype, idx);
  if (p.act == 1 && acc < 0.f) acc = 0.f;  // keeps NaN, as jnp.maximum
  static_cast<float*>(p.out)[idx] = acc;
  return acc;
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
  const int b_col = tid >> 1, b_k = (tid & 1) * 4;
  const Row row = make_row(p, m0 + a_row);
  for (int k0 = 0; k0 < p.K; k0 += kFBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long off = x_offset(p, row, k0 + a_k + e);
      As[a_k + e][a_row] = off >= 0 ? x[off] : 0.f;
    }
    const int gn = n0 + b_col;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gk = k0 + b_k + e;
      Bs[b_k + e][b_col] =
          (gk < p.K && gn < p.Cout)
              ? w[static_cast<long long>(gn) * p.K + gk]
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
      const float v = epilogue_store_f32(p, r, col, acc[i][j]);
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x NHWC [N,H,W,C], w OHWI [Cout,KH,KW,C], bias [Cout] or null, res
// [N,OH,OW,Cout] or null, out [N,OH,OW,Cout]; s1 and s2 null, or both
// [s_rows, Cout] f32 for the statistics, where s_rows must be
// ceil(N*OH*OW / pt_conv_tile_m()).  dtype: 0 = float32, 1 = bfloat16 (x, w
// and out; bf16 also needs C % 8 == 0, x and w 16-byte aligned and x of
// fewer than 2^31 elements); bias_dtype and res_dtype the same codes,
// ignored for a null pointer.  act: 0 none, 1 relu.  Returns a
// cudaError_t.
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
  const long long m_tiles = (M + kTileM - 1) / kTileM;
  if (s1 && s_rows != m_tiles) return cudaErrorInvalidValue;
  Params p{x,  w,  bias, res, out, static_cast<float*>(s1),
           static_cast<float*>(s2), N, H, W, C, Cout, KH, KW, SH,
           SW, PH, PW, OH, OW, static_cast<int>(M),
           static_cast<int>(K), bias_dtype, res_dtype, act, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(static_cast<unsigned>(m_tiles), (Cout + kBN - 1) / kBN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if (M == 0 || Cout == 0) return cudaSuccess;
    conv_f32_kernel<<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  if (dtype != 1 || C % 8 != 0 || !aligned16(x) || !aligned16(w) ||
      static_cast<long long>(N) * H * W * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (M == 0 || Cout == 0) return cudaSuccess;
  p.vec_out = Cout % 8 == 0 && aligned16(out);
  p.div_ohw = make_fastdiv(static_cast<uint32_t>(OH) * OW);
  p.div_ow = make_fastdiv(static_cast<uint32_t>(OW));
  p.res_staged = res && res_dtype == 1 && Cout % 8 == 0 && aligned16(res);
  if (Cout <= 64) return launch_wgmma<64, false>(p, s);
  if (Cout <= 128) return launch_wgmma<128, false>(p, s);
  return launch_wgmma<128, true>(p, s);
}

// The output rows (pixels) of one statistics partial.
int pt_conv_tile_m() { return kTileM; }

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
