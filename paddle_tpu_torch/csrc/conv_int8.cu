// The s8 x s8 -> s32 convolution and matmul for Hopper (sm_90a), with the
// int8 ops' epilogue fused, plain C interface.
//
// Replaces the s8 dots of paddle_tpu/ops/quant.py: conv2d_int8's
// lax.conv_general_dilated (and its im2col lowering's dot_general) and
// mul_int8's dot_general, each with preferred_element_type=int32
// (ops/quant.py:228-243, 335-340 and 462).  The JAX package leaves these to
// XLA; they are not Pallas kernels.  Contract:
//   x [N,H,W,C] int8 NHWC contiguous, C = G * cig, cig a multiple of 16
//   (the wrapper pads each group's channels with zeros); w [Cout, KH, KW,
//   cig] int8 (OHWI, the wrapper's cached copy of the OIHW filter, padded
//   alike), Cout = G * cog.  acc[m, co] = sum over (kh, kw, c) of
//   x[n, oh*sh - ph + kh*dh, ow*sw - pw + kw*dw, g*cig + c] * w[co, kh, kw,
//   c] for co in group g, exact in int32 (|acc| <= 127^2 * KH*KW*cig).
//   mul_int8 enters as a 1x1 convolution over [M, 1, 1, K].
//   The packed stem (route 2, groups 1, cig <= 4, dw 1, sw, pw and W
//   even): x [N,H,W,4] (the channels padded to 4, and W on the left so the
//   padding is even) and w [Cout, KH, KP], KP = KW * 4 rounded up to 16
//   bytes, w[co, kh, 4 * kw + c] the tap (kh, kw) of channel c: one filter
//   row's KW taps are KW * 4 contiguous bytes of x, so K is KH * KP (224
//   for the 7x7 stem) and not KH * KW * 16 (784), and a pair of taps
//   starts on 8 bytes.
//   out [N*OH*OW, Cout] (NHWC), written as one of:
//     int32: the raw accumulator (out_dtype "int32");
//     otherwise y = f32(acc) * alpha, then * colscale[co] when given, each
//     an f32 product rounded to nearest: conv2d_int8 passes alpha = sx /
//     bnd^2 (rounded once in f32 by the wrapper) and colscale = the filter
//     scale; mul_int8 passes alpha = sx / bnd and colscale = its
//     per-column (or per-tensor, broadcast) scale / bnd, or none for the
//     per-row convention (folded into x before quantisation).  Both ops
//     round in the same order, (f32(acc) * alpha) * colscale, as the JAX
//     ops do (conv: * (sx / bnd^2) * sc; mul: * (sx / bnd), then * post);
//     then the cast to y_code's dtype (f32 or bf16); + bias[co] and +
//     residual[m, co] with elementwise_add's promotion (a bf16 y plus an
//     f32 operand becomes f32; two bf16 stay bf16, rounded after the f32
//     add); relu as max(y, 0); and, where out_scale is given, the
//     requantize stage: clip(rint(y / so * bnd), -bnd, bnd) as int8, with
//     so = max(out_scale, 1e-8) from the wrapper.  Every float step is an
//     explicit __fmul_rn / __fdiv_rn / __fadd_rn (nvcc would otherwise
//     contract a*b+c into an FMA) and rint is round-half-even, as
//     jnp.round: the output is bit-equal to the plain PyTorch version, on
//     either route.
//
// Design (routes 1 and 2, groups 1: every int8 op of the repo's models):
// an implicit GEMM, M = N*OH*OW output pixels by Cout by K = KH*KW*cig
// bytes, a persistent warp-specialised kernel on wgmma s8.  One CTA an SM
// walks 256 x BN output tiles (Cout tiles fastest, so CTAs that run at
// once share x rows in L2), BN = 64 for Cout <= 64 (a 64-channel conv
// computes no idle columns), else 128: each x row is read Cout/128 times,
// the later times from L2 (128 x 256 tiles, which read it Cout/256 times,
// measured slower: PERF.md).  A producer warpgroup (two for the 64-channel
// tile, whose gather feeds fewer products) fills a ring of 3-4 stages,
// each a K step of 128 bytes: K-major tiles of 128-byte rows in the
// 128-byte swizzle (the bf16 tiles' layout; s8 wgmma reads both operands
// K-major only, which OHWI w and NHWC x are already).  w comes by TMA (a
// 2D map over [Cout, K]); x too where the conv is 1x1, stride 1, unpadded
// (its rows are the output's); otherwise each producer thread gathers one
// 16-byte chunk (16 channels of one tap) of its rows by cp.async,
// zero-filled outside the image and past K, its (tap, channel) advanced
// by increments (the packed stem: two 8-byte pairs of taps a chunk).  Each stage's
// "full" mbarrier takes the TMA bytes and every producer's
// cp.async.mbarrier.arrive.noinc.  Two consumer warpgroups (128 x BN each,
// 192-208 registers by setmaxnreg, the producers giving theirs up) wait on
// it, fence the async proxy and run wgmma.m64nNk32.s32.s8.s8, four k32
// slices a stage between barriers, releasing the stage once its products
// completed.  The epilogue, the part that holds most shapes, takes the
// accumulator in slabs of 64 columns: staged as s32 in shared memory, then
// each thread takes eight consecutive columns of a row: bias and colscale
// read once a slab, the residual by 16-byte loads four rows ahead, the
// stages, the output by 16-byte (f32, bf16, int32) or 8-byte (int8)
// stores, while the producers fill the ring for the next tile.  It issues
// a few instructions an output on 8 warps an SM, so its instruction count
// and its code size are what it is tuned for: the stages of the int8
// legs' epilogue subsets are compiled apart (W8Mode) and the slab loop is
// not unrolled; f32(acc) is an integer add where K <= 256; y / so in the
// requantize stage is y times RN64(1 / so) in f64, the same float as the
// division without its slow-path branch (i8_requant_rcp says why), and
// its rint and int cast one float add for an integer bnd.
// Route 0 (groups > 1, and on request: the first design, kept as the
// reference the wgmma route is held to): one CTA of 4 warps a 128 x 64 tile
// of one group (blockIdx.z), each warp 32 x 64 as 2 x 8 products of
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, 32 channels of one tap
// a K step by cp.async into a 4-stage ring, the epilogue per accumulator.
// What bounds it (H100 SXM at 700 W: 3.35 TB/s, 1979 TOPS dense s8): at
// ResNet-50's shapes at batch 128 the int8 convolutions move x once (1
// byte), w once and write an f32, bf16 or int8 y: bytes bound most shapes,
// the operations the 3x3 ones from 128 channels up; PERF.md has the times.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kI8Threads = 128;
constexpr int kI8BM = 128;     // output pixels a CTA
constexpr int kI8BN = 64;      // output channels a CTA
constexpr int kI8BK = 32;      // channels of one tap a K step (bytes)
constexpr int kI8Stages = 4;

// a row of a tile is 32 bytes (two 16-byte chunks); chunk j of row r sits
// at chunk j ^ ((r >> 2) & 1)
__device__ __forceinline__ int i8_chunk(int r, int j) {
  return j ^ ((r >> 2) & 1);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

struct I8Params {
  const int8_t* x;
  const int8_t* w;
  const float* alpha;     // [1]
  const float* colscale;  // [Cout] or null
  const void* bias;       // [Cout] f32/bf16 or null
  const void* residual;   // [M, Cout] f32/bf16 or null
  const float* out_scale; // [1] so = max(OutScale, 1e-8), or null
  void* out;
  int N, H, W, C, Cout, KH, KW, cig, cog, sh, sw, ph, pw, dh, dw, OH, OW;
  int M;
  int out_code;   // 0 f32, 1 bf16, 2 int8 (out_scale), 3 int32
  int y_code;     // the cast's dtype: 0 f32, 1 bf16
  int bias_code;  // -1 none, 0 f32, 1 bf16
  int res_code;
  int relu;
  float bnd;
  // y rounded to bf16 after the cast, the bias add, the residual add: the
  // promotion of elementwise_add (bf16 + bf16 stays bf16, else f32)
  int round_y, round_b, round_r;
  // the same, on the wgmma route's store of a bf16 out: the last rounding
  // left to the store's conversion (relu commutes with it)
  int fold_y, fold_b, fold_r;
  int small_acc;  // |acc| <= 2^22 (K <= 256): converted exactly by an add
  int mode;       // the store's stages fixed at compile time (W8Mode), or 0
  int int_bnd;    // bnd an integer: requantize clamps, then rounds by an add
  // the wgmma route
  int K;      // bytes of a w row: KH * KW * cig, or KH * kp (packed stem)
  int kp;     // packed stem: bytes of one filter row's taps; 0 otherwise
  int vec;    // out and residual rows in whole 16-byte groups of 8 columns
  int tma_x;  // x arrives by TMA (1x1, stride 1, unpadded)
  FastDiv div_ohw, div_ow, div_ntiles;  // by OH*OW, OW, Cout tiles
};

__device__ __forceinline__ float i8_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float i8_load(const void* p, int code,
                                         long long i) {
  return code == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// y of one output element from its accumulator, with alpha, the channel's
// colscale value cs (used where p.colscale is given), its bias value b and
// the residual value r (used where their codes say they exist): the two
// products, the cast, the adds with elementwise_add's promotion (y stays
// bf16, rounded after each f32 add, only while both sides are bf16:
// round_y, round_b, round_r, set once on the host), relu.  No stage
// branches: each is a uniform flag on a few instructions, so the
// compiler predicates them and overlaps neighbouring outputs.
__device__ __forceinline__ float i8_value(const I8Params& p, float acc,
                                          float alpha, float cs, float b,
                                          float r, int ry, int rb, int rr) {
  float y = __fmul_rn(acc, alpha);
  if (p.colscale) y = __fmul_rn(y, cs);
  if (ry) y = i8_round_bf16(y);
  if (p.bias_code >= 0) y = __fadd_rn(y, b);
  if (rb) y = i8_round_bf16(y);
  if (p.res_code >= 0) y = __fadd_rn(y, r);
  if (rr) y = i8_round_bf16(y);
  if (p.relu) y = y > 0.f ? y : 0.f;
  return y;
}

// The requantize stage: clip(rint(y / so * bnd), -bnd, bnd).
__device__ __forceinline__ int8_t i8_requant(float y, float so, float bnd) {
  float q = rintf(__fmul_rn(__fdiv_rn(y, so), bnd));
  q = fminf(fmaxf(q, -bnd), bnd);
  return static_cast<int8_t>(q);
}

// The requantize stage with y / so taken as y * rcp in f64, rcp =
// RN64(1 / so), then rounded to f32: the same float as the true division
// (__fdiv_rn), without its slow-path branch, which keeps the compiler from
// overlapping the divisions of neighbouring outputs.  y * rcp lies within
// 2^-52 of y / so (relative); a quotient of two 24-bit significands lies
// 2^-49 or more (relative) from every midpoint of two floats unless it is
// one, which it cannot be (its odd part would need 25 bits); so both round
// to the same f32.  Zeros, infinities and NaN pass as in the division.
// With an integer bnd, clamping before rint gives what clamping after it
// does, and the clamped value rounds to an integer (ties to even) by
// adding 1.5 * 2^23, whose low bits are then that integer.
__device__ __forceinline__ int8_t i8_requant_rcp(float y, double rcp,
                                                 float bnd, int int_bnd) {
  const float d = __double2float_rn(__dmul_rn(static_cast<double>(y), rcp));
  const float t = __fmul_rn(d, bnd);
  if (int_bnd)
    return static_cast<int8_t>(
        __float_as_int(__fadd_rn(fminf(fmaxf(t, -bnd), bnd), 12582912.f)) -
        0x4b400000);
  float q = rintf(t);
  q = fminf(fmaxf(q, -bnd), bnd);
  return static_cast<int8_t>(q);
}

// f32(acc), rounded to nearest; exactly, by an integer add and a float
// subtraction of 1.5 * 2^23, where |acc| <= 2^22 (small).
__device__ __forceinline__ float i8_acc_float(int acc, int small) {
  return small ? __fsub_rn(__int_as_float(0x4b400000 + acc), 12582912.f)
               : __int2float_rn(acc);
}

__device__ __forceinline__ void i8_store(const I8Params& p, long long at,
                                         int co, int acc) {
  if (p.out_code == 3) {
    static_cast<int*>(p.out)[at] = acc;
    return;
  }
  const float y = i8_value(
      p, __int2float_rn(acc), *p.alpha, p.colscale ? p.colscale[co] : 1.f,
      p.bias_code >= 0 ? i8_load(p.bias, p.bias_code, co) : 0.f,
      p.res_code >= 0 ? i8_load(p.residual, p.res_code, at) : 0.f,
      p.round_y, p.round_b, p.round_r);
  if (p.out_code == 2) {
    static_cast<int8_t*>(p.out)[at] = i8_requant(y, *p.out_scale, p.bnd);
  } else if (p.out_code == 1) {
    static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16(y);
  } else {
    static_cast<float*>(p.out)[at] = y;
  }
}

__global__ void __launch_bounds__(kI8Threads)
    conv_int8_kernel(const I8Params p) {
  __shared__ __align__(16) uint8_t a_s[kI8Stages][kI8BM * kI8BK];
  __shared__ __align__(16) uint8_t b_s[kI8Stages][kI8BN * kI8BK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * kI8BM;
  const int o0 = blockIdx.y * kI8BN;
  const int grp = blockIdx.z;
  const int kc_steps = (p.cig + kI8BK - 1) / kI8BK;  // K steps a tap
  const int nk = p.KH * p.KW * kc_steps;

  // this thread's x row (pixel m0 + tid): both of its 16-byte chunks
  const long long am = m0 + tid;
  const bool a_live = am < p.M;
  int a_n = 0, a_oh = 0, a_ow = 0;
  if (a_live) {
    a_ow = static_cast<int>(am % p.OW);
    const long long r = am / p.OW;
    a_oh = static_cast<int>(r % p.OH);
    a_n = static_cast<int>(r / p.OH);
  }
  // this thread's filter chunk: row tid / 2, chunk tid % 2
  const int b_row = tid >> 1, b_j = tid & 1;
  const bool b_live = o0 + b_row < p.cog;
  const long long b_base =
      (static_cast<long long>(grp) * p.cog + o0 + b_row) * p.KH * p.KW *
      p.cig;

  auto issue = [&](int kt) {
    const int stage = kt % kI8Stages;
    const int tap = kt / kc_steps;
    const int c0 = (kt - tap * kc_steps) * kI8BK;
    const int kh = tap / p.KW, kw = tap - kh * p.KW;
    const int ih = a_oh * p.sh - p.ph + kh * p.dh;
    const int iw = a_ow * p.sw - p.pw + kw * p.dw;
    const bool in = a_live && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
    const int8_t* xrow =
        p.x + ((static_cast<long long>(a_n) * p.H + ih) * p.W + iw) * p.C +
        static_cast<long long>(grp) * p.cig + c0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = in && c0 + 16 * j < p.cig;
      cp_async16(&a_s[stage][tid * kI8BK + i8_chunk(tid, j) * 16],
                 ok ? static_cast<const void*>(xrow + 16 * j)
                    : static_cast<const void*>(p.x),
                 ok ? 16 : 0);
    }
    const bool okb = b_live && c0 + 16 * b_j < p.cig;
    cp_async16(&b_s[stage][b_row * kI8BK + i8_chunk(b_row, b_j) * 16],
               okb ? static_cast<const void*>(
                         p.w + b_base + static_cast<long long>(tap) * p.cig +
                         c0 + 16 * b_j)
                   : static_cast<const void*>(p.w),
               okb ? 16 : 0);
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kI8Stages - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kI8Stages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + kI8Stages - 1 < nk) issue(kt + kI8Stages - 1);
    cp_async_commit();
    const uint8_t* as = a_s[kt % kI8Stages];
    const uint8_t* bs = b_s[kt % kI8Stages];
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r0 = warp * 32 + i * 16 + g, r1 = r0 + 8;
      a[i][0] = *reinterpret_cast<const uint32_t*>(
          as + r0 * kI8BK + i8_chunk(r0, 0) * 16 + 4 * t);
      a[i][1] = *reinterpret_cast<const uint32_t*>(
          as + r1 * kI8BK + i8_chunk(r1, 0) * 16 + 4 * t);
      a[i][2] = *reinterpret_cast<const uint32_t*>(
          as + r0 * kI8BK + i8_chunk(r0, 1) * 16 + 4 * t);
      a[i][3] = *reinterpret_cast<const uint32_t*>(
          as + r1 * kI8BK + i8_chunk(r1, 1) * 16 + 4 * t);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = j * 8 + g;
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(
          bs + n * kI8BK + i8_chunk(n, 0) * 16 + 4 * t);
      b[1] = *reinterpret_cast<const uint32_t*>(
          bs + n * kI8BK + i8_chunk(n, 1) * 16 + 4 * t);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = m0 + warp * 32 + i * 16 + g + 8 * hh;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ol = o0 + j * 8 + 2 * t + e;
          if (ol >= p.cog) continue;
          const int co = grp * p.cog + ol;
          i8_store(p, m * p.Cout + co, co, acc[i][j][2 * hh + e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// route 1: wgmma s8, persistent and warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWg = 128;  // threads of a warpgroup
constexpr int kWK = 128;  // bytes of K a stage: one 128-byte swizzled row

// d += A[64 x 32] * B[N x 32]^T in s8 with an s32 accumulator, A and B
// K-major tiles in shared memory (wgmma_desc), N 64 or 128.  The
// accumulator has the f32 layout of wgmma.cuh's header.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (N == 64)
    wgmma_s8_n64(d, a, b);
  else
    wgmma_s8_n128(d, a, b);
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Position of 16-byte chunk j (0-15) of row r in a staging slab of 64 s32
// columns: j ^ (r % 8), with the chunk's own bit 3 folded in, so the eight
// chunks 2q (or 2q + 1) a quarter warp reads of one row, and the chunks
// the accumulator fragments write, fall on distinct bank groups.
__device__ __forceinline__ int slab_chunk(int j, int r) {
  return j ^ ((j >> 3) & 1) ^ (r & 7);
}

// Copies 8 bytes (src 8-byte aligned); reads src_bytes of them (0 or 8)
// and zero-fills the rest.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The tile of one Cout width BN (64 or 128): two consumer warpgroups, each
// WM = 128 rows x BN columns (MI = 2 products of m64 a k32 slice), one
// above the other.
template <int BN>
struct WCfg {
  static constexpr int WM = 128;
  static constexpr int MI = WM / 64;
  static constexpr int BM = 2 * WM;
  static constexpr int kAcc = BN / 2;  // s32 accumulators a product
  static constexpr int kStages = BN == 128 ? 3 : 4;
  // a 64-channel tile gathers 256 rows for 64 columns of products: two
  // producer warpgroups
  static constexpr int kProducers = BN == 64 ? 2 * kWg : kWg;
  static constexpr int kThreads = 2 * kWg + kProducers;
  // registers a thread after setmaxnreg: the producers keep what their
  // rows' window coordinates need and give the rest to the consumers,
  // whose accumulators (64 or 128 a thread) would otherwise leave the
  // epilogue too few (it spilled at the 168 that 384 threads get):
  // 2 x 128 x kConsumerRegs + kProducers x kProducerRegs = 65536 (512
  // threads) or 64512 (384 threads at 168)
  static constexpr int kProducerRegs = BN == 64 ? 64 : 88;
  static constexpr int kConsumerRegs = BN == 64 ? 192 : 208;
  static_assert(2 * kWg * kConsumerRegs + kProducers * kProducerRegs <=
                    (kThreads == 512 ? 65536 : 64512),
                "the CTA's registers");
  static constexpr int kABytes = BM * kWK;
  static constexpr int kStageBytes = kABytes + BN * kWK;
  // a warpgroup's staging of one 64-column slab of its accumulator
  static constexpr int kStagingBytes = WM * 64 * 4;
  static constexpr int kSmemBytes =
      kStages * kStageBytes + 2 * kStagingBytes + 2 * kStages * 8 + 1024;
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(kSmemBytes <= 232448, "a CTA's shared memory");
};

// The producers: fill stage after stage for every tile of this CTA.
// Thread pt copies 16-byte chunk pt % 8 of tile rows pt / 8 + kStep i.
template <int BN>
__device__ __forceinline__ void w8_produce(const I8Params& p, char* smem,
                                           uint64_t* full, uint64_t* empty,
                                           int n_tiles, int tiles,
                                           const CUtensorMap* map_w,
                                           const CUtensorMap* map_x) {
  using Cf = WCfg<BN>;
  constexpr int kStep = Cf::kProducers / 8;  // rows a pass
  constexpr int kARows = Cf::BM / kStep;
  const int8_t* x = p.x;
  const int pt = threadIdx.x - 2 * kWg;
  const int chunk = pt & 7, r0 = pt >> 3;
  const uint32_t dst0 = swz128(r0, chunk);  // rows r0 + kStep i
  const int ohw = p.OH * p.OW;
  const int nk = (p.K + kWK - 1) / kWK;
  const int row_bytes = p.W * p.C;  // one image row of x
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = p.div_ntiles(tile);
    const int m0 = mt * Cf::BM, n0 = (tile - mt * n_tiles) * BN;
    // each row's window: x offset of its top-left tap (may lie outside x)
    // and its top-left input position; rows past M never pass the check
    int row_off[kARows], ih0[kARows], iw0[kARows];
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int m = m0 + r0 + kStep * i;
      if (m < p.M && !p.tma_x) {
        const int n = p.div_ohw(m), rem = m - n * ohw;
        const int oh = p.div_ow(rem), ow = rem - oh * p.OW;
        ih0[i] = oh * p.sh - p.ph;
        iw0[i] = ow * p.sw - p.pw;
        row_off[i] = ((n * p.H + ih0[i]) * p.W + iw0[i]) * p.C;
      } else {
        ih0[i] = -(1 << 30);
        iw0[i] = 0;
        row_off[i] = 0;
      }
    }
    // this thread's chunk at K step 0.  Gather: channel c of tap (ti, tj)
    // at x offset toff + c from a row's top-left tap.  Packed stem: byte
    // c of filter row ti, taps tj..tj+3 (c = 4 tj).
    int c = chunk * 16, ti = 0, tj = 0, toff = 0;
    if (p.kp) {
      while (c >= p.kp) c -= p.kp, ++ti;
      tj = c >> 2;
    } else {
      while (c >= p.C) {
        c -= p.C;
        toff += p.dw * p.C;
        if (++tj == p.KW) {
          tj = 0;
          ++ti;
          toff += p.dh * row_bytes - p.KW * p.dw * p.C;
        }
      }
    }
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      char* a_s = smem + stage * Cf::kStageBytes;
      char* b_s = a_s + Cf::kABytes;
      // one thread loads the w tile (and, for a 1x1 stride-1 conv, the x
      // tile) by TMA; the others gather x
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[stage],
                              (p.tma_x ? Cf::kABytes : 0) + BN * kWK);
        tma_load_2d(b_s, map_w, &full[stage], kt * kWK, n0);
        if (p.tma_x) tma_load_2d(a_s, map_x, &full[stage], kt * kWK, m0);
      }
      if (!p.tma_x && p.kp) {
        // the packed stem: taps tj..tj+3 of filter row ti, two 8-byte
        // pairs; a pair starts on an even column of an even-width x, so it
        // lies wholly inside or wholly outside the row
        const bool row_ok = ti < p.KH;
#pragma unroll
        for (int i = 0; i < kARows; ++i) {
          const int ih = ih0[i] + ti * p.dh;
          const bool ok_h = row_ok && static_cast<unsigned>(ih) <
                                          static_cast<unsigned>(p.H);
          char* dst = a_s + dst0 + kStep * 128 * i;
          const int8_t* src = x + row_off[i] + ti * p.dh * row_bytes;
#pragma unroll
          for (int u = 0; u < 4; u += 2) {
            const bool ok = ok_h && tj + u < p.KW &&
                            static_cast<unsigned>(iw0[i] + tj + u) <
                                static_cast<unsigned>(p.W);
            cp_async8(dst + 4 * u, ok ? src + 4 * (tj + u) : x, ok ? 8 : 0);
          }
        }
      } else if (!p.tma_x) {
        const bool tap_ok = ti < p.KH;
#pragma unroll
        for (int i = 0; i < kARows; ++i) {
          const bool ok = tap_ok &&
                          static_cast<unsigned>(ih0[i] + ti * p.dh) <
                              static_cast<unsigned>(p.H) &&
                          static_cast<unsigned>(iw0[i] + tj * p.dw) <
                              static_cast<unsigned>(p.W);
          cp_async16(a_s + dst0 + kStep * 128 * i,
                     ok ? x + (row_off[i] + toff + c) : x, ok ? 16 : 0);
        }
      }
      cp_async_arrive_noinc(&full[stage]);
      // the next K step: 128 bytes on, across taps by increments
      c += kWK;
      if (p.kp) {
        while (c >= p.kp) c -= p.kp, ++ti;
        tj = c >> 2;
      } else {
        while (c >= p.C) {
          c -= p.C;
          toff += p.dw * p.C;
          if (++tj == p.KW) {
            tj = 0;
            ++ti;
            toff += p.dh * row_bytes - p.KW * p.dw * p.C;
          }
        }
      }
      if (++stage == Cf::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  cp_async_wait_all();
}

// A thread's eight output channels col..col+7 of a slab: their colscale
// and bias values, read once a slab; alpha and so read once a kernel.
struct Cols8 {
  float cs[8], b[8];
};

__device__ __forceinline__ float ldg_elem(const void* p, int code,
                                          long long i) {
  return code == 0 ? __ldg(static_cast<const float*>(p) + i)
                   : __bfloat162float(
                         __ldg(static_cast<const __nv_bfloat16*>(p) + i));
}

// The stages of a store, fixed at compile time for the epilogue subsets
// the int8 legs run (the stages' flags otherwise issue as predicated
// instructions for every output, and the epilogue is bound by its issue
// rate): y's bf16 roundings (after the cast, the bias, the residual; a bf16
// out's last one folded into the store), the bias's and the residual's
// dtype codes (-1 none), relu, the out code.  kRT reads a stage from the
// params at run time (mode 0: every subset).
constexpr int kRT = 9;

template <int Ry, int Bias, int Rb, int Res, int Rr, int Relu, int Out>
struct W8Mode {
  static __device__ __forceinline__ int ry(const I8Params& p) {
    return Ry == kRT ? p.fold_y : Ry;
  }
  static __device__ __forceinline__ int bias(const I8Params& p) {
    return Bias == kRT ? p.bias_code : Bias;
  }
  static __device__ __forceinline__ int rb(const I8Params& p) {
    return Rb == kRT ? p.fold_b : Rb;
  }
  static __device__ __forceinline__ int res(const I8Params& p) {
    return Res == kRT ? p.res_code : Res;
  }
  static __device__ __forceinline__ int rr(const I8Params& p) {
    return Rr == kRT ? p.fold_r : Rr;
  }
  static __device__ __forceinline__ int relu(const I8Params& p) {
    return Relu == kRT ? p.relu : Relu;
  }
  static __device__ __forceinline__ int out(const I8Params& p) {
    return Out == kRT ? p.out_code : Out;
  }
};

// mode 0 and the subsets of infer_i8 (bf16 out, no bias) and
// infer_i8_inter (an f32 bias, relu, int8 or f32 out, with or without an
// f32 residual): pt_conv_int8 picks p.mode
using W8Any = W8Mode<kRT, kRT, kRT, kRT, kRT, kRT, kRT>;
using W8Bf16 = W8Mode<0, -1, 0, -1, 0, 0, 1>;
using W8BiasReluI8 = W8Mode<1, 0, 0, -1, 0, 1, 2>;
using W8BiasResReluI8 = W8Mode<1, 0, 0, 0, 0, 1, 2>;
using W8BiasResReluF32 = W8Mode<1, 0, 0, 0, 0, 1, 0>;
using W8BiasF32 = W8Mode<1, 0, 0, -1, 0, 0, 0>;

// The residual of eight consecutive outputs at `at` (a multiple of 8, on
// 16 bytes), by wide loads.
template <class M>
__device__ __forceinline__ void load_res8(const I8Params& p, long long at,
                                          float (&r)[8]) {
  if (M::res(p) == 0) {
    const float4* rp = reinterpret_cast<const float4*>(
        static_cast<const float*>(p.residual) + at);
    const float4 a = __ldg(rp), b = __ldg(rp + 1);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
    r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
  } else if (M::res(p) == 1) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.residual) + at));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[2 * k] = __uint_as_float(w[k] << 16);
      r[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = 0.f;
  }
}

// i8_value with the stages of mode M.
template <class M>
__device__ __forceinline__ float w8_value(const I8Params& p, float acc,
                                          float alpha, float cs, float b,
                                          float r) {
  float y = __fmul_rn(acc, alpha);
  if (p.colscale) y = __fmul_rn(y, cs);
  if (M::ry(p)) y = i8_round_bf16(y);
  if (M::bias(p) >= 0) y = __fadd_rn(y, b);
  if (M::rb(p)) y = i8_round_bf16(y);
  if (M::res(p) >= 0) y = __fadd_rn(y, r);
  if (M::rr(p)) y = i8_round_bf16(y);
  if (M::relu(p)) y = y > 0.f ? y : 0.f;
  return y;
}

// Eight consecutive output channels col..col+7 of row m from their
// accumulators v: the residual, the stages, then the stores.  The group
// lies on 16 bytes of out and residual (p.vec) and inside Cout.
template <class M>
__device__ __forceinline__ void w8_store8(const I8Params& p, int m, int col,
                                          const int (&v)[8],
                                          const Cols8& cols, float alpha,
                                          double rcp) {
  const long long at = static_cast<long long>(m) * p.Cout + col;
  if (M::out(p) == 3) {
    int4* o = reinterpret_cast<int4*>(static_cast<int*>(p.out) + at);
    o[0] = make_int4(v[0], v[1], v[2], v[3]);
    o[1] = make_int4(v[4], v[5], v[6], v[7]);
    return;
  }
  float r[8];
  load_res8<M>(p, at, r);
  float y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    y[e] = w8_value<M>(p, i8_acc_float(v[e], p.small_acc), alpha,
                       cols.cs[e], cols.b[e], r[e]);
  if (M::out(p) == 2) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e / 4] |= static_cast<uint32_t>(
                      static_cast<uint8_t>(
                          i8_requant_rcp(y[e], rcp, p.bnd, p.int_bnd)))
                  << (8 * (e % 4));
    *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + at) =
        make_uint2(w[0], w[1]);
  } else if (M::out(p) == 1) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = pack_bf16(y[2 * k], y[2 * k + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + at) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) + at);
    o[0] = make_float4(y[0], y[1], y[2], y[3]);
    o[1] = make_float4(y[4], y[5], y[6], y[7]);
  }
}

// The row loop of one slab: a thread's columns col..col+7 of rows r0 + 16
// i of the staged slab, through mode M's stages (four rows unrolled, so
// their residual loads are in flight together).
template <class M, int kRows>
__device__ __forceinline__ void w8_rows(const I8Params& p, const int* st,
                                        int r0, int q, int m0, int col,
                                        const Cols8& cols, float alpha,
                                        double rcp) {
#pragma unroll 4
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + 16 * i;
    const int m = m0 + r;
    if (m >= p.M) break;
    const int4 a = *reinterpret_cast<const int4*>(
        st + r * 64 + (slab_chunk(2 * q, r) << 2));
    const int4 b = *reinterpret_cast<const int4*>(
        st + r * 64 + (slab_chunk(2 * q + 1, r) << 2));
    const int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    if (p.vec) {
      w8_store8<M>(p, m, col, v, cols, alpha, rcp);
    } else {
      const long long at = static_cast<long long>(m) * p.Cout + col;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < p.Cout) i8_store(p, at + e, col + e, v[e]);
    }
  }
}

// Slab S (64 columns) of a consumer warpgroup's accumulator into its
// staging buffer: s32 fragments by 8-byte stores at the slab_chunk places.
template <int BN, int S>
__device__ __forceinline__ void w8_stage(
    const int (&acc)[WCfg<BN>::MI][WCfg<BN>::kAcc], int* st) {
  const int wt = threadIdx.x & (kWg - 1);
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < WCfg<BN>::MI; ++mi)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * mi + 16 * warp + g + 8 * h;
        const int j = 8 * S + jj;
        const int pos = (slab_chunk(2 * jj + (t >> 1), row) << 2) +
                        2 * (t & 1);
        *reinterpret_cast<int2*>(st + row * 64 + pos) =
            make_int2(acc[mi][4 * j + 2 * h], acc[mi][4 * j + 2 * h + 1]);
      }
}

// A consumer warpgroup's epilogue of its WM x BN part of a tile, slab by
// slab (64 columns): the slab staged (w8_stage), then each thread takes
// eight consecutive columns (the same ones in every row it takes) of WM /
// 16 rows.  The slab loop is not unrolled, and the stages are compiled
// apart for each mode (w8_rows): the code a launch runs stays small enough
// for the instruction cache (with the slabs unrolled and every subset's
// stages behind flags the kernel's code took 830 KB, and the epilogue ran
// several times slower).
template <int BN>
__device__ __forceinline__ void w8_epilogue(
    const I8Params& p, const int (&acc)[WCfg<BN>::MI][WCfg<BN>::kAcc],
    int* st, int wg, int m0, int n0, float alpha, double rcp) {
  using Cf = WCfg<BN>;
  constexpr int kRows = Cf::WM * 8 / kWg;  // rows a thread a slab
  const int wt = threadIdx.x & (kWg - 1);
  const int q = wt & 7, r0 = wt >> 3;  // rows r0 + 16 i
#pragma unroll 1
  for (int s = 0; s < BN / 64; ++s) {
    // the previous slab's (or tile's) reads of st are done
    named_barrier(1 + wg, kWg);
    switch (s) {
      case 0: w8_stage<BN, 0>(acc, st); break;
      default: if constexpr (BN == 128) w8_stage<BN, 1>(acc, st); break;
    }
    named_barrier(1 + wg, kWg);
    const int col = n0 + 64 * s + 8 * q;
    if (col >= p.Cout) continue;
    Cols8 cols;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = col + e < p.Cout;
      cols.cs[e] = p.colscale && in ? __ldg(p.colscale + col + e) : 1.f;
      cols.b[e] = p.bias_code >= 0 && in
                      ? ldg_elem(p.bias, p.bias_code, col + e)
                      : 0.f;
    }
    switch (p.mode) {
      case 1: w8_rows<W8Bf16, kRows>(p, st, r0, q, m0, col, cols, alpha,
                                     rcp); break;
      case 2: w8_rows<W8BiasReluI8, kRows>(p, st, r0, q, m0, col, cols,
                                           alpha, rcp); break;
      case 3: w8_rows<W8BiasResReluI8, kRows>(p, st, r0, q, m0, col, cols,
                                              alpha, rcp); break;
      case 4: w8_rows<W8BiasResReluF32, kRows>(p, st, r0, q, m0, col, cols,
                                               alpha, rcp); break;
      case 5: w8_rows<W8BiasF32, kRows>(p, st, r0, q, m0, col, cols, alpha,
                                        rcp); break;
      default: w8_rows<W8Any, kRows>(p, st, r0, q, m0, col, cols, alpha,
                                     rcp); break;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(WCfg<BN>::kThreads, 1)
    conv_int8_wgmma_kernel(const I8Params p, int n_tiles, int tiles,
                           const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_x) {
  using Cf = WCfg<BN>;
  extern __shared__ char smem_raw[];
  // the ring on a 1024-byte boundary, by an offset (not an integer cast),
  // so the staging's loads and stores stay shared-memory ones
  char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int* staging = reinterpret_cast<int*>(smem + Cf::kStages * Cf::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(staging) + 2 * Cf::kStagingBytes);
  uint64_t* empty = full + Cf::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::kStages; ++s) {
      // every producer's copies, and the TMA thread's expected bytes
      mbar_init(&full[s], Cf::kProducers + 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg >= 2) {
    setmaxnreg_dec<Cf::kProducerRegs>();
    w8_produce<BN>(p, smem, full, empty, n_tiles, tiles, &map_w, &map_x);
    return;
  }
  setmaxnreg_inc<Cf::kConsumerRegs>();
  const int lane = threadIdx.x & 31;
  const int a_row0 = Cf::WM * wg;
  const uint32_t smem_base = smem_addr(smem);
  int* st = staging + wg * (Cf::kStagingBytes / 4);
  const int nk = (p.K + kWK - 1) / kWK;
  int stage = 0;
  uint32_t phase = 0;
  int acc[Cf::MI][Cf::kAcc];
  const float alpha = __ldg(p.alpha);
  const double rcp = p.out_scale ? __drcp_rn(__ldg(p.out_scale)) : 1.0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = p.div_ntiles(tile);
    const int m0 = mt * Cf::BM, n0 = (tile - mt * n_tiles) * BN;
#pragma unroll
    for (int mi = 0; mi < Cf::MI; ++mi)
#pragma unroll
      for (int i = 0; i < Cf::kAcc; ++i) acc[mi][i] = 0;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      // the stage was written by cp.async (generic proxy); wgmma reads it
      // through the async proxy
      fence_proxy_async();
#pragma unroll
      for (int mi = 0; mi < Cf::MI; ++mi) fence_acc(acc[mi]);
      wgmma_fence();
      const uint32_t a_s = smem_base + stage * Cf::kStageBytes;
      const uint32_t b_s = a_s + Cf::kABytes;
#pragma unroll
      for (int kk = 0; kk < kWK / 32; ++kk) {
        const uint64_t bd = wgmma_desc(b_s + kk * 32);
#pragma unroll
        for (int mi = 0; mi < Cf::MI; ++mi)
          wgmma_s8<BN>(acc[mi],
                       wgmma_desc(a_s + (a_row0 + 64 * mi) * 128 + kk * 32),
                       bd);
      }
      wgmma_commit();
      // keep this step's products in flight; the previous step's have
      // completed, so its stage goes back to the producers
      wgmma_wait<1>();
#pragma unroll
      for (int mi = 0; mi < Cf::MI; ++mi) fence_acc(acc[mi]);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == Cf::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < Cf::MI; ++mi) fence_acc(acc[mi]);
    if (lane == 0) mbar_arrive(&empty[prev]);
    w8_epilogue<BN>(p, acc, st, wg, m0 + a_row0, n0, alpha, rcp);
  }
}

template <int BN>
cudaError_t launch_wgmma(I8Params p, cudaStream_t s) {
  using Cf = WCfg<BN>;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_int8_wgmma_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cf::kSmemBytes);
    if (e != cudaSuccess) {
      sms = 0;
      return e;
    }
  }
  const long long m_tiles = (static_cast<long long>(p.M) + Cf::BM - 1) /
                            Cf::BM;
  const long long n_tiles = (p.Cout + BN - 1) / BN;
  const long long tiles = m_tiles * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  p.div_ntiles = make_fastdiv(static_cast<uint32_t>(n_tiles));
  // w as [Cout, K]; x as [N*H*W, C] when its rows are the output rows
  CUtensorMap map_w, map_x;
  cudaError_t e = encode_byte_tile_map(&map_w, p.w, p.Cout, p.K, BN);
  p.tma_x = !p.kp && p.KH == 1 && p.KW == 1 && p.sh == 1 && p.sw == 1 &&
            p.ph == 0 && p.pw == 0 && p.OH == p.H && p.OW == p.W;
  map_x = map_w;
  if (e == cudaSuccess && p.tma_x)
    e = encode_byte_tile_map(&map_x, p.x, p.M, p.C, Cf::BM);
  if (e != cudaSuccess) return e;
  conv_int8_wgmma_kernel<BN><<<grid, Cf::kThreads, Cf::kSmemBytes, s>>>(
      p, static_cast<int>(n_tiles), static_cast<int>(tiles), map_w, map_x);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// x [N,H,W,C] int8, C = G * cig, w [Cout,KH,KW,cig] int8, Cout = G * cog;
// out [N*OH*OW, Cout].  out_code 0 f32, 1 bf16, 2 int8 (out_scale
// required), 3 int32; y_code the cast's dtype (0 f32, 1 bf16);
// bias_code/res_code -1 (none), 0 f32, 1 bf16; colscale may be null
// (mul_int8's per-row weight scales).  route 0: the mma.sync kernel (cig a
// multiple of 16, any G); 1: the wgmma kernel (G 1, cig a multiple of 16,
// x and w 16-byte aligned); 2: the wgmma kernel on the packed stem (G 1, C
// = cig = 4, dw 1, sw, pw and W even, w [Cout, KH, KP] with KP = KW * 4
// rounded up to 16).
// Returns a cudaError_t.
int pt_conv_int8(const void* x, const void* w, const float* alpha,
                 const float* colscale, const void* bias,
                 const void* residual, const float* out_scale, void* out,
                 int N, int H, int W, int C, int Cout, int KH, int KW,
                 int cig, int G, int sh, int sw, int ph, int pw, int dh,
                 int dw, int OH, int OW, int out_code, int y_code,
                 int bias_code, int res_code, int relu, int route, float bnd,
                 void* stream) {
  if (N <= 0 || OH <= 0 || OW <= 0 || G <= 0 || Cout % G != 0 ||
      C != G * cig || out_code < 0 || out_code > 3 ||
      (out_code == 2 && !out_scale) || route < 0 || route > 2 ||
      (route == 2 ? cig != 4 || dw != 1 || sw % 2 || pw % 2 || W % 2
                  : cig % 16 != 0) ||
      (route > 0 && (G != 1 || !aligned16(x) || !aligned16(w))))
    return cudaErrorInvalidValue;
  I8Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.alpha = alpha, p.colscale = colscale, p.bias = bias;
  p.residual = residual, p.out_scale = out_scale, p.out = out;
  p.N = N, p.H = H, p.W = W, p.C = C, p.Cout = Cout, p.KH = KH, p.KW = KW;
  p.cig = cig, p.cog = Cout / G, p.sh = sh, p.sw = sw, p.ph = ph, p.pw = pw;
  p.dh = dh, p.dw = dw, p.OH = OH, p.OW = OW;
  p.M = N * OH * OW;
  p.out_code = out_code, p.y_code = y_code, p.bias_code = bias_code;
  p.res_code = res_code, p.relu = relu, p.bnd = bnd;
  p.round_y = y_code == 1;
  p.round_b = p.round_y && bias_code == 1;
  p.round_r = (bias_code < 0 ? p.round_y : p.round_b) && res_code == 1;
  p.fold_y = p.round_y, p.fold_b = p.round_b, p.fold_r = p.round_r;
  if (out_code == 1) {
    if (res_code >= 0)
      p.fold_r = 0;
    else if (bias_code >= 0)
      p.fold_b = 0;
    else
      p.fold_y = 0;
  }
  p.int_bnd = bnd >= 0.f && bnd <= 4194304.f && bnd == floorf(bnd);
  // (ry, bias, rb, res, rr, relu, out) of the modes 1-5 (W8Bf16 ...)
  const int modes[5][7] = {{0, -1, 0, -1, 0, 0, 1}, {1, 0, 0, -1, 0, 1, 2},
                           {1, 0, 0, 0, 0, 1, 2},   {1, 0, 0, 0, 0, 1, 0},
                           {1, 0, 0, -1, 0, 0, 0}};
  const int have[7] = {p.fold_y, bias_code, p.fold_b, res_code, p.fold_r,
                       relu != 0, out_code};
  p.mode = 0;
  for (int m = 0; m < 5 && p.mode == 0; ++m) {
    bool same = true;
    for (int k = 0; k < 7; ++k) same = same && modes[m][k] == have[k];
    if (same) p.mode = m + 1;
  }
  const long long mt = (static_cast<long long>(N) * OH * OW + kI8BM - 1) /
                       kI8BM;
  if (mt > 0x7fffffffLL || static_cast<long long>(N) * OH * OW > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const dim3 grid(static_cast<unsigned>(mt), (p.cog + kI8BN - 1) / kI8BN,
                    G);
    conv_int8_kernel<<<grid, kI8Threads, 0, s>>>(p);
    return cudaGetLastError();
  }
  if (static_cast<long long>(N) * H * W * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  p.kp = route == 2 ? (KW * 4 + 15) / 16 * 16 : 0;
  p.K = route == 2 ? KH * p.kp : KH * KW * cig;
  // |x|, |w| <= 128
  p.small_acc = static_cast<long long>(p.K) * 128 * 128 <= (1LL << 22);
  p.vec = Cout % 8 == 0 && aligned16(out) && (!residual || aligned16(residual));
  p.div_ohw = make_fastdiv(static_cast<uint32_t>(OH) * OW);
  p.div_ow = make_fastdiv(static_cast<uint32_t>(OW));
  if (Cout <= 64) return launch_wgmma<64>(p, s);
  return launch_wgmma<128>(p, s);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
