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
//     jnp.round: the output is bit-equal to the plain PyTorch version.
//
// Design: an implicit GEMM, M = N*OH*OW output pixels by cog output
// channels by K = KH*KW*cig, one CTA of 4 warps a 128 x 64 tile of one
// group (blockIdx.z), each warp 32 x 64 as 2 x 8 products of
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  The K loop takes 32
// channels of one filter tap a step; its x rows (one pixel's 32 channels,
// two 16-byte cp.async chunks, zero-filled past the image, the group's
// channels or M) and filter rows land in a 4-stage ring of shared memory.
// A row's two 16-byte chunks swap places every fourth row, so the eight
// rows of a fragment load hit 32 banks.  Fragments come by 32-bit shared
// loads (A: rows g and g+8, bytes 4t..4t+3 and 16+4t..; B: row n = g,
// the same bytes).  The epilogue applies the stages to each accumulator
// and writes the output type.
// What bounds it (H100 SXM at 700 W: 3.35 TB/s, 1979 TOPS dense s8): at
// ResNet-50's shapes at batch 128 the int8 convolutions move x once (1
// byte), w once and write bf16 y (2 bytes): bytes bound most shapes, the
// operations the 3x3 ones from 128 channels up; PERF.md has the times.
// This first kernel reads each x row once per 64 output channels and
// keeps every product on the tensor cores; wgmma with TMA (a ROADMAP
// item) is the fast design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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
};

__device__ __forceinline__ float i8_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float i8_load(const void* p, int code,
                                         long long i) {
  return code == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// y (dtype dt: 0 f32, 1 bf16) plus an operand of dtype `code`, with
// elementwise_add's promotion: bf16 + bf16 stays bf16 (rounded after the
// f32 add), anything else is f32
__device__ __forceinline__ float i8_add(float y, int& dt, float v, int code) {
  dt = (dt == 1 && code == 1) ? 1 : 0;
  const float s = __fadd_rn(y, v);
  return dt == 1 ? i8_round_bf16(s) : s;
}

__device__ __forceinline__ void i8_store(const I8Params& p, long long at,
                                         int co, int acc) {
  if (p.out_code == 3) {
    static_cast<int*>(p.out)[at] = acc;
    return;
  }
  float y = __fmul_rn(__int2float_rn(acc), *p.alpha);
  if (p.colscale) y = __fmul_rn(y, p.colscale[co]);
  int dt = p.y_code;
  if (dt == 1) y = i8_round_bf16(y);
  if (p.bias_code >= 0) y = i8_add(y, dt, i8_load(p.bias, p.bias_code, co),
                                   p.bias_code);
  if (p.res_code >= 0)
    y = i8_add(y, dt, i8_load(p.residual, p.res_code, at), p.res_code);
  if (p.relu) y = y > 0.f ? y : 0.f;
  if (p.out_code == 2) {
    float q = rintf(__fmul_rn(__fdiv_rn(y, *p.out_scale), p.bnd));
    q = fminf(fmaxf(q, -p.bnd), p.bnd);
    static_cast<int8_t*>(p.out)[at] = static_cast<int8_t>(q);
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

}  // namespace

extern "C" {

// x [N,H,W,C] int8, C = G * cig (cig a multiple of 16), w [Cout,KH,KW,cig]
// int8, Cout = G * cog; out [N*OH*OW, Cout].  out_code 0 f32, 1 bf16, 2
// int8 (out_scale required), 3 int32; y_code the cast's dtype (0 f32, 1
// bf16); bias_code/res_code -1 (none), 0 f32, 1 bf16; colscale may be null
// (mul_int8's per-row weight scales).  Returns a cudaError_t.
int pt_conv_int8(const void* x, const void* w, const float* alpha,
                 const float* colscale, const void* bias,
                 const void* residual, const float* out_scale, void* out,
                 int N, int H, int W, int C, int Cout, int KH, int KW,
                 int cig, int G, int sh, int sw, int ph, int pw, int dh,
                 int dw, int OH, int OW, int out_code, int y_code,
                 int bias_code, int res_code, int relu, float bnd,
                 void* stream) {
  if (N <= 0 || OH <= 0 || OW <= 0 || G <= 0 || Cout % G != 0 ||
      cig % 16 != 0 || C != G * cig ||
      out_code < 0 || out_code > 3 || (out_code == 2 && !out_scale))
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
  const long long mt = (static_cast<long long>(N) * OH * OW + kI8BM - 1) /
                       kI8BM;
  if (mt > 0x7fffffffLL || static_cast<long long>(N) * OH * OW > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(mt), (p.cog + kI8BN - 1) / kI8BN, G);
  conv_int8_kernel<<<grid, kI8Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
