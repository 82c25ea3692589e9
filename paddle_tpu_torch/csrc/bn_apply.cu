// Fused batch-norm apply for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas_conv.py::_bn_apply_kernel (:484, wrapper
// _bn_apply_pallas).  Contract, read from the Pallas kernel and
// apply_bn_tail (paddle_tpu/ops/epilogue.py:324-333):
//   t   = ((y - mean) * rstd) * scale + shift        in f32
//   out = act(cast(t) + cast(residual))              in y's dtype
// y and out are [M, C] (NHWC rows), f32 or bf16; mean, rstd, scale, shift
// are [C] f32; residual is [M, C] f32 or bf16, or null.  cast rounds to
// y's dtype, so the residual add is computed in f32 and rounded once, as a
// bf16 add in jnp is; act: 0 none, 1 relu.  Each multiply and add is
// rounded on its own (__fmul_rn, __fadd_rn: no fused multiply-add), which
// is what the plain PyTorch version computes op by op.
//
// Design: an elementwise pass, tiled in two dimensions.  Where C is a
// multiple of 8 and every pointer is 16-byte aligned (every ResNet-50
// shape), a CTA of 256 threads owns a span of up to 256 channel octets
// (C/8 of them, grid.y spans) and walks rows: thread t keeps octet t % span
// of the span for its whole loop, so its 32 coefficients (mean, rstd,
// scale, shift of 8 channels) are loaded once, by eight float4 loads, and
// the loop has no division; the 256 / span row slots of a pass take
// consecutive rows, so a warp's 16-byte accesses are contiguous.  Each
// thread loads the y (and residual) rows of four passes, streamed past L1
// (ld.global.cs), before it computes the first, and streams its stores
// out (st.global.cs).  The grid is the SM count times the CTAs an SM
// holds (the occupancy API), so every CTA is resident and walks rows
// strided by the whole grid.  Other C and misaligned views take a masked
// kernel: one thread an octet of a row, element loads, a grid-stride loop.
// Both round at the same points, so they give the same bits.
//
// What bounds it: bytes.  y and the residual are read once and out written
// once, 2 or 3 times M*C elements against a handful of operations each:
// the step's largest shape, [128,112,112,64] bf16 with relu, moves 411 MB,
// 0.123 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* y;
  const float* mean;
  const float* rstd;
  const float* scale;
  const float* shift;
  const void* res;
  void* out;
  long long M;
  int C;
  int res_dtype;  // 0 f32, 1 bf16; unused for a null pointer
  int act;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// 8 consecutive f32 values, from two 16-byte loads
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// A residual value rounded to T first, as residual.astype(out_dtype)
template <typename T>
__device__ __forceinline__ float res_value(const Params& p, long long i) {
  const float r = p.res_dtype == 0
                      ? static_cast<const float*>(p.res)[i]
                      : __bfloat162float(
                            static_cast<const __nv_bfloat16*>(p.res)[i]);
  return to_f32(from_f32<T>(r));
}

template <typename T>
__device__ __forceinline__ T bn_value(const Params& p, float y, int c,
                                      bool has_res, float r) {
  float t = __fmul_rn(__fsub_rn(y, p.mean[c]), p.rstd[c]);
  t = __fadd_rn(__fmul_rn(t, p.scale[c]), p.shift[c]);
  T v = from_f32<T>(t);
  if (has_res) v = from_f32<T>(__fadd_rn(to_f32(v), r));
  if (p.act == 1 && to_f32(v) < 0.f) v = from_f32<T>(0.f);
  return v;
}

// The masked kernel: one thread an octet of a row, a grid-stride loop,
// element loads where C is not a multiple of 8 or a view is misaligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_apply_masked_kernel(const Params p) {
  const T* y = static_cast<const T*>(p.y);
  T* out = static_cast<T*>(p.out);
  const int cpr = (p.C + 7) / 8;  // octets a row
  const long long chunks = p.M * cpr;
  const bool has_res = p.res != nullptr;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       q < chunks; q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = q / cpr;
    const int c0 = static_cast<int>(q - row * cpr) * 8;
    const long long base = row * p.C + c0;
    for (int e = 0; e < 8 && c0 + e < p.C; ++e) {
      const long long i = base + e;
      out[i] = bn_value<T>(p, to_f32(y[i]), c0 + e, has_res,
                           has_res ? res_value<T>(p, i) : 0.f);
    }
  }
}

// 8 consecutive values of a T array as raw 16-byte words (two for f32),
// loaded streaming past L1, and their f32 values
template <typename T>
struct Raw8 {
  static constexpr int kWords = sizeof(T) * 8 / 16;
  uint4 w[kWords];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ float at(int e) const;
};
template <>
__device__ __forceinline__ float Raw8<float>::at(int e) const {
  const uint4& u = w[e / 4];
  const uint32_t x[4] = {u.x, u.y, u.z, u.w};
  return __uint_as_float(x[e % 4]);
}
template <>
__device__ __forceinline__ float Raw8<__nv_bfloat16>::at(int e) const {
  const uint32_t x[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
  return __uint_as_float(e % 2 ? x[e / 2] & 0xffff0000u : x[e / 2] << 16);
}

template <typename T>
__device__ __forceinline__ void store8_cs(T* p, const T (&v)[8]);
template <>
__device__ __forceinline__ void store8_cs<float>(float* p,
                                                 const float (&v)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(v[4], v[5], v[6], v[7]));
}
template <>
__device__ __forceinline__ void store8_cs<__nv_bfloat16>(
    __nv_bfloat16* p, const __nv_bfloat16 (&v)[8]) {
  uint4 a;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&a);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = v[e];
  __stcs(reinterpret_cast<uint4*>(p), a);
}

// rows of one pass a thread loads before it computes the first
constexpr int kUnroll = 4;

// The tiled kernel (C a multiple of 8, every pointer 16-byte aligned).
// R: the residual's type (void: none).  span: octets a CTA covers (grid.y
// spans cover the row); 256 / span rows a pass.
template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
    bn_apply_tiled_kernel(const Params p, int span) {
  constexpr bool kRes = !std::is_same<R, void>::value;
  const int cpr = p.C / 8;
  const int rpp = kThreads / span;  // rows a pass
  const int rsub = threadIdx.x / span;
  const int oct = blockIdx.y * span + threadIdx.x % span;
  if (rsub >= rpp || oct >= cpr) return;
  const int c0 = oct * 8;
  float mean[8], rstd[8], scale[8], shift[8];
  load8(p.mean + c0, mean);
  load8(p.rstd + c0, rstd);
  load8(p.scale + c0, scale);
  load8(p.shift + c0, shift);
  const T* y = static_cast<const T*>(p.y) + c0;
  T* out = static_cast<T*>(p.out) + c0;
  const long long stride = static_cast<long long>(gridDim.x) * rpp;
  for (long long row = static_cast<long long>(blockIdx.x) * rpp + rsub;
       row < p.M; row += kUnroll * stride) {
    // the rows' words stay packed until they are used (16 registers for
    // four bf16 rows), so more CTAs fit an SM
    Raw8<T> yv[kUnroll];
    Raw8<typename std::conditional<kRes, R, T>::type> rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * stride;
      if (r < p.M) {
        yv[u].load(y + r * p.C);
        if constexpr (kRes)
          rv[u].load(static_cast<const R*>(p.res) + c0 + r * p.C);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * stride;
      if (r < p.M) {
        T ov[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float t = __fmul_rn(__fsub_rn(yv[u].at(e), mean[e]), rstd[e]);
          t = __fadd_rn(__fmul_rn(t, scale[e]), shift[e]);
          T v = from_f32<T>(t);
          if constexpr (kRes)
            v = from_f32<T>(
                __fadd_rn(to_f32(v), to_f32(from_f32<T>(rv[u].at(e)))));
          if (p.act == 1 && to_f32(v) < 0.f) v = from_f32<T>(0.f);
          ov[e] = v;
        }
        store8_cs<T>(out + r * p.C, ov);
      }
    }
  }
}

// CTAs of `kernel` the current device keeps resident: the SM count times
// the CTAs an SM holds, asked once a device
template <typename K>
int resident_ctas(K kernel) {
  constexpr int kDevices = 64;
  static int cached[kDevices];  // 0: not asked yet
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kDevices && cached[dev] > 0) return cached[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) !=
          cudaSuccess)
    return 0;
  if (dev < kDevices) cached[dev] = sms * per_sm;
  return sms * per_sm;
}

template <typename T, typename R>
cudaError_t launch_tiled(const Params& p, cudaStream_t s) {
  const int cpr = p.C / 8;
  const int span = cpr < kThreads ? cpr : kThreads;
  const int spans = (cpr + span - 1) / span;
  const long long passes = (p.M + kThreads / span - 1) / (kThreads / span);
  const int resident = resident_ctas(bn_apply_tiled_kernel<T, R>);
  if (resident <= 0) return cudaErrorInvalidValue;
  long long gx = resident / spans;
  if (gx < 1) gx = 1;
  if (gx > passes) gx = passes;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(spans));
  bn_apply_tiled_kernel<T, R><<<grid, kThreads, 0, s>>>(p, span);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, bool tiled, cudaStream_t s) {
  if (tiled) {
    if (p.res == nullptr) return launch_tiled<T, void>(p, s);
    if (p.res_dtype == 0) return launch_tiled<T, float>(p, s);
    return launch_tiled<T, __nv_bfloat16>(p, s);
  }
  const long long chunks = p.M * ((p.C + 7) / 8);
  const long long want = (chunks + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  bn_apply_masked_kernel<T><<<blocks, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// y, out [M, C]; mean, rstd, scale, shift [C] f32; res [M, C] or null.
// dtype: 0 = float32, 1 = bfloat16 (y and out); res_dtype the same codes,
// ignored for a null residual.  act: 0 none, 1 relu.  Returns a
// cudaError_t.
int pt_bn_apply(const void* y, const void* mean, const void* rstd,
                const void* scale, const void* shift, const void* res,
                void* out, int M, int C, int dtype, int res_dtype, int act,
                void* stream) {
  if (M < 0 || C <= 0 || act < 0 || act > 1 || dtype < 0 || dtype > 1 ||
      (res && (res_dtype < 0 || res_dtype > 1)))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const Params p{y,
                 static_cast<const float*>(mean),
                 static_cast<const float*>(rstd),
                 static_cast<const float*>(scale),
                 static_cast<const float*>(shift),
                 res,
                 out,
                 M,
                 C,
                 res_dtype,
                 act};
  const bool tiled = C % 8 == 0 && aligned16(y) && aligned16(out) &&
                     (res == nullptr || aligned16(res)) && aligned16(mean) &&
                     aligned16(rstd) && aligned16(scale) && aligned16(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, tiled, s);
  return launch<__nv_bfloat16>(p, tiled, s);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
