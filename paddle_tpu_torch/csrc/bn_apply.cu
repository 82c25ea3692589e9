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
// Design: an elementwise pass.  Each thread takes 8 consecutive channels
// of one row: 16-byte loads of y and the residual (two for f32) and of the
// per-channel vectors when C is a multiple of 8 and the pointers are
// 16-byte aligned, masked element loads otherwise.  A grid-stride loop
// covers M * ceil(C/8) chunks.
//
// What bounds it: bytes.  y and the residual are read once and out written
// once, 2 or 3 times M*C elements against a handful of operations each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// 8 consecutive values of a T array as f32, from 16-byte loads
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float (&v)[8]) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const T (&v)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(
    __nv_bfloat16* p, const __nv_bfloat16 (&v)[8]) {
  uint4 a;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&a);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = v[e];
  reinterpret_cast<uint4*>(p)[0] = a;
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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) bn_apply_kernel(const Params p) {
  const T* y = static_cast<const T*>(p.y);
  T* out = static_cast<T*>(p.out);
  const int cpr = (p.C + 7) / 8;  // chunks a row
  const long long chunks = p.M * cpr;
  const bool has_res = p.res != nullptr;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       q < chunks; q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = q / cpr;
    const int c0 = static_cast<int>(q - row * cpr) * 8;
    const long long base = row * p.C + c0;
    if (kVec) {
      float yv[8], rv[8];
      load8<T>(y + base, yv);
      if (has_res) {
        if (p.res_dtype == 0)
          load8<float>(static_cast<const float*>(p.res) + base, rv);
        else
          load8<__nv_bfloat16>(
              static_cast<const __nv_bfloat16*>(p.res) + base, rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) rv[e] = to_f32(from_f32<T>(rv[e]));
      }
      T ov[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ov[e] = bn_value<T>(p, yv[e], c0 + e, has_res, has_res ? rv[e] : 0.f);
      store8<T>(out + base, ov);
    } else {
      for (int e = 0; e < 8 && c0 + e < p.C; ++e) {
        const long long i = base + e;
        out[i] = bn_value<T>(p, to_f32(y[i]), c0 + e, has_res,
                             has_res ? res_value<T>(p, i) : 0.f);
      }
    }
  }
}

template <typename T>
void launch(const Params& p, bool vec, cudaStream_t s) {
  const long long chunks = p.M * ((p.C + 7) / 8);
  const long long want = (chunks + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  if (vec)
    bn_apply_kernel<T, true><<<blocks, kThreads, 0, s>>>(p);
  else
    bn_apply_kernel<T, false><<<blocks, kThreads, 0, s>>>(p);
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
  const bool vec = C % 8 == 0 && aligned16(y) && aligned16(out) &&
                   (res == nullptr || aligned16(res));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(p, vec, s);
  else
    launch<__nv_bfloat16>(p, vec, s);
  return cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
