// The int8 ops' per-tensor activation quantisation for Hopper (sm_90a),
// plain C interface.
//
// Replaces the quantisation that XLA fuses into the s8 dot's operand in
// paddle_tpu/ops/quant.py: conv2d_int8's jnp.clip(jnp.round(xf / sx *
// bnd), -bnd, bnd).astype(int8) (:325) and mul_int8's (:460).  Contract:
//   x: n elements of f32 or bf16 (dtype 0 or 1), read in storage order;
//   sx: one f32 on the device (the op's clamped InScale, or max|x|), read
//   by the kernel, so the host never waits for it;
//   out: n int8, out[i] = int8(clamp(rint(__fmul_rn(__fdiv_rn(f32(x[i]),
//   sx), bnd)), -bnd, bnd)), NaN passed to the cast as torch.clamp passes
//   it.  Each step is rounded to nearest on its own (a true division, then
//   a product; no FMA contraction) and rint is round-half-even, as
//   torch.round and jnp.round: the output is bit-equal to the plain
//   PyTorch version (paddle_tpu_torch/ops/quant.py quantize_act_plain).
//
// Design: one pass, each thread 16 elements: four 16-byte loads of f32 (or
// two of bf16) and one 16-byte store of the 16 int8 results, where x and
// out start on 16 bytes; the n % 16 elements past the last whole group are
// taken one a thread by the threads after the groups' in the same launch.
// A view that does not start on 16 bytes runs the same arithmetic one
// element a thread.
// What bounds it: bytes.  Every element is read once (4 or 2 bytes) and
// written once (1 byte); at ResNet-50's int8 ops, batch 128, the f32
// inputs hold 1.365 G elements a batch, 6.8 GB of traffic, 2.04 ms at
// 3.35 TB/s (H100 SXM, 700 W).  Wide loads and stores with no second pass
// are all the kernel can do about it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // elements a thread on the vector path

__device__ __forceinline__ int8_t quantize(float v, float s, float bnd) {
  float q = rintf(__fmul_rn(__fdiv_rn(v, s), bnd));
  if (!isnan(q)) q = fminf(fmaxf(q, -bnd), bnd);
  return static_cast<int8_t>(q);
}

__device__ __forceinline__ float load_elem(const void* x, int dtype,
                                           long long i) {
  return dtype == 0
             ? static_cast<const float*>(x)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// The 16 elements of group i as f32.
__device__ __forceinline__ void load_group(const void* x, int dtype,
                                           long long i, float (&v)[16]) {
  if (dtype == 0) {
    const float4* p = static_cast<const float4*>(x) + 4 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 f = p[c];
      v[4 * c] = f.x, v[4 * c + 1] = f.y, v[4 * c + 2] = f.z;
      v[4 * c + 3] = f.w;
    }
  } else {
    const uint4* p = static_cast<const uint4*>(x) + 2 * i;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint4 u = p[c];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[8 * c + 2 * k] = __uint_as_float(w[k] << 16);
        v[8 * c + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
}

// Threads [0, groups) take a group of 16 each (groups 0 on the scalar
// path); thread groups + j takes element 16 * groups + j.
__global__ void __launch_bounds__(kThreads)
    quantize_act_kernel(const void* x, int8_t* out, const float* sx,
                        float bnd, int dtype, long long groups,
                        long long n) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float s = *sx;
  if (t < groups) {
    float v[16];
    load_group(x, dtype, t, v);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t b = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b |= static_cast<uint32_t>(static_cast<uint8_t>(
                 quantize(v[4 * k + e], s, bnd)))
             << (8 * e);
      w[k] = b;
    }
    reinterpret_cast<uint4*>(out)[t] = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  const long long i = kGroup * groups + (t - groups);
  if (i < n) out[i] = quantize(load_elem(x, dtype, i), s, bnd);
}

}  // namespace

extern "C" {

// x: n elements, dtype 0 = float32, 1 = bfloat16; out: n int8; sx: one
// f32 on the device.  Returns a cudaError_t.
int pt_quantize_act(const void* x, void* out, const float* sx, long long n,
                    int dtype, float bnd, void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1) || sx == nullptr)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long groups = vec ? n / kGroup : 0;
  const long long threads = groups + (n - kGroup * groups);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_act_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int8_t*>(out), sx, bnd, dtype, groups, n);
  return cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
