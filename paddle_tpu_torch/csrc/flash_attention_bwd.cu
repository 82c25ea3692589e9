// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas_kernels.py::_bwd_dq_kernel and
// _bwd_dkv_kernel (wrapper _flash_bwd_pallas).  Contract, read from the
// Pallas kernels and _bwd_p_ds_block:
//   q [B,H,Tq,D], k/v [B,H,Tk,D], dO [B,H,Tq,D] in f32 or bf16 (any
//   strides over B, H and T; unit stride over D).  lse [B*H,Tq] f32 from
//   the forward kernel, delta [B*H,Tq] f32 = rowsum(dO*O) - dlse, computed
//   by the caller.  dq [B,H,Tq,D], dk/dv [B,H,Tk,D] contiguous, in the
//   input dtype, accumulated in f32.
//   P = exp(S*scale - lse) with S = Q K^T, set to 0 outside the causal
//   band (bottom-right aligned, q_off = Tk - Tq), past Tk and on padded q
//   rows; a fully masked row (lse = -1e30) has no unmasked entry, so its
//   dq is 0 and it adds nothing to dk/dv.  dS = P*(dO V^T - delta)*scale.
//   dQ = dS K, dK = dS^T Q, dV = P^T dO.  With bf16 inputs dO is taken to
//   f32, dS is rounded to bf16 before the two products with it and P
//   stays f32, exactly as the Pallas kernels round.
//
// Design.  Two deterministic kernels, as Pallas splits them, with no
// atomics.  Both use CTAs of 256 threads in which four threads share one
// row of a 64-row tile, and stage tiles in shared memory as f32 with rows
// padded by one word (the 8 rows a warp reads fall in 8 banks).
//   dq:  one CTA per (b*h, 64-row q tile).  Q and dO stay in shared
//        memory, lse and delta in registers; the CTA walks the K/V tiles,
//        recomputes its rows' S and dO V^T, writes dS to shared memory and
//        accumulates dS K into the D/4 columns each thread owns.
//   dkv: one CTA per (b*h, 64-row k tile).  K and V stay in shared
//        memory; the CTA walks the q tiles, recomputes P and dS for its
//        keys (transposed: a thread's row is a key), and accumulates
//        P^T dO and dS^T Q into register accumulators for dv and dk.
// Tiles wholly above the causal diagonal are skipped in both sweeps.
//
// What bounds it.  At the training shape ([8,8,512,64], causal, f32) dq
// does three Tq x Tk x D products (S, dP, dQ), 3.22 GFLOP after the causal
// halving, and dkv four (S, dP, dV, dK), 4.29 GFLOP: in full f32 on the
// CUDA cores (67 TFLOP/s) they are bound by operations, 0.048 and
// 0.064 ms; the bytes (about 42 and 51 MB) take 0.013 and 0.015 ms.  Like
// the forward kernel, this first version spends about one shared-memory
// read per fused multiply-add, so shared-memory bandwidth holds it several
// times above that bound; register tiling (and wgmma for bf16) is the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, Tq, Tk;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
  int causal;
  float scale;
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

// dS as the products see it: rounded to the input dtype.
template <typename T>
__device__ __forceinline__ float round_to_input(float x) {
  return to_f32(from_f32<T>(x));
}

// Rows [r0, r0 + 64) of a [len, D] slice with row stride st, into shared
// memory as f32 with row stride D + 1; rows past len are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0, int len) {
  for (int e = threadIdx.x; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] = gr < len ? to_f32(src[gr * st + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (4 * kBlockK * (D + 1) + 2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int PP = kBlockK + 1;
  constexpr int NC = D / kThreadsPerRow;        // dq columns a thread owns
  constexpr int NS = kBlockK / kThreadsPerRow;  // keys a thread scores
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBlockQ * DP;
  float* k_s = do_s + kBlockQ * DP;
  float* v_s = k_s + kBlockK * DP;
  float* ds_s = v_s + kBlockK * DP;

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int sub = tid % kThreadsPerRow;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.sob + h * p.soh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  const int qr = q0 + row;
  const int qpos = qr + q_off;
  const bool row_ok = qr < p.Tq;
  const long long stat = static_cast<long long>(bh) * p.Tq + qr;
  const float lse = row_ok ? p.lse[stat] : 0.f;
  const float delta = row_ok ? p.delta[stat] : 0.f;

  load_tile<T, D>(q_s, q, p.sqt, q0, p.Tq);
  load_tile<T, D>(do_s, dout, p.sot, q0, p.Tq);

  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;

  // keys past the last row of this q tile are masked for every row
  const int kv_end = p.causal ? min(p.Tk, q_off + q0 + kBlockQ) : p.Tk;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K and dS reads are done
    load_tile<T, D>(k_s, k, p.skt, k0, p.Tk);
    load_tile<T, D>(v_s, v, p.svt, k0, p.Tk);
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) s[t] = dp[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[row * DP + d];
      const float od = do_s[row * DP + d];
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int kk = (sub + kThreadsPerRow * t) * DP + d;
        s[t] += qd * k_s[kk];
        dp[t] += od * v_s[kk];
      }
    }
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const int kpos = k0 + sub + kThreadsPerRow * t;
      const bool valid =
          row_ok && kpos < p.Tk && (!p.causal || qpos >= kpos);
      const float pv = valid ? expf(s[t] * p.scale - lse) : 0.f;
      ds_s[row * PP + sub + kThreadsPerRow * t] =
          round_to_input<T>(pv * (dp[t] - delta) * p.scale);
    }
    // the four threads of a row are lanes of one warp
    __syncwarp();
    for (int j = 0; j < kBlockK; ++j) {
      const float dsj = ds_s[row * PP + j];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        acc[i] += dsj * k_s[j * DP + sub + kThreadsPerRow * i];
    }
  }

  if (row_ok) {
    T* dq = static_cast<T*>(p.dq) + stat * D;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      dq[sub + kThreadsPerRow * i] = from_f32<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int PP = kBlockQ + 1;
  constexpr int NC = D / kThreadsPerRow;        // dk/dv columns a thread owns
  constexpr int NS = kBlockQ / kThreadsPerRow;  // q rows a thread scores
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBlockK * DP;
  float* q_s = v_s + kBlockK * DP;
  float* do_s = q_s + kBlockQ * DP;
  float* p_s = do_s + kBlockQ * DP;
  float* ds_s = p_s + kBlockK * PP;
  float* lse_s = ds_s + kBlockK * PP;
  float* delta_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;  // a key of this tile
  const int sub = tid % kThreadsPerRow;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.sob + h * p.soh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Tq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Tq;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  const int kr = k0 + row;
  const bool key_ok = kr < p.Tk;

  load_tile<T, D>(k_s, k, p.skt, k0, p.Tk);
  load_tile<T, D>(v_s, v, p.svt, k0, p.Tk);

  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // q rows before k0 - q_off see none of this tile's keys
  const int q_begin =
      p.causal ? (max(0, k0 - q_off) / kBlockQ) * kBlockQ : 0;
  for (int q0 = q_begin; q0 < p.Tq; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's Q, dO, P and dS reads are done
    load_tile<T, D>(q_s, q, p.sqt, q0, p.Tq);
    load_tile<T, D>(do_s, dout, p.sot, q0, p.Tq);
    if (tid < kBlockQ) {
      const bool ok = q0 + tid < p.Tq;
      lse_s[tid] = ok ? lse[q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) s[t] = dp[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[row * DP + d];
      const float vd = v_s[row * DP + d];
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int qq = (sub + kThreadsPerRow * t) * DP + d;
        s[t] += q_s[qq] * kd;
        dp[t] += do_s[qq] * vd;
      }
    }
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const int i = sub + kThreadsPerRow * t;
      const int qi = q0 + i;
      const bool valid =
          key_ok && qi < p.Tq && (!p.causal || qi + q_off >= kr);
      const float pv = valid ? expf(s[t] * p.scale - lse_s[i]) : 0.f;
      p_s[row * PP + i] = pv;
      ds_s[row * PP + i] =
          round_to_input<T>(pv * (dp[t] - delta_s[i]) * p.scale);
    }
    __syncwarp();
    for (int i = 0; i < kBlockQ; ++i) {
      const float pi = p_s[row * PP + i];
      const float dsi = ds_s[row * PP + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = i * DP + sub + kThreadsPerRow * c;
        dv_acc[c] += pi * do_s[col];
        dk_acc[c] += dsi * q_s[col];
      }
    }
  }

  if (key_ok) {
    const long long off = (static_cast<long long>(bh) * p.Tk + kr) * D;
    T* dk = static_cast<T*>(p.dk) + off;
    T* dv = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[sub + kThreadsPerRow * c] = from_f32<T>(dk_acc[c]);
      dv[sub + kThreadsPerRow * c] = from_f32<T>(dv_acc[c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Tq + kBlockQ - 1) / kBlockQ);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Tk + kBlockK - 1) / kBlockK);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t dispatch_d(const Params& p, int bh, int d, cudaStream_t s) {
#define PT_CASE(DIM)                                                  \
  case DIM:                                                           \
    return kDq ? launch_dq<T, DIM>(p, bh, s) : launch_dkv<T, DIM>(p, bh, s);
  switch (d) {
    PT_CASE(16)
    PT_CASE(32)
    PT_CASE(48)
    PT_CASE(64)
    PT_CASE(80)
    PT_CASE(96)
    PT_CASE(112)
    PT_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
}

template <bool kDq>
int run(Params p, int B, int D, int dtype, void* stream) {
  const int bh = B * p.H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<kDq, float>(p, bh, D, s);
  if (dtype == 1) return dispatch_d<kDq, __nv_bfloat16>(p, bh, D, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t.
int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int Tq,
    int Tk, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sob, long long soh,
    long long sot, int dtype, int causal, float scale, void* stream) {
  Params p{q,   k,   v,   dout, lse, delta, dq,  nullptr, nullptr,
           H,   Tq,  Tk,  sqb,  sqh, sqt,   skb, skh,     skt,
           svb, svh, svt, sob,  soh, sot,   causal, scale};
  return run<true>(p, B, D, dtype, stream);
}

int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Tq, int Tk, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sob, long long soh,
    long long sot, int dtype, int causal, float scale, void* stream) {
  Params p{q,   k,   v,   dout, lse, delta, nullptr, dk,  dv,
           H,   Tq,  Tk,  sqb,  sqh, sqt,   skb,     skh, skt,
           svb, svh, svt, sob,  soh, sot,   causal,  scale};
  return run<false>(p, B, D, dtype, stream);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
