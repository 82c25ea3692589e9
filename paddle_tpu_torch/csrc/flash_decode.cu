// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas_kernels.py::_decode_kernel (wrapper
// _flash_decode_pallas).  Contract, read from the Pallas kernel:
//   q [B,R,H,d] (R query rows a sequence; R = 1 is the decode step, R =
//   k+1 the speculative verify sweep; any strides over B, R and H, unit
//   stride over d) in f32 or bf16, or f32 over int8 pages.
//   Pools [P+1,H,ps,d] contiguous, in q's dtype or int8.  block_tables
//   [B,MP] int32 and seq_lens [B] int32, contiguous.  out [B,R,H,d]
//   contiguous, in q's dtype (f32 over int8 pages: the int8 dequant scales
//   are applied by the wrapper, outside the kernel).
//   Row r of sequence b sees keys kpos < min(len, len - R + 1 + r):
//   s = (q.k)*scale in f32, masked to -1e30; m' = max(m, max s);
//   p = exp(s - m') zeroed where masked; l = l*a + sum p;
//   acc = acc*a + p.V with a = exp(m - m') and p rounded to V's dtype
//   first (f32 and bf16; over int8 pages p stays f32).  At the end
//   l == 0 becomes 1 (a zero-length row emits exact zeros) and acc/l is
//   cast once to the output dtype.
//
// Design.  One CTA of 128 threads owns one (sequence, head, query row):
// grid B*H*R, with the R rows of a (sequence, head) on neighbouring
// blocks so that their K/V reads meet in L2.  The CTA reads its own
// block-table row and length and walks the live pages in order, never a
// page at or past the length.  Each page is streamed in chunks of 32 keys:
// the chunk's K and V rows are loaded with 16-byte vector loads (8-byte
// over int8 pages), converted to f32 and staged in shared memory; four
// threads share a key for q.k (strided over d, then two shuffles), the
// chunk max and sum are warp shuffles plus a fixed-order sum over the
// four warps, and thread c owns output column c for p.V.  The online
// softmax merges chunk by chunk (the Pallas kernel merges page by page:
// the same function, summed in another order).
//
// Rows do not interact.  A row's arithmetic depends on its own limit and
// on nothing else of the launch: the chunk boundaries are fixed by the
// page size, every reduction has the same fixed shape whatever the number
// of live keys, and a chunk wholly past the row's limit is an exact no-op
// (a = exp(0) = 1, p = 0).  So verify row r is bit-equal to a q-len-1
// launch at length len - R + 1 + r, which lossless speculative decoding
// needs.
//
// What bounds it.  The work is bytes: each live key's K and V row is read
// once (d*4 bytes each in f32) for 4*d operations.  At the serving shape
// (64 sequences of 64-160 tokens, 8 heads, d 128, page 128, f32) the live
// keys' K and V rows hold about 58 MB, 0.018 ms at 3.35 TB/s (the whole
// live pages 87 MB); chip_smoke.py times the kernel against that bound at
// this shape and at two long ones.  It keeps
// few loads in flight for each CTA and syncs four times a chunk.  A
// single long sequence runs on only B*H = 8 CTAs of the 132 SMs, far
// from its bound, and wants a split over pages with a second merging
// pass, which is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                        // keys a chunk
constexpr int kThreadsPerKey = kThreads / kChunk;  // 4
constexpr int kMaxD = 128;
constexpr int kPad = 4;  // K row padding: the 8 keys of a warp hit 8 banks
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* tables;
  const int* lens;
  void* out;
  int R, H, D, PS, MP;
  long long sqb, sqr, sqh;
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

// p as the p.V product sees it: rounded to V's dtype (f32 over int8)
template <typename KV>
__device__ __forceinline__ float round_p(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_p<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One vector load of kElems consecutive pool elements, as f32.
template <typename KV>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int kElems = 8;
  __device__ static void load(const int8_t* src, float* dst) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = static_cast<float>(b[i]);
  }
};

// Q: q and out type (f32 or bf16); KV: pool type (Q, or int8 with Q f32)
template <typename Q, typename KV>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Params p) {
  __shared__ float q_s[kMaxD];
  __shared__ float k_s[kChunk][kMaxD + kPad];
  __shared__ float v_s[kChunk][kMaxD];
  __shared__ float p_s[kChunk];
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int key = tid / kThreadsPerKey;  // this thread's key of a chunk
  const int sub = tid % kThreadsPerKey;
  const int r = blockIdx.x % p.R;
  const int bh = blockIdx.x / p.R;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int D = p.D;
  const int PS = p.PS;

  const Q* q = static_cast<const Q*>(p.q) + b * p.sqb + r * p.sqr + h * p.sqh;
  for (int c = tid; c < D; c += kThreads) q_s[c] = to_f32(q[c]);

  const int kv_len = p.lens[b];
  const int limit = min(kv_len, kv_len - p.R + 1 + r);
  int n_pages = (kv_len + PS - 1) / PS;
  if (n_pages > p.MP) n_pages = p.MP;
  const int* table = p.tables + static_cast<long long>(b) * p.MP;
  const KV* k_pool = static_cast<const KV*>(p.k_pages);
  const KV* v_pool = static_cast<const KV*>(p.v_pages);
  constexpr int E = Vec<KV>::kElems;

  float m = kNegInf;
  float l = 0.f;
  float acc = 0.f;  // output column tid (tid < D)

  for (int pg = 0; pg < n_pages; ++pg) {
    const long long slab =
        (static_cast<long long>(table[pg]) * p.H + h) * PS * D;
    for (int c0 = 0; c0 < PS; c0 += kChunk) {
      const int start = pg * PS + c0;  // position of the chunk's key 0
      if (start >= kv_len) break;
      const int rows = min(kChunk, PS - c0);
      __syncthreads();  // the previous chunk's reads are done
      const KV* kc = k_pool + slab + static_cast<long long>(c0) * D;
      const KV* vc = v_pool + slab + static_cast<long long>(c0) * D;
      const int n_vec = rows * D / E;
      for (int e = tid; e < n_vec; e += kThreads) {
        const int row = e * E / D, col = e * E % D;
        Vec<KV>::load(kc + e * E, &k_s[row][col]);
        Vec<KV>::load(vc + e * E, &v_s[row][col]);
      }
      // rows past a page's ragged end stay stale: they are masked below
      // and p.V stops at `rows`
      __syncthreads();

      float s = 0.f;
      for (int c = sub; c < D; c += kThreadsPerKey)
        s = fmaf(q_s[c], k_s[key][c], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const bool valid = key < rows && start + key < limit;
      s = valid ? s * p.scale : kNegInf;

      float wmax = s;
#pragma unroll
      for (int off = 4; off < 32; off *= 2)
        wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
      if (lane == 0) red_max[warp] = wmax;
      __syncthreads();
      const float cmax = fmaxf(fmaxf(red_max[0], red_max[1]),
                               fmaxf(red_max[2], red_max[3]));
      const float m_next = fmaxf(m, cmax);
      const float pv = valid ? expf(s - m_next) : 0.f;
      // each key's p sits in its four lanes: sum over the warp's 8 keys
      float wsum = pv;
#pragma unroll
      for (int off = 4; off < 32; off *= 2)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
      if (lane == 0) red_sum[warp] = wsum;
      if (sub == 0) p_s[key] = round_p<KV>(pv);
      __syncthreads();
      const float csum = (red_sum[0] + red_sum[1]) + (red_sum[2] + red_sum[3]);
      const float alpha = expf(m - m_next);
      l = l * alpha + csum;
      m = m_next;
      if (tid < D) {
        float o = 0.f;
        for (int j = 0; j < rows; ++j) o = fmaf(p_s[j], v_s[j][tid], o);
        acc = acc * alpha + o;
      }
    }
  }

  if (tid < D) {
    const float lc = l == 0.f ? 1.f : l;
    Q* out = static_cast<Q*>(p.out) +
             ((static_cast<long long>(b) * p.R + r) * p.H + h) * D;
    out[tid] = from_f32<Q>(acc / lc);
  }
}

template <typename Q, typename KV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * p.H * p.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_decode_kernel<Q, KV><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// kv_dtype: 0 = float32 (q f32), 1 = bfloat16 (q bf16), 2 = int8 pages
// (q f32, out f32).  Returns a cudaError_t.
int pt_flash_decode(const void* q, const void* k_pages, const void* v_pages,
                    const int* tables, const int* lens, void* out, int B,
                    int R, int H, int D, int PS, int MP, long long sqb,
                    long long sqr, long long sqh, int kv_dtype, float scale,
                    void* stream) {
  if (D <= 0 || D > kMaxD || D % 8 != 0 || R <= 0 || PS <= 0 || MP <= 0)
    return cudaErrorInvalidValue;
  Params p{q, k_pages, v_pages, tables, lens, out, R,   H,
           D, PS,      MP,      sqb,    sqr,  sqh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0) return launch<float, float>(p, B, s);
  if (kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(p, B, s);
  if (kv_dtype == 2) return launch<float, int8_t>(p, B, s);
  return cudaErrorInvalidValue;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
