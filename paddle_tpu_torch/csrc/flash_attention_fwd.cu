// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas_kernels.py::_fwd_kernel (wrapper
// _flash_fwd_pallas, pallas_call at :328).  Contract, read from the Pallas
// kernel:
//   q [B,H,Tq,D], k/v [B,H,Tk,D] in f32 or bf16 (any strides over B, H
//   and T; unit stride over D).  out [B,H,Tq,D] in q's dtype (contiguous),
//   lse [B*H,Tq] f32 with lse = m + log(l).
//   Causal masking is bottom-right aligned (query row i sees keys
//   k <= i + Tk - Tq).  Masked scores are -1e30 and their probabilities an
//   explicit 0, so a fully masked row has l == 0, which is clamped to 1:
//   its output is 0 and its lse -1e30.  With bf16 inputs P is rounded to
//   bf16 before the P.V product, as the Pallas kernel casts p to v's dtype,
//   while l sums the unrounded f32 p.
//
// bf16 design: tensor cores, FlashAttention-2's shape.  One CTA of 8 warps
// owns one (b*h, 128-row q tile); each warp owns 16 query rows.  The q
// tiles are launched longest first (the last q tile of a causal sweep has
// the most K/V tiles).
//   - Q, K and V tiles arrive by cp.async, 16 bytes a thread, zero-filled
//     past Tq and Tk, into shared memory laid out in 16-byte chunks,
//     XOR-swizzled by row (Tile, in tensor_core.cuh), so every ldmatrix
//     is free of bank conflicts.  K/V tiles of 64 keys are
//     double-buffered: the copy of tile j+1 runs while tile j computes,
//     one __syncthreads a tile.
//   - Each warp takes its Q fragments by ldmatrix once and keeps them in
//     registers for the whole K/V sweep.  S = Q K^T and P.V are
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), K and V fragments by
//     ldmatrix (ldmatrix.trans for V).
//   - The online softmax runs on the S accumulator in registers (each row
//     spread over a quad of 4 lanes, max and sum reduced by two shuffles),
//     in log2 units so each p is one FFMA and one ex2.  m, l and the f32 O
//     accumulator stay in registers.
//   - P's f32 C fragment, rounded to bf16 pairs, is register for register
//     the A fragment of P.V: P never touches shared memory.
//   - Tiles wholly inside the causal band and before Tk skip the mask (as
//     _fwd_kernel's interior blocks do); tiles above the CTA's diagonal are
//     never loaded, and a warp skips the math of a tile its rows cannot
//     see.
//   - The epilogue divides by the clamped l, stages O through the warp's
//     own rows of the Q tile's shared memory and stores it in 16-byte
//     coalesced chunks; one lane of each quad writes lse.
// f32 design: CUDA cores in full f32 (no TF32, so the serving path's
// logits agree with the CPU).  One CTA of 256 threads owns one (b*h,
// 64-row q tile); four threads share a query row.  The CTA stages each
// 64-key K/V tile in shared memory and keeps the online softmax state in
// registers; rows of Q and K are padded by one word so the 8 rows a warp
// reads at once fall in 8 different banks.
//
// What bounds it (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s
// f32 outside the tensor cores; q, k, v, out and lse each moved once, two
// Tq x Tk x D products, halved when causal):
//   [32,8,512,64] bf16 causal, the AMP training step: 67.6 MB, 0.0202 ms,
//     bytes (8.6 GFLOP take 0.0087 ms);
//   [1,8,32768,64] bf16 causal, long context: 1.10 TFLOP, 1.11 ms,
//     operations ([1,8,32768,128]: 2.20 TFLOP, 2.22 ms);
//   [8,8,512,64] f32 causal, serving: 2.15 GFLOP on the CUDA cores,
//     0.032 ms, operations.
// The bf16 design reads each K/V tile once per 128 query rows and keeps
// every product on the tensor cores, so both bf16 shapes are bound by its
// arithmetic rate, not by bytes.  mma.sync issues from the warp's own
// instruction slots, and the online softmax (~200 instructions a lane per
// 64-key tile: max, exp2, sums, rescale, packing) runs between a warp's
// products instead of under them; only the other warps of the SM hide it.
// wgmma fed by TMA from a producer warp, with two warpgroups in ping-pong
// so one's softmax runs under the other's products, is the next step;
// PERF.md has the times.  The f32 design spends about one shared-memory
// read per fused multiply-add, so shared-memory bandwidth holds it several
// times above its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int H, Tq, Tk;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt;
  int causal;
  float scale;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                          kBlockK * D + kBlockQ * (kBlockK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Params p) {
  constexpr int DP = D + 1;                     // padded Q/K row stride
  constexpr int PP = kBlockK + 1;               // padded P row stride
  constexpr int NC = D / kThreadsPerRow;        // output columns a thread owns
  constexpr int NS = kBlockK / kThreadsPerRow;  // scores a thread owns
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * DP;
  float* v_s = k_s + kBlockK * DP;
  float* p_s = v_s + kBlockK * D;

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int sub = tid % kThreadsPerRow;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  const int qpos = q0 + row + q_off;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int qr = q0 + r;
    q_s[r * DP + c] = qr < p.Tq ? q[qr * p.sqt + c] : 0.f;
  }

  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // keys past the last row of this q tile are masked for every row
  const int kv_end = p.causal ? min(p.Tk, q_off + q0 + kBlockQ) : p.Tk;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int kr = k0 + r;
      const bool ok = kr < p.Tk;
      k_s[r * DP + c] = ok ? k[kr * p.skt + c] : 0.f;
      v_s[r * D + c] = ok ? v[kr * p.svt + c] : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) s[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[row * DP + d];
#pragma unroll
      for (int t = 0; t < NS; ++t)
        s[t] += qd * k_s[(sub + kThreadsPerRow * t) * DP + d];
    }
    float tile_max = kNegInf;
    unsigned valid_bits = 0;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const int kpos = k0 + sub + kThreadsPerRow * t;
      const bool valid = kpos < p.Tk && (!p.causal || qpos >= kpos);
      valid_bits |= (valid ? 1u : 0u) << t;
      s[t] = valid ? s[t] * p.scale : kNegInf;
      tile_max = fmaxf(tile_max, s[t]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_next = fmaxf(m, tile_max);
    const float alpha = expf(m - m_next);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const float pv = (valid_bits >> t) & 1u ? expf(s[t] - m_next) : 0.f;
      psum += pv;
      p_s[row * PP + sub + kThreadsPerRow * t] = pv;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_next;
    // the four threads of a row are lanes of one warp
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = p_s[row * PP + j];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        acc[i] += pj * v_s[j * D + sub + kThreadsPerRow * i];
    }
  }

  const int qr = q0 + row;
  if (qr < p.Tq) {
    const float lc = l == 0.f ? 1.f : l;
    float* o = static_cast<float*>(p.out) +
               (static_cast<long long>(bh) * p.Tq + qr) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) o[sub + kThreadsPerRow * i] = acc[i] / lc;
    if (sub == 0)
      p.lse[static_cast<long long>(bh) * p.Tq + qr] = m + logf(lc);
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// The bf16 tile shape: 8 warps a CTA, each owning 16 query rows (a 128-row
// q tile), and 64-key K/V tiles, the fastest of the shapes timed at the
// AMP training shape (PERF.md).
constexpr int kTcWarps = 8;
constexpr int kTcBlockQ = 16 * kTcWarps;
constexpr int kTcBlockK = 64;
constexpr int kTcThreads = 32 * kTcWarps;

template <int D>
constexpr size_t bf16_smem_bytes() {
  // the Q tile, then two stages of (K tile, V tile)
  return sizeof(__nv_bfloat16) * Tile<D>::kStride *
         (kTcBlockQ + 4 * kTcBlockK);
}

// One tile's online-softmax step on a warp's S accumulator: s[j][e] holds
// row g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2 of the warp's 16 rows
// (g = lane / 4, t = lane % 4; qpos0 is the causal position of row 0).
// Masks S where kMasked, updates the running max m (log2 units: scaled by
// scale * log2 e) and this thread's share of the running sum l, leaves p =
// 2^(s * scale_log2 - m) in s and returns each row's rescale factor in
// alpha.
template <bool kMasked>
__device__ __forceinline__ void online_softmax(
    float (&s)[kTcBlockK / 8][4], float (&m)[2], float (&l)[2],
    float (&alpha)[2], const Params& p, float scale_log2, int k0,
    int qpos0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kTcBlockK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const int qpos = qpos0 + g + 8 * (e >> 1);
        if (kpos >= p.Tk || (p.causal && qpos < kpos)) s[j][e] = kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_next = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = fast_exp2(m[r] - m_next);
    m[r] = m_next;
    neg_m[r] = -m_next;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kTcBlockK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked entry is an explicit 0: in a row that has seen no key
      // yet m is as small as the mask value, and 2^0 would be 1
      const float pv = kMasked && s[j][e] == kNegInf
                           ? 0.f
                           : fast_exp2(fmaf(s[j][e], scale_log2,
                                            neg_m[e >> 1]));
      s[j][e] = pv;
      rs[e >> 1] += pv;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_bf16_kernel(Params p) {
  using L = Tile<D>;
  using bf16 = __nv_bfloat16;
  constexpr int kBQ = kTcBlockQ, kBK = kTcBlockK;
  constexpr int kTileElems = kBK * L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + kBQ * L::kStride;  // [stage][K tile, V tile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int b = bh / p.H;
  const int h = bh % p.H;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.skb + h * p.skh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.svb + h * p.svh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  // keys past the last row of this q tile are masked for every row
  const int kv_end = p.causal ? min(p.Tk, q_off + q0 + kBQ) : p.Tk;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int wr0 = 16 * warp;    // the warp's first row in the tile
  const int wq0 = q0 + wr0;     // its first query row
  const int wpos = q_off + wq0; // and that row's causal position
  const float scale_log2 = p.scale * kLog2e;

  uint32_t qf[D / 16][4];  // the A fragments of the warp's Q rows
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    load_tile<L, kBQ, kTcThreads>(q_s, q, p.sqt, q0, p.Tq);
    load_tile<L, kBK, kTcThreads>(kv_s, k, p.skt, 0, p.Tk);
    load_tile<L, kBK, kTcThreads>(kv_s + kTileElems, v, p.svt, 0, p.Tk);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    // tile `it` has landed, and every warp is done with tile it - 1,
    // whose buffers the copy of tile it + 1 now reuses
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      bf16* next = kv_s + ((it + 1) & 1) * 2 * kTileElems;
      const int k1 = (it + 1) * kBK;
      load_tile<L, kBK, kTcThreads>(next, k, p.skt, k1, p.Tk);
      load_tile<L, kBK, kTcThreads>(next + kTileElems, v, p.svt, k1, p.Tk);
      cp_async_commit();
    }
    if (it == 0) {
      // the Q tile landed with the first K/V tile
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], q_s + L::at(wr0 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8,
                                        2 * kk + (lane >> 4)));
    }
    const int k0 = it * kBK;
    // no row of this warp exists or sees any key of the tile
    if (wq0 >= p.Tq || (p.causal && k0 > wpos + 15)) continue;
    const bf16* k_s = kv_s + (it & 1) * 2 * kTileElems;
    const bf16* v_s = k_s + kTileElems;

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kBK / 8; j += 2) {
        // matrices: keys 8j..8j+7 at d 16kk.. and 16kk+8.., then keys
        // 8j+8..8j+15 at the same two d halves
        uint32_t kb[4];
        ldmatrix_x4(kb, k_s + L::at(8 * j + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
        const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
        mma_bf16(s[j], qf[kk], b0);
        mma_bf16(s[j + 1], qf[kk], b1);
      }

    const bool interior =
        k0 + kBK <= p.Tk && (!p.causal || k0 + kBK - 1 <= wpos);
    float alpha[2];
    if (interior)
      online_softmax<false>(s, m, l, alpha, p, scale_log2, k0, wpos);
    else
      online_softmax<true>(s, m, l, alpha, p, scale_log2, k0, wpos);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // the C fragments of key blocks 2kk and 2kk+1 are the A fragment
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        // matrices: keys 16kk..16kk+7 and 16kk+8..16kk+15 at d block n,
        // then the same at d block n+1; transposed into B fragments
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_s + L::at(16 * kk + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                          n + (lane >> 4)));
        const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        mma_bf16(o[n], pa[kk], b0);
        mma_bf16(o[n + 1], pa[kk], b1);
      }
  }

  // the warp's rows of the Q tile are its own: stage O there
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float lc[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          q_s + L::at(wr0 + g + 8 * r, n) + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] / lc[r], o[n][2 * r + 1] / lc[r]);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = wq0 + g + 8 * r;
      // a fully masked row has l = 0: lse = -1e30 + log(1), as the Pallas
      // kernel's m and clamped l give
      if (qr < p.Tq)
        p.lse[static_cast<long long>(bh) * p.Tq + qr] =
            l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l[r]);
    }
  }
  __syncwarp();
  bf16* out =
      static_cast<bf16*>(p.out) + static_cast<long long>(bh) * p.Tq * D;
#pragma unroll
  for (int i = lane; i < 16 * L::kChunks; i += 32) {
    const int r = i / L::kChunks, c = i % L::kChunks;
    if (wq0 + r < p.Tq)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(wq0 + r) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(q_s + L::at(wr0 + r, c));
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Tq + kTcBlockQ - 1) / kTcBlockQ);
  flash_fwd_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int bh, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, bh, stream);
  if (dtype == 1) return launch_bf16<D>(p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bf16 rows (base pointers and the B,
// H and T strides) must be 16-byte aligned.  Returns a cudaError_t.
int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* out, float* lse, int B, int H, int Tq,
                           int Tk, int D, long long sqb, long long sqh,
                           long long sqt, long long skb, long long skh,
                           long long skt, long long svb, long long svh,
                           long long svt, int dtype, int causal, float scale,
                           void* stream) {
  Params p{q,   k,   v,   out, lse, H,   Tq,  Tk,     sqb,   sqh,
           sqt, skb, skh, skt, svb, svh, svt, causal, scale};
  const int bh = B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, bh, dtype, s);
    case 32: return launch<32>(p, bh, dtype, s);
    case 48: return launch<48>(p, bh, dtype, s);
    case 64: return launch<64>(p, bh, dtype, s);
    case 80: return launch<80>(p, bh, dtype, s);
    case 96: return launch<96>(p, bh, dtype, s);
    case 112: return launch<112>(p, bh, dtype, s);
    case 128: return launch<128>(p, bh, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
