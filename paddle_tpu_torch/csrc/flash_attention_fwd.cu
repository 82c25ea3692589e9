// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas_kernels.py::_fwd_kernel (wrapper
// _flash_fwd_pallas, pallas_call at :328).  Contract, read from the Pallas
// kernel:
//   q [B,H,Tq,D], k/v [B,H,Tk,D] in f32 or bf16 (any 16-byte aligned
//   strides over B, H and T; unit stride over D; D a multiple of 16, which
//   the wrapper pads to).  out [B,H,Tq,D] in q's dtype (contiguous),
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
// f32 design: tensor cores at f32 accuracy, as split TF32 (tensor_core.cuh,
// as in the f32 backward): each operand x as hi = tf32(x) and lo =
// tf32(x - hi), rounded to nearest (ties away, as cvt.rna rounds, in
// integer operations), each product three mma.sync.m16n8k8 TF32 products,
// lo.hi + hi.lo + hi.hi, into one f32 accumulator (about 21 bits of each
// operand; single-pass TF32 keeps about 11, and the serving path's
// logits are held to 2e-3 of the CPU).  The bf16 design's shape: 8 warps
// x 16 rows, the longest q tiles first, the online softmax in log2 units
// (exp as ex2.approx.ftz), causal tiles skipped and interior ones
// unmasked, the fully-masked-row rule, O staged through the warp's Q rows
// for 16-byte stores.  What differs:
//   - Splits once per CTA.  K and V tiles land by cp.async in raw f32
//     tiles (RawF32, rows padded by 8 words), and after each tile's first
//     barrier the CTA splits them into hi and lo tiles (TileF32, rows
//     padded by 4 words); the next tile's copies then start into the raw
//     tiles and run under this tile's products.  The Q tile is split in
//     place once, into a second (lo) tile, where shared memory allows.
//     No warp splits a B fragment it loads; only P, which lives in
//     registers, is split per tile.
//   - S = Q K^T: A and B fragments by ldmatrix from the split tiles (an
//     8 x 4 f32 block is an 8 x 8 b16 matrix); the three passes run over
//     every key block in turn, so consecutive products are independent.
//   - O += P V: P's C fragment is the A fragment with k permuted alike
//     on both sides (keys 2t, 2t + 1 at k positions t, t + 4).  V is
//     split into V^T tiles whose keys are stored in that permuted order
//     (0 2 4 6 1 3 5 7 in each group of 8), so its B fragments come by
//     ldmatrix too, with no scalar loads; a warp splits 16 keys x 2
//     chunks at a time, so the transposed writes hit 32 banks.
//   - Short chains on the tensor cores.  They truncate as they
//     accumulate, so a long chain of products into one accumulator is
//     biased toward zero: with S over D / 8 k steps and O over every
//     tile's products on them, the output read 2.4e-6 to 3.6e-6 from the
//     plain version at [8,8,512,64] and the f32 step's batch-2 grads
//     (layer-norm biases among them) drifted from the CPU's coherently,
//     past their bounds.  So each k step of S and each key block of P V
//     (three products) goes to a fresh accumulator, which is added to S
//     or O by FADD, rounding to nearest.
//   - Shared memory (232,448 bytes a CTA): the Q tile(s), the raw K/V
//     tiles, the K hi/lo and V^T hi/lo tiles.  Sweep per D (f32_sweep,
//     f32_q_split): 64 keys a tile up to D 80 with Q split (176,128 bytes
//     at D 64, 217,600 at D 80), 32 keys at D 96 and 112 with Q split
//     (182,272 and 211,456), 32 keys at D 128 with Q's A fragments split
//     each tile (173,056; Q's split tiles would need 240,640).  One CTA
//     an SM, hence __launch_bounds__(256, 1).
// Wide design (D > 128, both dtypes): the wide tile of flash_wide.cuh on
// the CUDA cores, 16 query rows a CTA of 4 warps against 32-key tiles, a
// lane a key for S and the online softmax (natural exp), each thread two
// output columns of the 16 rows in the CTA's 256-column slice of O (D >
// 256: S summed over D in 256-column slices, each output slice's CTA
// recomputing it), P rounded to bf16 before P.V with bf16 inputs.  At these head dims the tensor-core tiles' O
// accumulators alone take 128 registers a lane.
// What bounds it (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s
// f32 outside the tensor cores; q, k, v, out and lse each moved once, two
// Tq x Tk x D products, halved when causal):
//   [32,8,512,64] bf16 causal, the AMP training step: 67.6 MB, 0.0202 ms,
//     bytes (8.6 GFLOP take 0.0087 ms);
//   [1,8,32768,64] bf16 causal, long context: 1.10 TFLOP, 1.11 ms,
//     operations ([1,8,32768,128]: 2.20 TFLOP, 2.22 ms);
//   [8,8,512,64] f32 causal, serving and the f32 step: 2.15 GFLOP as
//     three TF32 products each, 0.0130 ms at 494.7 TFLOP/s, operations
//     (bytes 0.0101 ms; on the CUDA cores the same work takes 0.032 ms).
// The bf16 design reads each K/V tile once per 128 query rows and keeps
// every product on the tensor cores, so both bf16 shapes are bound by its
// arithmetic rate, not by bytes.  mma.sync issues from the warp's own
// instruction slots, and the online softmax (~200 instructions a lane per
// 64-key tile: max, exp2, sums, rescale, packing) runs between a warp's
// products instead of under them; only the other warps of the SM hide it.
// wgmma fed by TMA from a producer warp, with two warpgroups in ping-pong
// so one's softmax runs under the other's products, is the next step;
// PERF.md has the times.  The f32 design moves four times bf16's bytes
// through shared memory (hi and lo of f32): every warp reads every K and
// V fragment, 72 KB a warp a 64-key tile against 384 mma.sync, and the
// split phase between a tile's two barriers runs no products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wide.cuh"
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

// One tile's online-softmax step on a warp's S accumulator of kN 8-key
// blocks: s[j][e] holds row g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2 of
// the warp's 16 rows
// (g = lane / 4, t = lane % 4; qpos0 is the causal position of row 0).
// Masks S where kMasked, updates the running max m (log2 units: scaled by
// scale * log2 e) and this thread's share of the running sum l, leaves p =
// 2^(s * scale_log2 - m) in s and returns each row's rescale factor in
// alpha.
template <bool kMasked, int kN>
__device__ __forceinline__ void online_softmax(
    float (&s)[kN][4], float (&m)[2], float (&l)[2],
    float (&alpha)[2], const Params& p, float scale_log2, int k0,
    int qpos0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kN; ++j)
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
  for (int j = 0; j < kN; ++j)
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

// ---------------------------------------------------------------------------
// f32: tensor cores, split TF32
// ---------------------------------------------------------------------------

constexpr size_t kMaxSmem = 232448;  // a CTA's dynamic shared memory

// The tiles cp.async lands K and V in before they are split: rows padded
// by 8 words, so the transposed V split's reads (4 rows of 2 chunks a
// phase) hit 32 banks.
template <int D>
struct RawF32 {
  static constexpr int kChunks = D / 4;  // 16-byte chunks a row
  static constexpr int kStride = D + 8;  // words a row
  __device__ static __forceinline__ int at(int row, int col) {
    return row * kStride + col;
  }
};

// Shared memory of the f32 kernel at head dim D and kSweep keys a tile:
// the Q tile (hi and lo when kQSplit), the raw K and V tiles, K's hi and
// lo tiles and V^T's hi and lo tiles.
template <int D, int kSweep, bool kQSplit>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         ((kQSplit ? 2 : 1) * kTcBlockQ * TileF32<D>::kStride +
          2 * kSweep * RawF32<D>::kStride + 2 * kSweep * TileF32<D>::kStride +
          2 * D * TileF32<kSweep>::kStride);
}

// 64 keys a tile where that fits beside Q's split tiles, else 32; Q is
// split once per CTA where its two tiles fit beside them, else its A
// fragments are split each tile (D 128).
template <int D>
__host__ __device__ constexpr int f32_sweep() {
  return f32_smem_bytes<D, 64, true>() <= kMaxSmem ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr bool f32_q_split() {
  return f32_smem_bytes<D, f32_sweep<D>(), true>() <= kMaxSmem;
}

// hi and lo (tensor_core.cuh's split) of the four f32 values at src.
__device__ __forceinline__ void split4(const float* src, uint4& hi,
                                       uint4& lo) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  uint32_t h[4], l[4];
  split_tf32(xs, h, l);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// The CTA splits rows [0, kRows) of `raw` (layout R) into hi and lo tiles
// of layout L, a 16-byte chunk a thread at a time; raw may be hi itself.
template <class R, class L, int kRows>
__device__ __forceinline__ void split_rows(const float* raw, float* hi,
                                           float* lo) {
  constexpr int kCopies = kRows * L::kChunks;
#pragma unroll
  for (int i = 0; i < (kCopies + kTcThreads - 1) / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    if (kCopies % kTcThreads != 0 && idx >= kCopies) break;
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    uint4 h, l;
    split4(raw + R::at(r, 4 * c), h, l);
    *reinterpret_cast<uint4*>(hi + L::at(r, 4 * c)) = h;
    *reinterpret_cast<uint4*>(lo + L::at(r, 4 * c)) = l;
  }
}

// The CTA splits the raw V tile (kSweep keys x D) into the hi and lo
// tiles of V^T (D rows of kSweep keys, layout TileF32<kSweep>), the keys
// of each group of 8 stored in the order 0 2 4 6 1 3 5 7: position t
// holds key 2t and position t + 4 key 2t + 1, so ldmatrix hands lane
// (g, t) the B fragment whose k rows (t, t + 4) are keys (2t, 2t + 1),
// the k order of a C fragment used as an A fragment (tensor_core.cuh).
// A warp splits 16 keys x 2 chunks at a time, so its raw reads and its
// transposed writes each hit 32 banks.
template <int D, int kSweep>
__device__ __forceinline__ void split_v_t(const float* raw, float* vt_hi,
                                          float* vt_lo) {
  using R = RawF32<D>;
  using LT = TileF32<kSweep>;
  constexpr int kPairs = D / 8;                   // chunk pairs a row
  constexpr int kUnits = kSweep / 16 * kPairs;    // warp-sized pieces
  constexpr int kWarps = kTcThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < (kUnits + kWarps - 1) / kWarps; ++i) {
    const int u = warp + i * kWarps;
    if (kUnits % kWarps != 0 && u >= kUnits) break;
    const int r = (u / kPairs) * 16 + (lane >> 1);
    const int c = (u % kPairs) * 2 + (lane & 1);
    uint4 h, l;
    split4(raw + R::at(r, 4 * c), h, l);
    const int pos = (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
    const uint32_t hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      vt_hi[LT::at(4 * c + e, pos)] = __uint_as_float(hs[e]);
      vt_lo[LT::at(4 * c + e, pos)] = __uint_as_float(ls[e]);
    }
  }
}

// The hi and lo A fragments of the warp's 16 Q rows from r0 at columns
// [8 kk, 8 kk + 8): ldmatrix from Q's split tiles, or from the raw Q tile
// and split here.
template <int D, bool kQSplit>
__device__ __forceinline__ void q_frag_f32(uint32_t (&hi)[4],
                                           uint32_t (&lo)[4],
                                           const float* q_hi,
                                           const float* q_lo, int r0,
                                           int kk) {
  using L = TileF32<D>;
  const int lane = threadIdx.x & 31;
  const int off =
      L::at(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 8 * kk + (lane >> 4) * 4);
  if constexpr (kQSplit) {
    ldmatrix_x4(hi, q_hi + off);
    ldmatrix_x4(lo, q_lo + off);
  } else {
    uint32_t f[4];
    ldmatrix_x4(f, q_hi + off);
    split_tf32(f, hi, lo);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_f32_kernel(Params p) {
  using L = TileF32<D>;
  using R = RawF32<D>;
  constexpr int kBQ = kTcBlockQ, kBK = f32_sweep<D>();
  constexpr bool kQSplit = f32_q_split<D>();
  using LT = TileF32<kBK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_hi = reinterpret_cast<float*>(smem_raw);  // or the raw Q tile
  float* q_lo = q_hi + kBQ * L::kStride;             // with kQSplit
  float* k_raw = q_hi + (kQSplit ? 2 : 1) * kBQ * L::kStride;
  float* v_raw = k_raw + kBK * R::kStride;
  float* k_hi = v_raw + kBK * R::kStride;
  float* k_lo = k_hi + kBK * L::kStride;
  float* vt_hi = k_lo + kBK * L::kStride;
  float* vt_lo = vt_hi + D * LT::kStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  // keys past the last row of this q tile are masked for every row
  const int kv_end = p.causal ? min(p.Tk, q_off + q0 + kBQ) : p.Tk;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int wr0 = 16 * warp;    // the warp's first row in the tile
  const int wq0 = q0 + wr0;     // its first query row
  const int wpos = q_off + wq0; // and that row's causal position
  const float scale_log2 = p.scale * kLog2e;

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    load_tile_f32<L, kBQ, kTcThreads>(q_hi, q, p.sqt, q0, p.Tq);
    load_tile_f32<R, kBK, kTcThreads>(k_raw, k, p.skt, 0, p.Tk);
    load_tile_f32<R, kBK, kTcThreads>(v_raw, v, p.svt, 0, p.Tk);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    // tile `it` has landed, and every warp is done with the split tiles
    // of tile it - 1, which the split of tile it now overwrites
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (kQSplit) {
      if (it == 0) split_rows<L, L, kBQ>(q_hi, q_hi, q_lo);
    }
    split_rows<R, L, kBK>(k_raw, k_hi, k_lo);
    split_v_t<D, kBK>(v_raw, vt_hi, vt_lo);
    // the split tiles are complete, and the raw tiles free for tile it + 1
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int k1 = (it + 1) * kBK;
      load_tile_f32<R, kBK, kTcThreads>(k_raw, k, p.skt, k1, p.Tk);
      load_tile_f32<R, kBK, kTcThreads>(v_raw, v, p.svt, k1, p.Tk);
      cp_async_commit();
    }
    const int k0 = it * kBK;
    // no row of this warp exists or sees any key of the tile
    if (wq0 >= p.Tq || (p.causal && k0 > wpos + 15)) continue;

    // S = Q K^T: per k step the three passes (lo.hi, hi.lo, hi.hi) each
    // run over every key block, so consecutive products are independent.
    // Each k step's products go to a fresh accumulator, added to S by
    // FADD (round to nearest): the tensor cores truncate as they
    // accumulate, and a chain of D / 8 k steps on them biased S and O
    // toward zero (see the header)
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float sk[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sk[j][e] = 0.f;
      uint32_t a_hi[4], a_lo[4];
      q_frag_f32<D, kQSplit>(a_hi, a_lo, q_hi, q_lo, wr0, kk);
      uint32_t b_hi[kBK / 8][2], b_lo[kBK / 8][2];
#pragma unroll
      for (int j = 0; j < kBK / 8; j += 2) {
        // blocks: keys 8j..8j+7 at columns 8kk.. and 8kk+4.., then keys
        // 8j+8..8j+15 at the same columns
        const int off = L::at(8 * j + (lane & 7) + ((lane >> 4) << 3),
                              8 * kk + ((lane >> 3) & 1) * 4);
        uint32_t x[4];
        ldmatrix_x4(x, k_hi + off);
        b_hi[j][0] = x[0], b_hi[j][1] = x[1];
        b_hi[j + 1][0] = x[2], b_hi[j + 1][1] = x[3];
        ldmatrix_x4(x, k_lo + off);
        b_lo[j][0] = x[0], b_lo[j][1] = x[1];
        b_lo[j + 1][0] = x[2], b_lo[j + 1][1] = x[3];
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mma_tf32(sk[j], a_lo, b_hi[j][0], b_hi[j][1]);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mma_tf32(sk[j], a_hi, b_lo[j][0], b_lo[j][1]);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mma_tf32(sk[j], a_hi, b_hi[j][0], b_hi[j][1]);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += sk[j][e];
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
    // O += P V.  Key block j's C fragment is the A fragment of keys
    // (2t, 2t + 1) at k positions (t, t + 4); V^T's B fragments by
    // ldmatrix, kG column blocks at a time.  As for S, each key block's
    // three products go to a fresh accumulator, added to O by FADD.
    constexpr int kG = (D / 8) % 4 == 0 ? 4 : 2;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const uint32_t af[4] = {__float_as_uint(s[j][0]),
                              __float_as_uint(s[j][2]),
                              __float_as_uint(s[j][1]),
                              __float_as_uint(s[j][3])};
      uint32_t a_hi[4], a_lo[4];
      split_tf32(af, a_hi, a_lo);
#pragma unroll
      for (int n0 = 0; n0 < D / 8; n0 += kG) {
        uint32_t b_hi[kG][2], b_lo[kG][2];
#pragma unroll
        for (int n = 0; n < kG; n += 2) {
          // blocks: d 8(n0+n).. at key positions 8j.. and 8j+4.., then
          // d 8(n0+n)+8.. at the same positions
          const int off =
              LT::at(8 * (n0 + n) + (lane & 7) + ((lane >> 4) << 3),
                     8 * j + ((lane >> 3) & 1) * 4);
          uint32_t x[4];
          ldmatrix_x4(x, vt_hi + off);
          b_hi[n][0] = x[0], b_hi[n][1] = x[1];
          b_hi[n + 1][0] = x[2], b_hi[n + 1][1] = x[3];
          ldmatrix_x4(x, vt_lo + off);
          b_lo[n][0] = x[0], b_lo[n][1] = x[1];
          b_lo[n + 1][0] = x[2], b_lo[n + 1][1] = x[3];
        }
        float pv[kG][4];
#pragma unroll
        for (int n = 0; n < kG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int n = 0; n < kG; ++n)
          mma_tf32(pv[n], a_lo, b_hi[n][0], b_hi[n][1]);
#pragma unroll
        for (int n = 0; n < kG; ++n)
          mma_tf32(pv[n], a_hi, b_lo[n][0], b_lo[n][1]);
#pragma unroll
        for (int n = 0; n < kG; ++n)
          mma_tf32(pv[n], a_hi, b_hi[n][0], b_hi[n][1]);
#pragma unroll
        for (int n = 0; n < kG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + n][e] += pv[n][e];
      }
    }
  }

  // the warp's rows of the Q tile are its own: stage O there
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float lc[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  __syncwarp();  // the warp's last reads of its Q rows are done
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(q_hi + L::at(wr0 + g + 8 * r, 8 * n + 2 * t)) =
          make_float2(o[n][2 * r] / lc[r], o[n][2 * r + 1] / lc[r]);
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
  float* out =
      static_cast<float*>(p.out) + static_cast<long long>(bh) * p.Tq * D;
#pragma unroll
  for (int i = lane; i < 16 * L::kChunks; i += 32) {
    const int r = i / L::kChunks, c = i % L::kChunks;
    if (wq0 + r < p.Tq)
      *reinterpret_cast<float4*>(out + static_cast<long long>(wq0 + r) * D +
                                 4 * c) =
          *reinterpret_cast<const float4*>(q_hi + L::at(wr0 + r, 4 * c));
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem =
      f32_smem_bytes<D, f32_sweep<D>(), f32_q_split<D>()>();
  static_assert(smem <= kMaxSmem, "the f32 tiles overflow shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Tq + kTcBlockQ - 1) / kTcBlockQ);
  flash_fwd_f32_kernel<D><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D > 128: the wide tile (flash_wide.cuh), f32 and bf16
// ---------------------------------------------------------------------------

// shared memory, for slices of W = min(D, 256) columns: a slice of the Q
// tile, a slice of the K tile (rows padded), the V tile's columns of the
// CTA's output slice, P and each row's rescale factor and final l (84,608
// bytes at W 256, whatever D)
__host__ __device__ constexpr size_t fwd_wide_smem_bytes(int W) {
  return sizeof(float) *
         (kWideRows * W + kWideSweep * (W + kWidePad) + kWideSweep * W +
          kWideRows * kWideSweep + 2 * kWideRows);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    flash_fwd_wide_kernel(Params p, int D) {
  extern __shared__ __align__(16) float wsm[];
  const int W = min(D, kWideSlice);
  float* q_s = wsm;                            // [16][W]
  float* k_s = q_s + kWideRows * W;            // [32][W + 4]
  float* v_s = k_s + kWideSweep * (W + kWidePad);  // [32][W]
  float* p_s = v_s + kWideSweep * W;           // [16][32]
  float* a_s = p_s + kWideRows * kWideSweep;             // [16]
  float* l_s = a_s + kWideRows;                          // [16]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWideRows;  // longest first
  // the output slice: columns [c0, c0 + wc) of O
  const int n_sl = wide_slices(D), c0 = blockIdx.z * kWideSlice;
  const int wc = wide_width(D, blockIdx.z);
  const int b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  const int kv_end =
      p.causal ? max(0, min(p.Tk, q_off + q0 + kWideRows)) : p.Tk;

  // one slice: Q stays in shared memory across the K/V tiles
  if (n_sl == 1) wide_load_rows(q_s, D, q, p.sqt, q0, kWideRows, p.Tq, D);
  float m[kWideOwn], l[kWideOwn];
#pragma unroll
  for (int i = 0; i < kWideOwn; ++i) m[i] = kNegInf, l[i] = 0.f;
  float acc[kWideRows][kWideCols];
#pragma unroll
  for (int r = 0; r < kWideRows; ++r)
#pragma unroll
    for (int g = 0; g < kWideCols; ++g) acc[r][g] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kWideSweep) {
    float s[kWideOwn];
#pragma unroll
    for (int i = 0; i < kWideOwn; ++i) s[i] = 0.f;
    for (int sl = 0; sl < n_sl; ++sl) {
      const int d0 = sl * kWideSlice, wd = wide_width(D, sl);
      __syncthreads();  // every thread is done with the previous tiles
      if (n_sl > 1)
        wide_load_rows(q_s, wd, q + d0, p.sqt, q0, kWideRows, p.Tq, wd);
      wide_load_rows(k_s, wd + kWidePad, k + d0, p.skt, k0, kWideSweep,
                     p.Tk, wd);
      if (sl == n_sl - 1)
        wide_load_rows(v_s, wc, v + c0, p.svt, k0, kWideSweep, p.Tk, wc);
      __syncthreads();
      wide_dots(s, q_s, warp, k_s + lane * (wd + kWidePad), wd);
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kWideOwn; ++i) {
      const int r = warp + kWideWarps * i, qr = q0 + r;
      const bool valid =
          qr < p.Tq && kpos < p.Tk && (!p.causal || qr + q_off >= kpos);
      const float x = valid ? s[i] * p.scale : kNegInf;
      const float m_next = fmaxf(m[i], wide_warp_max(x));
      const float pv = valid ? expf(x - m_next) : 0.f;
      const float alpha = expf(m[i] - m_next);
      l[i] = l[i] * alpha + wide_warp_sum(pv);
      m[i] = m_next;
      p_s[r * kWideSweep + lane] = wide_round<T>(pv);
      if (lane == 0) a_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      const float alpha = a_s[r];
#pragma unroll
      for (int g = 0; g < kWideCols; ++g) acc[r][g] *= alpha;
    }
    for (int j = 0; j < kWideSweep; ++j) {
      float vj[kWideCols];
#pragma unroll
      for (int g = 0; g < kWideCols; ++g) {
        const int c = tid + kWideThreads * g;
        vj[g] = c < wc ? v_s[j * wc + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) {
        const float pj = p_s[r * kWideSweep + j];
#pragma unroll
        for (int g = 0; g < kWideCols; ++g)
          acc[r][g] = fmaf(pj, vj[g], acc[r][g]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kWideOwn; ++i) {
    const int r = warp + kWideWarps * i, qr = q0 + r;
    if (lane == 0) {
      l_s[r] = l[i];
      // a fully masked row has l = 0: lse = -1e30, as the other tiles give;
      // every slice computes the same lse, the first writes it
      if (qr < p.Tq && blockIdx.z == 0)
        p.lse[static_cast<long long>(bh) * p.Tq + qr] =
            l[i] == 0.f ? kNegInf : m[i] + logf(l[i]);
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + static_cast<long long>(bh) * p.Tq * D;
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    if (q0 + r >= p.Tq) break;
    const float lc = l_s[r] == 0.f ? 1.f : l_s[r];
#pragma unroll
    for (int g = 0; g < kWideCols; ++g) {
      const int c = tid + kWideThreads * g;
      if (c < wc)
        out[static_cast<long long>(q0 + r) * D + c0 + c] =
            wide_cast<T>(acc[r][g] / lc);
    }
  }
}

template <typename T>
cudaError_t launch_wide(const Params& p, int bh, int D,
                        cudaStream_t stream) {
  const size_t smem = fwd_wide_smem_bytes(min(D, kWideSlice));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Tq + kWideRows - 1) / kWideRows, wide_slices(D));
  flash_fwd_wide_kernel<T><<<grid, kWideThreads, smem, stream>>>(p, D);
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

// dtype: 0 = float32, 1 = bfloat16.  Rows (base pointers and the B, H
// and T strides) must be 16-byte aligned in both dtypes.  Returns a
// cudaError_t.
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
    default: break;
  }
  if (D > 128 && D % 16 == 0) {
    if (dtype == 0) return launch_wide<float>(p, bh, D, s);
    if (dtype == 1) return launch_wide<__nv_bfloat16>(p, bh, D, s);
  }
  return cudaErrorInvalidValue;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
