// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas_kernels.py::_bwd_dq_kernel and
// _bwd_dkv_kernel (wrapper _flash_bwd_pallas).  Contract, read from the
// Pallas kernels and _bwd_p_ds_block:
//   q [B,H,Tq,D], k/v [B,H,Tk,D], dO [B,H,Tq,D] in f32 or bf16 (any
//   16-byte aligned strides over B, H and T; unit stride over D; D a
//   multiple of 16, which the wrapper pads to).  lse [B*H,Tq] f32 from
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
// atomics: each output element is summed by one CTA in a fixed order.
//
// bf16: tensor cores, FlashAttention-2's shape on mma.sync.m16n8k16 (bf16
// in, f32 accumulate), with the forward kernel's building blocks
// (tensor_core.cuh).  Tiles arrive by cp.async into XOR-swizzled shared
// memory (Tile), zero-filled past Tq and Tk, and are read by ldmatrix;
// every product's result stays in registers, and a C fragment rounded to
// bf16 pairs is register for register the A fragment of the next product.
//   dq:  one CTA of 8 warps per (b*h, 128-row q tile), each warp 16 rows;
//        q tiles launched longest first.  The Q and dO tiles stay in shared
//        memory (their A fragments in registers at D <= 64), lse (in log2
//        units) and delta of the warp's rows in registers.  64-key K/V
//        tiles are double-buffered.  Per tile: S = Q K^T and dP = dO V^T,
//        P = 2^(S scale log2e - lse log2e), dS = P (dP - delta) scale
//        rounded to bf16, dQ += dS K (K's B fragments by ldmatrix.trans).
//        The epilogue stages dQ through the warp's rows of the Q tile for
//        16-byte stores.
//   dkv: one CTA of 8 warps per (b*h, 128-key tile), each warp 16 keys; the
//        low key tiles, which see the most q tiles, launched first.  The K
//        and V tiles stay in shared memory (their A fragments in registers
//        at D <= 64); 64-row Q/dO tiles, with their lse and delta, are
//        double-buffered.  Per tile, transposed so a warp's rows are keys:
//        S^T = K Q^T and dP^T = V dO^T, P^T and dS^T with lse and delta
//        indexed by the C fragment's columns, dV += P^T dO and dK += dS^T
//        Q (dO's and Q's B fragments by ldmatrix.trans).  P stays f32 in
//        dV, as the Pallas kernel keeps it: P = hi + lo with hi = bf16(P)
//        and lo = bf16(P - hi) (about 16 bits of P), two products into one
//        accumulator that share dO's B fragments: dkv issues five
//        products a tile on the ldmatrix loads of four.  At D > 64 a warp
//        scores 32 q rows at a time instead of 64.
//   Tiles wholly above the causal diagonal are never loaded; a warp skips
//   the math of a tile none of its rows (keys) can see; tiles inside the
//   band and the bounds skip the mask, as _bwd_interior's blocks do.  A
//   fully masked row (lse -1e30) never has an unmasked entry, so its P is 0.
//   Registers: at D 128 the dk and dv accumulators alone take 128 a lane,
//   so the A fragments of Q/dO (dq) and K/V (dkv) are read from shared
//   memory again each tile where D > 64 rather than held.
// f32: tensor cores at f32 accuracy, as split TF32 (tensor_core.cuh): each
// operand x as hi = tf32(x) and lo = tf32(x - hi), rounded to nearest
// (ties away, as cvt.rna rounds, in integer operations), each product
// three mma.sync.m16n8k8 TF32 products, lo.hi + hi.lo + hi.hi (about 21
// bits of each operand, PyTorch's memory-efficient attention's
// OpMultiplyAddFastF32; single-pass TF32 keeps about 11).  Each k step's
// three products go to a fresh accumulator, added to S, dP, dQ, dK or dV
// by FADD, rounding to nearest: the tensor cores truncate as they
// accumulate, and with every tile's products chained into one
// accumulator dq, dk and dv read a mean signed error of -2e-7 to -1.3e-6
// against an f64 reference (a bias toward zero; the plain f32 version
// -2e-10 to -7e-10) and max errors 8-25x the plain version's (PERF.md).  The
// same shape as bf16: 8 warps x 16 rows, tiles by 16-byte cp.async into
// f32 tiles whose rows are padded by 4 words (TileF32), double-buffered,
// zero-filled past Tq and Tk; the same order, skips and epilogue.
//   dq:  Q/dO A fragments by ldmatrix (an 8 x 4 f32 block is an 8 x 8 b16
//        matrix) from shared memory each tile; S = Q K^T and dP = dO V^T
//        (K's and V's B fragments by ldmatrix too), P and dS = P
//        (dP - delta) scale in f32 from the f32 accumulators, then dQ += dS
//        K with dS's C fragments as A fragments: k permuted alike on both
//        sides (tensor_core.cuh), K's B fragments by scalar loads, rows 2t
//        and 2t + 1 at column g, which hit 32 banks.
//   dkv: transposed as in bf16: S^T = K Q^T and dP^T = V dO^T over 32 q
//        rows at a time, then dV += P^T dO and dK += dS^T Q with dO's and
//        Q's B fragments by scalar loads.  P stays f32 (split, not rounded).
//   Shared memory: two 128-row tiles and two stages of two sweep tiles,
//   64 rows up to D 96 (204,800 bytes at D 96), 32 at D 112 and 128.
//   Registers: one CTA an SM (its shared memory allows no second), so the
//   launch bounds name 1 CTA an SM: ptxas then takes the registers it
//   wants (about 200), and the kernels ran 5-10 % faster than under
//   256 threads alone (about 170).  The CTA's own A fragments (Q/dO,
//   K/V) are read from shared memory again each tile and split again at
//   every D: holding them in registers at D <= 64, as bf16 does, ran
//   slower.
//
// Wide design (D > 128, both dtypes): the wide tile of flash_wide.cuh on
// the CUDA cores.  dq: 16 q rows a CTA against 32-key tiles, a lane a key
// for S, dP and dS (rounded to bf16 with bf16 inputs), each thread two dQ
// columns of the 16 rows.  dkv: 16 keys a CTA against 32-row q tiles,
// transposed (a lane a q row), each thread two dK and two dV columns of
// the 16 keys; P stays f32 in dV.  Above D 256, S and dP are summed over
// D in 256-column slices and each CTA writes one 256-column slice of its
// outputs, recomputing S and dP like the other slices' CTAs.  The f32 results are
// sums of f32 FMAs, each rounded to nearest.
// What bounds it (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16, 494.7
// TFLOP/s dense TF32, 67 TFLOP/s f32 outside the tensor cores; inputs read
// and outputs written once; dq does three Tq x Tk x D products, dkv four,
// or five in bf16 with P split in two; halved when causal; three TF32
// products each in f32):
//   [32,8,512,64] bf16 causal, the AMP training step: dq 0.0254 ms and
//     dkv 0.0304 ms, bytes (the products take 0.013 and 0.022 ms);
//   [1,8,32768,64] bf16 causal, long context: dq 1.67 ms and dkv 2.78 ms,
//     operations ([1,8,32768,128]: 3.34 and 5.56 ms);
//   [8,8,512,64] f32 causal, the f32 training step: dq 0.0195 ms and dkv
//     0.0260 ms, operations as split TF32 (bytes 0.0126 and 0.0151; on
//     the CUDA cores the same work would take 0.048 and 0.064 ms).
// The kernels read each K/V (Q/dO) tile once per 128 rows (keys) and keep
// every product on the tensor cores; like the forward, the elementwise
// work between a warp's products (exp2, masks, dS, packing, and in f32
// the splits, four instructions an element of every fragment) is hidden
// only by the other warps of the SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wide.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// 8 warps a CTA, each owning 16 rows of the CTA's tile (q rows in dq,
// keys in dkv), against 64-row tiles of the other side.
constexpr int kTcWarps = 8;
constexpr int kTcRows = 16 * kTcWarps;  // the CTA's own tile
constexpr int kTcSweep = 64;            // the tiles it walks over
constexpr int kTcThreads = 32 * kTcWarps;

// Both kernels hold two kTcRows-row tiles (Q and dO, or K and V) and two
// stages of two kTcSweep-row tiles (K and V, or Q and dO); dkv adds two
// stages of kTcSweep lse and delta values.
template <int D>
constexpr size_t tc_smem_bytes(bool stats) {
  return sizeof(bf16) * Tile<D>::kStride * (2 * kTcRows + 4 * kTcSweep) +
         (stats ? sizeof(float) * 4 * kTcSweep : 0);
}

// The A fragment of rows [r0, r0 + 16) at d columns [16 kk, 16 kk + 16) of
// a tile of layout L.
template <class L>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + L::at(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              2 * kk + (lane >> 4)));
}

// c[j] += A . B^T for the 16-row A fragments a[kk] (kk < D / 16) and the
// rows [r0, r0 + 8 kN) of a tile of layout L as B: c[j] holds the 16 x 8
// block of B rows r0 + 8 j.  With kHold false the A fragments are read
// from a_tile's rows [a_r0, a_r0 + 16) instead of a.
template <class L, int D, int kN, bool kHold>
__device__ __forceinline__ void mma_abt(float (&c)[kN][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* a_tile, int a_r0,
                                        const bf16* b_tile, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    if constexpr (kHold) {
#pragma unroll
      for (int e = 0; e < 4; ++e) af[e] = a[kk][e];
    } else {
      a_frag<L>(af, a_tile, a_r0, kk);
    }
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      // matrices: B rows r0+8j..+7 at d 16kk.. and 16kk+8.., then rows
      // r0+8j+8..+15 at the same two d halves
      uint32_t bf[4];
      ldmatrix_x4(bf, b_tile + L::at(r0 + 8 * j + (lane & 7) +
                                         ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
      mma_bf16(c[j], af, b0);
      mma_bf16(c[j + 1], af, b1);
    }
  }
}

// acc += A_i . B for each of the kNA sets of 16-row A fragments a[i][kk]
// (kk < kK, over B rows r0 + 16 kk..) and B = rows [r0, r0 + 16 kK) of a
// tile of layout L, transposed into B fragments by ldmatrix.trans once
// for all kNA products: acc[n] holds d columns 8n..8n+7.
template <class L, int D, int kK, int kNA>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[kNA][kK][4],
                                       const bf16* b_tile, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      // matrices: rows r0+16kk..+7 and +8..+15 at d block n, then the same
      // at d block n+1
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b_tile + L::at(r0 + 16 * kk + (lane & 7) +
                                               ((lane >> 3) & 1) * 8,
                                           n + (lane >> 4)));
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
#pragma unroll
      for (int i = 0; i < kNA; ++i) {
        mma_bf16(acc[n], a[i][kk], b0);
        mma_bf16(acc[n + 1], a[i][kk], b1);
      }
    }
}

// The C fragments c[2kk] and c[2kk+1] (16 x 8 each) rounded to bf16 pairs
// are the A fragment kk of a 16 x 16 block.
template <int kN>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[kN / 2][4],
                                       const float (&c)[kN][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Rounds the 16 x D accumulator to bf16 into the warp's rows [r0, r0 + 16)
// of a tile of layout L, then stores those rows whose index row0 + r is
// below n_rows to dst (row-major, row stride D) in 16-byte chunks.
template <class L, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* tile, int r0, bf16* dst,
                                           int row0, int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp's last ldmatrix reads of these rows are done
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(tile + L::at(r0 + g + 8 * r, n) +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * L::kChunks; i += 32) {
    const int r = i / L::kChunks, c = i % L::kChunks;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(row0 + r) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(tile + L::at(r0 + r, c));
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_bf16_kernel(Params p) {
  using L = Tile<D>;
  constexpr int kBQ = kTcRows, kBK = kTcSweep;
  constexpr bool kHold = D <= 64;  // Q/dO A fragments kept in registers
  constexpr int kTileElems = kBK * L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBQ * L::kStride;
  bf16* kv_s = do_s + kBQ * L::kStride;  // [stage][K tile, V tile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int b = bh / p.H;
  const int h = bh % p.H;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.skb + h * p.skh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.svb + h * p.svh;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.sob + h * p.soh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  // keys past the last row of this q tile are masked for every row
  const int kv_end = p.causal ? min(p.Tk, q_off + q0 + kBQ) : p.Tk;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int wr0 = 16 * warp;     // the warp's first row in the tile
  const int wq0 = q0 + wr0;      // its first query row
  const int wpos = q_off + wq0;  // and that row's causal position
  const float scale_log2 = p.scale * kLog2e;

  // lse (log2 units) and delta of rows g and g + 8; padded rows have
  // zero Q and dO, so their P is finite and their dS 0
  float neg_lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = wq0 + g + 8 * r;
    const long long stat = static_cast<long long>(bh) * p.Tq + qr;
    neg_lse[r] = qr < p.Tq ? -p.lse[stat] * kLog2e : 0.f;
    delta[r] = qr < p.Tq ? p.delta[stat] : 0.f;
  }

  uint32_t qf[D / 16][4], df[D / 16][4];  // with kHold
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (n_tiles > 0) {
    load_tile<L, kBQ, kTcThreads>(q_s, q, p.sqt, q0, p.Tq);
    load_tile<L, kBQ, kTcThreads>(do_s, dout, p.sot, q0, p.Tq);
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
    if (kHold && it == 0) {
      // the Q and dO tiles landed with the first K/V tile
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        a_frag<L>(qf[kk], q_s, wr0, kk);
        a_frag<L>(df[kk], do_s, wr0, kk);
      }
    }
    const int k0 = it * kBK;
    // no row of this warp exists or sees any key of the tile
    if (wq0 >= p.Tq || (p.causal && k0 > wpos + 15)) continue;
    const bf16* k_s = kv_s + (it & 1) * 2 * kTileElems;
    const bf16* v_s = k_s + kTileElems;

    // s[j][e], dp[j][e]: row g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<L, D, kBK / 8, kHold>(s, qf, q_s, wr0, k_s, 0);
    mma_abt<L, D, kBK / 8, kHold>(dp, df, do_s, wr0, v_s, 0);

    const bool interior =
        k0 + kBK <= p.Tk && (!p.causal || k0 + kBK - 1 <= wpos);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool valid =
            interior ||
            (kpos < p.Tk && (!p.causal || wpos + g + 8 * r >= kpos));
        const float pv =
            valid ? fast_exp2(fmaf(s[j][e], scale_log2, neg_lse[r])) : 0.f;
        s[j][e] = pv * (dp[j][e] - delta[r]) * p.scale;  // dS
      }
    uint32_t dsa[1][kBK / 16][4];  // dS rounded to bf16, as A fragments
    c_to_a<kBK / 8>(dsa[0], s);
    mma_ab<L, D, kBK / 16, 1>(acc, dsa, k_s, 0);
  }

  store_rows<L, D>(acc, q_s, wr0,
                   static_cast<bf16*>(p.dq) +
                       static_cast<long long>(bh) * p.Tq * D,
                   wq0, p.Tq);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_bf16_kernel(Params p) {
  using L = Tile<D>;
  constexpr int kBK = kTcRows, kBQ = kTcSweep;
  constexpr bool kHold = D <= 64;      // K/V A fragments kept in registers
  constexpr int kSub = kHold ? 64 : 32;  // q rows a warp scores at once
  constexpr int kTileElems = kBQ * L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBK * L::kStride;
  bf16* qo_s = v_s + kBK * L::kStride;  // [stage][Q tile, dO tile]
  // [stage][-lse log2e, delta] of the stage's kBQ rows
  float* stat_s = reinterpret_cast<float*>(qo_s + 4 * kTileElems);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;  // low key tiles, the longest, first
  const int b = bh / p.H;
  const int h = bh % p.H;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.skb + h * p.skh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.svb + h * p.svh;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.sob + h * p.soh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Tq;
  const float* dlt = p.delta + static_cast<long long>(bh) * p.Tq;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  // q rows before k0 - q_off see none of this tile's keys
  const int q_begin = p.causal ? (max(0, k0 - q_off) / kBQ) * kBQ : 0;
  const int n_tiles = q_begin < p.Tq ? (p.Tq - q_begin + kBQ - 1) / kBQ : 0;
  const int wr0 = 16 * warp;  // the warp's first key in the tile
  const int wk0 = k0 + wr0;   // and in the sequence
  const float scale_log2 = p.scale * kLog2e;

  // The stage's statistics by plain loads (rows of lse are not 16-byte
  // aligned); padded rows are masked
  auto load_stats = [&](int stage, int q0) {
    if (threadIdx.x < 2 * kBQ) {
      const int i = threadIdx.x % kBQ, qi = q0 + i;
      const bool is_lse = threadIdx.x < kBQ;
      stat_s[stage * 2 * kBQ + threadIdx.x] =
          qi >= p.Tq ? 0.f : is_lse ? -lse[qi] * kLog2e : dlt[qi];
    }
  };

  uint32_t kf[D / 16][4], vf[D / 16][4];  // with kHold
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (n_tiles > 0) {
    load_tile<L, kBK, kTcThreads>(k_s, k, p.skt, k0, p.Tk);
    load_tile<L, kBK, kTcThreads>(v_s, v, p.svt, k0, p.Tk);
    load_tile<L, kBQ, kTcThreads>(qo_s, q, p.sqt, q_begin, p.Tq);
    load_tile<L, kBQ, kTcThreads>(qo_s + kTileElems, dout, p.sot, q_begin,
                                  p.Tq);
    cp_async_commit();
    load_stats(0, q_begin);
  }
  for (int it = 0; it < n_tiles; ++it) {
    // tile `it` has landed (its statistics too), and every warp is done
    // with tile it - 1, whose buffers the copy of tile it + 1 now reuses
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int stage = (it + 1) & 1, q1 = q_begin + (it + 1) * kBQ;
      bf16* next = qo_s + stage * 2 * kTileElems;
      load_tile<L, kBQ, kTcThreads>(next, q, p.sqt, q1, p.Tq);
      load_tile<L, kBQ, kTcThreads>(next + kTileElems, dout, p.sot, q1,
                                    p.Tq);
      cp_async_commit();
      load_stats(stage, q1);
    }
    if (kHold && it == 0) {
      // the K and V tiles landed with the first Q/dO tile
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        a_frag<L>(kf[kk], k_s, wr0, kk);
        a_frag<L>(vf[kk], v_s, wr0, kk);
      }
    }
    if (wk0 >= p.Tk) continue;  // the warp has no key
    const int q0 = q_begin + it * kBQ;
    const bf16* q_s = qo_s + (it & 1) * 2 * kTileElems;
    const bf16* do_s = q_s + kTileElems;
    const float* neg_lse_s = stat_s + (it & 1) * 2 * kBQ;
    const float* delta_s = neg_lse_s + kBQ;

#pragma unroll
    for (int sub = 0; sub < kBQ; sub += kSub) {
      const int qs0 = q0 + sub;  // the first q row scored
      // no row exists, or none sees the warp's first key
      if (qs0 >= p.Tq || (p.causal && qs0 + kSub - 1 + q_off < wk0)) continue;
      // st[j][e], dpt[j][e]: key wk0 + g + 8 (e / 2), q row
      // qs0 + 8 j + 2 t + e % 2
      float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_abt<L, D, kSub / 8, kHold>(st, kf, k_s, wr0, q_s, sub);
      mma_abt<L, D, kSub / 8, kHold>(dpt, vf, v_s, wr0, do_s, sub);

      const bool interior = qs0 + kSub <= p.Tq && wk0 + 16 <= p.Tk &&
                            (!p.causal || qs0 + q_off >= wk0 + 15);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
        const int col = sub + 8 * j + 2 * t;  // row of the Q tile
        const float2 nl = *reinterpret_cast<const float2*>(neg_lse_s + col);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = wk0 + g + 8 * (e >> 1), qi = q0 + col + (e & 1);
          const bool valid =
              interior || (key < p.Tk && qi < p.Tq &&
                           (!p.causal || qi + q_off >= key));
          const float pv =
              valid ? fast_exp2(fmaf(st[j][e], scale_log2,
                                     e & 1 ? nl.y : nl.x))
                    : 0.f;
          st[j][e] = pv;
          dpt[j][e] = pv * (dpt[j][e] - (e & 1 ? dl.y : dl.x)) * p.scale;
        }
      }
      // dS^T rounded to bf16, and P^T = hi + lo, each rounded to bf16, as
      // A fragments
      uint32_t dsa[1][kSub / 16][4], p2[2][kSub / 16][4];
      c_to_a<kSub / 8>(dsa[0], dpt);
      c_to_a<kSub / 8>(p2[0], st);
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float (&c)[4] = st[2 * kk + (i >> 1)];
          const int e = 2 * (i & 1);
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&p2[0][kk][i]));
          p2[1][kk][i] = pack_bf16(c[e] - hi.x, c[e + 1] - hi.y);
        }
      mma_ab<L, D, kSub / 16, 2>(dv, p2, do_s, sub);  // hi and lo
      mma_ab<L, D, kSub / 16, 1>(dk, dsa, q_s, sub);
    }
  }

  const long long out0 = static_cast<long long>(bh) * p.Tk * D;
  store_rows<L, D>(dk, k_s, wr0, static_cast<bf16*>(p.dk) + out0, wk0,
                   p.Tk);
  store_rows<L, D>(dv, v_s, wr0, static_cast<bf16*>(p.dv) + out0, wk0,
                   p.Tk);
}

// ---------------------------------------------------------------------------
// f32: tensor cores, split TF32
// ---------------------------------------------------------------------------

constexpr size_t kMaxSmem = 232448;  // a CTA's dynamic shared memory

// The rows of the tiles the f32 kernels walk over: 64, or 32 where two
// stages of 64-row tiles would not fit beside the CTA's own two 128-row
// tiles (D 112 and 128).
template <int D>
__host__ __device__ constexpr int f32_sweep() {
  return sizeof(float) * (TileF32<D>::kStride * (2 * kTcRows + 4 * 64) +
                          4 * 64) <= kMaxSmem
             ? 64
             : 32;
}

// As tc_smem_bytes, in f32 tiles.
template <int D>
constexpr size_t f32_smem_bytes(bool stats) {
  return sizeof(float) * (TileF32<D>::kStride *
                              (2 * kTcRows + 4 * f32_sweep<D>()) +
                          (stats ? 4 * f32_sweep<D>() : 0));
}

// The A fragment (f32 bits, unsplit) of rows [r0, r0 + 16) at columns
// [8 kk, 8 kk + 8) of an f32 tile of layout L, by ldmatrix: blocks rows
// 0-7 and 8-15 at columns 0-3, then the same at columns 4-7.
template <class L>
__device__ __forceinline__ void a_frag_f32(uint32_t (&a)[4],
                                           const float* tile, int r0,
                                           int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + L::at(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              8 * kk + (lane >> 4) * 4));
}

// c[j] += A . B^T at f32 accuracy for A = rows [a_r0, a_r0 + 16) of an f32
// tile of layout L and B = rows [r0, r0 + 8 kN) of another: c[j] holds the
// 16 x 8 block of B rows r0 + 8 j.  Each A fragment is split once for the
// kN blocks, each B fragment once.
template <class L, int D, int kN>
__device__ __forceinline__ void mma_abt_f32(float (&c)[kN][4],
                                            const float* a_tile, int a_r0,
                                            const float* b_tile, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t af[4], a_hi[4], a_lo[4];
    a_frag_f32<L>(af, a_tile, a_r0, kk);
    split_tf32(af, a_hi, a_lo);
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      // blocks: B rows r0+8j..+7 at columns 8kk.. and 8kk+4.., then rows
      // r0+8j+8..+15 at the same two columns: b0, b1 of block j, then of
      // block j + 1
      uint32_t bf[4], b_hi[4], b_lo[4];
      ldmatrix_x4(bf, b_tile + L::at(r0 + 8 * j + (lane & 7) +
                                         ((lane >> 4) << 3),
                                     8 * kk + ((lane >> 3) & 1) * 4));
      split_tf32(bf, b_hi, b_lo);
      // one k step's three products into fresh accumulators, added by
      // FADD: the tensor cores truncate as they accumulate (header)
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_split_tf32(t0, a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
      mma_split_tf32(t1, a_hi, a_lo, b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[j][e] += t0[e];
        c[j + 1][e] += t1[e];
      }
    }
  }
}

// acc += A . B at f32 accuracy, A the 16 x 8 kK C fragments c[j] (16 rows
// against B rows r0 + 8 j..), B rows [r0, r0 + 8 kK) of an f32 tile of
// layout L: acc[n] holds columns 8n..8n+7.  k is permuted alike on both
// sides (tensor_core.cuh): A's (t, t+4) are C's columns (2t, 2t+1) and B's
// rows (t, t+4) are tile rows 2t and 2t+1, read by scalar loads.
template <class L, int D, int kK>
__device__ __forceinline__ void mma_ab_f32(float (&acc)[D / 8][4],
                                           const float (&c)[kK][4],
                                           const float* b_tile, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    const uint32_t af[4] = {__float_as_uint(c[j][0]),
                            __float_as_uint(c[j][2]),
                            __float_as_uint(c[j][1]),
                            __float_as_uint(c[j][3])};
    uint32_t a_hi[4], a_lo[4];
    split_tf32(af, a_hi, a_lo);
    const float* b = b_tile + L::at(r0 + 8 * j + 2 * t, g);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t bf[2] = {__float_as_uint(b[8 * n]),
                              __float_as_uint(b[L::kStride + 8 * n])};
      uint32_t b_hi[2], b_lo[2];
      split_tf32(bf, b_hi, b_lo);
      float t[4] = {0.f, 0.f, 0.f, 0.f};  // a fresh accumulator, as above
      mma_split_tf32(t, a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
    }
  }
}

// Writes the 16 x D accumulator into the warp's rows [r0, r0 + 16) of an
// f32 tile of layout L, then stores those rows whose index row0 + r is
// below n_rows to dst (row-major, row stride D) in 16-byte chunks.
template <class L, int D>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[D / 8][4],
                                               float* tile, int r0,
                                               float* dst, int row0,
                                               int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp's last reads of these rows are done
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(tile + L::at(r0 + g + 8 * r, 8 * n + 2 * t)) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * L::kChunks; i += 32) {
    const int r = i / L::kChunks, c = i % L::kChunks;
    if (row0 + r < n_rows)
      *reinterpret_cast<float4*>(dst + static_cast<long long>(row0 + r) * D +
                                 4 * c) =
          *reinterpret_cast<const float4*>(tile + L::at(r0 + r, 4 * c));
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_f32_kernel(Params p) {
  using L = TileF32<D>;
  constexpr int kBQ = kTcRows, kBK = f32_sweep<D>();
  constexpr int kTileElems = kBK * L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = q_s + kBQ * L::kStride;
  float* kv_s = do_s + kBQ * L::kStride;  // [stage][K tile, V tile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.sob + h * p.soh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  // keys past the last row of this q tile are masked for every row
  const int kv_end = p.causal ? min(p.Tk, q_off + q0 + kBQ) : p.Tk;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int wr0 = 16 * warp;     // the warp's first row in the tile
  const int wq0 = q0 + wr0;      // its first query row
  const int wpos = q_off + wq0;  // and that row's causal position
  const float scale_log2 = p.scale * kLog2e;

  // lse (log2 units) and delta of rows g and g + 8; padded rows have
  // zero Q and dO, so their P is finite and their dS 0
  float neg_lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = wq0 + g + 8 * r;
    const long long stat = static_cast<long long>(bh) * p.Tq + qr;
    neg_lse[r] = qr < p.Tq ? -p.lse[stat] * kLog2e : 0.f;
    delta[r] = qr < p.Tq ? p.delta[stat] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (n_tiles > 0) {
    load_tile_f32<L, kBQ, kTcThreads>(q_s, q, p.sqt, q0, p.Tq);
    load_tile_f32<L, kBQ, kTcThreads>(do_s, dout, p.sot, q0, p.Tq);
    load_tile_f32<L, kBK, kTcThreads>(kv_s, k, p.skt, 0, p.Tk);
    load_tile_f32<L, kBK, kTcThreads>(kv_s + kTileElems, v, p.svt, 0, p.Tk);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    // tile `it` has landed, and every warp is done with tile it - 1,
    // whose buffers the copy of tile it + 1 now reuses
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      float* next = kv_s + ((it + 1) & 1) * 2 * kTileElems;
      const int k1 = (it + 1) * kBK;
      load_tile_f32<L, kBK, kTcThreads>(next, k, p.skt, k1, p.Tk);
      load_tile_f32<L, kBK, kTcThreads>(next + kTileElems, v, p.svt, k1,
                                        p.Tk);
      cp_async_commit();
    }
    const int k0 = it * kBK;
    // no row of this warp exists or sees any key of the tile
    if (wq0 >= p.Tq || (p.causal && k0 > wpos + 15)) continue;
    const float* k_s = kv_s + (it & 1) * 2 * kTileElems;
    const float* v_s = k_s + kTileElems;

    // s[j][e], dp[j][e]: row g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt_f32<L, D, kBK / 8>(s, q_s, wr0, k_s, 0);
    mma_abt_f32<L, D, kBK / 8>(dp, do_s, wr0, v_s, 0);

    const bool interior =
        k0 + kBK <= p.Tk && (!p.causal || k0 + kBK - 1 <= wpos);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool valid =
            interior ||
            (kpos < p.Tk && (!p.causal || wpos + g + 8 * r >= kpos));
        const float pv =
            valid ? fast_exp2(fmaf(s[j][e], scale_log2, neg_lse[r])) : 0.f;
        s[j][e] = pv * (dp[j][e] - delta[r]) * p.scale;  // dS, in f32
      }
    mma_ab_f32<L, D, kBK / 8>(acc, s, k_s, 0);
  }

  store_rows_f32<L, D>(acc, q_s, wr0,
                       static_cast<float*>(p.dq) +
                           static_cast<long long>(bh) * p.Tq * D,
                       wq0, p.Tq);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkv_f32_kernel(Params p) {
  using L = TileF32<D>;
  constexpr int kBK = kTcRows, kBQ = f32_sweep<D>();
  constexpr int kSub = 32;  // q rows a warp scores at once
  constexpr int kTileElems = kBQ * L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + kBK * L::kStride;
  float* qo_s = v_s + kBK * L::kStride;  // [stage][Q tile, dO tile]
  // [stage][-lse log2e, delta] of the stage's kBQ rows
  float* stat_s = qo_s + 4 * kTileElems;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;  // low key tiles, the longest, first
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.sob + h * p.soh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Tq;
  const float* dlt = p.delta + static_cast<long long>(bh) * p.Tq;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  // q rows before k0 - q_off see none of this tile's keys
  const int q_begin = p.causal ? (max(0, k0 - q_off) / kBQ) * kBQ : 0;
  const int n_tiles = q_begin < p.Tq ? (p.Tq - q_begin + kBQ - 1) / kBQ : 0;
  const int wr0 = 16 * warp;  // the warp's first key in the tile
  const int wk0 = k0 + wr0;   // and in the sequence
  const float scale_log2 = p.scale * kLog2e;

  // The stage's statistics by plain loads; padded rows are masked
  auto load_stats = [&](int stage, int q0) {
    if (threadIdx.x < 2 * kBQ) {
      const int i = threadIdx.x % kBQ, qi = q0 + i;
      const bool is_lse = threadIdx.x < kBQ;
      stat_s[stage * 2 * kBQ + threadIdx.x] =
          qi >= p.Tq ? 0.f : is_lse ? -lse[qi] * kLog2e : dlt[qi];
    }
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (n_tiles > 0) {
    load_tile_f32<L, kBK, kTcThreads>(k_s, k, p.skt, k0, p.Tk);
    load_tile_f32<L, kBK, kTcThreads>(v_s, v, p.svt, k0, p.Tk);
    load_tile_f32<L, kBQ, kTcThreads>(qo_s, q, p.sqt, q_begin, p.Tq);
    load_tile_f32<L, kBQ, kTcThreads>(qo_s + kTileElems, dout, p.sot,
                                      q_begin, p.Tq);
    cp_async_commit();
    load_stats(0, q_begin);
  }
  for (int it = 0; it < n_tiles; ++it) {
    // tile `it` has landed (its statistics too), and every warp is done
    // with tile it - 1, whose buffers the copy of tile it + 1 now reuses
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int stage = (it + 1) & 1, q1 = q_begin + (it + 1) * kBQ;
      float* next = qo_s + stage * 2 * kTileElems;
      load_tile_f32<L, kBQ, kTcThreads>(next, q, p.sqt, q1, p.Tq);
      load_tile_f32<L, kBQ, kTcThreads>(next + kTileElems, dout, p.sot, q1,
                                        p.Tq);
      cp_async_commit();
      load_stats(stage, q1);
    }
    if (wk0 >= p.Tk) continue;  // the warp has no key
    const int q0 = q_begin + it * kBQ;
    const float* q_s = qo_s + (it & 1) * 2 * kTileElems;
    const float* do_s = q_s + kTileElems;
    const float* neg_lse_s = stat_s + (it & 1) * 2 * kBQ;
    const float* delta_s = neg_lse_s + kBQ;

#pragma unroll
    for (int sub = 0; sub < kBQ; sub += kSub) {
      const int qs0 = q0 + sub;  // the first q row scored
      // no row exists, or none sees the warp's first key
      if (qs0 >= p.Tq || (p.causal && qs0 + kSub - 1 + q_off < wk0)) continue;
      // st[j][e], dpt[j][e]: key wk0 + g + 8 (e / 2), q row
      // qs0 + 8 j + 2 t + e % 2
      float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_abt_f32<L, D, kSub / 8>(st, k_s, wr0, q_s, sub);
      mma_abt_f32<L, D, kSub / 8>(dpt, v_s, wr0, do_s, sub);

      const bool interior = qs0 + kSub <= p.Tq && wk0 + 16 <= p.Tk &&
                            (!p.causal || qs0 + q_off >= wk0 + 15);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
        const int col = sub + 8 * j + 2 * t;  // row of the Q tile
        const float2 nl = *reinterpret_cast<const float2*>(neg_lse_s + col);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = wk0 + g + 8 * (e >> 1), qi = q0 + col + (e & 1);
          const bool valid =
              interior || (key < p.Tk && qi < p.Tq &&
                           (!p.causal || qi + q_off >= key));
          const float pv =
              valid ? fast_exp2(fmaf(st[j][e], scale_log2,
                                     e & 1 ? nl.y : nl.x))
                    : 0.f;
          st[j][e] = pv;                                       // P^T
          dpt[j][e] = pv * (dpt[j][e] - (e & 1 ? dl.y : dl.x)) * p.scale;
        }
      }
      mma_ab_f32<L, D, kSub / 8>(dv, st, do_s, sub);
      mma_ab_f32<L, D, kSub / 8>(dk, dpt, q_s, sub);
    }
  }

  const long long out0 = static_cast<long long>(bh) * p.Tk * D;
  store_rows_f32<L, D>(dk, k_s, wr0, static_cast<float*>(p.dk) + out0, wk0,
                       p.Tk);
  store_rows_f32<L, D>(dv, v_s, wr0, static_cast<float*>(p.dv) + out0, wk0,
                       p.Tk);
}

template <int D>
cudaError_t launch_dq(const Params& p, int bh, int dtype,
                      cudaStream_t stream) {
  const bool f32 = dtype == 0;
  auto kernel = f32 ? flash_bwd_dq_f32_kernel<D> : flash_bwd_dq_bf16_kernel<D>;
  const size_t smem = f32 ? f32_smem_bytes<D>(false) : tc_smem_bytes<D>(false);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Tq + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int bh, int dtype,
                       cudaStream_t stream) {
  const bool f32 = dtype == 0;
  auto kernel =
      f32 ? flash_bwd_dkv_f32_kernel<D> : flash_bwd_dkv_bf16_kernel<D>;
  const size_t smem = f32 ? f32_smem_bytes<D>(true) : tc_smem_bytes<D>(true);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Tk + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D > 128: the wide tile (flash_wide.cuh), f32 and bf16
// ---------------------------------------------------------------------------

// dq: a CTA owns 16 q rows and sweeps 32-key tiles.  Shared memory, for
// slices of W = min(D, 256) columns: slices of the Q and dO tiles, slices
// of the K and V tiles (rows padded), dS, and above D 256 the K tile's
// columns of the CTA's dQ slice (101,376 bytes at W 256; 134,144 above
// D 256, whatever D).
__host__ __device__ constexpr size_t dq_wide_smem_bytes(int D) {
  return sizeof(float) *
         (2 * kWideRows * (D < kWideSlice ? D : kWideSlice) +
          2 * kWideSweep * ((D < kWideSlice ? D : kWideSlice) + kWidePad) +
          kWideRows * kWideSweep +
          (D > kWideSlice ? kWideSweep * kWideSlice : 0));
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    flash_bwd_dq_wide_kernel(Params p, int D) {
  extern __shared__ __align__(16) float wsm[];
  const int W = min(D, kWideSlice), ldw = W + kWidePad;
  float* q_s = wsm;                            // [16][W]
  float* o_s = q_s + kWideRows * W;            // [16][W] dO
  float* k_s = o_s + kWideRows * W;            // [32][W + 4]
  float* v_s = k_s + kWideSweep * ldw;         // [32][W + 4]
  float* ds_s = v_s + kWideSweep * ldw;        // [16][32]
  float* kc_s = ds_s + kWideRows * kWideSweep; // [32][256] (D > 256)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWideRows;  // longest first
  // the output slice: columns [c0, c0 + wc) of dQ
  const int n_sl = wide_slices(D), c0 = blockIdx.z * kWideSlice;
  const int wc = wide_width(D, blockIdx.z);
  const int b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.sob + h * p.soh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  const int kv_end =
      p.causal ? max(0, min(p.Tk, q_off + q0 + kWideRows)) : p.Tk;

  // one slice: Q and dO stay in shared memory across the K/V tiles, and
  // the K tile is dQ's operand too
  if (n_sl == 1) {
    wide_load_rows(q_s, D, q, p.sqt, q0, kWideRows, p.Tq, D);
    wide_load_rows(o_s, D, dout, p.sot, q0, kWideRows, p.Tq, D);
  }
  const float* kc = n_sl == 1 ? k_s : kc_s;
  const int ldc = n_sl == 1 ? D + kWidePad : wc;
  float lse[kWideOwn], delta[kWideOwn];
#pragma unroll
  for (int i = 0; i < kWideOwn; ++i) {
    const int qr = q0 + warp + kWideWarps * i;
    const long long at = static_cast<long long>(bh) * p.Tq + qr;
    lse[i] = qr < p.Tq ? p.lse[at] : 0.f;
    delta[i] = qr < p.Tq ? p.delta[at] : 0.f;
  }
  float acc[kWideRows][kWideCols];
#pragma unroll
  for (int r = 0; r < kWideRows; ++r)
#pragma unroll
    for (int g = 0; g < kWideCols; ++g) acc[r][g] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kWideSweep) {
    float s[kWideOwn], dp[kWideOwn];
#pragma unroll
    for (int i = 0; i < kWideOwn; ++i) s[i] = dp[i] = 0.f;
    for (int sl = 0; sl < n_sl; ++sl) {
      const int d0 = sl * kWideSlice, wd = wide_width(D, sl);
      __syncthreads();  // every thread is done with the previous tiles
      if (n_sl > 1) {
        wide_load_rows(q_s, wd, q + d0, p.sqt, q0, kWideRows, p.Tq, wd);
        wide_load_rows(o_s, wd, dout + d0, p.sot, q0, kWideRows, p.Tq, wd);
        if (sl == n_sl - 1)
          wide_load_rows(kc_s, wc, k + c0, p.skt, k0, kWideSweep, p.Tk, wc);
      }
      wide_load_rows(k_s, wd + kWidePad, k + d0, p.skt, k0, kWideSweep,
                     p.Tk, wd);
      wide_load_rows(v_s, wd + kWidePad, v + d0, p.svt, k0, kWideSweep,
                     p.Tk, wd);
      __syncthreads();
      wide_dots(s, q_s, warp, k_s + lane * (wd + kWidePad), wd);
      wide_dots(dp, o_s, warp, v_s + lane * (wd + kWidePad), wd);
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kWideOwn; ++i) {
      const int r = warp + kWideWarps * i, qr = q0 + r;
      const bool valid =
          qr < p.Tq && kpos < p.Tk && (!p.causal || qr + q_off >= kpos);
      // a fully masked row (lse -1e30) has no valid entry
      const float pv = valid ? expf(s[i] * p.scale - lse[i]) : 0.f;
      ds_s[r * kWideSweep + lane] =
          wide_round<T>(pv * (dp[i] - delta[i]) * p.scale);
    }
    __syncthreads();
    for (int j = 0; j < kWideSweep; ++j) {
      float kj[kWideCols];
#pragma unroll
      for (int g = 0; g < kWideCols; ++g) {
        const int c = tid + kWideThreads * g;
        kj[g] = c < wc ? kc[j * ldc + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) {
        const float dsj = ds_s[r * kWideSweep + j];
#pragma unroll
        for (int g = 0; g < kWideCols; ++g)
          acc[r][g] = fmaf(dsj, kj[g], acc[r][g]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + static_cast<long long>(bh) * p.Tq * D;
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    if (q0 + r >= p.Tq) break;
#pragma unroll
    for (int g = 0; g < kWideCols; ++g) {
      const int c = tid + kWideThreads * g;
      if (c < wc)
        dq[static_cast<long long>(q0 + r) * D + c0 + c] =
            wide_cast<T>(acc[r][g]);
    }
  }
}

// dkv: a CTA owns 16 keys and sweeps 32-row q tiles, transposed: a lane
// owns a q row of the tile, a warp scores its keys.  Shared memory, for
// slices of W = min(D, 256) columns: slices of the K and V tiles, slices
// of the Q and dO tiles (rows padded), their lse and delta, P^T and dS^T,
// and above D 256 the Q and dO tiles' columns of the CTA's dK/dV slice
// (103,680 bytes at W 256; 169,216 above D 256, whatever D).
__host__ __device__ constexpr size_t dkv_wide_smem_bytes(int D) {
  return sizeof(float) *
         (2 * kWideRows * (D < kWideSlice ? D : kWideSlice) +
          2 * kWideSweep * ((D < kWideSlice ? D : kWideSlice) + kWidePad) +
          2 * kWideSweep + 2 * kWideRows * kWideSweep +
          (D > kWideSlice ? 2 * kWideSweep * kWideSlice : 0));
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    flash_bwd_dkv_wide_kernel(Params p, int D) {
  extern __shared__ __align__(16) float wsm[];
  const int W = min(D, kWideSlice), ldw = W + kWidePad;
  float* k_s = wsm;                             // [16][W]
  float* v_s = k_s + kWideRows * W;             // [16][W]
  float* q_s = v_s + kWideRows * W;             // [32][W + 4]
  float* o_s = q_s + kWideSweep * ldw;          // [32][256 + 4] dO
  float* lse_s = o_s + kWideSweep * ldw;        // [32]
  float* delta_s = lse_s + kWideSweep;          // [32]
  float* p_s = delta_s + kWideSweep;            // [16][32] P^T
  float* ds_s = p_s + kWideRows * kWideSweep;   // [16][32] dS^T
  float* qc_s = ds_s + kWideRows * kWideSweep;  // [32][256] (D > 256)
  float* oc_s = qc_s + kWideSweep * kWideSlice; // [32][256] (D > 256)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kWideRows;  // the CTA's first key
  // the output slice: columns [c0, c0 + wc) of dK and dV
  const int n_sl = wide_slices(D), c0 = blockIdx.z * kWideSlice;
  const int wc = wide_width(D, blockIdx.z);
  const int b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.sob + h * p.soh;
  const int q_off = p.causal ? p.Tk - p.Tq : 0;
  // the first q row that sees the CTA's first key, on a tile boundary
  const int q_begin =
      p.causal ? max(0, k0 - q_off) / kWideSweep * kWideSweep : 0;

  // one slice: K and V stay in shared memory across the q tiles, and the
  // Q and dO tiles are dK's and dV's operands too
  if (n_sl == 1) {
    wide_load_rows(k_s, D, k, p.skt, k0, kWideRows, p.Tk, D);
    wide_load_rows(v_s, D, v, p.svt, k0, kWideRows, p.Tk, D);
  }
  const float* qc = n_sl == 1 ? q_s : qc_s;
  const float* oc = n_sl == 1 ? o_s : oc_s;
  const int ldc = n_sl == 1 ? D + kWidePad : wc;
  float dk[kWideRows][kWideCols], dv[kWideRows][kWideCols];
#pragma unroll
  for (int r = 0; r < kWideRows; ++r)
#pragma unroll
    for (int g = 0; g < kWideCols; ++g) dk[r][g] = dv[r][g] = 0.f;

  for (int r0 = q_begin; r0 < p.Tq; r0 += kWideSweep) {
    float s[kWideOwn], dp[kWideOwn];
#pragma unroll
    for (int i = 0; i < kWideOwn; ++i) s[i] = dp[i] = 0.f;
    for (int sl = 0; sl < n_sl; ++sl) {
      const int d0 = sl * kWideSlice, wd = wide_width(D, sl);
      __syncthreads();  // every thread is done with the previous tiles
      if (n_sl > 1) {
        wide_load_rows(k_s, wd, k + d0, p.skt, k0, kWideRows, p.Tk, wd);
        wide_load_rows(v_s, wd, v + d0, p.svt, k0, kWideRows, p.Tk, wd);
        if (sl == n_sl - 1) {
          wide_load_rows(qc_s, wc, q + c0, p.sqt, r0, kWideSweep, p.Tq, wc);
          wide_load_rows(oc_s, wc, dout + c0, p.sot, r0, kWideSweep, p.Tq,
                         wc);
        }
      }
      wide_load_rows(q_s, wd + kWidePad, q + d0, p.sqt, r0, kWideSweep,
                     p.Tq, wd);
      wide_load_rows(o_s, wd + kWidePad, dout + d0, p.sot, r0, kWideSweep,
                     p.Tq, wd);
      if (sl == 0 && tid < kWideSweep) {
        const int qr = r0 + tid;
        const long long at = static_cast<long long>(bh) * p.Tq + qr;
        lse_s[tid] = qr < p.Tq ? p.lse[at] : 0.f;
        delta_s[tid] = qr < p.Tq ? p.delta[at] : 0.f;
      }
      __syncthreads();
      wide_dots(s, k_s, warp, q_s + lane * (wd + kWidePad), wd);
      wide_dots(dp, v_s, warp, o_s + lane * (wd + kWidePad), wd);
    }
    const int qr = r0 + lane;
#pragma unroll
    for (int i = 0; i < kWideOwn; ++i) {
      const int r = warp + kWideWarps * i, kpos = k0 + r;
      const bool valid =
          qr < p.Tq && kpos < p.Tk && (!p.causal || qr + q_off >= kpos);
      // a fully masked row (lse -1e30) has no valid entry
      const float pv = valid ? expf(s[i] * p.scale - lse_s[lane]) : 0.f;
      p_s[r * kWideSweep + lane] = pv;  // P stays f32 in dV
      ds_s[r * kWideSweep + lane] =
          wide_round<T>(pv * (dp[i] - delta_s[lane]) * p.scale);
    }
    __syncthreads();
    for (int j = 0; j < kWideSweep; ++j) {
      float qj[kWideCols], oj[kWideCols];
#pragma unroll
      for (int g = 0; g < kWideCols; ++g) {
        const int c = tid + kWideThreads * g;
        qj[g] = c < wc ? qc[j * ldc + c] : 0.f;
        oj[g] = c < wc ? oc[j * ldc + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) {
        const float pj = p_s[r * kWideSweep + j];
        const float dsj = ds_s[r * kWideSweep + j];
#pragma unroll
        for (int g = 0; g < kWideCols; ++g) {
          dv[r][g] = fmaf(pj, oj[g], dv[r][g]);
          dk[r][g] = fmaf(dsj, qj[g], dk[r][g]);
        }
      }
    }
  }

  const long long base = static_cast<long long>(bh) * p.Tk * D;
  T* dkp = static_cast<T*>(p.dk) + base;
  T* dvp = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    if (k0 + r >= p.Tk) break;
#pragma unroll
    for (int g = 0; g < kWideCols; ++g) {
      const int c = tid + kWideThreads * g;
      if (c < wc) {
        const long long at = static_cast<long long>(k0 + r) * D + c0 + c;
        dkp[at] = wide_cast<T>(dk[r][g]);
        dvp[at] = wide_cast<T>(dv[r][g]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_wide(const Params& p, int bh, int D, bool dq,
                        cudaStream_t stream) {
  auto kernel = dq ? flash_bwd_dq_wide_kernel<T>
                   : flash_bwd_dkv_wide_kernel<T>;
  const size_t smem = dq ? dq_wide_smem_bytes(D) : dkv_wide_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, ((dq ? p.Tq : p.Tk) + kWideRows - 1) / kWideRows,
                  wide_slices(D));
  kernel<<<grid, kWideThreads, smem, stream>>>(p, D);
  return cudaGetLastError();
}

template <bool kDq>
int run(Params p, int B, int D, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int bh = B * p.H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_CASE(DIM)                                  \
  case DIM:                                           \
    return kDq ? launch_dq<DIM>(p, bh, dtype, s)      \
               : launch_dkv<DIM>(p, bh, dtype, s);
  switch (D) {
    PT_CASE(16)
    PT_CASE(32)
    PT_CASE(48)
    PT_CASE(64)
    PT_CASE(80)
    PT_CASE(96)
    PT_CASE(112)
    PT_CASE(128)
    default:
      break;
  }
#undef PT_CASE
  if (D > 128 && D % 16 == 0) {
    if (dtype == 0) return launch_wide<float>(p, bh, D, kDq, s);
    return launch_wide<__nv_bfloat16>(p, bh, D, kDq, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Rows (base pointers and the B, H
// and T strides) must be 16-byte aligned.  Each returns a cudaError_t.
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
