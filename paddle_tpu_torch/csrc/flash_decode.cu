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
// Design.  One CTA of 128 threads owns one (sequence, head, block of up
// to 16 query rows, split): the rows of a verify sweep share every K/V
// read, and a long sequence is cut into splits of kSplitPages pages.
//   - K/V arrive in chunks of KC keys (32; 64 up to d 32, 128 for f32 up
//     to d 16; 16 for f32 pools from d 64 to 256 and at d 257-512; 8 at d
//     513-1024; 4 at d 1025-2048, where two stages of 8 f32 keys would
//     take 256 KB) from one page, or of whole pages where KC is a multiple of a
//     smaller page (two pages of 16), by 16-byte cp.async (cg: past L1)
//     into a ring of two to four stages of shared memory, the next chunks
//     in flight while this one is computed: the deepest ring that keeps
//     the grid to as few waves as two stages do (a long sequence's few
//     CTAs take more stages, a full grid more CTAs an SM).  Shared memory
//     keeps the pool's own type (f32, bf16 or int8); each element is
//     converted to f32 in registers on its way into a product.  K rows are
//     padded so the keys of a quarter warp's 16-byte reads hit 32 banks.
//     Where a pool row is not a whole number of 16-byte chunks (odd d, or
//     int8 d not a multiple of 16) the rows are copied element by element
//     and their last 16-byte chunk zero-filled: the pools' d is the
//     cache's, so only a narrower copy can take it.
//   - q.k: q of the CTA's rows sits in shared memory as f32 (zero past d);
//     128 / KC threads a key each take every (128 / KC)-th 16-byte chunk
//     of the key's row, load it once and fold it into the dot product of
//     every row, then shuffles sum the parts.
//   - The online softmax: a group of min(KC, 32) lanes owns a row (a warp
//     takes 32 / KC rows at once when KC < 32), a lane a key (KC / 32 keys
//     above 32), the chunk's max and sum by xor shuffles within the
//     group, m and l in the group's registers, p (rounded to V's dtype)
//     and the rescale factor through shared memory.
//   - p.V: thread c owns output column c (and c + 128, ... above 128) of
//     every row of the CTA, four keys at a time; up to d 32 (chunks of 64
//     or 128 keys) each warp sums a quarter of the keys for all d columns
//     instead, and warp 0 adds the four sums in a fixed order.
//   - The kernel is compiled for each row count up to 8 and for 16 (up to
//     d 128; fewer counts above), so a step of one row, or a sweep of five,
//     runs no code for rows it lacks.  Where the grid would have
//     fewer CTAs than half the SMs (a few sequences' verify sweeps), a CTA
//     takes fewer rows, so more CTAs share the work.
//   - Splits: a split covers a fixed number of pages (kSplitPages, 16,
//     a constant of the kernel).  A sequence of one split writes its output
//     directly; with more, each split writes (acc, m, l) of each row to a
//     workspace the wrapper allocates, and a second kernel merges them in
//     split order: m' = max(m, m_s), l = l e^(m - m') + l_s e^(m_s - m'),
//     acc alike, from (m, l, acc) = (-1e30, 0, 0).  No atomics, so two
//     launches give the same bits.
//
//   - Above d 2048 (kMaxD) a second kernel takes the head dim in slices
//     (flash_decode_wide_kernel): chunks of 4 keys, one warp a key
//     folding its row into q.k 16-byte chunk by chunk, read straight from
//     the pools (L2) with q's rows, so shared memory holds no row whole;
//     the output columns in slices of 2048 (a thread 16 of each row), one
//     slice a grid index, every slice recomputing q.k and the softmax.  A
//     CTA takes one or two rows.  d <= 2048 never reaches it.
//
// Rows do not interact.  A row's arithmetic depends on its own limit and
// on nothing else of the launch: every product, sum and reduction has a
// fixed order and shape (explicit fmaf, fixed shuffle trees), the chunk
// and split bounds are fixed by the page size and the page index, a
// chunk wholly past the row's limit is an exact no-op (a = exp(0) = 1, p =
// 0), a split wholly past it has (m, l, acc) = (-1e30, 0, 0), an exact
// no-op in the merge (e^(-1e30 - m) = 0), and merging one split into the
// identity gives it back exactly.  So verify row r is
// bit-equal to a q-len-1 launch at length len - R + 1 + r, whichever row
// block, instantiation and number of splits either launch has.
//
// What bounds it.  The work is bytes: each live key's K and V row is read
// once (d*4 bytes each in f32) for 4*d operations per query row, 2.5
// flop/byte at R = 5 in f32, far below the card's 20 (f32 CUDA cores).
// At the serving shape (64 sequences of 64-160 tokens, 8 heads, d 128,
// page 128, f32) the live keys' K and V rows hold about 58 MB, 0.017 ms
// at 3.35 TB/s; one 32768-token sequence 268 MB, 0.080 ms, which the
// split spreads over 128 CTAs.  Two stages of 32 keys hold 70 KB at d 128
// in f32, so three CTAs share an SM, each with a chunk in flight; with
// three stages two CTAs do, each with two chunks in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;  // the ring's stages: 2 to 4, by the grid
constexpr size_t kMaxSmem = 232448;  // a CTA's dynamic shared memory
constexpr int kSplitPages = 16;  // pages a split: a constant of the kernel
// the widest d of flash_decode_kernel: a thread holds 16 output columns
// (128 apart) of each row in registers; above it, flash_decode_wide_kernel
// takes the output in column slices of kMaxD
constexpr int kMaxD = 2048;
constexpr int kWideKC = 4;  // keys a chunk of the wide kernel
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* tables;
  const int* lens;
  void* out;
  float* ws;  // [B,H,R,NS,D+2]: a split's acc, then m and l; null at NS 1
  int R, H, D, PS, MP, NS;
  int rows_cta;  // rows a CTA (the last row block may have fewer)
  int n_rb;      // row blocks
  int nchk;      // 16-byte chunks of a pool row in shared memory
  int ldk, ldv;  // bytes of a K and a V row in shared memory
  int ldq;       // floats of a q row in shared memory (nchk 16-byte chunks)
  int vec;       // pool rows are whole 16-byte chunks: copy by cp.async
  int stages;    // stages of the ring
  int n_cs;      // column slices of kMaxD (the wide kernel; 1 otherwise)
  long long sqb, sqr, sqh;
  float scale;
};

// Rows a CTA at most, by NCG (output columns a thread, 128 apart): the
// acc registers (rows x NCG) stay at 32 or fewer.
template <int NCG>
constexpr int max_rows() {
  return NCG <= 2 ? 16 : 32 / NCG;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
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

// The elements of one 16-byte chunk of a pool row, as f32.
template <typename KV>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ static void cvt(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void cvt(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Chunk<int8_t> {
  static constexpr int kElems = 16;
  __device__ static void cvt(const uint4& u, float (&f)[16]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      f[i] = static_cast<float>(
          static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  }
};

// The raw bits of a pool element, for the element-by-element copy.
template <int kBytes>
struct RawOf;
template <>
struct RawOf<1> {
  using T = uint8_t;
};
template <>
struct RawOf<2> {
  using T = uint16_t;
};
template <>
struct RawOf<4> {
  using T = uint32_t;
};

// The CTA copies `rows` consecutive K and V rows of a pool slab (from kg
// and vg, d elements a row) into the stage buffers ks and vs.
template <typename KV>
__device__ __forceinline__ void issue_chunk(unsigned char* ks,
                                            unsigned char* vs, const KV* kg,
                                            const KV* vg, int rows,
                                            const Params& p) {
  if (p.vec) {
    // chunk i = j * nchk + c of the rows x nchk grid, for i = tid, tid +
    // 128, ...: (j, c) stepped without a division a copy
    const int n = rows * p.nchk;
    const long long row_bytes = static_cast<long long>(p.nchk) * 16;
    const int dj = kThreads / p.nchk, dc = kThreads - dj * p.nchk;
    int j = threadIdx.x / p.nchk, c = threadIdx.x - j * p.nchk;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const long long off = j * row_bytes + c * 16;
      cp_async16(ks + j * p.ldk + c * 16,
                 reinterpret_cast<const unsigned char*>(kg) + off, 16);
      cp_async16(vs + j * p.ldv + c * 16,
                 reinterpret_cast<const unsigned char*>(vg) + off, 16);
      j += dj;
      c += dc;
      if (c >= p.nchk) c -= p.nchk, ++j;
    }
  } else {
    using Raw = typename RawOf<sizeof(KV)>::T;
    const Raw* kr = reinterpret_cast<const Raw*>(kg);
    const Raw* vr = reinterpret_cast<const Raw*>(vg);
    const int w = p.nchk * Chunk<KV>::kElems;  // elements a stored row
    const int n = rows * w;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int j = i / w, e = i - j * w;
      Raw kx = 0, vx = 0;
      if (e < p.D) {
        kx = kr[static_cast<long long>(j) * p.D + e];
        vx = vr[static_cast<long long>(j) * p.D + e];
      }
      reinterpret_cast<Raw*>(ks + j * p.ldk)[e] = kx;
      reinterpret_cast<Raw*>(vs + j * p.ldv)[e] = vx;
    }
  }
}

// Waits until at most n of the committed copy groups are still pending.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// A split's chunks: pages [p0, p1), ppc pages a chunk (where a chunk
// holds several whole pages) or cpp chunks a page of ps keys, kc keys a
// chunk.
struct Chunk1 {
  int pg, c0, pages, rows;  // first page, first key in it, pages, keys
};
struct Split {
  int p0, p1, ppc, cpp, ps, kc;
  __device__ __forceinline__ Chunk1 at(int ci) const {
    Chunk1 c;
    if (ppc > 1) {
      c.pg = p0 + ci * ppc, c.c0 = 0, c.pages = min(ppc, p1 - c.pg);
      c.rows = c.pages * ps;
    } else {
      c.pg = p0 + ci / cpp, c.c0 = (ci % cpp) * kc, c.pages = 1;
      c.rows = min(kc, ps - c.c0);
    }
    return c;
  }
};

// Starts the copy of chunk ci of split sp into its stage and commits it.
template <typename KV>
__device__ __forceinline__ void issue_at(int ci, const Split& sp,
                                         const Params& p, unsigned char* k_s,
                                         unsigned char* v_s, const int* table,
                                         int h, const KV* k_pool,
                                         const KV* v_pool) {
  const Chunk1 c = sp.at(ci);
  const int row0 = (ci % p.stages) * sp.kc;
  for (int k = 0; k < c.pages; ++k) {
    const long long off =
        ((static_cast<long long>(table[c.pg + k]) * p.H + h) * sp.ps + c.c0) *
        p.D;
    issue_chunk<KV>(k_s + (row0 + k * sp.ps) * p.ldk,
                    v_s + (row0 + k * sp.ps) * p.ldv, k_pool + off,
                    v_pool + off, c.pages > 1 ? sp.ps : c.rows, p);
  }
  cp_async_commit();
}

// One exact step of the merge of online-softmax states, (m, l, acc) with
// (ms, ls, as): a state of m = -1e30, l = 0, acc = 0 is a no-op, and
// merging a state into that identity gives it back.
__device__ __forceinline__ void merge_state(float& m, float& l, float& acc,
                                            float ms, float ls, float as) {
  const float mn = fmaxf(m, ms);
  const float a = expf(__fsub_rn(m, mn)), e = expf(__fsub_rn(ms, mn));
  l = __fadd_rn(__fmul_rn(l, a), __fmul_rn(ls, e));
  acc = __fadd_rn(__fmul_rn(acc, a), __fmul_rn(as, e));
  m = mn;
}

// Q: q and out type (f32 or bf16); KV: pool type (Q, or int8 with Q f32);
// ROWS: the rows a CTA is compiled for (at least rows_cta), so a step of
// one row runs no code for the others.  Every
// product and sum is an explicit fmaf, __fadd_rn or __fmul_rn, so a row's
// bits do not depend on ROWS.
template <typename Q, typename KV, int NCG, int ROWS, int KC>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const Params p) {
  constexpr int kTpk = kThreads / KC;  // threads a key in q.k
  constexpr int E = Chunk<KV>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;                             // [stage][KC]
  unsigned char* v_s = k_s + p.stages * KC * p.ldk;      // [stage][KC]
  float* q_s = reinterpret_cast<float*>(v_s + p.stages * KC * p.ldv);
  float* s_s = q_s + p.rows_cta * p.ldq;  // [rows][KC] scores
  float* p_s = s_s + p.rows_cta * KC;     // [rows][KC] p, rounded
  float* a_s = p_s + p.rows_cta * KC;     // [rows] rescale factor
  float* ml_s = a_s + p.rows_cta;         // [rows][2] final m, l
  float* o_s = ml_s + 2 * p.rows_cta;     // [warp][rows][32] (KC >= 64)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int bid = blockIdx.x;
  const int rb = bid % p.n_rb;
  bid /= p.n_rb;
  const int split = bid % p.NS;
  const int bh = bid / p.NS;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D, PS = p.PS;

  const int kv_len = p.lens[b];
  const int n_pages = min((kv_len + PS - 1) / PS, p.MP);
  const int n_splits = max(1, (n_pages + kSplitPages - 1) / kSplitPages);
  if (split >= n_splits) return;
  const int r0 = rb * p.rows_cta;
  const int nrows = min(p.rows_cta, p.R - r0);

  // This split's live chunks, pages [p0, p1): KC keys of a page where a
  // page holds at least KC (cpp chunks a page, the last ones only while
  // they start before len), or ppc whole pages where KC is a multiple of
  // a smaller page.  Either way a chunk's bounds follow the page index.
  const int ppc = PS < KC && KC % PS == 0 ? KC / PS : 1;  // pages a chunk
  const int cpp = ppc > 1 ? 1 : (PS + KC - 1) / KC;     // chunks a page
  const int p0 = split * kSplitPages;
  const int p1 = min(p0 + kSplitPages, n_pages);
  int n_live = 0;
  if (p1 > p0) {
    const int last = min(kv_len - (p1 - 1) * PS, PS);
    n_live = ppc > 1 ? (p1 - p0 + ppc - 1) / ppc
                     : (p1 - p0 - 1) * cpp + min(cpp, (last + KC - 1) / KC);
  }
  const Split sp{p0, p1, ppc, cpp, PS, KC};
  const int* table = p.tables + static_cast<long long>(b) * p.MP;
  const KV* k_pool = static_cast<const KV*>(p.k_pages);
  const KV* v_pool = static_cast<const KV*>(p.v_pages);

  // The softmax: a group of kGrp lanes a row (a warp takes 32 / kGrp rows
  // at once), kKpl keys a lane (keys kl, kl + kGrp, ...); m and l of the
  // rows this lane's group owns, rows (warp * kRpw + grp) + kWarps * kRpw
  // * i.  A group's max and sum by xor shuffles within it equal the whole
  // warp's with the other lanes masked (their -1e30 and 0 change no max or
  // sum).
  constexpr int kGrp = KC < 32 ? KC : 32;  // lanes a row
  constexpr int kKpl = KC / kGrp;          // keys a lane
  constexpr int kRpw = 32 / kGrp;          // rows a warp takes at once
  constexpr int kOwn = (ROWS + kWarps * kRpw - 1) / (kWarps * kRpw);
  const int grp = lane / kGrp, kl = lane % kGrp;  // this lane's group, key
  float m[kOwn], l[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) m[i] = kNegInf, l[i] = 0.f;
  float acc[ROWS][NCG];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int g = 0; g < NCG; ++g) acc[r][g] = 0.f;

  const int key = tid / kTpk, sub = tid % kTpk;
  const int ahead = p.stages - 1;  // chunks in flight beside this one
  for (int ci = 0; ci < ahead && ci < n_live; ++ci)
    issue_at<KV>(ci, sp, p, k_s, v_s, table, h, k_pool, v_pool);

  // q of the CTA's rows, as f32, zero past d (while the first copies fly)
  {
    const Q* qb = static_cast<const Q*>(p.q) + b * p.sqb + h * p.sqh;
    const int n = nrows * p.ldq;
    for (int i = tid; i < n; i += kThreads) {
      const int r = i / p.ldq, c = i - r * p.ldq;
      q_s[i] = c < D ? to_f32(qb[(r0 + r) * p.sqr + c]) : 0.f;
    }
  }

  for (int ci = 0; ci < n_live; ++ci) {
    // chunk ci has landed (the copies of up to `ahead - 1` later chunks
    // may still run), and every thread is done with chunk ci - 1, whose
    // stage the copy of chunk ci + ahead now reuses
    cp_async_wait_n(min(n_live - 1 - ci, ahead - 1));
    __syncthreads();
    if (ci + ahead < n_live)
      issue_at<KV>(ci + ahead, sp, p, k_s, v_s, table, h, k_pool, v_pool);
    const Chunk1 cur = sp.at(ci);
    const int start = cur.pg * PS + cur.c0;  // position of the chunk's key 0
    const int rows = cur.rows;
    const unsigned char* kc = k_s + (ci % p.stages) * KC * p.ldk;
    const unsigned char* vc = v_s + (ci % p.stages) * KC * p.ldv;

    // q.k: this thread's 16-byte chunks of its key, folded into every row
    float dot[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dot[r] = 0.f;
    for (int c = sub; c < p.nchk; c += kTpk) {
      float kf[E];
      Chunk<KV>::cvt(
          *reinterpret_cast<const uint4*>(kc + key * p.ldk + c * 16), kf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          const float* qr = q_s + r * p.ldq + c * E;
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            dot[r] = fmaf(qv.x, kf[e], dot[r]);
            dot[r] = fmaf(qv.y, kf[e + 1], dot[r]);
            dot[r] = fmaf(qv.z, kf[e + 2], dot[r]);
            dot[r] = fmaf(qv.w, kf[e + 3], dot[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
#pragma unroll
        for (int off = 1; off < kTpk; off *= 2)
          dot[r] = __fadd_rn(dot[r],
                             __shfl_xor_sync(0xffffffffu, dot[r], off));
        if (sub == 0) s_s[r * KC + key] = __fmul_rn(dot[r], p.scale);
      }
    }
    __syncthreads();

    // the online softmax of the rows, a group of lanes a row, a lane a key
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int r = warp * kRpw + grp + kWarps * kRpw * i;
      if (warp * kRpw + kWarps * kRpw * i < nrows) {  // the warp's first
        const bool own = r < nrows;
        const int limit = min(kv_len, kv_len - p.R + 1 + r0 + r);
        bool valid[kKpl];
        float s[kKpl];
        float cmax = kNegInf;
#pragma unroll
        for (int t = 0; t < kKpl; ++t) {
          const int kk = kl + kGrp * t;
          valid[t] = own && kk < rows && start + kk < limit;
          s[t] = valid[t] ? s_s[r * KC + kk] : kNegInf;
          cmax = fmaxf(cmax, s[t]);
        }
#pragma unroll
        for (int off = kGrp / 2; off > 0; off /= 2)
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
        const float m_next = fmaxf(m[i], cmax);
        float pv[kKpl], csum = 0.f;
#pragma unroll
        for (int t = 0; t < kKpl; ++t) {
          pv[t] = valid[t] ? expf(__fsub_rn(s[t], m_next)) : 0.f;
          csum = t == 0 ? pv[0] : __fadd_rn(csum, pv[t]);
        }
#pragma unroll
        for (int off = kGrp / 2; off > 0; off /= 2)
          csum = __fadd_rn(csum, __shfl_xor_sync(0xffffffffu, csum, off));
        const float alpha = expf(__fsub_rn(m[i], m_next));
        if (own) {
          l[i] = __fmaf_rn(l[i], alpha, csum);
          m[i] = m_next;
#pragma unroll
          for (int t = 0; t < kKpl; ++t)
            p_s[r * KC + kl + kGrp * t] = round_p<KV>(pv[t]);
          if (kl == 0) a_s[r] = alpha;
        }
      }
    }
    __syncthreads();

    if constexpr (KC >= 64) {
      // p.V up to d 32: warp w sums keys [w KC / 4, (w + 1) KC / 4) of
      // the chunk for column `lane` of every row, in order; warp 0 adds the
      // four warps' sums in a fixed order and keeps the acc
      constexpr int kWk = KC / kWarps;  // a warp's keys
      float o[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) o[r] = 0.f;
      const int j1 = min(kWk * warp + kWk, rows);
      for (int j = kWk * warp; j < j1; ++j) {
        const KV* vrow = reinterpret_cast<const KV*>(vc + j * p.ldv);
        const float vj = lane < D ? to_f32(vrow[lane]) : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nrows) o[r] = fmaf(p_s[r * KC + j], vj, o[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < nrows) o_s[(warp * p.rows_cta + r) * 32 + lane] = o[r];
      __syncthreads();
      if (warp == 0) {
        const int ws = p.rows_cta * 32;  // a warp's sums
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nrows) {
            const float* os = o_s + r * 32 + lane;
            const float sum = __fadd_rn(__fadd_rn(os[0], os[ws]),
                                        __fadd_rn(os[2 * ws], os[3 * ws]));
            acc[r][0] = __fmaf_rn(acc[r][0], a_s[r], sum);
          }
        }
      }
    } else {
      // p.V: this thread's output columns of every row, the keys in order
      // (four at a time, p by 16-byte loads, then the ragged rest)
      float o[ROWS][NCG];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int g = 0; g < NCG; ++g) o[r][g] = 0.f;
      int j = 0;
      for (; j + 4 <= rows; j += 4) {
        float vf[4][NCG];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int g = 0; g < NCG; ++g) {
            const int c = tid + kThreads * g;
            vf[jj][g] =
                c < D ? to_f32(reinterpret_cast<const KV*>(
                                   vc + (j + jj) * p.ldv)[c])
                      : 0.f;
          }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nrows) {
            const float4 pj =
                *reinterpret_cast<const float4*>(p_s + r * KC + j);
#pragma unroll
            for (int g = 0; g < NCG; ++g) {
              o[r][g] = fmaf(pj.x, vf[0][g], o[r][g]);
              o[r][g] = fmaf(pj.y, vf[1][g], o[r][g]);
              o[r][g] = fmaf(pj.z, vf[2][g], o[r][g]);
              o[r][g] = fmaf(pj.w, vf[3][g], o[r][g]);
            }
          }
        }
      }
      for (; j < rows; ++j) {
        float vf[NCG];
#pragma unroll
        for (int g = 0; g < NCG; ++g) {
          const int c = tid + kThreads * g;
          vf[g] = c < D ? to_f32(reinterpret_cast<const KV*>(vc + j * p.ldv)[c])
                        : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nrows) {
            const float pj = p_s[r * KC + j];
#pragma unroll
            for (int g = 0; g < NCG; ++g) o[r][g] = fmaf(pj, vf[g], o[r][g]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          const float alpha = a_s[r];
#pragma unroll
          for (int g = 0; g < NCG; ++g)
            acc[r][g] = __fmaf_rn(acc[r][g], alpha, o[r][g]);
        }
      }
    }
  }

  // the rows' m and l, from the groups that own them
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int r = warp * kRpw + grp + kWarps * kRpw * i;
    if (r < nrows && kl == 0) {
      ml_s[2 * r] = m[i];
      ml_s[2 * r + 1] = l[i];
    }
  }
  __syncthreads();
  if (n_splits == 1) {
    Q* out = static_cast<Q*>(p.out);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
        const float lr = ml_s[2 * r + 1];
        const float lc = lr == 0.f ? 1.f : lr;
        const long long base =
            ((static_cast<long long>(b) * p.R + r0 + r) * p.H + h) * D;
#pragma unroll
        for (int g = 0; g < NCG; ++g) {
          const int c = tid + kThreads * g;
          if (c < D) out[base + c] = from_f32<Q>(acc[r][g] / lc);
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
        float* w = p.ws +
                   ((static_cast<long long>(bh) * p.R + r0 + r) * p.NS +
                    split) *
                       (D + 2);
#pragma unroll
        for (int g = 0; g < NCG; ++g) {
          const int c = tid + kThreads * g;
          if (c < D) w[c] = acc[r][g];
        }
        if (tid == 0) {
          w[D] = ml_s[2 * r];
          w[D + 1] = ml_s[2 * r + 1];
        }
      }
    }
  }
}

// Above d 2048: one CTA a (sequence, head, block of up to ROWS rows, split,
// slice of kMaxD output columns).  Chunks of kWideKC keys on the main
// kernel's page and split bounds; q.k by one warp a key over the key's
// 16-byte chunks (lane c, c + 32, ...), its K chunks and q's elements read
// from global memory (the pools stay in L2 across the CTAs of the slices
// and row blocks), summed by a fixed shuffle tree; the online softmax as
// the main kernel's at 4 keys a chunk; p.V for this slice's columns, a
// thread 16 of each row (128 apart), the keys in order.  Every slice
// recomputes q.k and the softmax, so no state crosses CTAs but the
// splits' partials.  As in the main kernel every sum is an explicit fmaf
// or __fadd_rn in a fixed order that depends on nothing of the launch but
// d, so verify rows stay bit-equal to q-len-1 launches.
template <typename Q, typename KV, int ROWS>
__global__ void __launch_bounds__(kThreads)
    flash_decode_wide_kernel(const Params p) {
  constexpr int KC = kWideKC;
  constexpr int E = Chunk<KV>::kElems;
  constexpr int NCG = kMaxD / kThreads;  // output columns a thread
  __shared__ float s_s[ROWS * KC], p_s[ROWS * KC], a_s[ROWS];
  __shared__ float ml_s[2 * ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int bid = blockIdx.x;
  const int cs = bid % p.n_cs;
  bid /= p.n_cs;
  const int rb = bid % p.n_rb;
  bid /= p.n_rb;
  const int split = bid % p.NS;
  const int bh = bid / p.NS;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D, PS = p.PS;

  const int kv_len = p.lens[b];
  const int n_pages = min((kv_len + PS - 1) / PS, p.MP);
  const int n_splits = max(1, (n_pages + kSplitPages - 1) / kSplitPages);
  if (split >= n_splits) return;
  const int r0 = rb * p.rows_cta;
  const int nrows = min(p.rows_cta, p.R - r0);

  const int ppc = PS < KC && KC % PS == 0 ? KC / PS : 1;
  const int cpp = ppc > 1 ? 1 : (PS + KC - 1) / KC;
  const int p0 = split * kSplitPages;
  const int p1 = min(p0 + kSplitPages, n_pages);
  int n_live = 0;
  if (p1 > p0) {
    const int last = min(kv_len - (p1 - 1) * PS, PS);
    n_live = ppc > 1 ? (p1 - p0 + ppc - 1) / ppc
                     : (p1 - p0 - 1) * cpp + min(cpp, (last + KC - 1) / KC);
  }
  const Split sp{p0, p1, ppc, cpp, PS, KC};
  const int* table = p.tables + static_cast<long long>(b) * p.MP;
  const KV* k_pool = static_cast<const KV*>(p.k_pages);
  const KV* v_pool = static_cast<const KV*>(p.v_pages);
  const Q* qb = static_cast<const Q*>(p.q) + b * p.sqb + h * p.sqh;
  // key j of a chunk: its K/V row in the pools
  auto row_of = [&](const Chunk1& c, int j) {
    const int pg = c.pg + (ppc > 1 ? j / PS : 0);
    const int pos = ppc > 1 ? j % PS : c.c0 + j;
    return ((static_cast<long long>(table[pg]) * p.H + h) * PS + pos) * D;
  };

  constexpr int kGrp = KC;       // lanes a row in the softmax
  const int grp = lane / kGrp, kl = lane % kGrp;
  float m = kNegInf, l = 0.f;  // of row grp (warp 0 only)
  float acc[ROWS][NCG];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int g = 0; g < NCG; ++g) acc[r][g] = 0.f;
  const int col0 = cs * kMaxD + tid;

  for (int ci = 0; ci < n_live; ++ci) {
    const Chunk1 cur = sp.at(ci);
    const int start = cur.pg * PS + cur.c0;
    const int rows = cur.rows;
    // q.k: warp `warp` takes key `warp` of the chunk
    if (warp < rows) {
      const KV* kr = k_pool + row_of(cur, warp);
      float dot[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dot[r] = 0.f;
      for (int c = lane; c < p.nchk; c += 32) {
        float kf[E];
        if (p.vec) {
          Chunk<KV>::cvt(reinterpret_cast<const uint4*>(kr)[c], kf);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            kf[e] = c * E + e < D ? to_f32(kr[c * E + e]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nrows) {
            const Q* qr = qb + (r0 + r) * p.sqr + c * E;
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float qv = c * E + e < D ? to_f32(qr[e]) : 0.f;
              dot[r] = fmaf(qv, kf[e], dot[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
#pragma unroll
          for (int off = 1; off < 32; off *= 2)
            dot[r] = __fadd_rn(dot[r],
                               __shfl_xor_sync(0xffffffffu, dot[r], off));
          if (lane == 0) s_s[r * KC + warp] = __fmul_rn(dot[r], p.scale);
        }
      }
    }
    __syncthreads();

    // the online softmax: warp 0, a group of 4 lanes a row, a lane a key
    if (warp == 0) {
      const int r = grp;
      const bool own = r < nrows;
      const int limit = min(kv_len, kv_len - p.R + 1 + r0 + r);
      const bool valid = own && kl < rows && start + kl < limit;
      const float sv = valid ? s_s[r * KC + kl] : kNegInf;
      float cmax = sv;
#pragma unroll
      for (int off = kGrp / 2; off > 0; off /= 2)
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      const float m_next = fmaxf(m, cmax);
      const float pv = valid ? expf(__fsub_rn(sv, m_next)) : 0.f;
      float csum = pv;
#pragma unroll
      for (int off = kGrp / 2; off > 0; off /= 2)
        csum = __fadd_rn(csum, __shfl_xor_sync(0xffffffffu, csum, off));
      const float alpha = expf(__fsub_rn(m, m_next));
      if (own) {
        l = __fmaf_rn(l, alpha, csum);
        m = m_next;
        p_s[r * KC + kl] = round_p<KV>(pv);
        if (kl == 0) a_s[r] = alpha;
      }
    }
    __syncthreads();

    // p.V: this thread's columns of every row, the keys in order
    float o[ROWS][NCG];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int g = 0; g < NCG; ++g) o[r][g] = 0.f;
    for (int j = 0; j < rows; ++j) {
      const KV* vr = v_pool + row_of(cur, j);
      float vf[NCG];
#pragma unroll
      for (int g = 0; g < NCG; ++g) {
        const int c = col0 + kThreads * g;
        vf[g] = c < D ? to_f32(vr[c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          const float pj = p_s[r * KC + j];
#pragma unroll
          for (int g = 0; g < NCG; ++g) o[r][g] = fmaf(pj, vf[g], o[r][g]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
        const float alpha = a_s[r];
#pragma unroll
        for (int g = 0; g < NCG; ++g)
          acc[r][g] = __fmaf_rn(acc[r][g], alpha, o[r][g]);
      }
    }
  }

  if (warp == 0 && grp < nrows && kl == 0) {
    ml_s[2 * grp] = m;
    ml_s[2 * grp + 1] = l;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nrows) continue;
    if (n_splits == 1) {
      const float lr = ml_s[2 * r + 1];
      const float lc = lr == 0.f ? 1.f : lr;
      Q* out = static_cast<Q*>(p.out) +
               ((static_cast<long long>(b) * p.R + r0 + r) * p.H + h) * D;
#pragma unroll
      for (int g = 0; g < NCG; ++g) {
        const int c = col0 + kThreads * g;
        if (c < D) out[c] = from_f32<Q>(acc[r][g] / lc);
      }
    } else {
      float* w = p.ws +
                 ((static_cast<long long>(bh) * p.R + r0 + r) * p.NS +
                  split) *
                     (D + 2);
#pragma unroll
      for (int g = 0; g < NCG; ++g) {
        const int c = col0 + kThreads * g;
        if (c < D) w[c] = acc[r][g];
      }
      if (cs == 0 && tid == 0) {
        w[D] = ml_s[2 * r];
        w[D + 1] = ml_s[2 * r + 1];
      }
    }
  }
}

// Merges the splits of one (sequence, head, row) in split order and
// writes its output; a sequence of one split wrote its own.
template <typename Q>
__global__ void __launch_bounds__(kThreads)
    flash_decode_merge_kernel(const Params p) {
  const int idx = blockIdx.x;  // (b * H + h) * R + row
  const int bh = idx / p.R;
  const int b = bh / p.H;
  const int kv_len = p.lens[b];
  const int n_pages = min((kv_len + p.PS - 1) / p.PS, p.MP);
  const int n_splits = (n_pages + kSplitPages - 1) / kSplitPages;
  if (n_splits <= 1) return;
  const int D = p.D;
  const float* w = p.ws + static_cast<long long>(idx) * p.NS * (D + 2);
  Q* out = static_cast<Q*>(p.out);
  const int row = idx % p.R, h = bh % p.H;
  const long long base =
      ((static_cast<long long>(b) * p.R + row) * p.H + h) * D;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float m = kNegInf, l = 0.f, acc = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* ws = w + s * (D + 2);
      merge_state(m, l, acc, ws[D], ws[D + 1], ws[c]);
    }
    out[base + c] = from_f32<Q>(acc / (l == 0.f ? 1.f : l));
  }
}

template <typename Q, typename KV, int NCG, int ROWS, int KC>
cudaError_t launch(Params p, int B, int sms, cudaStream_t stream) {
  constexpr int E = Chunk<KV>::kElems;
  p.nchk = (p.D + E - 1) / E;
  const int row_bytes = p.nchk * 16;
  // K rows padded so the keys of a quarter warp's 16-byte reads (8 /
  // (threads a key) keys of 16 bytes times threads a key each) tile 128
  // bytes, free of bank conflicts; a quarter warp on one key needs none
  constexpr int kKeySpan = 16 * (kThreads / KC) % 128;
  p.ldk = kKeySpan == 0
              ? row_bytes
              : row_bytes + (kKeySpan - row_bytes % 128 + 128) % 128;
  p.ldv = row_bytes;
  p.ldq = p.nchk * E;
  p.vec = p.D % E == 0;
  p.n_rb = (p.R + p.rows_cta - 1) / p.rows_cta;
  const long long blocks =
      static_cast<long long>(B) * p.H * p.NS * p.n_rb;
  const long long merge_blocks = static_cast<long long>(B) * p.H * p.R;
  if (blocks > 0x7fffffffLL || merge_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto kernel = flash_decode_kernel<Q, KV, NCG, ROWS, KC>;
  auto smem_of = [&](int stages) {
    return static_cast<size_t>(stages) * KC * (p.ldk + p.ldv) +
           sizeof(float) * p.rows_cta *
               (p.ldq + 2 * KC + 3 + (KC >= 64 ? kThreads : 0));
  };
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  // The deepest ring that keeps the grid to as few waves as two stages
  // do: a long sequence's few CTAs keep more chunks in flight, a full
  // grid keeps more CTAs an SM.
  auto waves = [&](int stages, cudaError_t* e) {
    int per_sm = 0;
    *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem_of(stages));
    const long long slots = static_cast<long long>(sms) * per_sm;
    return slots > 0 ? (blocks + slots - 1) / slots : -1LL;
  };
  const long long base = waves(2, &err);
  if (err != cudaSuccess) return err;
  if (base < 0) return cudaErrorInvalidValue;
  p.stages = 2;
  for (int s = kMaxStages; s > 2; --s) {
    if (smem_of(s) > kMaxSmem) continue;
    const long long w = waves(s, &err);
    if (err != cudaSuccess) return err;
    if (w == base) {
      p.stages = s;
      break;
    }
  }
  const size_t smem = smem_of(p.stages);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.NS == 1) return err;
  flash_decode_merge_kernel<Q>
      <<<static_cast<unsigned>(merge_blocks), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Rows a CTA serves: all of a sequence's rows, up to the shape's limit, so
// a verify sweep reads each K/V chunk once; fewer where the grid would
// leave most SMs idle (fewer CTAs than half the SMs: a few sequences'
// verify sweeps), since rows do not interact.  Then the instantiation
// compiled for the fewest rows that hold them.
template <typename Q, typename KV, int NCG, int KC>
cudaError_t launch_rows(Params p, int B, int sms, cudaStream_t stream) {
  constexpr int kMax = max_rows<NCG>();
  const long long seq_blocks = static_cast<long long>(B) * p.H * p.NS;
  int rows = min(p.R, kMax);
  while (rows > 1 && seq_blocks * ((p.R + rows - 1) / rows) < sms / 2)
    rows = (rows + 1) / 2;
  p.rows_cta = rows;
  if constexpr (NCG == 1) {
    // up to d 128 (every model of the repo): the exact row count up to 8,
    // so a verify sweep of k + 1 rows runs no code for rows it lacks
    switch (rows) {
      case 1: return launch<Q, KV, NCG, 1, KC>(p, B, sms, stream);
      case 2: return launch<Q, KV, NCG, 2, KC>(p, B, sms, stream);
      case 3: return launch<Q, KV, NCG, 3, KC>(p, B, sms, stream);
      case 4: return launch<Q, KV, NCG, 4, KC>(p, B, sms, stream);
      case 5: return launch<Q, KV, NCG, 5, KC>(p, B, sms, stream);
      case 6: return launch<Q, KV, NCG, 6, KC>(p, B, sms, stream);
      case 7: return launch<Q, KV, NCG, 7, KC>(p, B, sms, stream);
      case 8: return launch<Q, KV, NCG, 8, KC>(p, B, sms, stream);
      default: break;
    }
  } else if constexpr (NCG == 2) {
    if (rows == 1) return launch<Q, KV, NCG, 1, KC>(p, B, sms, stream);
    if (rows <= 4) return launch<Q, KV, NCG, 4, KC>(p, B, sms, stream);
  }
  return launch<Q, KV, NCG, kMax, KC>(p, B, sms, stream);
}

// Above d 2048: the wide kernel, one or two rows a CTA (fewer where the
// grid would leave most SMs idle), no dynamic shared memory.
template <typename Q, typename KV>
cudaError_t launch_wide(Params p, int B, int sms, cudaStream_t stream) {
  constexpr int E = Chunk<KV>::kElems;
  p.nchk = (p.D + E - 1) / E;
  p.vec = p.D % E == 0;
  p.n_cs = (p.D + kMaxD - 1) / kMaxD;
  const long long seq_blocks = static_cast<long long>(B) * p.H * p.NS *
                               p.n_cs;
  p.rows_cta = p.R > 1 && seq_blocks * ((p.R + 1) / 2) >= sms / 2 ? 2 : 1;
  p.n_rb = (p.R + p.rows_cta - 1) / p.rows_cta;
  const long long blocks = seq_blocks * p.n_rb;
  const long long merge_blocks = static_cast<long long>(B) * p.H * p.R;
  if (blocks > 0x7fffffffLL || merge_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (p.rows_cta == 2)
    flash_decode_wide_kernel<Q, KV, 2>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  else
    flash_decode_wide_kernel<Q, KV, 1>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.NS == 1) return err;
  flash_decode_merge_kernel<Q>
      <<<static_cast<unsigned>(merge_blocks), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The chunk: 32 keys (fewer above d 256: 16, 8, then 4 keys of up to d
// 2048, whose two stages take 128 KB in f32), but 16 for f32 pools from d 64
// to 256, whose 16 keys already take 16 KB a stage at d 128 (so a full
// grid keeps four CTAs an SM with two chunks in flight each), and 64 up to
// d 32 (128 for f32 up to d 16), whose rows are short: fewer chunks, less
// of their fixed cost.  It follows the pools alone, so every launch over
// the same pools chunks alike.
template <typename Q, typename KV>
cudaError_t launch_d(const Params& p, int B, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr bool kF32 = sizeof(KV) == 4;
  if (kF32 && p.D <= 16)
    return launch_rows<Q, KV, 1, 128>(p, B, sms, stream);
  if (p.D <= 32) return launch_rows<Q, KV, 1, 64>(p, B, sms, stream);
  if (p.D <= 128) {
    if (kF32 && p.D >= 64)
      return launch_rows<Q, KV, 1, 16>(p, B, sms, stream);
    return launch_rows<Q, KV, 1, 32>(p, B, sms, stream);
  }
  if (p.D <= 256) {
    if (kF32) return launch_rows<Q, KV, 2, 16>(p, B, sms, stream);
    return launch_rows<Q, KV, 2, 32>(p, B, sms, stream);
  }
  if (p.D <= 512) return launch_rows<Q, KV, 4, 16>(p, B, sms, stream);
  if (p.D <= 1024) return launch_rows<Q, KV, 8, 8>(p, B, sms, stream);
  if (p.D <= kMaxD) return launch_rows<Q, KV, 16, 4>(p, B, sms, stream);
  return launch_wide<Q, KV>(p, B, sms, stream);
}

}  // namespace

extern "C" {

// Splits of the workspace a launch with a table of MP pages needs; the
// wrapper allocates [B,H,R,splits,D+2] f32 when it is above 1.
int pt_flash_decode_splits(int MP) {
  return MP <= 0 ? 1 : (MP + kSplitPages - 1) / kSplitPages;
}

// kv_dtype: 0 = float32 (q f32), 1 = bfloat16 (q bf16), 2 = int8 pages
// (q f32, out f32).  ws: the workspace, or null when
// pt_flash_decode_splits(MP) is 1.  Returns a cudaError_t.
int pt_flash_decode(const void* q, const void* k_pages, const void* v_pages,
                    const int* tables, const int* lens, void* out, void* ws,
                    int B, int R, int H, int D, int PS, int MP, long long sqb,
                    long long sqr, long long sqh, int kv_dtype, float scale,
                    void* stream) {
  if (D <= 0 || R <= 0 || PS <= 0 || MP <= 0 || H <= 0 ||
      B < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ns = pt_flash_decode_splits(MP);
  if (ns > 1 && ws == nullptr) return cudaErrorInvalidValue;
  Params p{};
  p.q = q, p.k_pages = k_pages, p.v_pages = v_pages;
  p.tables = tables, p.lens = lens, p.out = out;
  p.ws = static_cast<float*>(ws);
  p.R = R, p.H = H, p.D = D, p.PS = PS, p.MP = MP, p.NS = ns, p.n_cs = 1;
  p.sqb = sqb, p.sqr = sqr, p.sqh = sqh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0) return launch_d<float, float>(p, B, s);
  if (kv_dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(p, B, s);
  if (kv_dtype == 2) return launch_d<float, int8_t>(p, B, s);
  return cudaErrorInvalidValue;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
