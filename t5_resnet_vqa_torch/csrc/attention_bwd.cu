// Backward of unmasked scaled dot-product attention, bf16, D = 64, over
// strided [B, H, S, D] views: dQ, dK and dV from q, k, v, the output's
// gradient dO and the forward's row statistics in one kernel (TMA + wgmma,
// sm_90a).
//
// Replaces the backward of the Pallas kernel's custom VJP,
// `_fas_bwd` (t5_resnet_vqa_tpu/ops/pallas/attention.py:156, registered on
// `fused_attention_grad_safe` at :162): the VJP of the plain attention
// (ops/layers.py:dot_product_attention), recomputed from q, k and v. The TPU
// package has no kernel for it; on the TPU it is XLA's code for that VJP.
// Same math, rounded where autograd of the plain version rounds
// (ops/attention.py, attention_reference):
//   P  = softmax(q.k^T / sqrt(D)) in fp32;   Pb = bf16(P)
//   dV = Pb^T.dO                             (fp32 sums, out in bf16)
//   dP = bf16(dO.V^T)                        (the gradient of att.float())
//   delta = sum_j P * dP, per query row      (fp32 P, rounded dP; not
//                                             FlashAttention's rowsum(dO*O))
//   dS = P * (dP - delta) / sqrt(D)
//   dQ = dS.K,  dK = dS^T.Q                  (fp32 sums, out in bf16)
// P comes from the forward's statistics of each row (fp32 [B, H, Sq, 2]:
// m, the max of its scores times c = log2(e) / sqrt(D), and l, the sum of
// 2^(s c - m); ops/attention.py saves them from the forward kernel): P =
// 2^(s c - m) / l, the forward's own fp32 P to the bit, normalised before
// any rounding as the reference's softmax is. (A log-sum-exp alone, P =
// 2^(s c - lse), gives the dominant key of a saturated row 2^(+-1e-5)
// instead of 1, so that its dP - delta, about 1e-36 in the reference,
// becomes 1e-5 dP.) The one departure: dS is rounded to bf16 as the wgmma
// operand of the last two products, where the reference multiplies it in
// fp32. Rounded once, it came close to the 1e-2 gate on the card (dS sums
// to zero along a row, so dQ = dS.K cancels and the rounding shows); so dS
// goes in as a hi and a lo bf16 part (hi + lo carries it to about 2^-17),
// two products each, and the error stays at the level of the outputs' own
// bf16 rounding.
//
// What bounds it on an H100: by its bytes, 7 * S * D * 2 a head (q, k, v and
// dO read, dQ, dK and dV written) against 5 products of 2 * S^2 * D
// operations, about 150 operations per byte at S = 213, below the ~295 at
// which the tensor cores become the limit: at B=64, H=12 the 146.6 MB take
// 0.0437 ms at 3.35 TB/s, the 22.3 GFLOP 0.023 ms at 989 TFLOP/s. What it
// spends is set by the work on chip and how little of it overlaps: 10
// products of 2 * S^2 * D a head at wgmma's 64-row granularity, two
// exponentials per score, the bf16 roundings and hi/lo splits, each product
// waited for before the work that reads it (two warpgroups fill each
// other's waits), and the head's inputs, 112 KB at S = 213. Registers
// decide the design: one thread holds a row of P (N/2 fp32) in phase 1,
// and at 255 registers ptxas serializes every wgmma of the kernel
// (C7511), or of products of different widths on one set of accumulators
// (C7512), which costs more than any overlap gains (PERF.md §6).
//
// Design: a persistent block per SM walks heads (b, h). Thread 0 issues the
// loads (4-D maps (D, S, H, B) over the caller's strided views, 128-byte
// swizzle; Q and dO boxes of round16(Sq) rows, K and V of N = round16(Sk)
// rows, rows past Sq or Sk zero-filled). Q and K sit in a ring of two
// slots: the next head's load when the current one starts, under its work.
// V and dO load when the head starts: phase 1 reads them only after S and
// its exponentials. Two warpgroups share two phases of the head:
//  * Phase 1, query-major: group g takes query tiles g, g + 2, ... Per tile:
//    S = Q K^T as one wgmma m64nNk16 chain into N/2 fp32 registers a thread,
//    P = 2^(s c - m) / l in place from the forward's statistics (no max, no
//    sum, no normalisation pass); delta over dP = dO V^T by 64-key chunks,
//    two in flight, so that chunk c+1's product runs while chunk c is
//    summed; then dQ += dS K by 32-key chunks, dP formed again (a row of
//    dP next to the row of P would need N/4 registers more than a thread
//    has), dS split straight into its hi and lo A registers (K read
//    MN-major with the transpose bit), chunk c+1's dP product issued with
//    chunk c's dQ products. Each row's log-sum-exp (m + log2 l) and delta
//    go to shared memory (2 KB); dQ leaves through the group's swizzled
//    staging tile by a TMA store into [B, Sq, H, D].
//  * Phase 2, key-major, after both groups' statistics are in: group g
//    takes 64-key tiles g, g + 2, ... and walks the query rows in chunks,
//    the ragged one first (round16(Sq) - 64 (nqt - 1) rows), then 64 at a
//    time: S^T = K Q^T
//    and dP^T = V dO^T, P^T = 2^(S^T c - lse) with one exponential and dS^T
//    formed a pair at a time straight into the A registers of dV +=
//    bf16(P^T) dO and dK += bf16(dS^T) Q (dO and Q MN-major). dK and dV
//    leave by TMA stores into [B, Sk, H, D].
//  Each output has one writer, so there are no atomics and no second pass.
//  Every product on one set of accumulators has one width: phase 1's last
//  64- and 32-key chunks read up to 48 rows of V past N, whose columns are
//  not used. 1/sqrt(D) = 1/8 is applied to dQ and dK at the end: a power of
//  two, so exactly.
//  Padding: keys past Sk get P = 0 in phase 1 (masked before the
//  exponential); query rows past Sq get lse = +inf (P = 0) and delta = 0,
//  so they add nothing to dK and dV in phase 2; rows past Sq or Sk are
//  clipped by the stores. A 64-row tile may read up to 48 rows past its
//  box: they lie in the next buffer of shared memory, only warps whose 16
//  rows all lie past the end read them (or columns no one uses), and such
//  a warp skips its elementwise work and feeds zeros to the products.
//  Budget: 2 x 128 threads, __launch_bounds__(256, 1): up to 255 registers
//  a thread (ptxas -v per N in the smoke's build line). Shared memory: Q
//  and K x 2, V, dO, one 8 KB staging tile per group, 2 KB of statistics,
//  2 KB of barriers and alignment: 188 KB at S = 213, 212 KB at S = 256.
//  One instantiation per N (64..256 in steps of 16).
//
// Limits (checked by the Python wrapper, which routes, and again here): bf16,
// D = 64, 64 <= Sq, Sk <= 256, every base address and stride of q, k, v
// and dO a positive multiple of 16 bytes; the statistics given.

#include "sm90_common.cuh"

using namespace sm90;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                    // a tile: 64 query rows or keys
constexpr int kD = 64;                       // one 128-byte swizzled row
constexpr int kTileElems = kRows * kD;
constexpr int kTileBytes = kTileElems * 2;   // 8192
constexpr int kGroups = 2;                   // warpgroups
constexpr int kThreads = kGroups * 128;
constexpr int kMaxS = 256;
constexpr int kMaxSmem = 232448;

struct Geo {
  int items, H, Sq, Sk;     // items = B * H heads
  int nqt;                  // 64-row query tiles of a head
  int last_w;               // query rows in the last tile, rounded up to 16
  unsigned q_bytes;         // the Q box, and the dO box: round16(Sq) rows
  unsigned kv_bytes;        // the K box, and the V box: N rows
  float scale_log2;         // log2(e) / sqrt(D)
  float scale;              // 1 / sqrt(D)
  const float2* stats;      // [B, H, Sq]: each row's (m, l) from the forward
};

// Shared memory: 1024 bytes of alignment slack, 1024 for the barriers, Q x
// 2, K x 2, V, dO (each a multiple of 2 KB, so each stays 1024-byte
// aligned), one staging tile per warpgroup, the statistics (2 x kMaxS
// floats): at most 212 KB (S = 256). Every buffer a 64-row tile may read
// past its box is followed by another buffer of at least the 48 rows it
// may read.
inline size_t smem_bytes(unsigned q_bytes, unsigned kv_bytes) {
  return 2048 + 3 * (size_t)q_bytes + 3 * (size_t)kv_bytes + (size_t)kGroups * kTileBytes +
         2 * kMaxS * sizeof(float);
}

// The two halves of a bf16 pair (pack_bf16(lo, hi)) as floats.
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// The fp32 pair (a, b) as dS enters a product: a bf16 high part and the
// bf16 rounding of the rest, hi + lo carrying it to about 2^-17 relative,
// so the products with dS lose nothing a reader of their bf16 results
// could see.
__device__ __forceinline__ void split2(float a, float b, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf16_lo(hi), b - bf16_hi(hi));
}

template <int K16>
__device__ __forceinline__ void zero_a(unsigned (*a)[4]) {
#pragma unroll
  for (int i = 0; i < K16; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = 0u;
}

// A group's 64 x 64 fp32 accumulator into its swizzled staging tile and out
// by a TMA store at rows row0.. of head (b, h); rows past the map's S are
// clipped. The group's earlier store from this tile must have read it
// (staging_free).
__device__ __forceinline__ void store_tile(const float (&acc)[32], bf16* stg,
                                           const CUtensorMap* map, int row0,
                                           int b, int h, int group) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    store2(stg + swizzled(r, 8 * j + c0), acc[4 * j], acc[4 * j + 1]);
    store2(stg + swizzled(r + 8, 8 * j + c0), acc[4 * j + 2], acc[4 * j + 3]);
  }
  fence_async_shared();
  named_barrier(1 + group, 128);
  if (tid == 0) {
    tma_store_4d(map, stg, 0, row0, h, b);
    bulk_commit();
  }
}

// The group's staging tile may be written: its last store has read it.
__device__ __forceinline__ void staging_free(int group) {
  if ((threadIdx.x & 127) == 0) bulk_wait_read();
  named_barrier(1 + group, 128);
}

// d[W/2] = A B^T over D (four k16 steps), A (64 rows) and B (W rows) both
// K-major.
template <int W>
__device__ __forceinline__ void product_nt(float (&d)[32], uint64_t a, uint64_t b) {
  float(&dw)[W / 2] = *reinterpret_cast<float(*)[W / 2]>(&d[0]);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<W>::run(dw, a + 2 * kk, b + 2 * kk, kk);
}

// d += A B over K16 k16 steps (16 rows of B, 2048 bytes, each), A from
// registers, B [k][64] read MN-major; `first` starts the sum at zero.
template <int K16>
__device__ __forceinline__ void product_rs(float (&d)[32], const unsigned (*a)[4],
                                           uint64_t b, bool first) {
#pragma unroll
  for (int i = 0; i < K16; ++i)
    wgmma_rs_n64_tb(d, a[i], b + (uint64_t)i * (2048 >> 4), (first && i == 0) ? 0 : 1);
}

template <int M>
__device__ __forceinline__ void fence_all(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_reg(r[i]);
}
template <int M>
__device__ __forceinline__ void fence_all(unsigned (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(r[i][e]);
}

// d[W/2] = A B^T over D for W <= 32 (a narrow chunk's own accumulators).
template <int W>
__device__ __forceinline__ void product_nt16(float (&d)[16], uint64_t a, uint64_t b) {
  float(&dw)[W / 2] = *reinterpret_cast<float(*)[W / 2]>(&d[0]);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<W>::run(dw, a + 2 * kk, b + 2 * kk, kk);
}

__device__ __forceinline__ uint64_t desc(const bf16* p) {
  return wgmma_desc_sw128(p, 16, 1024);
}

// ---- phase 1: one 64-row query tile (rows row0..) by one warpgroup. qs
// and dos are the tile's rows of Q and dO; ks and vs the head's K and V
// (N rows); dO (and V) landing on vo_bar. Writes the rows' statistics and
// stores the tile's dQ.
template <int N>
__device__ __forceinline__ void query_tile(const bf16* qs, const bf16* dos,
                                           const bf16* ks, const bf16* vs,
                                           uint64_t* vo_bar, unsigned ph, float* stats,
                                           bf16* stg, const CUtensorMap* dqmap,
                                           int row0, int b, int h, const Geo& g,
                                           int group) {
  constexpr int NC = (N + 63) / 64;          // delta's walk: 64-key chunks
  constexpr int NH = (N + 31) / 32;          // dQ's walk: 32-key chunks
  constexpr int WH = N - 32 * (NH - 1);      // keys of the last one: 16 or 32
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const bool live = row0 + warp * 16 < g.Sq;

  // ---- S = Q K^T, then P in place (fp32) from the forward's statistics ----
  float s[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    WgmmaSS<N>::run(s, desc(qs) + 2 * kk, desc(ks) + 2 * kk, kk);
  wgmma_commit();
  // the thread's two rows' m and 1 / l; lse = m + log2(l), so that phase 2
  // forms P = 2^(s c - lse) with one exponential and no product (rows past
  // Sq: m = lse = +inf and 1 / l = 0, so P = 0)
  float m[2], inv[2], lse[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * half;
    const float2 ml = row < g.Sq ? g.stats[(size_t)(b * g.H + h) * g.Sq + row]
                                 : make_float2(INFINITY, INFINITY);
    m[half] = ml.x;
    inv[half] = 1.f / ml.y;
    lse[half] = ml.x + __log2f(ml.y);
  }
  wgmma_wait<0>();
  fence_all(s);
  if (live) {
    // N = round16(Sk): padded keys lie in the last two n8 blocks only
#pragma unroll
    for (int j = N / 8 - 2; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + c0 + (e & 1) >= g.Sk) s[4 * j + e] = -INFINITY;
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      s[i] = ex2(fmaf(s[i], g.scale_log2, -m[(i >> 1) & 1])) * inv[(i >> 1) & 1];
  }

  // ---- delta = sum_j P bf16(dP), dP = dO V^T by 64-key chunks, two in
  // flight: chunk c+1's product runs while chunk c is summed ----
  const uint64_t ddo = desc(dos);
  // every chunk 64 keys wide, the last one too (past N it reads rows of
  // the next buffer, and their columns are not used): ptxas serializes
  // products of different widths on one set of accumulators
  auto issue_dp = [&](float (&dp)[32], int c) {
    wgmma_fence();
    product_nt<64>(dp, ddo, desc(vs + c * kTileElems));
    wgmma_commit();
  };
  mbar_wait(vo_bar, ph);
  float dsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};    // two partial sums a row
  float dp[2][32];
  issue_dp(dp[0], 0);
  if (NC > 1) issue_dp(dp[1], 1);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c + 1 < NC)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_all(dp[c & 1]);
    if (live) {
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        if (32 * c + i < N / 2) {
          const unsigned r = pack_bf16(dp[c & 1][i], dp[c & 1][i + 1]);  // dP in bf16
          float& acc = dsum[(i >> 2) & 1][(i >> 1) & 1];
          acc = fmaf(s[32 * c + i], bf16_lo(r), acc);
          acc = fmaf(s[32 * c + i + 1], bf16_hi(r), acc);
        }
    }
    if (c + 2 < NC) issue_dp(dp[c & 1], c + 2);
  }
  float delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    delta[half] = dsum[0][half] + dsum[1][half];
    delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 1);
    delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 2);
  }
  // the rows' statistics for phase 2: rows past Sq get lse = +inf (so P =
  // 0) and delta = 0, so that they add nothing to dK and dV
  if ((lane & 3) == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + warp * 16 + (lane >> 2) + 8 * half;
      const bool in = row < g.Sq;
      stats[row] = in ? lse[half] : INFINITY;
      stats[kMaxS + row] = in ? delta[half] : 0.f;
    }
  }

  // ---- dQ = dS K by 32-key chunks, dS = P (bf16(dP) - delta) formed from
  // dP again, whose product for chunk c+1 runs with chunk c's dQ products;
  // dQ is scaled by 1/sqrt(D) at the end (a power of two at D = 64:
  // exact) ----
  auto issue_dp32 = [&](float (&d)[16], int c) {
    wgmma_fence();
    product_nt16<32>(d, ddo, desc(vs + c * 32 * kD));
  };
  float dq[32], dpc[16];
  unsigned dh[2][4], dl[2][4];
  issue_dp32(dpc, 0);
  wgmma_commit();
#pragma unroll
  for (int c = 0; c < NH; ++c) {
    wgmma_wait<0>();
    fence_all(dpc);
    fence_all(dq);
    fence_all(dh);
    fence_all(dl);
    if (live) {
      // register r of k16 step k in the A layout is the pair (8k + 2r,
      // 8k + 2r + 1) of the chunk's accumulators
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        float a = 0.f, b = 0.f;
        if (16 * c + i < N / 2) {
          const unsigned r = pack_bf16(dpc[i], dpc[i + 1]);     // dP in bf16
          const float d = delta[(i >> 1) & 1];
          a = s[16 * c + i] * (bf16_lo(r) - d);
          b = s[16 * c + i + 1] * (bf16_hi(r) - d);
        }
        split2(a, b, dh[i >> 3][(i >> 1) & 3], dl[i >> 3][(i >> 1) & 3]);
      }
    } else {
      zero_a<2>(dh);
      zero_a<2>(dl);
    }
    const uint64_t kc = desc(ks + c * 32 * kD);
    wgmma_fence();
    if (c < NH - 1) {
      product_rs<2>(dq, dh, kc, c == 0);
      product_rs<2>(dq, dl, kc, false);
      issue_dp32(dpc, c + 1);
    } else {
      product_rs<WH / 16>(dq, dh, kc, c == 0);
      product_rs<WH / 16>(dq, dl, kc, false);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_all(dq);
  fence_all(dh);
  fence_all(dl);
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] *= g.scale;

  staging_free(group);
  store_tile(dq, stg, dqmap, row0, b, h, group);
}

// ---- phase 2, one chunk of W query rows (qs and dos point at its first
// row, stats at its first row's statistics) for one 64-key tile (K and V
// descriptors k_t and v_t): S^T = K Q^T and dP^T = V dO^T, P^T = 2^(S^T c
// - lse) and dS^T = P^T (bf16(dP^T) - delta) straight into the A registers
// of dV += bf16(P^T) dO and dK += bf16(dS^T) Q (a pair at a time, so that
// the chunk's fp32 values die as they go), each product waited for.
template <int W>
__device__ __forceinline__ void key_chunk(float (&dk)[32], float (&dv)[32], const bf16* qs,
                                          const bf16* dos, const float* stats, uint64_t k_t,
                                          uint64_t v_t, bool live, bool first, const Geo& g) {
  const int c0 = 2 * (threadIdx.x & 3);
  const uint64_t q_c = desc(qs), do_c = desc(dos);
  float st[W / 2], dpt[W / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<W>::run(st, k_t + 2 * kk, q_c + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) WgmmaSS<W>::run(dpt, v_t + 2 * kk, do_c + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(st);
  fence_all(dpt);
  unsigned pa[W / 16][4], dh[W / 16][4], dl[W / 16][4];
  if (live) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + c0;                    // even: float2 loads
      const float2 lse = *reinterpret_cast<const float2*>(stats + col);
      const float2 dl2 = *reinterpret_cast<const float2*>(stats + kMaxS + col);
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        // columns col and col + 1 of key row (e / 2): a pair, which is
        // register r of k16 step i in the A layout
        const int i = j >> 1, r = ((j & 1) << 1) | (e >> 1);
        const float p0 = ex2(fmaf(st[4 * j + e], g.scale_log2, -lse.x));
        const float p1 = ex2(fmaf(st[4 * j + e + 1], g.scale_log2, -lse.y));
        const unsigned rr = pack_bf16(dpt[4 * j + e], dpt[4 * j + e + 1]);
        const float d0 = p0 * (bf16_lo(rr) - dl2.x), d1 = p1 * (bf16_hi(rr) - dl2.y);
        pa[i][r] = pack_bf16(p0, p1);
        split2(d0, d1, dh[i][r], dl[i][r]);
      }
    }
  } else {
    zero_a<W / 16>(pa);
    zero_a<W / 16>(dh);
    zero_a<W / 16>(dl);
  }
  wgmma_fence();
  product_rs<W / 16>(dv, pa, do_c, first);
  product_rs<W / 16>(dk, dh, q_c, first);
  product_rs<W / 16>(dk, dl, q_c, false);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(dv);
  fence_all(dk);
  fence_all(pa);
  fence_all(dh);
  fence_all(dl);
}

// ---- phase 2: one 64-key tile (keys key0..) by one warpgroup. ks and vs
// are the tile's rows of K and V; qs and dos the head's Q and dO
// (round16(Sq) rows); stats the statistics of every query row. The query
// rows go in chunks: last_w first (round16(Sq) - 64 (nqt - 1): 16, 32, 48
// or 64), then 64 at a time. Stores the tile's dK and dV.
__device__ __forceinline__ void key_tile(const bf16* qs, const bf16* dos,
                                         const bf16* ks, const bf16* vs,
                                         const float* stats, bf16* stg,
                                         const CUtensorMap* dkmap,
                                         const CUtensorMap* dvmap, int key0,
                                         int b, int h, const Geo& g, int group) {
  const int warp = (threadIdx.x & 127) >> 5;
  const bool live = key0 + warp * 16 < g.Sk;
  const uint64_t k_t = desc(ks), v_t = desc(vs);
  float dk[32], dv[32];
  switch (g.last_w) {
    case 16: key_chunk<16>(dk, dv, qs, dos, stats, k_t, v_t, live, true, g); break;
    case 32: key_chunk<32>(dk, dv, qs, dos, stats, k_t, v_t, live, true, g); break;
    case 48: key_chunk<48>(dk, dv, qs, dos, stats, k_t, v_t, live, true, g); break;
    default: key_chunk<64>(dk, dv, qs, dos, stats, k_t, v_t, live, true, g); break;
  }
  for (int row = g.last_w; row < g.last_w + 64 * (g.nqt - 1); row += 64)
    key_chunk<64>(dk, dv, qs + row * kD, dos + row * kD, stats + row, k_t, v_t, live, false,
                  g);
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] *= g.scale;
  staging_free(group);
  store_tile(dk, stg, dkmap, key0, b, h, group);
  staging_free(group);
  store_tile(dv, stg, dvmap, key0, b, h, group);
}

// Persistent: block i takes heads i, i + gridDim.x, ... When a head starts,
// thread 0 loads its dO (and V) and the next head's Q and K (and V) into
// the ring's other slot; the two warpgroups share the head's phases.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_tma(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap gmap,
                  const __grid_constant__ CUtensorMap dqmap,
                  const __grid_constant__ CUtensorMap dkmap,
                  const __grid_constant__ CUtensorMap dvmap, Geo g) {
  constexpr int N64 = (N + 63) & ~63;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_in = reinterpret_cast<uint64_t*>(smem);  // [2]: Q and K landed
  uint64_t* full_vo = full_in + 2;                        // V and dO landed
  unsigned char* const q_base = smem + 1024;              // Q x 2
  unsigned char* const k_base = q_base + 2 * g.q_bytes;   // K x 2
  bf16* const vs = reinterpret_cast<bf16*>(k_base + 2 * g.kv_bytes);
  bf16* const dos = vs + g.kv_bytes / 2;
  bf16* const staging = dos + g.q_bytes / 2;              // [group] tiles
  float* const stats = reinterpret_cast<float*>(staging + kGroups * kTileElems);

  if (threadIdx.x == 0) {
    mbar_init(&full_in[0], 1);
    mbar_init(&full_in[1], 1);
    mbar_init(full_vo, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Q and K of head `item` into ring slot `s`
  auto load_in = [&](int s, int item) {
    const int b = item / g.H, h = item - b * g.H;
    mbar_arrive_expect_tx(&full_in[s], g.q_bytes + g.kv_bytes);
    tma_load_4d(k_base + s * g.kv_bytes, &kmap, 0, 0, h, b, &full_in[s]);
    tma_load_4d(q_base + s * g.q_bytes, &qmap, 0, 0, h, b, &full_in[s]);
  };
  if (threadIdx.x == 0 && blockIdx.x < g.items) load_in(0, blockIdx.x);

  const int group = threadIdx.x >> 7;
  bf16* stg = staging + group * kTileElems;
  int it = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++it) {
    // slot s holds heads s, s + 2, ... of the block: its fill (it >> 1)
    const int slot = it & 1;
    const unsigned ph_in = (it >> 1) & 1, ph_vo = it & 1;
    const int b = item / g.H, h = item - b * g.H;
    if (threadIdx.x == 0) {
      // the buffers the last head used are free (it ended in a barrier):
      // this head's V and dO, then the next head's Q and K
      mbar_arrive_expect_tx(full_vo, g.q_bytes + g.kv_bytes);
      tma_load_4d(vs, &vmap, 0, 0, h, b, full_vo);
      tma_load_4d(dos, &gmap, 0, 0, h, b, full_vo);
      if (item + gridDim.x < g.items) load_in(slot ^ 1, item + gridDim.x);
    }
    const bf16* qs = reinterpret_cast<const bf16*>(q_base + slot * g.q_bytes);
    const bf16* ks = reinterpret_cast<const bf16*>(k_base + slot * g.kv_bytes);
    mbar_wait(&full_in[slot], ph_in);
    for (int qt = group; qt < g.nqt; qt += kGroups)
      query_tile<N>(qs + qt * kTileElems, dos + qt * kTileElems, ks, vs, full_vo, ph_vo,
                    stats, stg, &dqmap, qt * kRows, b, h, g, group);
    __syncthreads();              // every row's statistics are in
    mbar_wait(full_vo, ph_vo);    // (if this group had no query tile)
    for (int kt = group; kt < N64 / kRows; kt += kGroups)
      key_tile(qs, dos, ks + kt * kTileElems, vs + kt * kTileElems, stats, stg, &dkmap,
               &dvmap, kt * kRows, b, h, g, group);
    __syncthreads();              // the head's buffers are free for the next one
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_all();
}

template <int N>
int launch(const CUtensorMap (&maps)[7], const Geo& g, cudaStream_t st) {
  // once per instantiation: the largest shared memory any launch asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_tma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = g.items < num_sms() ? g.items : num_sms();
  attention_bwd_tma<N><<<grid, kThreads, smem_bytes(g.q_bytes, g.kv_bytes), st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], g);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,Sq,D], k and v [B,H,Sk,D] and the output's gradient go [B,H,Sq,D],
// each given by its element strides over (b, h, s), D contiguous; stats the
// forward's contiguous fp32 [B,H,Sq,2] row statistics (attention.cu,
// attention_forward_tma: each row's m and l); dq, dk and dv are contiguous
// [B,Sq,H,D], [B,Sk,H,D], [B,Sk,H,D]. bf16 (dtype 1), D = 64, 64 <= Sq,
// Sk <= 256, every base address and stride a multiple of 16 bytes;
// anything else is refused with cudaErrorInvalidValue. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int attention_backward_tma(const void* q, const void* k, const void* v,
                                      const void* go, const void* stats, void* dq,
                                      void* dk, void* dv, int B, int H, int Sq, int Sk,
                                      int D, long long q0, long long q1, long long q2,
                                      long long k0, long long k1, long long k2,
                                      long long v0, long long v1, long long v2,
                                      long long g0, long long g1, long long g2,
                                      int dtype, void* stream) {
  if (dtype != 1 || D != kD || B < 1 || H < 1 || Sq < 64 || Sq > kMaxS || Sk < 64 ||
      Sk > kMaxS || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  const int N = (Sk + 15) & ~15, QR = (Sq + 15) & ~15, nqt = (Sq + kRows - 1) / kRows;
  const long long row = (long long)H * D;          // dq, dk, dv are [B, S, H, D]
  CUtensorMap maps[7];
  if (!make_head_map(&maps[0], q, B, H, Sq, q2, q1, q0, QR) ||
      !make_head_map(&maps[1], k, B, H, Sk, k2, k1, k0, N) ||
      !make_head_map(&maps[2], v, B, H, Sk, v2, v1, v0, N) ||
      !make_head_map(&maps[3], go, B, H, Sq, g2, g1, g0, QR) ||
      !make_head_map(&maps[4], dq, B, H, Sq, row, D, (long long)Sq * row, kRows) ||
      !make_head_map(&maps[5], dk, B, H, Sk, row, D, (long long)Sk * row, kRows) ||
      !make_head_map(&maps[6], dv, B, H, Sk, row, D, (long long)Sk * row, kRows))
    return (int)cudaErrorInvalidValue;
  const Geo g{B * H, H, Sq, Sk, nqt, QR - kRows * (nqt - 1),
              (unsigned)QR * kD * 2, (unsigned)N * kD * 2,
              1.4426950408889634f / sqrtf((float)D), 1.f / sqrtf((float)D),
              static_cast<const float2*>(stats)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64: return launch<64>(maps, g, st);
    case 80: return launch<80>(maps, g, st);
    case 96: return launch<96>(maps, g, st);
    case 112: return launch<112>(maps, g, st);
    case 128: return launch<128>(maps, g, st);
    case 144: return launch<144>(maps, g, st);
    case 160: return launch<160>(maps, g, st);
    case 176: return launch<176>(maps, g, st);
    case 192: return launch<192>(maps, g, st);
    case 208: return launch<208>(maps, g, st);
    case 224: return launch<224>(maps, g, st);
    case 240: return launch<240>(maps, g, st);
    case 256: return launch<256>(maps, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
