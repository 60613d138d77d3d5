// Backward of unmasked scaled dot-product attention, bf16, D = 64, over
// strided [B, H, S, D] views: dQ, dK and dV from q, k, v and the output's
// gradient dO in one kernel (TMA + wgmma, sm_90a).
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
// The one departure: dS is rounded to bf16 as the wgmma operand of the last
// two products, where the reference multiplies it in fp32. Rounded once, it
// came close to the 1e-2 gate on the card (dS sums to zero along a row, so
// dQ = dS.K cancels and the rounding shows); so dS goes in as a hi and a lo
// bf16 part (hi + lo carries it to about 2^-17), two products each, and
// the error stays at the level of the outputs' own bf16 rounding.
//
// What bounds it on an H100: bytes. Per head it reads q, k, v and dO and
// writes dQ, dK and dV, 7 * S * D * 2 bytes, for 5 products of 2 * S^2 * D
// operations: 5 S / 7, about 150 operations per byte at S = 213, below the
// ~295 at which the tensor cores become the limit. At B=64, H=12 the 146.6
// MB that must move take 0.0437 ms at 3.35 TB/s, the 22.3 GFLOP 0.023 ms at
// 989 TFLOP/s. So nothing but the 7 tensors touches device memory: P, dP and
// dS live in registers, the row statistics in shared memory, and q, k, v,
// dO are read in place through tensor maps (the head views of [B, S, H*D]
// projections; the gradient as the [B, H, Sq, D] view of a contiguous
// [B, Sq, H, D], which is how the forward's output hands it back), dQ, dK
// and dV are written as contiguous [B, S, H, D] by TMA stores.
//
// Design: a persistent block per SM walks heads (b, h). Thread 0 loads a
// head's Q and K on one mbarrier and its V and dO on another (4-D maps
// (D, S, H, B), 128-byte swizzle, rows past Sq or Sk zero-filled; Q and dO
// in nqt = ceil(Sq/64) 64-row tiles, K and V in N64 = round64(Sk) rows).
// Two warpgroups then share two phases of the head:
//  * Phase 1, query-major: group g takes query tiles g, g + 2, ... Per tile:
//    S = Q K^T as one wgmma m64nNk16 chain (N = round16(Sk)) into N/2 fp32
//    registers a thread, the softmax as the forward computes it (the whole
//    row in one quad: max, ex2, sum, P normalised in fp32, kept in the same
//    registers); then the keys in 64-column chunks (the last one N - 64 *
//    (chunks - 1) wide), twice: the first walk computes dP = dO V^T (V
//    K-major) and delta, the second computes dP again, dS from registers
//    and dQ += dS K (A from registers, K read MN-major with the transpose
//    bit, as the forward reads V). A whole row of dP next to P would need N
//    registers more than a thread has. Each row's log-sum-exp (its scaled
//    max plus log2 of its sum) and delta go to shared memory (2 KB); dQ
//    leaves through a swizzled staging tile by a TMA store into
//    [B, Sq, H, D].
//  * Phase 2, key-major, after both groups' statistics are in: group g
//    takes 64-key tiles g, g + 2, ... and walks the query rows in 64-row
//    chunks (the last one rounded up to 16 rows): S^T = K Q^T and dP^T =
//    V dO^T, P^T = 2^(S^T c - lse) with one exponential, dS^T, then dV +=
//    bf16(P^T) dO and dK += bf16(dS^T) Q (A from registers, dO and Q
//    MN-major). dK and dV leave by TMA stores into [B, Sk, H, D].
//  Each output has one writer, so there are no atomics and no second pass.
//  1/sqrt(D) = 1/8 is applied to dQ and dK at the end: a power of two, so
//  exactly.
//  Padding: keys past Sk get P = 0 in phase 1 (masked before the max, as in
//  the forward); query rows past Sq get lse = +inf (P = 0) and delta = 0,
//  so they add nothing to dK and dV in phase 2; rows past Sq or Sk are
//  clipped by the stores. A warp whose 16 rows (phase 1) or keys (phase 2)
//  all lie past the end skips its elementwise work.
//  Where the time goes: the elementwise work between the products
//  (exponentials, bf16 roundings, the hi/lo split) as much as the products
//  (S, dP twice, dQ, S^T, dP^T, dV and dK, with dS in two parts), and the
//  two barely overlap. So the elementwise work is kept lean: dP is rounded
//  two values at a time (one cvt.rn.bf16x2), 1/sum is folded into phase
//  2's exponent, and 1/sqrt(D) into the outputs. Tried on the card and left
//  out, as not faster at both S=197 and S=213: a ping-pong of the two
//  groups at the tensor cores; loading the next head's Q and K during the
//  current one (it took N = 208 to 255 registers); and pipelining phase
//  2's chunks over two sets of A registers, so that one chunk's
//  elementwise work runs under the last one's products (slower at both).
//  Budget: 2 x 128 threads, __launch_bounds__(256, 1): up to 255 registers
//  a thread (240 at N = 208, 246 at N = 224; ptxas -v, no spills below
//  N = 256). Shared memory: up to 128 KB of inputs, two 8 KB staging tiles
//  per group, 2 KB of statistics, 2 KB of barriers and alignment: up to
//  164 KB. One instantiation per N (64..256 in steps of 16).
//
// Limits (checked by the Python wrapper, which routes, and again here): bf16,
// D = 64, 64 <= Sq, Sk <= 256, every base address and stride of q, k, v
// and dO a positive multiple of 16 bytes.

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
  unsigned q_bytes;         // the Q box, and the dO box: nqt tiles
  unsigned kv_bytes;        // the K box, and the V box: N64 rows
  float scale_log2;         // log2(e) / sqrt(D)
  float scale;              // 1 / sqrt(D)
};

// Shared memory: 1024 bytes of alignment slack, 1024 for the barriers, Q,
// dO, K and V (each a multiple of 8 KB, so each stays 1024-byte aligned),
// two staging tiles per warpgroup, the statistics (2 x kMaxS floats).
inline size_t smem_bytes(int nqt, int n64) {
  return 2048 + 2 * (size_t)nqt * kTileBytes + 2 * (size_t)n64 * kD * 2 +
         (size_t)kGroups * 2 * kTileBytes + 2 * kMaxS * sizeof(float);
}

// The two halves of a bf16 pair (pack_bf16(lo, hi)) as floats.
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// The accumulators d[8i .. 8i+7] of a product (columns 16i..16i+15) as the
// A registers of k16 step i of the next one, rounded to bf16.
template <int K16>
__device__ __forceinline__ void pack_a(unsigned (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < K16; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = pack_bf16(d[8 * i + 2 * r], d[8 * i + 2 * r + 1]);
}

// The same, split into a bf16 high part and the bf16 rounding of the rest:
// hi + lo carries d to about 2^-17 relative, so the products with dS lose
// nothing a reader of their bf16 results could see.
template <int K16>
__device__ __forceinline__ void split_a(unsigned (&hi)[4][4], unsigned (&lo)[4][4],
                                        const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < K16; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = d[8 * i + 2 * r], b = d[8 * i + 2 * r + 1];
      const unsigned h = pack_bf16(a, b);
      hi[i][r] = h;
      lo[i][r] = pack_bf16(a - bf16_lo(h), b - bf16_hi(h));
    }
}

template <int K16>
__device__ __forceinline__ void zero_a(unsigned (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < K16; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = 0u;
}

// A group's 64 x 64 fp32 accumulator into its swizzled staging tile and out
// by a TMA store at rows row0.. of head (b, h); rows past the map's S are
// clipped. The group's earlier store from this tile must have read it.
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

// The group's staging tiles may be written: its last stores have read them.
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
__device__ __forceinline__ void product_rs(float (&d)[32], const unsigned (&a)[4][4],
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
__device__ __forceinline__ void fence_all(unsigned (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(r[i][e]);
}

__device__ __forceinline__ uint64_t desc(const bf16* p) {
  return wgmma_desc_sw128(p, 16, 1024);
}

// ---- phase 1: one 64-row query tile (rows row0..) by one warpgroup. qs
// and dos are the tile's rows of Q and dO; ks and vs the head's K and V
// (N64 rows); V and dO landing on vo_bar. Writes the rows' statistics and
// stores the tile's dQ.
template <int N>
__device__ __forceinline__ void query_tile(const bf16* qs, const bf16* dos,
                                           const bf16* ks, const bf16* vs,
                                           uint64_t* vo_bar, unsigned ph, float* stats,
                                           bf16* stg, const CUtensorMap* dqmap,
                                           int row0, int b, int h, const Geo& g,
                                           int group) {
  constexpr int NC = (N + 63) / 64;          // 64-key chunks
  constexpr int WL = N - 64 * (NC - 1);      // keys of the last one
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const bool live = row0 + warp * 16 < g.Sq;

  // ---- S = Q K^T, then P in place (fp32), exactly as the forward ----
  float s[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    WgmmaSS<N>::run(s, desc(qs) + 2 * kk, desc(ks) + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(s);
  // mc: each row's max times scale_log2; lse: mc + log2(sum), so that
  // phase 2 forms P = 2^(s c - lse) with one exponential and no product
  float mc[2] = {0.f, 0.f}, lse[2] = {0.f, 0.f};
  if (live) {
    // N = round16(Sk): padded keys lie in the last two n8 blocks only
#pragma unroll
    for (int j = N / 8 - 2; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + c0 + (e & 1) >= g.Sk) s[4 * j + e] = -INFINITY;
    // two partial maxima and sums per row: shorter dependency chains
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
    float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[j & 1][e >> 1] = fmaxf(mx[j & 1][e >> 1], s[4 * j + e]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[0][half] = fmaxf(mx[0][half], mx[1][half]);
      mx[0][half] = fmaxf(mx[0][half], __shfl_xor_sync(0xffffffffu, mx[0][half], 1));
      mx[0][half] = fmaxf(mx[0][half], __shfl_xor_sync(0xffffffffu, mx[0][half], 2));
      mc[half] = mx[0][half] * g.scale_log2;
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], g.scale_log2, -mc[e >> 1]));
        s[4 * j + e] = p;
        sum[j & 1][e >> 1] += p;
      }
    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float t = sum[0][half] + sum[1][half];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      inv[half] = 1.f / t;
      lse[half] = mc[half] + __log2f(t);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] *= inv[(i >> 1) & 1];
  }

  // dP = dO V^T for keys 64c.. (the last chunk WL keys wide)
  const uint64_t ddo = desc(dos);
  auto dp_chunk = [&](float (&dp)[32], int c) {
    wgmma_fence();
    if (c < NC - 1)
      product_nt<64>(dp, ddo, desc(vs + c * kTileElems));
    else
      product_nt<WL>(dp, ddo, desc(vs + c * kTileElems));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dp);
  };

  // ---- delta = sum_j P bf16(dP) ----
  mbar_wait(vo_bar, ph);
  float dsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};    // two partial sums a row
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float dp[32];
    dp_chunk(dp, c);
    if (live) {
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        if (32 * c + i < N / 2) {
          const unsigned r = pack_bf16(dp[i], dp[i + 1]);     // dP in bf16
          float& acc = dsum[(i >> 2) & 1][(i >> 1) & 1];
          acc = fmaf(s[32 * c + i], bf16_lo(r), acc);
          acc = fmaf(s[32 * c + i + 1], bf16_hi(r), acc);
        }
    }
  }
  float delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    delta[half] = dsum[0][half] + dsum[1][half];
    delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 1);
    delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 2);
  }

  // ---- dS = P (dP - delta) and dQ += dS K, chunk by chunk; dQ is scaled
  // by 1/sqrt(D) at the end (a power of two at D = 64: exact) ----
  float dq[32];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float dp[32];
    dp_chunk(dp, c);
    unsigned dh[4][4], dl[4][4];
    if (live) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        if (32 * c + i < N / 2) {
          const unsigned r = pack_bf16(dp[i], dp[i + 1]);     // dP in bf16
          const float d = delta[(i >> 1) & 1];
          dp[i] = s[32 * c + i] * (bf16_lo(r) - d);
          dp[i + 1] = s[32 * c + i + 1] * (bf16_hi(r) - d);
        } else {
          dp[i] = dp[i + 1] = 0.f;
        }
      }
      split_a<4>(dh, dl, dp);
    } else {
      zero_a<4>(dh);
      zero_a<4>(dl);
    }
    const uint64_t kc = desc(ks + c * kTileElems);
    wgmma_fence();
    if (c < NC - 1) {
      product_rs<4>(dq, dh, kc, c == 0);
      product_rs<4>(dq, dl, kc, false);
    } else {
      product_rs<WL / 16>(dq, dh, kc, c == 0);
      product_rs<WL / 16>(dq, dl, kc, false);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dq);
    fence_all(dh);
    fence_all(dl);
  }

  // ---- the rows' statistics for phase 2: rows past Sq get lse = +inf
  // (so P = 0) and delta = 0, so that they add nothing to dK and dV ----
  if ((lane & 3) == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + warp * 16 + (lane >> 2) + 8 * half;
      const bool in = row < g.Sq;
      stats[row] = in ? lse[half] : INFINITY;
      stats[kMaxS + row] = in ? delta[half] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] *= g.scale;

  staging_free(group);
  store_tile(dq, stg, dqmap, row0, b, h, group);
}

// ---- phase 2, one chunk of W query rows (qs and dos point at its first
// row, stats at its first row's statistics) for one 64-key tile (K and V
// descriptors k_t and v_t): dV += bf16(P^T) dO and dK += bf16(dS^T) Q.
template <int W>
__device__ __forceinline__ void key_chunk(float (&dk)[32], float (&dv)[32],
                                          const bf16* qs, const bf16* dos,
                                          const float* stats, uint64_t k_t,
                                          uint64_t v_t, bool live, bool first,
                                          const Geo& g) {
  const int c0 = 2 * (threadIdx.x & 3);
  const uint64_t q_c = desc(qs), do_c = desc(dos);
  // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns query rows
  float st[32], dpt[32];
  wgmma_fence();
  product_nt<W>(st, k_t, q_c);
  product_nt<W>(dpt, v_t, do_c);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(st);
  fence_all(dpt);
  unsigned pa[4][4], dh[4][4], dl[4][4];
  if (live) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + c0;                    // even: float2 loads
      const float2 lse = *reinterpret_cast<const float2*>(stats + col);
      const float2 dl2 = *reinterpret_cast<const float2*>(stats + kMaxS + col);
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        // columns c0 and c0 + 1 of row (e / 2): a pair
        const float p0 = ex2(fmaf(st[4 * j + e], g.scale_log2, -lse.x));
        const float p1 = ex2(fmaf(st[4 * j + e + 1], g.scale_log2, -lse.y));
        const unsigned r = pack_bf16(dpt[4 * j + e], dpt[4 * j + e + 1]);
        st[4 * j + e] = p0;
        st[4 * j + e + 1] = p1;
        dpt[4 * j + e] = p0 * (bf16_lo(r) - dl2.x);
        dpt[4 * j + e + 1] = p1 * (bf16_hi(r) - dl2.y);
      }
    }
    pack_a<W / 16>(pa, st);
    split_a<W / 16>(dh, dl, dpt);
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
// are the tile's rows of K and V; qs and dos the head's Q and dO (nqt
// tiles); stats the statistics of every query row. Stores the tile's dK and
// dV.
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
  int qc = 0;
  for (; qc < g.nqt - 1; ++qc)
    key_chunk<64>(dk, dv, qs + qc * kTileElems, dos + qc * kTileElems,
                  stats + qc * kRows, k_t, v_t, live, qc == 0, g);
  // the last tile's rows, rounded up to 16: a narrower product
  const bf16 *q_l = qs + qc * kTileElems, *do_l = dos + qc * kTileElems;
  const float* st_l = stats + qc * kRows;
  switch (g.last_w) {
    case 16: key_chunk<16>(dk, dv, q_l, do_l, st_l, k_t, v_t, live, qc == 0, g); break;
    case 32: key_chunk<32>(dk, dv, q_l, do_l, st_l, k_t, v_t, live, qc == 0, g); break;
    case 48: key_chunk<48>(dk, dv, q_l, do_l, st_l, k_t, v_t, live, qc == 0, g); break;
    default: key_chunk<64>(dk, dv, q_l, do_l, st_l, k_t, v_t, live, qc == 0, g); break;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] *= g.scale;
  staging_free(group);
  store_tile(dk, stg, dkmap, key0, b, h, group);
  store_tile(dv, stg + kTileElems, dvmap, key0, b, h, group);
}

// Persistent: block i takes heads i, i + gridDim.x, ... Thread 0 loads a
// head once both phases of the one before are done; the two warpgroups
// share its phases.
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
  uint64_t* full_qk = reinterpret_cast<uint64_t*>(smem);  // Q and K landed
  uint64_t* full_vo = full_qk + 1;                        // V and dO landed
  bf16* qs = reinterpret_cast<bf16*>(smem + 1024);
  bf16* dos = qs + g.q_bytes / 2;
  bf16* ks = dos + g.q_bytes / 2;
  bf16* vs = ks + g.kv_bytes / 2;
  bf16* staging = vs + g.kv_bytes / 2;                    // [group][2] tiles
  float* stats = reinterpret_cast<float*>(staging + kGroups * 2 * kTileElems);

  if (threadIdx.x == 0) {
    mbar_init(full_qk, 1);
    mbar_init(full_vo, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int group = threadIdx.x >> 7;
  bf16* stg = staging + group * 2 * kTileElems;
  int it = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++it) {
    const unsigned ph = it & 1;
    const int b = item / g.H, h = item - b * g.H;
    if (threadIdx.x == 0) {
      // Q and K first: the scores need them; V and dO after the softmax
      mbar_arrive_expect_tx(full_qk, g.q_bytes + g.kv_bytes);
      tma_load_4d(ks, &kmap, 0, 0, h, b, full_qk);
      tma_load_4d(qs, &qmap, 0, 0, h, b, full_qk);
      mbar_arrive_expect_tx(full_vo, g.q_bytes + g.kv_bytes);
      tma_load_4d(vs, &vmap, 0, 0, h, b, full_vo);
      tma_load_4d(dos, &gmap, 0, 0, h, b, full_vo);
    }
    mbar_wait(full_qk, ph);
    for (int qt = group; qt < g.nqt; qt += kGroups)
      query_tile<N>(qs + qt * kTileElems, dos + qt * kTileElems, ks, vs, full_vo, ph,
                    stats, stg, &dqmap, qt * kRows, b, h, g, group);
    __syncthreads();           // every row's statistics are in
    mbar_wait(full_vo, ph);    // (if this group had no query tile)
    for (int kt = group; kt < N64 / kRows; kt += kGroups)
      key_tile(qs, dos, ks + kt * kTileElems, vs + kt * kTileElems, stats, stg, &dkmap,
               &dvmap, kt * kRows, b, h, g, group);
    __syncthreads();           // the head's tiles are free for the next one
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
  attention_bwd_tma<N><<<grid, kThreads, smem_bytes(g.nqt, (N + 63) & ~63), st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], g);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,Sq,D], k and v [B,H,Sk,D] and the output's gradient go [B,H,Sq,D],
// each given by its element strides over (b, h, s), D contiguous; dq, dk and
// dv are contiguous [B,Sq,H,D], [B,Sk,H,D], [B,Sk,H,D]. bf16 (dtype 1), D =
// 64, 64 <= Sq, Sk <= 256, every base address and stride a multiple of 16
// bytes; anything else is refused with cudaErrorInvalidValue. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int attention_backward_tma(const void* q, const void* k, const void* v,
                                      const void* go, void* dq, void* dk, void* dv,
                                      int B, int H, int Sq, int Sk, int D,
                                      long long q0, long long q1, long long q2,
                                      long long k0, long long k1, long long k2,
                                      long long v0, long long v1, long long v2,
                                      long long g0, long long g1, long long g2,
                                      int dtype, void* stream) {
  if (dtype != 1 || D != kD || B < 1 || H < 1 || Sq < 64 || Sq > kMaxS || Sk < 64 ||
      Sk > kMaxS)
    return (int)cudaErrorInvalidValue;
  const int N = (Sk + 15) & ~15, n64 = (Sk + 63) & ~63, nqt = (Sq + kRows - 1) / kRows;
  const long long row = (long long)H * D;          // dq, dk, dv are [B, S, H, D]
  CUtensorMap maps[7];
  if (!make_head_map(&maps[0], q, B, H, Sq, q2, q1, q0, nqt * kRows) ||
      !make_head_map(&maps[1], k, B, H, Sk, k2, k1, k0, n64) ||
      !make_head_map(&maps[2], v, B, H, Sk, v2, v1, v0, n64) ||
      !make_head_map(&maps[3], go, B, H, Sq, g2, g1, g0, nqt * kRows) ||
      !make_head_map(&maps[4], dq, B, H, Sq, row, D, (long long)Sq * row, kRows) ||
      !make_head_map(&maps[5], dk, B, H, Sk, row, D, (long long)Sk * row, kRows) ||
      !make_head_map(&maps[6], dv, B, H, Sk, row, D, (long long)Sk * row, kRows))
    return (int)cudaErrorInvalidValue;
  const Geo g{B * H, H, Sq, Sk, nqt, ((Sq + 15) & ~15) - kRows * (nqt - 1),
              (unsigned)(nqt * kTileBytes), (unsigned)(n64 * kD * 2),
              1.4426950408889634f / sqrtf((float)D), 1.f / sqrtf((float)D)};
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
