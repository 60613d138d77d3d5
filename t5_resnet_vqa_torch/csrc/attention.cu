// Unmasked scaled dot-product attention over strided [B, H, S, D] views.
//
// Replaces the Pallas TPU kernel `_attention_kernel`
// (t5_resnet_vqa_tpu/ops/pallas/attention.py:56, launched by
// `fused_attention` at :108). Same math: fp32 scores = q.k^T * (1/sqrt(D)),
// row softmax in fp32, probabilities normalised in fp32 and only then
// rounded to the value dtype, P.V accumulated in fp32, output cast to the
// query dtype.
//
// Four routes, chosen by the Python wrapper (ops/attention.py, _route) by
// geometry alone:
//  * attention_forward_tma, bf16 with D = 64, 64 <= Sq, Sk <= 256 and
//    tensor-map readable strides (every base and stride a multiple of 16
//    bytes): TMA + wgmma, one pass over the keys. The ViT (S=197) and
//    RoBERTa (S=213) self-attentions.
//  * attention_forward_short, bf16 with 1 <= Sq, Sk <= 64, D a multiple of
//    16 and tensor-map readable strides (outside the wgmma route's
//    domain): persistent blocks fed by TMA, one pass over the keys,
//    mma.sync. The SGA blocks (H=8 or 4 at tp=2, D=96, Sq=16, Sk=16, 64).
//  * attention_forward, bf16 otherwise: mma.sync tiles of 16 query rows,
//    two passes over the keys (Sk up to 256, D even, any 4-byte aligned
//    rows).
//  * attention_forward, fp32: CUDA cores, a check path.
//
// What bounds it on an H100: bytes. At the SGA geometry each head does
// 2*Sq*Sk*D*2 FLOPs on (Sq + 2*Sk + Sq)*D elements, about 16 FLOPs per
// byte; at S=197, D=64 it is 2*S*D*2*S / (4*S*D*2) = S/2, about 98 FLOPs
// per byte. Both are far below the ~295 FLOPs/byte at which the tensor
// cores become the limit: at B=64, H=12, S=197 the 77.5 MB that must move
// (q, k, v read once, the output written once) take 0.023 ms at 3.35 TB/s,
// the 7.6 GFLOP of the two products under 0.01 ms at 989 TFLOP/s, and the
// 30 M exponentials about 0.008 ms on the SFUs. So everything that is not an
// input or an output stays on chip, and the inputs are read in place: q, k
// and v may be the strided head views of a [B, S, H*D] projection (D
// contiguous), and the output is written in [B, Sq, H, D] order, so the
// caller's head split and merge cost no copies.
//
// bf16, long rows (attention_forward_tma): one pass with TMA and wgmma.
//  * Sk <= 256, so a whole row of scores fits in the registers of the quad
//    of threads that owns it. The softmax therefore takes one pass over
//    the keys and still rounds exactly what the reference rounds: each
//    row's max and sum come from the quad's own registers (two shuffles),
//    P = exp(S - max) * (1 / sum) is formed in fp32 and rounded to bf16
//    after normalising. FlashAttention's online softmax would round the
//    unnormalised P instead, a different number.
//  * A persistent block per SM walks heads (b, h): one producer thread
//    keeps a 2-stage ring of TMA loads in flight on mbarriers (per head
//    one box of K, N = round16(Sk) rows, and one of Q, ceil(Sq/64) 64-row
//    tiles, on one barrier; one box of V on another, so the scores start
//    before V lands; rows past Sk or Sq zero-filled by the map), over the
//    caller's strided views as 4-D maps (D, S, H, B) with the 128-byte
//    swizzle, which fits D = 64 exactly (a row is 128 bytes). The next
//    head arrives while the current one is computed.
//  * Two consumer warpgroups; group g takes the head's query tiles g,
//    g + 2, ... (two each at S=197 and 213). Per tile: S = Q K^T as one
//    wgmma m64nNk16 chain (4 k16 steps, Q and K from shared memory) into
//    N/2 fp32 registers a thread; the softmax, masking only the last two
//    n8 blocks (the only ones that can hold padded keys); O = P V as a
//    chain of N/16 wgmma m64n64k16 with P from registers (the accumulator
//    layout of S, rounded to bf16 pairs, is the A-register layout) and V
//    from shared memory, transposed on read (V is [Sk][D], MN-major), into
//    32 fp32 registers. O leaves through the group's swizzled 8 KB staging
//    tile by a TMA store into [B, Sq, H, D] that clips rows past Sq. A warp
//    whose 16 rows all lie past Sq (the last tile at S=197 has 5 live rows)
//    skips its exponentials. The two groups are not made to take turns at
//    the tensor cores (FlashAttention-3's ping-pong): tried, it measured
//    slower here, where the exponentials, not the products, fill the time.
//  * Budget: 3 x 128 threads, __launch_bounds__(384, 1): 168 registers a
//    thread at launch (ptxas -v, every N), then setmaxnreg takes the
//    producer group to 24 and gives the consumers 240 (24 + 2 x 240 = 504
//    of the 512 each sub-partition holds for its three warps). At 168 the
//    wgmma chains of N >= 192 spilled and were serialized (ptxas C7512).
//    A consumer needs N/2 registers for S (104 at S=197, 112 at S=213),
//    N/4 for P and 32 for O. Shared memory: 2 stages of Q (32 KB) + K and
//    V (52 KB at N=208, 56 KB at N=224), two 8 KB output tiles and 2 KB of
//    barriers and alignment: 186-194 KB of the 227 KB a block may have.
//    One instantiation per N (64..256 in steps of 16): the products'
//    widths are compile-time.
//
// bf16, short rows (attention_forward_short): the SGA's geometry.
//  * What bounds it: bytes, and before them latency. Each head moves
//    (2 Sq + 2 Sk) D bf16 for 4 Sq Sk D FLOPs, about 16 FLOPs a byte at
//    Sq = 16, Sk = 64, D = 96. A CNN forward's six launches at B=64, H=8
//    move 6.29 MB (Sk=16: 1.88 us at 3.35 TB/s) or 15.7 MB (Sk=64: 4.69
//    us); the products take under a microsecond of tensor-core time. So
//    the design keeps each SM's share of the bytes in flight at once and
//    the launch's fixed cost small. It replaces, for these calls, the
//    mma.sync route below: one block of one warp per head (2-4 warps an
//    SM), K and V staged and waited for before any product, two passes
//    over the keys, fragments sized for D = 128.
//  * Persistent blocks, one per SM (at most B*H): block i takes heads i,
//    i + grid, ...; 4 consumer warps take the block's heads in turn
//    (warp w its w-th, w+4-th, ...) and one producer thread keeps a ring
//    of up to 8 stages loading ahead of them, as many as fit in shared
//    memory (4 at Sq = Sk = 64, D = 128). At B=64, H=8 a block holds its
//    3-4 heads in flight at once; larger batches wrap the ring.
//  * Each stage is one head: three TMA boxes (Q, K, V) over the caller's
//    strided [B, H, S, D] views as 4-D maps (D, S, H, B), on one mbarrier.
//    A D = 96 row is 192 bytes, which no swizzle mode covers (128 bytes is
//    the widest), and unswizzled rows 48 words apart put 4 rows of every
//    ldmatrix on one bank. So the maps have no swizzle and a box of D + 8
//    columns: the 8 past D lie outside the tensor and read as zeros, and
//    the rows land padded, (D + 8) * 2 bytes apart, an odd number of
//    16-byte units, so the 8 rows of an ldmatrix hit 8 distinct bank
//    groups. Rows past Sq or Sk (to 16-row tiles) read as zeros too.
//  * The products are mma.sync m16n8k16, not wgmma: wgmma takes 64 rows,
//    so at Sq = 16 three quarters of each product would be padding, and
//    the products are a small part of the bound's time here.
//  * One pass over the keys: a warp owns 16 query rows, and a row of at
//    most 64 scores fits in its quad's registers (S for all keys as
//    2 ceil(Sk/16) fp32 m16n8 fragments, 8 ceil(Sk/16) floats a thread).
//    Padded keys are -inf before the max; max and sum come from two quad
//    shuffles each; P = exp(S - max) * (1 / sum) is formed in fp32 and
//    rounded to bf16 only after it is normalised (the reference's rounding
//    point), straight from the accumulator fragments into A fragments; P V
//    accumulates in fp32. A head with Sq > 16 takes the warp's tiles one
//    after another.
//  * The output leaves through a per-warp staging tile in shared memory in
//    16-byte stores to [B, Sq, H, D]; rows past Sq are not written.
//  * Registers are sized for the compile-time D and key-tile count: one
//    instantiation per (D, ceil(Sk / 16)), D = 16..128 in steps of 16.

// bf16, other shapes (attention_forward): mma.sync m16n8k16.
//  * A block of 4 warps stages K and V of its heads in shared memory with
//    16-byte cp.async copies (4-byte where a view's rows are not 16-byte
//    aligned), D padded with zeros to a multiple of 16 and Sk to a multiple
//    of 16 (padded keys are masked out of the softmax).
//  * Each warp owns 16 query rows of one head: Q stays in registers as
//    A fragments; S = Q K^T comes 16 keys at a time.
//  * The reference rounds normalised P, so the softmax takes two passes
//    over the key tiles: the first finds each row's max and sum, the second
//    recomputes S, forms P = exp(S - max) * (1 / sum) in fp32 (the exp is
//    the hardware's ex2-based __expf: its error, a few ulp, vanishes in the
//    rounding to bf16), rounds it to bf16 straight from the accumulator
//    fragments into A fragments, and adds P V into fp32 accumulators. No
//    unnormalised P is ever rounded.
//  * One head per block, one warp per 16 query rows, up to 8 warps (128
//    rows) sharing the head's staged K and V: SGA (Sq = 16) runs B*H
//    one-warp blocks (512 at B=64, H=8). Each key tile's fragments are all
//    loaded before its products, so the shared-memory latencies overlap;
//    register arrays are sized for D up to 64 or up to 128 (two
//    instantiations).
//  * The output goes through the warp's Q area in shared memory, so rows
//    leave in 16-byte stores.
//
// fp32 (a check path): CUDA cores, one block per (batch, head), one warp
// per query row, K and V in shared memory with rows padded to an odd number
// of words.
//
// Limits (checked by the Python wrapper): Sk <= 256, D <= 128, D even; the
// last dimension contiguous and rows at least 4-byte aligned.

#include <initializer_list>

#include "sm90_common.cuh"

using namespace sm90;

namespace {

constexpr int kMaxSk = 256;
constexpr int kMaxD = 128;
constexpr int kMaxSmem = 232448;

struct Geo {
  int B, H, Sq, Sk, D;
  long long q0, q1, q2, k0, k1, k2, v0, v1, v2;   // element strides of b, h, s
  float scale;
  int qt, vec16;          // 16-row query tiles (warps) per block
};

// =================================================================== bf16

using bf16 = __nv_bfloat16;
constexpr int kMaxWarps = 8;

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Copy `rows` rows of D elements (row r at src + r * stride) into shared
// rows of ld elements, zero-filling columns D..Dp-1 and rows >= valid.
// Threads t0, t0 + nthreads, ... of the block take part.
__device__ inline void stage_rows(bf16* dst, int ld, const bf16* src,
                                  long long stride, int rows, int valid, int D,
                                  int Dp, bool vec16, int t0, int nthreads) {
  const int per = vec16 ? 8 : 2;              // elements per copy
  const int vpr = Dp / per;
  for (int e = t0; e < rows * vpr; e += nthreads) {
    const int r = e / vpr, col = (e - r * vpr) * per;
    int bytes = r < valid ? (D - col) * 2 : 0;
    bytes = bytes < 0 ? 0 : bytes;
    const bf16* s = bytes > 0 ? src + r * stride + col : src;
    if (vec16)
      cp_async16(dst + r * ld + col, s, bytes < 16 ? bytes : 16);
    else
      cp_async4(dst + r * ld + col, s, bytes < 4 ? bytes : 4);
  }
}

// DMAX: D rounded up to 64 or 128, which sizes the register fragments.
template <int DMAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = round16(g.D), Skp = round16(g.Sk), LD = Dp + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem);               // [Skp][LD]
  bf16* vs = ks + (size_t)Skp * LD;                       // [Skp][LD]
  bf16* qs = vs + (size_t)Skp * LD;                       // [warps][16][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec16 = g.vec16 != 0;
  const int b = blockIdx.x / g.H, h = blockIdx.x - b * g.H;

  // ---- stage K and V of the block's head, and each warp's 16 query rows --
  stage_rows(ks, LD, k + b * g.k0 + h * g.k1, g.k2, Skp, g.Sk, g.D, Dp, vec16,
             threadIdx.x, blockDim.x);
  stage_rows(vs, LD, v + b * g.v0 + h * g.v1, g.v2, Skp, g.Sk, g.D, Dp, vec16,
             threadIdx.x, blockDim.x);
  const int row0 = (blockIdx.y * g.qt + warp) * 16;
  const bool active = row0 < g.Sq;
  bf16* qw = qs + (size_t)warp * 16 * LD;
  if (active)
    stage_rows(qw, LD, q + b * g.q0 + h * g.q1 + row0 * g.q2, g.q2, 16,
               g.Sq - row0, g.D, Dp, vec16, lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  const int nk = Dp / 16, nkt = Skp / 16, nd = Dp / 8;

  unsigned qa[DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    if (kk < nk) ldmatrix_x4(qa[kk], qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);

  // S for keys 16t..16t+15 of rows lane/4 (elements 0, 1) and lane/4 + 8
  // (2, 3): n-tile j holds keys 16t + 8j + 2(lane % 4) + {0, 1}. Padded
  // keys are -inf.
  // ldmatrix x4 (no transpose) on K rows: matrix i = lane / 8 covers keys
  // 8(i / 2)..+7 at k offset 8(i % 2): the B fragments of both n-tiles.
  const bf16* kp = ks + ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  auto scores = [&](int t, float s[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // all of the tile's fragments first, so their loads overlap
    unsigned kb[DMAX / 16][4];
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      if (kk < nk) ldmatrix_x4(kb[kk], kp + t * 16 * LD + kk * 16);
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk < nk) {
        mma_bf16(s[0], qa[kk], kb[kk][0], kb[kk][1]);
        mma_bf16(s[1], qa[kk], kb[kk][2], kb[kk][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * 16 + j * 8 + (lane & 3) * 2 + (e & 1);
        s[j][e] = col < g.Sk ? s[j][e] * g.scale : -INFINITY;
      }
  };

  // ---- pass 1: each row's max and sum of exp (per thread, then per quad) --
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < nkt; ++t) {
    float s[2][4];
    scores(t, s);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = fmaxf(fmaxf(s[0][2 * half], s[0][2 * half + 1]),
                         fmaxf(s[1][2 * half], s[1][2 * half + 1]));
      const float mn = fmaxf(m[half], tmax);
      if (mn == -INFINITY) continue;
      float sum = m[half] == -INFINITY ? 0.f : l[half] * __expf(m[half] - mn);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * half + e];
          sum += x == -INFINITY ? 0.f : __expf(x - mn);
        }
      m[half] = mn;
      l[half] = sum;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mq = m[half];
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    float lq = m[half] == -INFINITY ? 0.f : l[half] * __expf(m[half] - mq);
    lq += __shfl_xor_sync(0xffffffffu, lq, 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    m[half] = mq;
    l[half] = 1.f / lq;          // from here on, the reciprocal of the sum
  }

  // ---- pass 2: P = exp(S - max) / sum, rounded to bf16, then P V ----
  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // x4.trans on V rows: lane l addresses key row (l & 15) at column
  // 8 (l >> 4); registers 0,1 feed d-tile 2j, 2,3 d-tile 2j+1
  const bf16* vp = vs + (lane & 15) * LD + (lane >> 4) * 8;
  for (int t = 0; t < nkt; ++t) {
    float s[2][4];
    scores(t, s);
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        p[j][e] = s[j][e] == -INFINITY ? 0.f : __expf(s[j][e] - m[half]) * l[half];
      }
    // the accumulator layout of two n8 tiles is the A layout of one k16 tile
    const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
    unsigned vb[DMAX / 16][4];
#pragma unroll
    for (int jd = 0; jd < DMAX / 16; ++jd)
      if (2 * jd < nd) ldmatrix_x4_trans(vb[jd], vp + t * 16 * LD + jd * 16);
#pragma unroll
    for (int jd = 0; jd < DMAX / 16; ++jd) {
      if (2 * jd < nd) {
        mma_bf16(acc[2 * jd], pa, vb[jd][0], vb[jd][1]);
        mma_bf16(acc[2 * jd + 1], pa, vb[jd][2], vb[jd][3]);
      }
    }
  }

  // ---- output: through the warp's Q area, then rows to o[b, s, h, :] ----
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (j < nd) {
      const int r = lane >> 2, c = j * 8 + (lane & 3) * 2;
      store2(qw + r * LD + c, acc[j][0], acc[j][1]);
      store2(qw + (r + 8) * LD + c, acc[j][2], acc[j][3]);
    }
  }
  __syncwarp();
  const int rows = g.Sq - row0 < 16 ? g.Sq - row0 : 16;
  const long long out_row = (long long)g.H * g.D;        // o is [B, Sq, H, D]
  bf16* ob = o + ((long long)b * g.Sq + row0) * out_row + (long long)h * g.D;
  if (g.D % 8 == 0) {
    const int vpr = g.D / 8;
    for (int e = lane; e < rows * vpr; e += 32) {
      const int r = e / vpr, c = (e - r * vpr) * 8;
      *reinterpret_cast<uint4*>(ob + r * out_row + c) =
          *reinterpret_cast<const uint4*>(qw + r * LD + c);
    }
  } else {
    const int vpr = g.D / 2;
    for (int e = lane; e < rows * vpr; e += 32) {
      const int r = e / vpr, c = (e - r * vpr) * 2;
      *reinterpret_cast<unsigned*>(ob + r * out_row + c) =
          *reinterpret_cast<const unsigned*>(qw + r * LD + c);
    }
  }
}

size_t smem_bf16(int qt, int Sk, int D) {
  const size_t ld = round16(D) + 8;
  return ((size_t)2 * round16(Sk) + (size_t)qt * 16) * ld * 2;
}

// ============================================= bf16, long rows: TMA + wgmma

namespace tma {

constexpr int kRows = 64;                    // query rows of a tile: wgmma's M
constexpr int kD = 64;                       // the route's D: one 128-byte row
constexpr int kTileBytes = kRows * kD * 2;   // 8192
constexpr int kGroups = 2;                   // consumer warpgroups
constexpr int kThreads = (kGroups + 1) * 128;  // + the producer warpgroup
// registers per thread after setmaxnreg: 24 + 2 * 240 = 504 of the 512 a
// sub-partition holds for its three warps (one of each group)
constexpr unsigned kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 2;
constexpr int kMaxS = 256;                   // Sq and Sk: one box each

struct Geo {
  int items, H, Sq, Sk;     // items = B * H heads
  int nqt;                  // 64-row query tiles per head
  unsigned q_bytes;         // a stage's Q box: nqt tiles
  unsigned kv_bytes;        // a stage's K box, and its V box: N rows
  float scale_log2;         // log2(e) / sqrt(D)
  float2* stats;            // [B, H, Sq] or null: each row's (max, sum)
};

// Shared memory: 1024 bytes of alignment slack, 1024 for the barriers, the
// stages (Q tiles, K rows, V rows, each 1024-byte aligned) and one 8 KB
// output tile per consumer group.
inline size_t smem_bytes(int nqt, int N) {
  const size_t stage = (size_t)nqt * kTileBytes + 2 * (size_t)N * kD * 2;
  return 2048 + kStages * stage + kGroups * kTileBytes;
}

// One 64-row query tile of a head, by one consumer warpgroup: S = Q K^T,
// the softmax of each row, P V, and the tile out by a TMA store; where
// g.stats is given, each row's statistics too (what the backward needs).
// qs, ks and vs are the swizzled tiles in shared memory (Q and K landed, V
// landing on v_bar); rows of K and V past Sk are zeros (the map's
// out-of-bounds fill).
template <int N>
__device__ __forceinline__ void tile(const bf16* qs, const bf16* ks, const bf16* vs,
                                     uint64_t* v_bar, unsigned ph, bf16* ostg,
                                     const CUtensorMap* omap, int row0, int b,
                                     int h, const Geo& g, int group) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;

  // ---- S = Q K^T: four k16 steps along D, 32 bytes apart in a row ----
  float s[N / 2];
  const uint64_t dq = wgmma_desc_sw128(qs, 16, 1024);
  const uint64_t dk = wgmma_desc_sw128(ks, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    WgmmaSS<N>::run(s, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_reg(s[i]);

  // ---- softmax of the thread's rows r (e < 2) and r + 8 (e >= 2): the
  // whole row is in the quad's registers, so max and sum take one pass;
  // P is normalised in fp32 and only then rounded to bf16, as the
  // reference rounds it. A warp whose 16 rows all lie past Sq skips it. ----
  unsigned pa[N / 16][4];
  if (row0 + warp * 16 < g.Sq) {
    // N = round16(Sk): padded keys lie in the last two n8 blocks only
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = N / 8 - 2; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + c0 + (e & 1) >= g.Sk) s[4 * j + e] = -INFINITY;
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      mx[half] *= g.scale_log2;
    }
    // exp(x / sqrt(D) - max / sqrt(D)) as 2^(x c - max c), c = log2(e) / sqrt(D)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], g.scale_log2, -mx[e >> 1]));
        s[4 * j + e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
    }
    // the row's statistics, as this kernel formed P: its scaled max
    // (max c) and sum (of 2^(s c - max c)), written by one thread of the
    // quad that owns the row; the backward forms the same P from them
    if (g.stats != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + warp * 16 + (lane >> 2) + 8 * half;
        if (row < g.Sq)
          g.stats[(size_t)(b * g.H + h) * g.Sq + row] = make_float2(mx[half], sum[half]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) sum[half] = 1.f / sum[half];
    // the accumulators of keys 16i..16i+15 are the A registers of k step i
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      pa[i][0] = pack_bf16(s[8 * i + 0] * sum[0], s[8 * i + 1] * sum[0]);
      pa[i][1] = pack_bf16(s[8 * i + 2] * sum[1], s[8 * i + 3] * sum[1]);
      pa[i][2] = pack_bf16(s[8 * i + 4] * sum[0], s[8 * i + 5] * sum[0]);
      pa[i][3] = pack_bf16(s[8 * i + 6] * sum[1], s[8 * i + 7] * sum[1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[i][e] = 0u;
  }

  // ---- O = P V: N / 16 k16 steps along the keys, V transposed on read;
  // a step is 16 rows of V, 2048 bytes ----
  float o[32];
  const uint64_t dv = wgmma_desc_sw128(vs, 16, 1024);
  mbar_wait(v_bar, ph);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < N / 16; ++i)
    wgmma_rs_n64_tb(o, pa[i], dv + (uint64_t)i * (2048 >> 4), i);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(o[i]);
#pragma unroll
  for (int i = 0; i < N / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(pa[i][e]);

  // ---- O into the group's swizzled staging tile, out by a TMA store
  // (rows past Sq clipped by the map) ----
  if (tid == 0) bulk_wait_read();        // the group's last store has read it
  named_barrier(1 + group, 128);
  const int r = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    store2(ostg + swizzled(r, 8 * j + c0), o[4 * j], o[4 * j + 1]);
    store2(ostg + swizzled(r + 8, 8 * j + c0), o[4 * j + 2], o[4 * j + 3]);
  }
  fence_async_shared();
  named_barrier(1 + group, 128);
  if (tid == 0) {
    tma_store_4d(omap, ostg, 0, row0, h, b);
    bulk_commit();
  }
}

// Persistent: block i takes heads i, i + gridDim.x, ... Warps 0-7 are two
// consumer warpgroups, warps 8-11 the producer group, one thread of which
// keeps the next head's Q, K and V loading into the other stage while the
// current one is used.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
attention_tma(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap omap, Geo g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_qk = reinterpret_cast<uint64_t*>(smem);  // Q and K landed
  uint64_t* full_v = full_qk + kStages;                   // V landed
  uint64_t* empty = full_v + kStages;
  unsigned char* stages = smem + 1024;
  const unsigned stage_bytes = g.q_bytes + 2 * g.kv_bytes;
  bf16* ostage = reinterpret_cast<bf16*>(stages + kStages * stage_bytes);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_qk[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kGroups * 4);     // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kGroups * 128) {
    // ---------------- producer group: one thread issues the loads --------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kGroups * 128) {
      int it = 0;
      for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++it) {
        const int st = it & 1;
        const unsigned ph = (it >> 1) & 1;
        const int b = item / g.H, h = item - b * g.H;
        unsigned char* buf = stages + st * stage_bytes;
        mbar_wait(&empty[st], ph ^ 1);
        // K and Q first: the scores need them, the products with V later
        mbar_arrive_expect_tx(&full_qk[st], g.q_bytes + g.kv_bytes);
        tma_load_4d(buf + g.q_bytes, &kmap, 0, 0, h, b, &full_qk[st]);
        tma_load_4d(buf, &qmap, 0, 0, h, b, &full_qk[st]);
        mbar_arrive_expect_tx(&full_v[st], g.kv_bytes);
        tma_load_4d(buf + g.q_bytes + g.kv_bytes, &vmap, 0, 0, h, b, &full_v[st]);
      }
    }
  } else {
    // ---------------- consumers: group q takes query tiles q, q + 2, ... --
    setmaxnreg_inc<kConsumerRegs>();
    const int group = threadIdx.x >> 7;
    bf16* ostg = ostage + group * kRows * kD;
    int it = 0;
    for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++it) {
      const int st = it & 1;
      const unsigned ph = (it >> 1) & 1;
      const int b = item / g.H, h = item - b * g.H;
      const unsigned char* buf = stages + st * stage_bytes;
      const bf16* qs = reinterpret_cast<const bf16*>(buf);
      const bf16* ks = reinterpret_cast<const bf16*>(buf + g.q_bytes);
      const bf16* vs = reinterpret_cast<const bf16*>(buf + g.q_bytes + g.kv_bytes);
      mbar_wait(&full_qk[st], ph);
      for (int qt = group; qt < g.nqt; qt += kGroups)
        tile<N>(qs + qt * kRows * kD, ks, vs, &full_v[st], ph, ostg, &omap,
                qt * kRows, b, h, g, group);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    }
    if ((threadIdx.x & 127) == 0) bulk_wait_all();
  }
}

template <int N>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           const CUtensorMap& om, const Geo& g, cudaStream_t st) {
  // once per instantiation: the largest shared memory any launch asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_tma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = g.items < num_sms() ? g.items : num_sms();
  attention_tma<N><<<grid, kThreads, smem_bytes(g.nqt, N), st>>>(qm, km, vm, om, g);
  return (int)cudaGetLastError();
}

}  // namespace tma

// ========================== bf16, short rows: persistent TMA ring + mma.sync

namespace shortkv {

constexpr int kMaxS = 64;                   // Sq and Sk: four 16-row tiles
constexpr int kWarps = 4;                   // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kMaxStages = 8;

struct Geo {
  int items, H, Sq, Sk;       // items = B * H heads
  int stages;                 // ring depth, <= kMaxStages
  unsigned q_bytes;           // a stage's Q box: round16(Sq) padded rows
  unsigned kv_bytes;          // its K box, and its V box: round16(Sk) rows
  float scale_log2;           // log2(e) / sqrt(D)
};

// Shared memory: 128 bytes of alignment slack, 128 for the barriers, the
// stages, and one 16-row staging tile per consumer warp.
inline size_t smem_bytes(int stages, unsigned stage_bytes, int D) {
  return 256 + (size_t)stages * stage_bytes + (size_t)kWarps * 16 * (D + 8) * 2;
}

// One 16-row query tile of a head, by one warp: S = Q K^T over all keys
// in registers, the softmax of each row in one pass, P V, and the rows out
// to o[b, row0 + r, h, :]. qs, ks and vs hold padded rows (D + 8 apart);
// rows past Sk are zeros.
template <int D, int NK>
__device__ __forceinline__ void tile(const bf16* qs, const bf16* ks, const bf16* vs,
                                     bf16* ostg, bf16* __restrict__ o, int b,
                                     int h, int row0, const Geo& g) {
  constexpr int LD = D + 8, KD = D / 16, NJ = 2 * NK;
  const int lane = threadIdx.x & 31;

  unsigned qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qa[kk], qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);

  // ---- S = Q K^T: n8 block j holds keys 8j + 2(lane % 4) + {0, 1} of rows
  // lane/4 (elements 0, 1) and lane/4 + 8 (2, 3) ----
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // ldmatrix x4 on K rows: matrix i = lane / 8 covers keys 8(i / 2)..+7 at
  // k offset 8(i % 2), the B fragments of a key tile's two n8 blocks
  const bf16* kp = ks + ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    unsigned kb[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(kb[kk], kp + t * 16 * LD + kk * 16);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      mma_bf16(s[2 * t], qa[kk], kb[kk][0], kb[kk][1]);
      mma_bf16(s[2 * t + 1], qa[kk], kb[kk][2], kb[kk][3]);
    }
  }

  // ---- softmax of rows r (e < 2) and r + 8 (e >= 2), in one pass: padded
  // keys, all in the last key tile, are -inf before the max ----
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = NJ - 2; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + c0 + (e & 1) >= g.Sk) s[j][e] = -INFINITY;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    mx[half] *= g.scale_log2;
  }
  // exp(x / sqrt(D) - max / sqrt(D)) as 2^(x c - max c), c = log2(e) / sqrt(D)
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[j][e], g.scale_log2, -mx[e >> 1]));
      s[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
    sum[half] = 1.f / sum[half];
  }

  // ---- O = P V: P normalised in fp32, then rounded to bf16 (the
  // accumulators of two n8 blocks are the A fragment of one k16 step); V
  // by ldmatrix x4.trans: lane l addresses key row l % 16 at column
  // 8 (l / 16), registers 0, 1 feed d-block 2jd and 2, 3 d-block 2jd + 1 ----
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bf16* vp = vs + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const unsigned pa[4] = {
        pack_bf16(s[2 * t][0] * sum[0], s[2 * t][1] * sum[0]),
        pack_bf16(s[2 * t][2] * sum[1], s[2 * t][3] * sum[1]),
        pack_bf16(s[2 * t + 1][0] * sum[0], s[2 * t + 1][1] * sum[0]),
        pack_bf16(s[2 * t + 1][2] * sum[1], s[2 * t + 1][3] * sum[1])};
    unsigned vb[KD][4];
#pragma unroll
    for (int jd = 0; jd < KD; ++jd) ldmatrix_x4_trans(vb[jd], vp + t * 16 * LD + jd * 16);
#pragma unroll
    for (int jd = 0; jd < KD; ++jd) {
      mma_bf16(acc[2 * jd], pa, vb[jd][0], vb[jd][1]);
      mma_bf16(acc[2 * jd + 1], pa, vb[jd][2], vb[jd][3]);
    }
  }

  // ---- out: through the warp's staging tile, 16-byte stores of the rows
  // below Sq to o[b, row0 + r, h, :] ([B, Sq, H, D]) ----
  const int r = lane >> 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    store2(ostg + r * LD + 8 * j + c0, acc[j][0], acc[j][1]);
    store2(ostg + (r + 8) * LD + 8 * j + c0, acc[j][2], acc[j][3]);
  }
  __syncwarp();
  const int rows = g.Sq - row0 < 16 ? g.Sq - row0 : 16;
  const long long orow = (long long)g.H * D;
  bf16* ob = o + ((long long)b * g.Sq + row0) * orow + (long long)h * D;
  constexpr int kVecs = D / 8;                 // 16-byte pieces of a row
  for (int e = lane; e < rows * kVecs; e += 32) {
    const int rr = e / kVecs, c = (e - rr * kVecs) * 8;
    *reinterpret_cast<uint4*>(ob + rr * orow + c) =
        *reinterpret_cast<const uint4*>(ostg + rr * LD + c);
  }
  __syncwarp();                    // the staging tile is free for the next
}

// Persistent: block i takes heads i, i + gridDim.x, ... in order; the
// block's n-th head lands in stage n % stages, and consumer warp n % 4
// takes it. Warp 4's first thread issues the loads.
// One block per SM (the grid is at most the SM count): __launch_bounds__'s
// second argument keeps ptxas from capping registers for occupancy, which
// spilled the D >= 112 single-key-tile instantiations at 64 registers.
template <int D, int NK>
__global__ void __launch_bounds__(kThreads, 1)
attention_short(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                bf16* __restrict__ o, Geo g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // tensor-map loads land 128-byte aligned; every stage and box keeps it
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);     // the head landed
  uint64_t* empty = full + kMaxStages;                    // its warp is done
  unsigned char* stages = smem + 128;
  const unsigned stage_bytes = g.q_bytes + 2 * g.kv_bytes;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---------------- producer: one thread, the ring's loads ----------------
    if (threadIdx.x == kWarps * 32) {
      int n = 0;
      for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++n) {
        const int st = n % g.stages;
        const unsigned ph = (n / g.stages) & 1;
        const int b = item / g.H, h = item - b * g.H;
        unsigned char* buf = stages + st * stage_bytes;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], stage_bytes);
        tma_load_4d(buf, &qmap, 0, 0, h, b, &full[st]);
        tma_load_4d(buf + g.q_bytes, &kmap, 0, 0, h, b, &full[st]);
        tma_load_4d(buf + g.q_bytes + g.kv_bytes, &vmap, 0, 0, h, b, &full[st]);
      }
    }
    return;
  }

  // ---------------- consumers: warp w takes the block's heads w, w + 4, ...
  constexpr int LD = D + 8;
  bf16* ostg = reinterpret_cast<bf16*>(stages + g.stages * stage_bytes) + warp * 16 * LD;
  const int nqt = (g.Sq + 15) >> 4;
  int n = warp;
  for (int item = blockIdx.x + warp * gridDim.x; item < g.items;
       item += kWarps * gridDim.x, n += kWarps) {
    const int st = n % g.stages;
    const unsigned ph = (n / g.stages) & 1;
    const int b = item / g.H, h = item - b * g.H;
    const unsigned char* buf = stages + st * stage_bytes;
    const bf16* qs = reinterpret_cast<const bf16*>(buf);
    const bf16* ks = reinterpret_cast<const bf16*>(buf + g.q_bytes);
    const bf16* vs = reinterpret_cast<const bf16*>(buf + g.q_bytes + g.kv_bytes);
    mbar_wait(&full[st], ph);
    for (int qt = 0; qt < nqt; ++qt)
      tile<D, NK>(qs + qt * 16 * LD, ks, vs, ostg, o, b, h, qt * 16, g);
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
  }
}

// A bf16 map over the heads of a [B, H, S, D] view (element strides of s,
// h and b; D contiguous) with no swizzle: boxes of D + 8 columns by
// box_rows rows, so rows land D + 8 elements apart in shared memory; the
// columns past D and the rows past S read as zeros. Returns false if
// cuTensorMapEncodeTiled refuses it.
inline bool make_padded_map(CUtensorMap* map, const void* p, int B, int H, int S,
                            int D, long long s_stride, long long h_stride,
                            long long b_stride, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_stride * 2, (cuuint64_t)h_stride * 2,
                                 (cuuint64_t)b_stride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D + 8, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NK>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           bf16* o, const Geo& g, int grid, size_t smem, cudaStream_t st) {
  // once per instantiation: the largest shared memory any launch asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_short<D, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  attention_short<D, NK><<<grid, kThreads, smem, st>>>(qm, km, vm, o, g);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
             bf16* o, const Geo& g, int grid, size_t smem, cudaStream_t st) {
  switch ((g.Sk + 15) / 16) {
    case 1: return launch<D, 1>(qm, km, vm, o, g, grid, smem, st);
    case 2: return launch<D, 2>(qm, km, vm, o, g, grid, smem, st);
    case 3: return launch<D, 3>(qm, km, vm, o, g, grid, smem, st);
    case 4: return launch<D, 4>(qm, km, vm, o, g, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace shortkv

// =================================================================== fp32

constexpr int kWarps32 = 8;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row stride of K and V in shared memory, in elements: D plus one word,
// which makes the stride an odd number of words.
__host__ __device__ inline int padded_row32(int D) { return D + 1; }

__global__ void __launch_bounds__(kWarps32 * 32)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Sk = g.Sk, D = g.D, ld = padded_row32(D);
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + (size_t)Sk * ld;
  float* qs = vs + (size_t)Sk * ld;                    // [kWarps32][D]
  float* ps = qs + kWarps32 * D;                       // [kWarps32][Sk]

  const int bh = blockIdx.x, b = bh / g.H, h = bh - b * g.H;
  const float* kh = k + b * g.k0 + h * g.k1;
  const float* vh = v + b * g.v0 + h * g.v1;
  const float* qh = q + b * g.q0 + h * g.q1;
  const long long out_row = (long long)g.H * D;        // o is [B, Sq, H, D]
  float* oh = o + (long long)b * g.Sq * out_row + (long long)h * D;

  for (int i = threadIdx.x; i < Sk * D; i += blockDim.x) {
    int r = i / D, c = i - r * D;
    ks[r * ld + c] = kh[r * g.k2 + c];
    vs[r * ld + c] = vh[r * g.v2 + c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qs + warp * D;
  float* pw = ps + warp * Sk;

  for (int row = warp; row < g.Sq; row += kWarps32) {
    for (int d = lane; d < D; d += 32) qw[d] = qh[row * g.q2 + d];
    __syncwarp();

    // scores: lane owns keys lane, lane+32, ...
    float sc[kMaxSk / 32];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxSk / 32; ++t) {
      int j = lane + 32 * t;
      float s = -INFINITY;
      if (j < Sk) {
        const float* kr = ks + j * ld;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qw[d], kr[d], acc);
        s = acc * g.scale;
      }
      sc[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxSk / 32; ++t) {
      int j = lane + 32 * t;
      float e = j < Sk ? expf(sc[t] - m) : 0.f;
      sc[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kMaxSk / 32; ++t) {
      int j = lane + 32 * t;
      if (j < Sk) pw[j] = sc[t] / sum;
    }
    __syncwarp();

    // P.V: lane owns features lane, lane+32, ...
    float acc[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) acc[i] = 0.f;
    for (int j = 0; j < Sk; ++j) {
      float p = pw[j];
      const float* vr = vs + j * ld;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(p, vr[d], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      int d = lane + 32 * i;
      if (d < D) oh[row * out_row + d] = acc[i];
    }
    __syncwarp();
  }
}

size_t smem_f32(int Sk, int D) {
  return ((size_t)2 * Sk * padded_row32(D) + (size_t)kWarps32 * (D + Sk)) * 4;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B,H,Sq,D], k/v [B,H,Sk,D] given by
// their element strides over (b, h, s), the last dimension contiguous; o is
// a contiguous [B,Sq,H,D]. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Sq, int Sk, int D,
                                 long long q0, long long q1, long long q2,
                                 long long k0, long long k1, long long k2,
                                 long long v0, long long v1, long long v2,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geo g{B, H, Sq, Sk, D, q0, q1, q2, k0, k1, k2, v0, v1, v2,
        1.0f / sqrtf((float)D), 1, 0};
  if (dtype == 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    attention_f32<<<B * H, kWarps32 * 32, smem_f32(Sk, D), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), g);
    return (int)cudaGetLastError();
  }
  // once per instantiation: the largest shared memory any launch asks for
  static const cudaError_t attr64 = cudaFuncSetAttribute(
      attention_bf16<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  static const cudaError_t attr128 = cudaFuncSetAttribute(
      attention_bf16<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr64 != cudaSuccess) return (int)attr64;
  if (attr128 != cudaSuccess) return (int)attr128;
  // 16-byte copies where every row of q, k and v starts 16-byte aligned
  bool vec16 = true;
  for (const void* p : {q, k, v}) vec16 &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : {q0, q1, q2, k0, k1, k2, v0, v1, v2}) vec16 &= (s * 2) % 16 == 0;
  g.vec16 = vec16;
  // one head per block, a warp per 16 query rows, up to 8 warps sharing the
  // head's staged K and V
  const int nqt = (Sq + 15) / 16;
  g.qt = nqt < kMaxWarps ? nqt : kMaxWarps;
  dim3 grid(B * H, (nqt + g.qt - 1) / g.qt);
  const size_t smem = smem_bf16(g.qt, Sk, D);
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  if (D <= 64)
    attention_bf16<64><<<grid, g.qt * 32, smem, st>>>(qq, kk, vv, oo, g);
  else
    attention_bf16<128><<<grid, g.qt * 32, smem, st>>>(qq, kk, vv, oo, g);
  return (int)cudaGetLastError();
}


// The long-row bf16 route (TMA + wgmma): D = 64, 64 <= Sk <= 256,
// 1 <= Sq <= 256, every base address and stride of q, k and v a multiple
// of 16 bytes (checked by the Python wrapper, which routes). Arguments as
// attention_forward's, then stats: null, or a contiguous fp32 [B,H,Sq,2]
// that gets each row's statistics (the backward's): the max of its scores
// q.k^T times log2(e) / sqrt(D), m, and the sum of 2^(s log2(e) / sqrt(D)
// - m) over its keys, so that P = 2^(...) / sum and the row's log-sum-exp
// is (m + log2 sum) ln 2; dtype must be 1.
extern "C" int attention_forward_tma(const void* q, const void* k, const void* v,
                                     void* o, int B, int H, int Sq, int Sk, int D,
                                     long long q0, long long q1, long long q2,
                                     long long k0, long long k1, long long k2,
                                     long long v0, long long v1, long long v2,
                                     int dtype, void* stream, void* stats) {
  if (dtype != 1 || D != tma::kD || Sq < 1 || Sq > tma::kMaxS || Sk < 64 ||
      Sk > tma::kMaxS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = round16(Sk), nqt = (Sq + tma::kRows - 1) / tma::kRows;
  const long long orow = (long long)H * D;            // o is [B, Sq, H, D]
  CUtensorMap qm, km, vm, om;
  if (!make_head_map(&qm, q, B, H, Sq, q2, q1, q0, nqt * tma::kRows) ||
      !make_head_map(&km, k, B, H, Sk, k2, k1, k0, N) ||
      !make_head_map(&vm, v, B, H, Sk, v2, v1, v0, N) ||
      !make_head_map(&om, o, B, H, Sq, orow, D, (long long)Sq * orow,
                     tma::kRows))
    return (int)cudaErrorInvalidValue;
  const tma::Geo g{B * H, H, Sq, Sk, nqt,
                   (unsigned)(nqt * tma::kTileBytes), (unsigned)(N * tma::kD * 2),
                   1.4426950408889634f / sqrtf((float)D), static_cast<float2*>(stats)};
  switch (N) {
    case 64: return tma::launch<64>(qm, km, vm, om, g, st);
    case 80: return tma::launch<80>(qm, km, vm, om, g, st);
    case 96: return tma::launch<96>(qm, km, vm, om, g, st);
    case 112: return tma::launch<112>(qm, km, vm, om, g, st);
    case 128: return tma::launch<128>(qm, km, vm, om, g, st);
    case 144: return tma::launch<144>(qm, km, vm, om, g, st);
    case 160: return tma::launch<160>(qm, km, vm, om, g, st);
    case 176: return tma::launch<176>(qm, km, vm, om, g, st);
    case 192: return tma::launch<192>(qm, km, vm, om, g, st);
    case 208: return tma::launch<208>(qm, km, vm, om, g, st);
    case 224: return tma::launch<224>(qm, km, vm, om, g, st);
    case 240: return tma::launch<240>(qm, km, vm, om, g, st);
    case 256: return tma::launch<256>(qm, km, vm, om, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The short-row bf16 route (persistent TMA ring + mma.sync): 1 <= Sq, Sk
// <= 64, D a multiple of 16 up to 128, every base address and stride of q,
// k and v a multiple of 16 bytes (checked by the Python wrapper, which
// routes). Arguments as attention_forward's; dtype must be 1.
extern "C" int attention_forward_short(const void* q, const void* k, const void* v,
                                       void* o, int B, int H, int Sq, int Sk, int D,
                                       long long q0, long long q1, long long q2,
                                       long long k0, long long k1, long long k2,
                                       long long v0, long long v1, long long v2,
                                       int dtype, void* stream) {
  if (dtype != 1 || B < 1 || H < 1 || Sq < 1 || Sq > shortkv::kMaxS || Sk < 1 ||
      Sk > shortkv::kMaxS || D < 16 || D > kMaxD || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Rq = round16(Sq), Rk = round16(Sk);
  CUtensorMap qm, km, vm;
  if (!shortkv::make_padded_map(&qm, q, B, H, Sq, D, q2, q1, q0, Rq) ||
      !shortkv::make_padded_map(&km, k, B, H, Sk, D, k2, k1, k0, Rk) ||
      !shortkv::make_padded_map(&vm, v, B, H, Sk, D, v2, v1, v0, Rk))
    return (int)cudaErrorInvalidValue;
  const unsigned row_bytes = (unsigned)(D + 8) * 2;
  shortkv::Geo g{B * H, H, Sq, Sk, 1, Rq * row_bytes, Rk * row_bytes,
                 1.4426950408889634f / sqrtf((float)D)};
  const unsigned stage_bytes = g.q_bytes + 2 * g.kv_bytes;
  const int grid = g.items < num_sms() ? g.items : num_sms();
  // as many stages as fit, up to 8, and no more than a block has heads
  const int per_block = (g.items + grid - 1) / grid;
  const size_t room = kMaxSmem - shortkv::smem_bytes(0, stage_bytes, D);
  int stages = (int)(room / stage_bytes);
  stages = stages < shortkv::kMaxStages ? stages : shortkv::kMaxStages;
  stages = stages < per_block ? stages : per_block;
  if (stages < 1) return (int)cudaErrorInvalidValue;
  g.stages = stages;
  const size_t smem = shortkv::smem_bytes(stages, stage_bytes, D);
  bf16* oo = static_cast<bf16*>(o);
  switch (D) {
    case 16: return shortkv::launch_d<16>(qm, km, vm, oo, g, grid, smem, st);
    case 32: return shortkv::launch_d<32>(qm, km, vm, oo, g, grid, smem, st);
    case 48: return shortkv::launch_d<48>(qm, km, vm, oo, g, grid, smem, st);
    case 64: return shortkv::launch_d<64>(qm, km, vm, oo, g, grid, smem, st);
    case 80: return shortkv::launch_d<80>(qm, km, vm, oo, g, grid, smem, st);
    case 96: return shortkv::launch_d<96>(qm, km, vm, oo, g, grid, smem, st);
    case 112: return shortkv::launch_d<112>(qm, km, vm, oo, g, grid, smem, st);
    case 128: return shortkv::launch_d<128>(qm, km, vm, oo, g, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
