// Unmasked scaled dot-product attention over strided [B, H, S, D] views.
//
// Replaces the Pallas TPU kernel `_attention_kernel`
// (t5_resnet_vqa_tpu/ops/pallas/attention.py:56, launched by
// `fused_attention` at :108). Same math: fp32 scores = q.k^T * (1/sqrt(D)),
// row softmax in fp32, probabilities normalised in fp32 and only then
// rounded to the value dtype, P.V accumulated in fp32, output cast to the
// query dtype.
//
// What bounds it on an H100: bytes. At the SGA geometry (H=8, D=96, Sq=16,
// Sk<=64) each head does 2*Sq*Sk*D*2 FLOPs on (Sq + 2*Sk + Sq)*D elements,
// about 16 FLOPs per byte, far below the ~295 FLOPs/byte at which the
// tensor cores become the limit. So everything that is not an input or an
// output stays on chip, and the inputs are read in place: q, k and v may be
// the strided head views of a [B, S, H*D] projection (D contiguous), and the
// output is written in [B, Sq, H, D] order, so the caller's head split and
// merge cost no copies.
//
// bf16 (the main path): tensor cores through mma.sync m16n8k16.
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
//    one-warp blocks (512 at B=64, H=8), ViT (S = 197) two blocks a head.
//    Each key tile's fragments are all loaded before its products, so the
//    shared-memory latencies overlap; register arrays are sized for D up
//    to 64 or up to 128 (two instantiations).
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
