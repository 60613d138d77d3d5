// One frozen ResNet-50 bottleneck block, fused, NHWC.
//
// Replaces the Pallas TPU kernel `_block_kernel`
// (t5_resnet_vqa_tpu/ops/pallas/bottleneck.py:84, launched by
// `_fused_block_call` at :164 and entered through `fused_bottleneck` at
// :180). Same math, with BatchNorm folded into the weights by the caller:
//   t1  = relu(x @ w1 + b1)                       1x1, stride 1
//   t2  = relu(im2col3x3(t1, stride) @ w2 + b2)   3x3 carries the stride
//   y   = t2 @ w3 + b3
//   idn = x[::s, ::s] @ wd + bd   (downsample)  or  x   (identity)
//   out = relu(y + idn)
// Products take the activation dtype and accumulate in fp32; bias, ReLU and
// the residual add are fp32 in the epilogues, then cast to the activation
// dtype.
//
// What bounds it on an H100: bytes. A stride-1 block of stage 0 does about
// 140 FLOPs per byte of its input and output, below the ~295 FLOPs/byte at
// which the bf16 tensor cores become the limit, so the unfused chain (each
// conv reads its input from and writes its output to device memory) is
// limited by memory traffic. Both paths below keep t1 and t2 out of device
// memory: a thread block owns a tile of output pixels of one image with all
// output channels, recomputes t1 on the tile's halo ((TH-1)*s+3 x
// (TW-1)*s+3 pixels) into shared memory, and keeps t2 there.
//
// bf16 (the main path): tensor cores through mma.sync m16n8k16.
//  * Tiles of 8x16 = 128 output pixels at stride 1 (4x16 at stride 2, whose
//    17x33 halo of a 128-pixel tile would not fit beside the ring). Each
//    streamed weight chunk then serves twice the pixels of a 64-pixel tile,
//    and the halo costs 180 rows for 128 outputs instead of 108 (padded to
//    128) for 64.
//  * Weights are packed on the host (ops/bottleneck.py, pack_operands) into
//    64-row chunks in the exact shared-memory order the warps read: rows of
//    N + 8 elements, the 8 zeros keeping ldmatrix free of bank conflicts.
//    So each chunk is one contiguous cp.async.bulk.
//  * Input pixels arrive by tensor-map (TMA) loads, one per chunk: the halo
//    as a box of 64 channels x halo width x halo rows, image borders filled
//    with zeros by the map; the downsample's x[::s, ::s] through a second
//    map whose strides skip pixels. Both use the 128-byte swizzle, which
//    the ldmatrix addresses undo. (One 128-byte copy per pixel row, the
//    first form of this design, left the stride-2 block waiting on copies.)
//  * One producer thread keeps a ring of 3-4 stages in flight through
//    full/empty mbarriers; eight consumer warps run the products and never
//    wait on a whole-block barrier for a chunk. A named barrier over the
//    consumers orders t1 and t2 between the three convolutions.
//  * conv3 leaves through shared memory: each 128-channel slice of the
//    tile is summed into a swizzled staging tile and written by tensor-map
//    stores, which clip partial tiles; an identity block's x arrives in the
//    same staging tile by tensor-map loads issued before the products.
//    (Per-thread 4-byte stores of 8 scattered rows, the first form, took a
//    third of the kernel's time.) Epilogues load their biases before their
//    first store, so the loads' latencies overlap.
//  * Persistent blocks: one block per SM walks output tiles, so the
//    producer streams the next tile's first chunks under the current
//    tile's last products and epilogue.
//  * Warp tiles: conv1 runs up to 192 halo rows per pass (48 rows x N/2
//    columns a warp), conv2 and conv3 32 rows x N/2 (N/4 at stride 2).
//  Whole-block weight residency (no re-streaming at all) was not chosen:
//  stage 0's padded weights take 160 KB, which leaves too little beside
//  t1, the staging tile and the input ring at 128-pixel tiles, and stage
//  1's (557-754 KB) never fit. The ring instead reads each weight chunk
//  from L2 once per tile.
//
// fp32 (a check path, not the main path): CUDA-core FMAs on 4x16 tiles,
// weights unpacked and staged with cp.async through one buffer.
//
// Limits (checked by the Python wrapper): Cin % 64 == 0, Cw in {64, 128},
// Cout % 128 == 0, H and W divisible by the stride.

#include <cuda.h>

#include "sm90_common.cuh"

using namespace sm90;

namespace {

constexpr int KC = 64;                  // K rows per chunk
constexpr int NMAX = 128;               // output channels per conv3 pass
constexpr int kPad = 8;                 // elements added to every shared row
constexpr int kMaxSmem = 232448;        // H100: one block's dynamic shared memory

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~(size_t)127; }

// =================================================================== bf16

using bf16 = __nv_bfloat16;

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreadsBf16 = kConsumers + 32;     // + one producer warp
constexpr int M1 = 192;                           // rows of a conv1 pass
constexpr int kABytes = M1 * KC * 2;              // 24576: input rows, 128 B each
constexpr int kWBytes = KC * (NMAX + kPad) * 2;   // 17408
constexpr int kStageBytes = kABytes + kWBytes;    // a multiple of 1024
constexpr int kBarBytes = 128;

__host__ __device__ inline size_t align1024(size_t n) { return (n + 1023) & ~(size_t)1023; }

template <int S> struct Cfg {
  static constexpr int TH = S == 1 ? 8 : 4, TW = 16, TM = TH * TW;
  static constexpr int HH = (TH - 1) * S + 3, HW = (TW - 1) * S + 3;
  static constexpr int HALO = HH * HW;
  // conv1 passes: boxes of BOXH whole halo rows, at most M1 pixels each
  static constexpr int BOXH = S == 1 ? HH : 5;
  static constexpr int PASS_ROWS = BOXH * HW;      // 180 or 165
  static constexpr int PASSES = (HH + BOXH - 1) / BOXH;
  static constexpr int WC = S == 1 ? 2 : 4;     // column groups, conv2/conv3
  static constexpr int OUT_BYTES = TM * NMAX * 2;  // output staging
  // shared memory: barriers and t1, the output staging, then the ring
  __host__ __device__ static size_t t1_end(int Cw) {
    return align1024(kBarBytes + (size_t)HALO * (Cw + kPad) * 2);
  }
  __host__ __device__ static size_t ring_start(int Cw) {
    return t1_end(Cw) + OUT_BYTES;
  }
  static int stages(int Cw) {    // as deep as fits, at most 4
    const size_t room = kMaxSmem - 1024 - ring_start(Cw);
    const size_t n = room / kStageBytes;
    return n < 4 ? (int)n : 4;
  }
  static size_t smem(int Cw) {   // + 1024: the base is aligned at run time
    return 1024 + ring_start(Cw) + (size_t)stages(Cw) * kStageBytes;
  }
};
static_assert(Cfg<1>::PASS_ROWS <= M1 && Cfg<2>::PASS_ROWS <= M1, "conv1 pass");

struct Geo {
  int H, W, Cin, Cw, Cout, Ho, Wo, has_ds, tiles_w, tiles_img, tiles, stages;
};

// The [rows, N] product of one warp group layout, summed over K-chunks.
// 8 warps as WR = 8 / WC row groups of MT m16 tiles and WC column groups of
// N / WC columns (nt = N / (8 WC) n8 tiles, at most NTMAX).
template <int MT, int WC> struct MmaTile {
  static constexpr int WR = kConsumerWarps / WC, NTMAX = NMAX / (8 * WC);
  float c[MT][NTMAX][4];
  int row0, col0, nt;

  __device__ void zero(int N) {
    const int w = threadIdx.x >> 5;
    row0 = (w % WR) * MT * 16;
    col0 = (w / WR) * (N / WC);
    nt = N / (8 * WC);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTMAX; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
  }
  // Add one K-chunk: a_row(m) points at row m (k = 0) of A in shared memory;
  // b is a [KC][ldb] weight chunk. SWZ: A rows are 128 bytes whose 16-byte
  // pieces the tensor map's 128-byte swizzle permuted (piece j of row m at
  // j ^ (m % 8)); otherwise rows are padded and unpermuted. Rows at or past
  // rows_valid are not needed by the caller, so a warp whose rows all lie
  // there skips the chunk.
  template <bool SWZ, typename RowPtr>
  __device__ void mma(RowPtr a_row, const bf16* b, int ldb, int rows_valid) {
    if (row0 >= rows_valid) return;
    const int lane = threadIdx.x & 31, hi = lane >> 4;
    // ldmatrix x4: lane l addresses row (l & 15) at k offset 8 * (l >> 4);
    // row0 is a multiple of 16, so the row's m % 8 is l % 8
    const bf16* ap[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) ap[i] = a_row(row0 + i * 16 + (lane & 15));
    // x4.trans of a [16 k][16 n] block: lane l addresses k row (l & 15) at
    // column 8 * (l >> 4); registers 0,1 feed n-tile 2j, 2,3 n-tile 2j+1
    const bf16* bp = b + (lane & 15) * ldb + col0 + hi * 8;
#pragma unroll
    for (int k = 0; k < KC; k += 16) {
      const int piece = SWZ ? (((k >> 3) + hi) ^ (lane & 7)) : (k >> 3) + hi;
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], ap[i] + piece * 8);
#pragma unroll
      for (int j = 0; j < NTMAX / 2; ++j) {
        if (2 * j < nt) {
          unsigned bb[4];
          ldmatrix_x4_trans(bb, bp + k * ldb + j * 16);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(c[i][2 * j], a[i], bb[0], bb[1]);
            mma_bf16(c[i][2 * j + 1], a[i], bb[2], bb[3]);
          }
        }
      }
    }
  }
  // f(row, col, a, b) for every pair of adjacent columns the thread owns,
  // with a, b = the products + bias[col], bias[col + 1] (+ bias2 where
  // given). The biases are all loaded before the first f, so their
  // latencies overlap instead of queueing behind f's stores.
  template <typename F>
  __device__ void epilogue(const float* bias, const float* bias2, F f) {
    const int lane = threadIdx.x & 31;
    float2 bv[NTMAX];
#pragma unroll
    for (int j = 0; j < NTMAX; ++j) {
      if (j < nt) {
        const int col = col0 + j * 8 + (lane & 3) * 2;
        bv[j] = load2(bias + col);
        if (bias2 != nullptr) {
          const float2 b2 = load2(bias2 + col);
          bv[j].x += b2.x;
          bv[j].y += b2.y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = row0 + i * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < NTMAX; ++j) {
        if (j < nt) {
          const int col = col0 + j * 8 + (lane & 3) * 2;
          f(row, col, c[i][j][0] + bv[j].x, c[i][j][1] + bv[j].y);
          f(row + 8, col, c[i][j][2] + bv[j].x, c[i][j][3] + bv[j].y);
        }
      }
    }
  }
};

template <int S>
__global__ void __launch_bounds__(kThreadsBf16, 1)
bottleneck_bf16(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap dsmap,
                const __grid_constant__ CUtensorMap omap,
                const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, const bf16* __restrict__ w3,
                const float* __restrict__ b3, const bf16* __restrict__ wd,
                const float* __restrict__ bd, Geo g) {
  using C = Cfg<S>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle of the input rows needs 1024-byte aligned buffers
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + g.stages;
  uint64_t* idn_bar = empty + g.stages;     // the identity's arrival
  const int Cw = g.Cw, LT = Cw + kPad;
  bf16* t1 = reinterpret_cast<bf16*>(smem + kBarBytes);     // [HALO][LT]
  bf16* t2 = t1;                            // [TM][LT], once conv2 is done
  // [2][TM][64]: an output tile of 128 channels, two swizzled halves
  bf16* ostage = reinterpret_cast<bf16*>(smem + C::t1_end(Cw));
  unsigned char* ring = smem + C::ring_start(Cw);
  auto abuf = [&](int st) { return reinterpret_cast<bf16*>(ring + st * kStageBytes); };
  auto wbuf = [&](int st) {
    return reinterpret_cast<bf16*>(ring + st * kStageBytes + kABytes);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(idn_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int kci = g.Cin / KC, kcw = Cw / KC, ncs = g.Cout / NMAX;
  int st = 0;
  unsigned ph = 0;

  if (warp == kConsumerWarps) {
    // ---------------- producer (one thread): the consumers' chunk order ----
    if (lane != 0) return;
    const unsigned w_small = KC * LT * 2;              // a w1 / w2 chunk
    const unsigned w_big = KC * (NMAX + kPad) * 2;     // a w3 / wd chunk
    const unsigned halo_box = KC * C::PASS_ROWS * 2;   // 64 channels
    const unsigned ds_box = KC * C::TM * 2;
    // one chunk: a weight chunk and, with a map, an input box at (c, w, h, b)
    auto produce = [&](const bf16* wsrc, unsigned wbytes, const CUtensorMap* map,
                       int c, int w, int h, int b, unsigned abytes) {
      mbar_wait(&empty[st], ph ^ 1);
      mbar_arrive_expect_tx(&full[st], wbytes + abytes);
      bulk_copy_g2s(wbuf(st), wsrc, wbytes, &full[st]);
      if (map != nullptr) tma_load_4d(abuf(st), map, c, w, h, b, &full[st]);
      if (++st == g.stages) { st = 0; ph ^= 1; }
    };
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      const int b = tile / g.tiles_img, t = tile - b * g.tiles_img;
      const int oh0 = (t / g.tiles_w) * C::TH, ow0 = (t % g.tiles_w) * C::TW;
      const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;
      for (int p = 0; p < C::PASSES; ++p)
        for (int c = 0; c < kci; ++c)
          produce(w1 + (size_t)c * KC * LT, w_small, &xmap, c * KC, iw0,
                  ih0 + p * C::BOXH, b, halo_box);
      for (int q = 0; q < 9 * kcw; ++q)
        produce(w2 + (size_t)q * KC * LT, w_small, nullptr, 0, 0, 0, 0, 0);
      for (int nc = 0; nc < ncs; ++nc) {
        for (int c = 0; c < kcw; ++c)
          produce(w3 + (size_t)(nc * kcw + c) * KC * (NMAX + kPad), w_big,
                  nullptr, 0, 0, 0, 0, 0);
        if (g.has_ds)
          for (int c = 0; c < kci; ++c)
            produce(wd + (size_t)(nc * kci + c) * KC * (NMAX + kPad), w_big,
                    &dsmap, c * KC, ow0, oh0, b, ds_box);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  auto acquire = [&]() { mbar_wait(&full[st], ph); return st; };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == g.stages) { st = 0; ph ^= 1; }
  };
  MmaTile<3, 2> acc1;              // conv1: 4 x 48 rows = one 192-row pass
  MmaTile<2, C::WC> acc;           // conv2, conv3: TM rows
  unsigned idn_ph = 0;

  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int b = tile / g.tiles_img, t = tile - b * g.tiles_img;
    const int oh0 = (t / g.tiles_w) * C::TH, ow0 = (t % g.tiles_w) * C::TW;
    const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;

    // ---- conv1 (1x1) + bias + ReLU on the halo; zero outside the image ----
    for (int p = 0; p < C::PASSES; ++p) {
      acc1.zero(Cw);
      for (int c = 0; c < kci; ++c) {
        const int s = acquire();
        const bf16* a = abuf(s);
        acc1.mma<true>([&](int m) { return a + m * KC; }, wbuf(s), LT,
                       C::HALO - p * C::PASS_ROWS);
        release();
      }
      // the previous tile's conv3 has read t2, which t1 overwrites
      if (p == 0) named_barrier(1, kConsumers);
      acc1.epilogue(b1, nullptr, [&](int r, int n, float v0, float v1) {
        const int idx = p * C::PASS_ROWS + r;
        if (r >= C::PASS_ROWS || idx >= C::HALO) return;
        const int ih = ih0 + idx / C::HW, iw = iw0 + idx % C::HW;
        const bool inside = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
        store2(t1 + (size_t)idx * LT + n, inside ? fmaxf(v0, 0.f) : 0.f,
               inside ? fmaxf(v1, 0.f) : 0.f);
      });
    }
    named_barrier(1, kConsumers);

    // ---- conv2 (3x3, stride S) + bias + ReLU: 9 taps read t1 in place ----
    // output pixel m = (m / TW, m % TW) of the tile reads halo pixel
    // (S * (m / TW) + di, S * (m % TW) + dj)
    acc.zero(Cw);
    for (int q = 0; q < 9 * kcw; ++q) {
      const int s = acquire();
      const int tap = q / kcw, kc = (q - tap * kcw) * KC;
      const int di = tap / 3, dj = tap - 3 * di;
      const bf16* base = t1 + (size_t)(di * C::HW + dj) * LT + kc;
      acc.mma<false>([&](int m) {
        return base + (size_t)((m / C::TW) * S * C::HW + (m % C::TW) * S) * LT;
      }, wbuf(s), LT, C::TM);
      release();
    }
    named_barrier(1, kConsumers);      // every warp is past its reads of t1
    acc.epilogue(b2, nullptr, [&](int r, int n, float v0, float v1) {
      store2(t2 + (size_t)r * LT + n, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
    named_barrier(1, kConsumers);

    // ---- conv3 (1x1) [+ strided 1x1 downsample] + residual + ReLU ----
    // Per 128 output channels: the sum goes to the staging tile, which two
    // tensor-map stores write out (partial tiles clipped by the map). For
    // an identity block the staging first receives x at the output pixels
    // by tensor-map loads, issued before the products so they arrive under
    // them. One thread (consumer 0) drives the bulk copies.
    const bool leader = threadIdx.x == 0;
    for (int nc = 0; nc < ncs; ++nc) {
      const int c0 = nc * NMAX;
      if (leader) {
        bulk_wait_read();                  // the last tile's stores are out
        if (!g.has_ds) {
          mbar_arrive_expect_tx(idn_bar, C::OUT_BYTES);
          for (int h = 0; h < 2; ++h)
            tma_load_4d(ostage + h * C::TM * 64, &dsmap, c0 + h * 64, ow0, oh0, b,
                        idn_bar);
        }
      }
      acc.zero(NMAX);
      for (int c = 0; c < kcw; ++c) {
        const int s = acquire();
        const bf16* base = t2 + c * KC;
        acc.mma<false>([&](int m) { return base + (size_t)m * LT; }, wbuf(s),
                       NMAX + kPad, C::TM);
        release();
      }
      if (g.has_ds)
        for (int c = 0; c < kci; ++c) {
          const int s = acquire();
          const bf16* a = abuf(s);
          acc.mma<true>([&](int m) { return a + m * KC; }, wbuf(s), NMAX + kPad,
                        C::TM);
          release();
        }
      if (g.has_ds) {
        named_barrier(1, kConsumers);      // the leader's wait is done
      } else {
        mbar_wait(idn_bar, idn_ph);
        idn_ph ^= 1;
      }
      acc.epilogue(b3 + c0, g.has_ds ? bd + c0 : nullptr,
                   [&](int r, int n, float v0, float v1) {
        bf16* o = ostage + (n >> 6) * C::TM * 64 + swizzled(r, n & 63);
        if (!g.has_ds) {
          const float2 idn = load2(o);
          v0 += idn.x;
          v1 += idn.y;
        }
        store2(o, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      });
      fence_async_shared();
      named_barrier(1, kConsumers);
      if (leader) {
        for (int h = 0; h < 2; ++h)
          tma_store_4d(&omap, ostage + h * C::TM * 64, c0 + h * 64, ow0, oh0, b);
        bulk_commit();
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// A bf16 map over pixels of x [B, H, W, C] (NHWC), every `step`-th row and
// column, in boxes of 64 channels x box_w x box_h pixels with the 128-byte
// swizzle. Returns false if the driver refuses it.
bool make_map(CUtensorMap* map, const void* x, int B, int H, int W, int C,
              int step, int box_w, int box_h) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)(W / step),
                              (cuuint64_t)(H / step), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2 * step,
                                 (cuuint64_t)W * C * 2 * step,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)KC, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int S>
int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* w3, const void* b3, const void* wd,
                const void* bd, void* out, int B, int H, int W, int Cin, int Cw,
                int Cout, int has_ds, cudaStream_t stream) {
  using C = Cfg<S>;
  // once per instantiation: the largest shared memory any launch asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      bottleneck_bf16<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap xmap, dsmap, omap;
  if (!make_map(&xmap, x, B, H, W, Cin, 1, C::HW, C::BOXH) ||
      !make_map(&dsmap, x, B, H, W, Cin, S, C::TW, C::TH) ||
      !make_map(&omap, out, B, H / S, W / S, Cout, 1, C::TW, C::TH))
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.H = H; g.W = W; g.Cin = Cin; g.Cw = Cw; g.Cout = Cout;
  g.Ho = H / S; g.Wo = W / S; g.has_ds = has_ds; g.stages = C::stages(Cw);
  g.tiles_w = (g.Wo + C::TW - 1) / C::TW;
  g.tiles_img = ((g.Ho + C::TH - 1) / C::TH) * g.tiles_w;
  g.tiles = B * g.tiles_img;
  const int grid = g.tiles < num_sms() ? g.tiles : num_sms();
  bottleneck_bf16<S><<<grid, kThreadsBf16, C::smem(Cw), stream>>>(
      xmap, dsmap, omap, static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<const bf16*>(wd),
      static_cast<const float*>(bd), g);
  return (int)cudaGetLastError();
}

// =================================================================== fp32

constexpr int kThreadsF32 = 256;
constexpr int TH32 = 4, TW32 = 16, TM32 = TH32 * TW32;   // 64-pixel tile
constexpr int kLdA32 = KC + kPad;
constexpr int kLdW32 = NMAX + kPad;

// CUDA-core FMAs. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// 4ty..4ty+3 and the column pairs 2tx + 32j, j < N / 32.
struct AccF32 {
  float a[4][8];
  int np;

  __device__ void zero(int N) {
    np = N / 32;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
  }
  template <typename RowPtr>
  __device__ void mma(RowPtr a_row, const float* b) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const float* rows[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) rows[i] = a_row(4 * ty + i);
    for (int k = 0; k < KC; ++k) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = rows[i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < np) {
          float2 bv = load2(b + k * kLdW32 + 2 * tx + 32 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i][2 * j] = fmaf(av[i], bv.x, a[i][2 * j]);
            a[i][2 * j + 1] = fmaf(av[i], bv.y, a[i][2 * j + 1]);
          }
        }
      }
    }
  }
  template <typename F> __device__ void epilogue(F f) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < np) f(4 * ty + i, 2 * tx + 32 * j, a[i][2 * j], a[i][2 * j + 1]);
  }
};

// Stage an A chunk [TM32][KC] (row stride kLdA32) from pixel rows of x; a
// null row is zero-filled.
template <typename RowPtr>
__device__ void stage_a(float* dst, RowPtr row_ptr, const float* any_valid) {
  constexpr int vpr = KC / 4;
  for (int e = threadIdx.x; e < TM32 * vpr; e += kThreadsF32) {
    int r = e / vpr, v = e - r * vpr;
    const float* src = row_ptr(r);
    cp_async16(dst + r * kLdA32 + v * 4, src != nullptr ? src + v * 4 : any_valid,
               src != nullptr ? 16 : 0);
  }
}

// Stage a weight chunk [KC][cols] (row stride kLdW32) from rows src_ld apart.
__device__ void stage_w(float* dst, const float* src, int cols, int src_ld) {
  const int vpr = cols / 4;
  for (int e = threadIdx.x; e < KC * vpr; e += kThreadsF32) {
    int r = e / vpr, v = e - r * vpr;
    cp_async16(dst + r * kLdW32 + v * 4, src + (size_t)r * src_ld + v * 4, 16);
  }
}

// Run n K-chunks through one staging buffer: stage(c) issues chunk c's
// copies, compute(c) adds its products.
template <typename Stage, typename Compute>
__device__ void pipeline(int n, Stage stage, Compute compute) {
  for (int c = 0; c < n; ++c) {
    stage(c);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    compute(c);
    __syncthreads();
  }
}

constexpr size_t kA32Bytes = TM32 * kLdA32 * 4;
constexpr size_t kW32Bytes = KC * kLdW32 * 4;

size_t smem_f32(int stride, int Cw) {
  const size_t halo = (size_t)((TH32 - 1) * stride + 3) * ((TW32 - 1) * stride + 3);
  return align128(halo * (Cw + kPad) * 4) + kA32Bytes + kW32Bytes;
}

__global__ void __launch_bounds__(kThreadsF32)
bottleneck_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ w3,
               const float* __restrict__ b3, const float* __restrict__ wd,
               const float* __restrict__ bd, float* __restrict__ out, Geo g,
               int s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HWd = (TW32 - 1) * s + 3;
  const int P1 = ((TH32 - 1) * s + 3) * HWd;
  const int Cw = g.Cw, LT = Cw + kPad;

  float* t1 = reinterpret_cast<float*>(smem);             // [P1][LT]
  float* t2 = t1;                                         // [TM32][LT], after conv2
  float* a_buf = reinterpret_cast<float*>(smem + align128((size_t)P1 * LT * 4));
  float* w_buf = a_buf + TM32 * kLdA32;

  const int b = blockIdx.y;
  const int tr = blockIdx.x / g.tiles_w, tc = blockIdx.x - tr * g.tiles_w;
  const int oh0 = tr * TH32, ow0 = tc * TW32;
  const int ih0 = oh0 * s - 1, iw0 = ow0 * s - 1;
  const float* xb = x + (size_t)b * g.H * g.W * g.Cin;
  const int kcw = Cw / KC, kci = g.Cin / KC;

  AccF32 acc;

  // ---- conv1 (1x1) + bias + ReLU on the halo; zero outside the image ----
  for (int p0 = 0; p0 < P1; p0 += TM32) {
    acc.zero(Cw);
    pipeline(
        kci,
        [&](int c) {
          stage_a(a_buf, [&](int r) -> const float* {
            int p = p0 + r;
            if (p >= P1) return nullptr;
            int ih = ih0 + p / HWd, iw = iw0 + p % HWd;
            if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return nullptr;
            return xb + ((size_t)ih * g.W + iw) * g.Cin + c * KC;
          }, xb);
          stage_w(w_buf, w1 + (size_t)c * KC * Cw, Cw, Cw);
        },
        [&](int) { acc.mma([&](int m) { return a_buf + m * kLdA32; }, w_buf); });
    acc.epilogue([&](int r, int n, float v0, float v1) {
      int p = p0 + r;
      if (p >= P1) return;
      int ih = ih0 + p / HWd, iw = iw0 + p % HWd;
      bool inside = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      store2(t1 + (size_t)p * LT + n, inside ? fmaxf(v0 + b1[n], 0.f) : 0.f,
             inside ? fmaxf(v1 + b1[n + 1], 0.f) : 0.f);
    });
  }
  __syncthreads();

  // ---- conv2 (3x3, stride s) + bias + ReLU: 9 taps read t1 in place ----
  acc.zero(Cw);
  pipeline(
      9 * kcw,
      [&](int c) {
        int tap = c / kcw, kc = (c - tap * kcw) * KC;
        stage_w(w_buf, w2 + ((size_t)tap * Cw + kc) * Cw, Cw, Cw);
      },
      [&](int c) {
        int tap = c / kcw, kc = (c - tap * kcw) * KC;
        int di = tap / 3, dj = tap - 3 * di;
        const float* base = t1 + (size_t)(di * HWd + dj) * LT + kc;
        acc.mma([&](int m) {
          return base + (size_t)((m / TW32) * s * HWd + (m % TW32) * s) * LT;
        }, w_buf);
      });
  // every thread is past its reads of t1, so t2 may overwrite it
  acc.epilogue([&](int r, int n, float v0, float v1) {
    store2(t2 + (size_t)r * LT + n, fmaxf(v0 + b2[n], 0.f), fmaxf(v1 + b2[n + 1], 0.f));
  });
  __syncthreads();

  // ---- conv3 (1x1) [+ strided 1x1 downsample] + residual + ReLU ----
  for (int nc = 0; nc < g.Cout; nc += NMAX) {
    acc.zero(NMAX);
    pipeline(
        kcw + (g.has_ds ? kci : 0),
        [&](int c) {
          if (c < kcw) {
            stage_w(w_buf, w3 + (size_t)c * KC * g.Cout + nc, NMAX, g.Cout);
            return;
          }
          int kc = (c - kcw) * KC;
          stage_a(a_buf, [&](int r) -> const float* {
            int oh = oh0 + r / TW32, ow = ow0 + r % TW32;
            if (oh >= g.Ho || ow >= g.Wo) return nullptr;
            return xb + ((size_t)(oh * s) * g.W + ow * s) * g.Cin + kc;
          }, xb);
          stage_w(w_buf, wd + (size_t)kc * g.Cout + nc, NMAX, g.Cout);
        },
        [&](int c) {
          if (c < kcw) {
            const float* base = t2 + c * KC;
            acc.mma([&](int m) { return base + (size_t)m * LT; }, w_buf);
          } else {
            acc.mma([&](int m) { return a_buf + m * kLdA32; }, w_buf);
          }
        });
    acc.epilogue([&](int r, int n, float v0, float v1) {
      int oh = oh0 + r / TW32, ow = ow0 + r % TW32;
      if (oh >= g.Ho || ow >= g.Wo) return;
      int c = nc + n;
      float2 idn;
      if (g.has_ds)
        idn = make_float2(bd[c], bd[c + 1]);
      else   // identity: stride 1 and Cin == Cout
        idn = load2(xb + ((size_t)oh * g.W + ow) * g.Cin + c);
      store2(out + (((size_t)b * g.Ho + oh) * g.Wo + ow) * g.Cout + c,
             fmaxf(v0 + b3[c] + idn.x, 0.f), fmaxf(v1 + b3[c + 1] + idn.y, 0.f));
    });
  }
}

int launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, const void* w3, const void* b3, const void* wd,
               const void* bd, void* out, int B, int H, int W, int Cin, int Cw,
               int Cout, int stride, int has_ds, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bottleneck_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  Geo g;
  g.H = H; g.W = W; g.Cin = Cin; g.Cw = Cw; g.Cout = Cout;
  g.Ho = H / stride; g.Wo = W / stride; g.has_ds = has_ds;
  g.tiles_w = (g.Wo + TW32 - 1) / TW32;
  const int tiles_h = (g.Ho + TH32 - 1) / TH32;
  dim3 grid(tiles_h * g.tiles_w, B);
  bottleneck_f32<<<grid, kThreadsF32, smem_f32(stride, Cw), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<float*>(out), g, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B,H,W,Cin] and out [B,H/s,W/s,Cout]
// NHWC contiguous; biases fp32. Weights: fp32 unpacked, w1 [Cin,Cw], w2
// [9*Cw,Cw] (tap-major rows), w3 [Cw,Cout], wd [Cin,Cout]; bf16 packed into
// 64-row chunks of rows padded by 8 zeros, in the order the kernel streams
// them (ops/bottleneck.py, pack_operands). wd is ignored without downsample.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int bottleneck_forward(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* b3, const void* wd, const void* bd,
                                  void* out, int B, int H, int W, int Cin, int Cw,
                                  int Cout, int stride, int has_ds, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, Cin, Cw,
                      Cout, stride, has_ds, st);
  if (stride == 1)
    return launch_bf16<1>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, Cin,
                          Cw, Cout, has_ds, st);
  return launch_bf16<2>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, Cin,
                        Cw, Cout, has_ds, st);
}
