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
// Products take the activation dtype (bf16 through the tensor cores with
// mma.sync m16n8k16, or fp32 on the CUDA cores) and accumulate in fp32;
// bias, ReLU and the residual add are fp32 in the epilogues, then cast to
// the activation dtype.
//
// What bounds it on an H100: bytes. A stride-1 block of stage 0 does about
// 140 FLOPs per byte of its input and output, below the ~295 FLOPs/byte at
// which the bf16 tensor cores become the limit, so the unfused chain (each
// conv reads its input from and writes its output to device memory) is
// limited by memory traffic. The design keeps t1 and t2 out of device
// memory: each thread block owns one 4x16 tile of output pixels of one image
// with all output channels, recomputes t1 on the tile's halo into shared
// memory ((TH-1)*s+3 x (TW-1)*s+3 pixels: 6x18 at stride 1, 9x33 at
// stride 2), and keeps t2 in shared memory. Weights are streamed through
// shared memory in K-chunks of 64 rows (stage 1's w2 alone is 295 KB in
// bf16), double-buffered with cp.async so that the next chunk's copy runs
// under the current chunk's products. Stride 2 with a downsample is handled
// like stride 1: ldmatrix takes one address per row, so the 3x3 reads t1
// in place, s pixels apart, and no im2col buffer is ever built.
//
// Inside the block the limit is shared-memory bandwidth, so every shared
// row is padded by 8 elements: the 8 rows one ldmatrix reads then fall in
// different banks. Accumulators go from registers straight to their
// destination (t1, t2 or the output), with no fp32 staging in shared memory.
//
// Shared memory: t1 [P1][Cw+8] (t2 [64][Cw+8] reuses it once conv2's
// products are done), then stages<T>() staging buffers, each an A chunk
// [64][64+8] and a weight chunk [64][128+8].
// Limits (checked by the Python wrapper): Cin % 64 == 0, Cw in {64, 128},
// Cout % 128 == 0, H and W divisible by the stride.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int TH = 4, TW = 16, TM = TH * TW;   // output tile: 64 pixels
constexpr int KC = 64;                  // K rows per staged chunk
constexpr int NMAX = 128;               // output channels per pass
constexpr int kPad = 8;                 // elements added to every shared row
constexpr int kLdA = KC + kPad;         // row stride of a staged A chunk
constexpr int kLdW = NMAX + kPad;       // row stride of a staged weight chunk

// bf16 double-buffers its staging; fp32 (a check path, not the main path)
// has one buffer so that stride 2 at Cw=128 still fits in shared memory.
template <typename T> __host__ __device__ constexpr int stages() {
  return sizeof(T) == 2 ? 2 : 1;
}

struct Geo {
  int H, W, Cin, Cw, Cout, Ho, Wo, stride, has_ds, tiles_w;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~(size_t)127; }

// ---- cp.async: 16 bytes global -> shared; a copy of 0 bytes fills zeros ----
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---- bf16 tensor-core fragments ----
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The [TM, N] product tile of one pass, summed over K-chunks.
// mma(a_row, b) adds one K-chunk: a_row(m) points at row m of the A operand
// (k = 0) in shared memory; b is a [KC][N] weight chunk, row stride kLdW.
// epilogue(f) calls f(row, col, v[col], v[col + 1]) for every pair of
// adjacent columns the thread owns.
template <typename T> struct Acc;

// bf16: warp w owns rows 16*(w & 3) .. +15 and columns N/2 * (w >> 2) .. +N/2,
// as N/16 m16n8 accumulator tiles (at most 8).
template <> struct Acc<__nv_bfloat16> {
  using T = __nv_bfloat16;
  float c[8][4];
  int n0, nt;

  __device__ void zero(int N) {
    nt = N / 16;
    n0 = (threadIdx.x >> 7) * (N / 2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  }
  template <typename RowPtr>
  __device__ void mma(RowPtr a_row, const T* b) {
    const int lane = threadIdx.x & 31, mt = (threadIdx.x >> 5) & 3;
    // ldmatrix x4: lane l addresses row (l & 15), k offset 8 * (l >> 4)
    const T* a_ptr = a_row(mt * 16 + (lane & 15)) + (lane >> 4) * 8;
    // x4.trans of a [16 k][16 n] block: lane l addresses k row (l & 15) at
    // column 8 * (l >> 4); registers 0,1 feed n-tile 2j, 2,3 n-tile 2j+1
    const T* b_ptr = b + (lane & 15) * kLdW + n0 + (lane >> 4) * 8;
#pragma unroll
    for (int k = 0; k < KC; k += 16) {
      unsigned a[4];
      ldmatrix_x4(a, a_ptr + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (2 * j < nt) {
          unsigned bb[4];
          ldmatrix_x4_trans(bb, b_ptr + k * kLdW + j * 16);
          mma_bf16(c[2 * j], a, bb[0], bb[1]);
          mma_bf16(c[2 * j + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  template <typename F> __device__ void epilogue(F f) {
    const int lane = threadIdx.x & 31, mt = (threadIdx.x >> 5) & 3;
    const int row = mt * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt) {
        const int col = n0 + j * 8 + (lane & 3) * 2;
        f(row, col, c[j][0], c[j][1]);
        f(row + 8, col, c[j][2], c[j][3]);
      }
    }
  }
};

// fp32: CUDA-core FMAs. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// 4ty..4ty+3 and the column pairs 2tx + 32j, j < N / 32.
template <> struct Acc<float> {
  using T = float;
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
  __device__ void mma(RowPtr a_row, const T* b) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const T* rows[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) rows[i] = a_row(4 * ty + i);
    for (int k = 0; k < KC; ++k) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = rows[i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < np) {
          float2 bv = load2(b + k * kLdW + 2 * tx + 32 * j);
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

// Stage an A chunk [TM][KC] (row stride kLdA) from pixel rows of x; a null
// row is zero-filled.
template <typename T, typename RowPtr>
__device__ void stage_a(T* dst, RowPtr row_ptr, const T* any_valid) {
  constexpr int per = 16 / (int)sizeof(T);          // elements per copy
  constexpr int vpr = KC / per;
  for (int e = threadIdx.x; e < TM * vpr; e += kThreads) {
    int r = e / vpr, v = e - r * vpr;
    const T* src = row_ptr(r);
    cp_async16(dst + r * kLdA + v * per,
               src != nullptr ? src + v * per : any_valid, src != nullptr);
  }
}

// Stage a weight chunk [KC][cols] (row stride kLdW) from rows src_ld apart.
template <typename T>
__device__ void stage_w(T* dst, const T* src, int cols, int src_ld) {
  constexpr int per = 16 / (int)sizeof(T);
  const int vpr = cols / per;
  for (int e = threadIdx.x; e < KC * vpr; e += kThreads) {
    int r = e / vpr, v = e - r * vpr;
    cp_async16(dst + r * kLdW + v * per, src + (size_t)r * src_ld + v * per, true);
  }
}

// Run n K-chunks: stage(c, buf) issues chunk c's copies into buffer buf,
// compute(c, buf) adds its products. With two stages chunk c+1 is copied
// while chunk c is multiplied. Ends with every thread past its last read
// of the staging buffers.
template <typename T, typename Stage, typename Compute>
__device__ void pipeline(int n, Stage stage, Compute compute) {
  constexpr int S = stages<T>();
  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (S > 1 && c + 1 < n) {
      stage(c + 1, (c + 1) % S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(c, c % S);
    __syncthreads();
    if (S == 1 && c + 1 < n) {
      stage(c + 1, 0);
      cp_async_commit();
    }
  }
}

__host__ __device__ inline int halo_h(int s) { return (TH - 1) * s + 3; }
__host__ __device__ inline int halo_w(int s) { return (TW - 1) * s + 3; }

template <typename T> __host__ __device__ inline size_t a_bytes() {
  return align128((size_t)TM * kLdA * sizeof(T));
}
template <typename T> __host__ __device__ inline size_t stage_bytes() {
  return a_bytes<T>() + align128((size_t)KC * kLdW * sizeof(T));
}
template <typename T> __host__ __device__ inline size_t t1_bytes(int s, int Cw) {
  return align128((size_t)halo_h(s) * halo_w(s) * (Cw + kPad) * sizeof(T));
}

template <typename T>
size_t smem_bytes(int stride, int Cw) {
  return t1_bytes<T>(stride, Cw) + stages<T>() * stage_bytes<T>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const float* __restrict__ b3, const T* __restrict__ wd,
                  const float* __restrict__ bd, T* __restrict__ out, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s = g.stride;
  const int HWd = halo_w(s);
  const int P1 = halo_h(s) * HWd;
  const int Cw = g.Cw, LT = Cw + kPad;

  T* t1 = reinterpret_cast<T*>(smem);                  // [P1][LT]
  T* t2 = t1;                                          // [TM][LT], after conv2
  unsigned char* staging = smem + t1_bytes<T>(s, Cw);
  auto a_buf = [&](int buf) {
    return reinterpret_cast<T*>(staging + buf * stage_bytes<T>());
  };
  auto w_buf = [&](int buf) {
    return reinterpret_cast<T*>(staging + buf * stage_bytes<T>() + a_bytes<T>());
  };

  const int b = blockIdx.y;
  const int tr = blockIdx.x / g.tiles_w, tc = blockIdx.x - tr * g.tiles_w;
  const int oh0 = tr * TH, ow0 = tc * TW;
  const int ih0 = oh0 * s - 1, iw0 = ow0 * s - 1;
  const T* xb = x + (size_t)b * g.H * g.W * g.Cin;
  const int kcw = Cw / KC, kci = g.Cin / KC;

  Acc<T> acc;

  // ---- conv1 (1x1) + bias + ReLU on the halo; zero outside the image ----
  for (int p0 = 0; p0 < P1; p0 += TM) {
    acc.zero(Cw);
    pipeline<T>(
        kci,
        [&](int c, int buf) {
          stage_a(a_buf(buf), [&](int r) -> const T* {
            int p = p0 + r;
            if (p >= P1) return nullptr;
            int ih = ih0 + p / HWd, iw = iw0 + p % HWd;
            if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return nullptr;
            return xb + ((size_t)ih * g.W + iw) * g.Cin + c * KC;
          }, xb);
          stage_w(w_buf(buf), w1 + (size_t)c * KC * Cw, Cw, Cw);
        },
        [&](int, int buf) {
          const T* xs = a_buf(buf);
          acc.mma([&](int m) { return xs + m * kLdA; }, w_buf(buf));
        });
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
  // output pixel m = (m / TW, m % TW) of the tile reads halo pixel
  // (s * (m / TW) + di, s * (m % TW) + dj)
  acc.zero(Cw);
  pipeline<T>(
      9 * kcw,
      [&](int c, int buf) {
        int tap = c / kcw, kc = (c - tap * kcw) * KC;
        stage_w(w_buf(buf), w2 + ((size_t)tap * Cw + kc) * Cw, Cw, Cw);
      },
      [&](int c, int buf) {
        int tap = c / kcw, kc = (c - tap * kcw) * KC;
        int di = tap / 3, dj = tap - 3 * di;
        const T* base = t1 + (size_t)(di * HWd + dj) * LT + kc;
        acc.mma([&](int m) {
          return base + (size_t)((m / TW) * s * HWd + (m % TW) * s) * LT;
        }, w_buf(buf));
      });
  // every thread is past its reads of t1, so t2 may overwrite it
  acc.epilogue([&](int r, int n, float v0, float v1) {
    store2(t2 + (size_t)r * LT + n, fmaxf(v0 + b2[n], 0.f),
           fmaxf(v1 + b2[n + 1], 0.f));
  });
  __syncthreads();

  // ---- conv3 (1x1) [+ strided 1x1 downsample] + residual + ReLU ----
  for (int nc = 0; nc < g.Cout; nc += NMAX) {
    acc.zero(NMAX);
    pipeline<T>(
        kcw + (g.has_ds ? kci : 0),
        [&](int c, int buf) {
          if (c < kcw) {
            stage_w(w_buf(buf), w3 + (size_t)c * KC * g.Cout + nc, NMAX, g.Cout);
            return;
          }
          int kc = (c - kcw) * KC;
          stage_a(a_buf(buf), [&](int r) -> const T* {
            int oh = oh0 + r / TW, ow = ow0 + r % TW;
            if (oh >= g.Ho || ow >= g.Wo) return nullptr;
            return xb + ((size_t)(oh * s) * g.W + ow * s) * g.Cin + kc;
          }, xb);
          stage_w(w_buf(buf), wd + (size_t)kc * g.Cout + nc, NMAX, g.Cout);
        },
        [&](int c, int buf) {
          if (c < kcw) {
            const T* base = t2 + c * KC;
            acc.mma([&](int m) { return base + (size_t)m * LT; }, w_buf(buf));
          } else {
            const T* xs = a_buf(buf);
            acc.mma([&](int m) { return xs + m * kLdA; }, w_buf(buf));
          }
        });
    acc.epilogue([&](int r, int n, float v0, float v1) {
      int oh = oh0 + r / TW, ow = ow0 + r % TW;
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

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wd,
           const void* bd, void* out, int B, int H, int W, int Cin, int Cw,
           int Cout, int stride, int has_ds, cudaStream_t stream) {
  Geo g;
  g.H = H; g.W = W; g.Cin = Cin; g.Cw = Cw; g.Cout = Cout;
  g.Ho = H / stride; g.Wo = W / stride; g.stride = stride; g.has_ds = has_ds;
  g.tiles_w = (g.Wo + TW - 1) / TW;
  const int tiles_h = (g.Ho + TH - 1) / TH;
  const size_t smem = smem_bytes<T>(stride, Cw);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles_h * g.tiles_w, B);
  bottleneck_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const T*>(wd),
      static_cast<const float*>(bd), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B,H,W,Cin] and out [B,H/s,W/s,Cout]
// NHWC contiguous; w1 [Cin,Cw], w2 [9*Cw,Cw] (tap-major rows), w3 [Cw,Cout],
// wd [Cin,Cout] (ignored without downsample); biases fp32. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int bottleneck_forward(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* b3, const void* wd, const void* bd,
                                  void* out, int B, int H, int W, int Cin, int Cw,
                                  int Cout, int stride, int has_ds, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, Cin,
                         Cw, Cout, stride, has_ds, st);
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W,
                               Cin, Cw, Cout, stride, has_ds, st);
}
