// Unmasked scaled dot-product attention, one thread block per (batch, head).
//
// Replaces the Pallas TPU kernel `_attention_kernel`
// (t5_resnet_vqa_tpu/ops/pallas/attention.py:56, launched by
// `fused_attention` at :108). Same math: fp32 scores = q.k^T * (1/sqrt(D)),
// row softmax in fp32, probabilities rounded to the value dtype, P.V
// accumulated in fp32, output cast to the query dtype.
//
// What bounds it on an H100: bytes. At the SGA geometry (H=8, D=96, Sq=16,
// Sk<=64) each head does 2*Sq*Sk*D*2 FLOPs on (Sq + 2*Sk + Sq)*D elements,
// about 16 FLOPs per byte, far below the ~295 FLOPs/byte at which the
// tensor cores become the limit. So the design keeps everything that is not
// an input or an output on chip: K and V of one head are staged once in
// shared memory, the [Sq, Sk] scores live in registers of the warp that owns
// the query row, and only the [Sq, D] output goes back to device memory.
// The TPU kernel ran one grid step per batch element over all heads; here
// B*H blocks (512 at B=64, H=8) spread over the 132 SMs. Loop bounds come
// from Sk and D, so D=96 and S=197 need no padding and no -1e30 columns.
//
// Shared-memory rows of K and V are padded by one 32-bit word so that lanes
// reading different keys at the same feature hit different banks.
//
// Limits (checked by the Python wrapper): Sk <= 256, D <= 128, D even.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxSk = 256;            // scores per lane: kMaxSk / 32
constexpr int kMaxD = 128;             // features per lane: kMaxD / 32

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row stride of K and V in shared memory, in elements: D plus one 32-bit
// word, which makes the stride an odd number of words.
template <typename T> __host__ __device__ constexpr int padded_row(int D) {
  return D + 4 / (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Sk, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = padded_row<T>(D);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)Sk * ld;
  // fp32 areas after K and V, 16-byte aligned
  size_t kv_bytes = ((size_t)2 * Sk * ld * sizeof(T) + 15) & ~(size_t)15;
  float* qs = reinterpret_cast<float*>(smem + kv_bytes);      // [kWarps][D]
  float* ps = qs + kWarps * D;                                  // [kWarps][Sk]

  const size_t head = blockIdx.x;                  // b * H + h
  const T* qh = q + head * Sq * D;
  const T* kh = k + head * Sk * D;
  const T* vh = v + head * Sk * D;
  T* oh = o + head * Sq * D;

  for (int i = threadIdx.x; i < Sk * D; i += blockDim.x) {
    int r = i / D, c = i - r * D;
    ks[r * ld + c] = kh[i];
    vs[r * ld + c] = vh[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qs + warp * D;
  float* pw = ps + warp * Sk;

  for (int row = warp; row < Sq; row += kWarps) {
    for (int d = lane; d < D; d += 32) qw[d] = to_f(qh[(size_t)row * D + d]);
    __syncwarp();

    // scores: lane owns keys lane, lane+32, ...
    float sc[kMaxSk / 32];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxSk / 32; ++t) {
      int j = lane + 32 * t;
      float s = -INFINITY;
      if (j < Sk) {
        const T* kr = ks + j * ld;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qw[d], to_f(kr[d]), acc);
        s = acc * scale;
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
      // probabilities are rounded to the value dtype before P.V
      if (j < Sk) pw[j] = to_f(from_f<T>(sc[t] / sum));
    }
    __syncwarp();

    // P.V: lane owns features lane, lane+32, ...
    float acc[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) acc[i] = 0.f;
    for (int j = 0; j < Sk; ++j) {
      float p = pw[j];
      const T* vr = vs + j * ld;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(p, to_f(vr[d]), acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      int d = lane + 32 * i;
      if (d < D) oh[(size_t)row * D + d] = from_f<T>(acc[i]);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int D, cudaStream_t stream) {
  size_t kv_bytes = ((size_t)2 * Sk * padded_row<T>(D) * sizeof(T) + 15) & ~(size_t)15;
  size_t smem = kv_bytes + (size_t)kWarps * (D + Sk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float scale = 1.0f / sqrtf((float)D);
  attention_kernel<T><<<BH, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o are [B*H, Sq, D], k/v [B*H, Sk, D],
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 void* o, int BH, int Sq, int Sk, int D,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, BH, Sq, Sk, D, s);
  return launch<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, s);
}
