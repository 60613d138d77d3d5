// Helpers shared by the package's kernels (sm_90a): asynchronous copies
// (cp.async, and cp.async.bulk on mbarriers: tensor-map (TMA) loads and
// stores with the driver's map encoder, and the maps of attention heads),
// bf16 tensor-core fragments (ldmatrix and mma.sync m16n8k16), warpgroup
// products (wgmma with A from shared memory or registers, its
// shared-memory matrix descriptors and fences), and small conversions.
//
// ops/kernel_build.py hashes every csrc/*.cuh into each library's name, so
// an edit here rebuilds every kernel that includes this file.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ---- cp.async: src_bytes of a 16- (or 4-) byte copy come from global, the
// rest of the copy is filled with zeros (0 bytes: all zeros) ----
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---- mbarrier and bulk copies (the TMA's untiled form: contiguous bytes,
// 16-byte aligned at both ends, completing on an mbarrier) ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Spin until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- tensor-map (TMA) copies: boxes of a strided 4-D tensor, the 128-byte
// swizzle applied by the hardware; loads complete on an mbarrier, stores in
// the issuing thread's bulk group ----

// A 4-D tensor-map load (dims d0..d3, innermost first) into shared memory,
// completing on an mbarrier. Coordinates outside the tensor read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// A 4-D tensor-map store from shared memory, in the thread's bulk group;
// coordinates outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3, %4}], [%5];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(smem_addr(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until the thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Wait until the thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Order this thread's shared-memory writes before later bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Element (m, n) of a [rows][64] bf16 tile that a tensor map with the
// 128-byte swizzle reads or writes (the tile 1024-byte aligned): 16-byte
// piece n / 8 of row m sits at piece (n / 8) ^ (m % 8).
__device__ __forceinline__ int swizzled(int m, int n) {
  return m * 64 + ((((n >> 3) ^ m) & 7) << 3) + (n & 7);
}

// cuTensorMapEncodeTiled from the driver, found through the runtime, so a
// library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 map over the heads of a [B, H, S, 64] view (element strides of
// s, h and b; D = 64 contiguous, one 128-byte row): dims (D, S, H, B),
// boxes of 64 x box_rows with the 128-byte swizzle, rows past S read as
// zeros and not written. Returns false if the driver refuses it.
inline bool make_head_map(CUtensorMap* map, const void* p, int B, int H, int S,
                          long long s_stride, long long h_stride,
                          long long b_stride, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_stride * 2, (cuuint64_t)h_stride * 2,
                                 (cuuint64_t)b_stride * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count: the grid of a persistent kernel.
inline int num_sms() {
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

// Barrier over the first `threads` threads of the block (id 1..15; id 0 is
// __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- bf16 tensor-core fragments ----
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16x16, row) * b (16x8, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- wgmma: one warpgroup's (4 warps, 128 threads) product of 64 rows,
// issued asynchronously. B, and A unless it comes from registers, is read
// from shared memory through a matrix descriptor. Accumulator (and
// A-register) layout per warp w of the group: the mma.sync m16n8 layout of
// rows 16w..16w+15, repeated over n8 blocks: d[4j + e] holds row
// 16w + lane/4 + 8(e / 2), column 8j + 2(lane % 4) + e % 2. ----

// The descriptor of a tile written with the 128-byte swizzle (rows of 128
// bytes in 8-row atoms of 1024 bytes, the tile 1024-byte aligned): start
// address, leading and stride byte offsets (16-byte units), layout 1. For a
// K-major operand the stride offset steps between 8-row groups and the
// leading offset is unused; for an MN-major one (transposed) the stride
// offset steps between 8-row groups along K and the leading offset between
// 64-element column blocks.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p, unsigned lbo,
                                                     unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// Before a group's first wgmma, and whenever registers it reads were
// written by other instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Move the warpgroup's registers per thread down to R, or up to R, from
// the pool the block was launched with (R a multiple of 8 in [24, 256]).
// Every warp of the group runs it; the roles must not reconverge after.
template <unsigned R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <unsigned R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
// Pin a register in place: the compiler may not move its reads or writes
// across this point (a wgmma reads and writes its registers after issue).
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void fence_reg(unsigned& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// Operand lists of the accumulators: SM90_ACCS_g names d[0..8g-1] and
// SM90_REGS_g numbers them %0..%(8g-1) in the instruction.
#define SM90_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                     "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_REGS_1 "%0, %1, %2, %3, %4, %5, %6, %7"
#define SM90_REGS_2 SM90_REGS_1 ", " "%8, %9, %10, %11, %12, %13, %14, %15"
#define SM90_REGS_3 SM90_REGS_2 ", " "%16, %17, %18, %19, %20, %21, %22, %23"
#define SM90_REGS_4 SM90_REGS_3 ", " "%24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_REGS_5 SM90_REGS_4 ", " "%32, %33, %34, %35, %36, %37, %38, %39"
#define SM90_REGS_6 SM90_REGS_5 ", " "%40, %41, %42, %43, %44, %45, %46, %47"
#define SM90_REGS_7 SM90_REGS_6 ", " "%48, %49, %50, %51, %52, %53, %54, %55"
#define SM90_REGS_8 SM90_REGS_7 ", " "%56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_REGS_9 SM90_REGS_8 ", " "%64, %65, %66, %67, %68, %69, %70, %71"
#define SM90_REGS_10 SM90_REGS_9 ", " "%72, %73, %74, %75, %76, %77, %78, %79"
#define SM90_REGS_11 SM90_REGS_10 ", " "%80, %81, %82, %83, %84, %85, %86, %87"
#define SM90_REGS_12 SM90_REGS_11 ", " "%88, %89, %90, %91, %92, %93, %94, %95"
#define SM90_REGS_13 SM90_REGS_12 ", " "%96, %97, %98, %99, %100, %101, %102, %103"
#define SM90_REGS_14 SM90_REGS_13 ", " "%104, %105, %106, %107, %108, %109, %110, %111"
#define SM90_REGS_15 SM90_REGS_14 ", " "%112, %113, %114, %115, %116, %117, %118, %119"
#define SM90_REGS_16 SM90_REGS_15 ", " "%120, %121, %122, %123, %124, %125, %126, %127"
#define SM90_ACCS_1 SM90_ACC8(0)
#define SM90_ACCS_2 SM90_ACCS_1, SM90_ACC8(8)
#define SM90_ACCS_3 SM90_ACCS_2, SM90_ACC8(16)
#define SM90_ACCS_4 SM90_ACCS_3, SM90_ACC8(24)
#define SM90_ACCS_5 SM90_ACCS_4, SM90_ACC8(32)
#define SM90_ACCS_6 SM90_ACCS_5, SM90_ACC8(40)
#define SM90_ACCS_7 SM90_ACCS_6, SM90_ACC8(48)
#define SM90_ACCS_8 SM90_ACCS_7, SM90_ACC8(56)
#define SM90_ACCS_9 SM90_ACCS_8, SM90_ACC8(64)
#define SM90_ACCS_10 SM90_ACCS_9, SM90_ACC8(72)
#define SM90_ACCS_11 SM90_ACCS_10, SM90_ACC8(80)
#define SM90_ACCS_12 SM90_ACCS_11, SM90_ACC8(88)
#define SM90_ACCS_13 SM90_ACCS_12, SM90_ACC8(96)
#define SM90_ACCS_14 SM90_ACCS_13, SM90_ACC8(104)
#define SM90_ACCS_15 SM90_ACCS_14, SM90_ACC8(112)
#define SM90_ACCS_16 SM90_ACCS_15, SM90_ACC8(120)

// d[N/2] = A (64x16, K-major, descriptor a) * B (16xN, K-major, descriptor
// b) + (scale_d ? d : 0), bf16 in, fp32 out; N a multiple of 16 in
// [16, 256]. G = N / 16 groups of 8 accumulators; the descriptors and
// scale_d are operands G*8, G*8 + 1 and G*8 + 2.
template <int N> struct WgmmaSS;
#define SM90_WGMMA_SS(G, N, A, B, S)                                           \
  template <> struct WgmmaSS<N> {                                              \
    __device__ __forceinline__ static void run(float (&d)[N / 2], uint64_t a,  \
                                               uint64_t b, int scale_d) {      \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"            \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " \
                   "{" SM90_REGS_##G "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n" \
                   : SM90_ACCS_##G                                             \
                   : "l"(a), "l"(b), "r"(scale_d));                            \
    }                                                                          \
  };
SM90_WGMMA_SS(1, 16, 8, 9, 10)
SM90_WGMMA_SS(2, 32, 16, 17, 18)
SM90_WGMMA_SS(3, 48, 24, 25, 26)
SM90_WGMMA_SS(4, 64, 32, 33, 34)
SM90_WGMMA_SS(5, 80, 40, 41, 42)
SM90_WGMMA_SS(6, 96, 48, 49, 50)
SM90_WGMMA_SS(7, 112, 56, 57, 58)
SM90_WGMMA_SS(8, 128, 64, 65, 66)
SM90_WGMMA_SS(9, 144, 72, 73, 74)
SM90_WGMMA_SS(10, 160, 80, 81, 82)
SM90_WGMMA_SS(11, 176, 88, 89, 90)
SM90_WGMMA_SS(12, 192, 96, 97, 98)
SM90_WGMMA_SS(13, 208, 104, 105, 106)
SM90_WGMMA_SS(14, 224, 112, 113, 114)
SM90_WGMMA_SS(15, 240, 120, 121, 122)
SM90_WGMMA_SS(16, 256, 128, 129, 130)
#undef SM90_WGMMA_SS

// d[N/2] = A (64x16 from registers: a[4] in the accumulator layout of two
// n8 blocks, as bf16 pairs; the fragment ldmatrix.x4 gives when lane l
// addresses row l % 16 at k offset 8 (l / 16)) * B (16xN, K-major,
// descriptor b) + (scale_d ? d : 0). A's registers are read after issue:
// keep them unchanged until a wgmma_wait covers the group.
template <int N> struct WgmmaRS;
#define SM90_WGMMA_RS(G, N, A0, A1, A2, A3, B, S)                              \
  template <> struct WgmmaRS<N> {                                              \
    __device__ __forceinline__ static void run(float (&d)[N / 2],              \
                                               const unsigned (&a)[4],         \
                                               uint64_t b, int scale_d) {      \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"            \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " \
                   "{" SM90_REGS_##G "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 \
                   "}, %" #B ", p, 1, 1, 0;\n}\n"                              \
                   : SM90_ACCS_##G                                             \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                     "r"(scale_d));                                            \
    }                                                                          \
  };
SM90_WGMMA_RS(2, 32, 16, 17, 18, 19, 20, 21)
SM90_WGMMA_RS(4, 64, 32, 33, 34, 35, 36, 37)
SM90_WGMMA_RS(8, 128, 64, 65, 66, 67, 68, 69)
#undef SM90_WGMMA_RS

// d[32] = A (64x16 from registers: a[4] in the accumulator layout of two
// n8 blocks, as bf16 pairs) * B (16x64, MN-major: descriptor b, rows of B
// along K, transposed on read) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const unsigned (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{" SM90_REGS_4 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : SM90_ACCS_4
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// 2^x on the SFU (ex2.approx: a few ulp, flushed to zero below 2^-126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

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

}  // namespace sm90
