// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// K1 and its weight gradient (dhconv.cu), K2/K3 (fused_mlp.cu) and K4
// (fused_rank.cu).
//
// Shared-memory operands use wgmma's 128-byte-swizzle layouts. An atom is 8
// rows of 128 bytes (1024 bytes, 1024-byte aligned); the 16-byte chunk c of
// row r is stored at r * 128 + ((c ^ (r % 8)) * 16).
//   - K-major (kmajor_desc): a row is one M (or N) index, the 128 bytes run
//     along K; atoms of 8 rows are 1024 bytes apart. A product of depth 32
//     bytes (16 bf16, 8 tf32) starts 32 bytes further along the row.
//   - MN-major (mnmajor_desc, 16-bit types only): a row is one K index, the 128
//     bytes hold 64 consecutive M (or N) values; groups of 8 K rows are 1024
//     bytes apart, so a product of depth 16 starts 2048 bytes further on.
// Every helper is inline: each translation unit compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The 16-bit element types of the tensor-core kernels, bf16 and fp16: one
// value rounded to nearest even and widened, and two values packed in one
// 32-bit word (the first in the low half) and unpacked. Both types take 2
// bytes, so every layout, descriptor and swizzle here serves either.
template <typename T>
struct Elem16;
template <>
struct Elem16<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 round(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return (uint32_t)__bfloat16_as_ushort(h.x) | ((uint32_t)__bfloat16_as_ushort(h.y) << 16);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
  }
};
template <>
struct Elem16<__half> {
  static __device__ __forceinline__ __half round(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ float widen(__half v) { return __half2float(v); }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __half2 h = __floats2half2_rn(a, b);
    return (uint32_t)__half_as_ushort(h.x) | ((uint32_t)__half_as_ushort(h.y) << 16);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return make_float2(__half2float(__ushort_as_half((unsigned short)(w & 0xFFFFu))),
                       __half2float(__ushort_as_half((unsigned short)(w >> 16))));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma descriptor of a K-major operand in the 128-byte-swizzle layout:
// start address, leading offset 16 (unused for this layout), stride 1024
// bytes between 8-row atoms, swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma descriptor of an MN-major operand in the 128-byte-swizzle layout,
// for tiles exactly 64 values wide in M (or N): the stride between groups of
// 8 K rows is 1024 bytes. The other offset, between 64-wide M (or N) blocks,
// is never used by such a tile; it is set to 1024 bytes as well, so the
// descriptor is the same whichever of the two fields the hardware reads as
// the K-group stride. Swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait for the phase of the given parity to complete. A wait that outlasts
// any legitimate one (2^26 polls) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy stores to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Thread block clusters: every thread of every block of the cluster arrives,
// and waits until all have (release / acquire: shared-memory writes before
// the barrier are visible to the cluster's reads after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// This block's index along y inside its cluster (its rank where the
// cluster is one block wide in x and z).
__device__ __forceinline__ uint32_t cluster_ctaid_y() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctaid.y;\n" : "=r"(r));
  return r;
}
// The shared::cluster address of the same offset in the block of the given
// rank, and a 16-byte load from it.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Keeps the compiler from moving accumulator reads or writes across a wait.
template <int kN>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace
