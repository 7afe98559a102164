// K2: the block MLP as one pass, with quantized dropout drawn in the kernel,
// and K3: the same pass with the block tail's per-sample affine in front.
//
// K2 replaces the Pallas kernel spherical_dyffusion_tpu/ops/fused_mlp.py
// (_fused_mlp_2d, pallas_call at :125, body _kernel at :61):
//
//     h = qdrop(gelu(x @ W1 + b1))  rounded to the input type
//     y = qdrop(h @ W2 + b2) (+ residual)   stored as promote(x, residual)
//
// K3 replaces the Pallas kernel of fused_block_tail in the same file
// (_fused_tail_3d, pallas_call at :212, body _tail_kernel at :135). Its x is
// the PRE-norm activation of B samples of N rows each, and it first forms
//
//     xn = x * A[b] + C[b]   in float32, per channel, b = row / N,
//
// rounds xn to the input type (as the TPU kernel does before its first
// product) and then runs K2's arithmetic on xn. A and C fold the instance
// norm's statistics and affine and the time scale-shift (InstanceNorm2d with
// fold=True in models/modules.py), so the normalized tensor never reaches
// device memory. The row grid is flat over B * N rows; N need not be a
// multiple of the row tile, so a tile may hold rows of two samples, and each
// row reads the A and C of its own sample. The affine is a rounded product and
// a rounded sum (__fmul_rn, __fadd_rn: no FMA contraction), as the plain
// version computes it. K3 is K2's code with kAffine set: with A = 1 and C = 0,
// xn is x exactly and K3 equals K2 bit for bit.
//
// Quantized dropout keeps an element iff its byte is < t and scales it by
// 256 / t; t == 0 means dropout off. The bytes come from Philox4x32-10 keyed
// by the 64-bit seed (low word first). One call gives 16 bytes to 16
// elements: element (row, col) of stream s (0 the hidden mask, 1 the output
// mask; in K3 the row is the flat row b * N + n) takes
//
//     counter (col/32*4 + (col%8)/2, row/16*8 + row%8, s, 0),
//     byte    b = 4*((col%32)/8) + 2*(col%2) + (row%16)/8,
//
// byte b % 4 (from the low end) of output word b / 4. In each 16-row by
// 32-column block the 16 elements of one counter are exactly those that one
// thread holds in its wgmma accumulator fragment (rows r and r + 8, columns
// 8q + 2(lane%4) + {0, 1}, q = 0..3), so one Philox serves 16 elements and
// no byte serves two. philox_bits in spherical_dyffusion_tpu_torch/ops/
// fused_mlp.py computes the same map, so the plain versions drop the same
// elements. The TPU kernels draw per-tile hardware bits, which cannot be
// reproduced: the port agrees with them in distribution only.
//
// On a block of a grid split over a process mesh (x the rows of B samples of
// Hl x Wl pixels at origin (h0, w0) of an H x W grid) the row above is not
// the local row r = b*Hl*Wl + i*Wl + j but its pixel's row on the whole grid,
// g = b*H*W + (h0+i)*W + (w0+j) (RowMap; the identity when lw == 0, and on
// the whole grid g = r), so a sharded run drops what the one-process run
// drops. A thread's rows r and r + 8 then need not share a counter: the
// epilogues make a second Philox call where their counters differ (for
// instance where Wl is not a multiple of 16) and one where they agree, as
// always on the whole grid.
//
// What bounds them on the H100: at the main path's shapes (N = 64,800 rows,
// C = 256 -> 512 -> 256, bf16 inputs, f32 residual and output) K2 does 34 GFLOP
// against 166 MB of compulsory traffic: 0.034 ms at the bf16 tensor-core rate
// and 0.050 ms at 3.35 TB/s, so bytes bound it. K3 adds 2 KB of A and C per
// sample: the same bound at batch 1, and at the interpolator's double batch
// (B = 2, no residual, bf16 out) 68 GFLOP against 133 MB, 0.069 ms, bound by
// operations. The hidden tensor (N x 512) would add 133 MB of round trip per
// sample if it reached device memory; it never does, which is the point of
// the kernels.
//
// 16-bit design (fused_mlp_tc_kernel: x bf16 or fp16, residual float32, of
// x's type or none). The two instances differ only in the element type T:
// wgmma's operand type (.bf16 or .f16), the rounding of the affine, the
// hidden tile and the output (Elem16 in hopper.cuh), and the weight image's
// type; bytes, layouts and tiling are the same, and so is the tensor-core
// rate (989 TFLOP/s dense for either on the H100). The notes below say bf16
// for T. Both products run on the tensor cores with wgmma (sm_90a), float32
// accumulation. One block is one warpgroup (128 threads) and owns 64 rows,
// wgmma's M; two blocks share an SM. Shared memory (107 KB at C = 256,
// 1024-byte aligned), every operand in wgmma's K-major 128-byte-swizzle
// layout (element (r, k) of an 8-row by 64-column atom at byte r*128 +
// ((k/8) ^ (r%8))*16 + (k%8)*2; atoms 1024 bytes apart, 64-column blocks
// 8 KB apart):
//   - the x tile, 64 x C bf16 (32 KB), staged once through registers with
//     16-byte loads, issued in batches from clamped addresses so that they
//     are in flight together: that is where K3's affine and its bf16 rounding
//     happen (K2 runs the same code without them); rows past B * N and
//     columns past C are zero;
//   - two 32 KB weight slots, one for a W1 part and one for a W2 part. W1
//     and W2 arrive as one image that the wrapper repacks per call with one
//     small kernel (weight_image in ops/fused_mlp.py: per chunk of 64 hidden
//     units, W1[:, chunk] and W2[chunk, :] transposed, already swizzled,
//     widths padded with zeros to 64 and 256), so each part is one
//     cp.async.bulk completing on the slot's mbarrier. Thread 0 refills a
//     slot with the next chunk's part as soon as the products that read it
//     have completed, a chunk ahead of its use;
//   - the 64 x 64 bf16 hidden tile (8 KB), and b1 and b2 (3 KB), staged once
//     so that the epilogues read them without waiting on device memory.
// Per chunk j of 64 hidden units the warpgroup issues GEMM2 of chunk j - 1
// (4 x m64n256k16, hidden tile times W2 part, into the 64 x 256 float32
// output tile: 128 registers a thread) and GEMM1 of chunk j (C/16 x
// m64n64k16, x tile times W1 part, 32 registers a thread) back to back,
// waits for both, and then runs the epilogue of GEMM1 in registers: b1, gelu,
// stream-0 dropout, rounding to bf16 (as the TPU kernel rounds between its
// products), stores to the swizzled hidden tile and fence.proxy.async, so the
// next chunk's GEMM2 reads it. While one block runs that epilogue on the CUDA
// cores, the other block on the SM can use the tensor cores. The last
// epilogue adds b2, applies stream-1 dropout, adds the residual (loaded a
// group of 32 columns at a time from clamped addresses) and stores the
// promoted type; rows past B * N are not stored. The tanh-form gelu is
// computed as v * sigmoid(2u) with the fast exponential and division, within
// about 1e-6 of v of the tanhf form, before the 16-bit rounding. Widths: C,
// Hd and C2 multiples of 16, C and C2 at most 256; the wrapper raises on any
// other 16-bit call. At B = 1 the grid is 1,013 blocks on 132 SMs. ptxas gives
// the bf16 kernel 218 registers, no spill.
//
// Why not a producer warpgroup with setmaxnreg: with three warpgroups the
// launch bound caps the whole kernel at 168 registers, and ptxas kept the
// consumers there despite setmaxnreg.inc, so the 160 accumulator registers
// spilled and the wgmma were serialized (C7512). With one warpgroup a block
// the kernel may use up to 255.
//
// What bounds this design: the blocks of one wave load x and store their
// outputs at the same time, and run their products and epilogues at the same
// time, so device memory and the tensor cores take turns instead of
// overlapping; the per-chunk gelu and dropout epilogue on the CUDA cores takes
// about as long as the two products; and each block re-reads the 0.5 MB
// weight image from L2. A persistent schedule that overlaps one tile's loads
// and stores with another tile's products is later work.
//
// float32 design (fused_mlp_kernel: x float32): unchanged from the first
// port. One block of 256 threads owns 64 rows, stages its x tile in shared
// memory, and computes both products with float32 FMAs on the CUDA cores
// (8 rows x 8 columns a thread), the hidden chunk of 64 units rounded
// through shared memory. It stays on the CUDA cores because the float32
// checks hold the kernels to 1e-5 of the plain float32 version, which TF32
// tensor cores (10-bit mantissas) would break; it serves those checks, not
// the bf16 main path.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// Philox4x32-10 at counter (c0, c1, c2, 0); returns the four output words.
__device__ __forceinline__ uint4 philox4(uint64_t seed, uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  uint32_t c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word_of(uint4 w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// The dropout row map (see the note above): lw local rows per sample (0: the
// identity), wl and gw the local and global row widths, ghw the global rows
// per sample, off = h0 * gw + w0.
struct RowMap {
  int lw, wl, gw, ghw, off;
};

__device__ __forceinline__ uint32_t global_row(uint32_t r, const RowMap& m) {
  if (m.lw == 0) return r;
  const uint32_t b = r / (uint32_t)m.lw, rem = r - b * (uint32_t)m.lw;
  const uint32_t i = rem / (uint32_t)m.wl, j = rem - i * (uint32_t)m.wl;
  return b * (uint32_t)m.ghw + i * (uint32_t)m.gw + j + (uint32_t)m.off;
}

// The counter's first two words for (row, col): see the note above.
__device__ __forceinline__ uint32_t mask_c0(uint32_t col) { return (col >> 5) * 4 + ((col & 7) >> 1); }
__device__ __forceinline__ uint32_t mask_c1(uint32_t row) { return (row >> 4) * 8 + (row & 7); }

__device__ __forceinline__ float gelu(float v, int exact) {
  if (exact) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

// The tanh-form gelu of the 16-bit kernels: 0.5 v (1 + tanh(u)) =
// v sigmoid(2u), with the fast exponential and division, within about 1e-6
// of v of the tanhf form; its result is rounded to bf16 (2^-9 relative at
// most) or fp16 (2^-11 at most) next, so the difference stays a few
// hundredths of fp16's rounding step or less. (The float32 kernel keeps
// tanhf: its checks allow 1e-5.) erf gelu is computed as in gelu().
__device__ __forceinline__ float gelu_16(float v, int exact) {
  if (exact) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  const float two_u = 1.5957691216057308f * v * (1.f + 0.044715f * v * v);
  return __fdividef(v, 1.f + __expf(-two_u));
}

// Keeps v scaled by 256 / t (scale) iff its byte is below t.
__device__ __forceinline__ float keep_or_zero(float v, uint32_t byte, int t, float scale) {
  return byte < (uint32_t)t ? v * scale : 0.f;
}

// One element's dropout, computing its own Philox call (the float32 kernel).
__device__ __forceinline__ float qdrop(float v, int t, uint64_t seed, uint32_t row,
                                       uint32_t col, uint32_t stream) {
  const uint4 w = philox4(seed, mask_c0(col), mask_c1(row), stream);
  const uint32_t b = 4 * ((col & 31) >> 3) + 2 * (col & 1) + ((row & 15) >> 3);
  return keep_or_zero(v, (word_of(w, (int)(b >> 2)) >> (8 * (b & 3))) & 255u, t,
                      256.f / (float)t);
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel

constexpr int kRows = 64;     // rows of x per block
constexpr int kHidden = 64;   // hidden units per chunk
constexpr int kSlice = 32;    // rows of W1 / W2 staged at a time
constexpr int kMaxOut = 256;  // widest output row a thread tile covers
constexpr int kThreads = 256;
// kAffine: K3's per-sample affine on the staged x tile (aff_a, aff_c are
// (N / n_per_sample, C) float32); without it, K2.
template <bool kAffine, typename T, typename R, typename O>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ aff_a,
                 const float* __restrict__ aff_c, int n_per_sample,
                 const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, const R* __restrict__ res,
                 O* __restrict__ y, int N, int C, int Hd, int C2, int t,
                 uint64_t seed, int exact_gelu, RowMap map) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [kRows][C]
  T* hs = xs + kRows * C;                  // [kRows][kHidden]
  T* ws = hs + kRows * kHidden;            // [kSlice][max(kHidden, C2)]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rbase = (tid >> 5) * 8;  // each warp owns 8 rows of the tile
  const int r0 = blockIdx.x * kRows;

  for (int e = tid; e < kRows * C; e += kThreads) {
    const int r = e / C;
    T v = from_f<T>(0.f);
    if (r0 + r < N) {
      v = x[(size_t)r0 * C + e];
      if constexpr (kAffine) {
        const size_t ab = (size_t)((r0 + r) / n_per_sample) * C + (e - r * C);
        v = from_f<T>(__fadd_rn(__fmul_rn(to_f(v), aff_a[ab]), aff_c[ab]));
      }
    }
    xs[e] = v;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int j0 = 0; j0 < Hd; j0 += kHidden) {
    // hidden tile: x_tile @ W1[:, j0:j0+64]
    float hacc[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) hacc[i][0] = hacc[i][1] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kSlice) {
      __syncthreads();
      for (int e = tid; e < kSlice * kHidden; e += kThreads) {
        const int k = e / kHidden, c = e % kHidden;
        ws[e] = (k0 + k < C && j0 + c < Hd) ? w1[(size_t)(k0 + k) * Hd + j0 + c]
                                             : from_f<T>(0.f);
      }
      __syncthreads();
      const int kn = min(kSlice, C - k0);
      for (int k = 0; k < kn; ++k) {
        const float bw0 = to_f(ws[k * kHidden + lane]);
        const float bw1 = to_f(ws[k * kHidden + lane + 32]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = to_f(xs[(rbase + i) * C + k0 + k]);
          hacc[i][0] = fmaf(a, bw0, hacc[i][0]);
          hacc[i][1] = fmaf(a, bw1, hacc[i][1]);
        }
      }
    }
    // bias, gelu, dropout, round to the input type; units past Hd are 0
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = j0 + lane + 32 * h;
        float v = 0.f;
        if (col < Hd) {
          v = gelu(hacc[i][h] + b1[col], exact_gelu);
          if (t > 0)
            v = qdrop(v, t, seed, global_row((uint32_t)(r0 + rbase + i), map), (uint32_t)col, 0u);
        }
        hs[(rbase + i) * kHidden + lane + 32 * h] = from_f<T>(v);
      }
    // out tile += hidden_tile @ W2[j0:j0+64, :]
    for (int k0 = 0; k0 < kHidden; k0 += kSlice) {
      __syncthreads();
      for (int e = tid; e < kSlice * C2; e += kThreads) {
        const int k = e / C2, c = e % C2;
        ws[e] = (j0 + k0 + k < Hd) ? w2[(size_t)(j0 + k0 + k) * C2 + c] : from_f<T>(0.f);
      }
      __syncthreads();
      for (int k = 0; k < kSlice; ++k) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f(hs[(rbase + i) * kHidden + k0 + k]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = lane + 32 * c;
          const float b = col < C2 ? to_f(ws[k * C2 + col]) : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + rbase + i;
    if (row >= N) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = lane + 32 * c;
      if (col >= C2) continue;
      float v = acc[i][c] + b2[col];
      if (t > 0) v = qdrop(v, t, seed, global_row((uint32_t)row, map), (uint32_t)col, 1u);
      if (res != nullptr) v += to_f(res[(size_t)row * C2 + col]);
      y[(size_t)row * C2 + col] = from_f<O>(v);
    }
  }
}

template <bool kAffine, typename R>
int launch_simt(const void* x, const float* aff_a, const float* aff_c, int n_per_sample,
                const void* w1, const float* b1, const void* w2, const float* b2,
                const void* res, void* y, int N, int C, int Hd, int C2, int t, uint64_t seed,
                int exact_gelu, RowMap map, cudaStream_t stream) {
  const int wsw = C2 > kHidden ? C2 : kHidden;
  const size_t smem =
      sizeof(float) * ((size_t)kRows * C + kRows * kHidden + (size_t)kSlice * wsw);
  auto kern = fused_mlp_kernel<kAffine, float, R, float>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kRows - 1) / kRows;
  if (blocks == 0) return 0;
  kern<<<blocks, kThreads, smem, stream>>>(
      (const float*)x, aff_a, aff_c, n_per_sample, (const float*)w1, b1, (const float*)w2, b2,
      (const R*)res, (float*)y, N, C, Hd, C2, t, seed, exact_gelu, map);
  return (int)cudaGetLastError();
}

// The float32 kernels: residual float32, bfloat16 or none; output float32.
template <bool kAffine>
int dispatch_simt(const void* x, const float* aff_a, const float* aff_c, int n_per_sample,
                  const void* w1, const void* b1, const void* w2, const void* b2,
                  const void* res, void* y, int N, int C, int Hd, int C2, int x_dtype,
                  int res_dtype, int t, uint64_t seed, int exact_gelu, RowMap map,
                  void* stream) {
  if (x_dtype != 0 || C2 > kMaxOut || C2 <= 0 || C <= 0 || Hd <= 0 || N < 0 || res_dtype < -1 ||
      res_dtype > 1)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const void* r = res_dtype < 0 ? nullptr : res;
  if (res_dtype == 1)
    return launch_simt<kAffine, __nv_bfloat16>(x, aff_a, aff_c, n_per_sample, w1,
                                               (const float*)b1, w2, (const float*)b2, r, y,
                                               N, C, Hd, C2, t, seed, exact_gelu, map, s);
  return launch_simt<kAffine, float>(x, aff_a, aff_c, n_per_sample, w1, (const float*)b1, w2,
                                     (const float*)b2, r, y, N, C, Hd, C2, t, seed,
                                     exact_gelu, map, s);
}

// ---------------------------------------------------------------------------
// bf16 and fp16: the tensor-core kernel

namespace tc {
constexpr int kThreads = 128;           // one warpgroup
constexpr int kRows = 64;               // rows of x per block: wgmma's M
constexpr int kChunk = 64;              // hidden units per chunk
constexpr int kN2 = 256;                // GEMM2 width: C2 padded in the image
constexpr int kSlots = 2;               // weight slots: one W1 part, one W2 part
constexpr uint32_t kSlotBytes = 32768;  // kN2 x kChunk 16-bit values
constexpr uint32_t kBlockBytes = 8192;  // 64 rows x 128 bytes
constexpr int kMaxC = 256;
constexpr uint32_t kBiasOffset = 64;    // b1 and b2 follow the barriers
}  // namespace tc

// D (+)= A B for a 64-row A tile and a 64- or 256-wide B tile, K = 16, both
// K-major in shared memory; scale_d == 0 overwrites D. TY is the PTX type of
// the 16-bit operands, "bf16" or "f16"; the instances differ in nothing else.
#define SDT_WGMMA_N64(TY)                                                                      \
  asm volatile(                                                                                \
      "{\n.reg .pred p;\n"                                                                     \
      "setp.ne.b32 p, %34, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                 \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "     \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
        "+f"(d[31])                                                                            \
      : "l"(a), "l"(b), "r"(scale_d))

#define SDT_WGMMA_N256(TY)                                                                     \
  asm volatile(                                                                                \
      "{\n.reg .pred p;\n"                                                                     \
      "setp.ne.b32 p, %130, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                 \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"       \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"       \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"       \
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"       \
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"       \
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110," \
      " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"   \
      " %125, %126, %127}, "                                                                   \
      "%128, %129, p, 1, 1, 0, 0;\n}\n"                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),          \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),          \
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),          \
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),          \
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),          \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),          \
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),          \
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),       \
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),    \
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),    \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),    \
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),    \
        "+f"(d[127])                                                                           \
      : "l"(a), "l"(b), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t a, uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    SDT_WGMMA_N64("f16");
  else
    SDT_WGMMA_N64("bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t a, uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    SDT_WGMMA_N256("f16");
  else
    SDT_WGMMA_N256("bf16");
}

__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p) {
  return Elem16<T>::unpack(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = Elem16<T>::pack(a, b);
}

// x (N, C) of the 16-bit type T (bf16 or fp16); img the weight image in T
// (weight_image in ops/fused_mlp.py); b1, b2 float32; res (N, C2) of type O
// or null; y (N, C2) of type O (float32 or T).
template <bool kAffine, typename T, typename O>
__global__ void __launch_bounds__(tc::kThreads, 2)
fused_mlp_tc_kernel(const T* __restrict__ x, const float* __restrict__ aff_a,
                    const float* __restrict__ aff_c, int n_per_sample,
                    const T* __restrict__ img, const float* __restrict__ b1,
                    const float* __restrict__ b2, const O* __restrict__ res,
                    O* __restrict__ y, int N, int C, int Hd, int C2, int t, uint64_t seed,
                    int exact_gelu, RowMap map) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t raw = smem_u32(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sgen = smem_tc + (base - raw);  // generic pointer to base

  const int Cp = (C + 63) & ~63;  // GEMM1's depth in whole 64-wide blocks
  const int nkb = Cp >> 6;
  const int nch = (Hd + kChunk - 1) / kChunk;
  const uint32_t xs = 0;                              // [kb][64 rows][128 B]
  const uint32_t ws = xs + (uint32_t)nkb * kBlockBytes;  // [slot][32 KB]
  const uint32_t hs = ws + kSlots * kSlotBytes;       // [64 rows][128 B]
  const uint32_t bar0 = base + hs + kBlockBytes;      // one full barrier a slot
  float* const b1s = reinterpret_cast<float*>(sgen + (bar0 - base) + kBiasOffset);
  float* const b2s = b1s + nch * kChunk;  // b1 and b2, zero past Hd and C2
  // Load i is the W1 part of chunk i/2 (even i) or its W2 part (odd i), in
  // slot i % kSlots, whose barrier completes once per round of loads.
  auto full = [&](int i) { return bar0 + 8u * (uint32_t)(i % kSlots); };
  auto round_parity = [](int i) { return (uint32_t)((i / kSlots) & 1); };
  auto slot = [&](int i) { return base + ws + (uint32_t)(i % kSlots) * kSlotBytes; };
  const size_t w1_elems = (size_t)Cp * kChunk;
  const size_t img_stride = w1_elems + (size_t)kN2 * kChunk;  // elements per chunk
  const int n_loads = 2 * nch;
  auto issue = [&](int i) {
    if (i >= n_loads) return;
    const bool w2_part = i & 1;
    const uint32_t bytes = w2_part ? kSlotBytes : (uint32_t)(w1_elems * 2);
    mbar_expect_tx(full(i), bytes);
    bulk_load(slot(i), img + (size_t)(i >> 1) * img_stride + (w2_part ? w1_elems : 0), bytes,
              full(i));
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kSlots; ++i) issue(i);
  }
  for (int i = tid; i < nch * kChunk + kN2; i += tc::kThreads) {
    const int k = i - nch * kChunk;
    const float v = k < 0 ? __ldg(b1 + min(i, Hd - 1)) : __ldg(b2 + min(k, C2 - 1));
    b1s[i] = (k < 0 ? i < Hd : k < C2) ? v : 0.f;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * tc::kRows;

  // x tile: 16-byte loads, K3's affine in float32, T into the swizzle.
  // Each batch issues its loads from clamped, always valid addresses before
  // it uses any of them; rows past N and columns past C become zero.
  {
    const int kc = Cp >> 3;             // 16-byte chunks per row, a multiple of 8
    const int iters = 64 * kc / tc::kThreads;  // a multiple of 4
    for (int it0 = 0; it0 < iters; it0 += 4) {
      uint4 v[4];
      float4 av[4][2], cv[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = tid + (it0 + u) * tc::kThreads, r = e / kc;
        const int row = min(row0 + r, N - 1), col = min((e - r * kc) * 8, C - 8);
        v[u] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * C + col));
        if constexpr (kAffine) {
          const size_t ab = (size_t)(row / n_per_sample) * C + col;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            av[u][h] = __ldg(reinterpret_cast<const float4*>(aff_a + ab + 4 * h));
            cv[u][h] = __ldg(reinterpret_cast<const float4*>(aff_c + ab + 4 * h));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = tid + (it0 + u) * tc::kThreads, r = e / kc, cc = e - r * kc;
        uint32_t wv[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        if constexpr (kAffine) {
          const float a8[8] = {av[u][0].x, av[u][0].y, av[u][0].z, av[u][0].w,
                               av[u][1].x, av[u][1].y, av[u][1].z, av[u][1].w};
          const float c8[8] = {cv[u][0].x, cv[u][0].y, cv[u][0].z, cv[u][0].w,
                               cv[u][1].x, cv[u][1].y, cv[u][1].z, cv[u][1].w};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float2 lh = Elem16<T>::unpack(wv[p]);
            wv[p] = Elem16<T>::pack(__fadd_rn(__fmul_rn(lh.x, a8[2 * p]), c8[2 * p]),
                                    __fadd_rn(__fmul_rn(lh.y, a8[2 * p + 1]), c8[2 * p + 1]));
          }
        }
        const bool inside = row0 + r < N && cc * 8 < C;
        *reinterpret_cast<uint4*>(sgen + xs + (uint32_t)(cc >> 3) * kBlockBytes + r * 128 +
                                  (((cc & 7) ^ (r & 7)) << 4)) =
            inside ? make_uint4(wv[0], wv[1], wv[2], wv[3]) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  fence_async_smem();
  __syncthreads();

  // the thread's rows: rowa and rowa + 8, in the 16-row block of its warp;
  // their dropout rows ga and gb share a counter (one Philox call) unless a
  // row map puts them in different ones. The byte half is bit 3 of the row.
  const int rowa = row0 + 16 * warp + (lane >> 2);
  const uint32_t ga = global_row((uint32_t)rowa, map), gb = global_row((uint32_t)rowa + 8u, map);
  const uint32_t c1 = mask_c1(ga), c1b = mask_c1(gb);
  const bool two_calls = c1b != c1;
  const uint32_t half[2] = {(ga >> 3) & 1u, (gb >> 3) & 1u};
  const float scale = t > 0 ? 256.f / (float)t : 1.f;

  float acc_o[128];
  float acc_h[32];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc_o[i] = 0.f;

  for (int j = 0; j < nch; ++j) {
    const int l1 = 2 * j;  // load of chunk j's W1 part; chunk j - 1's W2 part is l1 - 1
    if (j > 0) mbar_wait(full(l1 - 1), round_parity(l1 - 1));
    mbar_wait(full(l1), round_parity(l1));
    wgmma_fence();
    if (j > 0) {
      const uint32_t w2s = slot(l1 - 1);
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
        wgmma_n256<T>(acc_o, kmajor_desc(base + hs + 32 * ks), kmajor_desc(w2s + 32 * ks), 1);
    }
    const uint32_t w1s = slot(l1);
    for (int ks = 0; ks < 4 * nkb; ++ks) {
      const uint32_t off = (uint32_t)(ks >> 2) * kBlockBytes + 32u * (ks & 3);
      wgmma_n64<T>(acc_h, kmajor_desc(base + xs + off), kmajor_desc(w1s + off), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(acc_h);
    fence_regs<128>(acc_o);
    if (tid == 0) {  // both slots are free again: fetch the next W1 and W2 parts
      issue(l1 + kSlots);
      if (j > 0) issue(l1 - 1 + kSlots);
    }

    // GEMM1's epilogue: b1, gelu, stream-0 dropout, T into the hidden tile
    const int j0 = j * kChunk;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t cq = (uint32_t)((j0 >> 5) + q) * 4 + (lane & 3);
      const uint4 bits = t > 0 ? philox4(seed, cq, c1, 0u) : make_uint4(0u, 0u, 0u, 0u);
      const uint4 bits_b = t > 0 && two_calls ? philox4(seed, cq, c1b, 0u) : bits;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j8 = 4 * q + jj;
        const int cl = 8 * j8 + 2 * (lane & 3);  // column in the chunk
        const float2 bia = *reinterpret_cast<const float2*>(b1s + j0 + cl);
        const uint32_t words[2] = {word_of(bits, jj), word_of(bits_b, jj)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = gelu_16(acc_h[4 * j8 + 2 * h] + bia.x, exact_gelu);
          float v1 = gelu_16(acc_h[4 * j8 + 2 * h + 1] + bia.y, exact_gelu);
          if (t > 0) {
            v0 = keep_or_zero(v0, (words[h] >> (8 * half[h])) & 255u, t, scale);
            v1 = keep_or_zero(v1, (words[h] >> (8 * (2 + half[h]))) & 255u, t, scale);
          }
          const int r = 16 * warp + (lane >> 2) + 8 * h;
          *reinterpret_cast<uint32_t*>(sgen + hs + r * 128 + ((j8 ^ (r & 7)) << 4) +
                                       4 * (lane & 3)) = Elem16<T>::pack(v0, v1);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
  }

  // the last chunk's GEMM2
  {
    const int l2 = 2 * nch - 1;
    mbar_wait(full(l2), round_parity(l2));
    wgmma_fence();
    const uint32_t w2s = slot(l2);
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks)
      wgmma_n256<T>(acc_o, kmajor_desc(base + hs + 32 * ks), kmajor_desc(w2s + 32 * ks), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<128>(acc_o);
  }

  // output epilogue: b2, stream-1 dropout, residual, store. Per group of 32
  // columns the thread's 8 residual pairs are loaded first, from clamped
  // addresses, and only the stores are predicated.
#pragma unroll
  for (int q = 0; q < kN2 / 32; ++q) {
    if (32 * q >= C2) continue;  // uniform: C2 is a multiple of 16
    float2 rv[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = min(8 * (4 * q + jj) + 2 * (lane & 3), C2 - 2);
        rv[jj][h] = res != nullptr ? load_pair(res + (size_t)min(rowa + 8 * h, N - 1) * C2 + col)
                                   : make_float2(0.f, 0.f);
      }
    const uint32_t cq = (uint32_t)q * 4 + (lane & 3);
    const uint4 bits = t > 0 ? philox4(seed, cq, c1, 1u) : make_uint4(0u, 0u, 0u, 0u);
    const uint4 bits_b = t > 0 && two_calls ? philox4(seed, cq, c1b, 1u) : bits;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j8 = 4 * q + jj;
      const int col = 8 * j8 + 2 * (lane & 3);
      const float2 bia = *reinterpret_cast<const float2*>(b2s + col);
      const uint32_t words[2] = {word_of(bits, jj), word_of(bits_b, jj)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rowa + 8 * h;
        float v0 = acc_o[4 * j8 + 2 * h] + bia.x;
        float v1 = acc_o[4 * j8 + 2 * h + 1] + bia.y;
        if (t > 0) {
          v0 = keep_or_zero(v0, (words[h] >> (8 * half[h])) & 255u, t, scale);
          v1 = keep_or_zero(v1, (words[h] >> (8 * (2 + half[h]))) & 255u, t, scale);
        }
        if (row < N && col < C2) store_pair(y + (size_t)row * C2 + col, v0 + rv[jj][h].x,
                                            v1 + rv[jj][h].y);
      }
    }
  }
}

// The weight image of weight_image_plain (ops/fused_mlp.py) in the 16-bit
// type T, one 16-byte chunk of 8 values a thread, from W1 (C, Hd) and W2 (Hd,
// C2) of type W.
template <typename W, typename T>
__global__ void weight_image_kernel(const W* __restrict__ w1, const W* __restrict__ w2,
                                    T* __restrict__ img, int C, int Hd, int C2) {
  using namespace tc;
  const int Cp = (C + 63) & ~63;
  const int per_chunk = (Cp + kN2) * kChunk / 8;  // 16-byte pieces per hidden chunk
  const int nch = (Hd + kChunk - 1) / kChunk;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nch * per_chunk) return;
  const int j = idx / per_chunk, rem = idx - j * per_chunk;
  float v[8];
  if (rem < Cp * 8) {  // W1 part: [input block][hidden unit n][storage chunk s]
    const int n = (rem >> 3) & 63, u = j * kChunk + n;
    const int k0 = (rem >> 9) * 64 + (((rem & 7) ^ (n & 7)) << 3);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = k0 + e < C && u < Hd ? to_f(w1[(size_t)(k0 + e) * Hd + u]) : 0.f;
  } else {  // W2 part: [output n][storage chunk s]
    const int r2 = rem - Cp * 8, n = r2 >> 3;
    const int u0 = j * kChunk + (((r2 & 7) ^ (n & 7)) << 3);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = u0 + e < Hd && n < C2 ? to_f(w2[(size_t)(u0 + e) * C2 + n]) : 0.f;
  }
  uint32_t packed[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) packed[p] = Elem16<T>::pack(v[2 * p], v[2 * p + 1]);
  *reinterpret_cast<uint4*>(img + (size_t)idx * 8) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

template <bool kAffine, typename T, typename O>
int launch_tc(const void* x, const float* aff_a, const float* aff_c, int n_per_sample,
              const void* img, const float* b1, const float* b2, const void* res, void* y,
              int N, int C, int Hd, int C2, int t, uint64_t seed, int exact_gelu, RowMap map,
              cudaStream_t stream) {
  using namespace tc;
  const int nkb = (C + 63) / 64;
  const size_t smem = 1024 + (size_t)nkb * kBlockBytes + kSlots * kSlotBytes + kBlockBytes +
                      kBiasOffset + 4 * ((size_t)(Hd + kChunk - 1) / kChunk * kChunk + kN2);
  if (smem > 232448) return -1;  // Hd beyond about 30,000
  auto kern = fused_mlp_tc_kernel<kAffine, T, O>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + tc::kRows - 1) / tc::kRows;
  if (blocks == 0) return 0;
  kern<<<blocks, tc::kThreads, smem, stream>>>(
      (const T*)x, aff_a, aff_c, n_per_sample, (const T*)img, b1, b2, (const O*)res, (O*)y, N,
      C, Hd, C2, t, seed, exact_gelu, map);
  return (int)cudaGetLastError();
}

// The row map of the entry points' last five integers, checked: the
// identity (all 0), or lw = Hl * Wl and ghw = H * W with Wl <= gw.
bool make_map(int lw, int wl, int gw, int ghw, int off, RowMap* m) {
  *m = RowMap{lw, wl, gw, ghw, off};
  if (lw == 0) return wl == 0 && gw == 0 && ghw == 0 && off == 0;
  return lw > 0 && wl > 0 && lw % wl == 0 && gw >= wl && ghw >= lw && ghw % gw == 0 &&
         off >= 0 && off + (lw / wl - 1) * gw + wl <= ghw;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16; res_dtype -1 = no residual. The
// last five integers before the stream are the dropout row map (RowMap: lw,
// wl, gw, ghw, off; all 0 for the identity); -1 for a map that is not one.
// The float32 kernels (K2 and K3 with x float32): x (N, C), w1 (C, Hd), w2
// (Hd, C2) float32; b1, b2 float32; res (N, C2) float32 or bfloat16; y (N, C2)
// float32. All contiguous. Returns the cudaError_t of the launch (0 on
// success), or -1 for x not float32 or a width the thread tile does not cover.
extern "C" int sdt_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* res, void* y, int N, int C,
                             int Hd, int C2, int x_dtype, int res_dtype, int t,
                             unsigned long long seed, int exact_gelu, int lw, int wl, int gw,
                             int ghw, int off, void* stream) {
  RowMap map;
  if (!make_map(lw, wl, gw, ghw, off, &map)) return -1;
  return dispatch_simt<false>(x, nullptr, nullptr, 1, w1, b1, w2, b2, res, y, N, C, Hd, C2,
                              x_dtype, res_dtype, t, seed, exact_gelu, map, stream);
}

// K3: as sdt_fused_mlp, with x (B * n_per_sample, C) the pre-norm rows of B
// samples and a, c (B, C) float32, the affine x * a[b] + c[b] applied to
// every row of sample b before the first product. Returns -1 also when N is
// not a multiple of n_per_sample.
extern "C" int sdt_fused_block_tail(const void* x, const void* a, const void* c,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* res, void* y, int N,
                                    int n_per_sample, int C, int Hd, int C2, int x_dtype,
                                    int res_dtype, int t, unsigned long long seed,
                                    int exact_gelu, int lw, int wl, int gw, int ghw, int off,
                                    void* stream) {
  RowMap map;
  if (n_per_sample <= 0 || N % n_per_sample != 0 || !make_map(lw, wl, gw, ghw, off, &map))
    return -1;
  return dispatch_simt<true>(x, (const float*)a, (const float*)c, n_per_sample, w1, b1, w2,
                             b2, res, y, N, C, Hd, C2, x_dtype, res_dtype, t, seed,
                             exact_gelu, map, stream);
}

// The weight image for the 16-bit kernels: w1 (C, Hd) and w2 (Hd, C2), both
// float32 (w_dtype 0), both bfloat16 (1) or both float16 (2), contiguous; img
// (Hd/64 rounded up, (C rounded up to 64 + 256) * 64) in bfloat16 (img_dtype
// 1) or float16 (2), 16-byte aligned. Returns the cudaError_t of the launch,
// or -1 for what the kernels do not take.
template <typename T>
int launch_image(const void* w1, const void* w2, void* img, int C, int Hd, int C2,
                 int w_dtype, int blocks, int threads, cudaStream_t s) {
  if (w_dtype == 0)
    weight_image_kernel<float, T><<<blocks, threads, 0, s>>>(
        (const float*)w1, (const float*)w2, (T*)img, C, Hd, C2);
  else if (w_dtype == 1)
    weight_image_kernel<__nv_bfloat16, T><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)w1, (const __nv_bfloat16*)w2, (T*)img, C, Hd, C2);
  else if (w_dtype == 2)
    weight_image_kernel<__half, T><<<blocks, threads, 0, s>>>(
        (const __half*)w1, (const __half*)w2, (T*)img, C, Hd, C2);
  else
    return -1;
  return (int)cudaGetLastError();
}

extern "C" int sdt_weight_image(const void* w1, const void* w2, void* img, int C, int Hd,
                                int C2, int w_dtype, int img_dtype, void* stream) {
  if (C <= 0 || C > tc::kMaxC || Hd <= 0 || C2 <= 0 || C2 > tc::kN2) return -1;
  const int pieces = (Hd + tc::kChunk - 1) / tc::kChunk * (((C + 63) & ~63) + tc::kN2) *
                     tc::kChunk / 8;
  const int threads = 256, blocks = (pieces + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (img_dtype == 1)
    return launch_image<__nv_bfloat16>(w1, w2, img, C, Hd, C2, w_dtype, blocks, threads, s);
  if (img_dtype == 2)
    return launch_image<__half>(w1, w2, img, C, Hd, C2, w_dtype, blocks, threads, s);
  return -1;
}

// K2 (aff_a == null) or K3 with x and the image in T: the output type O is
// float32 with a float32 residual, else T.
template <typename T>
int dispatch_tc(const void* x, const float* aff_a, const float* aff_c, int n_per_sample,
                const void* img, const float* b1, const float* b2, const void* res, void* y,
                int N, int C, int Hd, int C2, int res_dtype, int t, uint64_t seed,
                int exact_gelu, RowMap map, cudaStream_t s) {
  const bool affine = aff_a != nullptr;
  const int nps = affine ? n_per_sample : 1;
  if (res_dtype == 0)
    return affine ? launch_tc<true, T, float>(x, aff_a, aff_c, nps, img, b1, b2, res, y, N, C,
                                              Hd, C2, t, seed, exact_gelu, map, s)
                  : launch_tc<false, T, float>(x, aff_a, aff_c, nps, img, b1, b2, res, y, N, C,
                                               Hd, C2, t, seed, exact_gelu, map, s);
  return affine ? launch_tc<true, T, T>(x, aff_a, aff_c, nps, img, b1, b2, res, y, N, C, Hd, C2,
                                        t, seed, exact_gelu, map, s)
                : launch_tc<false, T, T>(x, aff_a, aff_c, nps, img, b1, b2, res, y, N, C, Hd,
                                         C2, t, seed, exact_gelu, map, s);
}

// The 16-bit kernels, K2 (a == c == null) and K3: x (N, C) in bfloat16
// (x_dtype 1) or float16 (2), 16-byte aligned; img the weight image of
// sdt_weight_image in x's type; b1 (Hd,), b2 (C2,) float32; a, c (B, C)
// float32 with N = B * n_per_sample; res (N, C2) float32 (y float32), of x's
// type (res_dtype == x_dtype) or none (y of x's type). C, Hd, C2 multiples of
// 16, C and C2 at most 256. Returns the cudaError_t of the launch, or -1 for
// what the kernel does not take.
extern "C" int sdt_fused_mlp_tc(const void* x, const void* a, const void* c, int n_per_sample,
                                const void* img, const void* b1, const void* b2,
                                const void* res, void* y, int N, int C, int Hd, int C2,
                                int x_dtype, int res_dtype, int t, unsigned long long seed,
                                int exact_gelu, int lw, int wl, int gw, int ghw, int off,
                                void* stream) {
  RowMap map;
  if (!make_map(lw, wl, gw, ghw, off, &map)) return -1;
  if (N < 0 || C <= 0 || C > tc::kMaxC || C % 16 || Hd <= 0 || Hd % 16 || C2 <= 0 ||
      C2 > tc::kN2 || C2 % 16 || (x_dtype != 1 && x_dtype != 2) ||
      (res_dtype != -1 && res_dtype != 0 && res_dtype != x_dtype))
    return -1;
  const bool affine = a != nullptr;
  if (affine != (c != nullptr)) return -1;
  if (affine && (n_per_sample <= 0 || N % n_per_sample != 0)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* fa = (const float*)a;
  const float* fc = (const float*)c;
  const float* fb1 = (const float*)b1;
  const float* fb2 = (const float*)b2;
  const void* r = res_dtype < 0 ? nullptr : res;
  if (x_dtype == 2)
    return dispatch_tc<__half>(x, fa, fc, n_per_sample, img, fb1, fb2, r, y, N, C, Hd, C2,
                               res_dtype, t, seed, exact_gelu, map, s);
  return dispatch_tc<__nv_bfloat16>(x, fa, fc, n_per_sample, img, fb1, fb2, r, y, N, C, Hd,
                                    C2, res_dtype, t, seed, exact_gelu, map, s);
}
