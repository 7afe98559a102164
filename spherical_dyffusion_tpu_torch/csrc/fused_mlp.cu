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
// multiple of the 64-row tile, so a tile may hold rows of two samples, and
// each row reads the A and C of its own sample. The affine is computed as a
// rounded product and a rounded sum (no FMA contraction), as the plain
// version computes it. K3 is K2's kernel template with kAffine set: with
// A = 1 and C = 0, xn is x exactly and K3 equals K2 bit for bit.
//
// Quantized dropout keeps an element iff (bits & 255) < t and scales it by
// 256 / t; t == 0 means dropout off. The bits come from Philox4x32-10 keyed by
// the 64-bit seed and counted by (column, row, stream, 0), stream 0 for the
// hidden mask and 1 for the output mask; in K3 the row is the flat row
// b * N + n. The plain versions in spherical_dyffusion_tpu_torch/ops/fused_mlp.py
// compute the same bits. The TPU kernels draw per-tile hardware bits, which
// cannot be reproduced: the port agrees with them in distribution only.
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
// Design: one block of 256 threads owns 64 rows. It stages its x tile in
// shared memory once (applying K3's affine on the way), then for each chunk
// of 64 hidden units computes the 64 x 64 hidden tile with float32 FMAs (W1
// staged in slices of 32 rows), applies bias, gelu and the dropout mask,
// rounds it to the input type into shared memory (as the TPU kernel does
// between its GEMMs), and accumulates hidden_chunk @ W2_chunk into a
// 64 x 256 float32 tile held in registers (8 rows x 8 columns per thread).
// Rows past B * N read zeros and are never stored. This first version does
// its products with float32 FMAs, not tensor cores, so it sits far above its
// bound; mma/wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // rows of x per block
constexpr int kHidden = 64;   // hidden units per chunk
constexpr int kSlice = 32;    // rows of W1 / W2 staged at a time
constexpr int kMaxOut = 256;  // widest output row a thread tile covers
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Philox4x32-10; returns the first output word.
__device__ __forceinline__ uint32_t philox_word0(uint64_t seed, uint32_t c0,
                                                 uint32_t c1, uint32_t c2) {
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
  return c0;
}

__device__ __forceinline__ float gelu(float v, int exact) {
  if (exact) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

__device__ __forceinline__ float qdrop(float v, int t, uint64_t seed,
                                       uint32_t row, uint32_t col,
                                       uint32_t stream) {
  const uint32_t bits = philox_word0(seed, col, row, stream) & 255u;
  return bits < (uint32_t)t ? v * (256.f / (float)t) : 0.f;
}

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
                 uint64_t seed, int exact_gelu) {
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
          if (t > 0) v = qdrop(v, t, seed, (uint32_t)(r0 + rbase + i), (uint32_t)col, 0u);
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
      if (t > 0) v = qdrop(v, t, seed, (uint32_t)row, (uint32_t)col, 1u);
      if (res != nullptr) v += to_f(res[(size_t)row * C2 + col]);
      y[(size_t)row * C2 + col] = from_f<O>(v);
    }
  }
}

template <bool kAffine, typename T, typename R, typename O>
int launch(const void* x, const float* aff_a, const float* aff_c, int n_per_sample,
           const void* w1, const float* b1, const void* w2, const float* b2,
           const void* res, void* y, int N, int C, int Hd, int C2, int t, uint64_t seed,
           int exact_gelu, cudaStream_t stream) {
  const int wsw = C2 > kHidden ? C2 : kHidden;
  const size_t smem = sizeof(T) * ((size_t)kRows * C + kRows * kHidden + (size_t)kSlice * wsw);
  auto kern = fused_mlp_kernel<kAffine, T, R, O>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kRows - 1) / kRows;
  kern<<<blocks, kThreads, smem, stream>>>(
      (const T*)x, aff_a, aff_c, n_per_sample, (const T*)w1, b1, (const T*)w2, b2,
      (const R*)res, (O*)y, N, C, Hd, C2, t, seed, exact_gelu);
  return (int)cudaGetLastError();
}

// The four (input, residual, output) type combinations of both kernels.
template <bool kAffine>
int dispatch(const void* x, const float* aff_a, const float* aff_c, int n_per_sample,
             const void* w1, const void* b1, const void* w2, const void* b2,
             const void* res, void* y, int N, int C, int Hd, int C2, int x_dtype,
             int res_dtype, int t, uint64_t seed, int exact_gelu, void* stream) {
  if (C2 > kMaxOut || C2 <= 0 || C <= 0 || Hd <= 0 || N < 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* fb1 = (const float*)b1;
  const float* fb2 = (const float*)b2;
  const void* r = res_dtype < 0 ? nullptr : res;
  if (x_dtype == 0 && res_dtype != 1)
    return launch<kAffine, float, float, float>(x, aff_a, aff_c, n_per_sample, w1, fb1, w2,
                                                fb2, r, y, N, C, Hd, C2, t, seed,
                                                exact_gelu, s);
  if (x_dtype == 0 && res_dtype == 1)
    return launch<kAffine, float, __nv_bfloat16, float>(x, aff_a, aff_c, n_per_sample, w1,
                                                        fb1, w2, fb2, r, y, N, C, Hd, C2,
                                                        t, seed, exact_gelu, s);
  if (x_dtype == 1 && res_dtype == 0)
    return launch<kAffine, __nv_bfloat16, float, float>(x, aff_a, aff_c, n_per_sample, w1,
                                                        fb1, w2, fb2, r, y, N, C, Hd, C2,
                                                        t, seed, exact_gelu, s);
  if (x_dtype == 1)
    return launch<kAffine, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        x, aff_a, aff_c, n_per_sample, w1, fb1, w2, fb2, r, y, N, C, Hd, C2, t, seed,
        exact_gelu, s);
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; res_dtype -1 = no residual.
// x (N, C), w1 (C, Hd), w2 (Hd, C2) in x's dtype; b1, b2 float32; res and y
// (N, C2); y is float32 if x or res is float32, else bfloat16. All contiguous.
// Returns the cudaError_t of the launch (0 on success), or -1 for an
// unsupported dtype combination or a width the thread tile does not cover.
extern "C" int sdt_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* res, void* y, int N, int C,
                             int Hd, int C2, int x_dtype, int res_dtype, int t,
                             unsigned long long seed, int exact_gelu, void* stream) {
  return dispatch<false>(x, nullptr, nullptr, 1, w1, b1, w2, b2, res, y, N, C, Hd, C2,
                         x_dtype, res_dtype, t, seed, exact_gelu, stream);
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
                                    int exact_gelu, void* stream) {
  if (n_per_sample <= 0 || N % n_per_sample != 0) return -1;
  return dispatch<true>(x, (const float*)a, (const float*)c, n_per_sample, w1, b1, w2, b2,
                        res, y, N, C, Hd, C2, x_dtype, res_dtype, t, seed, exact_gelu,
                        stream);
}
