// K4: the CP rank pipeline's spectral middle -- Legendre analysis, per-l CP
// scale, Legendre synthesis -- in one kernel.
//
// Replaces the Pallas prototype scripts/proto_fused_rank.py (fused_kernel,
// pallas_call at :94, called through make_fused at :87). For one sample b
// and one azimuthal order m, with xf the DFT stage's output of the rank
// projection (channels [x@Ar | x@Ai], each with (re, im)):
//
//     t[l, c] = sum_h A[m, h, l] xf[b, h, m, c]         (c: 2R x 2 columns)
//     p[l, k] = (Sr_re - Si_im) + i (Sr_im + Si_re)    (k < R; Sr = t[l, k],
//     s[l, k] = p[l, k] * C[l, k]                        Si = t[l, R + k])
//     y[b, h, m, :] = sum_l S[m, h, l] [s | i s][l, :]
//
// Layout: xf and y (B, H, M, 2R, 2), A and S (M, H, L), all in one dtype T
// (float or bf16); C (L, R, 2) float. Rounding points are the model path's
// (ops/fused_rank.py): under bf16, t, s and y are rounded to bf16 where the
// plain version rounds them, and the scale is float32 without FMA
// contraction, as the plain version computes it.
//
// What bounds it on the H100: at the fast window's shape (H 180, L = M =
// 144, R 64) one call at B = 1 moves 41.5 MB (xf and y 13.3 MB each in
// bf16, A and S 7.5 MB each) and does 3.8 GFLOP of dense products, so the
// bytes bound it: 12.4 us at 3.35 TB/s against 3.9 us at the 989 TFLOP/s of
// the bf16 tensor cores. This first version uses float32 FMAs on the SIMT
// cores, so it runs far above that bound; tensor cores are later work.
//
// Design: one block of 256 threads per (16 rank indices, m, b): the 64
// input columns of those ranks (Sr and Si, re and im). It walks h in chunks
// of 16, staging the xf rows and the A rows of the chunk in shared memory,
// and keeps the whole t tile (up to 192 l x 64 columns) in registers, 48
// float32 sums a thread; t then goes to shared memory, where the scale runs
// in place, so t and s never reach device memory (what the TPU kernel kept
// in VMEM). The synthesis walks h in tiles of 64 and l in chunks of 16. The
// four output columns of a rank are y(k) = S s and y(R + k) = i S s, so the
// synthesis computes the two columns of S s and writes the other two as a
// copy and a negation (exact in floating point). A[m] and S[m] (52 KB each
// in bf16 at 180 x 144) are read by the R / 16 rank tiles and the B samples
// of one m, which run close together in launch order and find them in L2.
// P_l^m = 0 for l < m, so half of each Legendre product is structurally
// zero; skipping that triangle is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRanks = 16;            // rank indices per block
constexpr int kCols = 4 * kRanks;     // input columns per block
constexpr int kChunk = 16;            // h per analysis step, l per synthesis step
constexpr int kTileH = 64;            // h per synthesis tile

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the plain version's .to(dtype) on an
// intermediate
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// NI l-rows of 16 per thread: the kernel takes L <= 16 * NI
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
fused_rank_kernel(const T* __restrict__ xf, const T* __restrict__ At,
                  const T* __restrict__ St, const float* __restrict__ C,
                  T* __restrict__ y, int H, int M, int L, int R) {
  constexpr int Lp = 16 * NI;
  extern __shared__ float smem[];
  float* ts = smem;                  // [Lp][kCols]: t, then s in columns 0..31
  float* xs = ts + Lp * kCols;       // [kChunk][kCols]: an h chunk of xf
  float* as = xs + kChunk * kCols;   // [kChunk][Lp]: an h chunk of A[m]
  float* sst = xs;                   // [kTileH][kChunk + 1]: a tile of S[m]

  const int k0 = blockIdx.x * kRanks;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(kRanks, R - k0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t row = (size_t)M * 4 * R;  // elements between two h of xf and y
  const T* xb = xf + (size_t)b * H * row + (size_t)m * 4 * R;
  T* yb = y + (size_t)b * H * row + (size_t)m * 4 * R;
  const T* Am = At + (size_t)m * H * L;
  const T* Sm = St + (size_t)m * H * L;

  // local column j < 32: Sr of rank k0 + j / 2, (re, im) = j % 2;
  // j >= 32: Si of rank k0 + (j - 32) / 2
  auto col = [&](int j) { return j < 32 ? 2 * k0 + j : 2 * R + 2 * k0 + (j - 32); };

  // ---- Legendre analysis: t[l][j] = sum_h A[m, h, l] xf[b, h, m, col(j)]
  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kChunk) {
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int hh = e / kCols, j = e % kCols;
      float v = 0.f;
      if (h0 + hh < H && (j % 32) / 2 < nk) v = to_float(xb[(size_t)(h0 + hh) * row + col(j)]);
      xs[e] = v;
    }
    for (int e = tid; e < kChunk * Lp; e += kThreads) {
      const int hh = e / Lp, l = e % Lp;
      float v = 0.f;
      if (h0 + hh < H && l < L) v = to_float(Am[(size_t)(h0 + hh) * L + l]);
      as[e] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int hh = 0; hh < kChunk; ++hh) {
      float a[NI], x[4];
#pragma unroll
      for (int i = 0; i < NI; ++i) a[i] = as[hh * Lp + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = xs[hh * kCols + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ts[(ty + 16 * i) * kCols + tx + 16 * j] = round_to<T>(acc[i][j]);
  __syncthreads();

  // ---- per-l CP scale, in place: s_re, s_im of rank k0 + kk go to
  // columns 2 kk and 2 kk + 1 (read only by this item)
  for (int e = tid; e < L * kRanks; e += kThreads) {
    const int l = e / kRanks, kk = e % kRanks;
    if (kk >= nk) continue;
    float* r = ts + l * kCols;
    const float p_re = __fsub_rn(r[2 * kk], r[33 + 2 * kk]);
    const float p_im = __fadd_rn(r[2 * kk + 1], r[32 + 2 * kk]);
    const float cr = C[((size_t)l * R + k0 + kk) * 2];
    const float ci = C[((size_t)l * R + k0 + kk) * 2 + 1];
    const float s_re = __fsub_rn(__fmul_rn(p_re, cr), __fmul_rn(p_im, ci));
    const float s_im = __fadd_rn(__fmul_rn(p_re, ci), __fmul_rn(p_im, cr));
    r[2 * kk] = round_to<T>(s_re);
    r[2 * kk + 1] = round_to<T>(s_im);
  }
  __syncthreads();

  // ---- Legendre synthesis: for local q < 32 (rank k0 + q / 2, re or im of
  // s), u[h][q] = sum_l S[m, h, l] s[l][q]; then y(k0 + q/2, q%2) = u and
  // y(R + k0 + q/2, 1 - q%2) = +u (q even) or -u (q odd)
  for (int h0 = 0; h0 < H; h0 += kTileH) {
    float u[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i][0] = u[i][1] = 0.f;
    for (int l0 = 0; l0 < L; l0 += kChunk) {
      for (int e = tid; e < kTileH * kChunk; e += kThreads) {
        const int hh = e / kChunk, ll = e % kChunk;
        float v = 0.f;
        if (h0 + hh < H && l0 + ll < L) v = to_float(Sm[(size_t)(h0 + hh) * L + l0 + ll]);
        sst[hh * (kChunk + 1) + ll] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int ll = 0; ll < kChunk; ++ll) {
        // rows l >= L of ts hold zeros (their A rows were staged as zeros)
        const float s0 = ts[(l0 + ll) * kCols + tx];
        const float s1 = ts[(l0 + ll) * kCols + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = sst[(ty + 16 * i) * (kChunk + 1) + ll];
          u[i][0] = fmaf(a, s0, u[i][0]);
          u[i][1] = fmaf(a, s1, u[i][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = h0 + ty + 16 * i;
      if (h >= H) continue;
      T* yr = yb + (size_t)h * row;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = tx + 16 * j;
        if (q / 2 >= nk) continue;
        const T v = from_float<T>(u[i][j]);
        const T nv = from_float<T>(-u[i][j]);
        yr[2 * k0 + q] = v;
        yr[2 * R + 2 * k0 + (q ^ 1)] = (q & 1) ? nv : v;
      }
    }
  }
}

template <typename T, int NI>
int launch(const void* xf, const void* At, const void* St, const float* C, void* y, int B,
           int H, int M, int L, int R, cudaStream_t stream) {
  constexpr int Lp = 16 * NI;
  const size_t smem = sizeof(float) * ((size_t)Lp * kCols + kChunk * kCols + kChunk * Lp);
  auto kernel = fused_rank_kernel<T, NI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + kRanks - 1) / kRanks, M, B);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)xf, (const T*)At, (const T*)St, C, (T*)y,
                                           H, M, L, R);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* xf, const void* At, const void* St, const float* C, void* y, int B,
             int H, int M, int L, int R, cudaStream_t s) {
  if (L <= 48) return launch<T, 3>(xf, At, St, C, y, B, H, M, L, R, s);
  if (L <= 96) return launch<T, 6>(xf, At, St, C, y, B, H, M, L, R, s);
  if (L <= 144) return launch<T, 9>(xf, At, St, C, y, B, H, M, L, R, s);
  if (L <= 192) return launch<T, 12>(xf, At, St, C, y, B, H, M, L, R, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xf, y: (B, H, M, 2R, 2); At, St: (M, H, L); all contiguous in one dtype
// (dtype 0 float32, 1 bf16); C: (L, R, 2) float32. L <= 192. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sdt_fused_rank(const void* xf, const void* At, const void* St, const void* C,
                              void* y, int B, int H, int M, int L, int R, int dtype,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)C;
  if (dtype == 0) return dispatch<float>(xf, At, St, c, y, B, H, M, L, R, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(xf, At, St, c, y, B, H, M, L, R, s);
  return (int)cudaErrorInvalidValue;
}
