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
// Layout: xf (B, H, M, 2R, 2), A (M, H, L), S (M, H_out, L), y (B, H_out, M,
// 2R, 2), all in one dtype T (float, bf16 or fp16); C (L, R, 2) float;
// l_first (M,) int32. The synthesis has its own row count H_out: on a grid
// split over latitudes a rank analyses every latitude and synthesizes its
// block's rows (H_out = H on one device). Rounding points are the model
// path's (ops/fused_rank.py): under bf16 (fp16), t, s and y are rounded to
// bf16 (fp16) where the plain version rounds them, and the scale is float32
// without FMA contraction, as the plain version computes it.
//
// The Legendre triangle. The associated Legendre functions vanish for
// l < m, so A[m] and S[m] are zero in their first m columns. The transforms
// record, per m, the first l at which A[m] or S[m] is non-zero (l_first,
// read from the matrices themselves; 0 for matrices without zeros), and both
// instances run the analysis rows and the synthesis depth only over
// [lb, L), lb = l_first[m] rounded down to 16. Rows l < l_first of t are
// exactly zero and meet zero columns of S, so the skip changes no sum.
//
// What bounds it on the H100: at the fast window's shape (H 180, L = M =
// 144, R 64, legendre-gauss grid, where the triangle l >= m holds 50.3% of
// A and S) one call at B = 1 must move 34.1 MB (xf and y 13.3 MB each in
// bf16, the triangles of A and S 3.8 MB each, C 74 KB) and do 1.9 GFLOP
// over the triangle, so bytes bound it: 10.2 us at 3.35 TB/s (18.1 us at
// B = 2) against 2 us at the 989 TFLOP/s of the bf16 tensor cores.
//
// 16-bit design (fused_rank_tc_kernel: both products on wgmma, float32
// accumulation; one instance for bf16 and one for fp16, which differ only in
// wgmma's operand type and the rounding of t, s and y, so the notes below,
// written for bf16, hold for fp16 with the same bytes and rate). One block
// is one warpgroup (128 threads) and owns 16 rank indices (the 64 input
// columns Sr and Si, re and im) of one (b, m); blocks run heaviest m first
// (m is the outer grid axis, and l_first grows with m).
// Up to H 192, everything a block needs fits in shared memory at once (109
// KB at H 180, L 144: two blocks an SM); a taller grid goes through h in
// chunks of 192 rows, the analysis summing over the chunks and the synthesis
// writing one chunk's rows at a time, from the same shared memory. Operands
// are staged into the 128-byte swizzle by 16-byte
// cp.async copies, all of a phase in flight at once, where the strides
// allow (R % 4 == 0, L % 8 == 0), and by 2-byte loads through registers
// where they do not (the ragged shapes: a 1,160-byte h stride in xf, a
// 58-byte row in A), from clamped addresses in batches of four:
//   - analysis t = A_m^T xf_m: M = l (up to three tiles of 64 from lb),
//     K = h (a chunk rounded up to 64), N = the 64 columns. A_m is [h][l] and xf_m
//     [h][column], so both operands are MN-major (wgmma's transposes, which
//     only 16-bit types have): rows of h, 64 l or 64 columns to a row;
//   - the CP scale in registers: a thread's accumulator fragment holds Sr
//     (columns 8q + 2(lane % 4) + {0, 1}) and Si (the same + 32) of the same
//     rank and l, so t is rounded to bf16, scaled in float32 with
//     __fmul_rn/__fsub_rn/__fadd_rn and rounded to bf16 without leaving the
//     thread, and s lands in shared memory as the synthesis B operand
//     (K-major: 32 rows, the re and im of each rank, l along the row);
//   - synthesis u = S_m s: M = h (a chunk rounded up to 64, three tiles of
//     64 at H 180), K = l from lb (in steps of 16), N = the 32 columns of S s. S_m
//     is [h][l]: K-major, staged into the region A_m used, its copies in
//     flight while the scale runs. y(k) = S s and
//     y(R + k) = i S s, so the other 32 output columns are a copy and a
//     negation of u (exact), stored as bf16 pairs.
// The block's A_m and S_m (52 KB each at 180 x 144) are read by the R / 16
// rank tiles and B samples of one m, adjacent in launch order, from L2.
// What bounds this design: each block makes two dependent round trips to
// memory (xf and A_m, then S_m) around short products, and every rank tile
// of an m reads A_m and S_m again; at the fast window's shape it takes
// about 4x its bound on an H100 SXM at 700 W (PERF.md).
//
// float32 design (fused_rank_kernel, the CUDA cores; it serves the float32
// checks, which hold K4 to 1e-5 of the plain float32 version): one block of
// 256 threads per (16 rank indices, m, b) walks h in chunks of 16, staging
// the xf rows and the A rows of the chunk in shared memory, and keeps the t
// tile (up to 192 l x 64 columns) in registers, 48 float32 sums a thread;
// t then goes to shared memory, where the scale runs in place. The
// synthesis walks h in tiles of 64 and l in chunks of 16 from lb, and writes
// the other two columns of a rank as a copy and a negation.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kRanks = 16;  // rank indices per block

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel

constexpr int kThreads = 256;
constexpr int kCols = 4 * kRanks;     // input columns per block
constexpr int kChunk = 16;            // h per analysis step, l per synthesis step
constexpr int kTileH = 64;            // h per synthesis tile

// NI l-rows of 16 per thread: the kernel takes L <= 16 * NI
template <int NI>
__global__ void __launch_bounds__(kThreads)
fused_rank_kernel(const float* __restrict__ xf, const float* __restrict__ At,
                  const float* __restrict__ St, const float* __restrict__ C,
                  const int* __restrict__ l_first, float* __restrict__ y, int H, int H_out,
                  int M, int L, int R) {
  constexpr int Lp = 16 * NI;
  extern __shared__ float smem[];
  float* ts = smem;                  // [Lp][kCols]: t (row l - lb), then s in columns 0..31
  float* xs = ts + Lp * kCols;       // [kChunk][kCols]: an h chunk of xf
  float* as = xs + kChunk * kCols;   // [kChunk][Lp]: an h chunk of A[m], from column lb
  float* sst = xs;                   // [kTileH][kChunk + 1]: a tile of S[m]

  const int k0 = blockIdx.x * kRanks;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(kRanks, R - k0);
  const int lb = min(max(l_first[m], 0), L) & ~15;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t row = (size_t)M * 4 * R;  // elements between two h of xf and y
  const float* xb = xf + (size_t)b * H * row + (size_t)m * 4 * R;
  float* yb = y + (size_t)b * H_out * row + (size_t)m * 4 * R;
  const float* Am = At + (size_t)m * H * L;
  const float* Sm = St + (size_t)m * H_out * L;

  // local column j < 32: Sr of rank k0 + j / 2, (re, im) = j % 2;
  // j >= 32: Si of rank k0 + (j - 32) / 2
  auto col = [&](int j) { return j < 32 ? 2 * k0 + j : 2 * R + 2 * k0 + (j - 32); };

  // ---- Legendre analysis: t[l - lb][j] = sum_h A[m, h, l] xf[b, h, m, col(j)]
  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kChunk) {
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int hh = e / kCols, j = e % kCols;
      float v = 0.f;
      if (h0 + hh < H && (j % 32) / 2 < nk) v = xb[(size_t)(h0 + hh) * row + col(j)];
      xs[e] = v;
    }
    for (int e = tid; e < kChunk * Lp; e += kThreads) {
      const int hh = e / Lp, l = lb + e % Lp;
      float v = 0.f;
      if (h0 + hh < H && l < L) v = Am[(size_t)(h0 + hh) * L + l];
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
    for (int j = 0; j < 4; ++j) ts[(ty + 16 * i) * kCols + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // ---- per-l CP scale, in place: s_re, s_im of rank k0 + kk go to
  // columns 2 kk and 2 kk + 1 (read only by this item)
  for (int e = tid; e < (L - lb) * kRanks; e += kThreads) {
    const int lr = e / kRanks, kk = e % kRanks, l = lb + lr;
    if (kk >= nk) continue;
    float* r = ts + lr * kCols;
    const float p_re = __fsub_rn(r[2 * kk], r[33 + 2 * kk]);
    const float p_im = __fadd_rn(r[2 * kk + 1], r[32 + 2 * kk]);
    const float cr = C[((size_t)l * R + k0 + kk) * 2];
    const float ci = C[((size_t)l * R + k0 + kk) * 2 + 1];
    r[2 * kk] = __fsub_rn(__fmul_rn(p_re, cr), __fmul_rn(p_im, ci));
    r[2 * kk + 1] = __fadd_rn(__fmul_rn(p_re, ci), __fmul_rn(p_im, cr));
  }
  __syncthreads();

  // ---- Legendre synthesis over l in [lb, L): for local q < 32 (rank
  // k0 + q / 2, re or im of s), u[h][q] = sum_l S[m, h, l] s[l][q]; then
  // y(k0 + q/2, q%2) = u and y(R + k0 + q/2, 1 - q%2) = +u (q even) or -u
  // (q odd)
  for (int h0 = 0; h0 < H_out; h0 += kTileH) {
    float u[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i][0] = u[i][1] = 0.f;
    for (int l0 = 0; l0 < L - lb; l0 += kChunk) {
      for (int e = tid; e < kTileH * kChunk; e += kThreads) {
        const int hh = e / kChunk, ll = e % kChunk, l = lb + l0 + ll;
        float v = 0.f;
        if (h0 + hh < H_out && l < L) v = Sm[(size_t)(h0 + hh) * L + l];
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
      if (h >= H_out) continue;
      float* yr = yb + (size_t)h * row;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = tx + 16 * j;
        if (q / 2 >= nk) continue;
        yr[2 * k0 + q] = u[i][j];
        yr[2 * R + 2 * k0 + (q ^ 1)] = (q & 1) ? -u[i][j] : u[i][j];
      }
    }
  }
}

template <int NI>
int launch_simt(const void* xf, const void* At, const void* St, const float* C,
                const int* l_first, void* y, int B, int H, int H_out, int M, int L, int R,
                cudaStream_t stream) {
  constexpr int Lp = 16 * NI;
  const size_t smem = sizeof(float) * ((size_t)Lp * kCols + kChunk * kCols + kChunk * Lp);
  auto kernel = fused_rank_kernel<NI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + kRanks - 1) / kRanks, M, B);
  kernel<<<grid, kThreads, smem, stream>>>((const float*)xf, (const float*)At, (const float*)St,
                                           C, l_first, (float*)y, H, H_out, M, L, R);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and fp16: the tensor-core kernel

namespace tc {
constexpr int kThreads = 128;   // one warpgroup
constexpr int kMaxTiles = 3;    // 64-row tiles of l (analysis) and of h (synthesis)
constexpr int kMaxHL = 64 * kMaxTiles;
constexpr uint32_t kSBlock = 4096;  // s: one 64-deep K block, 32 rows x 128 B
constexpr uint32_t kTile = 8192;    // 64 rows x 128 B
}  // namespace tc

// D += A B, m64n64k16, both operands MN-major (imm-trans-a = imm-trans-b =
// 1), and m64n32k16, both operands K-major; TY is the PTX type of the 16-bit
// operands, "bf16" or "f16".
#define SDT_WGMMA_N64_MN(TY)                                                                  \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %34, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "    \
      "%32, %33, p, 1, 1, 1, 1;\n}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
        "+f"(d[31])                                                                           \
      : "l"(a), "l"(b), "r"(1))

#define SDT_WGMMA_N32(TY)                                                                     \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %18, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "              \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                                 \
      : "l"(a), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_n64_mn(float* d, uint64_t a, uint64_t b) {
  if constexpr (std::is_same<T, __half>::value)
    SDT_WGMMA_N64_MN("f16");
  else
    SDT_WGMMA_N64_MN("bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t a, uint64_t b) {
  if constexpr (std::is_same<T, __half>::value)
    SDT_WGMMA_N32("f16");
  else
    SDT_WGMMA_N32("bf16");
}

// Eight 16-bit values of a 16-byte chunk from p, of which the first `valid`
// (0 to 8) are in range: 2-byte loads of the valid ones.
__device__ __forceinline__ uint4 load8(const void* p, int valid) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < valid ? __ldg(q + 2 * i) : 0u;
    const uint32_t hi = 2 * i + 1 < valid ? __ldg(q + 2 * i + 1) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// cp.async of 16 bytes from global src to shared dst, of which the first
// `bytes` (0 or 16) are read and the rest are written as zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Writes n 16-byte chunks into shared memory: chunk e comes from src(e),
// which returns the chunk's first element (always a valid address) and
// sets how many of its 8 elements are in range, and goes to byte dst(e).
// kVec (16-byte aligned chunks, valid 0 or 8): one cp.async a chunk, all of
// them in flight at once, completed by cp_async_wait_all; otherwise 2-byte
// loads through registers, four chunks of a thread in flight before their
// stores.
template <bool kVec, typename Src, typename Dst>
__device__ __forceinline__ void stage(unsigned char* sgen, int n, Src src, Dst dst) {
  if constexpr (kVec) {
    const uint32_t base = smem_u32(sgen);
    for (int e = threadIdx.x; e < n; e += tc::kThreads) {
      int valid;
      const void* p = src(e, valid);
      cp_async16(base + dst(e), p, 2 * valid);
    }
  } else {
    for (int e0 = threadIdx.x; e0 < n; e0 += 4 * tc::kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = min(e0 + u * tc::kThreads, n - 1);
        int valid;
        const void* p = src(e, valid);
        v[u] = load8(p, valid);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * tc::kThreads;
        if (e < n) *reinterpret_cast<uint4*>(sgen + dst(e)) = v[u];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ float round16(float v) {
  return Elem16<T>::widen(Elem16<T>::round(v));
}

// the byte of 16-byte chunk c of row r in a 128-byte-swizzle tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)r * 128 + (uint32_t)((c ^ (r & 7)) << 4);
}

// T: the 16-bit element type, bf16 or fp16 (xf, A, S, y and the rounding
// points); the instances differ in nothing else.
template <typename T, bool kVec>
__global__ void __launch_bounds__(tc::kThreads, 2)
fused_rank_tc_kernel(const T* __restrict__ xf, const T* __restrict__ At,
                     const T* __restrict__ St, const float2* __restrict__ C,
                     const int* __restrict__ l_first, T* __restrict__ y, int H,
                     int H_out, int M, int L, int R) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_k4[];
  const uint32_t raw = smem_u32(smem_k4);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sgen = smem_k4 + (base - raw);  // generic pointer to base

  // h goes in chunks of Hc rows (one chunk up to H 192): the analysis sums
  // over the chunks of H, the synthesis writes the rows of one chunk of H_out
  // at a time
  const int Hc = min((H + 63) & ~63, kMaxHL);
  const uint32_t xs = 0;                                     // xf: [Hc][64 columns]
  const uint32_t ms = (uint32_t)Hc * 128;                    // A_m, then S_m
  const uint32_t ss = ms + (uint32_t)((L + 63) / 64) * Hc * 128;  // s: [K block][32][64]

  const int nrt = (R + kRanks - 1) / kRanks;
  const int rt = blockIdx.x % nrt, b = blockIdx.x / nrt;
  const int m = blockIdx.y;
  const int k0 = rt * kRanks, nk = min(kRanks, R - k0);
  const int lb = min(max(l_first[m], 0), L) & ~15;
  const int nl = L - lb;           // rows of t, depth of the synthesis
  const int nlt = (nl + 63) / 64;  // l tiles = K blocks of 64 of the synthesis
  const size_t row = (size_t)M * 4 * R;  // elements between two h of xf and y
  const T* xb = xf + (size_t)b * H * row + (size_t)m * 4 * R;
  T* yb = y + (size_t)b * H_out * row + (size_t)m * 4 * R;
  const T* Am = At + (size_t)m * H * L;
  const T* Sm = St + (size_t)m * H_out * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // ---- Legendre analysis: t (l x 64) = A_m^T xf_m, both operands MN-major,
  // summed over the h chunks
  float acc[kMaxTiles][32];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
  for (int h0 = 0; h0 < H; h0 += Hc) {
    const int hr = min(Hc, (H - h0 + 63) & ~63);  // staged rows of this chunk
    // xf_m (chunk c < 4: Sr columns 8c.., else Si) and A_m[:, lb:], rows h0..
    stage<kVec>(
        sgen, hr * 8,
        [&](int e, int& valid) {
          const int h = h0 + (e >> 3), c = e & 7;
          valid = h < H ? max(0, min(8, 2 * (nk - 4 * (c & 3)))) : 0;
          return xb + (size_t)min(h, H - 1) * row + (c < 4 ? 2 * k0 : 2 * R + 2 * k0) +
                 8 * (c & 3) * (valid > 0);
        },
        [&](int e) { return xs + swz(e >> 3, e & 7); });
    stage<kVec>(
        sgen, nlt * hr * 8,
        [&](int e, int& valid) {
          const int t = e / (hr * 8), r = e - t * hr * 8, h = h0 + (r >> 3);
          const int l = lb + 64 * t + 8 * (r & 7);
          valid = h < H ? max(0, min(8, L - l)) : 0;
          return Am + (size_t)min(h, H - 1) * L + (valid > 0 ? l : 0);
        },
        [&](int e) {
          const int t = e / (hr * 8), r = e - t * hr * 8;
          return ms + (uint32_t)t * Hc * 128 + swz(r >> 3, r & 7);
        });
    if constexpr (kVec) cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    for (int ks = 0; ks < hr / 16; ++ks) {
      const uint64_t bx = mnmajor_desc(base + xs + 2048u * ks);
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t)
        if (t < nlt)
          wgmma_n64_mn<T>(acc[t],
                            mnmajor_desc(base + ms + (uint32_t)t * Hc * 128 + 2048u * ks), bx);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) fence_regs<32>(acc[t]);
    __syncthreads();  // the chunk's region is free
  }

  // ---- S_m[h0.., lb:] into A_m's region, K-major: [h tile][K block][64
  // rows][64 l], nht tiles of 64 h
  const int per_tile = nlt * 512;  // chunks per h tile
  auto stage_S = [&](int h0, int nht) {
    stage<kVec>(
        sgen, nht * per_tile,
        [&](int e, int& valid) {
          const int ht = e / per_tile, r = e - ht * per_tile, kb = r >> 9, rr = r & 511;
          const int h = h0 + 64 * ht + (rr >> 3), l = lb + 64 * kb + 8 * (rr & 7);
          valid = h < H_out ? max(0, min(8, L - l)) : 0;
          return Sm + (size_t)min(h, H_out - 1) * L + (valid > 0 ? l : 0);
        },
        [&](int e) {
          const int ht = e / per_tile, r = e - ht * per_tile, kb = r >> 9, rr = r & 511;
          return ms + (uint32_t)(ht * nlt + kb) * kTile + swz(rr >> 3, rr & 7);
        });
  };
  stage_S(0, min(Hc, (H_out + 63) & ~63) / 64);  // in flight during the scale

  // ---- the CP scale in registers: row lr = l - lb of t; the thread holds Sr
  // (columns 8q + 2(lane % 4) + {0, 1}) and Si (the same + 32) of rank
  // kk = 4q + lane % 4. s goes to the synthesis B operand: row 2 kk (re) or
  // 2 kk + 1 (im), K = lr. Rows past L and ranks past nk are zero.
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    if (t >= nlt) continue;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int lr = 64 * t + 16 * warp + (lane >> 2) + 8 * h2, l = lb + lr;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = 4 * q + (lane & 3);
        float s_re = 0.f, s_im = 0.f;
        if (l < L && kk < nk) {
          const float sr_re = round16<T>(acc[t][4 * q + 2 * h2]);
          const float sr_im = round16<T>(acc[t][4 * q + 2 * h2 + 1]);
          const float si_re = round16<T>(acc[t][4 * (q + 4) + 2 * h2]);
          const float si_im = round16<T>(acc[t][4 * (q + 4) + 2 * h2 + 1]);
          const float p_re = __fsub_rn(sr_re, si_im), p_im = __fadd_rn(sr_im, si_re);
          const float2 c = C[(size_t)l * R + k0 + kk];
          s_re = __fsub_rn(__fmul_rn(p_re, c.x), __fmul_rn(p_im, c.y));
          s_im = __fadd_rn(__fmul_rn(p_re, c.y), __fmul_rn(p_im, c.x));
        }
        const uint32_t at = ss + (uint32_t)t * kSBlock + (uint32_t)((lr & 7) * 2);
        *reinterpret_cast<T*>(sgen + at + swz(2 * kk, (lr & 63) >> 3)) =
            Elem16<T>::round(s_re);
        *reinterpret_cast<T*>(sgen + at + swz(2 * kk + 1, (lr & 63) >> 3)) =
            Elem16<T>::round(s_im);
      }
    }
  }

  // ---- Legendre synthesis, chunk by chunk of h: u (h x 32) = S_m s, both
  // operands K-major
  for (int h0 = 0; h0 < H_out; h0 += Hc) {
    const int nht = min(Hc, (H_out - h0 + 63) & ~63) / 64;
    if (h0 > 0) {
      __syncthreads();  // the previous chunk's products have read S_m
      stage_S(h0, nht);
    }
    if constexpr (kVec) cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    float u[kMaxTiles][16];
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t)
#pragma unroll
      for (int i = 0; i < 16; ++i) u[t][i] = 0.f;
    wgmma_fence();
    for (int ks = 0; ks < (nl + 15) / 16; ++ks) {
      const int kb = ks >> 2;
      const uint32_t ko = 32u * (ks & 3);
      const uint64_t bs = kmajor_desc(base + ss + (uint32_t)kb * kSBlock + ko);
#pragma unroll
      for (int ht = 0; ht < kMaxTiles; ++ht)
        if (ht < nht)
          wgmma_n32<T>(u[ht], kmajor_desc(base + ms + (uint32_t)(ht * nlt + kb) * kTile + ko),
                         bs);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) fence_regs<16>(u[t]);

    // y: (u_re, u_im) for rank k0 + kk and (-u_im, u_re) for R + k0 + kk,
    // as pairs of T; the thread holds rows h and h + 8, columns 8j + 2(lane % 4)
#pragma unroll
    for (int ht = 0; ht < kMaxTiles; ++ht) {
      if (ht >= nht) continue;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int h = h0 + 64 * ht + 16 * warp + (lane >> 2) + 8 * h2;
        if (h >= H_out) continue;
        T* yr = yb + (size_t)h * row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = 4 * j + (lane & 3);
          if (kk >= nk) continue;
          const float re = u[ht][4 * j + 2 * h2], im = u[ht][4 * j + 2 * h2 + 1];
          *reinterpret_cast<uint32_t*>(yr + 2 * (k0 + kk)) = Elem16<T>::pack(re, im);
          *reinterpret_cast<uint32_t*>(yr + 2 * (R + k0 + kk)) = Elem16<T>::pack(-im, re);
        }
      }
    }
  }
}

template <typename T, bool kVec>
int launch_tc(const void* xf, const void* At, const void* St, const float* C,
              const int* l_first, void* y, int B, int H, int H_out, int M, int L, int R,
              cudaStream_t stream) {
  using namespace tc;
  const size_t Hc = std::min((size_t)(H + 63) / 64 * 64, (size_t)kMaxHL);
  const size_t nkb = (size_t)(L + 63) / 64;
  const size_t smem = 1024 + Hc * 128 * (1 + nkb) + nkb * kSBlock;
  auto kernel = fused_rank_tc_kernel<T, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(((R + kRanks - 1) / kRanks) * B, M);
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      (const T*)xf, (const T*)At, (const T*)St, (const float2*)C, l_first, (T*)y, H, H_out, M,
      L, R);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// xf: (B, H, M, 2R, 2); At: (M, H, L); St: (M, H_out, L); y: (B, H_out, M,
// 2R, 2); all contiguous in one dtype (dtype 0 float32, 1 bf16, 2 fp16); C:
// (L, R, 2) float32; l_first: (M,) int32, per m a column before which A[m] and S[m] are
// zero (0 skips nothing). L <= 192. Returns the cudaError_t of the launch (0
// on success).
extern "C" int sdt_fused_rank(const void* xf, const void* At, const void* St, const void* C,
                              const void* l_first, void* y, int B, int H, int H_out, int M,
                              int L, int R, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)C;
  const int* lf = (const int*)l_first;
  if (B <= 0 || H <= 0 || H_out <= 0 || M <= 0 || L <= 0 || R <= 0 || L > tc::kMaxHL ||
      M > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    if (L <= 48) return launch_simt<3>(xf, At, St, c, lf, y, B, H, H_out, M, L, R, s);
    if (L <= 96) return launch_simt<6>(xf, At, St, c, lf, y, B, H, H_out, M, L, R, s);
    if (L <= 144) return launch_simt<9>(xf, At, St, c, lf, y, B, H, H_out, M, L, R, s);
    return launch_simt<12>(xf, At, St, c, lf, y, B, H, H_out, M, L, R, s);
  }
  const bool vec = R % 4 == 0 && L % 8 == 0 && aligned16(xf) && aligned16(At) &&
                   aligned16(St);
  if (dtype == 1)
    return vec ? launch_tc<__nv_bfloat16, true>(xf, At, St, c, lf, y, B, H, H_out, M, L, R, s)
               : launch_tc<__nv_bfloat16, false>(xf, At, St, c, lf, y, B, H, H_out, M, L, R, s);
  if (dtype == 2)
    return vec ? launch_tc<__half, true>(xf, At, St, c, lf, y, B, H, H_out, M, L, R, s)
               : launch_tc<__half, false>(xf, At, St, c, lf, y, B, H, H_out, M, L, R, s);
  return (int)cudaErrorInvalidValue;
}
