// K1: the dense Driscoll-Healy spectral contraction, forward, on the TF32
// tensor cores with float32 accuracy (3xTF32).
//
// Replaces the Pallas kernel spherical_dyffusion_tpu/ops/pallas_contractions.py
// (_pallas_forward, pallas_call at :72). Per degree l it is one complex GEMM
//
//     y[b, l, m, co] = sum_ci x[b, l, m, ci] * w[ci, co, l]
//
// The backward's input gradient is the same product with the conjugate
// transposed weight, dx[b, l, m, ci] = sum_co g[b, l, m, co] conj(w[ci, co, l])
// (dx of _dhconv_rr_bwd, :94-105), so it runs this kernel over the image of
// conj(w)^T, which dhconv_weight_image_kernel writes from w itself (conj_t).
//
// Layout: x and y are the interleaved (re, im) layout of torch.view_as_real,
// x (B*L, M, CI, 2) and y (B*L, M, CO, 2) float32. The weight reaches the
// kernel as an image made once per model (dhconv_weight_image_kernel below;
// ops/pallas_contractions.py caches it on the module that owns the weight).
//
// The complex product as one real GEMM over K = 2 CI. Row m of x, read as
// (ci, re/im) pairs, is K-major already. With the weight column of co as the
// pair (wr, wi) over those K, the real output is A' . w with A' = (xr, -xi)
// and the imaginary output A'' . w with A'' = (xi, xr): two real GEMMs that
// share the weight operand and differ only in how the staged x is written,
// so the weight image holds the weight once, (L, CO, CI, 2) K-major, and
// never a negated copy. (TF32 wgmma takes only K-major operands.)
//
// Accuracy. K1 is float32 in the JAX package, and its checks hold it to 1e-5
// of the largest output; one TF32 pass keeps about 11 bits of each operand
// and misses that. Each operand is split as a = hi + lo, hi = a rounded to
// TF32 (nearest, ties away from zero: add half a TF32 ulp to the bits and
// clear the 13 low bits), lo = a - hi (exact in float32) rounded the same
// way, and the product is hi.hi + hi.lo + lo.hi, accumulated in float32 by
// the tensor cores; only lo.lo (about 2^-22 of each product) is dropped.
// The weight image stores hi and lo (made once); x is split on its way from
// registers into shared memory.
//
// What bounds it on the H100: at the main path's shapes (B = 1, L = 180,
// M = 181, CI = CO = 256) the three TF32 passes do 3 x 17.08 GFLOP, 0.104 ms
// at the 495 TFLOP/s of the TF32 tensor cores, against 322 MB of compulsory
// traffic (x and y 66.7 MB each, the hi/lo image 188.7 MB), 0.096 ms at
// 3.35 TB/s: operations bound it.
//
// Design. One block is one warpgroup (128 threads) that owns 64 rows (m) by
// 128 columns (co) of one (b, l): wgmma's M, and N = 128 for each of the two
// GEMMs, so the real and imaginary accumulators take 64 float32 registers
// each. M = 181 is three row tiles (6% padding). K runs in chunks of 16 ci
// (32 floats, one 128-byte swizzle row). Shared memory (97 KB, two blocks an
// SM):
//   - the x chunk as four 64 x 32 tiles, A' hi, A' lo, A'' hi, A'' lo
//     (8 KB each), written from registers: each thread loads its 8 complex
//     values of the next chunk while the tensor cores work on this one,
//     then splits and stores them in the K-major swizzle;
//   - a ring of two weight slots, each the hi and lo tiles (128 x 32, 16 KB
//     each) of one chunk, one 32 KB cp.async.bulk from the image completing
//     on the slot's mbarrier; thread 0 refills a slot as soon as the
//     products that read it have completed, two chunks ahead of its use.
// Per chunk the warpgroup issues 4 k-steps x 2 GEMMs x 3 passes = 24
// m64n128k8 products. Blocks of one l are adjacent in launch order (b
// fastest, then the six row and column tiles), so its weight slice is read
// from device memory about once per call and from L2 by the others. At B = 1
// the grid is 1,080 blocks on 132 SMs.
// What bounds this design: in steady state the tensor cores run at about
// four fifths of their TF32 peak; at B = 1 the 1,080 blocks are 4.09 waves
// of two blocks an SM, and the partial last wave leaves most SMs idle, so a
// call takes about 1.8x its bound on an H100 SXM at 700 W (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace k1 {
constexpr int kThreads = 128;                 // one warpgroup
constexpr int kRows = 64;                     // m rows per block: wgmma's M
constexpr int kCo = 128;                      // co per block: each GEMM's N
constexpr int kCi = 16;                       // ci per chunk: K = 32 floats
constexpr uint32_t kATile = 8192;             // 64 rows x 128 B
constexpr uint32_t kBTile = 16384;            // 128 rows x 128 B
constexpr uint32_t kSlotBytes = 2 * kBTile;   // the hi and lo tiles of a chunk
constexpr int kSlots = 2;
constexpr uint32_t kSlotFloats = kSlotBytes / 4;
constexpr size_t kSmem = 1024 + 4 * kATile + kSlots * kSlotBytes + 8 * kSlots;
}  // namespace k1

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, kept in a float with the 13 low bits clear; the weight image's
// plain version (ops/pallas_contractions.py:split_tf32) computes the same
// bits.
__device__ __forceinline__ float tf32_round(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// D += A B, m64n128k8, tf32 operands (K-major: the only layout tf32 takes)
__device__ __forceinline__ void wgmma_tf32_n128(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// x (B*L, M, CI) complex as float2; img the weight image; y (B*L, M, CO)
// complex as float2. blockIdx.y = l * B + b; blockIdx.x = row tile * (column
// tiles) + column tile.
__global__ void __launch_bounds__(k1::kThreads, 2)
dhconv_tc_kernel(const float2* __restrict__ x, const float* __restrict__ img,
                 float2* __restrict__ y, int B, int L, int M, int CI, int CO) {
  using namespace k1;
  extern __shared__ __align__(1024) unsigned char smem_k1[];
  const uint32_t raw = smem_u32(smem_k1);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sgen = smem_k1 + (base - raw);  // generic pointer to base
  const uint32_t bs = 4 * kATile;                     // the weight ring
  const uint32_t bar0 = base + bs + kSlots * kSlotBytes;

  const int nct = (CO + kCo - 1) / kCo;
  const int nch = (CI + kCi - 1) / kCi;
  const int ct = blockIdx.x % nct, mt = blockIdx.x / nct;
  const int l = blockIdx.y / B, b = blockIdx.y % B;
  const size_t bl = (size_t)b * L + l;
  const float2* xb = x + bl * M * CI;
  const int row0 = mt * kRows, co0 = ct * kCo;
  const float* imgb = img + ((size_t)l * nct + ct) * nch * kSlotFloats;

  auto full = [&](int j) { return bar0 + 8u * (uint32_t)(j % kSlots); };
  auto slot = [&](int j) { return base + bs + (uint32_t)(j % kSlots) * kSlotBytes; };
  auto issue = [&](int j) {
    if (j >= nch) return;
    mbar_expect_tx(full(j), kSlotBytes);
    bulk_load(slot(j), imgb + (size_t)j * kSlotFloats, kSlotBytes, full(j));
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kSlots; ++j) issue(j);
  }

  // A thread's 8 complex values of a chunk: e = tid + 128 u is row e / 16
  // and ci e % 16 of the chunk. Loads come from clamped, always valid
  // addresses; rows past M and ci past CI are written as zeros.
  float2 xv[8];
  auto load_x = [&](int j) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = tid + u * kThreads, r = e >> 4, c = e & 15;
      xv[u] = __ldg(xb + (size_t)min(row0 + r, M - 1) * CI + min(j * kCi + c, CI - 1));
    }
  };
  // A' = (xr, -xi) and A'' = (xi, xr), each as hi and lo, into the four
  // tiles: the pair of ci c sits at K = 2c, 2c + 1 of its row.
  auto store_x = [&](int j) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = tid + u * kThreads, r = e >> 4, c = e & 15;
      const bool inside = row0 + r < M && j * kCi + c < CI;
      const float xr = inside ? xv[u].x : 0.f, xi = inside ? xv[u].y : 0.f;
      const float hr = tf32_round(xr), hi = tf32_round(xi);
      const float lr = tf32_round(xr - hr), li = tf32_round(xi - hi);
      unsigned char* p = sgen + r * 128 + (((c >> 1) ^ (r & 7)) << 4) + (c & 1) * 8;
      *reinterpret_cast<float2*>(p) = make_float2(hr, -hi);
      *reinterpret_cast<float2*>(p + kATile) = make_float2(lr, -li);
      *reinterpret_cast<float2*>(p + 2 * kATile) = make_float2(hi, hr);
      *reinterpret_cast<float2*>(p + 3 * kATile) = make_float2(li, lr);
    }
  };

  load_x(0);
  store_x(0);
  fence_async_smem();
  __syncthreads();

  float acc_r[64], acc_i[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_r[i] = acc_i[i] = 0.f;

  for (int j = 0; j < nch; ++j) {
    mbar_wait(full(j), (uint32_t)((j / kSlots) & 1));
    wgmma_fence();
    const uint32_t whi = slot(j), wlo = whi + kBTile;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 8 K (32 bytes) a step
      const uint32_t ko = 32u * ks;
      const uint64_t wh = kmajor_desc(whi + ko), wl = kmajor_desc(wlo + ko);
      const uint32_t a = base + ko;
      wgmma_tf32_n128(acc_r, kmajor_desc(a + kATile), wh);      // A' lo . w hi
      wgmma_tf32_n128(acc_r, kmajor_desc(a), wl);               // A' hi . w lo
      wgmma_tf32_n128(acc_r, kmajor_desc(a), wh);               // A' hi . w hi
      wgmma_tf32_n128(acc_i, kmajor_desc(a + 3 * kATile), wh);  // A'' lo . w hi
      wgmma_tf32_n128(acc_i, kmajor_desc(a + 2 * kATile), wl);  // A'' hi . w lo
      wgmma_tf32_n128(acc_i, kmajor_desc(a + 2 * kATile), wh);  // A'' hi . w hi
    }
    wgmma_commit();
    const bool more = j + 1 < nch;
    if (more) load_x(j + 1);  // in flight while the products run
    wgmma_wait_all();
    fence_regs<64>(acc_r);
    fence_regs<64>(acc_i);
    __syncthreads();  // every read of the x tiles and of slot j is done
    if (tid == 0) issue(j + kSlots);
    if (more) {
      store_x(j + 1);
      fence_async_smem();
      __syncthreads();
    }
  }

  // y[row, co] = (acc_r, acc_i): the thread holds rows r and r + 8 of its
  // warp's 16, columns 8 q + 2 (lane % 4) + {0, 1}; two neighbouring columns
  // are one 16-byte store where CO is even.
  const int warp = tid >> 5, lane = tid & 31;
  float2* yb = y + bl * M * CO;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * h;
    if (row >= M) continue;
    float2* yr = yb + (size_t)row * CO;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int co = co0 + 8 * q + 2 * (lane & 3);
      const int i = 4 * q + 2 * h;
      if ((CO & 1) == 0) {
        if (co < CO)
          *reinterpret_cast<float4*>(yr + co) =
              make_float4(acc_r[i], acc_i[i], acc_r[i + 1], acc_i[i + 1]);
      } else {
        if (co < CO) yr[co] = make_float2(acc_r[i], acc_i[i]);
        if (co + 1 < CO) yr[co + 1] = make_float2(acc_r[i + 1], acc_i[i + 1]);
      }
    }
  }
}

// The weight image of dhconv_weight_image_plain (ops/pallas_contractions.py)
// of the contraction's weight, (CI, CO, L, 2) float32 as K1 reads it: for
// each l, column tile of 128 co and chunk of 16 ci, the hi tile and then the
// lo tile, each 128 rows (co) of 32 floats (the chunk's (ci, re/im) pairs) in
// the K-major 128-byte swizzle; co past CO and ci past CI are zeros. With
// conj_t the source w is (CO, CI, L, 2) and the image is that of its
// conjugate transpose, conj(w)^T: the weight of the backward product dx = g
// conj(w)^T, read straight from the model's weight. One thread writes one
// 16-byte piece.
__global__ void dhconv_weight_image_kernel(const float* __restrict__ w, float* __restrict__ img,
                                           int L, int CI, int CO, int conj_t) {
  using namespace k1;
  const int nct = (CO + kCo - 1) / kCo, nch = (CI + kCi - 1) / kCi;
  const size_t pieces = (size_t)L * nct * nch * 2 * kCo * 8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pieces) return;
  size_t rest = idx >> 3;
  const int s = (int)(idx & 7);
  const int n = (int)(rest % kCo);
  rest /= kCo;
  const int lo = (int)(rest & 1);
  rest >>= 1;
  const int j = (int)(rest % nch);
  rest /= nch;
  const int ct = (int)(rest % nct);
  const int l = (int)(rest / nct);
  const int c = s ^ (n & 7);  // the logical 16-byte chunk: K = 4 c .. 4 c + 3
  const int co = ct * kCo + n;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = 4 * c + e, ci = j * kCi + (k >> 1), part = k & 1;
    float a = 0.f;
    if (ci < CI && co < CO) {
      const size_t src = conj_t ? ((size_t)co * CI + ci) : ((size_t)ci * CO + co);
      a = w[(src * L + l) * 2 + part];
      if (conj_t && part) a = -a;
    }
    const float hi = tf32_round(a);
    v[e] = lo ? tf32_round(a - hi) : hi;
  }
  *reinterpret_cast<float4*>(img + idx * 4) = make_float4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------------------
// K1's weight gradient, dW = sum_{b,m} conj(x)^T g per degree l, on the same
// TF32 tensor cores with the same 3xTF32 split:
//
//     dW[ci, co, l] = sum_{b, m} conj(x[b, l, m, ci]) * g[b, l, m, co]
//
// Replaces the weight half of _dhconv_rr_bwd
// (spherical_dyffusion_tpu/ops/pallas_contractions.py:103-104: dwr = xr^T gr
// + xi^T gi, dwi = xr^T gi - xi^T gr, two XLA einsums a part). x is (B, L,
// M, CI) and g (B, L, M, CO) complex as float2, contiguous; dW is the
// weight's own (CI, CO, L, 2) float32 layout.
//
// The complex product as two real GEMMs over K' = the (b, m, re/im) of an l
// that share one staged operand (K1's trick, mirrored): with B[co, (k, re)]
// = gr and B[co, (k, im)] = gi, the real part is A' . B with A'[ci, (k, re)]
// = xr, A'[ci, (k, im)] = xi, and the imaginary part A'' . B with A'' =
// (-xi, xr). The staged g is written once, x twice, and the epilogue writes
// dW with no pass over a real product.
//
// What bounds it on the H100: at the main path's shapes (B = 1, L = 180, M =
// 181, CI = CO = 256) the three TF32 passes do 3 x 17.08 GFLOP, 0.1035 ms at
// 495 TFLOP/s, against 228 MB of compulsory traffic (x and g 66.7 MB each,
// dW 94.4 MB), 0.0680 ms at 3.35 TB/s: operations bound it. At the skill
// studies' (16, 64, 65, 64) the bytes do (0.0210 ms against 0.0132).
//
// Design. One block is one warpgroup that owns 64 ci (wgmma's M) by 128 co
// (each GEMM's N; 64 where CO <= 64, so that no product multiplies padding)
// of one l and one split of its rows; the real and imaginary accumulators
// take kCo / 2 float32 registers each. The B M rows (b, m) of an l are one
// sequence, taken in chunks of 16 (32 floats, one 128-byte swizzle row)
// across b boundaries; only the last chunk is clamped and zeroed. Both
// operands arrive MN-major (a row (b, l, m) holds its ci, or co, contiguous)
// and TF32 wgmma reads only K-major tiles, so both are staged through
// registers: each thread loads its 8 x and 8 or 16 g values of the next
// chunk (16-byte loads of a ci or co pair) while the tensor cores work on
// this one, then splits them into hi and lo and stores them transposed into
// the K-major swizzle (16-byte stores of a k pair; a warp's store covers 8
// rows by 16 k, four wavefronts of 512 bytes, no conflict). A'' is written
// from the split of A' (the rounding is odd). Shared memory 65 KB (49 KB at
// 64 co), two blocks an SM, so that one block's
// staging, first loads and epilogue run while the other's products do: A'
// hi, A' lo, A'' hi, A'' lo (64 x 32 floats, 8 KB each), B hi, B lo (kCo x
// 32). Per chunk 4 k-steps x
// 2 GEMMs x 3 passes = 24 products. Blocks of one l are adjacent in launch
// order, so its x and g slices come from device memory about once per call
// and from L2 to the others.
// The split (blockIdx.z; the wrapper's plan, ops/pallas_contractions.py:
// wgrad_plan): where the tiles of all l are fewer than the card's 132 SMs
// and there are at least 16 chunks, the chunks are cut into splits that
// give every SM a block and keep the grid within 198 blocks (3/4 of two an
// SM; at the studies' shape 192 blocks ran faster than 256 to 576 on an
// H100): at (16, 64, 65, 64) one 64 x 64 tile an l, 65 chunks in 3 splits
// of 22, 192 blocks where 64 were. Split 0 writes dW, split z > 0
// its partial into slice z - 1 of the float32 workspace `ws`, laid out as
// dW; then a second kernel, dhconv_wgrad_reduce_kernel, adds the slices into
// dW in split order (round to nearest, no atomics: two calls give the same
// bits). A call of one split launches the first kernel alone.
// The output puts l innermost: one l's (ci, co) entries lie 2 L floats
// apart, so a block alone could store only 8-byte pieces, a quarter of a
// 32-byte sector each (a variant that did was slower). Instead the four
// blocks of four consecutive l (one tile, one split) form a cluster
// (__cluster_dims__(1, 4, 1)): each writes its 64 x kCo complex tile into
// its own shared memory (the operand area, free after the last product;
// 16-byte chunks swizzled by the row), and after a cluster barrier block r
// reads rows 16 r .. 16 r + 15 of all four tiles through distributed shared
// memory (16-byte reads, all of a batch issued before its stores) and stores
// each (ci, co)'s run of four l as two 16-byte stores by neighbouring lanes:
// whole sectors. A second barrier keeps every block's tile alive until the
// others have read it. Blocks of l >= L (L not a multiple of 4) compute
// nothing and take part in the barriers and the stores.
// Accuracy over long sums. The tensor cores add each product into the
// float32 accumulator rounding toward zero, so the error of a sum grows with
// its length, not with its square root: over random data the tile's largest
// entry loses about 2.7e-7 of itself per chunk (3.2e-6 over the main path's
// 12 chunks at B = 1, 1.8e-5 over 80 chunks, the full skill preset's before
// the rows were flattened, on an H100). So the plan keeps every block's
// serial sum within a budget (chunks x promote <= 576): a block whose split
// is longer adds its accumulators every `promote` chunks into its promotion
// tile and restarts them; the last interval is added to the tile read back.
// The tile has the output tile's layout and lies in the workspace after the
// partials (the first time a store, then round-to-nearest 16-byte atomic
// adds to entries no other thread touches, so the sums run in a fixed
// order). The error then grows with sqrt(chunks x promote).
// What bounds this design: a block's products wait on its own staging
// between chunks (the warps that issue wgmma are held for most of the
// products' time, so only the SM's other block overlaps them), and a
// block's first loads and its epilogue (the exchange and 64 KB of stores at
// 128 co) are fixed costs that only that other block hides; the tensor
// cores take about 2.7x the three passes' time at B = 1 (PERF.md). Shared
// memory does not set the pace: on an H100, shared-memory stores of a
// chunk's size beside two warpgroups' products hardly slowed them. A design
// with g as wgmma's register operand, x alone staged by a producer
// warpgroup and two consumer warpgroups (one block an SM, for its
// registers) ran slower at the main path's shape: with one block an SM its
// first loads and epilogue, which no other block hid, took a large share of
// each block's time.

namespace k1w {
constexpr int kThreads = 128;                 // one warpgroup
constexpr int kCi = 64;                       // ci per block: wgmma's M
constexpr int kK = 16;                        // (b, m) rows per chunk: K' = 32 floats
constexpr int kCluster = 4;                   // consecutive l per cluster
constexpr uint32_t kATile = 8192;             // 64 rows x 128 B
constexpr uint32_t kBBase = 4 * kATile;       // A' hi, A' lo, A'' hi, A'' lo, then B
// co per block (each GEMM's N): 128, or 64 where CO <= 64
template <int kCo>
__host__ __device__ constexpr uint32_t b_tile() { return kCo * 128; }  // kCo rows x 128 B
template <int kCo>
constexpr size_t smem() { return 1024 + kBBase + 2 * b_tile<kCo>(); }
}  // namespace k1w

// D += A B, m64n64k8, tf32 operands (K-major)
__device__ __forceinline__ void wgmma_tf32_n64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <int kCo>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b) {
  if (kCo == 128)
    wgmma_tf32_n128(d, a, b);
  else
    wgmma_tf32_n64(d, a, b);
}

// x (B, L, M, CI) and g (B, L, M, CO) complex as float2; dw (CI, CO, L)
// complex as float2; ws: the split partials, (gridDim.z - 1) slices laid out
// as dw, then (where a split's chunks exceed promote) one promotion tile a
// block. blockIdx.x = ci tile * (co tiles) + co tile; blockIdx.y = l
// (rounded up to a multiple of the cluster); blockIdx.z = split, chunks
// [z per_split, (z + 1) per_split).
template <int kCo>
__global__ void __cluster_dims__(1, k1w::kCluster, 1) __launch_bounds__(k1w::kThreads, 2)
dhconv_wgrad_tc_kernel(const float2* __restrict__ x, const float2* __restrict__ g,
                       float2* __restrict__ dw, float2* __restrict__ ws, int B, int L, int M,
                       int CI, int CO, int per_split, int promote) {
  using namespace k1w;
  constexpr uint32_t kBTile = b_tile<kCo>();
  constexpr uint32_t kTileRow = kCo * 8;  // one ci row of the output tile
  constexpr int kAcc = kCo / 2;           // accumulator registers a GEMM
  static_assert(kCi * kTileRow <= kBBase + 2 * kBTile, "the output tile reuses the operands");
  extern __shared__ __align__(1024) unsigned char smem_k1w[];
  const uint32_t raw = smem_u32(smem_k1w);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sgen = smem_k1w + (base - raw);  // generic pointer to base

  const int nct = (CO + kCo - 1) / kCo;
  const int ct = blockIdx.x % nct, it = blockIdx.x / nct;
  const int l = blockIdx.y, z = blockIdx.z;
  const int ci0 = it * kCi, co0 = ct * kCo;
  const int K = B * M;  // the (b, m) rows of an l, one sequence across b
  const int nch = (K + kK - 1) / kK;
  const int c0 = z * per_split, c1 = min(nch, c0 + per_split);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Row (b, l, m) of (b, m) row j kK + o of this l: row0 + o within the
  // chunk's first b, plus (L - 1) M for each b boundary crossed (at most one
  // where M >= kK); one division a chunk. Rows past the last are clamped to
  // it and zeroed where they are stored.
  const size_t bstep = (size_t)(L - 1) * M;
  auto row_at = [&](int j, int o) -> size_t {
    const int k = j * kK, b0 = k / M, m0 = k - b0 * M;
    o = min(o, K - 1 - k);
    const int q = M >= kK ? (m0 + o >= M) : (m0 + o) / M;
    return ((size_t)b0 * L + l) * M + m0 + o + q * bstep;
  };

  // A thread's values of a chunk, in units of 8 rows by 16 k: unit v = warp
  // + 4 u (x: u < 2, rows 8 v .. 8 v + 7 of the 64; g: u < kCo / 32, of the
  // kCo),
  // the thread's rows 8 v + 2 cp and + 1 (cp = lane % 4), its k 2 kp and
  // 2 kp + 1 (kp = lane / 4): one 16-byte load a k of the row pair, one
  // 16-byte store a row of the k pair (a swizzle chunk). Loads come from
  // clamped, always valid addresses; rows past CI or CO and k past M are
  // written as zeros.
  const int cp = lane & 3, kp = lane >> 2;
  constexpr int kGu = kCo / 32;
  float4 xv[2][2], gv[kGu][2];
  // the complex values (c, c + 1) of row (b, l, m) of a (.., C) array
  auto ld_pair = [](const float2* a, size_t row, int c, int C) -> float4 {
    if ((C & 1) == 0)
      return __ldg(reinterpret_cast<const float4*>(a + row * C + min(c, C - 2)));
    const float2 u = __ldg(a + row * C + min(c, C - 1)), v = __ldg(a + row * C + min(c + 1, C - 1));
    return make_float4(u.x, u.y, v.x, v.y);
  };
  auto load = [&](int j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const size_t row = row_at(j, 2 * kp + e);
#pragma unroll
      for (int u = 0; u < 2; ++u) xv[u][e] = ld_pair(x, row, ci0 + 8 * (warp + 4 * u) + 2 * cp, CI);
#pragma unroll
      for (int u = 0; u < kGu; ++u)
        gv[u][e] = ld_pair(g, row, co0 + 8 * (warp + 4 * u) + 2 * cp, CO);
    }
  };
  // v split into hi (returned) and lo (in lo); the rounding is odd, so the
  // split of -v is that of v negated
  auto split = [](float4 v, float4& lo) {
    const float4 h =
        make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z), tf32_round(v.w));
    lo = make_float4(tf32_round(v.x - h.x), tf32_round(v.y - h.y), tf32_round(v.z - h.z),
                     tf32_round(v.w - h.w));
    return h;
  };
  auto st16 = [](unsigned char* p, float4 v) { *reinterpret_cast<float4*>(p) = v; };
  // row h of a row pair's two loads (k = 2 kp and 2 kp + 1): one swizzle
  // chunk, (re, im) of each k, zero where the k lies past the last row or
  // the row outside the tile's channels
  auto row_of = [](const float4* v, int h, bool k0, bool k1) {
    const float2 a = h ? make_float2(v[0].z, v[0].w) : make_float2(v[0].x, v[0].y);
    const float2 c = h ? make_float2(v[1].z, v[1].w) : make_float2(v[1].x, v[1].y);
    return make_float4(k0 ? a.x : 0.f, k0 ? a.y : 0.f, k1 ? c.x : 0.f, k1 ? c.y : 0.f);
  };
  // k sits at K' = 2 k (re), 2 k + 1 (im) of its row: A' = (xr, xi), A'' =
  // (-xi, xr), B = (gr, gi), each as hi and lo.
  auto store = [&](int j) {
    const bool k0 = j * kK + 2 * kp < K, k1 = j * kK + 2 * kp + 1 < K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the row pair's rows
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 8 * (warp + 4 * u) + 2 * cp + h;
        const bool in = ci0 + r < CI;
        float4 lo;
        const float4 hi = split(row_of(xv[u], h, in && k0, in && k1), lo);
        unsigned char* p = sgen + r * 128 + ((kp ^ (r & 7)) << 4);
        st16(p, hi);
        st16(p + kATile, lo);
        st16(p + 2 * kATile, make_float4(-hi.y, hi.x, -hi.w, hi.z));
        st16(p + 3 * kATile, make_float4(-lo.y, lo.x, -lo.w, lo.z));
      }
#pragma unroll
      for (int u = 0; u < kGu; ++u) {
        const int r = 8 * (warp + 4 * u) + 2 * cp + h;
        const bool in = co0 + r < CO;
        float4 lo;
        unsigned char* p = sgen + kBBase + r * 128 + ((kp ^ (r & 7)) << 4);
        st16(p, split(row_of(gv[u], h, in && k0, in && k1), lo));
        st16(p + kBTile, lo);
      }
    }
  };

  // this block's tile of the promotion workspace, after the split partials
  // (rounded up to 16 bytes): (ci row, co pair) as the output tile below
  // lays it out
  const size_t part = (size_t)CI * CO * L;  // complex values a partial slice
  const bool promoted = promote < c1 - c0;
  float4* const wt =
      promoted ? reinterpret_cast<float4*>(ws + (((gridDim.z - 1) * part + 1) & ~(size_t)1)) +
                     (((size_t)z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                         (kCi * kCo / 2)
               : nullptr;
  if (l < L && c0 < c1) {
    float acc_r[kAcc], acc_i[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc_r[i] = acc_i[i] = 0.f;

    load(c0);
    store(c0);
    fence_async_smem();
    __syncthreads();
    for (int j = c0; j < c1; ++j) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // 8 K' (32 bytes) a step
        const uint32_t ko = 32u * ks, a = base + ko;
        const uint64_t bh = kmajor_desc(base + kBBase + ko);
        const uint64_t bl = kmajor_desc(base + kBBase + kBTile + ko);
        wgmma_tf32<kCo>(acc_r, kmajor_desc(a + kATile), bh);      // A' lo . B hi
        wgmma_tf32<kCo>(acc_r, kmajor_desc(a), bl);               // A' hi . B lo
        wgmma_tf32<kCo>(acc_r, kmajor_desc(a), bh);               // A' hi . B hi
        wgmma_tf32<kCo>(acc_i, kmajor_desc(a + 3 * kATile), bh);  // A'' lo . B hi
        wgmma_tf32<kCo>(acc_i, kmajor_desc(a + 2 * kATile), bl);  // A'' hi . B lo
        wgmma_tf32<kCo>(acc_i, kmajor_desc(a + 2 * kATile), bh);  // A'' hi . B hi
      }
      wgmma_commit();
      const bool more = j + 1 < c1;
      if (more) load(j + 1);  // in flight while the products run
      wgmma_wait_all();
      fence_regs<kAcc>(acc_r);
      fence_regs<kAcc>(acc_i);
      if (more && (j + 1 - c0) % promote == 0) {  // the accumulators into ws, restarted
        const bool first = j + 1 - c0 == promote;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + (lane >> 2) + 8 * h;
#pragma unroll
          for (int q = 0; q < kCo / 8; ++q) {
            const int c = 4 * q + (lane & 3), i = 4 * q + 2 * h;
            float4* p = wt + row * (kCo / 2) + c;
            const float4 v = make_float4(acc_r[i], acc_i[i], acc_r[i + 1], acc_i[i + 1]);
            if (first)
              *p = v;
            else
              atomicAdd(p, v);  // one 16-byte reduction in L2 (sm_90)
            acc_r[i] = acc_i[i] = acc_r[i + 1] = acc_i[i + 1] = 0.f;
          }
        }
      }
      __syncthreads();  // every read of the operand tiles is done
      if (more) {
        store(j + 1);
        fence_async_smem();
        __syncthreads();
      }
    }

    // The tile into the operand area, row ci (1 KB of (co, re/im)): the
    // thread holds rows r and r + 8 of its warp's 16, columns 8 q + 2 (lane
    // % 4) + {0, 1}, one 16-byte chunk (co / 2) stored at chunk ^ (row % 8).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + (lane >> 2) + 8 * h;
#pragma unroll
      for (int q = 0; q < kCo / 8; ++q) {
        const int c = 4 * q + (lane & 3), i = 4 * q + 2 * h;
        float4 v = make_float4(acc_r[i], acc_i[i], acc_r[i + 1], acc_i[i + 1]);
        if (promoted) {  // the earlier intervals, this thread's own entries
          const float4* const pt = wt + row * (kCo / 2) + c;
          const float4 s = __ldcg(pt);
          v = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
        }
        *reinterpret_cast<float4*>(sgen + row * kTileRow + ((c ^ (row & 7)) << 4)) = v;
      }
    }
  }
  cluster_sync();  // the four tiles are written

  // This block stores rows 16 r .. 16 r + 15 (r its rank) of the cluster's
  // four l: lane pair (2 t, 2 t + 1) takes one (ci, co pair), the even lane
  // l0 and l0 + 1 from ranks 0 and 1, the odd lane l0 + 2 and l0 + 3 from
  // ranks 2 and 3, one 16-byte read from each; a warp covers 32 co of one
  // row, 16 whole sectors a store. Split 0 stores into dW, split z > 0 into
  // slice z - 1 of the partials.
  float2* const out = z == 0 ? dw : ws + (size_t)(z - 1) * part;
  const int rank = (int)cluster_ctaid_y(), l0 = blockIdx.y - rank;
  const int half = lane & 1;
  const int la = l0 + 2 * half;
  const bool two = la + 1 < L, wide = two && (L & 1) == 0;
  // 16 (ci, co pair) a lane pair, in two batches of 8 whose reads are all
  // issued before the batch's stores (the reads are ordered asm)
#pragma unroll 1
  for (int n0 = tid >> 1; n0 < 16 * kCo / 2; n0 += 8 * (kThreads / 2)) {
    float4 va[8], vb[8];
    bool ok[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + i * (kThreads / 2);
      const int row = 16 * rank + n / (kCo / 2), cq = n % (kCo / 2);
      ok[i] = ci0 + row < CI && co0 + 2 * cq < CO && la < L;
      va[i] = vb[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t off = base + row * kTileRow + ((cq ^ (row & 7)) << 4);
      if (ok[i]) va[i] = ld_cluster_f4(cluster_map(off, 2 * half));
      if (ok[i] && two) vb[i] = ld_cluster_f4(cluster_map(off, 2 * half + 1));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!ok[i]) continue;
      const int n = n0 + i * (kThreads / 2);
      const int ci = ci0 + 16 * rank + n / (kCo / 2), co = co0 + 2 * (n % (kCo / 2));
      float2* dst = out + ((size_t)ci * CO + co) * L + la;
      const bool next = co + 1 < CO;
      if (wide) {
        *reinterpret_cast<float4*>(dst) = make_float4(va[i].x, va[i].y, vb[i].x, vb[i].y);
        if (next)
          *reinterpret_cast<float4*>(dst + L) = make_float4(va[i].z, va[i].w, vb[i].z, vb[i].w);
      } else {
        dst[0] = make_float2(va[i].x, va[i].y);
        if (two) dst[1] = make_float2(vb[i].x, vb[i].y);
        if (next) {
          dst[L] = make_float2(va[i].z, va[i].w);
          if (two) dst[L + 1] = make_float2(vb[i].z, vb[i].w);
        }
      }
    }
  }
  cluster_sync();  // no tile is released while another block may read it
}

// dw[i] += p[0][i] + p[1][i] + ... in that order (splits 1, 2, ...), each
// add rounded to nearest: the sum of dW's split partials, the same bits on
// every call. n floats a slice.
__global__ void dhconv_wgrad_reduce_kernel(float* __restrict__ dw, const float* __restrict__ p,
                                           size_t n, int parts) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = dw[i];
    for (int s = 0; s < parts; ++s) v += __ldg(p + (size_t)s * n + i);
    dw[i] = v;
  }
}

template <int kCo>
int launch_wgrad(const void* x, const void* g, void* dw, void* ws, int B, int L, int M, int CI,
                 int CO, int per_split, int promote, dim3 grid, cudaStream_t stream) {
  using namespace k1w;
  const int bytes = (int)smem<kCo>();
  cudaError_t err = cudaFuncSetAttribute(dhconv_wgrad_tc_kernel<kCo>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dhconv_wgrad_tc_kernel<kCo><<<grid, kThreads, bytes, stream>>>(
      (const float2*)x, (const float2*)g, (float2*)dw, (float2*)ws, B, L, M, CI, CO, per_split,
      promote);
  return (int)cudaGetLastError();
}

}  // namespace

// w (CI, CO, L, 2) float32, contiguous, or with conj_t (CO, CI, L, 2), whose
// conjugate transpose is imaged; img (L, ceil(CO/128), ceil(CI/16), 2, 128,
// 32) float32, 16-byte aligned. Returns the cudaError_t of the launch (0 on
// success), or -1 for widths it does not take.
extern "C" int sdt_dhconv_weight_image(const void* w, void* img, int L, int CI, int CO,
                                       int conj_t, void* stream) {
  using namespace k1;
  if (L <= 0 || CI <= 0 || CO <= 0) return -1;
  const size_t pieces = (size_t)L * ((CO + kCo - 1) / kCo) * ((CI + kCi - 1) / kCi) * 2 * kCo * 8;
  const int threads = 256;
  const size_t blocks = (pieces + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return -1;
  dhconv_weight_image_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (float*)img, L, CI, CO, conj_t);
  return (int)cudaGetLastError();
}

// x: (B*L, M, CI, 2) float32, contiguous; img: the image of
// sdt_dhconv_weight_image for (CI, CO, L); y: (B*L, M, CO, 2) float32,
// contiguous. B*L <= 65535. Returns the cudaError_t of the launch (0 on
// success), or -1 for shapes the kernel does not take.
extern "C" int sdt_dhconv_fwd(const void* x, const void* img, void* y, int B, int L, int M,
                              int CI, int CO, void* stream) {
  using namespace k1;
  if (B <= 0 || L <= 0 || M <= 0 || CI <= 0 || CO <= 0 || (long long)B * L > 65535) return -1;
  cudaError_t err = cudaFuncSetAttribute(dhconv_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((M + kRows - 1) / kRows) * ((CO + kCo - 1) / kCo);
  dim3 grid(tiles, B * L);
  dhconv_tc_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)img, (float2*)y, B, L, M, CI, CO);
  return (int)cudaGetLastError();
}

// x: (B, L, M, CI, 2) and g: (B, L, M, CO, 2) float32, contiguous; dw: (CI,
// CO, L, 2) float32, contiguous; per_split: chunks of 16 (b, m) rows a split
// (>= 1; splits = ceil(ceil(B M / 16) / per_split)); promote: chunks between
// the accumulators' promotions (>= 1); ws: 16-byte aligned float32 (its
// contents need not be set), (splits - 1) slices of dw's size for the split
// partials, then, where per_split > promote, from the next 16-byte boundary
// one tile of 64 ci x the block's co (128, or 64 where CO <= 64) complex a
// block; null where it needs neither. Several splits launch the partials'
// kernel, then the reduction's. Returns the cudaError_t of the launches (0
// on success), or -1 for arguments the kernels do not take.
extern "C" int sdt_dhconv_wgrad(const void* x, const void* g, void* dw, void* ws, int B, int L,
                                int M, int CI, int CO, int per_split, int promote, void* stream) {
  using namespace k1w;
  if (B <= 0 || L <= 0 || M <= 0 || CI <= 0 || CO <= 0 || per_split <= 0 || promote <= 0)
    return -1;
  const long long rows = (long long)B * M;
  if (rows > 0x7FFFFFFF - kK) return -1;
  const long long nch = (rows + kK - 1) / kK;
  const long long splits = (nch + per_split - 1) / per_split;
  const int co_tile = CO > 64 ? 128 : 64;
  const long long ly = ((long long)L + kCluster - 1) / kCluster * kCluster;
  const long long tiles = (long long)((CI + kCi - 1) / kCi) * ((CO + co_tile - 1) / co_tile);
  if (ly > 65535 || splits > 65535 || tiles > 0x7FFFFFFF) return -1;
  if ((splits > 1 || per_split > promote) && ws == nullptr) return -1;
  const dim3 grid((unsigned)tiles, (unsigned)ly, (unsigned)splits);
  const cudaStream_t s = (cudaStream_t)stream;
  const int err =
      co_tile == 128
          ? launch_wgrad<128>(x, g, dw, ws, B, L, M, CI, CO, per_split, promote, grid, s)
          : launch_wgrad<64>(x, g, dw, ws, B, L, M, CI, CO, per_split, promote, grid, s);
  if (err != 0 || splits == 1) return err;
  const size_t n = (size_t)CI * CO * L * 2;
  const size_t want = (n + 255) / 256, blocks = want < 2048 ? want : 2048;
  dhconv_wgrad_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>((float*)dw, (const float*)ws, n,
                                                               (int)(splits - 1));
  return (int)cudaGetLastError();
}
