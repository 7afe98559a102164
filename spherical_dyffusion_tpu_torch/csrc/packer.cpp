// Host-side packing and normalization of the data loader's windows.
//
// Packs per-variable (T, H, W) float32 arrays into channels-last
// (T, H, W, C) and applies per-channel z-score normalization, (x - mean) *
// (1 / std), in one pass, parallelized over timesteps with a small pthread
// pool, without numpy's stack and broadcast temporaries. The port's copy of
// the JAX package's native/packer.cpp: built with g++ as a plain C ABI
// shared library and loaded through ctypes by
// spherical_dyffusion_tpu_torch/utils/native.py.

#include <cstdint>
#include <cstring>
#include <pthread.h>
#include <vector>

extern "C" {

struct PackTask {
  const float *const *srcs; // C pointers to (T*H*W) variable arrays
  float *dst;               // (T*H*W*C) output
  int64_t t0, t1;           // timestep range [t0, t1)
  int64_t hw;               // H*W
  int64_t c;                // number of channels
  const float *means;       // per-channel mean (may be null)
  const float *inv_stds;    // per-channel 1/std (may be null)
};

static void *pack_worker(void *arg) {
  PackTask *task = static_cast<PackTask *>(arg);
  const int64_t hw = task->hw, c = task->c;
  for (int64_t t = task->t0; t < task->t1; ++t) {
    float *out_row = task->dst + t * hw * c;
    for (int64_t ch = 0; ch < c; ++ch) {
      const float *src = task->srcs[ch] + t * hw;
      const float mu = task->means ? task->means[ch] : 0.0f;
      const float is = task->inv_stds ? task->inv_stds[ch] : 1.0f;
      float *out = out_row + ch;
      for (int64_t i = 0; i < hw; ++i) {
        out[i * c] = (src[i] - mu) * is;
      }
    }
  }
  return nullptr;
}

// Pack `c` arrays of shape (T, H*W) into dst (T, H*W, c), normalizing each
// channel with (x - mean) * inv_std. n_threads <= 0 means single-threaded.
int pack_normalize(const float *const *srcs, float *dst, int64_t t_steps,
                   int64_t hw, int64_t c, const float *means,
                   const float *inv_stds, int n_threads) {
  if (n_threads <= 1 || t_steps < 2) {
    PackTask task{srcs, dst, 0, t_steps, hw, c, means, inv_stds};
    pack_worker(&task);
    return 0;
  }
  if (n_threads > t_steps) n_threads = static_cast<int>(t_steps);
  std::vector<pthread_t> threads(n_threads);
  std::vector<PackTask> tasks(n_threads);
  const int64_t chunk = (t_steps + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    const int64_t t0 = i * chunk;
    const int64_t t1 = (t0 + chunk < t_steps) ? t0 + chunk : t_steps;
    tasks[i] = PackTask{srcs, dst, t0, t1, hw, c, means, inv_stds};
    if (pthread_create(&threads[i], nullptr, pack_worker, &tasks[i]) != 0) {
      // fall back to inline execution for the remaining work
      pack_worker(&tasks[i]);
      threads[i] = 0;
    }
  }
  for (int i = 0; i < n_threads; ++i) {
    if (threads[i]) pthread_join(threads[i], nullptr);
  }
  return 0;
}

// Unpack (T, H*W, C) into per-channel (T, H*W) buffers with denormalization.
int unpack_denormalize(const float *src, float *const *dsts, int64_t t_steps,
                       int64_t hw, int64_t c, const float *means,
                       const float *stds) {
  for (int64_t ch = 0; ch < c; ++ch) {
    const float mu = means ? means[ch] : 0.0f;
    const float sd = stds ? stds[ch] : 1.0f;
    float *dst = dsts[ch];
    const float *in = src + ch;
    for (int64_t i = 0; i < t_steps * hw; ++i) {
      dst[i] = in[i * c] * sd + mu;
    }
  }
  return 0;
}

}  // extern "C"
