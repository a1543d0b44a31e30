// Host point-cloud preprocessing ops (C++17, no external dependencies): the
// PyTorch port's copy of si_mamba_tpu/native/pointops.cpp.
//
// Batched farthest point sampling and brute-force kNN on the host, for
// dataset preprocessing and checks. The model's own FPS and kNN run on the
// device (si_mamba_tpu_torch/ops/pointops.py). Each squared distance is
// ((0 + dx^2) + dy^2) + dz^2 in float32, every product and sum rounded on its
// own (the build passes -ffp-contract=off), the arithmetic of the numpy loop.
//
// Built by si_mamba_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off -o <build>/pointops-<hash>.so pointops.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline float sqdist(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int i = 0; i < d; ++i) {
    const float diff = a[i] - b[i];
    s += diff * diff;
  }
  return s;
}

void fps_single(const float* pts, int64_t n, int d, int64_t m, int64_t start,
                int64_t* out_idx) {
  std::vector<float> min_d(n, FLT_MAX);
  int64_t farthest = start;
  for (int64_t i = 0; i < m; ++i) {
    out_idx[i] = farthest;
    const float* fp = pts + farthest * d;
    float best = -1.f;
    int64_t best_j = 0;
    for (int64_t j = 0; j < n; ++j) {
      const float dj = sqdist(pts + j * d, fp, d);
      if (dj < min_d[j]) min_d[j] = dj;
      if (min_d[j] > best) {
        best = min_d[j];
        best_j = j;
      }
    }
    farthest = best_j;
  }
}

void parallel_for(int64_t count, const std::function<void(int64_t)>& fn) {
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const unsigned workers = static_cast<unsigned>(
      std::min<int64_t>(count, static_cast<int64_t>(hw)));
  if (workers <= 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (unsigned t = 0; t < workers; ++t) {
    threads.emplace_back([&] {
      for (;;) {
        const int64_t i = next.fetch_add(1);
        if (i >= count) return;
        fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// pts: (b, n, d) float32; out_idx: (b, m) int64. start broadcast per batch.
void fps_batch_f32(const float* pts, int64_t b, int64_t n, int d, int64_t m,
                   int64_t start, int64_t* out_idx) {
  parallel_for(b, [&](int64_t bi) {
    fps_single(pts + bi * n * d, n, d, m, start, out_idx + bi * m);
  });
}

// query: (b, q, d); pts: (b, n, d); out_idx: (b, q, k) int64 sorted ascending.
void knn_batch_f32(const float* query, const float* pts, int64_t b, int64_t q,
                   int64_t n, int d, int k, int64_t* out_idx) {
  parallel_for(b * q, [&](int64_t flat) {
    const int64_t bi = flat / q;
    const int64_t qi = flat % q;
    const float* qp = query + (bi * q + qi) * d;
    const float* base = pts + bi * n * d;
    std::vector<std::pair<float, int64_t>> dists(n);
    for (int64_t j = 0; j < n; ++j) dists[j] = {sqdist(base + j * d, qp, d), j};
    std::partial_sort(dists.begin(), dists.begin() + k, dists.end());
    int64_t* out = out_idx + (bi * q + qi) * k;
    for (int j = 0; j < k; ++j) out[j] = dists[j].second;
  });
}

}  // extern "C"
