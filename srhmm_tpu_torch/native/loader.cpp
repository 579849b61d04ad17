// Native batched .perfil loader.
//
// Replacement for the reference's per-utterance blocking stdio
// reads inside hot loops (reading_coef, hmm_continuous_full_fs.c:515-567,
// re-read twice per utterance per EM iteration at :259/:287): parse a whole
// training list into one padded (B, T_max, D) host buffer with a worker
// pool, ready for a single host->device transfer.
//
// C ABI only (ctypes-friendly).  Layout contract matches io/dataset.py:
//   features: row-major (B, T_max, D) float32 or float64, zero-padded
//   lengths:  (B,) int32 frame counts (0 on per-file failure, see status)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libsrhmm_loader.so loader.cpp
// -lpthread (srhmm_tpu_torch/io/native_loader.py builds it on first use into
// build/srhmm_tpu_torch/native/ and raises when it cannot).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct FileJob {
  const char* path;
  int64_t row;
};

// Returns frame count, or a negative error code.
//  -1: open failed, -2: header read failed, -3: bad header
template <typename T>
int64_t read_one(const char* path, T* out_row, int64_t t_max, int64_t d_expected) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int32_t coef = 0;
  if (std::fread(&coef, sizeof(int32_t), 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  if (coef != d_expected || coef <= 0) {
    std::fclose(f);
    return -3;
  }
  std::vector<double> frame(coef);
  int64_t t = 0;
  while (t < t_max &&
         std::fread(frame.data(), sizeof(double), coef, f) == (size_t)coef) {
    T* dst = out_row + t * d_expected;
    for (int32_t i = 0; i < coef; ++i) dst[i] = (T)frame[i];
    ++t;
  }
  std::fclose(f);
  return t;
}

template <typename T>
void load_batch_impl(const char** paths, int64_t n_files, T* features,
                     int32_t* lengths, int32_t* status, int64_t t_max,
                     int64_t dim, int32_t n_threads) {
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_files) return;
      T* row = features + i * t_max * dim;
      std::memset(row, 0, sizeof(T) * t_max * dim);
      int64_t r = read_one<T>(paths[i], row, t_max, dim);
      if (r >= 0) {
        lengths[i] = (int32_t)r;
        status[i] = 0;
      } else {
        lengths[i] = 0;
        status[i] = (int32_t)r;
      }
    }
  };
  if (n_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int32_t k = 0; k < n_threads; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Peek at frame counts/dims without materializing data (for bucket sizing).
// Writes per-file (frames, dim) into out (n_files x 2 int64). Returns 0.
int32_t srhmm_scan_perfil(const char** paths, int64_t n_files, int64_t* out) {
  for (int64_t i = 0; i < n_files; ++i) {
    out[2 * i] = 0;
    out[2 * i + 1] = 0;
    FILE* f = std::fopen(paths[i], "rb");
    if (!f) continue;
    int32_t coef = 0;
    if (std::fread(&coef, sizeof(int32_t), 1, f) == 1 && coef > 0) {
      std::fseek(f, 0, SEEK_END);
      long sz = std::ftell(f);
      out[2 * i] = (sz - 4) / (8 * coef);
      out[2 * i + 1] = coef;
    }
    std::fclose(f);
  }
  return 0;
}

int32_t srhmm_load_batch_f32(const char** paths, int64_t n_files,
                             float* features, int32_t* lengths,
                             int32_t* status, int64_t t_max, int64_t dim,
                             int32_t n_threads) {
  load_batch_impl<float>(paths, n_files, features, lengths, status, t_max,
                         dim, n_threads);
  return 0;
}

int32_t srhmm_load_batch_f64(const char** paths, int64_t n_files,
                             double* features, int32_t* lengths,
                             int32_t* status, int64_t t_max, int64_t dim,
                             int32_t n_threads) {
  load_batch_impl<double>(paths, n_files, features, lengths, status, t_max,
                          dim, n_threads);
  return 0;
}

}  // extern "C"
