// Native batch-assembly for the record data path.
//
// The input pipeline's hot host-side operation is gathering B rows from
// memory-mapped shard arrays into one contiguous batch buffer (the numpy
// equivalent is a Python loop + np.stack, which pays interpreter and
// allocator overhead per row).  This library does the gather as raw memcpy,
// optionally multi-threaded for large batches, and fuses the final
// host-layout transforms the TED/BEAT datasets need (row f32 scale+shift for
// z-scoring, strided transpose for [T,J,F] -> [J,F,T]).
//
// Exposed via ctypes (see livelyspeaker_tpu_torch/data/native.py); no pybind11
// dependency.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather rows of `row_bytes` bytes at `indices` from `src` into `dst`.
void gather_rows_bytes(const char* src, const int64_t* indices, int64_t n_idx,
                       int64_t row_bytes, char* dst, int n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + indices[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };
  if (n_threads <= 1 || n_idx < 4) {
    work(0, n_idx);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk > n_idx ? n_idx : lo + chunk;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Gather only the first `prefix_bytes` of each `src_row_bytes`-byte row —
// fuses the window crop (42 stored frames -> 34 consumed, 44800 stored audio
// samples -> 36267) into the gather, halving the hot copy: without this the
// batch pays a full-row gather AND a crop copy.
void gather_rows_prefix_bytes(const char* src, const int64_t* indices,
                              int64_t n_idx, int64_t src_row_bytes,
                              int64_t prefix_bytes, char* dst, int n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * prefix_bytes, src + indices[i] * src_row_bytes,
                  static_cast<size_t>(prefix_bytes));
    }
  };
  if (n_threads <= 1 || n_idx < 4) {
    work(0, n_idx);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk > n_idx ? n_idx : lo + chunk;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Fused gather + per-element affine (z-score / un-z-score) for f32 rows:
// dst[i] = src[indices[i]] * scale + shift   (scale/shift length row_elems)
void gather_rows_affine_f32(const float* src, const int64_t* indices,
                            int64_t n_idx, int64_t row_elems,
                            const float* scale, const float* shift,
                            float* dst) {
  for (int64_t i = 0; i < n_idx; ++i) {
    const float* s = src + indices[i] * row_elems;
    float* d = dst + i * row_elems;
    for (int64_t j = 0; j < row_elems; ++j) d[j] = s[j] * scale[j] + shift[j];
  }
}

// Gather + transpose [T, C] rows into [C, T] (the models consume
// channels-major [J*F, T] motion layouts; doing it here avoids a
// per-batch numpy transpose copy).
void gather_rows_transpose_f32(const float* src, const int64_t* indices,
                               int64_t n_idx, int64_t t_dim, int64_t c_dim,
                               float* dst) {
  for (int64_t i = 0; i < n_idx; ++i) {
    const float* s = src + indices[i] * t_dim * c_dim;
    float* d = dst + i * t_dim * c_dim;
    for (int64_t t = 0; t < t_dim; ++t)
      for (int64_t c = 0; c < c_dim; ++c) d[c * t_dim + t] = s[t * c_dim + c];
  }
}

// Gather + crop + transpose: take the first `t_out` of `src_t` [T, C] frames
// of each gathered row, writing [C, t_out] — the [B, J*F, T] motion layout
// the denoiser consumes, produced in one pass from the stored [T, J, F]
// windows (42 frames stored, 34 consumed).
void gather_rows_transpose_crop_f32(const float* src, const int64_t* indices,
                                    int64_t n_idx, int64_t src_t,
                                    int64_t t_out, int64_t c_dim, float* dst) {
  for (int64_t i = 0; i < n_idx; ++i) {
    const float* s = src + indices[i] * src_t * c_dim;
    float* d = dst + i * t_out * c_dim;
    for (int64_t t = 0; t < t_out; ++t)
      for (int64_t c = 0; c < c_dim; ++c) d[c * t_out + t] = s[t * c_dim + c];
  }
}

}  // extern "C"
