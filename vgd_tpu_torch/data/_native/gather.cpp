// Threaded batch gather of the port's input path (the port's own copy of
// vgd_tpu/data/_native/gather.cpp: the same two functions, signatures and
// arithmetic, and one more entry point).
//
// Assembling a shuffled minibatch from the decoded uint8 memmap cache is
// out[i] = data[idx[i]] for B rows of H*W*C bytes: a memcpy per row, bound
// by the host's memory (and, for a cold cache, by page-in). Threads
// overlap the rows' page-ins and copies. `gather_rows_at` writes the rows
// at a row offset of a caller's buffer. The training loop gathers every
// batch of a chunk, in order, straight into a pinned (n, B, H, W, C)
// staging buffer in one call (batch i lands in slot i; the threads start
// once a chunk), with no stacking pass and no copy into pinned memory.
//
// Built at first use by vgd_tpu_torch/data/native.py with the host C++
// compiler (-O3 -shared -fPIC -std=c++17 -pthread) and bound with ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Runs body(start, stop) over [0, batch) split into at most n_threads
// contiguous ranges, one thread each (the caller's thread when one).
template <typename Body>
void parallel_rows(int64_t batch, int n_threads, Body body) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > batch) n_threads = static_cast<int>(batch);
  if (n_threads <= 1) {
    body(0, batch);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t start = t * chunk;
    int64_t stop = start + chunk < batch ? start + chunk : batch;
    if (start >= stop) break;
    threads.emplace_back(body, start, stop);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather `batch` rows of `row_bytes` each from `src` at positions `indices`
// into rows [dst_row, dst_row + batch) of `dst`, using up to `n_threads`
// threads.
void gather_rows_at(const uint8_t* src, const int64_t* indices, int64_t batch,
                    int64_t row_bytes, uint8_t* dst, int64_t dst_row,
                    int n_threads) {
  uint8_t* out = dst + dst_row * row_bytes;
  parallel_rows(batch, n_threads, [&](int64_t start, int64_t stop) {
    for (int64_t i = start; i < stop; ++i) {
      std::memcpy(out + i * row_bytes, src + indices[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  });
}

// Gather `batch` rows of `row_bytes` each from `src` at positions `indices`
// into the contiguous `dst`, using up to `n_threads` threads.
void gather_rows(const uint8_t* src, const int64_t* indices, int64_t batch,
                 int64_t row_bytes, uint8_t* dst, int n_threads) {
  gather_rows_at(src, indices, batch, row_bytes, dst, 0, n_threads);
}

// uint8 -> float32 [-1, 1] fused with the gather (host-side consumers),
// s * (1 / 127.5) - 1 as in the JAX package's native path.
void gather_rows_signed_f32(const uint8_t* src, const int64_t* indices,
                            int64_t batch, int64_t row_elems, float* dst,
                            int n_threads) {
  parallel_rows(batch, n_threads, [&](int64_t start, int64_t stop) {
    for (int64_t i = start; i < stop; ++i) {
      const uint8_t* s = src + indices[i] * row_elems;
      float* d = dst + i * row_elems;
      for (int64_t j = 0; j < row_elems; ++j) {
        d[j] = s[j] * (1.0f / 127.5f) - 1.0f;
      }
    }
  });
}

}  // extern "C"
