// Host-side packing of tensor lists into one flat buffer and back: the
// native half of apex_tpu_torch/utils/host_pack.py (apex_C's flatten /
// unflatten, csrc/flatten_unflatten.cpp:5-18 of the reference).
//
// A torch loop's CPU tensors cross into the flat optimizer state as one
// staging buffer (TreeFlattener's layout) and come back as a list; copying
// them one numpy call at a time serializes on the GIL, so this file is a
// threaded memcpy engine with a plain C interface, loaded with ctypes.
//
// Layout: offsets are ELEMENT offsets into a dst buffer laid out by
// TreeFlattener (each leaf 128-element aligned), sizes are element counts,
// elem_size is the one element width in bytes.  Gaps (the alignment
// padding) are left as they are: callers zero the buffer once when they
// allocate it.  No kernel, no CUDA: built with the host C++ compiler.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Span {
  const char* src;
  char* dst;
  int64_t nbytes;
};

// Split the copies into 1 MiB pieces and share them out in equal runs, so
// one large leaf cannot hold the pool to one thread.
void run_spans(const std::vector<Span>& spans, int n_threads) {
  constexpr int64_t kSplit = 1 << 20;
  std::vector<Span> work;
  work.reserve(spans.size() * 2);
  for (const Span& s : spans) {
    for (int64_t off = 0; off < s.nbytes; off += kSplit) {
      work.push_back({s.src + off, s.dst + off,
                      std::min(kSplit, s.nbytes - off)});
    }
  }
  if (work.empty()) return;
  n_threads = std::max(1, std::min<int>(n_threads, (int)work.size()));
  const std::size_t per = (work.size() + n_threads - 1) / n_threads;
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    const std::size_t lo = t * per;
    const std::size_t hi = std::min(work.size(), lo + per);
    if (lo >= hi) break;
    pool.emplace_back([&work, lo, hi]() {
      for (std::size_t i = lo; i < hi; ++i)
        std::memcpy(work[i].dst, work[i].src, work[i].nbytes);
    });
  }
  for (auto& th : pool) th.join();
}

int hw_threads() {
  const unsigned n = std::thread::hardware_concurrency();
  return n ? (int)n : 4;
}

}  // namespace

extern "C" {

// srcs[i] -> dst + offsets[i] * elem_size, sizes[i] elements each.
void apex_torch_host_pack(const void** srcs, const int64_t* sizes,
                          const int64_t* offsets, int64_t n, void* dst,
                          int64_t elem_size) {
  std::vector<Span> spans;
  spans.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    spans.push_back({(const char*)srcs[i],
                     (char*)dst + offsets[i] * elem_size,
                     sizes[i] * elem_size});
  }
  run_spans(spans, hw_threads());
}

// src + offsets[i] * elem_size -> dsts[i], sizes[i] elements each.
void apex_torch_host_unpack(const void* src, const int64_t* sizes,
                            const int64_t* offsets, int64_t n, void** dsts,
                            int64_t elem_size) {
  std::vector<Span> spans;
  spans.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    spans.push_back({(const char*)src + offsets[i] * elem_size,
                     (char*)dsts[i], sizes[i] * elem_size});
  }
  run_spans(spans, hw_threads());
}

int apex_torch_host_pack_abi() { return 1; }

}  // extern "C"
