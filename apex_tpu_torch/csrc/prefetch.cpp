// Native data-prefetch ring: host code (no TPU kernel counterpart; it is
// the C++ engine behind apex_tpu/data/loader.py `NativeLoader`, copied here
// so the port carries its own source).  Built with the host C++ compiler
// at first use by apex_tpu_torch/utils/build.py (`host_library`) and bound
// with ctypes by apex_tpu_torch/data/loader.py.
//
// What remains on the host around a training step is batch assembly:
// shuffling indices and gathering sample rows into a contiguous batch
// buffer (or synthesizing data when benchmarking).  Done in Python it holds
// the GIL; this engine runs it on C++ worker threads over a ring of host
// buffers:
//
//   workers:  fill slot -> mark ready ---\
//   consumer: acquire ready slot -> copy into a pinned tensor -> release
//
// Sources:
//   * gather: rows are memcpy'd from a caller-owned base pointer (e.g. a
//     numpy memmap) at shuffled indices — per-epoch Fisher-Yates with a
//     seeded xorshift so runs are reproducible.
//   * synthetic: when base == nullptr, x is filled with uniform floats in
//     [-1, 1) and labels uniform in [0, n_classes).
//
// Batches arrive in ticket order, so the stream is the same for any
// worker count, and it is the JAX package's engine's stream bit for bit
// (the same xorshift, shuffle and ticket order).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    return s;
  }
  // uniform in [0, n)
  uint64_t below(uint64_t n) { return n ? next() % n : 0; }
  float unit() {  // [-1, 1)
    return 2.0f * ((next() >> 40) * (1.0f / 16777216.0f)) - 1.0f;
  }
};

struct Slot {
  std::vector<char> x;
  std::vector<int32_t> y;
  int64_t ticket = 0;         // batch sequence number this slot holds
  std::atomic<int> state{0};  // 0 free, 1 filling, 2 ready
};

struct Prefetcher {
  // dataset
  const char* base = nullptr;      // nullptr => synthetic
  const int32_t* labels = nullptr; // nullptr => synthetic labels
  int64_t n_samples = 0;
  int64_t sample_bytes = 0;
  int64_t batch = 0;
  int32_t n_classes = 1000;
  uint64_t seed = 0;

  // ring
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  // epoch order (workers claim batches by monotonic ticket; the consumer
  // receives them strictly in ticket order so runs are deterministic for
  // any worker count)
  std::vector<int64_t> order;
  std::atomic<int64_t> next_batch{0};   // ticket: batch index since start
  int64_t next_deliver = 0;             // consumer-side ticket (under mu)
  int64_t batches_per_epoch = 0;

  void build_epoch(uint64_t epoch) {
    order.resize(n_samples);
    for (int64_t i = 0; i < n_samples; ++i) order[i] = i;
    XorShift rng(seed + 0x517cc1b727220a95ULL * (epoch + 1));
    for (int64_t i = n_samples - 1; i > 0; --i) {
      int64_t j = (int64_t)rng.below((uint64_t)i + 1);
      std::swap(order[i], order[j]);
    }
  }

  void fill(Slot& slot, int64_t ticket) {
    if (base == nullptr) {  // synthetic
      XorShift rng(seed ^ (0xd1342543de82ef95ULL * (ticket + 1)));
      float* xf = reinterpret_cast<float*>(slot.x.data());
      int64_t n_floats = batch * sample_bytes / (int64_t)sizeof(float);
      for (int64_t i = 0; i < n_floats; ++i) xf[i] = rng.unit();
      for (int64_t i = 0; i < batch; ++i)
        slot.y[i] = (int32_t)rng.below((uint64_t)n_classes);
      return;
    }
    int64_t epoch = ticket / batches_per_epoch;
    int64_t b = ticket % batches_per_epoch;
    // Copy this batch's indices out under the lock (cheap: `batch` int64s);
    // the epoch permutation is rebuilt lazily by whichever worker crosses
    // the boundary first.  The megabyte-scale row memcpys below then run
    // unlocked and in parallel across workers.
    std::vector<int64_t> idxs((size_t)batch);
    {
      std::unique_lock<std::mutex> lk(mu);
      if (epoch != built_epoch) { build_epoch((uint64_t)epoch); built_epoch = epoch; }
      for (int64_t i = 0; i < batch; ++i)
        idxs[(size_t)i] = order[(size_t)((b * batch + i) % n_samples)];
    }
    for (int64_t i = 0; i < batch; ++i) {
      std::memcpy(slot.x.data() + i * sample_bytes,
                  base + idxs[(size_t)i] * sample_bytes,
                  (size_t)sample_bytes);
      slot.y[i] = labels ? labels[idxs[(size_t)i]] : 0;
    }
  }

  int64_t built_epoch = -1;

  void worker() {
    while (!stop.load(std::memory_order_relaxed)) {
      // claim a free slot
      Slot* slot = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          if (stop.load(std::memory_order_relaxed)) return true;
          for (auto& s : slots)
            if (s.state.load(std::memory_order_relaxed) == 0) return true;
          return false;
        });
        if (stop.load(std::memory_order_relaxed)) return;
        for (auto& s : slots)
          if (s.state.load(std::memory_order_relaxed) == 0) {
            s.state.store(1, std::memory_order_relaxed);
            slot = &s;
            break;
          }
      }
      if (!slot) continue;
      int64_t ticket = next_batch.fetch_add(1, std::memory_order_relaxed);
      slot->ticket = ticket;
      fill(*slot, ticket);
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->state.store(2, std::memory_order_release);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* pf_create(const char* base, const int32_t* labels, int64_t n_samples,
                int64_t sample_bytes, int64_t batch, int32_t n_classes,
                int32_t depth, int32_t n_threads, uint64_t seed) {
  auto* p = new Prefetcher();
  p->base = base;
  p->labels = labels;
  p->n_samples = n_samples > 0 ? n_samples : 1;
  p->sample_bytes = sample_bytes;
  p->batch = batch;
  p->n_classes = n_classes > 0 ? n_classes : 1;
  p->seed = seed;
  p->batches_per_epoch =
      p->base ? std::max<int64_t>(1, p->n_samples / batch) : (int64_t)1 << 62;
  if (depth < 2) depth = 2;
  p->slots = std::vector<Slot>((size_t)depth);
  for (auto& s : p->slots) {
    s.x.resize((size_t)(batch * sample_bytes));
    s.y.resize((size_t)batch);
  }
  if (n_threads < 1) n_threads = 1;
  for (int t = 0; t < n_threads; ++t)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Blocks until the NEXT batch (by ticket) is ready; returns its slot id and
// exposes its buffers.  Strict ticket order keeps epochs deterministic for
// any worker count (every claimed ticket has a slot, so the wait is
// deadlock-free for depth >= 2).
int32_t pf_acquire(void* h, char** x_out, int32_t** y_out,
                   int64_t* ticket_out) {
  auto* p = static_cast<Prefetcher*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  int32_t best = -1;
  p->cv_ready.wait(lk, [&] {
    if (p->stop.load(std::memory_order_relaxed)) return true;
    best = -1;
    for (size_t i = 0; i < p->slots.size(); ++i) {
      Slot& s = p->slots[i];
      if (s.state.load(std::memory_order_acquire) == 2 &&
          s.ticket == p->next_deliver) {
        best = (int32_t)i;
        return true;
      }
    }
    return false;
  });
  if (best < 0) return -1;  // stopped
  p->next_deliver += 1;
  Slot& s = p->slots[(size_t)best];
  *x_out = s.x.data();
  *y_out = s.y.data();
  *ticket_out = s.ticket;
  return best;
}

void pf_release(void* h, int32_t slot) {
  auto* p = static_cast<Prefetcher*>(h);
  if (slot < 0 || (size_t)slot >= p->slots.size()) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->slots[(size_t)slot].state.store(0, std::memory_order_release);
  }
  p->cv_free.notify_one();
}

void pf_destroy(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  p->stop.store(true);
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  for (auto& w : p->workers) w.join();
  delete p;
}

}  // extern "C"
