// tpunative — native runtime helpers of the training engine: the port's
// copy of tpu_engine/native/tpunative.cpp, built and bound by
// tpu_engine_torch/native/__init__.py.
//
//   1. a memory-mapped tokenized-dataset reader with threaded batch gather
//      and a double-buffered background prefetcher, so the host-side input
//      pipeline does not make the device wait;
//   2. a host telemetry probe (/proc).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
// Threading model: one reader handle may be used from one Python thread;
// the prefetcher owns its own worker threads internally.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Deterministic RNG (splitmix64) — epoch shuffles must be reproducible
// across hosts so every data-parallel rank derives the same permutation.
// ---------------------------------------------------------------------------

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
};

// ---------------------------------------------------------------------------
// Reader
// ---------------------------------------------------------------------------

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_bytes = 0;
  int dtype_bytes = 2;  // 2 = uint16 tokens, 4 = int32 tokens
  int64_t seq_len = 0;
  int64_t n_tokens = 0;
  int64_t n_seqs = 0;

  // Prefetcher state.
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::vector<int32_t> slots[2];
  int ready[2] = {0, 0};
  int next_fill = 0, next_pop = 0;
  int64_t batch = 0;
  uint64_t seed = 0;
  bool shuffle = true;
  int64_t cursor = 0;     // position in the permutation
  int64_t epoch = 0;
  std::vector<int64_t> perm;
  std::atomic<bool> stop{false};
  bool prefetching = false;

  ~Reader() {
    stop_prefetch();
    if (base) munmap(const_cast<uint8_t*>(base), file_bytes);
    if (fd >= 0) close(fd);
  }

  void reshuffle() {
    perm.resize(n_seqs);
    for (int64_t i = 0; i < n_seqs; ++i) perm[i] = i;
    if (shuffle) {
      SplitMix64 rng(seed ^ (0xA5A5A5A5ULL * (uint64_t)(epoch + 1)));
      for (int64_t i = n_seqs - 1; i > 0; --i) {
        int64_t j = (int64_t)(rng.next() % (uint64_t)(i + 1));
        std::swap(perm[i], perm[j]);
      }
    }
  }

  // Copy sequence `idx` (seq_len tokens) into out as int32.
  inline void copy_seq(int64_t idx, int32_t* out) const {
    const uint8_t* src = base + (size_t)idx * seq_len * dtype_bytes;
    if (dtype_bytes == 2) {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
      for (int64_t t = 0; t < seq_len; ++t) out[t] = (int32_t)s[t];
    } else {
      memcpy(out, src, (size_t)seq_len * 4);
    }
  }

  // Gather a batch of sequences by explicit indices, multi-threaded.
  void gather(const int64_t* idx, int64_t n, int32_t* out, int n_threads) const {
    if (n_threads <= 1 || n < 4) {
      for (int64_t i = 0; i < n; ++i) copy_seq(idx[i], out + i * seq_len);
      return;
    }
    std::vector<std::thread> ts;
    std::atomic<int64_t> next{0};
    for (int t = 0; t < n_threads; ++t) {
      ts.emplace_back([&]() {
        int64_t i;
        while ((i = next.fetch_add(1)) < n) copy_seq(idx[i], out + i * seq_len);
      });
    }
    for (auto& t : ts) t.join();
  }

  // Next `batch` indices from the (reshuffled-per-epoch) permutation.
  void next_indices(std::vector<int64_t>& out_idx) {
    out_idx.resize(batch);
    for (int64_t i = 0; i < batch; ++i) {
      if (cursor >= n_seqs) {
        ++epoch;
        cursor = 0;
        reshuffle();
      }
      out_idx[i] = perm[cursor++];
    }
  }

  void prefetch_loop() {
    std::vector<int64_t> idx;
    while (!stop.load()) {
      next_indices(idx);
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_empty.wait(lk, [&] { return stop.load() || !ready[next_fill]; });
        if (stop.load()) return;
        slot = next_fill;
      }
      gather(idx.data(), batch, slots[slot].data(), 4);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready[slot] = 1;
        next_fill = 1 - next_fill;
      }
      cv_full.notify_one();
    }
  }

  void start_prefetch(int64_t batch_, uint64_t seed_, bool shuffle_) {
    stop_prefetch();
    batch = batch_;
    seed = seed_;
    shuffle = shuffle_;
    cursor = 0;
    epoch = 0;
    reshuffle();
    slots[0].assign((size_t)batch * seq_len, 0);
    slots[1].assign((size_t)batch * seq_len, 0);
    ready[0] = ready[1] = 0;
    next_fill = next_pop = 0;
    stop.store(false);
    prefetching = true;
    worker = std::thread([this] { prefetch_loop(); });
  }

  int next_batch(int32_t* out) {
    if (!prefetching) return -1;
    int slot;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return stop.load() || ready[next_pop]; });
      if (stop.load()) return -2;
      slot = next_pop;
    }
    memcpy(out, slots[slot].data(), (size_t)batch * seq_len * 4);
    {
      std::lock_guard<std::mutex> lk(mu);
      ready[slot] = 0;
      next_pop = 1 - next_pop;
    }
    cv_empty.notify_one();
    return 0;
  }

  void stop_prefetch() {
    if (!prefetching) return;
    stop.store(true);
    cv_full.notify_all();
    cv_empty.notify_all();
    if (worker.joinable()) worker.join();
    prefetching = false;
  }
};

}  // namespace

extern "C" {

// dtype_code: 2 = uint16 tokens, 4 = int32 tokens. Returns nullptr on error.
void* tn_open(const char* path, int64_t seq_len, int dtype_code) {
  if (seq_len <= 0 || (dtype_code != 2 && dtype_code != 4)) return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < seq_len * dtype_code) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  madvise(base, (size_t)st.st_size, MADV_WILLNEED);
  Reader* r = new Reader();
  r->fd = fd;
  r->base = static_cast<const uint8_t*>(base);
  r->file_bytes = (size_t)st.st_size;
  r->dtype_bytes = dtype_code;
  r->seq_len = seq_len;
  r->n_tokens = st.st_size / dtype_code;
  r->n_seqs = r->n_tokens / seq_len;
  return r;
}

int64_t tn_num_sequences(void* h) { return h ? static_cast<Reader*>(h)->n_seqs : -1; }
int64_t tn_num_tokens(void* h) { return h ? static_cast<Reader*>(h)->n_tokens : -1; }

// Gather `n` sequences by explicit index into out[n * seq_len] (int32).
// Returns 0, or -1 on a bad handle / out-of-range index.
int tn_read_batch(void* h, const int64_t* idx, int64_t n, int32_t* out,
                  int n_threads) {
  if (!h || !idx || !out || n <= 0) return -1;
  Reader* r = static_cast<Reader*>(h);
  for (int64_t i = 0; i < n; ++i)
    if (idx[i] < 0 || idx[i] >= r->n_seqs) return -1;
  r->gather(idx, n, out, n_threads);
  return 0;
}

// Background double-buffered prefetch of shuffled batches.
int tn_prefetch_start(void* h, int64_t batch, uint64_t seed, int shuffle) {
  if (!h || batch <= 0) return -1;
  Reader* r = static_cast<Reader*>(h);
  if (batch > r->n_seqs) return -1;
  r->start_prefetch(batch, seed, shuffle != 0);
  return 0;
}

// Blocking pop of the next prefetched batch into out[batch * seq_len].
int tn_next_batch(void* h, int32_t* out) {
  if (!h || !out) return -1;
  return static_cast<Reader*>(h)->next_batch(out);
}

int64_t tn_epoch(void* h) { return h ? static_cast<Reader*>(h)->epoch : -1; }

void tn_close(void* h) { delete static_cast<Reader*>(h); }

// ---------------------------------------------------------------------------
// Host telemetry (/proc) — feeds TPUManager's fleet status with real host
// facts (the reference's host plane came from nvidia-smi's XML).
// ---------------------------------------------------------------------------

struct TnHostStats {
  double mem_total_gb;
  double mem_available_gb;
  double load_1m;
  double load_5m;
  int64_t n_cpus;
};

int tn_host_stats(TnHostStats* out) {
  if (!out) return -1;
  memset(out, 0, sizeof(*out));
  out->n_cpus = (int64_t)sysconf(_SC_NPROCESSORS_ONLN);

  FILE* f = fopen("/proc/meminfo", "r");
  if (f) {
    char key[64];
    long long kb;
    while (fscanf(f, "%63s %lld kB\n", key, &kb) == 2) {
      if (strcmp(key, "MemTotal:") == 0) out->mem_total_gb = kb / 1048576.0;
      if (strcmp(key, "MemAvailable:") == 0) out->mem_available_gb = kb / 1048576.0;
    }
    fclose(f);
  }
  f = fopen("/proc/loadavg", "r");
  if (f) {
    if (fscanf(f, "%lf %lf", &out->load_1m, &out->load_5m) != 2) {
      out->load_1m = out->load_5m = 0.0;
    }
    fclose(f);
  }
  return 0;
}

}  // extern "C"
