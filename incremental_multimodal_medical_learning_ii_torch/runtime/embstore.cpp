// Native embedding-store runtime (the PyTorch package's copy of the JAX
// package's runtime/embstore.cpp: the same C ABI, file layout and shuffle,
// so a store written by either package opens in the other and a seed gives
// the same batch order in both).
//
// The reference feeds training from torch TensorDatasets deserialized into
// host RAM with multi-process DataLoader workers (Trainer.py:221-246).  This
// runtime feeds the train step padded static batches with no Python in the
// gather:
//
//   * a memory-mapped flat binary store (open is O(1); no pickle/npz
//     decompression; page-cache shared across processes),
//   * a seeded Fisher-Yates epoch shuffler,
//   * a batch gatherer that assembles (embeddings, labels, mask) batches
//     with zero-padding for ragged tails,
//   * a double-buffered background prefetch thread, so batch N+1 is being
//     gathered while the device runs batch N.
//
// File layout (little-endian):
//   magic  u64  = 0x454d4253544f5245  ("EMBSTORE")
//   n      u64, emb_dim u64, n_labels u64
//   embeddings  f32[n * emb_dim]
//   labels      f32[n * n_labels]
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x454d4253544f5245ULL;

struct Header {
  uint64_t magic;
  uint64_t n;
  uint64_t emb_dim;
  uint64_t n_labels;
};

struct Store {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  Header hdr{};
  const float* embs = nullptr;
  const float* labels = nullptr;
};

// Deterministic 64-bit SplitMix64 for the shuffler.
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

struct Batcher {
  Store* store = nullptr;
  int64_t batch_size = 0;
  int64_t padded_size = 0;
  bool shuffle = false;
  uint64_t seed = 0;
  uint64_t epoch = 0;

  std::vector<uint64_t> order;
  int64_t cursor = 0;

  // double-buffered prefetch
  struct Slot {
    std::vector<float> embs, labels, mask;
    int64_t valid = 0;  // true (unpadded) count; 0 = end of epoch
    bool ready = false;
  };
  Slot slots[2];
  int consume_idx = 0;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};

  void fill(Slot& s) {
    const Header& h = store->hdr;
    int64_t remaining = static_cast<int64_t>(h.n) - cursor;
    if (remaining <= 0) {
      s.valid = 0;
      return;
    }
    int64_t take = remaining < batch_size ? remaining : batch_size;
    s.embs.assign(static_cast<size_t>(padded_size) * h.emb_dim, 0.0f);
    s.labels.assign(static_cast<size_t>(padded_size) * h.n_labels, 0.0f);
    s.mask.assign(static_cast<size_t>(padded_size), 0.0f);
    for (int64_t i = 0; i < take; ++i) {
      uint64_t src = order[static_cast<size_t>(cursor + i)];
      std::memcpy(&s.embs[static_cast<size_t>(i) * h.emb_dim],
                  store->embs + src * h.emb_dim, h.emb_dim * sizeof(float));
      std::memcpy(&s.labels[static_cast<size_t>(i) * h.n_labels],
                  store->labels + src * h.n_labels, h.n_labels * sizeof(float));
      s.mask[static_cast<size_t>(i)] = 1.0f;
    }
    cursor += take;
    s.valid = take;
  }

  void start_epoch() {
    // A prior epoch abandoned mid-way leaves `worker` joinable (assigning a
    // new thread over it would std::terminate) — and possibly RUNNING
    // inside fill(), reading order/cursor.  Join it BEFORE touching that
    // state: mutating order (resize can reallocate) or cursor under a live
    // fill() is a use-after-free / torn read.
    if (worker.joinable()) {
      stop.store(true);
      cv.notify_all();
      worker.join();
    }
    const uint64_t n = store->hdr.n;
    order.resize(n);
    for (uint64_t i = 0; i < n; ++i) order[i] = i;
    if (shuffle) {
      uint64_t state = seed ^ (0x9e3779b97f4a7c15ULL * (epoch + 1));
      for (uint64_t i = n; i > 1; --i) {
        uint64_t j = splitmix64(state) % i;
        std::swap(order[i - 1], order[j]);
      }
    }
    ++epoch;
    cursor = 0;
    consume_idx = 0;
    stop.store(false);
    for (auto& s : slots) s.ready = false;
    worker = std::thread([this] {
      int produce_idx = 0;
      while (!stop.load()) {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !slots[produce_idx].ready; });
        if (stop.load()) return;
        lk.unlock();
        fill(slots[produce_idx]);
        lk.lock();
        slots[produce_idx].ready = true;
        cv.notify_all();
        if (slots[produce_idx].valid == 0) return;  // epoch done
        produce_idx ^= 1;
      }
    });
  }

  // Returns valid count (0 at epoch end); copies into caller buffers.
  int64_t next(float* embs_out, float* labels_out, float* mask_out) {
    Slot& s = slots[consume_idx];
    {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return s.ready; });
    }
    int64_t valid = s.valid;
    if (valid > 0) {
      const Header& h = store->hdr;
      std::memcpy(embs_out, s.embs.data(),
                  static_cast<size_t>(padded_size) * h.emb_dim * sizeof(float));
      std::memcpy(labels_out, s.labels.data(),
                  static_cast<size_t>(padded_size) * h.n_labels * sizeof(float));
      std::memcpy(mask_out, s.mask.data(),
                  static_cast<size_t>(padded_size) * sizeof(float));
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      s.ready = false;
      cv.notify_all();
    }
    consume_idx ^= 1;
    if (valid == 0) finish();
    return valid;
  }

  void finish() {
    stop.store(true);
    cv.notify_all();
    if (worker.joinable()) worker.join();
  }

  ~Batcher() { finish(); }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- store
int embstore_write(const char* path, const float* embs, const float* labels,
                   uint64_t n, uint64_t emb_dim, uint64_t n_labels) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  Header h{kMagic, n, emb_dim, n_labels};
  int ok = std::fwrite(&h, sizeof(h), 1, f) == 1 &&
           std::fwrite(embs, sizeof(float), n * emb_dim, f) == n * emb_dim &&
           std::fwrite(labels, sizeof(float), n * n_labels, f) == n * n_labels;
  std::fclose(f);
  return ok ? 0 : -2;
}

void* embstore_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                     MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->map = map;
  s->map_size = static_cast<size_t>(st.st_size);
  if (s->map_size < sizeof(Header)) {
    ::munmap(map, s->map_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  std::memcpy(&s->hdr, map, sizeof(Header));
  // reject truncated files (crash/disk-full mid-write leaves a valid header
  // with n promising more rows than the payload holds): reading past the
  // mapping would SIGBUS instead of failing cleanly
  const uint64_t need = sizeof(Header) +
      s->hdr.n * (s->hdr.emb_dim + s->hdr.n_labels) * sizeof(float);
  if (s->hdr.magic != kMagic || s->map_size < need) {
    ::munmap(map, s->map_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  const char* base = static_cast<const char*>(map) + sizeof(Header);
  s->embs = reinterpret_cast<const float*>(base);
  s->labels = s->embs + s->hdr.n * s->hdr.emb_dim;
  return s;
}

uint64_t embstore_n(void* store) { return static_cast<Store*>(store)->hdr.n; }
uint64_t embstore_emb_dim(void* store) { return static_cast<Store*>(store)->hdr.emb_dim; }
uint64_t embstore_n_labels(void* store) { return static_cast<Store*>(store)->hdr.n_labels; }

void embstore_gather(void* store_p, const uint64_t* indices, uint64_t n_idx,
                     float* embs_out, float* labels_out) {
  Store* s = static_cast<Store*>(store_p);
  const Header& h = s->hdr;
  for (uint64_t i = 0; i < n_idx; ++i) {
    std::memcpy(embs_out + i * h.emb_dim, s->embs + indices[i] * h.emb_dim,
                h.emb_dim * sizeof(float));
    std::memcpy(labels_out + i * h.n_labels, s->labels + indices[i] * h.n_labels,
                h.n_labels * sizeof(float));
  }
}

void embstore_close(void* store_p) {
  Store* s = static_cast<Store*>(store_p);
  if (s->map) ::munmap(s->map, s->map_size);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

// ---------------------------------------------------------------- batcher
void* batcher_create(void* store, int64_t batch_size, int64_t padded_size,
                     int shuffle, uint64_t seed) {
  auto* b = new Batcher();
  b->store = static_cast<Store*>(store);
  b->batch_size = batch_size;
  b->padded_size = padded_size < batch_size ? batch_size : padded_size;
  b->shuffle = shuffle != 0;
  b->seed = seed;
  return b;
}

void batcher_start_epoch(void* b) { static_cast<Batcher*>(b)->start_epoch(); }

int64_t batcher_next(void* b, float* embs_out, float* labels_out, float* mask_out) {
  return static_cast<Batcher*>(b)->next(embs_out, labels_out, mask_out);
}

void batcher_destroy(void* b) { delete static_cast<Batcher*>(b); }

}  // extern "C"
