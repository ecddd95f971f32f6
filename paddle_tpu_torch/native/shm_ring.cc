// Shared-memory SPSC ring buffer — the DataLoader worker transport.
//
// Reference parity: the shm queues under paddle/fluid/operators/reader/ +
// python/paddle/io's _DataLoaderIterMultiProcess use_shared_memory path
// (SURVEY.md §2.2 "DataLoader"): worker processes ship serialized batches
// to the trainer without pipe copies. Design here: one single-producer
// single-consumer ring per worker, lock-free via C11-style atomics on a
// shm mapping; blobs are u32-length-prefixed, contiguous (a blob never
// wraps — the writer pads to the end when it wouldn't fit, so readers can
// hand ctypes a contiguous pointer).
//
// C ABI for ctypes (paddle_tpu_torch/io/shm_queue.py), built with g++ by
// paddle_tpu_torch/native/_build.py.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>

namespace {

struct Header {
  std::atomic<uint64_t> head;  // write offset (monotonic)
  std::atomic<uint64_t> tail;  // read offset (monotonic)
  uint64_t capacity;           // data bytes
};

struct Ring {
  Header* hdr = nullptr;
  uint8_t* data = nullptr;
  size_t map_len = 0;
  std::string name;
  bool owner = false;
};

constexpr uint32_t kPad = 0xFFFFFFFFu;  // "skip to end of ring" marker

inline uint64_t pos(const Ring* r, uint64_t off) {
  return off % r->hdr->capacity;
}

inline uint64_t contiguous(const Ring* r, uint64_t off) {
  return r->hdr->capacity - pos(r, off);
}

}  // namespace

extern "C" {

void* shm_ring_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t len = sizeof(Header) + capacity;
  if (ftruncate(fd, static_cast<off_t>(len)) != 0) {
    ::close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* m = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* r = new Ring();
  r->hdr = static_cast<Header*>(m);
  r->data = static_cast<uint8_t*>(m) + sizeof(Header);
  r->map_len = len;
  r->name = name;
  r->owner = true;
  r->hdr->head.store(0);
  r->hdr->tail.store(0);
  r->hdr->capacity = capacity;
  return r;
}

void* shm_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, static_cast<size_t>(st.st_size),
                 PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) return nullptr;
  auto* r = new Ring();
  r->hdr = static_cast<Header*>(m);
  r->data = static_cast<uint8_t*>(m) + sizeof(Header);
  r->map_len = static_cast<size_t>(st.st_size);
  r->name = name;
  return r;
}

// Blocking write; returns 0 ok, -1 timeout, -2 blob too large.
int shm_ring_write(void* handle, const uint8_t* buf, uint32_t len,
                   int timeout_ms) {
  auto* r = static_cast<Ring*>(handle);
  const uint64_t cap = r->hdr->capacity;
  const uint64_t need = 4ull + len;
  if (need > cap) return -2;  // after a pad, a full-capacity run is available
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  for (;;) {
    uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
    uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
    uint64_t avail = cap - (head - tail);
    uint64_t cont = contiguous(r, head);
    if (cont < need) {
      // Blob would wrap. Commit the pad as a SEPARATE step once the pad
      // region itself fits, so the reader can drain it while we wait for
      // the blob's own `need` bytes — waiting for cont+need at once can
      // exceed capacity and deadlock (blobs > ~half the ring).
      if (avail >= cont) {
        if (cont >= 4) {
          uint32_t marker = kPad;
          memcpy(r->data + pos(r, head), &marker, 4);
        }
        r->hdr->head.store(head + cont, std::memory_order_release);
        continue;
      }
    } else if (avail >= need) {
      memcpy(r->data + pos(r, head), &len, 4);
      memcpy(r->data + pos(r, head) + 4, buf, len);
      r->hdr->head.store(head + need, std::memory_order_release);
      return 0;
    }
    if (timeout_ms >= 0 && std::chrono::steady_clock::now() >= deadline)
      return -1;
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
}

// Blocking read: returns blob length (copied into out up to cap bytes),
// -1 on timeout.
int64_t shm_ring_read(void* handle, uint8_t* out, uint64_t out_cap,
                      int timeout_ms) {
  auto* r = static_cast<Ring*>(handle);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  for (;;) {
    uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    if (head != tail) {
      uint64_t cont = contiguous(r, tail);
      if (cont < 4) {  // implicit pad (no room for marker at segment end)
        r->hdr->tail.store(tail + cont, std::memory_order_release);
        continue;
      }
      uint32_t len;
      memcpy(&len, r->data + pos(r, tail), 4);
      if (len == kPad) {  // explicit pad marker: skip to ring start
        r->hdr->tail.store(tail + cont, std::memory_order_release);
        continue;
      }
      uint64_t n = len < out_cap ? len : out_cap;
      memcpy(out, r->data + pos(r, tail) + 4, n);
      r->hdr->tail.store(tail + 4 + len, std::memory_order_release);
      return static_cast<int64_t>(len);
    }
    if (timeout_ms >= 0 && std::chrono::steady_clock::now() >= deadline)
      return -1;
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
}

// Length of the next blob without consuming it; -1 if empty.
int64_t shm_ring_peek(void* handle) {
  auto* r = static_cast<Ring*>(handle);
  for (;;) {
    uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    if (head == tail) return -1;
    uint64_t cont = contiguous(r, tail);
    if (cont < 4) {
      r->hdr->tail.store(tail + cont, std::memory_order_release);
      continue;
    }
    uint32_t len;
    memcpy(&len, r->data + pos(r, tail), 4);
    if (len == kPad) {
      r->hdr->tail.store(tail + cont, std::memory_order_release);
      continue;
    }
    return static_cast<int64_t>(len);
  }
}

void shm_ring_close(void* handle) {
  auto* r = static_cast<Ring*>(handle);
  munmap(r->hdr, r->map_len);
  if (r->owner) shm_unlink(r->name.c_str());
  delete r;
}

void shm_ring_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
