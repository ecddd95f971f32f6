// TCPStore: KV rendezvous for distributed bootstrap.
//
// Reference parity: paddle/fluid/distributed/store/tcp_store.cc
// (SURVEY.md §2.1 "TCPStore"): a master daemon on rank 0 serving
// set/get/add/wait over TCP; workers connect and block on wait().
// It serves launch rendezvous, user barriers and checkpoint coordination
// on the CPU side, with no Python in the hot wait loop.
//
// Exposed as a C ABI for ctypes (paddle_tpu_torch/distributed/store.py),
// built with g++ by paddle_tpu_torch/native/_build.py.
//
// Protocol (all little-endian):
//   request:  u8 op | u32 klen | key | u64 arg | u32 vlen | value
//     op: 0=SET 1=GET 2=ADD 3=WAIT 4=DELETE 5=NUM_KEYS
//   response: i64 status/num | u32 vlen | value
//     GET: status 0 + value, or -1 (missing). WAIT blocks until key exists.

#include <algorithm>
#include <arpa/inet.h>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Daemon {
  int listen_fd = -1;
  std::thread accept_thread;
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::vector<uint8_t>> kv;
  bool stopping = false;
  std::vector<std::thread> workers;
  std::vector<int> client_fds;  // open connections, for shutdown on stop
};

bool read_exact(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void serve_client(Daemon* d, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  for (;;) {
    uint8_t op;
    uint32_t klen;
    if (!read_exact(fd, &op, 1) || !read_exact(fd, &klen, 4)) break;
    std::string key(klen, '\0');
    if (klen && !read_exact(fd, key.data(), klen)) break;
    uint64_t arg;
    uint32_t vlen;
    if (!read_exact(fd, &arg, 8) || !read_exact(fd, &vlen, 4)) break;
    std::vector<uint8_t> val(vlen);
    if (vlen && !read_exact(fd, val.data(), vlen)) break;

    int64_t status = 0;
    std::vector<uint8_t> out;
    switch (op) {
      case 0: {  // SET
        std::lock_guard<std::mutex> g(d->mu);
        d->kv[key] = std::move(val);
        d->cv.notify_all();
        break;
      }
      case 1: {  // GET
        std::lock_guard<std::mutex> g(d->mu);
        auto it = d->kv.find(key);
        if (it == d->kv.end()) {
          status = -1;
        } else {
          out = it->second;
        }
        break;
      }
      case 2: {  // ADD (i64 counter); result rides the VALUE channel so
                 // negative counters don't collide with transport errors
        std::lock_guard<std::mutex> g(d->mu);
        int64_t cur = 0;
        auto it = d->kv.find(key);
        if (it != d->kv.end() && it->second.size() == 8)
          memcpy(&cur, it->second.data(), 8);
        cur += static_cast<int64_t>(arg);
        std::vector<uint8_t> enc(8);
        memcpy(enc.data(), &cur, 8);
        d->kv[key] = enc;
        out = enc;
        status = 0;
        d->cv.notify_all();
        break;
      }
      case 3: {  // WAIT (arg = timeout ms, 0 = forever)
        std::unique_lock<std::mutex> g(d->mu);
        auto pred = [&] { return d->stopping || d->kv.count(key) > 0; };
        if (arg == 0) {
          d->cv.wait(g, pred);
        } else if (!d->cv.wait_for(g, std::chrono::milliseconds(arg),
                                   pred)) {
          status = -2;  // timeout
        }
        if (d->stopping) status = -3;
        if (status == 0) out = d->kv[key];
        break;
      }
      case 4: {  // DELETE
        std::lock_guard<std::mutex> g(d->mu);
        status = static_cast<int64_t>(d->kv.erase(key));
        break;
      }
      case 5: {  // NUM_KEYS
        std::lock_guard<std::mutex> g(d->mu);
        status = static_cast<int64_t>(d->kv.size());
        break;
      }
      default:
        status = -100;
    }
    uint32_t olen = static_cast<uint32_t>(out.size());
    if (!write_exact(fd, &status, 8) || !write_exact(fd, &olen, 4)) break;
    if (olen && !write_exact(fd, out.data(), olen)) break;
  }
  {
    // prune before close: master_stop must never shutdown() a reused fd
    std::lock_guard<std::mutex> g(d->mu);
    auto& v = d->client_fds;
    v.erase(std::remove(v.begin(), v.end(), fd), v.end());
  }
  ::close(fd);
}

}  // namespace

extern "C" {

// ----------------------------------------------------------------- master
void* tcp_store_master_start(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 128) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* d = new Daemon();
  d->listen_fd = fd;
  d->accept_thread = std::thread([d] {
    for (;;) {
      int cfd = ::accept(d->listen_fd, nullptr, nullptr);
      if (cfd < 0) {
        {
          std::lock_guard<std::mutex> g(d->mu);
          if (d->stopping) break;
        }
        if (errno == EINTR) continue;
        break;
      }
      std::lock_guard<std::mutex> g(d->mu);
      if (d->stopping) {
        ::close(cfd);
        break;
      }
      d->client_fds.push_back(cfd);
      d->workers.emplace_back(serve_client, d, cfd);
    }
  });
  return d;
}

int tcp_store_master_port(void* handle) {
  auto* d = static_cast<Daemon*>(handle);
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(d->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len))
    return -1;
  return ntohs(addr.sin_port);
}

void tcp_store_master_stop(void* handle) {
  auto* d = static_cast<Daemon*>(handle);
  {
    std::lock_guard<std::mutex> g(d->mu);
    d->stopping = true;
    d->cv.notify_all();
    // unblock worker threads parked in read() on live connections
    for (int cfd : d->client_fds) ::shutdown(cfd, SHUT_RDWR);
  }
  ::shutdown(d->listen_fd, SHUT_RDWR);
  ::close(d->listen_fd);
  d->accept_thread.join();
  std::vector<std::thread> ws;
  {
    std::lock_guard<std::mutex> g(d->mu);
    ws.swap(d->workers);
  }
  for (auto& w : ws) w.join();
  delete d;
}

// ----------------------------------------------------------------- client
int tcp_store_connect(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  // retry-connect until timeout (workers may start before the master)
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (::connect(fd, reinterpret_cast<sockaddr*>(&addr),
                   sizeof(addr)) != 0) {
    ::close(fd);
    if (std::chrono::steady_clock::now() >= deadline) return -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// Returns status; fills out up to out_cap bytes, sets *out_len.
static int64_t request(int fd, uint8_t op, const char* key, uint64_t arg,
                       const uint8_t* val, uint32_t vlen, uint8_t* out,
                       uint32_t out_cap, uint32_t* out_len) {
  uint32_t klen = static_cast<uint32_t>(strlen(key));
  if (!write_exact(fd, &op, 1) || !write_exact(fd, &klen, 4) ||
      !write_exact(fd, key, klen) || !write_exact(fd, &arg, 8) ||
      !write_exact(fd, &vlen, 4))
    return -200;
  if (vlen && !write_exact(fd, val, vlen)) return -200;
  int64_t status;
  uint32_t olen;
  if (!read_exact(fd, &status, 8) || !read_exact(fd, &olen, 4)) return -200;
  std::vector<uint8_t> tmp(olen);
  if (olen && !read_exact(fd, tmp.data(), olen)) return -200;
  if (out_len) *out_len = olen;
  if (out && olen) memcpy(out, tmp.data(), olen < out_cap ? olen : out_cap);
  return status;
}

int64_t tcp_store_set(int fd, const char* key, const uint8_t* val,
                      uint32_t vlen) {
  return request(fd, 0, key, 0, val, vlen, nullptr, 0, nullptr);
}

int64_t tcp_store_get(int fd, const char* key, uint8_t* out,
                      uint32_t out_cap, uint32_t* out_len) {
  return request(fd, 1, key, 0, nullptr, 0, out, out_cap, out_len);
}

// status in return value; counter in *result (value channel — a negative
// counter is legal and must not look like a transport error)
int64_t tcp_store_add(int fd, const char* key, int64_t amount,
                      int64_t* result) {
  uint8_t out[8];
  uint32_t olen = 0;
  int64_t st = request(fd, 2, key, static_cast<uint64_t>(amount), nullptr,
                       0, out, 8, &olen);
  if (st == 0 && olen == 8 && result) memcpy(result, out, 8);
  return st;
}

int64_t tcp_store_wait(int fd, const char* key, uint64_t timeout_ms,
                       uint8_t* out, uint32_t out_cap, uint32_t* out_len) {
  return request(fd, 3, key, timeout_ms, nullptr, 0, out, out_cap, out_len);
}

int64_t tcp_store_delete(int fd, const char* key) {
  return request(fd, 4, key, 0, nullptr, 0, nullptr, 0, nullptr);
}

int64_t tcp_store_num_keys(int fd) {
  return request(fd, 5, "", 0, nullptr, 0, nullptr, 0, nullptr);
}

void tcp_store_close(int fd) { ::close(fd); }

}  // extern "C"
