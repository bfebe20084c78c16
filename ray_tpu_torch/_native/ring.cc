// Native core for ray_tpu_torch: futex-backed SPSC ring ops + parallel memcpy.
//
// Parity rationale: the reference implements its low-latency substrate in
// C++ (src/ray/core_worker/experimental_mutable_object_manager.h for
// compiled-graph channels; plasma/object copies in src/ray/object_manager).
// This file is the TPU-native equivalent: the channel header lives in a
// shared-memory segment and both ends block in the kernel (futex) instead
// of burning the (often single) host core on sleep-poll loops.
//
// Header layout at the base of every channel segment (64 bytes, see
// ray_tpu_torch/experimental/channel.py which shares it):
//   [0]  u64 seq    — number of messages ever published by the writer
//   [8]  u64 ack    — number of messages ever consumed by the reader
//   [16] u64 size   — payload byte length of the current message
//   [24] u32 wseq   — futex word mirroring (u32)seq: readers wait on it
//   [28] u32 wack   — futex word mirroring (u32)ack: writers wait on it
//   [32..64) reserved
// Data area starts at byte 64.
//
// Waits are BOUNDED (default 2 ms per kernel wait, then re-check) so a
// peer running the pure-Python fallback — which never calls futex_wake —
// still interoperates; the wake call just makes the native<->native pair
// fast. All functions return 0/length on success, -1 on timeout.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr size_t kHdr = 64;
constexpr long kSliceNs = 2'000'000;  // bounded kernel wait per iteration

struct Hdr {
  std::atomic<uint64_t> seq;
  std::atomic<uint64_t> ack;
  std::atomic<uint64_t> size;
  std::atomic<uint32_t> wseq;
  std::atomic<uint32_t> wack;
};

static_assert(sizeof(Hdr) <= kHdr, "header overflow");

inline Hdr* hdr(uint8_t* base) { return reinterpret_cast<Hdr*>(base); }

inline int futex_wait(std::atomic<uint32_t>* addr, uint32_t expect, long ns) {
  timespec ts{0, ns};
  return syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr),
                 FUTEX_WAIT, expect, &ts, nullptr, 0);
}

inline void futex_wake(std::atomic<uint32_t>* addr) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE,
          INT32_MAX, nullptr, nullptr, 0);
}

inline int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1'000'000'000 + ts.tv_nsec;
}

}  // namespace

extern "C" {

// Write one message. Blocks until the previous message is acked (capacity-1
// backpressure, matching the reference mutable-object semantics).
int rt_ring_write(uint8_t* base, uint64_t cap, const uint8_t* data,
                  uint64_t n, int64_t timeout_ns) {
  if (n > cap) return -2;
  Hdr* h = hdr(base);
  const uint64_t seq = h->seq.load(std::memory_order_acquire);
  const int64_t deadline = timeout_ns < 0 ? -1 : now_ns() + timeout_ns;
  while (h->ack.load(std::memory_order_acquire) < seq) {
    if (deadline >= 0 && now_ns() > deadline) return -1;
    futex_wait(&h->wack, static_cast<uint32_t>(seq - 1), kSliceNs);
  }
  std::memcpy(base + kHdr, data, n);
  h->size.store(n, std::memory_order_release);
  h->seq.store(seq + 1, std::memory_order_release);
  h->wseq.store(static_cast<uint32_t>(seq + 1), std::memory_order_release);
  futex_wake(&h->wseq);
  return 0;
}

// Wait until seq > last_read; returns the payload length (copied into out,
// which must hold cap bytes), or -1 on timeout.
int64_t rt_ring_read(uint8_t* base, uint64_t cap, uint8_t* out,
                     uint64_t last_read, int64_t timeout_ns) {
  Hdr* h = hdr(base);
  const int64_t deadline = timeout_ns < 0 ? -1 : now_ns() + timeout_ns;
  while (h->seq.load(std::memory_order_acquire) <= last_read) {
    if (deadline >= 0 && now_ns() > deadline) return -1;
    futex_wait(&h->wseq, static_cast<uint32_t>(last_read), kSliceNs);
  }
  const uint64_t n = h->size.load(std::memory_order_acquire);
  if (n > cap) return -2;
  std::memcpy(out, base + kHdr, n);
  const uint64_t seq = h->seq.load(std::memory_order_acquire);
  h->ack.store(seq, std::memory_order_release);
  h->wack.store(static_cast<uint32_t>(seq), std::memory_order_release);
  futex_wake(&h->wack);
  return static_cast<int64_t>(n);
}

// Zero-copy variant: blocks for the next message, returns its length, and
// leaves the payload in place (caller reads base+64 directly, then calls
// rt_ring_ack). -1 on timeout.
int64_t rt_ring_wait(uint8_t* base, uint64_t last_read, int64_t timeout_ns) {
  Hdr* h = hdr(base);
  const int64_t deadline = timeout_ns < 0 ? -1 : now_ns() + timeout_ns;
  while (h->seq.load(std::memory_order_acquire) <= last_read) {
    if (deadline >= 0 && now_ns() > deadline) return -1;
    futex_wait(&h->wseq, static_cast<uint32_t>(last_read), kSliceNs);
  }
  return static_cast<int64_t>(h->size.load(std::memory_order_acquire));
}

void rt_ring_ack(uint8_t* base) {
  Hdr* h = hdr(base);
  const uint64_t seq = h->seq.load(std::memory_order_acquire);
  h->ack.store(seq, std::memory_order_release);
  h->wack.store(static_cast<uint32_t>(seq), std::memory_order_release);
  futex_wake(&h->wack);
}

// Parallel memcpy: splits a large copy across threads. On many-core TPU
// hosts a single-threaded memcpy leaves most of the memory bandwidth on
// the table; the object-store put path calls this for multi-MB payloads.
void rt_parallel_memcpy(uint8_t* dst, const uint8_t* src, uint64_t n,
                        int nthreads) {
  if (nthreads <= 1 || n < (4u << 20)) {
    std::memcpy(dst, src, n);
    return;
  }
  const uint64_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<std::thread> ts;
  ts.reserve(nthreads - 1);
  for (int i = 1; i < nthreads; ++i) {
    const uint64_t off = uint64_t(i) * chunk;
    if (off >= n) break;
    const uint64_t len = std::min(chunk, n - off);
    ts.emplace_back([=] { std::memcpy(dst + off, src + off, len); });
  }
  std::memcpy(dst, src, std::min(chunk, n));
  for (auto& t : ts) t.join();
}

}  // extern "C"
