// libeegring — lock-free SPSC ring buffer for real-time EEG acquisition.
//
// Native serving tier (see imagined_speech_decoding_tpu_torch/ringbuf.py): an
// acquisition thread pushes arbitrary-length (C, n) sample chunks while
// the decode loop snapshots the latest (C, window) samples with bounded
// latency and no locks. The Python StreamingDecoder's numpy ring
// (serving.py) serializes producer and consumer through the GIL; this
// tier lets a C/C++ acquisition callback run concurrently with decode.
//
// Consistency protocol (seqlock-flavored, single producer / single
// consumer, though multiple readers are also safe):
//   producer: reserve += n  (release)  -> write samples -> total += n (release)
//   consumer: t0 = total (acquire); copy window ending at t0;
//             r1 = reserve (acquire);
//             valid iff r1 - (t0 - window) <= capacity
// A committed sample with global index g lives in slot g % capacity and
// is only overwritten by a write with index >= g + capacity; any such
// write is visible in `reserve` before it touches the slot, so the
// post-copy check detects every possible tear.
//
// The PyTorch port's own copy of the JAX package's native/eegring.cpp,
// with the same C interface. imagined_speech_decoding_tpu_torch/_native.py
// builds it into build/isd_torch_native/ on first use.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct EegRing {
  uint32_t channels;
  uint32_t capacity;                 // samples per channel
  std::atomic<uint64_t> reserve{0};  // samples claimed (incl. in-flight)
  std::atomic<uint64_t> total{0};    // samples committed
  std::vector<float> data;           // channels x capacity, row-major

  EegRing(uint32_t c, uint32_t cap)
      : channels(c), capacity(cap), data(static_cast<size_t>(c) * cap, 0.f) {}
};

}  // namespace

extern "C" {

void* eegring_create(uint32_t channels, uint32_t capacity) {
  if (channels == 0 || capacity == 0) return nullptr;
  return new EegRing(channels, capacity);
}

void eegring_destroy(void* ring) { delete static_cast<EegRing*>(ring); }

uint32_t eegring_channels(void* ring) {
  return static_cast<EegRing*>(ring)->channels;
}

uint32_t eegring_capacity(void* ring) {
  return static_cast<EegRing*>(ring)->capacity;
}

uint64_t eegring_total(void* ring) {
  return static_cast<EegRing*>(ring)->total.load(std::memory_order_acquire);
}

// Producer: append (C, n) row-major samples. Single producer only.
void eegring_push(void* ring_, const float* chunk, uint64_t n) {
  EegRing* ring = static_cast<EegRing*>(ring_);
  if (n == 0) return;
  const uint64_t cap = ring->capacity;
  // seq_cst, NOT release: a release RMW orders only PRIOR accesses, so
  // the sample stores below could become visible before the increment
  // (weakly-ordered hardware or compiler reordering), letting a
  // consumer validate a torn snapshot against a stale `reserve`. The
  // protocol requires the reservation to be visible before any slot is
  // touched.
  const uint64_t start = ring->reserve.fetch_add(n, std::memory_order_seq_cst);
  // Only the last `cap` samples of an oversized chunk can survive.
  uint64_t skip = n > cap ? n - cap : 0;
  for (uint32_t c = 0; c < ring->channels; ++c) {
    const float* src = chunk + static_cast<size_t>(c) * n + skip;
    float* row = ring->data.data() + static_cast<size_t>(c) * cap;
    uint64_t remaining = n - skip;
    uint64_t g = (start + skip) % cap;
    while (remaining > 0) {
      uint64_t run = std::min(remaining, cap - g);
      std::memcpy(row + g, src, run * sizeof(float));
      src += run;
      g = (g + run) % cap;
      remaining -= run;
    }
  }
  ring->total.fetch_add(n, std::memory_order_release);
}

// Consumer: copy the latest `window` samples per channel into
// out (C, window) row-major. Returns the snapshot's end index (total at
// capture) on success, -1 if fewer than `window` samples have been
// pushed, -2 if `max_retries` consecutive copies were torn by the
// producer (window too close to capacity for the push rate).
long long eegring_snapshot(void* ring_, float* out, uint64_t window,
                           int max_retries) {
  EegRing* ring = static_cast<EegRing*>(ring_);
  const uint64_t cap = ring->capacity;
  if (window == 0 || window > cap) return -1;
  for (int attempt = 0; attempt <= max_retries; ++attempt) {
    const uint64_t t0 = ring->total.load(std::memory_order_acquire);
    if (t0 < window) return -1;
    const uint64_t first = t0 - window;  // global index of oldest sample
    for (uint32_t c = 0; c < ring->channels; ++c) {
      const float* row = ring->data.data() + static_cast<size_t>(c) * cap;
      float* dst = out + static_cast<size_t>(c) * window;
      uint64_t remaining = window;
      uint64_t g = first % cap;
      while (remaining > 0) {
        uint64_t run = std::min(remaining, cap - g);
        std::memcpy(dst, row + g, run * sizeof(float));
        dst += run;
        g = (g + run) % cap;
        remaining -= run;
      }
    }
    std::atomic_thread_fence(std::memory_order_acquire);
    const uint64_t r1 = ring->reserve.load(std::memory_order_acquire);
    if (r1 - first <= cap) return static_cast<long long>(t0);
  }
  return -2;
}

}  // extern "C"
