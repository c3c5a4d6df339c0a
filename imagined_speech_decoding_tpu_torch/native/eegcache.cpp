// libeegcache — native binary corpus cache for the EEG data layer.
//
// The reference stores its preprocessed corpus in gzip HDF5 and reads it
// through h5py (scripts/preprocess.py:83-99, src/fast/data/loaders.py:
// 27-45). For production serving/training the hot requirement is raw
// sequential + strided read bandwidth into host buffers that feed the
// device; this library provides a minimal, dependency-free binary tensor
// container with multi-threaded I/O:
//
//   header:  magic 'EEGC' | version u32 | dtype u32 (0=f32,1=u8,2=bf16)
//            | ndim u32 | dims u64[ndim]
//   payload: contiguous row-major tensor bytes
//
// C API (ctypes-friendly): write, open/close, metadata queries, full and
// trial-sliced reads. Reads fan out across threads in contiguous spans —
// on page-cached files this saturates memory bandwidth, and cold reads
// overlap seek latency.
//
// The PyTorch port's own copy of the JAX package's native/eegcache.cpp,
// with the same C interface and file format.
// imagined_speech_decoding_tpu_torch/_native.py builds it into
// build/isd_torch_native/ on first use; data/fastcache.py binds it.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x43474545;  // 'EEGC' little-endian
constexpr uint32_t kVersion = 1;
constexpr int kMaxDims = 8;

struct Header {
  uint32_t magic;
  uint32_t version;
  uint32_t dtype;
  uint32_t ndim;
  uint64_t dims[kMaxDims];
};

size_t dtype_size(uint32_t dtype) {
  switch (dtype) {
    case 0: return 4;  // float32
    case 1: return 1;  // uint8
    case 2: return 2;  // bfloat16
    default: return 0;
  }
}

struct Handle {
  std::string path;
  Header header;
  uint64_t payload_offset;
  uint64_t total_elems;
};

uint64_t elem_count(const Header& h) {
  uint64_t n = 1;
  for (uint32_t i = 0; i < h.ndim; ++i) n *= h.dims[i];
  return n;
}

// Read [offset, offset+size) of the payload into dst using n_threads
// contiguous spans.
int read_span_threaded(const Handle* h, uint64_t byte_offset, uint64_t byte_size,
                       char* dst, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  std::vector<int> status(n_threads, 0);
  uint64_t chunk = (byte_size + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    uint64_t lo = t * chunk;
    if (lo >= byte_size) break;
    uint64_t hi = lo + chunk < byte_size ? lo + chunk : byte_size;
    workers.emplace_back([h, dst, byte_offset, lo, hi, t, &status]() {
      FILE* f = std::fopen(h->path.c_str(), "rb");
      if (!f) { status[t] = -1; return; }
      // fseeko, not fseek: long is 32-bit on some ABIs and a >2 GiB
      // cache offset would silently truncate.
      if (fseeko(f, static_cast<off_t>(h->payload_offset + byte_offset + lo), SEEK_SET) != 0) {
        std::fclose(f);
        status[t] = -2;
        return;
      }
      size_t got = std::fread(dst + lo, 1, hi - lo, f);
      std::fclose(f);
      status[t] = got == hi - lo ? 0 : -3;
    });
  }
  for (auto& w : workers) w.join();
  for (int s : status)
    if (s != 0) return s;
  return 0;
}

}  // namespace

extern "C" {

// Write a tensor to a cache file. Returns 0 on success.
int eegcache_write(const char* path, const void* data, uint32_t dtype,
                   uint32_t ndim, const uint64_t* dims) {
  if (ndim == 0 || ndim > kMaxDims || dtype_size(dtype) == 0) return -1;
  Header h{};
  h.magic = kMagic;
  h.version = kVersion;
  h.dtype = dtype;
  h.ndim = ndim;
  uint64_t n = 1;
  for (uint32_t i = 0; i < ndim; ++i) {
    h.dims[i] = dims[i];
    n *= dims[i];
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  if (std::fwrite(&h, sizeof(Header), 1, f) != 1) { std::fclose(f); return -3; }
  uint64_t bytes = n * dtype_size(dtype);
  if (std::fwrite(data, 1, bytes, f) != bytes) { std::fclose(f); return -4; }
  std::fclose(f);
  return 0;
}

// Open a cache; returns an opaque handle (nullptr on failure).
void* eegcache_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Header h{};
  if (std::fread(&h, sizeof(Header), 1, f) != 1 || h.magic != kMagic ||
      h.version != kVersion || h.ndim == 0 || h.ndim > kMaxDims ||
      dtype_size(h.dtype) == 0) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  auto* handle = new Handle();
  handle->path = path;
  handle->header = h;
  handle->payload_offset = sizeof(Header);
  handle->total_elems = elem_count(h);
  return handle;
}

void eegcache_close(void* handle) { delete static_cast<Handle*>(handle); }

uint32_t eegcache_dtype(const void* handle) {
  return static_cast<const Handle*>(handle)->header.dtype;
}

uint32_t eegcache_ndim(const void* handle) {
  return static_cast<const Handle*>(handle)->header.ndim;
}

void eegcache_dims(const void* handle, uint64_t* out) {
  const auto* h = static_cast<const Handle*>(handle);
  std::memcpy(out, h->header.dims, h->header.ndim * sizeof(uint64_t));
}

// Read the full payload into dst (threaded). Returns 0 on success.
int eegcache_read_all(const void* handle, void* dst, int n_threads) {
  const auto* h = static_cast<const Handle*>(handle);
  uint64_t bytes = h->total_elems * dtype_size(h->header.dtype);
  return read_span_threaded(h, 0, bytes, static_cast<char*>(dst), n_threads);
}

// Read rows [start, start+count) of the leading axis into dst (threaded).
int eegcache_read_rows(const void* handle, uint64_t start, uint64_t count,
                       void* dst, int n_threads) {
  const auto* h = static_cast<const Handle*>(handle);
  // Overflow-safe bounds check: `start + count` could wrap (e.g. a
  // negative Python int coerced through c_uint64) past a naive check.
  if (start > h->header.dims[0] || count > h->header.dims[0] - start) return -1;
  uint64_t row_elems = h->total_elems / h->header.dims[0];
  uint64_t esz = dtype_size(h->header.dtype);
  return read_span_threaded(h, start * row_elems * esz, count * row_elems * esz,
                            static_cast<char*>(dst), n_threads);
}

}  // extern "C"
