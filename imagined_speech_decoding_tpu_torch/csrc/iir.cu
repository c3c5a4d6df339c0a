// Biquad-cascade IIR filter (kernel B1) for Hopper, walked in parallel in time.
//
// Replaces the Pallas kernel imagined_speech_decoding_tpu/ops/pallas/iir.py
// (_make_kernel, called by sosfilt_time_major). It computes what that kernel
// computes: a causal cascade of S second-order sections in direct form II
// transposed, a0 normalised to 1, from per-row initial states. Two entries
// share one device routine (cascade_tile):
//   isd_sosfilt_time_major  the TPU kernel's interface: x (T, R) time-major,
//                           zi (2S, R) in, zf (2S, R) out.
//   isd_sosfiltfilt_chain   the online decoder's whole filter chain on a
//                           row-major (R, T) input: for each of one or two
//                           filters, SciPy's sosfiltfilt (odd extension by
//                           padlen, a forward pass seeded with zi * ext[0], a
//                           reverse pass seeded with zi * y[n-1], the crop).
//                           x is read once and y written once; everything in
//                           between stays in shared memory and registers.
//
// What bounds it on the H100. A row is one dependent chain: each sample of
// each section needs the state the previous sample left. Walked one thread
// per row (this kernel's first design), a row of ~850 samples is ~850 steps,
// and a decode (B = 1, 64 rows) uses one SM waiting on latency: 0.3% of the
// byte bound. At the corpus size (R = 336,000) there are rows enough to fill
// the card, and the bound is the bytes (8 per sample) or the FMAs.
//
// What the design does. A section is the linear recurrence z' = A z + B x,
// y = z0 + b0 x, with A = [[-a1, 1], [-a2, 0]]. G lanes of a warp share a row,
// each holding one contiguous chunk of L <= 31 samples in registers:
//   1. each lane runs its chunk from a zero state (the first lane from the
//      row's true state) and keeps its end state e;
//   2. a Kogge-Stone scan over the G lanes combines the end states with the
//      chunk transitions A^L, A^2L, ..., A^(G/2)L (f64 on the host, rounded to
//      f32) into each lane's carry-in c: the true state at its chunk's start;
//   3. each lane adds its homogeneous response A^k c to its outputs (3
//      operations a sample), fused into the next section's pass over the chunk.
// Sections go in order, each one's output being the next one's input in the
// same registers. A row's dependent chain is ~L = T/G steps per section, not
// T. Rows longer than 31 G samples are walked in tiles whose end states seed
// the next tile. Chunk lengths are odd, so lanes that read shared memory at
// a stride of L words hit 32 different banks. The section tables sit in
// shared memory.
//
// Two walks. The chain entry gives every chunk 31 samples and every tile
// 31 G, and walks them with no predicate: samples past the row's end only
// disturb outputs that are never stored and the last tile's end state, which
// nothing reads. The causal entry must return the exact zf, so its chunks
// end at the row's end (`chunking` in ops/cuda/iir.py) and its loops are
// predicated.
//
// Lanes per row (G), chosen by ops/cuda/iir.py lanes_for from the row count,
// as chip_smoke.py measured on an H100 80GB HBM3 at 700 W (profiler device
// time; notch + band-pass chain at T = 800, the band-pass's causal pass at
// T = 854). Up to a few thousand rows one row's dependent chain is the time
// and 32 lanes are fastest (chain at 512 rows: 0.0168 ms with 32 lanes,
// 0.0278 with 16). From 4,096 rows on the card is full and 16 lanes, one
// scan level less, do a little better (corpus, 336,000 rows: 3.242 ms with
// 16, 3.492 with 32, 4.633 with 8). There every G >= 2 pays the fix-up, ~8
// operations a sample and section against 5 for a sequential walk, and that
// work, not the 8 bytes a sample, sets the time. The causal entry walks more
// than 8,192 rows one lane a row (G = 1: no scan, no fix-up, loads straight
// from the time-major array): 0.1157 ms at (854, 22400), against 0.2514 with
// 16 lanes and 0.2532 with 32.
//
// Determinism: every output element is written once by one lane, with no
// atomics and a fixed order of operations, so reruns are bit-identical.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 8;
constexpr int kChunkMax = 31;       // samples a lane holds in registers (odd)
constexpr int kSectionFloats = 32;  // b0 b1 b2 a1 a2 zi0 zi1 - A^(L 2^k) (k < 5) - pad
constexpr int kPowers = 8;          // offset of the powers in a section record
constexpr int kStateFloats = 2 * kMaxSections;
constexpr int kMaxExtended = 6144;  // longest extended row the chain stages
constexpr int kMaxChain = 2;
constexpr int kMaxSmem = 232448;    // shared memory a block may have
constexpr int kCausalStaticSmem = 4 * kMaxSections * kSectionFloats;  // its table
constexpr int kChainStaticSmem = kMaxChain * kCausalStaticSmem;       // both tables

// One filter of a chain launch: its section table (device memory, for chunks
// of kChunkMax samples), section count and odd-extension length.
struct FilterPlan {
  const float* table;
  int sections;
  int padlen;
};

struct ChainPlan {
  FilterPlan f[kMaxChain];
};

// The S-section cascade over one tile of a row, in place in v. `lane` is the
// lane's index among the G lanes of its row; its chunk holds `len` samples
// (0 for lanes past the tile's end). Lane 0 starts each section from st_in
// (the true states entering the tile); the lane that holds the tile's last
// sample writes the true states leaving it to st_out.
//   kExact false: every lane walks all kChunkMax samples with no predicate.
//     Samples past the row's end then only disturb outputs that are never
//     stored and the end state of the row's last tile, which the chain never
//     reads (its tiles are lanes * kChunkMax long, so the others are full).
//   kScan false: one lane per row (G = 1); no scan and no fix-up.
template <bool kExact, bool kScan>
__device__ __forceinline__ void cascade_tile(float (&v)[kChunkMax], int len, int lane, int lanes,
                                             int last_lane, const float* table, int sections,
                                             const float* st_in, float* st_out) {
  float h0 = 0.f, h1 = 0.f;    // homogeneous response of the previous section
  float pa1 = 0.f, pa2 = 0.f;  // the previous section's a1, a2
  float pe0 = 0.f, pe1 = 0.f;  // the previous section's zero-state end state
  for (int s = 0; s < sections; ++s) {
    const float* sec = table + s * kSectionFloats;
    const float b0 = sec[0], b1 = sec[1], b2 = sec[2], a1 = sec[3], a2 = sec[4];
    float z0 = 0.f, z1 = 0.f;
    if (lane == 0) {
      z0 = st_in[2 * s];
      z1 = st_in[2 * s + 1];
    }
#pragma unroll
    for (int j = 0; j < kChunkMax; ++j) {
      if (!kExact || j < len) {
        float x = v[j];
        if (kScan) {  // the previous section's true output
          x += h0;
          const float nh0 = fmaf(-pa1, h0, h1);
          h1 = -pa2 * h0;
          h0 = nh0;
        }
        const float u0 = fmaf(b1, x, z1), u1 = b2 * x;
        const float y = fmaf(b0, x, z0);
        z0 = fmaf(-a1, y, u0);
        z1 = fmaf(-a2, y, u1);
        v[j] = y;
      }
    }
    if (s > 0 && lane == last_lane) {
      st_out[2 * s - 2] = pe0 + h0;
      st_out[2 * s - 1] = pe1 + h1;
    }
    if (kScan) {
      // Inclusive scan of the end states: c_l = e_l + A^L c_(l-1).
      float c0 = z0, c1 = z1;
      for (int k = 0, d = 1; d < lanes; ++k, d <<= 1) {
        const float w0 = __shfl_up_sync(0xffffffffu, c0, d, lanes);
        const float w1 = __shfl_up_sync(0xffffffffu, c1, d, lanes);
        if (lane >= d) {
          const float* p = sec + kPowers + 4 * k;
          c0 = fmaf(p[0], w0, fmaf(p[1], w1, c0));
          c1 = fmaf(p[2], w0, fmaf(p[3], w1, c1));
        }
      }
      const float in0 = __shfl_up_sync(0xffffffffu, c0, 1, lanes);
      const float in1 = __shfl_up_sync(0xffffffffu, c1, 1, lanes);
      h0 = lane > 0 ? in0 : 0.f;
      h1 = lane > 0 ? in1 : 0.f;
    }
    pa1 = a1;
    pa2 = a2;
    pe0 = z0;
    pe1 = z1;
  }
  if (kScan) {
#pragma unroll
    for (int j = 0; j < kChunkMax; ++j) {
      if (!kExact || j < len) {
        v[j] += h0;
        const float nh0 = fmaf(-pa1, h0, h1);
        h1 = -pa2 * h0;
        h0 = nh0;
      }
    }
  }
  if (lane == last_lane) {
    st_out[2 * sections - 2] = pe0 + h0;
    st_out[2 * sections - 1] = pe1 + h1;
  }
}

// Copies `n` floats of a section table into shared memory (whole block).
__device__ __forceinline__ void stage_table(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Odd extension by p of the t_len samples at a: sample u of the extended row.
__device__ __forceinline__ float odd_ext(const float* a, int u, int t_len, int p) {
  if (u < p) return 2.f * a[0] - a[p - u];
  if (u < p + t_len) return a[u - p];
  return 2.f * a[t_len - 1] - a[2 * t_len - 2 + p - u];
}

// Per row, in shared memory: a (t_len samples: the input, then each filter's
// cropped output), e (the extended row of the current filter), st (two sets
// of section states, alternating by tile). A row's stride is 32k + G words
// when G < 32, so that the rows sharing a warp fall on other banks. Every
// chunk is kChunkMax samples and every tile lanes * kChunkMax (the last one
// runs past the row's end), so the walk needs no predicate.
__global__ void sosfiltfilt_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                                         int rows, int t_len, int n_filters, int lanes,
                                         int st_offset, int row_stride, const ChainPlan plan) {
  __shared__ float tables[kMaxChain][kMaxSections * kSectionFloats];
  extern __shared__ float smem[];
  stage_table(tables[0], plan.f[0].table, plan.f[0].sections * kSectionFloats);
  stage_table(tables[1], plan.f[1].table, plan.f[1].sections * kSectionFloats);
  __syncthreads();

  const int rows_per_warp = 32 / lanes;
  const int warp = threadIdx.x / 32, lane32 = threadIdx.x % 32;
  const int lane = lane32 % lanes;
  const int local_row = warp * rows_per_warp + lane32 / lanes;
  const long long first_row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) *
                              rows_per_warp + warp * rows_per_warp;
  if (first_row >= rows) return;  // the whole warp is past the last row
  const long long row = first_row + lane32 / lanes;
  const bool active = row < rows;
  float* a = smem + static_cast<size_t>(local_row) * row_stride;
  float* e = a + t_len;
  float* st = a + st_offset;  // 2 x kStateFloats, past the longest extended row

  const float* xr = x + row * t_len;
#pragma unroll 8
  for (int t = lane; t < t_len; t += lanes) a[t] = active ? xr[t] : 0.f;
  __syncwarp();

  const int tile = lanes * kChunkMax, start = lane * kChunkMax;
  float v[kChunkMax];
  for (int f = 0; f < n_filters; ++f) {
    const int sections = f == 0 ? plan.f[0].sections : plan.f[1].sections;
    const int p = f == 0 ? plan.f[0].padlen : plan.f[1].padlen;
    const float* table = tables[f];
    const int n = t_len + 2 * p;
    for (int u = lane; u < n; u += lanes) e[u] = odd_ext(a, u, t_len, p);
    __syncwarp();
    // Forward pass over e, in place.
    int cur = 0;
    if (lane == 0) {
      for (int s = 0; s < sections; ++s) {
        st[2 * s] = table[s * kSectionFloats + 5] * e[0];
        st[2 * s + 1] = table[s * kSectionFloats + 6] * e[0];
      }
    }
    __syncwarp();
    for (int t0 = 0; t0 < n; t0 += tile) {
      const int base = t0 + start;
#pragma unroll
      for (int j = 0; j < kChunkMax; ++j) v[j] = e[min(base + j, n - 1)];
      cascade_tile<false, true>(v, kChunkMax, lane, lanes, lanes - 1, table, sections,
                                st + cur * kStateFloats, st + (cur ^ 1) * kStateFloats);
#pragma unroll
      for (int j = 0; j < kChunkMax; ++j)
        if (base + j < n) e[base + j] = v[j];
      cur ^= 1;
      __syncwarp();
    }
    // Reverse pass over e (logical sample i is e[n - 1 - i]); the crop goes to a.
    if (lane == 0) {
      const float last = e[n - 1];
      for (int s = 0; s < sections; ++s) {
        st[cur * kStateFloats + 2 * s] = table[s * kSectionFloats + 5] * last;
        st[cur * kStateFloats + 2 * s + 1] = table[s * kSectionFloats + 6] * last;
      }
    }
    __syncwarp();
    for (int t0 = 0; t0 < n; t0 += tile) {
      const int top = n - 1 - t0 - start;  // physical index of the chunk's first sample
#pragma unroll
      for (int j = 0; j < kChunkMax; ++j) v[j] = e[max(top - j, 0)];
      cascade_tile<false, true>(v, kChunkMax, lane, lanes, lanes - 1, table, sections,
                                st + cur * kStateFloats, st + (cur ^ 1) * kStateFloats);
#pragma unroll
      for (int j = 0; j < kChunkMax; ++j) {
        const int u = top - j - p;
        if (u >= 0 && u < t_len) a[u] = v[j];
      }
      cur ^= 1;
      __syncwarp();
    }
  }

  float* yr = y + row * t_len;
  if (active)
    for (int t = lane; t < t_len; t += lanes) yr[t] = a[t];
}

// Time-major causal entry, exact: zf is the state after each row's last
// sample. G > 1: a block stages a tile of rows_per_block adjacent rows
// through shared memory (loads and stores coalesced across rows), each warp
// walks its rows' tile in registers, and the section states carry from tile
// to tile in shared memory. G = 1: one thread per row walks it with no scan,
// reading and writing the time-major arrays directly (coalesced across the
// warp's rows); the states still carry through shared memory.
__global__ void sosfilt_time_major_kernel(const float* __restrict__ x,
                                          const float* __restrict__ zi, float* __restrict__ y,
                                          float* __restrict__ zf, const float* __restrict__ table,
                                          int sections, int t_len, int rows, int tile, int chunk,
                                          int lanes, int row_stride) {
  __shared__ float tab[kMaxSections * kSectionFloats];
  extern __shared__ float smem[];
  stage_table(tab, table, sections * kSectionFloats);
  const int rows_per_warp = 32 / lanes;
  const int rows_per_block = (blockDim.x / 32) * rows_per_warp;
  const int lane = (threadIdx.x % 32) % lanes;
  const int local_row = threadIdx.x / lanes;  // warp * rows_per_warp + lane32 / lanes
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  float* buf = smem + static_cast<size_t>(local_row) * row_stride;
  float* st = buf + tile;  // 2 x kStateFloats
  const int n_states = 2 * sections;
  // Thread i stages row rr = i % rows_per_block at times tt = i / rows_per_block
  // + k * lanes (blockDim.x = lanes * rows_per_block).
  const int rr = threadIdx.x % rows_per_block, tt0 = threadIdx.x / rows_per_block;
  const long long r = row0 + rr;
  float* sbuf = smem + static_cast<size_t>(rr) * row_stride;

  for (int k = tt0; k < n_states; k += lanes)
    sbuf[tile + k] = r < rows ? zi[static_cast<long long>(k) * rows + r] : 0.f;
  __syncthreads();

  float v[kChunkMax];
  int cur = 0;
  const int start = lane * chunk;
  for (int t0 = 0; t0 < t_len; t0 += tile) {
    const int tile_len = min(tile, t_len - t0);
    const int len = max(0, min(chunk, tile_len - start));
    float* sin = st + cur * kStateFloats;
    float* sout = st + (cur ^ 1) * kStateFloats;
    if (lanes == 1) {  // rr == local_row: this thread's own row, straight from x
      const float* xr = x + static_cast<long long>(t0) * rows + r;
#pragma unroll
      for (int j = 0; j < kChunkMax; ++j)
        if (j < len && r < rows) v[j] = xr[static_cast<long long>(j) * rows];
      cascade_tile<true, false>(v, len, 0, 1, 0, tab, sections, sin, sout);
      float* yr = y + static_cast<long long>(t0) * rows + r;
#pragma unroll
      for (int j = 0; j < kChunkMax; ++j)
        if (j < len && r < rows) yr[static_cast<long long>(j) * rows] = v[j];
    } else {
      for (int tt = tt0; tt < tile_len; tt += lanes)
        sbuf[tt] = r < rows ? x[static_cast<long long>(t0 + tt) * rows + r] : 0.f;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kChunkMax; ++j)
        if (j < len) v[j] = buf[start + j];
      cascade_tile<true, true>(v, len, lane, lanes, (tile_len - 1) / chunk, tab, sections, sin,
                               sout);
#pragma unroll
      for (int j = 0; j < kChunkMax; ++j)
        if (j < len) buf[start + j] = v[j];
      __syncthreads();
      if (r < rows)
        for (int tt = tt0; tt < tile_len; tt += lanes)
          y[static_cast<long long>(t0 + tt) * rows + r] = sbuf[tt];
    }
    cur ^= 1;
    __syncthreads();
  }

  if (r < rows)
    for (int k = tt0; k < n_states; k += lanes)
      zf[static_cast<long long>(k) * rows + r] = sbuf[tile + cur * kStateFloats + k];
}

bool valid_geometry(int lanes, int tile, int chunk) {
  return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 && chunk >= 1 &&
         chunk <= kChunkMax && (chunk & 1) == 1 && tile >= 1 && tile <= lanes * chunk;
}

// Warps per block: up to `want`, as many as the shared memory allows beside
// the kernel's static tables.
int warps_that_fit(int want, int rows_per_warp, int row_stride, int static_bytes) {
  const long long fit = (kMaxSmem - static_bytes) / (4LL * rows_per_warp * row_stride);
  return static_cast<int>(fit < want ? fit : want);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// x, y: (t_len, rows) f32 on the device; zi, zf: (2 * n_sections, rows);
// table: (n_sections, 32) f32 on the device (ops/cuda/iir.py section_table)
// for this chunk length and lane count. Returns a cudaError_t (0 on success).
extern "C" int isd_sosfilt_time_major(const float* x, const float* zi, float* y, float* zf,
                                      const float* table, int n_sections, int t_len, int rows,
                                      int tile, int chunk, int lanes, void* stream) {
  if (n_sections < 1 || n_sections > kMaxSections || t_len < 0 || rows < 1 ||
      !valid_geometry(lanes, tile, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows_per_warp = 32 / lanes;
  // 32 k + 32 / rows_per_block words per row: the staging loop's threads of
  // one warp (rows fastest) then hit distinct banks when G = 32.
  const int row_stride = round_up(tile + 2 * kStateFloats, 32) +
                         (lanes == 32 ? 4 : lanes);
  const int warps = warps_that_fit(8, rows_per_warp, row_stride, kCausalStaticSmem);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = warps * rows_per_warp;
  const size_t smem = sizeof(float) * static_cast<size_t>(rows_per_block) * row_stride;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(sosfilt_time_major_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  sosfilt_time_major_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      x, zi, y, zf, table, n_sections, t_len, rows, tile, chunk, lanes, row_stride);
  return static_cast<int>(cudaGetLastError());
}

// x, y: (rows, t_len) f32 on the device. For each of n_filters (1 or 2)
// filters: its section table (device, with zi, for chunks of kChunkMax
// samples and this lane count), section count and padlen.
extern "C" int isd_sosfiltfilt_chain(const float* x, float* y, int rows, int t_len,
                                     int n_filters, int lanes, const float* table0,
                                     int sections0, int padlen0, const float* table1,
                                     int sections1, int padlen1, void* stream) {
  const ChainPlan plan = {{{table0, sections0, padlen0}, {table1, sections1, padlen1}}};
  if (n_filters < 1 || n_filters > kMaxChain || rows < 0 || t_len < 1 || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int longest = 0;
  for (int f = 0; f < kMaxChain; ++f) {
    const FilterPlan& fp = plan.f[f];
    const int n = t_len + 2 * fp.padlen;
    if (fp.sections < 1 || fp.sections > kMaxSections || fp.padlen < 0 ||
        fp.padlen >= t_len || n > kMaxExtended) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (f < n_filters) longest = n > longest ? n : longest;
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  // a: t_len words, then e: the longest extended row, then st.
  const int st_offset = t_len + longest;
  const int row_stride = round_up(st_offset + 2 * kStateFloats, 32) + (lanes == 32 ? 0 : lanes);
  const int rows_per_warp = 32 / lanes;
  const int warps = warps_that_fit(4, rows_per_warp, row_stride, kChainStaticSmem);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = warps * rows_per_warp;
  const size_t smem = sizeof(float) * static_cast<size_t>(rows_per_block) * row_stride;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(sosfiltfilt_chain_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  sosfiltfilt_chain_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, rows, t_len, n_filters, lanes, st_offset, row_stride, plan);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by any isd_* entry point of this library.
extern "C" const char* isd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
