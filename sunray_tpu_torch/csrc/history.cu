// K13: the history gather: many 4-byte fields read at one source index.
//
// Replaces sunray_tpu/ops/pallas_window.py: window_select_t
// (_window_select_kernel). On the TPU a dynamic gather serializes, so the
// temporal history reads (the DI and GI reservoirs, the TAA corners) are
// rebuilt there as "every lane reads one of K statically shifted copies of
// a transposed, padded (C, P) table", a DMA window plus per-lane selects,
// behind a ladder of motion tests (ops/banded.py). What that computes is a
// bit-preserving gather of history rows at a per-lane source index, and
// that is what this kernel does: out_f[i] = field_f[clamp(idx[i])] for
// every field f, each a (P,) or (P, k) plane of float32 or int32 words.
//
// What bounds it here: memory. Each lane reads its index (8 B) and the
// fields' words at the source row, and writes the same words: the joint
// DI+GI read moves 29 words a lane each way, ~490 MB at 1080p, ~0.15 ms
// at 3.35 TB/s. No arithmetic. So the design is about keeping enough
// reads in flight and every store a whole line:
//   - one CTA of 256 threads owns a tile of L lanes (L x the words of a
//     lane ~ 8k words: 256 lanes for the joint read, 1,024 for the TAA
//     corners) and reads the tile's indices once, clamped, into shared
//     memory;
//   - every word of every field of the tile is then requested at once, by
//     4-byte cp.async copies into a shared-memory image of the tile's
//     outputs (thread t copies the rows of lanes t, t + 256, ...): no
//     copy waits on another or on a store, so a CTA has ~8k reads in
//     flight, and the SM several CTAs;
//   - after one wait and one barrier, the tile's output block of each
//     field (L x k contiguous words) is written word-major: consecutive
//     threads store consecutive words, whole 128-byte lines a warp.
// The fields come as a small by-value array of (source, output, width)
// descriptors in the kernel's parameters, so the port's structure-of-
// arrays reservoirs are read where they lie: no packed table is built
// (the table build is what ate the TPU kernel's gain, sunray_tpu/config.py
// history_select_kernel). Words are copied as uint32: int32 ids and NaN
// payloads never pass a float register operation, so nothing can change
// them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 16;
constexpr int kTileWords = 8192;   // words of one CTA's tile, all fields
constexpr int kMaxTile = 1024;     // lanes

struct Field {
  const uint32_t* src;
  uint32_t* dst;
  int width;
};

struct Fields {
  Field f[kMaxFields];
  int n;
};

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
history_gather_kernel(Fields fields, const int64_t* __restrict__ idx, int64_t m,
                      int64_t p, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* rows = reinterpret_cast<int64_t*>(smem);
  uint32_t* image = reinterpret_cast<uint32_t*>(rows + tile);
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int lanes = static_cast<int>(m - lane0 < tile ? m - lane0 : tile);
  for (int l = threadIdx.x; l < lanes; l += kThreads) {
    const int64_t s = idx[lane0 + l];
    rows[l] = s < 0 ? 0 : (s >= p ? p - 1 : s);
  }
  __syncthreads();
  uint32_t* out = image;
  for (int k = 0; k < fields.n; ++k) {
    const Field f = fields.f[k];
    for (int l = threadIdx.x; l < lanes; l += kThreads) {
      const uint32_t* src = f.src + rows[l] * f.width;
      for (int c = 0; c < f.width; ++c) cp_async4(out + l * f.width + c, src + c);
    }
    out += lanes * f.width;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  out = image;
  for (int k = 0; k < fields.n; ++k) {
    const Field f = fields.f[k];
    const int words = lanes * f.width;
    uint32_t* dst = f.dst + lane0 * f.width;
    for (int q = threadIdx.x; q < words; q += kThreads) dst[q] = out[q];
    out += words;
  }
}

}  // namespace

extern "C" int sunray_history_gather(void* const* srcs, void* const* dsts,
                                     const int* widths, int n_fields,
                                     const int64_t* idx, int64_t m, int64_t p,
                                     void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Fields fields;
  fields.n = n_fields;
  int words = 0;
  for (int k = 0; k < n_fields; ++k) {
    fields.f[k] = {static_cast<const uint32_t*>(srcs[k]),
                   static_cast<uint32_t*>(dsts[k]), widths[k]};
    words += widths[k];
  }
  // Lanes a tile: ~kTileWords words, a multiple of 32 from 32 lanes on.
  int tile = words > 0 ? kTileWords / words : kMaxTile;
  tile = tile >= kMaxTile ? kMaxTile : (tile >= 32 ? tile & ~31 : (tile > 0 ? tile : 1));
  const size_t bytes = static_cast<size_t>(tile) * (sizeof(int64_t) + 4 * words);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        history_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m > 0) {
    const int64_t blocks = (m + tile - 1) / tile;
    history_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(fields, idx, m, p, tile);
  }
  return static_cast<int>(cudaGetLastError());
}
