// K8: small-table row gather by clamped index.
//
// Replaces sunray_tpu/ops/pallas_gather.py: onehot_gather_cols
// (_kernel via _onehot_gather_fwd_impl) and onehot_gather_cols_multi
// (_kernel_multi). On the TPU a dynamic gather serializes, so the Pallas
// kernels select rows with a one-hot (K, B) matrix on the MXU. The card
// has real indexed loads, so here the gather is what it computes:
// out[g, c, n] = table[clamp(idx[g, n], 0, K - 1), c].
//
// What bounds it here: memory. Per output element it moves 4 bytes out
// and 4/C bytes of index in; the table (at most a few KB on the shade
// path: 36 x 4 and 72 x 6) stays in L1/L2 after the first touch. At
// 3 x 2M indices x 6 columns the call writes ~150 MB, ~45 us at 3.35 TB/s.
//
// Design: one thread per (g, n), a loop over the C columns. Writes of
// neighbouring threads land on neighbouring addresses of each (g, c)
// plane, so every store is coalesced; the table reads are broadcasts
// through the read-only cache. Rows are copied as 32-bit words, so the
// result is bit-exact for float32 and int32 tables alike: no value ever
// passes through a float register operation (no denormal flush of ids).
//
// gather_rows_bwd: the gradient of a float32 gather, the custom_vjp
// backward of onehot_gather_cols_multi (_onehot_gather_multi_bwd, a
// segment-sum): dtab[k, c] = sum over (g, n) with clamp(idx[g, n]) = k
// of ct[g, c, n], for K <= kMaxRows rows.
//
// What bounds it here: memory. It reads ct (4 C bytes an index) and idx
// (4 bytes) once and writes the K x C table: at 720p, 3 x 921,600
// indices x 6 columns, 77.4 MB, 0.023 ms at 3.35 TB/s. The sums land in
// few rows (72 on the Cornell box), so float atomics into global memory
// would serialise on them.
//
// Design, deterministic: each warp walks its slice of the indices 32 at a
// time. The lanes stage their C values in shared memory; the lowest lane
// of each group of equal rows (__match_any_sync) sums the group in lane
// order and adds the sum to its warp's own (K, C) table in shared memory,
// which no other warp writes. A warp whose lanes hold at most
// kButterflyRows rows (most warps of camera-coherent lanes) sums each row
// by a butterfly of shuffles instead, in a fixed order too. A block adds its warps' tables in warp
// order and writes one (K, C) partial; a second launch adds the blocks'
// partials in block order. The grid depends only on G * N, so every sum
// is taken in one fixed order and two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                   int k_rows, int n_cols, int64_t n, int64_t total,
                   uint32_t* __restrict__ out) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int64_t g = j / n;
  const int64_t col = j - g * n;
  int r = idx[j];
  r = r < 0 ? 0 : (r >= k_rows ? k_rows - 1 : r);
  const uint32_t* row = table + static_cast<int64_t>(r) * n_cols;
  uint32_t* o = out + g * n_cols * n + col;
  for (int c = 0; c < n_cols; ++c) o[c * n] = __ldg(row + c);
}

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kMaxRows = 512;
constexpr int kBwdBlocksPerSm = 4;
constexpr int kButterflyRows = 4;   // a warp with at most this many rows sums by shuffles

__global__ void __launch_bounds__(kBwdThreads)
gather_rows_bwd_kernel(const float* __restrict__ ct, const int32_t* __restrict__ idx,
                       int k_rows, int n_cols, int64_t n, int64_t total, int64_t chunk,
                       float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int table = k_rows * n_cols;
  float* mine = smem + warp * table;                     // this warp's (K, C)
  float* stage = smem + kBwdWarps * table + warp * 32 * n_cols;   // (32, C)
  for (int i = lane; i < table; i += 32) mine[i] = 0.0f;
  __syncwarp();

  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = begin + chunk < total ? begin + chunk : total;
  for (int64_t base = begin + warp * 32; base < end; base += kBwdThreads) {
    const int64_t j = base + lane;
    const bool live = j < end;
    int r = -1;
    if (live) {
      r = idx[j];
      r = r < 0 ? 0 : (r >= k_rows ? k_rows - 1 : r);
      const int64_t g = j / n;
      const float* src = ct + g * n_cols * n + (j - g * n);
      for (int c = 0; c < n_cols; ++c) stage[lane * n_cols + c] = src[c * n];
    }
    __syncwarp();
    const unsigned group = __match_any_sync(0xffffffffu, r);
    const bool leader = live && (__ffs(group) - 1) == lane;
    const unsigned leaders = __ballot_sync(0xffffffffu, leader);
    if (__popc(leaders) <= kButterflyRows) {
      // A few rows in the warp (camera-coherent lanes): for each, in lane
      // order of their leaders, a butterfly sum of each column over the
      // row's members (zeros from the other lanes), lane 0's in its fixed
      // order. `leaders` is the same on every lane, so every lane takes
      // the shuffles.
      for (unsigned m = leaders; m; m &= m - 1) {
        const int row = __shfl_sync(0xffffffffu, r, __ffs(m) - 1);
        for (int c = 0; c < n_cols; ++c) {
          float acc = (live && r == row) ? stage[lane * n_cols + c] : 0.0f;
          for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (lane == 0) mine[row * n_cols + c] += acc;
        }
      }
    } else if (leader) {
      for (int c = 0; c < n_cols; ++c) {
        float acc = 0.0f;
        for (unsigned m = group; m; m &= m - 1) acc += stage[(__ffs(m) - 1) * n_cols + c];
        mine[r * n_cols + c] += acc;
      }
    }
    __syncwarp();
  }
  __syncthreads();
  float* out = partial + static_cast<int64_t>(blockIdx.x) * table;
  for (int i = threadIdx.x; i < table; i += kBwdThreads) {
    float acc = smem[i];
    for (int w = 1; w < kBwdWarps; ++w) acc += smem[w * table + i];
    out[i] = acc;
  }
}

__global__ void gather_rows_bwd_sum(const float* __restrict__ partial, int table, int blocks,
                                    float* __restrict__ dtab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= table) return;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc += partial[static_cast<int64_t>(b) * table + i];
  dtab[i] = acc;
}

}  // namespace

// The (blocks, chunk) of gather_rows_bwd for G * N = total indices, and
// the bytes of its partial sums: the caller allocates them.
extern "C" int sunray_gather_rows_bwd_shape(int64_t total, int k_rows, int n_cols,
                                            int64_t* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t max_blocks = static_cast<int64_t>(sms) * kBwdBlocksPerSm;
  int64_t chunk = (total + max_blocks - 1) / max_blocks;
  chunk = (chunk + kBwdThreads - 1) / kBwdThreads * kBwdThreads;
  if (chunk < kBwdThreads) chunk = kBwdThreads;
  out[0] = total > 0 ? (total + chunk - 1) / chunk : 0;
  out[1] = chunk;
  out[2] = out[0] * k_rows * n_cols * static_cast<int64_t>(sizeof(float));
  return 0;
}

extern "C" int sunray_gather_rows_bwd(const float* ct, const int32_t* idx, int k_rows,
                                      int n_cols, int64_t n_groups, int64_t n,
                                      int64_t blocks, int64_t chunk, float* partial,
                                      float* dtab, void* stream) {
  if (k_rows < 1 || k_rows > kMaxRows || n_cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_groups * n;
  const int table = k_rows * n_cols;
  auto s = static_cast<cudaStream_t>(stream);
  if (blocks == 0) {
    cudaMemsetAsync(dtab, 0, sizeof(float) * table, s);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * kBwdWarps * (table + 32 * n_cols);
  cudaError_t err = cudaFuncSetAttribute(gather_rows_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_bwd_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem, s>>>(
      ct, idx, k_rows, n_cols, n, total, chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_bwd_sum<<<(table + 127) / 128, 128, 0, s>>>(partial, table,
                                                          static_cast<int>(blocks), dtab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sunray_gather_rows(const void* table, const int32_t* idx, int k_rows,
                                  int n_cols, int64_t n_groups, int64_t n, void* out,
                                  void* stream) {
  const int64_t total = n_groups * n;
  if (total > 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    gather_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(table), idx, k_rows, n_cols, n, total,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
