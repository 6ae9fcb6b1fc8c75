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
// Design, deterministic (no float atomics; the launch shape is a pure
// function of G * N, K, C and the SM count, ops/cuda_gather.py
// bwd_launch_shape, so every sum is taken in one fixed order and two runs
// give the same bits):
// - Runs in registers. Each warp walks its own contiguous slice of the
//   indices kBwdStep at a time; a lane takes kBwdVec consecutive indices
//   of a step with one 16-byte load of idx and one of each ct column
//   (kBwdVec loads of one word each where N is not a multiple of kBwdVec
//   or a pointer is not 16-byte aligned: the same indices a lane, so the
//   same order of sums). A lane sums the values of equal
//   consecutive rows in registers across steps, and hands its (row, sums)
//   to the warp's combine only where its row changes, and at the end of
//   its slice. Camera-coherent corners and material rows change rows at
//   triangle edges only.
// - The warp's combine, into its own (K, W) table in shared memory, which
//   no other warp writes: lanes whose rows no other flushing lane holds
//   add their sums directly; else the rows' members are summed by a
//   butterfly of shuffles (at most kButterflyRows rows) or by the lowest
//   lane of each row in lane order (__match_any_sync groups).
// - A block adds its warps' tables in warp order into its (K, C) partial.
//   The last block of each group of group_blocks blocks to finish (a
//   ticket after __threadfence) adds its group's partials in block order;
//   the last group to finish adds the groups' sums in group order into
//   dtab. One launch; the tickets sit in the call's own buffer, after
//   the partials, zeroed on the stream ahead of the kernel, so no launch
//   depends on what an earlier one left. A cluster's distributed shared
//   memory would give the same order, but needs a cluster launch; the
//   group sums read 1.7 KB a partial from L2.
// - Tables wider than kBwdMaxCols columns go in passes of kBwdMaxCols.
//   The block's warps and blocks an SM follow from K and C (shared memory
//   a warp: (K + 32) W floats), and an instantiation's dynamic
//   shared-memory limit is raised once for each larger size, a device,
//   where that size and the static flag pass the default 48 KB.

// gather_rows_bwd_runs: the same gradient for tables of any size
// (K > kMaxRows, where a warp's (K, W) table no longer fits in shared
// memory: a glTF scene's 3,518 vertex rows, 256,068 triangles, an
// atlas's 8,388,608 texel rows). It replaces no TPU kernel of its own:
// the JAX package gathers such tables with plain indexing
// (sunray_tpu/ops/linalg.py:27, render/shade.py:138, ops/texture.py:65,
// 81), whose transpose is a scatter-add.
//
// What bounds it here: memory. It reads ct and idx once and writes the
// K x C table once: at 720p the texel call (5 x 921,600 indices x 4
// columns into 8,388,608 rows) moves ~226 MB, 0.07 ms at 3.35 TB/s; the
// row order, the run bounds (2 K words) and the sort move about as much
// again.
//
// Design, deterministic and without float atomics:
// - run_keys_kernel clamps the row ids; the caller orders them with a
//   stable sort (torch.sort(stable=True): a permutation of the indices,
//   equal rows in index order).
// - run_bounds_kernel marks each run of equal sorted rows: start[r] and
//   end[r], written by the run's first and last position alone (rows
//   with no index keep 0, 0 from a memset).
// - run_rows_kernel, a thread a row: a run of at most kShortRun indices is
//   summed by its thread in index order, kRunCols columns a pass, in
//   float64; an empty row is written as 0; a longer run is cut into
//   chunks of kRunChunk positions, listed as work items (the list's order
//   is the atomics', the sums' order is not: each chunk's partial sums
//   go to the slot its row reserved, chunk by chunk).
// - run_long_kernel, a block of kRunThreads threads a chunk: thread t sums
//   positions t, t + kRunThreads, ... of the chunk in float64, the warp
//   adds its threads by a butterfly of shuffles, thread 0 the warps in
//   warp order, into the chunk's float64 partial. Consecutive positions
//   of a run are mostly consecutive pixels (the stable order keeps index
//   order within a row), so the warp's loads of a column coalesce. The
//   chunks spread one long run (a floor vertex's 10^5 corners) over the
//   SMs: with one block a run, such a run took 12 ms of a 720p corner
//   call on an H100.
// - run_finish_kernel adds each long run's chunk partials in chunk order.
// Every row is written once, in float32 from a float64 sum taken in one
// fixed order: two runs give the same bits, and the sums are
// within float32's last bit of the exact ones.
// ct is read through its strides (g, c, n), so a (G, N, C) cotangent
// viewed as (G, C, N) needs no copy.

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

constexpr int kMaxRows = 512;        // ops/cuda_gather.py MAX_ROWS
constexpr int kBwdMaxCols = 16;      // columns a pass (MAX_COLS)
constexpr int kBwdMaxWarps = 8;      // warps a block at most (BWD_MAX_WARPS)
constexpr int kBwdVec = 4;           // indices a lane a step (BWD_VEC)
constexpr int kBwdStep = 32 * kBwdVec;   // indices a warp a step (BWD_STEP)
constexpr int kMaxGroups = 64;       // groups of blocks (BWD_MAX_GROUPS)
constexpr int kButterflyRows = 4;    // rows a combine sums by shuffles at most

// sum over q < count of src[q * stride], in order of q, with up to 8
// loads from L2 in flight (the partials other blocks wrote).
__device__ __forceinline__ float ordered_sum(const float* src, int64_t stride, int count) {
  float a = __ldcg(src);
  for (int q = 1; q < count; q += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = q + u < count ? __ldcg(src + (q + u) * stride) : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (q + u < count) a += v[u];
  }
  return a;
}

__device__ __forceinline__ int clamp_row(int r, int k_rows) {
  return r < 0 ? 0 : (r >= k_rows ? k_rows - 1 : r);
}

// One combine round of a warp: each lane with `flush` adds its sums acc
// of row `row` into the warp's (K, W) table `mine`. Called by all lanes.
template <int W>
__device__ __forceinline__ void combine(bool flush, int row, const float (&acc)[W], int cols,
                                        float* mine, float* stage, int lane) {
  const int key = flush ? row : -1;
  const unsigned group = __match_any_sync(0xffffffffu, key);
  const bool leader = flush && (__ffs(group) - 1) == lane;
  if (__ballot_sync(0xffffffffu, flush && __popc(group) > 1) == 0) {
    // Every flushing lane holds its own row.
    if (flush) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < cols) mine[row * W + c] += acc[c];
    }
  } else {
    const unsigned leaders = __ballot_sync(0xffffffffu, leader);
    if (__popc(leaders) <= kButterflyRows) {
      // A few rows: for each, in lane order of their leaders, a butterfly
      // sum of each column over the row's members (zeros from the other
      // lanes), lane 0's in its fixed order.
      for (unsigned m = leaders; m; m &= m - 1) {
        const int r = __shfl_sync(0xffffffffu, row, __ffs(m) - 1);
        const bool member = flush && row == r;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          float a = member ? acc[c] : 0.0f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
          if (lane == 0 && c < cols) mine[r * W + c] += a;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) stage[lane * W + c] = acc[c];
      __syncwarp();
      if (leader) {
        for (int c = 0; c < cols; ++c) {
          float a = 0.0f;
          for (unsigned m = group; m; m &= m - 1) a += stage[(__ffs(m) - 1) * W + c];
          mine[row * W + c] += a;
        }
      }
    }
  }
  __syncwarp();
}

// Rows and values of the kBwdVec indices a lane takes at flat index j,
// at (g, nn) of the (G, C, N) cotangent: one 16-byte load of idx and one
// of each column (V = kBwdVec; j < end, and end - j a multiple of
// kBwdVec), or a word at a time (V = 1; an index may fall in the next g,
// and indices at or past `end` read nothing).
template <int W, int V>
__device__ __forceinline__ void load_step(const float* __restrict__ ct,
                                          const int32_t* __restrict__ idx, int64_t j,
                                          int64_t end, int64_t g, int64_t nn, int64_t n,
                                          int n_cols, int c0, int cols, int (&r)[kBwdVec],
                                          float (&v)[kBwdVec][W]) {
  if constexpr (V == kBwdVec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx + j));
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
    const float* src = ct + (g * n_cols + c0) * n + nn;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < cols) f = __ldg(reinterpret_cast<const float4*>(src + c * n));
      v[0][c] = f.x;
      v[1][c] = f.y;
      v[2][c] = f.z;
      v[3][c] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kBwdVec; ++e) {
      const bool live = j + e < end;
      int64_t ge = g, ne = nn + e;
      while (ne >= n) {
        ne -= n;
        ++ge;
      }
      const float* src = ct + (ge * n_cols + c0) * n + ne;
      r[e] = live ? __ldg(idx + j + e) : 0;
#pragma unroll
      for (int c = 0; c < W; ++c) v[e][c] = live && c < cols ? __ldg(src + c * n) : 0.0f;
    }
  }
}

template <int W, int V>
__global__ void __launch_bounds__(32 * kBwdMaxWarps, 2)
gather_rows_bwd_kernel(const float* __restrict__ ct, const int32_t* __restrict__ idx,
                       int k_rows, int n_cols, int64_t n, int64_t total, int64_t warp_chunk,
                       int group_blocks, float* __restrict__ partial,
                       unsigned* __restrict__ tickets, float* __restrict__ dtab) {
  extern __shared__ float smem[];
  __shared__ bool last;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int table = k_rows * W;
  float* mine = smem + warp * (table + 32 * W);     // this warp's (K, W)
  float* stage = mine + table;                       // (32, W)
  const int k_c = k_rows * n_cols;
  float* out = partial + static_cast<int64_t>(blockIdx.x) * k_c;

  const int64_t begin = (static_cast<int64_t>(blockIdx.x) * warps + warp) * warp_chunk;
  const int64_t end = begin + warp_chunk < total ? begin + warp_chunk : total;
  for (int c0 = 0; c0 < n_cols; c0 += W) {
    const int cols = n_cols - c0 < W ? n_cols - c0 : W;
    for (int i = lane; i < table; i += 32) mine[i] = 0.0f;
    __syncwarp();
    int cur = -1;                  // the lane's row, -1 before its first index
    float acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0f;
    int64_t j = begin + lane * kBwdVec;
    int64_t g = j / n;
    int64_t nn = j - g * n;
    for (int64_t s = begin; s < end; s += kBwdStep) {
      int r[kBwdVec];
      float v[kBwdVec][W];
      if (V == 1 || j < end) load_step<W, V>(ct, idx, j, end, g, nn, n, n_cols, c0, cols, r, v);
#pragma unroll
      for (int e = 0; e < kBwdVec; ++e) {
        const bool live = V == kBwdVec ? j < end : j + e < end;
        const int row = live ? clamp_row(r[e], k_rows) : cur;
        const bool change = live && row != cur;
        const bool flush = change && cur >= 0;
        if (__any_sync(0xffffffffu, flush)) combine<W>(flush, cur, acc, cols, mine, stage, lane);
        if (change) {
          cur = row;
#pragma unroll
          for (int c = 0; c < W; ++c) acc[c] = v[e][c];
        } else if (live) {
#pragma unroll
          for (int c = 0; c < W; ++c) acc[c] += v[e][c];
        }
      }
      j += kBwdStep;
      nn += kBwdStep;
      while (nn >= n) {
        nn -= n;
        ++g;
      }
    }
    if (__any_sync(0xffffffffu, cur >= 0)) combine<W>(cur >= 0, cur, acc, cols, mine, stage, lane);
    __syncthreads();
    // The block's partial: its warps' tables in warp order.
    for (int i = threadIdx.x; i < k_rows * cols; i += blockDim.x) {
      const int row = i / cols, c = i - row * cols;
      float a = smem[row * W + c];
      for (int w = 1; w < warps; ++w) a += smem[w * (table + 32 * W) + row * W + c];
      out[row * n_cols + c0 + c] = a;
    }
    __syncthreads();
  }

  // The group's last block adds its group's partials, the last group the
  // groups' sums, each in a fixed order.
  const int blocks = gridDim.x;
  const int groups = (blocks + group_blocks - 1) / group_blocks;
  const int grp = blockIdx.x / group_blocks;
  const int first = grp * group_blocks;
  const int count = blocks - first < group_blocks ? blocks - first : group_blocks;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[grp], 1u) == static_cast<unsigned>(count - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* gsum = groups == 1 ? dtab : partial + static_cast<int64_t>(blocks + grp) * k_c;
  for (int i = threadIdx.x; i < k_c; i += blockDim.x)
    gsum[i] = ordered_sum(partial + static_cast<int64_t>(first) * k_c + i, k_c, count);
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[groups], 1u) == static_cast<unsigned>(groups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* sums = partial + static_cast<int64_t>(blocks) * k_c;
  for (int i = threadIdx.x; i < k_c; i += blockDim.x) dtab[i] = ordered_sum(sums + i, k_c, groups);
}

// The instantiation for (w, vec), its dynamic shared-memory limit raised
// once for each larger size it is launched with.
template <int W, int V>
cudaError_t launch_bwd(int w, dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                       const float* ct, const int32_t* idx, int k_rows, int n_cols, int64_t n,
                       int64_t total, int64_t warp_chunk, int group_blocks, float* partial,
                       unsigned* tickets, float* dtab) {
  if constexpr (W > kBwdMaxCols) {
    return cudaErrorInvalidValue;
  } else {
    if (w != W)
      return launch_bwd<W + 1, V>(w, grid, block, smem, s, ct, idx, k_rows, n_cols, n, total,
                                  warp_chunk, group_blocks, partial, tickets, dtab);
    // The largest dynamic shared memory set so far for this instantiation,
    // a device.
    static size_t raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (smem > raised[dev]) {
      // The default limit holds the static shared memory (the ticket flag)
      // and the dynamic together: 48 KB of dynamic memory alone (a 64-row
      // table of 16 columns a pass, 8 warps) already needs the raise.
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, gather_rows_bwd_kernel<W, V>);
      if (err == cudaSuccess && smem + attr.sharedSizeBytes > 48 * 1024)
        err = cudaFuncSetAttribute(gather_rows_bwd_kernel<W, V>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
      if (err != cudaSuccess) {
        cudaGetLastError();   // not left behind for the next launch to report
        return err;
      }
      raised[dev] = smem;
    }
    gather_rows_bwd_kernel<W, V><<<grid, block, smem, s>>>(ct, idx, k_rows, n_cols, n, total,
                                                           warp_chunk, group_blocks, partial,
                                                           tickets, dtab);
    return cudaGetLastError();
  }
}

constexpr int kRunThreads = 256;    // threads a block of every runs kernel
constexpr int kShortRun = 32;       // runs of at most this many: a thread
constexpr int kRunCols = 16;        // columns a pass
constexpr int kRunChunk = 2048;     // positions of a long run a block takes

__global__ void __launch_bounds__(kRunThreads)
run_keys_kernel(const int32_t* __restrict__ idx, int64_t total, int k_rows,
                int32_t* __restrict__ keys) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < total) keys[j] = clamp_row(idx[j], k_rows);
}

__global__ void __launch_bounds__(kRunThreads)
run_bounds_kernel(const int32_t* __restrict__ srow, int64_t total, int32_t* __restrict__ start,
                  int32_t* __restrict__ end) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int32_t r = srow[j];
  if (j == 0 || srow[j - 1] != r) start[r] = static_cast<int32_t>(j);
  if (j == total - 1 || srow[j + 1] != r) end[r] = static_cast<int32_t>(j + 1);
}

// The cotangent row of position e of the sorted order (total < 2^31, so
// the index splits into (g, n) in 32 bits).
struct RunCt {
  const float* ct;
  const int64_t* perm;
  int64_t sg, sc, sn;
  int n;
  __device__ __forceinline__ const float* row(int e) const {
    const int j = static_cast<int>(perm[e]);
    const int g = j / n;
    return ct + g * sg + (j - g * n) * sn;
  }
};

// A long run's work item: its row, its chunk (kRunChunk positions) and the
// slot of its first chunk's partial sums.
struct RunItem {
  int row, chunk, base;
};

__global__ void __launch_bounds__(kRunThreads)
run_rows_kernel(RunCt in, const int32_t* __restrict__ start, const int32_t* __restrict__ end,
                int k_rows, int n_cols, RunItem* __restrict__ items,
                int32_t* __restrict__ n_items, float* __restrict__ dtab) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= k_rows) return;
  const int lo = start[r], hi = end[r];
  if (hi - lo > kShortRun) {
    const int m = (hi - lo + kRunChunk - 1) / kRunChunk;
    const int base = atomicAdd(n_items, m);
    for (int q = 0; q < m; ++q) items[base + q] = RunItem{r, q, base};
    return;
  }
  float* out = dtab + static_cast<int64_t>(r) * n_cols;
  for (int c0 = 0; c0 < n_cols; c0 += kRunCols) {
    double acc[kRunCols];
#pragma unroll
    for (int u = 0; u < kRunCols; ++u) acc[u] = 0.0;
    for (int e = lo; e < hi; ++e) {
      const float* src = in.row(e) + c0 * in.sc;
#pragma unroll
      for (int u = 0; u < kRunCols; ++u)
        if (c0 + u < n_cols) acc[u] += static_cast<double>(__ldg(src + u * in.sc));
    }
#pragma unroll
    for (int u = 0; u < kRunCols; ++u)
      if (c0 + u < n_cols) out[c0 + u] = static_cast<float>(acc[u]);
  }
}

// Each listed chunk of a long run: its float64 sums into partial's slot
// base + chunk.
__global__ void __launch_bounds__(kRunThreads)
run_long_kernel(RunCt in, const int32_t* __restrict__ start, const int32_t* __restrict__ end,
                int n_cols, const RunItem* __restrict__ items,
                const int32_t* __restrict__ n_items, double* __restrict__ partial) {
  __shared__ double part[kRunThreads / 32][kRunCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int count = *n_items;
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const RunItem it = items[i];
    const int lo = start[it.row] + it.chunk * kRunChunk;
    const int hi = min(end[it.row], lo + kRunChunk);
    double* out = partial + static_cast<int64_t>(it.base + it.chunk) * n_cols;
    for (int c0 = 0; c0 < n_cols; c0 += kRunCols) {
      double acc[kRunCols];
#pragma unroll
      for (int u = 0; u < kRunCols; ++u) acc[u] = 0.0;
      for (int e = lo + threadIdx.x; e < hi; e += kRunThreads) {
        const float* src = in.row(e) + c0 * in.sc;
#pragma unroll
        for (int u = 0; u < kRunCols; ++u)
          if (c0 + u < n_cols) acc[u] += static_cast<double>(__ldg(src + u * in.sc));
      }
#pragma unroll
      for (int u = 0; u < kRunCols; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
        if (lane == 0) part[warp][u] = acc[u];
      }
      __syncthreads();
      if (threadIdx.x < kRunCols && c0 + threadIdx.x < n_cols) {
        double a = part[0][threadIdx.x];
        for (int w = 1; w < kRunThreads / 32; ++w) a += part[w][threadIdx.x];
        out[c0 + threadIdx.x] = a;
      }
      __syncthreads();
    }
  }
}

// Each long run's row: its chunks' sums in chunk order, a thread a
// (run, column).
__global__ void __launch_bounds__(kRunThreads)
run_finish_kernel(const int32_t* __restrict__ start, const int32_t* __restrict__ end,
                  int n_cols, const RunItem* __restrict__ items,
                  const int32_t* __restrict__ n_items, const double* __restrict__ partial,
                  float* __restrict__ dtab) {
  const int64_t count = static_cast<int64_t>(*n_items) * n_cols;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < count;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const RunItem it = items[t / n_cols];
    if (it.chunk != 0) continue;
    const int c = static_cast<int>(t % n_cols);
    const int m = (end[it.row] - start[it.row] + kRunChunk - 1) / kRunChunk;
    const double* src = partial + static_cast<int64_t>(it.base) * n_cols + c;
    double a = src[0];
    for (int q = 1; q < m; ++q) a += src[static_cast<int64_t>(q) * n_cols];
    dtab[static_cast<int64_t>(it.row) * n_cols + c] = static_cast<float>(a);
  }
}

}  // namespace

// {kRunThreads, kShortRun, kRunCols, kRunChunk}: ops/cuda_gather.py
// RUN_SHAPE, which the plain model of the runs path
// (gather_rows_bwd_runs_model) reads.
extern "C" int sunray_gather_runs_launch_shape(int* out) {
  out[0] = kRunThreads;
  out[1] = kShortRun;
  out[2] = kRunCols;
  out[3] = kRunChunk;
  return 0;
}

// The runs path's first step: keys[j] = clamp(idx[j], 0, K - 1).
extern "C" int sunray_gather_runs_keys(const int32_t* idx, int64_t total, int k_rows,
                                       int32_t* keys, void* stream) {
  if (k_rows < 1 || total < 0 || total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (total > 0)
    run_keys_kernel<<<static_cast<unsigned>((total + kRunThreads - 1) / kRunThreads), kRunThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(idx, total, k_rows, keys);
  return static_cast<int>(cudaGetLastError());
}

// The runs path's sums: srow, the keys in a stable sorted order, and perm
// (int64), the index of each; ct element (g, c, n) at ct + g sg + c sc +
// n sn (floats). scratch holds 2 K + 3 item_cap + 1 words: start, end,
// the long runs' work items (item_cap >= 2 total / (kShortRun + 1) + 1)
// and their count; partial holds item_cap x C doubles. long_blocks blocks
// take the work items in turns. dtab (K, C) is written in full.
extern "C" int sunray_gather_rows_bwd_runs(const float* ct, int64_t sg, int64_t sc, int64_t sn,
                                           int64_t n, int64_t total, const int32_t* srow,
                                           const int64_t* perm, int k_rows, int n_cols,
                                           int32_t* scratch, int64_t item_cap, double* partial,
                                           int long_blocks, float* dtab, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k_rows < 1 || n_cols < 1 || n < 0 || n > INT32_MAX || total < 0 || total > INT32_MAX ||
      long_blocks < 1 || item_cap < 2 * total / (kShortRun + 1) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* start = scratch;
  int32_t* end = scratch + k_rows;
  RunItem* items = reinterpret_cast<RunItem*>(end + k_rows);
  int32_t* n_items = end + k_rows + 3 * item_cap;
  if (cudaMemsetAsync(start, 0, sizeof(int32_t) * 2 * k_rows, s) != cudaSuccess ||
      cudaMemsetAsync(n_items, 0, sizeof(int32_t), s) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  if (total > 0) {
    run_bounds_kernel<<<static_cast<unsigned>((total + kRunThreads - 1) / kRunThreads),
                        kRunThreads, 0, s>>>(srow, total, start, end);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const RunCt in{ct, perm, sg, sc, sn, static_cast<int>(n)};
  run_rows_kernel<<<static_cast<unsigned>((k_rows + kRunThreads - 1) / kRunThreads), kRunThreads,
                    0, s>>>(in, start, end, k_rows, n_cols, items, n_items, dtab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  run_long_kernel<<<static_cast<unsigned>(long_blocks), kRunThreads, 0, s>>>(
      in, start, end, n_cols, items, n_items, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  run_finish_kernel<<<static_cast<unsigned>(long_blocks), kRunThreads, 0, s>>>(
      start, end, n_cols, items, n_items, partial, dtab);
  return static_cast<int>(cudaGetLastError());
}

// {kMaxRows, kBwdMaxCols, kBwdMaxWarps, kBwdVec, kMaxGroups}:
// ops/cuda_gather.py models them (bwd_launch_shape) and cuda_build checks
// them at load.
extern "C" int sunray_gather_bwd_launch_shape(int* out) {
  out[0] = kMaxRows;
  out[1] = kBwdMaxCols;
  out[2] = kBwdMaxWarps;
  out[3] = kBwdVec;
  out[4] = kMaxGroups;
  return 0;
}

// gather_rows_bwd with the launch shape of ops/cuda_gather.py
// bwd_launch_shape: `blocks` blocks of `warps` warps, each warp
// warp_chunk indices (a multiple of kBwdStep), groups of group_blocks
// blocks; vec = kBwdVec (N a multiple of it, ct and idx 16-byte aligned)
// or 1. partial holds (blocks + groups) K x C floats, then groups + 1
// words for the tickets, which this call zeroes.
extern "C" int sunray_gather_rows_bwd(const float* ct, const int32_t* idx, int k_rows,
                                      int n_cols, int64_t n_groups, int64_t n, int vec,
                                      int warps, int64_t blocks, int64_t warp_chunk,
                                      int group_blocks, float* partial, float* dtab,
                                      void* stream) {
  const int64_t total = n_groups * n;
  auto s = static_cast<cudaStream_t>(stream);
  if (k_rows < 1 || k_rows > kMaxRows || n_cols < 1 || warps < 1 || warps > kBwdMaxWarps ||
      blocks < 0 || group_blocks < 1 || (blocks + group_blocks - 1) / group_blocks > kMaxGroups ||
      warp_chunk % kBwdStep != 0 || blocks * warps * warp_chunk < total ||
      (vec != 1 && vec != kBwdVec) ||
      (vec == kBwdVec && (n % kBwdVec != 0 || reinterpret_cast<uintptr_t>(ct) % 16 != 0 ||
                          reinterpret_cast<uintptr_t>(idx) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) {
    cudaMemsetAsync(dtab, 0, sizeof(float) * k_rows * n_cols, s);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t groups = (blocks + group_blocks - 1) / group_blocks;
  unsigned* tickets = reinterpret_cast<unsigned*>(partial + (blocks + groups) * k_rows * n_cols);
  if (cudaMemsetAsync(tickets, 0, sizeof(unsigned) * (groups + 1), s) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int w = n_cols < kBwdMaxCols ? n_cols : kBwdMaxCols;
  const size_t smem = sizeof(float) * warps * (static_cast<size_t>(k_rows) + 32) * w;
  const dim3 grid(static_cast<unsigned>(blocks)), block(32 * warps);
  const cudaError_t err =
      vec == kBwdVec
          ? launch_bwd<1, kBwdVec>(w, grid, block, smem, s, ct, idx, k_rows, n_cols, n, total,
                                   warp_chunk, group_blocks, partial, tickets, dtab)
          : launch_bwd<1, 1>(w, grid, block, smem, s, ct, idx, k_rows, n_cols, n, total,
                             warp_chunk, group_blocks, partial, tickets, dtab);
  return static_cast<int>(err);
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
