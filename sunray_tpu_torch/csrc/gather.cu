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
// memory: a glTF scene's 2,698 vertex rows, 262,144 triangles, an atlas's
// 8,388,608 texel rows). It replaces no TPU kernel of its own: the JAX
// package gathers such tables with plain indexing
// (sunray_tpu/ops/linalg.py:27, render/shade.py:138, ops/texture.py:65,
// 81), whose transpose is a scatter-add.
//
// What bounds it here: memory. It reads ct and idx once and writes the
// K x C table once: at 720p the texel call (5 x 921,600 indices x 4
// columns into 8,388,608 rows) moves ~226 MB, 0.07 ms at 3.35 TB/s. The
// sort's passes move 16 bytes an index a pass on top, and the sums read
// ct in sorted order: texel rows of 16 bytes at random (a sector each),
// corner columns 32 positions to ~7 sectors (4 if consecutive).
//
// Design, deterministic and without float atomics, no library sort:
// - A stable LSD radix sort of the clamped row ids on their own
//   ceil(log2 K) bits, digits of at most kDigitBits bits (the digit plan,
//   ops/cuda_gather.py runs_digit_plan: 3 passes for the atlas, 2 for the
//   corners and the triangles), int32 positions. sort_hist_kernel reads
//   idx once (clamping it) and counts every pass's digits; then one
//   sort_pass_kernel a pass: a tile of kSortTile keys a block, taken in
//   launch order by a ticket, ranked stably inside the block (each warp
//   its kSortItems x 32 consecutive keys in order, an item's lanes of one
//   digit found by a shared atomicOr of their bits, a running count a
//   warp and digit; the warps in order), its offset over the tiles before
//   it by a decoupled look-back (each tile publishes its digit counts,
//   then adds its predecessors' until one has published its inclusive
//   prefix, kLookWindow words loaded at a time; a 64-bit word holds flag
//   and count, so no fence is needed), then staged in shared memory in
//   sorted order and written a digit's run at a time, neighbouring
//   threads to neighbouring slots (tools/runs_sort_variants.py on an
//   H100: a key a thread straight to its slot, a 32-byte sector a key,
//   made the sort 1.7-2.6x slower; __match_any_sync in place of the
//   atomicOr 16-33% slower). The first pass reads idx itself, its
//   positions implicit. The permutation of a
//   stable sort is unique: it is torch.sort(stable=True)'s (a card test
//   checks it).
// - run_heads_kernel, a thread a sorted position: a run starts where the
//   key differs from the one before it. A run of at most kShortRun
//   positions is summed in index order in float64 and its row written:
//   by its first position's thread, kRunCols columns a pass, kRunGroup
//   positions' loads in flight; a run of more than kRunGroup positions
//   in more than kRunCols columns by its warp, a lane a column (one
//   thread took ~40 dependent rounds of loads on a 32 x 20 corner run). A
//   longer run (key at start + kShortRun equal: at most one a warp) is
//   measured by its warp, 32 probes a round (exponential, then each
//   bracket cut in 33), cut into chunks of kRunChunk positions and listed
//   as work items (the list's order is the atomics', the sums' order is
//   not: each chunk's partial sums go to the slot its run reserved, chunk
//   by chunk).
// - run_chunks_kernel, a warp a (chunk, group of kRunCols columns), in
//   the order of a block of kRunThreads threads: thread t sums positions
//   t, t + kRunThreads, ... of the chunk in float64, each warp's threads
//   are added by a butterfly of shuffles, the warps in warp order, into
//   the chunk's float64 partial. The warp's lanes stand for each of the
//   block's warps in turn, with all of a lane's loads issued before its
//   adds and the next warp's positions loaded meanwhile: no barrier (a
//   block a chunk, with two barriers a column group, was slower on the
//   corners). The run's last work item to finish (a ticket after
//   __threadfence) adds the chunks' partials in chunk order and writes
//   the row. Consecutive positions of a run are mostly consecutive pixels
//   (the stable order keeps index order within a row), so the warp's
//   loads of a column coalesce.
// - The table is zeroed by one memset; each present row is written once,
//   in float32 from a float64 sum taken in one fixed order
//   (gather_rows_bwd_runs_model): two runs give the same bits, and the
//   sums are within float32's last bit of the exact ones. No pass runs
//   over the K rows.
// ct is read through its strides (g, c, n), so a (G, N, C) cotangent
// viewed as (G, C, N) needs no copy. A sorted copy of ct (rows in sorted
// order, written by the last pass) was left out: the corner and triangle
// calls' positions lie 93-99.8% in long runs, whose column reads already
// coalesce, and the texel call's rows are contiguous.

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

constexpr int kRunThreads = 256;    // threads a block of the runs kernels
constexpr int kShortRun = 32;       // runs of at most this many: summed in index order
constexpr int kRunCols = 4;         // columns a pass
constexpr int kRunChunk = 2048;     // positions of a long run's chunk
constexpr int kRunGroup = 8;        // a short run's positions loaded together
constexpr int kRunSteps = kRunChunk / kRunThreads;   // a chunk's positions a thread
constexpr int kSortThreads = 256;   // threads a block of the sort's kernels
constexpr int kSortItems = 16;      // keys a thread of a tile
constexpr int kDigitBits = 9;       // the widest digit
constexpr int kMaxPasses = 4;       // 31 bits in digits of at most 9
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortTile = kSortThreads * kSortItems;   // keys a tile
constexpr int kDigits = 1 << kDigitBits;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;    // look-back flags
constexpr long long kMaxSpins = 1ll << 24;   // polls before a look-back gives up
static_assert(2 * kSortThreads == kDigits, "exclusive_scan_digits: two digits a thread");

// The digits of the sort, least significant first: passes, each pass's
// shift and width.
struct SortPlan {
  int passes;
  int shift[kMaxPasses];
  int bits[kMaxPasses];
};

__device__ __forceinline__ int digit_of(int key, int shift, int bits) {
  return (key >> shift) & ((1 << bits) - 1);
}

// Every pass's digit counts over all clamped ids: hist[p * kDigits + d];
// a tile of kSortTile ids a block, all its loads issued first, counted by
// shared atomics, then added to hist.
__global__ void __launch_bounds__(kSortThreads)
sort_hist_kernel(const int32_t* __restrict__ idx, int total, int k_rows, SortPlan plan,
                 int* __restrict__ hist) {
  __shared__ int count[kMaxPasses * kDigits];
  for (int i = threadIdx.x; i < kMaxPasses * kDigits; i += kSortThreads) count[i] = 0;
  int key[kSortItems];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kSortTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int64_t e = tile0 + i * kSortThreads;
    key[i] = e < total ? clamp_row(__ldg(idx + e), k_rows) : -1;
  }
  __syncthreads();
  for (int p = 0; p < plan.passes; ++p) {
#pragma unroll
    for (int i = 0; i < kSortItems; ++i)
      if (key[i] >= 0) atomicAdd(&count[p * kDigits + digit_of(key[i], plan.shift[p], plan.bits[p])], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < plan.passes * kDigits; i += kSortThreads)
    if (count[i] != 0) atomicAdd(hist + i, count[i]);
}

__device__ __forceinline__ unsigned long long look_word(unsigned flag, unsigned count) {
  return (static_cast<unsigned long long>(flag) << 32) | count;
}

// a[0..2 kSortThreads) to its exclusive prefix sums, two entries a
// thread; every thread of the block calls it.
__device__ void exclusive_scan_digits(int* a, int* warp_sums) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int a0 = a[2 * tid], a1 = a[2 * tid + 1];
  int incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int first = incl - a0 - a1;
  for (int w = 0; w < warp; ++w) first += warp_sums[w];
  a[2 * tid] = first;
  a[2 * tid + 1] = first + a0;
  __syncthreads();
}

// The count of digit d over the tiles before `tile`: the decoupled
// look-back, kLookWindow predecessors' words loaded at a time, summed in
// order until one holds an inclusive count.
constexpr int kLookWindow = 4;
__device__ unsigned look_back(const unsigned long long* status, int tile, int radix, int d) {
  unsigned excl = 0;
  long long spins = 0;
  for (int j = tile - 1;;) {
    unsigned long long w[kLookWindow];
#pragma unroll
    for (int q = 0; q < kLookWindow; ++q)
      w[q] = j - q >= 0
                 ? *(volatile const unsigned long long*)(status + static_cast<int64_t>(j - q) * radix + d)
                 : 0ull;
    int used = 0;
    bool done = false;
#pragma unroll
    for (int q = 0; q < kLookWindow; ++q) {
      const unsigned flag = static_cast<unsigned>(w[q] >> 32);
      if (done || used < q || flag == 0) continue;
      excl += static_cast<unsigned>(w[q]);
      used = q + 1;
      done = flag == kInclusive;
    }
    if (done) return excl;
    j -= used;
    if (used == 0) {
      if (++spins > kMaxSpins) return excl;   // never expected: a wrong result, not a hang
      __nanosleep(32);
    }
  }
}

// One stable pass on the digit (shift, bits): keys_out[dest] = key and
// pos_out[dest] = its position. pos_in == nullptr: the first pass, whose
// keys_in is idx (clamped here) and whose positions are the indices.
// hist holds this pass's digit counts; status a 64-bit word a (tile,
// digit), zero before the launch; ticket hands out the tiles in order.
// The tile is ranked, staged in shared memory in its sorted order and
// written a digit's run at a time (neighbouring threads, neighbouring
// slots).
__global__ void __launch_bounds__(kSortThreads)
sort_pass_kernel(const int32_t* __restrict__ keys_in, const int32_t* __restrict__ pos_in,
                 int total, int k_rows, int shift, int bits, const int* __restrict__ hist,
                 unsigned long long* status, unsigned* ticket,
                 int32_t* __restrict__ keys_out, int32_t* __restrict__ pos_out) {
  // Running counts a warp and digit, then exclusive over the warps (at
  // most kSortTile: 16 bits).
  __shared__ unsigned short warp_cnt[kSortWarps][kDigits];
  // An item's lanes a digit while ranking; then the staged tile.
  __shared__ union {
    unsigned lanes_of[kSortWarps][kDigits];
    int32_t stage[2][kSortTile];
  } sh;
  __shared__ int offset[kDigits];       // the digit's first slot in keys_out for this tile
  __shared__ int tile_first[kDigits];   // the digit's first slot in the staged tile
  __shared__ int warp_sums[kSortWarps];
  __shared__ int tile_sh;
  const int radix = 1 << bits;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) tile_sh = static_cast<int>(atomicAdd(ticket, 1u));
  for (int i = tid; i < kSortWarps * kDigits; i += kSortThreads) {
    (&warp_cnt[0][0])[i] = 0;
    (&sh.lanes_of[0][0])[i] = 0u;
  }
  for (int d = tid; d < kDigits; d += kSortThreads) offset[d] = hist[d];
  __syncthreads();
  exclusive_scan_digits(offset, warp_sums);   // the digits' first slots overall

  const int tile = tile_sh;
  const int64_t tile0 = static_cast<int64_t>(tile) * kSortTile;
  const int64_t seg = tile0 + warp * 32 * kSortItems;
  const unsigned below = (1u << lane) - 1u;
  int key[kSortItems], pos[kSortItems], rank[kSortItems];
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int64_t e = seg + i * 32 + lane;
    const bool live = e < total;
    if (pos_in == nullptr) {
      key[i] = live ? clamp_row(__ldg(keys_in + e), k_rows) : -1;
      pos[i] = static_cast<int>(e);
    } else {
      key[i] = live ? __ldg(keys_in + e) : -1;
      pos[i] = live ? __ldg(pos_in + e) : 0;
    }
  }
  // Ranks inside the warp, keys in position order (item, then lane): the
  // lanes of an item that share a digit, by a shared atomicOr of their
  // bits.
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int d = key[i] < 0 ? -1 : digit_of(key[i], shift, bits);
    if (d >= 0) atomicOr(&sh.lanes_of[warp][d], 1u << lane);
    __syncwarp();
    const unsigned peers = d >= 0 ? sh.lanes_of[warp][d] : 0u;
    const int before = d >= 0 ? warp_cnt[warp][d] : 0;
    rank[i] = before + __popc(peers & below);
    __syncwarp();
    if (d >= 0 && __ffs(peers) - 1 == lane) {
      warp_cnt[warp][d] = static_cast<unsigned short>(before + __popc(peers));
      sh.lanes_of[warp][d] = 0u;
    }
    __syncwarp();
  }
  __syncthreads();
  // Each digit: the warps' exclusive counts and the tile's count,
  // published; then the count over the tiles before it (look-back).
  constexpr int kMine = kDigits / kSortThreads;   // digits a thread
  int count[kMine];
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const int d = tid + m * kSortThreads;
    count[m] = 0;
    if (d < radix) {
      for (int w = 0; w < kSortWarps; ++w) {
        const int c = warp_cnt[w][d];
        warp_cnt[w][d] = static_cast<unsigned short>(count[m]);
        count[m] += c;
      }
      *(volatile unsigned long long*)(status + static_cast<int64_t>(tile) * radix + d) =
          look_word(tile == 0 ? kInclusive : kAggregate, static_cast<unsigned>(count[m]));
    }
    tile_first[d] = count[m];
  }
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const int d = tid + m * kSortThreads;
    if (d >= radix || tile == 0) continue;
    const unsigned excl = look_back(status, tile, radix, d);
    *(volatile unsigned long long*)(status + static_cast<int64_t>(tile) * radix + d) =
        look_word(kInclusive, excl + static_cast<unsigned>(count[m]));
    offset[d] += static_cast<int>(excl);
  }
  __syncthreads();
  exclusive_scan_digits(tile_first, warp_sums);
  // Stage the tile in its sorted order, then write it out: slot s of the
  // tile goes to offset[d] + s - tile_first[d].
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    if (key[i] < 0) continue;
    const int d = digit_of(key[i], shift, bits);
    const int slot = tile_first[d] + warp_cnt[warp][d] + rank[i];
    sh.stage[0][slot] = key[i];
    sh.stage[1][slot] = pos[i];
  }
  __syncthreads();
  const int live = total - tile0 < kSortTile ? static_cast<int>(total - tile0) : kSortTile;
  for (int slot = tid; slot < live; slot += kSortThreads) {
    const int k = sh.stage[0][slot];
    const int d = digit_of(k, shift, bits);
    const int dest = offset[d] + slot - tile_first[d];
    keys_out[dest] = k;
    pos_out[dest] = sh.stage[1][slot];
  }
}

// The cotangent row of sorted position e (total < 2^31, so the index
// splits into (g, n) in 32 bits).
struct RunCt {
  const float* ct;
  const int32_t* pos;
  int64_t sg, sc, sn;
  int n;
  __device__ __forceinline__ const float* at(int j) const {   // index j = g n + n'
    const int g = j / n;
    return ct + g * sg + static_cast<int64_t>(j - g * n) * sn;
  }
  __device__ __forceinline__ const float* row(int e) const { return at(__ldg(pos + e)); }
};

// A long run's work item: its row, its chunk's positions [lo, hi), the
// slot of its first chunk's partial sums and its count of chunks.
struct RunItem {
  int row, lo, hi, base, count;
};

// The float64 sum of the run [lo, hi) (at most kShortRun positions) in
// index order, written to out (its row of dtab) in float32.
__device__ void short_run_sum(const RunCt& in, int lo, int hi, int n_cols, float* out) {
  for (int c0 = 0; c0 < n_cols; c0 += kRunCols) {
    double acc[kRunCols];
#pragma unroll
    for (int u = 0; u < kRunCols; ++u) acc[u] = 0.0;
    for (int e0 = lo; e0 < hi; e0 += kRunGroup) {
      float v[kRunGroup][kRunCols];
#pragma unroll
      for (int q = 0; q < kRunGroup; ++q) {
        const bool live = e0 + q < hi;
        const float* src = live ? in.row(e0 + q) + c0 * in.sc : nullptr;
#pragma unroll
        for (int u = 0; u < kRunCols; ++u)
          v[q][u] = live && c0 + u < n_cols ? __ldg(src + u * in.sc) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kRunGroup; ++q)
        if (e0 + q < hi) {
#pragma unroll
          for (int u = 0; u < kRunCols; ++u) acc[u] += static_cast<double>(v[q][u]);
        }
    }
#pragma unroll
    for (int u = 0; u < kRunCols; ++u)
      if (c0 + u < n_cols) out[c0 + u] = static_cast<float>(acc[u]);
  }
}

// The end of the run of `row` that starts at `start` and holds more than
// kShortRun positions, by the whole warp: 32 probes a round, first at
// start + kShortRun + (kShortRun << lane), then evenly inside the bracket
// [last position in the run, first past it).
__device__ int long_run_end(const int32_t* __restrict__ skey, int total, int start, int row,
                            int lane) {
  int64_t lo = start + kShortRun, hi = total;   // lo in the run, hi past it
  {
    const int64_t q = lo + (static_cast<int64_t>(kShortRun) << lane);
    const bool in = q < hi && __ldg(skey + q) == row;
    const int x = __popc(__ballot_sync(0xffffffffu, in));   // probes in the run
    const int64_t qx = __shfl_sync(0xffffffffu, q, x < 32 ? x : 31);
    const int64_t qin = __shfl_sync(0xffffffffu, q, x > 0 ? x - 1 : 0);
    if (x > 0) lo = qin;
    if (x < 32 && qx < hi) hi = qx;
  }
  while (hi - lo > 1) {
    const int64_t span = hi - lo;
    const bool valid = span > 32 || lane < span - 1;
    const int64_t q = span > 32 ? lo + span * (lane + 1) / 33 : lo + 1 + lane;
    const bool in = valid && __ldg(skey + q) == row;
    const int x = __popc(__ballot_sync(0xffffffffu, in));
    const int64_t qx = __shfl_sync(0xffffffffu, q, x < 32 ? x : 31);
    const int64_t qin = __shfl_sync(0xffffffffu, q, x > 0 ? x - 1 : 0);
    const bool out_probe = span > 32 ? x < 32 : x < span - 1;
    if (x > 0) lo = qin;
    if (out_probe) hi = qx;
  }
  return static_cast<int>(hi);
}

// A thread a sorted position: short runs summed and written by their
// first position's thread, long runs measured and listed in chunks.
__global__ void __launch_bounds__(kRunThreads)
run_heads_kernel(RunCt in, const int32_t* __restrict__ skey, int total, int n_cols,
                 RunItem* __restrict__ items, int* __restrict__ n_items,
                 unsigned* __restrict__ tickets, float* __restrict__ dtab) {
  const int e = blockIdx.x * kRunThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const bool live = e < total;
  const int key = live ? __ldg(skey + e) : -1;
  const bool head = live && (e == 0 || __ldg(skey + e - 1) != key);
  const bool is_long = head && e + kShortRun < total && __ldg(skey + e + kShortRun) == key;
  int len = 0;
  if (head && !is_long) {
    int hi = e + 1;
    while (hi < total && __ldg(skey + hi) == key) ++hi;   // at most kShortRun - 1 more
    len = hi - e;
    if (n_cols <= kRunCols || len <= kRunGroup)
      short_run_sum(in, e, hi, n_cols, dtab + static_cast<int64_t>(key) * n_cols);
  }
  // Short runs of more than kRunGroup positions in more than kRunCols
  // columns by the whole warp, a lane a column, each column's sum in
  // index order.
  unsigned wide = __ballot_sync(0xffffffffu, n_cols > kRunCols && len > kRunGroup);
  while (wide != 0) {
    const int src = __ffs(wide) - 1;
    wide &= wide - 1;
    const int lo = __shfl_sync(0xffffffffu, e, src);
    const int n_run = __shfl_sync(0xffffffffu, len, src);
    const int row = __shfl_sync(0xffffffffu, key, src);
    for (int c = lane; c < n_cols; c += 32) {
      double acc = 0.0;
      for (int q0 = 0; q0 < n_run; q0 += kRunGroup) {
        float v[kRunGroup];
#pragma unroll
        for (int q = 0; q < kRunGroup; ++q)
          v[q] = q0 + q < n_run ? __ldg(in.row(lo + q0 + q) + c * in.sc) : 0.0f;
#pragma unroll
        for (int q = 0; q < kRunGroup; ++q)
          if (q0 + q < n_run) acc += static_cast<double>(v[q]);
      }
      dtab[static_cast<int64_t>(row) * n_cols + c] = static_cast<float>(acc);
    }
  }
  // A long run covers the rest of the warp, so a warp holds at most one
  // long run's start.
  const unsigned longs = __ballot_sync(0xffffffffu, is_long);
  if (longs == 0) return;
  const int src = __ffs(longs) - 1;
  const int start = __shfl_sync(0xffffffffu, e, src);
  const int row = __shfl_sync(0xffffffffu, key, src);
  const int end = long_run_end(skey, total, start, row, lane);
  const int m = (end - start + kRunChunk - 1) / kRunChunk;
  int base = 0;
  if (lane == 0) {
    base = atomicAdd(n_items, m);
    tickets[base] = 0u;
  }
  base = __shfl_sync(0xffffffffu, base, 0);
  for (int q = lane; q < m; q += 32) {
    const int lo = start + q * kRunChunk;
    items[base + q] = RunItem{row, lo, min(end, lo + kRunChunk), base, m};
  }
}

// sum over q < count of src[q * stride] in float64, in order of q, with
// up to 16 loads from L2 in flight (partials other blocks wrote).
__device__ __forceinline__ double ordered_sum64(const double* src, int64_t stride, int count) {
  double a = __ldcg(src);
  for (int q = 1; q < count; q += 16) {
    double v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = q + u < count ? __ldcg(src + (q + u) * stride) : 0.0;
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (q + u < count) a += v[u];
  }
  return a;
}

// Each listed chunk of a long run and group of kRunCols columns, a warp
// each: its float64 sums into partial's slot base + chunk (the item's own
// index), in the order of a block of kRunThreads threads (the model's):
// lane l stands for thread 32 w + l of each of the block's warps w in
// turn, sums its positions in order, the warp's butterfly adds them, and
// lane 0 adds the warps' sums in warp order. The run's last work item to
// finish (a ticket after __threadfence) adds the chunks' partials in
// chunk order and writes the run's row.
__global__ void __launch_bounds__(kRunThreads)
run_chunks_kernel(RunCt in, int n_cols, const RunItem* __restrict__ items,
                  const int* __restrict__ n_items, unsigned* __restrict__ tickets,
                  double* __restrict__ partial, float* __restrict__ dtab) {
  const int lane = threadIdx.x % 32;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kRunThreads + threadIdx.x) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (kRunThreads / 32);
  const int groups = (n_cols + kRunCols - 1) / kRunCols;
  const int64_t units = static_cast<int64_t>(*n_items) * groups;
  for (int64_t unit = first; unit < units; unit += stride) {
    const int i = static_cast<int>(unit / groups);
    const int c0 = static_cast<int>(unit - static_cast<int64_t>(i) * groups) * kRunCols;
    const RunItem it = items[i];
    double tot[kRunCols];
#pragma unroll
    for (int u = 0; u < kRunCols; ++u) tot[u] = 0.0;
    // Thread 32 w + lane: positions lo + 32 w + lane + s kRunThreads; the
    // next warp's indices loaded while this one's cotangents are.
    int next[kRunSteps];
#pragma unroll
    for (int s = 0; s < kRunSteps; ++s) {
      const int e = it.lo + lane + s * kRunThreads;
      next[s] = e < it.hi ? __ldg(in.pos + e) : -1;
    }
    for (int w = 0; w < kRunThreads / 32 && it.lo + 32 * w < it.hi; ++w) {
      int j[kRunSteps];
#pragma unroll
      for (int s = 0; s < kRunSteps; ++s) {
        j[s] = next[s];
        const int e = it.lo + 32 * (w + 1) + lane + s * kRunThreads;
        next[s] = w + 1 < kRunThreads / 32 && e < it.hi ? __ldg(in.pos + e) : -1;
      }
      float v[kRunSteps][kRunCols];
      bool live[kRunSteps];
#pragma unroll
      for (int s = 0; s < kRunSteps; ++s) {
        live[s] = j[s] >= 0;
        const float* src = live[s] ? in.at(j[s]) + c0 * in.sc : nullptr;
#pragma unroll
        for (int u = 0; u < kRunCols; ++u)
          v[s][u] = live[s] && c0 + u < n_cols ? __ldg(src + u * in.sc) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kRunCols; ++u) {
        double a = 0.0;
#pragma unroll
        for (int s = 0; s < kRunSteps; ++s)
          if (live[s]) a += static_cast<double>(v[s][u]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        tot[u] = w == 0 ? a : tot[u] + a;
      }
    }
    if (lane < kRunCols && c0 + lane < n_cols) {
      double a = tot[0];
#pragma unroll
      for (int u = 1; u < kRunCols; ++u)
        if (lane == u) a = tot[u];
      partial[static_cast<int64_t>(i) * n_cols + c0 + lane] = a;
    }
    __threadfence();
    unsigned done = 0;
    if (lane == 0) done = atomicAdd(&tickets[it.base], 1u);
    done = __shfl_sync(0xffffffffu, done, 0);
    if (done == static_cast<unsigned>(it.count * groups - 1)) {
      __threadfence();
      for (int c = lane; c < n_cols; c += 32)
        dtab[static_cast<int64_t>(it.row) * n_cols + c] = static_cast<float>(
            ordered_sum64(partial + static_cast<int64_t>(it.base) * n_cols + c, n_cols, it.count));
    }
  }
}

// The digit plan from its code (bits of pass p in bits 4p..4p+3, least
// significant digit first, a zero nibble ending it), checked against K.
bool decode_plan(int code, int k_rows, SortPlan* plan) {
  plan->passes = 0;
  int shift = 0;
  for (int p = 0; p < kMaxPasses; ++p) {
    const int bits = (code >> (4 * p)) & 15;
    if (bits == 0) break;
    if (bits > kDigitBits) return false;
    plan->shift[p] = shift;
    plan->bits[p] = bits;
    shift += bits;
    ++plan->passes;
  }
  if (code >> (4 * plan->passes) != 0 || plan->passes == 0 || shift > 31) return false;
  return shift == 31 || ((k_rows - 1) >> shift) == 0;
}

// Where the runs path keeps its work, in int32 words of one buffer: the
// zeroed part (look-back words, histograms, tile tickets, the work-item
// count), two ping-pong (key, position)
// buffers, the sorted keys and positions, the work items and the runs'
// tickets.
struct RunsLayout {
  int64_t status, hist, tile_tickets, n_items, zero_words;
  int64_t ping[4], keys, pos, items, tickets, words;
};

RunsLayout runs_layout(int64_t total, const SortPlan& plan, int64_t item_cap) {
  RunsLayout L;
  const int64_t tiles = (total + kSortTile - 1) / kSortTile;
  int64_t w = 0;
  L.status = 0;
  for (int p = 0; p < plan.passes; ++p) w += 2 * tiles * (int64_t{1} << plan.bits[p]);
  L.hist = w;
  w += kMaxPasses * kDigits;
  L.tile_tickets = w;
  w += kMaxPasses;
  L.n_items = w++;
  L.zero_words = w;
  for (int b = 0; b < 4; ++b) {
    L.ping[b] = w;
    w += total;
  }
  L.keys = w;
  w += total;
  L.pos = w;
  w += total;
  L.items = w;
  w += 5 * item_cap;
  L.tickets = w;
  w += item_cap;
  L.words = w;
  return L;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// The sort: memset of the zeroed words, the histogram, one launch a pass;
// the sorted keys and their positions into keys_out and pos_out.
cudaError_t runs_sort(const int32_t* idx, int total, int k_rows, const SortPlan& plan,
                      const RunsLayout& L, int32_t* scratch, int32_t* keys_out, int32_t* pos_out,
                      int sms, cudaStream_t s) {
  if (cudaMemsetAsync(scratch, 0, sizeof(int32_t) * L.zero_words, s) != cudaSuccess)
    return cudaGetLastError();
  const int tiles = (total + kSortTile - 1) / kSortTile;
  int* hist = scratch + L.hist;
  sort_hist_kernel<<<static_cast<unsigned>(tiles), kSortThreads, 0, s>>>(
      idx, total, k_rows, plan, hist);
  cudaError_t err = cudaGetLastError();
  auto* status = reinterpret_cast<unsigned long long*>(scratch + L.status);
  for (int p = 0; p < plan.passes && err == cudaSuccess; ++p) {
    const bool end = p == plan.passes - 1;
    const int32_t* kin = p == 0 ? idx : scratch + L.ping[2 * ((p - 1) & 1)];
    const int32_t* pin = p == 0 ? nullptr : scratch + L.ping[2 * ((p - 1) & 1) + 1];
    int32_t* kout = end ? keys_out : scratch + L.ping[2 * (p & 1)];
    int32_t* pout = end ? pos_out : scratch + L.ping[2 * (p & 1) + 1];
    sort_pass_kernel<<<static_cast<unsigned>(tiles), kSortThreads, 0, s>>>(
        kin, pin, total, k_rows, plan.shift[p], plan.bits[p], hist + p * kDigits, status,
        reinterpret_cast<unsigned*>(scratch + L.tile_tickets) + p, kout, pout);
    err = cudaGetLastError();
    status += static_cast<int64_t>(tiles) << plan.bits[p];
  }
  return err;
}

}  // namespace

// {kRunThreads, kShortRun, kRunCols, kRunChunk, kSortThreads, kSortItems,
// kDigitBits, kMaxPasses}: ops/cuda_gather.py RUN_SHAPE, which the plain
// models of the runs path (runs_digit_plan, runs_sort_model,
// gather_rows_bwd_runs_model) read.
extern "C" int sunray_gather_runs_launch_shape(int* out) {
  out[0] = kRunThreads;
  out[1] = kShortRun;
  out[2] = kRunCols;
  out[3] = kRunChunk;
  out[4] = kSortThreads;
  out[5] = kSortItems;
  out[6] = kDigitBits;
  out[7] = kMaxPasses;
  return 0;
}

// The int32 words of scratch the runs path takes for total indices, the
// digit plan `plan` and item_cap work items (0 for the sort alone).
extern "C" int sunray_gather_runs_scratch(int64_t total, int plan, int k_rows, int64_t item_cap,
                                          int64_t* words) {
  SortPlan p;
  if (total < 0 || total > INT32_MAX || item_cap < 0 || k_rows < 1 || !decode_plan(plan, k_rows, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  *words = runs_layout(total, p, item_cap).words;
  return 0;
}

// The runs path's sort alone: keys_out the clamped ids of idx in a stable
// order, pos_out the index of each (int32), as torch.sort(stable=True).
extern "C" int sunray_gather_runs_sort(const int32_t* idx, int64_t total, int k_rows, int plan,
                                       int32_t* scratch, int32_t* keys_out, int32_t* pos_out,
                                       void* stream) {
  SortPlan p;
  if (total < 0 || total > INT32_MAX || k_rows < 1 || !decode_plan(plan, k_rows, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const RunsLayout L = runs_layout(total, p, 0);
  return static_cast<int>(runs_sort(idx, static_cast<int>(total), k_rows, p, L, scratch, keys_out,
                                    pos_out, sms, static_cast<cudaStream_t>(stream)));
}

// The runs path: ct element (g, c, n) at ct + g sg + c sc + n sn (floats),
// total = G n indices idx; plan the digit plan; scratch of
// sunray_gather_runs_scratch(total, plan, k_rows, item_cap) words
// (item_cap >= 2 total / (kShortRun + 1) + 1); partial holds item_cap x C
// doubles. dtab (K, C) is written in full.
extern "C" int sunray_gather_rows_bwd_runs(const float* ct, int64_t sg, int64_t sc, int64_t sn,
                                           int64_t n, int64_t total, const int32_t* idx,
                                           int k_rows, int n_cols, int plan, int32_t* scratch,
                                           int64_t item_cap, double* partial, float* dtab,
                                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  SortPlan p;
  if (k_rows < 1 || n_cols < 1 || n < 0 || n > INT32_MAX || total < 0 || total > INT32_MAX ||
      item_cap < 2 * total / (kShortRun + 1) + 1 || !decode_plan(plan, k_rows, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaMemsetAsync(dtab, 0, sizeof(float) * k_rows * n_cols, s) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  if (total == 0) return 0;
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const RunsLayout L = runs_layout(total, p, item_cap);
  const int t = static_cast<int>(total);
  cudaError_t err = runs_sort(idx, t, k_rows, p, L, scratch, scratch + L.keys, scratch + L.pos,
                              sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RunCt in{ct, scratch + L.pos, sg, sc, sn, static_cast<int>(n)};
  auto* items = reinterpret_cast<RunItem*>(scratch + L.items);
  auto* tickets = reinterpret_cast<unsigned*>(scratch + L.tickets);
  run_heads_kernel<<<static_cast<unsigned>((t + kRunThreads - 1) / kRunThreads), kRunThreads, 0,
                     s>>>(in, scratch + L.keys, t, n_cols, items, scratch + L.n_items, tickets,
                          dtab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  run_chunks_kernel<<<static_cast<unsigned>(8 * sms), kRunThreads, 0, s>>>(
      in, n_cols, items, scratch + L.n_items, tickets, partial, dtab);
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
