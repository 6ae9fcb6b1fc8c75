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

}  // namespace

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
