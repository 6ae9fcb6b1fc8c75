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
// at 3.35 TB/s. No arithmetic.
//
// Design: one thread per lane, a loop over the fields and their words.
// The fields come as a small by-value array of (source, output, width)
// descriptors in the kernel's parameters, so the port's structure-of-
// arrays reservoirs are read where they lie: no packed table is built
// (the table build is what ate the TPU kernel's gain, sunray_tpu/config.py
// history_select_kernel). A lane's source words of one field are
// contiguous, and neighbouring lanes read neighbouring rows where the
// reprojection is smooth. Words are copied as uint32: int32 ids never
// pass a float register operation, so nothing can flush them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 16;

struct Field {
  const uint32_t* src;
  uint32_t* dst;
  int width;
};

struct Fields {
  Field f[kMaxFields];
  int n;
};

__global__ void __launch_bounds__(kThreads)
history_gather_kernel(Fields fields, const int64_t* __restrict__ idx, int64_t m,
                      int64_t p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int64_t s = idx[i];
  s = s < 0 ? 0 : (s >= p ? p - 1 : s);
  for (int k = 0; k < fields.n; ++k) {
    const Field f = fields.f[k];
    const uint32_t* src = f.src + s * f.width;
    uint32_t* dst = f.dst + i * f.width;
    for (int c = 0; c < f.width; ++c) dst[c] = __ldg(src + c);
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
  for (int k = 0; k < n_fields; ++k) {
    fields.f[k] = {static_cast<const uint32_t*>(srcs[k]),
                   static_cast<uint32_t*>(dsts[k]), widths[k]};
  }
  if (m > 0) {
    const int64_t blocks = (m + kThreads - 1) / kThreads;
    history_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(fields, idx, m, p);
  }
  return static_cast<int>(cudaGetLastError());
}
