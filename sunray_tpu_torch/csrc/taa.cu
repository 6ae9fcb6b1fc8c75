// K9: TAA 3x3 luminance-gated neighbourhood clamp and blend.
//
// Replaces sunray_tpu/ops/pallas_image.py: taa_clamp_blend_tpu
// (_taa_forward, _taa_kernel). The TPU kernel stitches four edge-padded
// VMEM views of a 6-plane (raw, folded history) array into a block with a
// one-pixel halo, because VMEM blocks cannot overlap; it folds the
// use-history mask into the history plane so that one array carries both.
//
// What it computes, per pixel (temporal_accumulation.slang:60-132, the
// plain version ops/cuda_image.taa_clamp_blend_plain):
//   the luminance-gated min/max box of the 3x3 neighbourhood of raw, with
//   edge-replicated taps; the history clamped into that box; then
//   out = fma(raw - clamped, factor, clamped) where use, raw elsewhere.
//
// What bounds it here: memory. A pixel reads raw (12 B), the history
// (12 B) and its mask (1 B) once and writes 12 B: 37 B a pixel, ~77 MB at
// 1080p, ~23 us at 3.35 TB/s. The arithmetic (~120 fp32 operations a
// pixel) is a few microseconds at the card's fp32 rate.
//
// Design: one thread per pixel, 32x8-pixel blocks. The eight neighbour
// taps are read through the read-only cache (__ldg): a block's taps fall
// on its own rows and the row above and below, which the neighbouring
// threads and blocks have just brought into L1/L2, so device memory sees
// raw about once. No shared-memory tile: the halo would cost as many
// loads as it saves at 3 floats a pixel.
//
// The window form (sunray_taa_clamp_blend_window) is the same clamp and
// blend on one band of a row-sharded frame (parallel/spmd.py): it reads
// raw_x, the band's raw with one edge-extended row above and below
// ((h + 2) x w, exchanged from the neighbouring bands), and the band's
// history and mask, and writes the band. The centre is raw_x's row y + 1
// and a tap's row needs no clamp: the exchange has edge-replicated it.
// Its plain twin is taa_clamp_blend_plain(..., raw_x=raw_x). JAX's grid
// TAA computes the same function in jnp (postprocess.py:287-293); the
// TPU has no window kernel. Bound: the same 37 B a band pixel plus the
// two halo rows' 24 B a column.
//
// Numerics: the library is built with --fmad=false, so the luminance is
// (c0 * 0.2126 + c1 * 0.7152) + c2 * 0.0722 in separate roundings as the
// plain version computes it, and the blend's one fused multiply-add is the
// explicit fmaf() where the plain version calls ops/fp.fma. min/max
// propagate NaN as torch.minimum/torch.maximum do. The kernel and the
// plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float luma(float r, float g, float b) {
  return r * 0.2126f + g * 0.7152f + b * 0.0722f;
}

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

// kWindow: raw is the band's (h + 2)-row window, its row 0 one row above
// the band.
template <bool kWindow>
__global__ void __launch_bounds__(kBlockX * kBlockY)
taa_kernel(const float* __restrict__ raw, const float* __restrict__ hist,
           const uint8_t* __restrict__ use, int h, int w, float factor,
           float* __restrict__ out) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int64_t c = kWindow ? p + w : p;  // the centre in raw
  const float c0 = __ldg(raw + 3 * c), c1 = __ldg(raw + 3 * c + 1),
              c2 = __ldg(raw + 3 * c + 2);
  if (!use[p]) {
    out[3 * p] = c0;
    out[3 * p + 1] = c1;
    out[3 * p + 2] = c2;
    return;
  }
  const float cl = luma(c0, c1, c2);
  const float thr = fmaxf(cl * 5.0f, 0.08f);
  float mn0 = c0, mn1 = c1, mn2 = c2, mx0 = c0, mx1 = c1, mx2 = c2;
  // Taps in the plain version's order: dy outer, dx inner, centre skipped.
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = kWindow ? y + 1 + dy : min(max(y + dy, 0), h - 1);
    for (int dx = -1; dx <= 1; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const int xx = min(max(x + dx, 0), w - 1);
      const int64_t q = 3 * (static_cast<int64_t>(yy) * w + xx);
      const float n0 = __ldg(raw + q), n1 = __ldg(raw + q + 1), n2 = __ldg(raw + q + 2);
      if (fabsf(luma(n0, n1, n2) - cl) < thr) {
        mn0 = tmin(mn0, n0);
        mn1 = tmin(mn1, n1);
        mn2 = tmin(mn2, n2);
        mx0 = tmax(mx0, n0);
        mx1 = tmax(mx1, n1);
        mx2 = tmax(mx2, n2);
      }
    }
  }
  const float k0 = tmin(tmax(__ldg(hist + 3 * p), mn0), mx0);
  const float k1 = tmin(tmax(__ldg(hist + 3 * p + 1), mn1), mx1);
  const float k2 = tmin(tmax(__ldg(hist + 3 * p + 2), mn2), mx2);
  out[3 * p] = fmaf(c0 - k0, factor, k0);
  out[3 * p + 1] = fmaf(c1 - k1, factor, k1);
  out[3 * p + 2] = fmaf(c2 - k2, factor, k2);
}

template <bool kWindow>
int launch(const float* raw, const float* hist, const uint8_t* use, int h,
           int w, float factor, float* out, void* stream) {
  if (h > 0 && w > 0) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
    taa_kernel<kWindow><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        raw, hist, use, h, w, factor, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sunray_taa_clamp_blend(const float* raw, const float* hist,
                                      const uint8_t* use, int h, int w, float factor,
                                      float* out, void* stream) {
  return launch<false>(raw, hist, use, h, w, factor, out, stream);
}

// raw_x: (h + 2) x w x 3, the band's raw with a row above and below; hist,
// use and out: the band's h rows.
extern "C" int sunray_taa_clamp_blend_window(const float* raw_x, const float* hist,
                                             const uint8_t* use, int h, int w,
                                             float factor, float* out, void* stream) {
  return launch<true>(raw_x, hist, use, h, w, factor, out, stream);
}
