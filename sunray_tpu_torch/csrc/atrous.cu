// K7: one edge-avoiding a-trous denoise pass (denoise.slang:27-116).
//
// Replaces sunray_tpu/ops/pallas_image.py: atrous_denoise_tpu
// (_atrous_pass_pallas, _atrous_kernel). The TPU kernel holds a banded
// window of channels-first planes in VMEM, stitched from four views of a
// padded array, and reads the 24 taps as static shifted slices.
//
// What bounds it here: instruction issue, not bytes. A pass must move the
// five guide planes and the color once (~116 MB at 1080p, 0.035 ms at
// 3.35 TB/s), but every one of a pixel's 24 taps needs the neighbour's
// illuminance color / max(diffuse, 0.001) (three IEEE divisions), its
// luma, one more division (luma_ratio), one sqrtf and one expf. The first
// port recomputed the neighbour side in every tap from 10 scalar global
// loads of (H, W, 3) planes: 72 of its 96 divisions a pixel were the same
// illuminance computed again by the pixels around it.
//
// Design: a block takes a tile of kTileX x kTileY pixels of one
// sub-lattice of the pass, the pixels with the same x mod step and
// y mod step. On it the dilated 5 x 5 stencil is dense, so the tile's
// halo is 2 lattice pixels at every step (a dense tile at step 8 would
// need a 16-pixel halo). The block stages its tile and halo once, in
// shared memory, as three 16-byte records a pixel: (illuminance, luma),
// (raw diffuse, depth), (normal, unused). Each staged pixel's divisions
// and luma are computed once there; every tap then reads three 16-byte
// shared loads (neighbouring threads on neighbouring records, no bank
// conflict) and does one division, one sqrtf and one expf. A halo pixel
// outside the image is staged as the edge-clamped pixel, exactly the
// pixel the clamped index read before, and the in-image mask zeroes its
// weight: its 0 x value stays the same product (a zero-filled record
// could turn an inf x 0 into another sum). Block ids put the step^2
// sibling lattices of one region next to each other, so the blocks that
// read the same lines run close together and L2 serves them.
//
// Numerics follow the jnp pass sunray_tpu/render/postprocess.py:307-375
// (and the plain PyTorch twin in ops/cuda_image.py) operation for
// operation: edge-clamped taps whose weight the in-image mask zeroes,
// the centre diffuse clamped to 0.001 and the neighbour diffuse raw in
// diffuse_diff (with vec_norm's 1e-20 floor), the neighbour illuminance
// divided by the clamped neighbour diffuse, wsum floored at 1e-4, and the
// bypass (depth >= 10000 or roughness < 0.1) passing color through. The
// staged illuminance is the same division of the same operands, and the
// taps are summed in the same order, so the kernel is bit-equal to the
// one-thread-per-pixel kernel it replaces. The library is built with
// --fmad=false so each operation rounds as in the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// sunray_atrous_tile_shape reports kTileX, kTileY and kHalo.
constexpr int kTileX = 32;   // one warp a tile row
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
constexpr int kHalo = 2;
constexpr int kStageX = kTileX + 2 * kHalo;
constexpr int kStageY = kTileY + 2 * kHalo;
constexpr int kStaged = kStageX * kStageY;

__device__ __forceinline__ float luma(float r, float g, float b) {
  return r * 0.2126f + g * 0.7152f + b * 0.0722f;
}

__device__ __forceinline__ float bspline(int i) {
  // 5x5 B-spline taps (denoise.slang:20): 1, 4, 6, 4, 1 over 16.
  return i == 0 || i == 4 ? 1.0f / 16.0f : (i == 2 ? 6.0f / 16.0f : 4.0f / 16.0f);
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// Pixels of the lattice that starts at offset a (a < n) with stride step.
__device__ __forceinline__ int lattice_len(int n, int a, int step) {
  return a < n ? (n - a + step - 1) / step : 0;
}

__global__ void __launch_bounds__(kThreads)
atrous_kernel(const float* __restrict__ color, const float* __restrict__ depth,
              const float* __restrict__ normal, const float* __restrict__ roughness,
              const float* __restrict__ diffuse, int h, int w, int step, int tiles_x,
              int row0, int h_global, float* __restrict__ out) {
  __shared__ float4 s_il[kStaged];   // illuminance rgb, luma
  __shared__ float4 s_dd[kStaged];   // raw diffuse rgb, depth
  __shared__ float4 s_n[kStaged];    // normal xyz, unused

  const int lattices = step * step;
  const int lat = blockIdx.x % lattices;
  const int tile = blockIdx.x / lattices;
  const int ax = lat % step, ay = lat / step;
  const int lx0 = (tile % tiles_x) * kTileX, ly0 = (tile / tiles_x) * kTileY;
  const int lw = lattice_len(w, ax, step), lh = lattice_len(h, ay, step);
  if (lx0 >= lw || ly0 >= lh) return;   // the whole block: no centre here

#pragma unroll 1
  for (int k = threadIdx.x; k < kStaged; k += kThreads) {
    const int x = ax + (lx0 + k % kStageX - kHalo) * step;
    const int y = ay + (ly0 + k / kStageX - kHalo) * step;
    const int q = clampi(y, h - 1) * w + clampi(x, w - 1);
    const float d0 = diffuse[3 * q + 0], d1 = diffuse[3 * q + 1], d2 = diffuse[3 * q + 2];
    const float i0 = color[3 * q + 0] / fmaxf(d0, 0.001f);
    const float i1 = color[3 * q + 1] / fmaxf(d1, 0.001f);
    const float i2 = color[3 * q + 2] / fmaxf(d2, 0.001f);
    s_il[k] = make_float4(i0, i1, i2, luma(i0, i1, i2));
    s_dd[k] = make_float4(d0, d1, d2, depth[q]);
    s_n[k] = make_float4(normal[3 * q + 0], normal[3 * q + 1], normal[3 * q + 2], 0.0f);
  }
  __syncthreads();

  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int lx = lx0 + tx, ly = ly0 + ty;
  if (lx >= lw || ly >= lh) return;
  const int x = ax + lx * step, y = ay + ly * step;
  const int p = y * w + x;
  const int c = (ty + kHalo) * kStageX + tx + kHalo;
  const float4 cil = s_il[c], cdd = s_dd[c], cn = s_n[c];
  const float dep = cdd.w;
  if (dep >= 10000.0f || roughness[p] < 0.1f) {
    out[3 * p + 0] = color[3 * p + 0];
    out[3 * p + 1] = color[3 * p + 1];
    out[3 * p + 2] = color[3 * p + 2];
    return;
  }
  const float cd0 = fmaxf(cdd.x, 0.001f);
  const float cd1 = fmaxf(cdd.y, 0.001f);
  const float cd2 = fmaxf(cdd.z, 0.001f);
  const float il0 = cil.x, il1 = cil.y, il2 = cil.z;
  const float cl = cil.w;
  const float n0 = cn.x, n1 = cn.y, n2 = cn.z;

  const float kc = (6.0f / 16.0f) * (6.0f / 16.0f);
  float s0 = il0 * kc, s1 = il1 * kc, s2 = il2 * kc;
  float sw = kc;
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      if (dx == 0 && dy == 0) continue;
      // The tap's in-image test runs on global rows: row0 is the global
      // row of the window's row 0 (0 and h_global = h for a whole image).
      const int iy = row0 + y + dy * step;
      const int ix = x + dx * step;
      const bool in_b = iy >= 0 && iy < h_global && ix >= 0 && ix < w;
      const int q = c + dy * kStageX + dx;
      const float4 qil = s_il[q], qdd = s_dd[q], qn = s_n[q];
      const float si0 = qil.x, si1 = qil.y, si2 = qil.z;
      const float sl = qil.w;
      const float e0 = cd0 - qdd.x, e1 = cd1 - qdd.y, e2 = cd2 - qdd.z;
      const float diffuse_diff = sqrtf(fmaxf(e0 * e0 + e1 * e1 + e2 * e2, 1e-20f));
      const float luma_diff = fabsf(cl - sl);
      const float luma_sigma = fmaxf(cl, sl) * 0.4f + 0.01f;
      const float luma_ratio = luma_diff / luma_sigma;
      const float ndot = n0 * qn.x + n1 * qn.y + n2 * qn.z;
      const float power = -fabsf(dep - qdd.w) * 8.0f + (ndot - 1.0f) * 80.0f -
                          diffuse_diff * 50.0f - luma_ratio * luma_ratio;
      float wgt = expf(power) * bspline(dx + 2) * bspline(dy + 2);
      if (!in_b) wgt = 0.0f;
      s0 = s0 + si0 * wgt;
      s1 = s1 + si1 * wgt;
      s2 = s2 + si2 * wgt;
      sw = sw + wgt;
    }
  }
  const float wsum = fmaxf(sw, 1e-4f);
  out[3 * p + 0] = s0 / wsum * cd0;
  out[3 * p + 1] = s1 / wsum * cd1;
  out[3 * p + 2] = s2 / wsum * cd2;
}

}  // namespace

// K7's window form: one pass over an h-row window of a row-sharded image
// (parallel/halo.py) whose row 0 is global row row0 of an h_global-row
// image; the edge-clamped staging stays inside the window and the taps'
// in-image test takes global rows (postprocess.py:307-316).
extern "C" int sunray_atrous_pass_window(const float* color, const float* depth,
                                         const float* normal, const float* roughness,
                                         const float* diffuse, int h, int w, int step,
                                         int row0, int h_global, float* out,
                                         void* stream) {
  if (h > 0 && w > 0 && step > 0) {
    // Tiles of the widest and tallest lattice (offset 0); the blocks of a
    // narrower lattice's last tile column or row exit at once.
    const int tiles_x = ((w + step - 1) / step + kTileX - 1) / kTileX;
    const int tiles_y = ((h + step - 1) / step + kTileY - 1) / kTileY;
    const int64_t blocks = static_cast<int64_t>(step) * step * tiles_x * tiles_y;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    atrous_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        color, depth, normal, roughness, diffuse, h, w, step, tiles_x, row0, h_global,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sunray_atrous_pass(const float* color, const float* depth,
                                  const float* normal, const float* roughness,
                                  const float* diffuse, int h, int w, int step, float* out,
                                  void* stream) {
  return sunray_atrous_pass_window(color, depth, normal, roughness, diffuse, h, w, step, 0,
                                   h, out, stream);
}

// K7's block shape, {kTileX, kTileY, kHalo}: the host's models of the
// kernel (ops/cuda_image.ATROUS_TILE, ATROUS_HALO) are checked against it
// when the library loads.
extern "C" int sunray_atrous_tile_shape(int* out) {
  out[0] = kTileX;
  out[1] = kTileY;
  out[2] = kHalo;
  return 0;
}
