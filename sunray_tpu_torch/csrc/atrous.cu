// K7: one edge-avoiding a-trous denoise pass (denoise.slang:27-116).
//
// Replaces sunray_tpu/ops/pallas_image.py: atrous_denoise_tpu
// (_atrous_pass_pallas, _atrous_kernel). The TPU kernel holds a banded
// window of channels-first planes in VMEM, stitched from four views of a
// padded array, and reads the 24 taps as static shifted slices.
//
// What bounds it here: memory traffic and the 24 exp() per pixel. Per
// pixel a pass reads its own 11 guide floats and 24 neighbours' 10 floats
// (color, depth, normal, diffuse); at 1080p that is ~2M x 35 x 4 bytes
// ~ 0.3 GB of loads per pass if nothing were cached, but neighbouring
// pixels share almost all taps, so L1/L2 serve most of them and the pass
// is closer to its ~50 MB of unique traffic plus the exp/div arithmetic.
//
// Design: one launch per pass, one thread per pixel, 16 x 16 blocks so
// the taps of a block fall on a few cached lines. The guides are read in
// place, once per pass, from the (H, W, C) tensors of the G-buffer; the
// color ping-pongs between two buffers that the wrapper allocates.
//
// Numerics follow the jnp pass sunray_tpu/render/postprocess.py:307-375
// (and the plain PyTorch twin in ops/cuda_image.py) operation for
// operation: edge-clamped taps whose weight the in-image mask zeroes,
// the centre diffuse clamped to 0.001 and the neighbour diffuse raw in
// diffuse_diff (with vec_norm's 1e-20 floor), the neighbour illuminance
// divided by the clamped neighbour diffuse, wsum floored at 1e-4, and the
// bypass (depth >= 10000 or roughness < 0.1) passing color through. The
// library is built with --fmad=false so each operation rounds as in the
// plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;

__device__ __forceinline__ float luma(float r, float g, float b) {
  return r * 0.2126f + g * 0.7152f + b * 0.0722f;
}

__device__ __forceinline__ float bspline(int i) {
  // 5x5 B-spline taps (denoise.slang:20): 1, 4, 6, 4, 1 over 16.
  return i == 0 || i == 4 ? 1.0f / 16.0f : (i == 2 ? 6.0f / 16.0f : 4.0f / 16.0f);
}

__global__ void __launch_bounds__(kBlock* kBlock)
atrous_kernel(const float* __restrict__ color, const float* __restrict__ depth,
              const float* __restrict__ normal, const float* __restrict__ roughness,
              const float* __restrict__ diffuse, int h, int w, int step,
              float* __restrict__ out) {
  const int x = blockIdx.x * kBlock + threadIdx.x;
  const int y = blockIdx.y * kBlock + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  const float c0 = color[3 * p + 0], c1 = color[3 * p + 1], c2 = color[3 * p + 2];
  const float dep = depth[p];
  if (dep >= 10000.0f || roughness[p] < 0.1f) {
    out[3 * p + 0] = c0;
    out[3 * p + 1] = c1;
    out[3 * p + 2] = c2;
    return;
  }
  const float cd0 = fmaxf(diffuse[3 * p + 0], 0.001f);
  const float cd1 = fmaxf(diffuse[3 * p + 1], 0.001f);
  const float cd2 = fmaxf(diffuse[3 * p + 2], 0.001f);
  const float il0 = c0 / cd0, il1 = c1 / cd1, il2 = c2 / cd2;
  const float cl = luma(il0, il1, il2);
  const float n0 = normal[3 * p + 0], n1 = normal[3 * p + 1], n2 = normal[3 * p + 2];

  const float kc = (6.0f / 16.0f) * (6.0f / 16.0f);
  float s0 = il0 * kc, s1 = il1 * kc, s2 = il2 * kc;
  float sw = kc;
  for (int dy = -2; dy <= 2; ++dy) {
    for (int dx = -2; dx <= 2; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const int iy = y + dy * step;
      const int ix = x + dx * step;
      const bool in_b = iy >= 0 && iy < h && ix >= 0 && ix < w;
      const int q = min(max(iy, 0), h - 1) * w + min(max(ix, 0), w - 1);
      const float sd0 = diffuse[3 * q + 0], sd1 = diffuse[3 * q + 1],
                  sd2 = diffuse[3 * q + 2];
      const float si0 = color[3 * q + 0] / fmaxf(sd0, 0.001f);
      const float si1 = color[3 * q + 1] / fmaxf(sd1, 0.001f);
      const float si2 = color[3 * q + 2] / fmaxf(sd2, 0.001f);
      const float sl = luma(si0, si1, si2);
      const float e0 = cd0 - sd0, e1 = cd1 - sd1, e2 = cd2 - sd2;
      const float diffuse_diff = sqrtf(fmaxf(e0 * e0 + e1 * e1 + e2 * e2, 1e-20f));
      const float luma_diff = fabsf(cl - sl);
      const float luma_sigma = fmaxf(cl, sl) * 0.4f + 0.01f;
      const float luma_ratio = luma_diff / luma_sigma;
      const float ndot =
          n0 * normal[3 * q + 0] + n1 * normal[3 * q + 1] + n2 * normal[3 * q + 2];
      const float power = -fabsf(dep - depth[q]) * 8.0f + (ndot - 1.0f) * 80.0f -
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

extern "C" int sunray_atrous_pass(const float* color, const float* depth,
                                  const float* normal, const float* roughness,
                                  const float* diffuse, int h, int w, int step, float* out,
                                  void* stream) {
  if (h > 0 && w > 0) {
    const dim3 block(kBlock, kBlock);
    const dim3 grid((w + kBlock - 1) / kBlock, (h + kBlock - 1) / kBlock);
    atrous_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        color, depth, normal, roughness, diffuse, h, w, step, out);
  }
  return static_cast<int>(cudaGetLastError());
}
