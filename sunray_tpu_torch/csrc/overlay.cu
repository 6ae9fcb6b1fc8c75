// R1: the 2D overlay painter — every mesh rasterised and blended in one
// launch.
//
// Replaces sunray_tpu/render/overlay2d.py: rasterize_mesh and
// paint_meshes (:79-155), which have no pallas_call. The reference runs a
// mesh as a lax.scan over its triangles: each step is edge-function
// coverage and barycentric interpolation over the whole (H, W) plane,
// about 20 elementwise operations on planes that live in memory; then one
// bilinear texture fetch, the clip rect and the blend, each a pass over
// the plane again. The plain twin (render/overlay2d.paint_meshes_plain)
// is the same, T x ~20 full-frame launches for T triangles.
//
// What it computes, per pixel (x + 0.5, y + 0.5), mesh after mesh in
// submission order:
//   for each triangle in order: area, its sign s, inv = s / max(|area|,
//   1e-8), the three edge functions e_i times s; inside when all three are
//   >= 0 and |area| > 1e-8; then w_i = e_i * inv * s and the uv and the
//   colour as fma(w2, a2, fma(w0, a0, w1 * a1)); the last covering
//   triangle wins;
//   rgba *= the bilinear texel at uv (textured meshes, every pixel);
//   alpha = covered ? rgba.a : 0, and 0 outside the clip rect;
//   img = img * (1 - alpha) + rgb * alpha (every pixel, as the reference).
//
// Design: one thread a pixel, 16 x 16 threads a block, all meshes in one
// launch, the image read once and written once. A mesh's triangle records
// (24 floats: three positions, uvs, colours) are staged through shared
// memory kTile at a time, so a block reads each record once from memory;
// each thread keeps its winning uv and colour in registers. The mesh table
// (6 ints a mesh) is read through the read-only cache; a mesh's texels
// come from one float pool (the font atlas is 7 x 290 x 4 floats).
//
// Numerics: built with --fmad=false, every product and sum rounds on its
// own as the plain twin's separate float32 ops do; fmaf() stands exactly
// where the plain twin calls ops/fp.fma, which is where XLA's CPU compile
// of the reference's scan body contracts (area, the edge functions and the
// attribute sums; pinned in tests/test_torch_overlay.py). The texture
// fetch, the clip and the blend run as eager jnp ops in the reference:
// nothing fused there. min/max propagate NaN as torch.clamp does. Kernel
// and plain twin agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTile = 256;          // triangles staged a round
constexpr int kRecord = 24;         // floats a triangle
// A mesh's metadata: tri start, count, texel offset, th, tw, clip flag.
constexpr int kMeta = 6;

// torch.clamp(x, lo, hi): NaN stays NaN.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  if (x != x) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
paint_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
             int w, const float* __restrict__ tris,
             const int* __restrict__ meta, const float* __restrict__ clip,
             const float* __restrict__ pool, int n_meshes) {
  __shared__ float tile[kTile * kRecord];
  const int x = blockIdx.x * kThreadsX + threadIdx.x;
  const int y = blockIdx.y * kThreadsY + threadIdx.y;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const bool live = x < w && y < h;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const int64_t p = live ? (static_cast<int64_t>(y) * w + x) * 3 : 0;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (live) {
    c0 = img[p];
    c1 = img[p + 1];
    c2 = img[p + 2];
  }
  for (int m = 0; m < n_meshes; ++m) {
    const int start = __ldg(meta + kMeta * m);
    const int count = __ldg(meta + kMeta * m + 1);
    float r = 0.0f, g = 0.0f, b = 0.0f, a = 0.0f, u = 0.0f, v = 0.0f;
    bool covered = false;
    for (int t0 = 0; t0 < count; t0 += kTile) {
      const int n = min(kTile, count - t0);
      __syncthreads();
      const float* src = tris + static_cast<int64_t>(start + t0) * kRecord;
      for (int k = tid; k < n * kRecord; k += kThreads) tile[k] = src[k];
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const float* td = tile + k * kRecord;
        const float x0 = td[0], y0 = td[1], x1 = td[2], y1 = td[3],
                    x2 = td[4], y2 = td[5];
        const float area = fmaf(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)));
        const float s = area < 0.0f ? -1.0f : 1.0f;
        const float aa = fabsf(area);
        const float e0 = fmaf(x2 - x1, py - y1, -((y2 - y1) * (px - x1))) * s;
        const float e1 = fmaf(x0 - x2, py - y2, -((y0 - y2) * (px - x2))) * s;
        const float e2 = fmaf(x1 - x0, py - y0, -((y1 - y0) * (px - x0))) * s;
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && aa > 1e-8f) {
          // s / max(|area|, 1e-8), where |area| > 1e-8.
          const float inv = s / aa;
          const float w0 = e0 * inv * s, w1 = e1 * inv * s, w2 = e2 * inv * s;
          u = fmaf(w2, td[10], fmaf(w0, td[6], w1 * td[8]));
          v = fmaf(w2, td[11], fmaf(w0, td[7], w1 * td[9]));
          r = fmaf(w2, td[20], fmaf(w0, td[12], w1 * td[16]));
          g = fmaf(w2, td[21], fmaf(w0, td[13], w1 * td[17]));
          b = fmaf(w2, td[22], fmaf(w0, td[14], w1 * td[18]));
          a = fmaf(w2, td[23], fmaf(w0, td[15], w1 * td[19]));
          covered = true;
        }
      }
    }
    if (!live) continue;
    const int off = __ldg(meta + kMeta * m + 2);
    if (off >= 0) {
      const int th = __ldg(meta + kMeta * m + 3);
      const int tw = __ldg(meta + kMeta * m + 4);
      const float fx_ = clampf(u * static_cast<float>(tw) - 0.5f, 0.0f,
                               static_cast<float>(tw) - 1.0f);
      const float fy_ = clampf(v * static_cast<float>(th) - 0.5f, 0.0f,
                               static_cast<float>(th) - 1.0f);
      const int bx = static_cast<int>(floorf(fx_));
      const int by = static_cast<int>(floorf(fy_));
      const float fx = fx_ - static_cast<float>(bx);
      const float fy = fy_ - static_cast<float>(by);
      const int bx1 = min(bx + 1, tw - 1);
      const int by1 = min(by + 1, th - 1);
      const float* t00 = pool + off + (by * tw + bx) * 4;
      const float* t10 = pool + off + (by * tw + bx1) * 4;
      const float* t01 = pool + off + (by1 * tw + bx) * 4;
      const float* t11 = pool + off + (by1 * tw + bx1) * 4;
      const float gx = 1.0f - fx, gy = 1.0f - fy;
      float tex[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tex[c] = (__ldg(t00 + c) * gx + __ldg(t10 + c) * fx) * gy +
                 (__ldg(t01 + c) * gx + __ldg(t11 + c) * fx) * fy;
      }
      r = r * tex[0];
      g = g * tex[1];
      b = b * tex[2];
      a = a * tex[3];
    }
    float alpha = covered ? a : 0.0f;
    if (__ldg(meta + kMeta * m + 5)) {
      const float cx0 = __ldg(clip + 4 * m), cy0 = __ldg(clip + 4 * m + 1);
      const float cx1 = __ldg(clip + 4 * m + 2), cy1 = __ldg(clip + 4 * m + 3);
      if (!(px >= cx0 && px < cx1 && py >= cy0 && py < cy1)) alpha = 0.0f;
    }
    const float keep = 1.0f - alpha;
    c0 = c0 * keep + r * alpha;
    c1 = c1 * keep + g * alpha;
    c2 = c2 * keep + b * alpha;
  }
  if (live) {
    out[p] = c0;
    out[p + 1] = c1;
    out[p + 2] = c2;
  }
}

}  // namespace

extern "C" int sunray_paint_meshes(const float* img, float* out, int h, int w,
                                   const float* tris, const int* meta,
                                   const float* clip, const float* pool,
                                   int n_meshes, void* stream) {
  if (h > 0 && w > 0) {
    const dim3 block(kThreadsX, kThreadsY);
    const dim3 grid((w + kThreadsX - 1) / kThreadsX,
                    (h + kThreadsY - 1) / kThreadsY);
    paint_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        img, out, h, w, tris, meta, clip, pool, n_meshes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sunray_overlay_launch_shape(int* out) {
  out[0] = kThreadsX;
  out[1] = kThreadsY;
  out[2] = kTile;
  return 0;
}
