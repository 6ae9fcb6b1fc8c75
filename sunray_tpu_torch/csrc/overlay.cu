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
// What bounds it. The image is read once and written once (2 x 12 bytes a
// pixel: 0.0149 ms at 1080p), and a pixel needs the edge tests of only the
// triangles whose boxes hold it: the 1080p HUD's 368 triangles reach 96 of
// its 8,160 16 x 16 tiles, so nearly all of the image is bytes alone. The
// first kernel tested every pixel against every triangle (4.15e9 tests on
// the 2,000-triangle stress set, against ~6.7e7 binned).
//
// Design: one block a 16 x 16 tile, one thread a pixel, all meshes in one
// launch in submission order. For each mesh:
//   - its union box (pack_meshes) misses the tile: no triangle covers a
//     pixel there, and the pixel's result img * 1 + (0 * texel(uv 0)) * 0
//     is img + zero[m] bit for bit (x * 1 is x; the add still quiets a
//     NaN as the product did), so each thread adds the mesh's three
//     uncovered words and goes on. Where no mesh reaches the tile, one
//     add of their fold does it all (ops/cuda_overlay.fold_words): that
//     is the whole HUD outside its 96 tiles.
//   - otherwise the mesh's triangles are walked in chunks of kChunk, last
//     chunk first. Each thread tests one triangle's box against the tile
//     (and its |area| > 1e-8); the hits are compacted in triangle order
//     (__ballot_sync, a count a warp, a prefix over the warps: no atomics,
//     so the order and the bits do not depend on scheduling) and staged in
//     shared memory, each edge as its start vertex and its differences
//     times the area's sign s (three float4s a hit). Each pixel not yet
//     covered walks the staged hits back to front and stops at the first
//     that covers it: walking the last chunk first and each chunk back to
//     front, that is the last covering triangle, which wins. The chunk
//     loop stops when every pixel of the tile is covered
//     (__syncthreads_or).
//   - a covered pixel then computes its winner's edge functions, weights,
//     uv and colours in the plain twin's form, fetches the texel, clips and
//     blends as before; an uncovered one adds zero[m].
//
// Why a box holds every pixel the inside test passes (the boxes are made
// by ops/cuda_overlay.triangle_boxes, on the host, once a call). The
// inside test reads rounded values, so a pixel just outside a triangle
// could pass. With u = 2^-24, each edge function fmaf(A, B, -(C * D)),
// A = fl(x2 - x1), B = fl(py - y1), C = fl(y2 - y1), D = fl(px - x1), is
// within 5u (|P| + |Q|) of the exact P - Q (P = (x2 - x1)(py - y1), Q =
// (y2 - y1)(px - x1); A B carries two roundings, fl(C D) three, the fmaf
// one): with L the vertex box's longer side and D the image's longer side
// plus the largest |coordinate|, within err_e = 10 u L D; the area's fmaf
// within err_a = 10 u L^2. If |area| > err_a, s is the exact area's sign,
// and a pixel that passes has every exact barycentric lambda_i >=
// -err_e / (|area| - err_a): its coordinates lie within L * 3 err_e /
// (|area| - err_a) of the vertex box, the margin the box adds. A triangle
// with |area| <= err_a (collinear or sub-ulp, whose edge functions are all
// rounding), a non-finite coordinate (an infinite vertex's edge functions
// are +-inf and can all pass) or one beyond 2^48 (its products could
// overflow) is thin, and its box is the whole image. The wrapper's area is
// rounded as ops/fp.fma rounds, within one ulp of the fmaf here, and it
// leaves a slack of
// 2^-22 both ways: a triangle gets the empty box only where this kernel's
// |area| <= 1e-8 for certain (a NaN coordinate makes the area NaN), and
// the kernel still tests |area| > 1e-8 itself. Underflow adds under 1e-37
// to each error, which the bounds carry. tests/test_torch_overlay_tiles.py
// checks the boxes against the plain inside test on adversarial families.
//
// Numerics: built with --fmad=false, every product and sum rounds on its
// own as the plain twin's separate float32 ops do; fmaf() stands exactly
// where the plain twin calls ops/fp.fma, which is where XLA's CPU compile
// of the reference's scan body contracts (area, the edge functions and the
// attribute sums; pinned in tests/test_torch_overlay.py). The walk's
// test folds s into A and C, fmaf(s A, B, -((s C) D)) >= 0: that is s
// times fmaf(A, B, -(C D)) but for the sign of an exact zero, which >= 0
// does not see; the winner's edge functions, whose zeros' signs reach the
// weights, are computed again as fmaf(A, B, -(C * D)) * s. The texture fetch, the clip and
// the blend run as eager jnp ops in the reference: nothing fused there.
// min/max propagate NaN as torch.clamp does. Kernel and plain twin agree
// bit for bit, and two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kThreads = kTileX * kTileY;
constexpr int kChunk = 256;         // triangle boxes culled a round, one a thread
static_assert(kChunk == kThreads, "one box a thread");
constexpr int kWarps = kThreads / 32;
constexpr int kRecord = 24;         // floats a triangle
// A mesh's metadata: tri start, count, texel offset, th, tw, clip flag.
constexpr int kMeta = 6;

// torch.clamp(x, lo, hi): NaN stays NaN.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  if (x != x) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ bool meets(int4 box, int x0, int y0, int x1,
                                      int y1) {
  return box.x <= x1 && box.z >= x0 && box.y <= y1 && box.w >= y0;
}

// One edge of a staged hit at (px, py): e = (x_j, y_j, s dx, s dy) gives
// fmaf(s dx, py - y_j, -((s dy) * (px - x_j))), which is s * fmaf(dx,
// py - y_j, -(dy * (px - x_j))) but for the sign of an exact zero (RN is
// symmetric; an exact zero sum is +0), so it is >= 0 exactly where the
// inside test's e_i * s is. The winner's edge functions are computed
// again in the test's own form for its weights.
__device__ __forceinline__ bool passes(float4 e, float px, float py) {
  return fmaf(e.z, py - e.y, -(e.w * (px - e.x))) >= 0.0f;
}

// Six blocks an SM (40 registers, a few spilled) in place of the four
// that 57 registers allow: the walk waits on its loads and barriers, and
// more resident blocks hide them (the stress set's time against four
// blocks: PERF.md, R1's findings; tools/r1_before_after.py --variant).
__global__ void __launch_bounds__(kThreads, 6)
paint_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
             int w, const float* __restrict__ tris,
             const int4* __restrict__ boxes, const int* __restrict__ meta,
             const int4* __restrict__ ubox, const float* __restrict__ clip,
             const float* __restrict__ zero, const float* __restrict__ pool,
             int n_meshes) {
  // The staged hits of a chunk, in triangle order: per edge i the vertex it
  // starts from and s times its difference, (x1, y1, s (x2 - x1),
  // s (y2 - y1)), (x2, y2, s (x0 - x2), s (y0 - y2)), (x0, y0, s (x1 - x0),
  // s (y1 - y0)); and the triangle's index.
  __shared__ float4 s_edge[3][kChunk];
  __shared__ int s_tri[kChunk];
  __shared__ int s_hits[kWarps];

  const int tx0 = blockIdx.x * kTileX, ty0 = blockIdx.y * kTileY;
  const int tx1 = tx0 + kTileX - 1, ty1 = ty0 + kTileY - 1;
  const int x = tx0 + threadIdx.x;
  const int y = ty0 + threadIdx.y;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
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
  // No mesh reaches the tile: one add of the meshes' folded uncovered
  // words (row n_meshes), which is the adds mesh by mesh bit for bit.
  const bool alone =
      n_meshes > 0 && !meets(__ldg(ubox + n_meshes), tx0, ty0, tx1, ty1);
  if (alone && live) {
    c0 = c0 + __ldg(zero + 3 * n_meshes);
    c1 = c1 + __ldg(zero + 3 * n_meshes + 1);
    c2 = c2 + __ldg(zero + 3 * n_meshes + 2);
  }
  for (int m = 0; m < (alone ? 0 : n_meshes); ++m) {
    if (!meets(__ldg(ubox + m), tx0, ty0, tx1, ty1)) {
      // No triangle of the mesh covers a pixel of this tile.
      if (live) {
        c0 = c0 + __ldg(zero + 3 * m);
        c1 = c1 + __ldg(zero + 3 * m + 1);
        c2 = c2 + __ldg(zero + 3 * m + 2);
      }
      continue;
    }
    const int start = __ldg(meta + kMeta * m);
    const int count = __ldg(meta + kMeta * m + 1);
    int win = -1;         // the last triangle that covers the pixel
    bool open = live;     // still looking for it
    for (int t0 = count > 0 ? (count - 1) / kChunk * kChunk : -1; t0 >= 0;
         t0 -= kChunk) {
      const int n = min(kChunk, count - t0);
      const int tri = start + t0 + tid;
      bool hit = false;
      float x0 = 0.0f, y0 = 0.0f, x1 = 0.0f, y1 = 0.0f, x2 = 0.0f, y2 = 0.0f;
      float area = 0.0f;
      if (tid < n && meets(__ldg(boxes + tri), tx0, ty0, tx1, ty1)) {
        const float* td = tris + static_cast<int64_t>(tri) * kRecord;
        const float4 p01 = __ldg(reinterpret_cast<const float4*>(td));
        const float2 p2 = __ldg(reinterpret_cast<const float2*>(td + 4));
        x0 = p01.x;
        y0 = p01.y;
        x1 = p01.z;
        y1 = p01.w;
        x2 = p2.x;
        y2 = p2.y;
        area = fmaf(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)));
        hit = fabsf(area) > 1e-8f;
      }
      // Compact the hits in triangle order.
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_hits[warp] = __popc(ballot);
      __syncthreads();
      int slot = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int c = s_hits[k];
        slot += k < warp ? c : 0;
        total += c;
      }
      if (hit) {
        const float s = area < 0.0f ? -1.0f : 1.0f;
        s_edge[0][slot] = make_float4(x1, y1, s * (x2 - x1), s * (y2 - y1));
        s_edge[1][slot] = make_float4(x2, y2, s * (x0 - x2), s * (y0 - y2));
        s_edge[2][slot] = make_float4(x0, y0, s * (x1 - x0), s * (y1 - y0));
        s_tri[slot] = tri;
      }
      __syncthreads();
      if (total == 0) continue;   // the barrier above orders s_hits' reuse
      if (open) {
        for (int k = total - 1; k >= 0; --k) {
          if (passes(s_edge[0][k], px, py) & passes(s_edge[1][k], px, py) &
              passes(s_edge[2][k], px, py)) {
            win = s_tri[k];
            open = false;
            break;
          }
        }
      }
      // The barrier also keeps the next chunk's staging behind every walk.
      if (!__syncthreads_or(open)) break;
    }
    if (!live) continue;
    if (win < 0) {
      c0 = c0 + __ldg(zero + 3 * m);
      c1 = c1 + __ldg(zero + 3 * m + 1);
      c2 = c2 + __ldg(zero + 3 * m + 2);
      continue;
    }
    // The winner, in the plain twin's own arithmetic.
    const float* td = tris + static_cast<int64_t>(win) * kRecord;
    const float4 p01 = __ldg(reinterpret_cast<const float4*>(td));
    const float2 p2 = __ldg(reinterpret_cast<const float2*>(td + 4));
    const float x0 = p01.x, y0 = p01.y, x1 = p01.z, y1 = p01.w, x2 = p2.x,
                y2 = p2.y;
    const float area = fmaf(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)));
    const float s = area < 0.0f ? -1.0f : 1.0f;
    // s / max(|area|, 1e-8), where |area| > 1e-8.
    const float inv = s / fabsf(area);
    const float e0 = fmaf(x2 - x1, py - y1, -((y2 - y1) * (px - x1))) * s;
    const float e1 = fmaf(x0 - x2, py - y2, -((y0 - y2) * (px - x2))) * s;
    const float e2 = fmaf(x1 - x0, py - y0, -((y1 - y0) * (px - x0))) * s;
    const float w0 = e0 * inv * s, w1 = e1 * inv * s, w2 = e2 * inv * s;
    const float2 uv0 = __ldg(reinterpret_cast<const float2*>(td + 6));
    const float2 uv1 = __ldg(reinterpret_cast<const float2*>(td + 8));
    const float2 uv2 = __ldg(reinterpret_cast<const float2*>(td + 10));
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(td + 12));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(td + 16));
    const float4 a2 = __ldg(reinterpret_cast<const float4*>(td + 20));
    const float u = fmaf(w2, uv2.x, fmaf(w0, uv0.x, w1 * uv1.x));
    const float v = fmaf(w2, uv2.y, fmaf(w0, uv0.y, w1 * uv1.y));
    float r = fmaf(w2, a2.x, fmaf(w0, a0.x, w1 * a1.x));
    float g = fmaf(w2, a2.y, fmaf(w0, a0.y, w1 * a1.y));
    float b = fmaf(w2, a2.z, fmaf(w0, a0.z, w1 * a1.z));
    float a = fmaf(w2, a2.w, fmaf(w0, a0.w, w1 * a1.w));
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
    float alpha = a;
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
                                   const float* tris, const int* boxes,
                                   const int* meta, const int* ubox,
                                   const float* clip, const float* zero,
                                   const float* pool, int n_meshes,
                                   void* stream) {
  if (h > 0 && w > 0) {
    const dim3 block(kTileX, kTileY);
    const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
    paint_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        img, out, h, w, tris, reinterpret_cast<const int4*>(boxes), meta,
        reinterpret_cast<const int4*>(ubox), clip, zero, pool, n_meshes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sunray_overlay_launch_shape(int* out) {
  out[0] = kTileX;
  out[1] = kTileY;
  out[2] = kChunk;
  return 0;
}
